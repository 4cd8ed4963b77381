"""The port's dense parameter server and optimizers against the JAX package's.

The optimizers: pushes of the same gradients through ``adamw``/``adam``/
``sgd`` against optax's, float32, rtol 1e-6.  Adam's bias corrections
``1 - b**t`` are float32 in optax and float64 in torch; at t = 1, ``1 -
0.999`` differs by 1.3e-5 relative between the two, so an Adam update
(about ``lr`` per element) differs by up to ~7e-6·lr: the Adam arms add
atol 1e-5·lr per push.

``transform_dense``: a small float32 LM over three batches from weights
carried from JAX, per-step losses rtol 1e-5.  Final parameters: with SGD
rtol 1e-4 / atol 1e-6 (float32 gradients summed in another order).  AdamW
divides each step by the gradient's own magnitude plus eps, so a gradient
element at float32 noise level (GELU's flat tail makes some) would move by
up to lr on either side with optax's eps 1e-8; that arm runs eps 1e-4,
which bounds the effect, and adds atol 1e-3·lr.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from flink_parameter_server_tpu.core import dense as ref_dense
from flink_parameter_server_tpu.models import transformer as ref_tr
from flink_parameter_server_tpu_torch import interop
from flink_parameter_server_tpu_torch.core import dense, optim
from flink_parameter_server_tpu_torch.models import transformer as tr

torch.set_num_threads(2)

OPTIMIZERS = {  # name: (optax, port, atol per push)
    "adamw": (optax.adamw(0.05), optim.adamw(0.05), 1e-5 * 0.05),
    "adamw_decay": (optax.adamw(0.05, weight_decay=0.1), optim.adamw(0.05, weight_decay=0.1), 1e-5 * 0.05),
    "adam": (optax.adam(0.05), optim.adam(0.05), 1e-5 * 0.05),
    "sgd": (optax.sgd(0.1), optim.sgd(0.1), 0.0),
    "sgd_momentum": (optax.sgd(0.1, momentum=0.9, nesterov=True), optim.sgd(0.1, momentum=0.9, nesterov=True),
                     0.0),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_pushes_match_optax(name):
    ref_opt, opt, atol = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    init = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    ref = ref_dense.DenseParameterServer(jax.tree.map(jnp.asarray, init), ref_opt)
    module = nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()})
    server = dense.DenseParameterServer(module, opt)
    for step in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
        ref = ref.push(jax.tree.map(jnp.asarray, grads))
        pushed = [torch.from_numpy(grads[k]) for k, _ in module.named_parameters()]
        assert server.push(pushed) is server  # in place
        for k in init:
            np.testing.assert_allclose(server.pull()[k].detach().numpy(), np.asarray(ref.pull()[k]),
                                       rtol=1e-6, atol=1e-7 + atol * (step + 1), err_msg=f"{k} after push {step}")


def test_adamw_defaults_are_optax_defaults():
    opt = optim.adamw(1e-3)([nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8 and group["betas"] == (0.9, 0.999)


CFG = dict(vocab_size=64, d_model=64, n_heads=1, n_layers=2, d_ff=128, max_seq=16)


def _batches(n, B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, CFG["vocab_size"], (B, T)).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("opt_name,steps_per_call", [("sgd", 1), ("sgd", 2), ("adamw", 1), ("adamw", 2)])
def test_transform_dense_matches_reference(opt_name, steps_per_call):
    ref_opt, opt, atol = {"sgd": (optax.sgd(0.5), optim.sgd(0.5), 1e-6),
                          "adamw": (optax.adamw(1e-2, eps=1e-4), optim.adamw(1e-2, eps=1e-4), 1e-6 + 1e-3 * 1e-2),
                          }[opt_name]
    ref_cfg = ref_tr.TransformerConfig(**CFG, dtype=jnp.float32)
    cfg = tr.TransformerConfig(**CFG, dtype=torch.float32)
    params = ref_tr.init_params(jax.random.PRNGKey(0), ref_cfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    batches = _batches(3)

    ref_losses = []
    want = ref_dense.transform_dense(
        batches, lambda p, b: ref_tr.lm_loss(p, b, ref_cfg),
        ref_dense.DenseParameterServer(params, ref_opt),
        on_step=lambda i, l: ref_losses.append((i, float(l))), steps_per_call=steps_per_call,
    )
    server = dense.DenseParameterServer(interop.transformer_params_from_numpy(tree, cfg, device="cpu"), opt)
    before = interop.transformer_params_to_numpy(server.params)
    losses = []
    got = dense.transform_dense(
        batches, lambda m, b: tr.lm_loss(m, b, cfg), server,
        on_step=lambda i, l: losses.append((i, float(l))), steps_per_call=steps_per_call,
    )
    assert [i for i, _ in losses] == [i for i, _ in ref_losses] == [0, 1, 2]
    np.testing.assert_allclose([l for _, l in losses], [l for _, l in ref_losses], rtol=1e-5)
    np.testing.assert_allclose([float(l) for l in got.worker_outputs],
                               [float(l) for l in want.worker_outputs], rtol=1e-5)
    final = interop.transformer_params_to_numpy(got.server_outputs[0])
    ref_final = jax.tree.map(lambda x: np.asarray(x, np.float32), want.server_outputs[0])
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(ref_final)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)
    # the caller's server is left as it was: weights and optimizer state
    after = interop.transformer_params_to_numpy(server.params)
    for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)
    assert server.opt_state["state"] == {}
    assert got.store is None and got.worker_state is None


def test_server_resumes_from_an_optimizer_state():
    """A server built from another's model copy and ``opt_state`` continues
    its Adam moments and step count, and shares no state with it."""
    rng = np.random.default_rng(2)
    module = nn.ParameterDict({"w": nn.Parameter(torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)))})
    a = dense.DenseParameterServer(module, optim.adamw(0.05))
    grads = [torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)) for _ in range(3)]
    a.push([grads[0]]).push([grads[1]])
    b = dense.DenseParameterServer(copy.deepcopy(module), optim.adamw(0.05), opt_state=a.opt_state)
    a.push([grads[2]])
    b.push([grads[2]])
    torch.testing.assert_close(b.pull()["w"], a.pull()["w"], rtol=0, atol=0)
    assert a.opt.state[module["w"]]["step"] == b.opt_state["state"][0]["step"] == 3


def test_errors():
    cfg = tr.TransformerConfig(**CFG, dtype=torch.float32)
    server = dense.DenseParameterServer(tr.init_params(cfg, device="cpu"), optim.sgd(0.1))
    with pytest.raises(ValueError, match="steps_per_call"):
        dense.transform_dense(_batches(1), lambda m, b: tr.lm_loss(m, b, cfg), server, steps_per_call=0)
    # batch_sharding is the dp DeviceMesh (tests/test_torch_zero1.py and the
    # one-rank test below run it); ZeRO-1 needs one, as the reference's does
    with pytest.raises(ValueError, match="DeviceMesh"):
        dense.transform_dense(_batches(1), lambda m, b: tr.lm_loss(m, b, cfg), server, batch_sharding=object())
    with pytest.raises(ValueError, match="requires mesh"):
        dense.make_dense_train_step(lambda m, b: 0, shard_opt_state=True)
    with pytest.raises(ValueError, match="gradients for"):
        server.push([torch.zeros(1)])


@pytest.fixture()
def one_rank_mesh():
    """A one-rank gloo ``("dp",)`` mesh in this process, torn down after."""
    from flink_parameter_server_tpu_torch.parallel.mesh import make_dp_mesh

    torch.distributed.init_process_group("gloo", store=torch.distributed.HashStore(), world_size=1, rank=0)
    try:
        yield make_dp_mesh(device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("regime", ["replicated", "zero1", "fsdp"])
def test_one_rank_dp_mesh_is_the_unsharded_run(one_rank_mesh, regime):
    """``transform_dense(batch_sharding=mesh)`` with ``lm_loss(mesh=)`` on a
    one-rank mesh, in each regime, is bitwise the unsharded run (every
    collective a copy), a row-masked batch included."""
    cfg = tr.TransformerConfig(**CFG, dtype=torch.float32)
    batches = _batches(3)
    batches[1]["mask"] = np.array([1.0, 0.0], np.float32)

    def server(mesh=None):
        model = tr.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
        if mesh is not None and regime == "fsdp":
            dense.fsdp_place(model, mesh)
        return dense.DenseParameterServer(model, optim.adamw(1e-2))

    want = dense.transform_dense(batches, lambda m, b: tr.lm_loss(m, b, cfg), server())
    mesh = one_rank_mesh
    got = dense.transform_dense(batches, lambda m, b: tr.lm_loss(m, b, cfg, mesh=mesh), server(mesh),
                                batch_sharding=mesh, shard_opt_state=regime == "zero1")
    assert [float(x) for x in got.worker_outputs] == [float(x) for x in want.worker_outputs]
    for a, b in zip(interop.transformer_params_to_numpy(got.server_outputs[0])["layers"],
                    interop.transformer_params_to_numpy(want.server_outputs[0])["layers"]):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
