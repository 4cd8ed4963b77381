"""The port's switch-MoE layer (``models/moe.py``) and the MoE Transformer
against the JAX package's mesh-less path, on the CPU.

The same numpy weights and inputs go through both packages.  Tolerances:
  * float32 routing (expert, slot, keep) EXACTLY the reference's: the
    argmax of a float32 softmax decides, and a different expert would be
    a different function, not a rounding;
  * float32 outputs atol 2e-5 (the reference's own ``moe_dense`` against
    ``moe_reference`` bar), gradients rtol 1e-4 / atol 1e-5, the MoE LM's
    logits atol 2e-4 (tests/test_torch_transformer.py's bar);
  * bfloat16: the gate product in bfloat16 may add in another order than
    XLA's, so a token whose top two probabilities nearly tie can take
    another expert; at most 2 % of tokens may be routed differently, and
    the output rows of the tokens routed alike agree within 2**-5 of the
    largest output magnitude.

Mirrors the single-device tests of tests/test_moe.py
(``test_moe_dense_matches_reference``, ``test_capacity_overflow_drops_tokens``
through ``moe_dense``, the gradient test against ``jax.grad`` and the
Transformer test against ``forward(mesh=None)``); the expert-parallel ones
run across gloo ranks in tests/test_torch_moe_ep.py, and here on a
one-rank ``("dp", "ep")`` mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.models import moe as ref_moe
from flink_parameter_server_tpu.models import transformer as ref_tr
from flink_parameter_server_tpu_torch import interop
from flink_parameter_server_tpu_torch.core.dense import DenseParameterServer, transform_dense
from flink_parameter_server_tpu_torch.core.optim import adamw
from flink_parameter_server_tpu_torch.models import moe
from flink_parameter_server_tpu_torch.models import transformer as tr

torch.set_num_threads(2)

D, F_, E = 16, 32, 8


def _cfgs(capacity, dtype="float32"):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    return (ref_moe.MoEConfig(d_model=D, d_ff=F_, num_experts=E, capacity=capacity, dtype=jdt),
            moe.MoEConfig(d_model=D, d_ff=F_, num_experts=E, capacity=capacity, dtype=tdt))


def _weights(seed, dtype="float32"):
    """The reference's init (its keys) as numpy, and both packages' copies."""
    ref_cfg, cfg = _cfgs(16, dtype)
    ref = ref_moe.init_moe_params(jax.random.PRNGKey(seed), ref_cfg)
    host = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    port = {k: torch.from_numpy(v.copy()).to(cfg.dtype) for k, v in host.items()}
    return ref, port


def _x(n, seed, dtype="float32"):
    x = np.random.default_rng(seed).normal(0, 1, (n, D)).astype(np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_moe_dense_matches_reference():
    """The bucketed single-device path == the O(E·N) oracle, in the port
    and against the reference's, including under capacity pressure."""
    ref_p, p = _weights(7)
    jx, x = _x(48, seed=8)
    for capacity in (16, 2):
        ref_cfg, cfg = _cfgs(capacity)
        got = _np(moe.moe_dense(p, x, cfg))
        np.testing.assert_allclose(got, _np(moe.moe_reference(p, x, cfg)), atol=2e-5)
        np.testing.assert_allclose(got, _np(ref_moe.moe_reference(ref_p, jx, ref_cfg)), atol=2e-5)
        np.testing.assert_allclose(got, _np(ref_moe.moe_dense(ref_p, jx, ref_cfg)), atol=2e-5)


def test_routing_matches_reference_exactly():
    ref_p, p = _weights(3)
    jx, x = _x(96, seed=4)
    for capacity in (1, 5, 16):
        want = ref_moe._route(jx, ref_p["w_gate"], E, capacity)
        got = moe._route(x, p["w_gate"], E, capacity)
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_allclose(np.asarray(want[3]), g_gate := got[3].numpy(), rtol=1e-6)
        assert g_gate.dtype == np.float32


@pytest.mark.parametrize("capacity", [1, 2])
def test_capacity_overflow_drops_tokens(capacity):
    """Through moe_dense: at most E × capacity tokens produce output, the
    rest are exactly 0, and every kept token — the one in the last slot of
    the last expert too, where the reference parks dropped tokens — keeps
    its expert's output (the reference's values)."""
    ref_p, p = _weights(2)
    jx, x = _x(64, seed=2)
    ref_cfg, cfg = _cfgs(capacity)
    got = _np(moe.moe_dense(p, x, cfg))
    expert, slot, keep, _gate = (t.numpy() for t in moe._route(x, p["w_gate"], E, capacity))
    nonzero = int(np.any(got != 0, axis=1).sum())
    assert nonzero <= E * capacity
    assert np.all(got[~keep] == 0) and np.all(np.any(got[keep] != 0, axis=1))
    assert (~keep).sum() > 0  # capacity pressure is real
    last = (expert == E - 1) & (slot == capacity - 1)
    assert last.sum() == 1 and np.any(got[last] != 0)
    np.testing.assert_allclose(got, _np(ref_moe.moe_dense(ref_p, jx, ref_cfg)), atol=2e-5)
    np.testing.assert_allclose(got, _np(ref_moe.moe_reference(ref_p, jx, ref_cfg)), atol=2e-5)


def test_moe_dense_gradients_match_jax():
    """d/d(params, x) of sum(moe_dense(...)**2), capacity 4 (some tokens
    dropped): the port's autograd against jax.grad of the reference's
    moe_dense."""
    ref_p, p = _weights(9)
    jx, x = _x(40, seed=10)
    ref_cfg, cfg = _cfgs(4)
    want = jax.grad(lambda prm, xx: jnp.sum(ref_moe.moe_dense(prm, xx, ref_cfg) ** 2), argnums=(0, 1))(ref_p, jx)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xg = x.clone().requires_grad_()
    torch.sum(moe.moe_dense(leaves, xg, cfg) ** 2).backward()
    for k in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(want[0][k]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-5)


def test_bf16_routing_disagreements_within_tolerance():
    ref_p, p = _weights(11, dtype="bfloat16")
    ref_p = {k: v.astype(jnp.bfloat16) for k, v in ref_p.items()}
    jx, x = _x(512, seed=12, dtype="bfloat16")
    ref_cfg, cfg = _cfgs(512, dtype="bfloat16")
    r_exp = np.asarray(ref_moe._route(jx, ref_p["w_gate"], E, 512)[0])
    g_exp = moe._route(x, p["w_gate"], E, 512)[0].numpy()
    same = r_exp == g_exp
    assert (~same).mean() <= 0.02, f"{(~same).sum()} of {len(same)} tokens routed differently"
    want, got = _np(ref_moe.moe_dense(ref_p, jx, ref_cfg)), _np(moe.moe_dense(p, x, cfg))
    scale = float(np.abs(want).max())
    assert np.abs(got[same] - want[same]).max() <= 2**-5 * scale


def _lm_configs(dtype="float32", capacity=12):
    args = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=16,
                num_experts=E, moe_capacity=capacity)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    return (ref_tr.TransformerConfig(**args, dtype=jdt),
            tr.TransformerConfig(**args, dtype=tdt, flash_attention="off"))


def test_transformer_with_moe_layers_matches_jax():
    """Every layer's MLP through moe_dense: the port's logits against the
    reference's forward(mesh=None) with the reference's weights carried
    across (capacity 12 of 64 tokens: some tokens dropped), and the tree
    round-trips through interop."""
    ref_cfg, cfg = _lm_configs()
    params = ref_tr.init_params(jax.random.PRNGKey(5), ref_cfg)
    tree = jax.tree.map(lambda v: np.asarray(v, np.float32), params)
    assert set(tree["layers"][0]) == {"attn_norm", "wqkv", "wo", "mlp_norm", "moe"}
    model = interop.transformer_params_from_numpy(tree, cfg, device="cpu")
    back = interop.transformer_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    tokens = np.random.default_rng(6).integers(0, 64, (4, 16)).astype(np.int32)
    want = np.asarray(ref_tr.forward(params, jnp.asarray(tokens), ref_cfg, mesh=None))
    got = tr.forward(model, torch.from_numpy(tokens), cfg).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_moe_lm_trains_and_init_matches_reference_tree():
    """init_params builds layers[i].moe.{w_gate, w_up, w_down} with the
    reference's shapes and dtypes; two adamw steps through the dense PS
    run and lower the loss on a repeated batch."""
    ref_cfg, cfg = _lm_configs("bfloat16")
    want = ref_tr.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for layer, ref_layer in zip(model.layers, want["layers"]):
        assert not hasattr(layer, "w_up")
        for k in tr.MOE_KEYS:
            assert tuple(layer.moe[k].shape) == ref_layer["moe"][k].shape
            assert layer.moe[k].dtype == torch.bfloat16 and ref_layer["moe"][k].dtype == jnp.bfloat16
    f32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = tr.init_params(f32_cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": np.random.default_rng(1).integers(0, 64, (4, 16)).astype(np.int32)}
    losses = []
    transform_dense([batch] * 6, lambda m, b: tr.lm_loss(m, b, f32_cfg),
                    DenseParameterServer(model, adamw(1e-2)),
                    on_step=lambda i, loss: losses.append(float(loss)))
    assert len(losses) == 6 and losses[-1] < losses[0]


def test_config_guards():
    """Expert parallelism is ported: the config takes ``ep_axis``, and
    ``moe_apply`` / ``init_moe_params(mesh=)`` take a torch DeviceMesh (any
    other mesh raises ``TypeError``)."""
    assert tr.TransformerConfig(num_experts=8, moe_capacity=4, ep_axis="ep").ep_axis == "ep"
    with pytest.raises(ValueError, match="moe_capacity"):
        tr.TransformerConfig(num_experts=8)
    _, cfg = _cfgs(4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        moe.moe_apply({}, torch.zeros(2, D), cfg, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        moe.init_moe_params(None, cfg, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            moe.init_moe_params(None, cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            tr.init_params(_lm_configs()[1])


@pytest.fixture()
def one_rank_ep_mesh():
    """A one-rank gloo ``("dp", "ep")`` mesh in this process, torn down after."""
    from flink_parameter_server_tpu_torch.parallel.mesh import single_device_mesh

    mesh = single_device_mesh(device_type="cpu", axis_names=("dp", "ep"))
    try:
        yield mesh
    finally:
        torch.distributed.destroy_process_group()


def test_one_rank_ep_mesh_is_moe_dense(one_rank_ep_mesh):
    """On a one-rank ``("dp", "ep")`` mesh (the card's NCCL layout) each
    all-to-all is a copy: ``init_moe_params(mesh=)`` keeps every expert of
    the same draw, ``moe_apply`` is ``moe_dense`` bitwise (capacity 4 of 48
    tokens: some drop), and so are its gradients; ``E % ep`` is checked."""
    _, cfg = _cfgs(4)
    mesh = one_rank_ep_mesh
    mine = moe.init_moe_params(torch.Generator().manual_seed(2), cfg, mesh)
    whole = moe.init_moe_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    for k in whole:
        torch.testing.assert_close(mine[k], whole[k], rtol=0, atol=0)
    _, x = _x(48, 9)
    grads = []
    for fn in (lambda p: moe.moe_apply(p, x, cfg, mesh=mesh), lambda p: moe.moe_dense(p, x, cfg)):
        p = {k: v.clone().requires_grad_() for k, v in whole.items()}
        y = fn(p)
        (y ** 2).sum().backward()
        grads.append((y.detach(), {k: v.grad for k, v in p.items()}))
    (y_ep, g_ep), (y_dense, g_dense) = grads
    assert (y_dense.abs().sum(1) == 0).any()
    torch.testing.assert_close(y_ep, y_dense, rtol=0, atol=0)
    for k in g_dense:
        torch.testing.assert_close(g_ep[k], g_dense[k], rtol=0, atol=0)
    assert moe.local_experts(8, mesh) == slice(0, 8)
