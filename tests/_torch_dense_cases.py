"""The dense LM's data-parallel cases, run by ``tests/_torch_mesh_child.py``.

Each case runs on every rank of a 1-D ``("dp",)`` gloo mesh (the
``dense`` battery: dp 4; ``dense2``: dp 2) and returns numpy arrays.  The
JAX parameters and the token batches come from ``<outdir>/inputs.npz``,
written by the test before the spawn; everything else is made from seeds
with numpy here.  Imports only numpy, torch and the port.
"""
from __future__ import annotations

import numpy as np

MLP_LR = 1e-2  # tests/test_zero1.py's adam(1e-2)
LM_CFG = dict(vocab_size=64, d_model=128, n_heads=2, n_layers=2, d_ff=128, max_seq=128)
LM_LR, LM_EPS = 1e-2, 1e-4  # tests/test_torch_dense.py's adamw arm
MEM_CFG = dict(vocab_size=1024, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=32)
REGIMES = ("replicated", "zero1", "fsdp")


def _np(t):
    import torch

    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def mlp_init():
    """tests/test_zero1.py's ``_setup`` parameters (seed 0)."""
    rng = np.random.default_rng(0)
    return {"w1": rng.normal(0, 0.1, (16, 32)).astype(np.float32), "b1": np.zeros(32, np.float32),
            "w2": rng.normal(0, 0.1, (32, 4)).astype(np.float32)}


def mlp_batches(n=4, b=64):
    """tests/test_zero1.py's ``_batches`` (seed 1), with a row mask whose
    valid rows differ between the ranks' slices."""
    r = np.random.default_rng(1)
    out = [{"x": r.normal(size=(b, 16)).astype(np.float32), "y": r.normal(size=(b, 4)).astype(np.float32)}
           for _ in range(n)]
    for i, batch in enumerate(out):
        batch["mask"] = unequal_mask(b, seed=10 + i)
    return out


def unequal_mask(b, seed):
    """A (b,) float mask whose quarters (and halves) hold different counts."""
    rng = np.random.default_rng(seed)
    keep = np.array([0.95, 0.6, 0.3, 0.05])[np.arange(b) * 4 // b]
    return (rng.random(b) < keep).astype(np.float32)


def _module(init):
    import torch
    from torch import nn

    return nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()})


def _mlp_out(p, b):
    import torch

    return torch.tanh(b["x"] @ p["w1"] + p["b1"]) @ p["w2"]


def mlp_loss(p, b):
    import torch

    return torch.mean((_mlp_out(p, b) - b["y"]) ** 2)


def _tensors(b):
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _state_shapes(opt, module):
    names = {id(p): n for n, p in module.named_parameters()}
    return {f"mu_shape_{names[id(p)]}": np.array(s["exp_avg"].shape) for p, s in opt.state.items()}


def _run_mlp(c, regime, masked):
    from flink_parameter_server_tpu_torch.core import dense, optim
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    module = _module(mlp_init())
    if regime == "fsdp":
        dense.fsdp_place(module, c.mesh)
    server = dense.DenseParameterServer(module, optim.adam(MLP_LR))
    mesh = None if regime in ("single", "fsdp") else c.mesh

    def masked_loss(p, b):
        err = ((_mlp_out(p, b) - b["y"]) ** 2).sum(-1)
        if mesh is None and regime == "single":
            return (err * b["mask"]).sum() / (b["mask"].sum()).clamp(min=1.0)
        m = c.mesh
        return coll.global_mean((err * b["mask"]).sum(), b["mask"].sum(), m)

    step = dense.make_dense_train_step(masked_loss if masked else mlp_loss, mesh=mesh,
                                       shard_opt_state=regime == "zero1")
    p, o = server.params, server.opt
    losses = []
    for b in mlp_batches():
        p, o, loss = step(p, o, _tensors(b))
        losses.append(float(loss))
    shapes = _state_shapes(o, p)
    whole = dense.gather_params(p)
    tag = f"{regime}{'_masked' if masked else ''}"
    out = {f"{tag}_loss": np.array(losses)}
    out.update({f"{tag}_{k}": _np(v) for k, v in whole.items()})
    out.update({f"{tag}_{k}": v for k, v in shapes.items()})
    out.update({f"{tag}_held_{k}": np.array(v.shape) for k, v in p.items()})
    return out


def case_mlp(c):
    """tests/test_zero1.py's MLP through the dense step: replicated, ZeRO-1
    and FSDP on the mesh, and the unsharded step, with the plain mean loss
    and a masked mean (unequal valid rows per rank) through global_mean."""
    out = {}
    for regime in REGIMES + ("single",):
        for masked in (False, True):
            out.update(_run_mlp(c, regime, masked))
    return out


def case_odd_leaf(c):
    """A leaf with no dp-divisible axis stays replicated; ZeRO-1's specs
    are the reference's."""
    import torch

    from flink_parameter_server_tpu_torch.core import dense, optim

    rng = np.random.default_rng(0)
    module = _module({"w": rng.normal(0, 0.1, (16, 32)).astype(np.float32),
                      "odd": rng.normal(0, 0.1, (3, 5)).astype(np.float32)})
    server = dense.DenseParameterServer(module, optim.adam(MLP_LR))
    specs = dense.opt_state_zero1_specs(server.opt, c.mesh)

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"]) ** 2) + torch.sum(p["odd"] ** 2)

    step = dense.make_dense_train_step(loss_fn, mesh=c.mesh, shard_opt_state=True)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    p, o, loss = step(server.params, server.opt, {"x": torch.from_numpy(x)})
    return dict(x=x, loss=np.float64(float(loss)), specs=np.array([str(s) for s in specs]),
                **_state_shapes(o, p), **{k: _np(v) for k, v in p.items()})


def case_refusals(c):
    """The reference's refusals: ZeRO-1 without a mesh, a mesh without
    ``dp``, a multi-axis mesh without ``opt_specs``; a batch dp does not
    divide."""
    import torch

    from flink_parameter_server_tpu_torch.core import dense
    from flink_parameter_server_tpu_torch.parallel.mesh import make_mesh

    said = []

    def refused(fn):
        try:
            fn()
        except ValueError as e:
            said.append(str(e))
            return
        said.append("did not raise")

    loss = lambda p, b: torch.zeros(())  # noqa: E731
    other = make_mesh(2, c.world // 2, device_type="cpu", axis_names=("data", "model"))
    wide = make_mesh(c.world, 1, device_type="cpu")
    refused(lambda: dense.make_dense_train_step(loss, shard_opt_state=True))
    refused(lambda: dense.make_dense_train_step(loss, mesh=other, shard_opt_state=True))
    refused(lambda: dense.make_dense_train_step(loss, mesh=wide, shard_opt_state=True))
    step = dense.make_dense_train_step(loss, mesh=c.mesh)
    module = _module(mlp_init())
    refused(lambda: step(module, torch.optim.SGD(module.parameters(), 0.1), {"x": torch.zeros(c.world + 1, 2)}))
    return dict(said=np.array(said))


def case_loss_routes(c):
    """A loss_fn that adds a regulariser to ``global_mean``'s result (the
    mark is lost, so neither gradient route fits) raises; the same
    regulariser folded into a mean over equal slices trains.  An LM with
    MoE layers builds and runs on the dp mesh, routing the whole batch:
    its global logits beside the mesh-less run's on the whole batch."""
    import torch

    from flink_parameter_server_tpu_torch.core import dense
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    module = _module(mlp_init())
    batch = _tensors(mlp_batches(1)[0])
    reg = lambda p: 1e-3 * torch.sum(p["w1"] ** 2)  # noqa: E731

    def mixed(p, b):
        err = torch.sum((_mlp_out(p, b) - b["y"]) ** 2, dim=1)
        return coll.global_mean(torch.sum(err * b["mask"]), torch.sum(b["mask"]), c.mesh) + reg(p)

    out = {}
    step = dense.make_dense_train_step(mixed, mesh=c.mesh)
    try:
        step(module, torch.optim.SGD(module.parameters(), 0.1), batch)
        out["mixed"] = "did not raise"
    except ValueError as e:
        out["mixed"] = str(e)
    with torch.no_grad():
        out["whole_loss"] = np.float64(float(mlp_loss(module, batch) + reg(module)))
    step = dense.make_dense_train_step(lambda p, b: mlp_loss(p, b) + reg(p), mesh=c.mesh)
    _, _, loss = step(module, torch.optim.SGD(module.parameters(), 0.1), batch)
    out["mean_route_loss"] = np.float64(float(loss))
    moe_cfg = tr.TransformerConfig(**LM_CFG, dtype=torch.float32, num_experts=4, moe_capacity=64)
    model = tr.init_params(moe_cfg, torch.Generator().manual_seed(4), mesh=c.mesh)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, LM_CFG["vocab_size"], (c.world, 16)))
    with torch.no_grad():
        rows = tr.forward(model, coll.dp_rows(tokens, c.mesh), moe_cfg, mesh=c.mesh)
        out["moe_whole"] = _np(tr.forward(model, tokens, moe_cfg))
    out["moe_forward"] = _np(coll.all_gather_cat(rows, c.mesh, "dp"))
    out["moe_init"] = np.array(len(model.layers[0].moe["w_up"]))
    return {k: np.array(v) for k, v in out.items()}


def _bytes(tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def case_memory(c):
    """tests/test_zero1_memory.py's three regimes on its small LM: the
    bytes of the parameters and of the optimizer state this rank holds
    after one step."""
    import torch

    from flink_parameter_server_tpu_torch.core import dense, optim
    from flink_parameter_server_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(**MEM_CFG, dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(0, MEM_CFG["vocab_size"], (8, MEM_CFG["max_seq"]))
    out = {}
    for regime in REGIMES:
        model = tr.init_params(cfg, torch.Generator().manual_seed(0), mesh=c.mesh)
        if regime == "fsdp":
            dense.fsdp_place(model, c.mesh)
        server = dense.DenseParameterServer(model, optim.adam(1e-3))
        before = _bytes(model.parameters())
        step = dense.make_dense_train_step(lambda m, b: tr.lm_loss(m, b, cfg, mesh=c.mesh),
                                           mesh=c.mesh, shard_opt_state=regime == "zero1")
        p, o, loss = step(model, server.opt, {"tokens": torch.from_numpy(tokens)})
        opt_bytes = _bytes(t for s in o.state.values() for t in s.values() if isinstance(t, torch.Tensor))
        out.update({f"{regime}_params_before": np.int64(before), f"{regime}_params": np.int64(_bytes(p.parameters())),
                    f"{regime}_opt": np.int64(opt_bytes), f"{regime}_loss": np.float64(float(loss))})
    return out


def lm_inputs(outdir):
    """The JAX-initialised LM weights and the batches the test wrote."""
    from flink_parameter_server_tpu_torch import interop

    z = np.load(outdir / "inputs.npz")
    layers = []
    for i in range(LM_CFG["n_layers"]):
        layers.append({k[len(f"lm_layer{i}_"):]: z[k] for k in z.files if k.startswith(f"lm_layer{i}_")})
    tree = {"embed": z["lm_embed"], "final_norm": z["lm_final_norm"], "layers": layers}
    batches = [{"tokens": z[f"lm_tokens{i}"]} for i in range(int(z["lm_steps"]))]
    return interop, tree, batches, z["lm_mask"]


def case_lm(c):
    """The small LM through ``transform_dense(batch_sharding=mesh)`` with
    ``lm_loss(mesh=)``: replicated, ZeRO-1 and FSDP, each with and without
    a (B,) row mask that leaves the ranks different token counts, beside
    the unsharded run."""
    import torch

    from flink_parameter_server_tpu_torch.core import dense, optim
    from flink_parameter_server_tpu_torch.models import transformer as tr

    interop, tree, batches, mask = lm_inputs(c.outdir)
    cfg = tr.TransformerConfig(**LM_CFG, dtype=torch.float32)
    out = {}
    for regime in REGIMES + ("single",):
        for masked in (False, True):
            data = [dict(b, mask=mask) for b in batches] if masked else batches
            mesh = None if regime == "single" else c.mesh
            server = interop.dense_server_from_numpy(tree, cfg, optim.adamw(LM_LR, eps=LM_EPS), mesh=mesh,
                                                     fsdp=regime == "fsdp", device="cpu")
            res = dense.transform_dense(data, lambda m, b: tr.lm_loss(m, b, cfg, mesh=mesh), server,
                                        batch_sharding=None if regime in ("single", "fsdp") else mesh,
                                        shard_opt_state=regime == "zero1")
            tag = f"{regime}{'_masked' if masked else ''}"
            out[f"{tag}_loss"] = np.array([float(x) for x in res.worker_outputs])
            flat = interop.transformer_params_to_numpy(res.server_outputs[0])
            out[f"{tag}_embed"] = flat["embed"]
            out[f"{tag}_final_norm"] = flat["final_norm"]
            for i, layer in enumerate(flat["layers"]):
                out.update({f"{tag}_layer{i}_{k}": v for k, v in layer.items()})
    return out


def case_flash_dp(c):
    """``flash_mha_dp`` on the global batch (the plain versions on the CPU)
    against the reference attention, forward and gradient; the gate's
    structural parts with the CUDA test patched true."""
    import torch

    from flink_parameter_server_tpu_torch.ops import flash_attention as fa
    from flink_parameter_server_tpu_torch.parallel.mesh import make_mesh
    from flink_parameter_server_tpu_torch.parallel.ring_attention import reference_attention

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, 128, 2, 64)).astype(np.float32)).requires_grad_()
               for _ in range(3))
    got = fa.flash_mha_dp(q, k, v, mesh=c.mesh)
    (got * got).sum().backward()
    grads = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    want = reference_attention(q, k, v)
    (want * want).sum().backward()
    gate = dict(cpu=fa.eligible_dp(128, 64, 4, c.mesh))
    sp = make_mesh(1, c.world, device_type="cpu", axis_names=("dp", "sp"))
    real = fa._mesh_on_cuda
    fa._mesh_on_cuda = lambda mesh: True
    try:
        gate.update(ok=fa.eligible_dp(128, 64, 4, c.mesh), odd_batch=fa.eligible_dp(128, 64, 3, c.mesh),
                    sp=fa.eligible_dp(128, 64, 4, sp), short=fa.eligible_dp(64, 64, 4, c.mesh))
    finally:
        fa._mesh_on_cuda = real
    try:
        fa.flash_mha_dp(q[:3], k[:3], v[:3], mesh=c.mesh)
        odd = "did not raise"
    except ValueError as e:
        odd = str(e)
    return dict(q=q.detach().numpy(), k=k.detach().numpy(), v=v.detach().numpy(), got=_np(got), want=_np(want),
                **{f"grad_{n}": _np(g) for n, g in zip("qkv", grads)},
                **{f"want_grad_{n}": _np(x.grad) for n, x in zip("qkv", (q, k, v))},
                **{f"gate_{k}": np.bool_(v) for k, v in gate.items()}, odd=np.array(odd))


def case_model_flash_dp(c):
    """``forward(mesh=)`` with "auto", the dp gate patched true: it calls
    ``flash_mha`` on this rank's rows once a layer and matches "off"."""
    import dataclasses

    import torch

    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa
    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel.collectives import dp_rows

    interop, tree, batches, _ = lm_inputs(c.outdir)
    cfg = tr.TransformerConfig(**LM_CFG, dtype=torch.float32, flash_attention="auto")
    model = interop.transformer_params_from_numpy(tree, cfg, mesh=c.mesh)
    tokens = torch.from_numpy(batches[0]["tokens"])
    mine = dp_rows(tokens, c.mesh)
    off = tr.forward(model, mine, dataclasses.replace(cfg, flash_attention="off"), mesh=c.mesh)
    calls = []
    real_gate, real_mha = fa.eligible_dp, fa.flash_mha

    def counting(q, k, v):
        calls.append(q.shape[0])
        return real_mha(q, k, v)

    fa.eligible_dp, fa.flash_mha = (lambda *a, **kw: True), counting
    try:
        auto = tr.forward(model, mine, cfg, mesh=c.mesh)
        loss = tr.lm_loss(model, {"tokens": mine}, cfg, mesh=c.mesh)
    finally:
        fa.eligible_dp, fa.flash_mha = real_gate, real_mha
    return dict(off=_np(coll.all_gather_cat(off, c.mesh, "dp")), auto=_np(coll.all_gather_cat(auto, c.mesh, "dp")),
                calls=np.array(calls), rows=np.int64(mine.shape[0]), loss=np.float64(float(loss.detach())))


CASES = {
    "dense": [case_mlp, case_odd_leaf, case_refusals, case_loss_routes, case_memory, case_lm],
    "dense2": [case_mlp, case_lm, case_flash_dp, case_model_flash_dp],
}
