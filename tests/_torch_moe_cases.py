"""Expert parallelism's cases, run by ``tests/_torch_mesh_child.py``.

Each case runs on every rank of a gloo mesh and returns numpy arrays: the
``ep8`` battery is the ``("dp", "ep")`` mesh at (1, 8), ``ep24`` at (2, 4),
``moe_dp`` the 1-D ``("dp",)`` mesh at dp 4.  The JAX weights, the inputs
and the token batches come from ``<outdir>/inputs.npz``, written by
``tests/test_torch_moe_ep.py`` before the spawn.  Imports only numpy, torch
and the port.
"""
from __future__ import annotations

import numpy as np

MOE_CFG = dict(d_model=16, d_ff=32, num_experts=8)  # tests/test_moe.py's CFG (capacity per case)
CAPACITY = {"apply": 16, "drop": 1, "grad": 16}
# tests/test_moe.py:88's LM (capacity 64: no drops) and the training runs'
# (capacity 3 of a dp shard's 32 tokens: some drop)
LM_CFG = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq=8, num_experts=8)
LM_CAPACITY, TRAIN_CAPACITY, DP_CAPACITY = 64, 3, 6
LM_LR, LM_EPS = 1e-2, 1e-4  # tests/test_torch_dense.py's adamw arm
REGIMES = ("replicated", "zero1", "fsdp")


def _np(t):
    import torch

    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _inputs(c):
    return np.load(c.outdir / "inputs.npz")


def _moe_params(z, tag, mesh, requires_grad=False):
    """The reference's whole ``tag_*`` leaves, this rank's experts kept."""
    import torch

    from flink_parameter_server_tpu_torch.models.moe import local_experts

    mine = local_experts(MOE_CFG["num_experts"], mesh)
    out = {}
    for k in ("w_gate", "w_up", "w_down"):
        v = z[f"{tag}_{k}"] if k == "w_gate" else z[f"{tag}_{k}"][mine]
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).requires_grad_(requires_grad)
    return out


def _cfg(capacity):
    from flink_parameter_server_tpu_torch.models.moe import MoEConfig

    return MoEConfig(**MOE_CFG, capacity=capacity)


def _my_rows(x, c):
    """This rank's dp rows of a global (N, d) array."""
    per = x.shape[0] // c.dp
    return x[c.dp_index * per:(c.dp_index + 1) * per]


def case_moe_apply(c):
    """``moe_apply`` on this rank's dp rows for tests/test_moe.py's
    ``apply`` (capacity 16) and ``drop`` (capacity 1) inputs, and the
    all-to-all's counts for one forward and one backward."""
    import torch

    from flink_parameter_server_tpu_torch.models import moe
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    z = _inputs(c)
    out = {}
    for tag in ("apply", "drop"):
        x = torch.from_numpy(_my_rows(z[f"{tag}_x"], c))
        coll.reset_collective_counts()
        got = moe.moe_apply(_moe_params(z, tag, c.mesh), x, _cfg(CAPACITY[tag]), mesh=c.mesh)
        counts = coll.collective_counts()
        out[tag] = _np(got)
        out[f"{tag}_a2a_calls"] = np.int64(counts["all_to_all"])
        out[f"{tag}_a2a_bytes"] = np.int64(counts["all_to_all_bytes"])
    params = _moe_params(z, "apply", c.mesh, requires_grad=True)
    x = torch.from_numpy(_my_rows(z["apply_x"], c)).requires_grad_()  # so both trips run backward
    coll.reset_collective_counts()
    (moe.moe_apply(params, x, _cfg(16), mesh=c.mesh) ** 2).sum().backward()
    out["fwd_bwd_a2a_calls"] = np.int64(coll.collective_counts()["all_to_all"])
    try:
        moe.moe_apply(_moe_params(z, "apply", c.mesh), x.detach(), moe.MoEConfig(16, 32, c.ep * 3 // 2 + 1, 4),
                      mesh=c.mesh)
        out["odd_experts"] = np.array("did not raise")
    except ValueError as e:
        out["odd_experts"] = np.array(str(e))
    return out


def case_grad(c):
    """Gradients of ``sum(moe_apply(x)**2)`` over this rank's rows
    (tests/test_moe.py:69), and the planted fault: the same with the
    experts' division by ep taken out, so their gradients come out ep
    times too large."""
    import torch

    from flink_parameter_server_tpu_torch.models import moe

    z = _inputs(c)
    x = torch.from_numpy(_my_rows(z["grad_x"], c))
    out = {}
    real = moe._EpCopies.apply
    for tag, planted in (("grad", False), ("fault", True)):
        params = _moe_params(z, "grad", c.mesh, requires_grad=True)
        if planted:
            moe._EpCopies.apply = lambda w, ep: w
        try:
            (moe.moe_apply(params, x, _cfg(CAPACITY["grad"]), mesh=c.mesh) ** 2).sum().backward()
        finally:
            moe._EpCopies.apply = real
        out.update({f"{tag}_{k}": _np(v.grad) for k, v in params.items()})
    return out


def case_init(c):
    """``init_moe_params(mesh=)`` keeps this rank's experts of the whole
    draw from the same generator; ``w_gate`` is whole."""
    import torch

    from flink_parameter_server_tpu_torch.models import moe

    cfg = _cfg(4)
    mine = moe.init_moe_params(torch.Generator().manual_seed(11), cfg, c.mesh)
    whole = moe.init_moe_params(torch.Generator().manual_seed(11), cfg, device="cpu")
    sl = moe.local_experts(cfg.num_experts, c.mesh)
    return dict(start=np.int64(sl.start), stop=np.int64(sl.stop),
                **{f"mine_{k}": _np(v) for k, v in mine.items()},
                **{f"whole_{k}": _np(v)[slice(None) if k == "w_gate" else sl] for k, v in whole.items()})


def lm_tree(z, prefix="lm"):
    """The reference's LM pytree from ``inputs.npz``."""
    layers = []
    for i in range(LM_CFG["n_layers"]):
        head = f"{prefix}_layer{i}_"
        layer = {k[len(head):]: z[k] for k in z.files if k.startswith(head) and not k[len(head):].startswith("moe_")}
        layer["moe"] = {k: z[f"{head}moe_{k}"] for k in ("w_gate", "w_up", "w_down")}
        layers.append(layer)
    return {"embed": z[f"{prefix}_embed"], "final_norm": z[f"{prefix}_final_norm"], "layers": layers}


def _lm_cfg(capacity, **kw):
    import torch

    from flink_parameter_server_tpu_torch.models import transformer as tr

    return tr.TransformerConfig(**LM_CFG, moe_capacity=capacity, dtype=torch.float32, **kw)


def case_lm(c):
    """tests/test_moe.py:88: the MoE LM on the ep mesh (capacity 64), the
    global logits all-gathered over dp; the model's tree gathered back
    whole (experts over ep); the expert leaves a rank holds."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    z = _inputs(c)
    cfg = _lm_cfg(LM_CAPACITY, ep_axis="ep")
    model = interop.transformer_params_from_numpy(lm_tree(z), cfg, mesh=c.mesh)
    tokens = torch.from_numpy(z["lm_tokens0"][:4])
    with torch.no_grad():
        rows = tr.forward(model, coll.dp_rows(tokens, c.mesh), cfg, mesh=c.mesh)
    back = interop.transformer_params_to_numpy(model)
    out = dict(logits=_np(coll.all_gather_cat(rows, c.mesh, "dp")),
               held_w_up=np.array(model.layers[0].moe["w_up"].shape),
               back_w_up=back["layers"][0]["moe"]["w_up"], back_w_down=back["layers"][1]["moe"]["w_down"],
               back_wqkv=back["layers"][0]["wqkv"])
    return out


# the LM at the flash kernels' shape gate (T 128, head_dim 64), 1 layer
FLASH_LM_CFG = dict(vocab_size=64, d_model=128, n_heads=2, n_layers=1, d_ff=64, max_seq=128, num_experts=8)
FLASH_CAPACITY, FLASH_BATCH = 64, 4  # 256 tokens a dp shard, 32 an expert on average


def case_flash_ep(c):
    """The flash gate on the ep mesh: ``eligible_dp`` with and without the
    ep axis (its CUDA test patched true), and the MoE LM at the kernels'
    shape under "auto" and "on", which call ``flash_mha`` on the rank's
    rows (the plain versions on the CPU), against "off": the global
    logits, the loss, and the gradient of the rank's ``wqkv``; the model's
    tree gathered whole for the reference."""
    import dataclasses

    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    cfg = tr.TransformerConfig(**FLASH_LM_CFG, moe_capacity=FLASH_CAPACITY, ep_axis="ep", dtype=torch.float32,
                               flash_attention="off")
    model = tr.init_params(cfg, torch.Generator().manual_seed(7), mesh=c.mesh)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (FLASH_BATCH, cfg.max_seq)).astype(np.int64)
    rows = coll.dp_rows(torch.from_numpy(tokens), c.mesh)
    flat = interop.transformer_params_to_numpy(model)
    out = dict(tokens=tokens, tree_embed=flat["embed"], tree_final_norm=flat["final_norm"])
    for i, layer in enumerate(flat["layers"]):
        out.update({f"tree_layer{i}_{k}": v for k, v in layer.items() if k != "moe"})
        out.update({f"tree_layer{i}_moe_{k}": v for k, v in layer["moe"].items()})
    calls, real_cuda, real_mha = [], fa._mesh_on_cuda, fa.flash_mha

    def counting(q, k, v):
        calls.append(q.shape[0])
        return real_mha(q, k, v)

    fa._mesh_on_cuda, fa.flash_mha = (lambda mesh: True), counting
    try:
        out.update(gate_ep=fa.eligible_dp(128, 64, FLASH_BATCH, c.mesh, "dp", "ep"),
                   gate_no_ep=fa.eligible_dp(128, 64, FLASH_BATCH, c.mesh, "dp"),
                   gate_odd=fa.eligible_dp(128, 64, FLASH_BATCH + 1, c.mesh, "dp", "ep"))
        for mode in ("off", "auto", "on"):
            run = dataclasses.replace(cfg, flash_attention=mode)
            model.zero_grad(set_to_none=True)
            with torch.no_grad():
                logits = tr.forward(model, rows, run, mesh=c.mesh)
            loss = tr.lm_loss(model, {"tokens": rows}, run, mesh=c.mesh)
            loss.backward()
            out[f"{mode}_logits"] = _np(coll.all_gather_cat(logits, c.mesh, "dp"))
            out[f"{mode}_loss"] = np.float64(float(loss.detach()))
            out[f"{mode}_grad_wqkv"] = _np(model.layers[0].wqkv.grad)
            out[f"{mode}_calls"] = np.array(calls)
            calls.clear()
    finally:
        fa._mesh_on_cuda, fa.flash_mha = real_cuda, real_mha
    return {k: (np.bool_(v) if isinstance(v, bool) else v) for k, v in out.items()}


def case_regimes(c):
    """The MoE LM (capacity 3 a dp shard: tokens drop) through
    ``transform_dense(batch_sharding=mesh)`` on the ep mesh, replicated,
    ZeRO-1 and FSDP: the losses, the whole trained tree, and the shapes of
    the expert leaf and its Adam moment a rank holds."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.core import dense, optim
    from flink_parameter_server_tpu_torch.models import transformer as tr

    z = _inputs(c)
    cfg = _lm_cfg(TRAIN_CAPACITY, ep_axis="ep")
    batches = [{"tokens": z[f"lm_tokens{i}"]} for i in range(int(z["lm_steps"]))]
    out = {}
    for regime in REGIMES:
        server = interop.dense_server_from_numpy(lm_tree(z), cfg, optim.adamw(LM_LR, eps=LM_EPS), mesh=c.mesh,
                                                 fsdp=regime == "fsdp")
        res = dense.transform_dense(batches, lambda m, b: tr.lm_loss(m, b, cfg, mesh=c.mesh), server,
                                    batch_sharding=None if regime == "fsdp" else c.mesh,
                                    shard_opt_state=regime == "zero1")
        final = res.server_outputs[0]
        out[f"{regime}_loss"] = np.array([float(x) for x in res.worker_outputs])
        flat = interop.transformer_params_to_numpy(final)
        out[f"{regime}_embed"] = flat["embed"]
        out[f"{regime}_final_norm"] = flat["final_norm"]
        for i, layer in enumerate(flat["layers"]):
            out.update({f"{regime}_layer{i}_{k}": v for k, v in layer.items() if k != "moe"})
            out.update({f"{regime}_layer{i}_moe_{k}": v for k, v in layer["moe"].items()})
        out[f"{regime}_held_w_up"] = np.array(final.layers[0].moe["w_up"].shape)
    server = interop.dense_server_from_numpy(lm_tree(z), cfg, optim.adamw(LM_LR, eps=LM_EPS), mesh=c.mesh)
    step = dense.make_dense_train_step(lambda m, b: tr.lm_loss(m, b, cfg, mesh=c.mesh), mesh=c.mesh,
                                       shard_opt_state=True,
                                       opt_specs=dense.opt_state_zero1_specs(server.opt, c.mesh, params=server.params))
    p, o, _ = step(server.params, server.opt, {"tokens": torch.from_numpy(batches[0]["tokens"])})
    out["zero1_mu_w_up"] = np.array(o.state[p.layers[0].moe["w_up"]]["exp_avg"].shape)
    return out


def case_specs(c):
    """ZeRO-1's specs for the MoE LM on the ep mesh, by parameter name (the
    reference's ``_merged_dp_specs`` of the same tree), and the refusal
    without the module, whose recorded layout they merge into."""
    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.core import dense, optim

    z = _inputs(c)
    cfg = _lm_cfg(LM_CAPACITY, ep_axis="ep")
    server = interop.dense_server_from_numpy(lm_tree(z), cfg, optim.adamw(LM_LR), mesh=c.mesh)
    names = [n for n, _ in server.params.named_parameters()]
    merged = dense.opt_state_zero1_specs(server.opt, c.mesh, params=server.params)
    try:
        bare = str(dense.opt_state_zero1_specs(server.opt, c.mesh))
    except ValueError as e:
        bare = str(e)
    return dict(names=np.array(names), specs=np.array([str(s) for s in merged]), bare=np.array(bare))


def case_dp_routing(c):
    """On the dp-only mesh the MoE LM (capacity 6 over the global batch's
    64 tokens: some drop) routes the WHOLE batch: the global logits, the
    mesh-less run on the whole batch, and the per-rank routing (each
    rank's rows alone through the mesh-less model); each layer's kept
    token count in the global run; then 2 training steps on the mesh
    against the mesh-less steps."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.core import dense, optim
    from flink_parameter_server_tpu_torch.models import moe
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    z = _inputs(c)
    cfg = _lm_cfg(DP_CAPACITY)
    model = interop.transformer_params_from_numpy(lm_tree(z), cfg, mesh=c.mesh)
    tokens = torch.from_numpy(z["lm_tokens0"])
    rows = coll.dp_rows(tokens, c.mesh)
    kept = []
    real = moe._route

    def spy(x, w, E, C):
        r = real(x, w, E, C)
        kept.append((int(r[2].sum()), x.shape[0]))
        return r

    with torch.no_grad():
        on_mesh = tr.forward(model, rows, cfg, mesh=c.mesh)
        moe._route = spy
        try:
            whole = tr.forward(model, tokens, cfg)
        finally:
            moe._route = real
        per_rank = tr.forward(model, rows, cfg)
    out = dict(dp=_np(coll.all_gather_cat(on_mesh, c.mesh, "dp")), whole=_np(whole),
               per_rank=_np(coll.all_gather_cat(per_rank, c.mesh, "dp")), kept=np.array(kept))
    batches = [{"tokens": z[f"lm_tokens{i}"]} for i in range(2)]
    for tag, mesh in (("mesh", c.mesh), ("single", None)):
        server = interop.dense_server_from_numpy(lm_tree(z), cfg, optim.adamw(LM_LR, eps=LM_EPS), mesh=mesh,
                                                 device="cpu")
        res = dense.transform_dense(batches, lambda m, b: tr.lm_loss(m, b, cfg, mesh=mesh), server,
                                    batch_sharding=mesh)
        out[f"{tag}_loss"] = np.array([float(x) for x in res.worker_outputs])
        flat = interop.transformer_params_to_numpy(res.server_outputs[0])
        out[f"{tag}_w_up"] = flat["layers"][0]["moe"]["w_up"]
        out[f"{tag}_w_gate"] = flat["layers"][1]["moe"]["w_gate"]
        out[f"{tag}_wqkv"] = flat["layers"][0]["wqkv"]
    return out


CASES = {
    "ep8": [case_moe_apply, case_grad, case_init],
    "ep24": [case_moe_apply, case_grad, case_init, case_lm, case_regimes, case_specs, case_flash_ep],
    "moe_dp": [case_dp_routing],
}
