"""Tensor, sequence (ring) and pipeline parallelism's cases, and MoE
layers beside them, run by ``tests/_torch_mesh_child.py``.

Each case runs on every rank of the ``mp`` battery (8 gloo ranks) and
returns numpy arrays.  The base mesh is ``("dp", "sp")`` at (2, 4); a case
that needs another layout builds it over the same 8 ranks (``_mesh``: the
reference's ``make_mesh(a, b, axis_names=...)`` or ``Mesh(devices.reshape(
2, 2, 2), names)``, rank ``r`` at the row-major coordinates of ``r``).
The JAX weights, inputs and token batches come from ``<outdir>/inputs.npz``,
written by ``tests/test_torch_model_parallel.py`` before the spawn.
Imports only numpy, torch and the port.
"""
from __future__ import annotations

import numpy as np

# tests/test_transformer.py's TINY (float32)
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32)
# the flash gate's LM: the kernels' shape (T 128, head_dim 64), 4 heads for tp 4
FLASH_TINY = dict(vocab_size=64, d_model=256, n_heads=4, n_layers=1, d_ff=64, max_seq=128)
# tests/test_flash_attention.py:257's config
PP_FLASH = dict(vocab_size=64, d_model=128, n_heads=2, n_layers=2, d_ff=128, max_seq=128)
LR, EPS = 1e-2, 1e-4  # tests/test_torch_dense.py's adamw arm
REGIMES = ("replicated", "zero1", "fsdp")
SWEEP = ((2, 2), (4, 1), (4, 4), (8, 2))  # tests/test_property_extras.py:79's (S, M)
RING_SWEEP = ((1, 16, 1, 4, 8), (3, 64, 2, 16, 4), (2, 24, 5, 8, 2))  # :63's (B, T, H, D, sp)
# the trees the test writes: name -> (n_layers, JAX key); "moe" has MoE layers (MOE_EXPERTS experts)
TREES = {"tp": (2, 1), "sp": (2, 2), "pp": (4, 4), "ppsp": (4, 6), "ppspg": (2, 8), "train": (2, 0), "moe": (2, 10)}
MOE_EXPERTS = 4
NO_DROP = 128  # the batch's 128 tokens: no routing drops a token at this capacity
# the LM layouts the reference runs beside the earlier ones, each on its tree ("moe", or "tp" for the dense
# pp x tp) and the (8, 16) moe_tokens: name -> (mesh shape, axes, config fields, microbatches (None: forward),
# a capacity that drops tokens under the layout's rule (None: dense), the planted fault).  The faults:
# "tp_sum" sums over tp the gradients every tp rank already holds whole (the experts', or the stages');
# "slice" routes each sp rank's positions alone (the port before the sp gather); "shard" routes a pipeline
# stage's MoE over the whole dp shard (1 microbatch) instead of each microbatch
LAYOUTS = {
    "moe_tp": ((2, 4), ("dp", "tp"), dict(tp_axis="tp"), None, 8, "tp_sum"),
    "moe_ep_tp": ((2, 2, 2), ("dp", "ep", "tp"), dict(ep_axis="ep", tp_axis="tp"), None, 8, "tp_sum"),
    "moe_ep_sp": ((2, 2, 2), ("dp", "ep", "sp"), dict(ep_axis="ep", sp_axis="sp", use_ring_attention=True), None, 8,
                  "slice"),
    "moe_sp": ((2, 4), ("dp", "sp"), dict(sp_axis="sp", use_ring_attention=True), None, 8, "slice"),
    "moe_pp": ((4, 2), ("dp", "pp"), dict(pp_axis="pp"), 2, 4, "shard"),
    "moe_pp_ep": ((2, 2, 2), ("dp", "pp", "ep"), dict(pp_axis="pp", ep_axis="ep"), 2, 4, "shard"),
    "moe_pp_sp": ((2, 2, 2), ("dp", "pp", "sp"), dict(pp_axis="pp", sp_axis="sp", use_ring_attention=True), 2, 4,
                  "shard"),
    "pp_tp": ((2, 2, 2), ("dp", "pp", "tp"), dict(pp_axis="pp", tp_axis="tp"), 2, None, "tp_sum"),
}
MOE_REGIMES = ("moe_tp", "moe_ep_tp")  # the layouts trained in each of REGIMES, at their dropping capacity


def layout_capacities(name):
    """The capacities a layout runs at: its dropping one and NO_DROP (a
    dense layout: None)."""
    drop = LAYOUTS[name][4]
    return (None,) if drop is None else (drop, NO_DROP)

_MESHES = {}


def pack(tree, prefix):
    """A reference LM pytree (numpy leaves) as flat ``inputs.npz`` entries."""
    out = {f"{prefix}_embed": tree["embed"], f"{prefix}_final_norm": tree["final_norm"]}
    for i, layer in enumerate(tree["layers"]):
        for k, v in layer.items():
            if k == "moe":
                out.update({f"{prefix}_layer{i}_moe_{m}": w for m, w in v.items()})
            else:
                out[f"{prefix}_layer{i}_{k}"] = v
    return out


def unpack(z, prefix, n_layers):
    layers = []
    for i in range(n_layers):
        head = f"{prefix}_layer{i}_"
        layer = {k[len(head):]: np.asarray(z[k]) for k in z.files if k.startswith(head)}
        moe = {k[len("moe_"):]: layer.pop(k) for k in list(layer) if k.startswith("moe_")}
        layers.append(dict(layer, **({"moe": moe} if moe else {})))
    return {"embed": np.asarray(z[f"{prefix}_embed"]), "final_norm": np.asarray(z[f"{prefix}_final_norm"]),
            "layers": layers}


def _np(t):
    import torch

    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _inputs(c):
    return np.load(c.outdir / "inputs.npz")


def _mesh(shape, names):
    """A mesh over the 8 ranks, built once a battery."""
    from flink_parameter_server_tpu_torch.parallel.mesh import make_nd_mesh

    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = make_nd_mesh(shape, names, device_type="cpu")
    return _MESHES[key]


def _cfg(base=TINY, **kw):
    import torch

    from flink_parameter_server_tpu_torch.models import transformer as tr

    return tr.TransformerConfig(**dict(base, **kw), dtype=torch.float32)


def _rows(x, mesh, axis="dp"):
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    return coll.dp_rows(x, mesh, axis)


def _gather(t, mesh, *axes_dims):
    """The global tensor of this rank's block: all-gathered over each
    (axis, dim), innermost first."""
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    for axis, dim in axes_dims:
        t = coll.all_gather_cat(t.contiguous(), mesh, axis, dim)
    return t


def _summed_grads(model, mesh, dp_axis="dp"):
    """The dense step's gradient rule without its update: the model's
    recorded sum axes, then dp; returns the gathered tree of gradients
    (the reference's layout) through a copy whose values are the grads."""
    import copy

    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.core import dense
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    named = list(model.named_parameters())
    with torch.no_grad():
        dense._sum_over_model_axes(named, dense.model_layout(model))
        for _, p in named:
            p.grad = coll.all_reduce_sum(p.grad, mesh, dp_axis)
    grads = copy.deepcopy(model)
    with torch.no_grad():
        for (_, g), (_, p) in zip(grads.named_parameters(), named):
            g.copy_(p.grad)
    return interop.transformer_params_to_numpy(grads)


def _mean_logp0(logits, mesh, axes):
    """The reference tests' loss ``mean(log_softmax(logits)[..., 0])`` over
    the global (B, T), from this rank's logits."""
    import torch

    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    local = torch.log_softmax(logits, -1)[..., 0]
    return coll.global_mean(local.sum(), torch.tensor(float(local.numel())), mesh, axes)


# ---------------------------------------------------------------- ring attention


def case_ring(c):
    """tests/test_transformer.py:38 / :44 / :50 / :141 on the (2, 4)
    ``("dp", "sp")`` mesh: ``ring_attention`` on the global q, k, v (each
    rank its dp and sp block, the output all-gathered), causal and not;
    the gradients of ``sum(out**2)``; bf16 inputs."""
    import torch

    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel.ring_attention import ring_attention

    z = _inputs(c)
    out = {}
    for tag, causal in (("causal", True), ("noncausal", False)):
        q, k, v = (torch.from_numpy(z[f"ring_{tag}_{n}"]) for n in "qkv")
        out[tag] = _np(ring_attention(q, k, v, mesh=c.mesh, causal=causal))
    q, k, v = (torch.from_numpy(z[f"ring_grad_{n}"]).requires_grad_() for n in "qkv")
    coll.reset_collective_counts()
    (ring_attention(q, k, v, mesh=c.mesh) ** 2).sum().backward()
    out["grad_ppermutes"] = np.int64(coll.collective_counts()["ppermute"])
    out.update({f"grad_{n}": _np(t.grad) for n, t in zip("qkv", (q, k, v))})
    q, k, v = (torch.from_numpy(z[f"ring_bf16_{n}"]).to(torch.bfloat16) for n in "qkv")
    got = ring_attention(q, k, v, mesh=c.mesh)
    out["bf16"], out["bf16_dtype"] = _np(got), np.array(str(got.dtype))
    return out


def case_ring_sweep(c):
    """tests/test_property_extras.py:63: ``ring_attention`` with
    ``dp_axis=None`` on ``(8/sp, sp)`` ``("dp", "sp")`` meshes at three
    shapes (odd heads, T 24 over sp 2, one position a rank at sp 8)."""
    import torch

    from flink_parameter_server_tpu_torch.parallel.ring_attention import ring_attention

    out = {}
    for B, T, H, D, sp in RING_SWEEP:
        rng = np.random.default_rng(B * T + H)
        q, k, v = (torch.from_numpy(rng.normal(0, 1, (B, T, H, D)).astype(np.float32)) for _ in range(3))
        tag = f"b{B}t{T}h{H}d{D}sp{sp}"
        out[tag] = _np(ring_attention(q, k, v, mesh=_mesh((8 // sp, sp), ("dp", "sp")), dp_axis=None))
        out[tag + "_q"], out[tag + "_k"], out[tag + "_v"] = _np(q), _np(k), _np(v)
    return out


# ---------------------------------------------------------------- tensor parallelism


def case_tp(c):
    """tests/test_transformer.py:100: the LM with ``tp_axis="ps"`` on
    ``make_mesh(2, 4)`` (dp 2, tp 4), the reference's weights carried in
    (each rank its heads' columns of q, k and v), the global logits; the
    tree gathered back; the gradients of ``lm_loss`` summed over dp
    against the mesh-less model's, and the same with ``copy_to_tp`` made
    the identity (a planted fault: the tp-replicated leaves then see only
    their rank's heads)."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    z = _inputs(c)
    mesh = _mesh((2, 4), ("dp", "ps"))
    cfg = _cfg(tp_axis="ps")
    tree = unpack(z, "tp", 2)
    model = interop.transformer_params_from_numpy(tree, cfg, mesh=mesh)
    tokens = torch.from_numpy(z["tp_tokens"]).long()
    with torch.no_grad():
        logits = tr.forward(model, _rows(tokens, mesh), cfg, mesh=mesh)
    out = dict(logits=_np(_gather(logits, mesh, ("dp", 0))), held_wqkv=np.array(model.layers[0].wqkv.shape),
               held_wo=np.array(model.layers[0].wo.shape), held_w_up=np.array(model.layers[0].w_up.shape),
               **pack(interop.transformer_params_to_numpy(model), "back"))
    single = interop.transformer_params_from_numpy(tree, _cfg(), device="cpu")
    tr.lm_loss(single, {"tokens": tokens}, _cfg()).backward()
    flat = _np(torch.cat([p.grad.reshape(-1) for p in single.parameters()]))
    for tag, planted in (("grad", False), ("fault", True)):
        m = interop.transformer_params_from_numpy(tree, cfg, mesh=mesh)
        real = coll.copy_to_tp
        if planted:
            coll.copy_to_tp = lambda x, mesh, axis: x
        try:
            coll.reset_collective_counts()
            tr.lm_loss(m, {"tokens": _rows(tokens, mesh)}, cfg, mesh=mesh).backward()
            counts = coll.collective_counts()
        finally:
            coll.copy_to_tp = real
        grads = _summed_grads(m, mesh)
        got = np.concatenate([v.reshape(-1) for v in _grad_leaves(grads)])
        out[f"{tag}_err"] = np.float64(np.abs(got - flat).max())
        out[f"{tag}_attn_norm"] = grads["layers"][0]["attn_norm"]
        out[f"{tag}_all_reduces"] = np.int64(counts["all_reduce"])
    out["single_attn_norm"] = _np(single.layers[0].attn_norm.grad)
    return out


def _grad_leaves(tree):
    """A tree's leaves in the module's parameter order."""
    yield tree["embed"]
    yield tree["final_norm"]
    for layer in tree["layers"]:
        for k in ("attn_norm", "wqkv", "wo", "mlp_norm", "w_up", "w_down"):
            yield layer[k]


def case_tp_flash(c):
    """The flash gate on a tp mesh ((2, 4) ``("dp", "tp")``, the kernels'
    shape): ``eligible_dp`` with and without ``tp_axis`` (its CUDA test
    patched true); "auto" and "on" call ``flash_mha`` on each rank's
    ``(B/dp, T, H/tp, D)`` tensors, counted (the plain versions on the
    CPU), and match "off"; "on" raises in ``forward_pipelined`` on a
    ``("dp", "pp")`` mesh (tests/test_flash_attention.py:257)."""
    import dataclasses

    import torch

    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa

    mesh = _mesh((2, 4), ("dp", "tp"))
    cfg = _cfg(FLASH_TINY, tp_axis="tp", flash_attention="off")
    model = tr.init_params(cfg, torch.Generator().manual_seed(7), mesh=mesh)
    tokens = np.random.default_rng(8).integers(0, 64, (4, 128))
    rows = _rows(torch.from_numpy(tokens), mesh)
    out = {}
    calls, real_cuda, real_mha = [], fa._mesh_on_cuda, fa.flash_mha

    def counting(q, k, v):
        calls.append(tuple(q.shape))
        return real_mha(q, k, v)

    fa._mesh_on_cuda, fa.flash_mha = (lambda m: True), counting
    try:
        out.update(gate_tp=np.bool_(fa.eligible_dp(128, 64, 4, mesh, "dp", None, "tp")),
                   gate_no_tp=np.bool_(fa.eligible_dp(128, 64, 4, mesh, "dp")))
        for mode in ("off", "auto", "on"):
            run = dataclasses.replace(cfg, flash_attention=mode)
            model.zero_grad(set_to_none=True)
            loss = tr.lm_loss(model, {"tokens": rows}, run, mesh=mesh)
            loss.backward()
            with torch.no_grad():
                out[f"{mode}_logits"] = _np(tr.forward(model, rows, run, mesh=mesh))
            out[f"{mode}_loss"] = np.float64(float(loss))
            out[f"{mode}_grad_wqkv"] = _np(model.layers[0].wqkv.grad)
            out[f"{mode}_calls"] = np.array(calls).reshape(-1, 4)
            calls.clear()
    finally:
        fa._mesh_on_cuda, fa.flash_mha = real_cuda, real_mha
    pp_mesh = _mesh((4, 2), ("dp", "pp"))
    pcfg = _cfg(PP_FLASH, pp_axis="pp", flash_attention="off")
    pmodel = tr.init_params(pcfg, torch.Generator().manual_seed(0), mesh=pp_mesh)
    ptok = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 128)))
    try:
        tr.forward_pipelined(pmodel, ptok, dataclasses.replace(pcfg, flash_attention="on"), mesh=pp_mesh)
        out["pp_on"] = np.array("did not raise")
    except ValueError as e:
        out["pp_on"] = np.array(str(e))
    return out


# ---------------------------------------------------------------- sequence parallelism


def case_sp_lm(c):
    """tests/test_transformer.py:117: the LM with ``sp_axis="sp"`` and the
    ring on the (2, 4) ``("dp", "sp")`` mesh, the global logits gathered
    over sp and dp; ``lm_loss`` on the mesh (each rank's last position's
    target is the next slice's first token) against the mesh-less loss,
    and its gradients summed over dp and sp against the mesh-less ones."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.models import transformer as tr

    z = _inputs(c)
    cfg = _cfg(sp_axis="sp", use_ring_attention=True)
    tree = unpack(z, "sp", 2)
    model = interop.transformer_params_from_numpy(tree, cfg, mesh=c.mesh)
    tokens = torch.from_numpy(z["sp_tokens"]).long()
    rows = _rows(tokens, c.mesh)
    with torch.no_grad():
        logits = tr.forward(model, rows, cfg, mesh=c.mesh)
    out = dict(logits=_np(_gather(logits, c.mesh, ("sp", 1), ("dp", 0))), local_len=np.int64(logits.shape[1]))
    loss = tr.lm_loss(model, {"tokens": rows}, cfg, mesh=c.mesh)
    loss.backward()
    single = interop.transformer_params_from_numpy(tree, _cfg(), device="cpu")
    want = tr.lm_loss(single, {"tokens": tokens}, _cfg())
    want.backward()
    got = np.concatenate([v.reshape(-1) for v in _grad_leaves(_summed_grads(model, c.mesh))])
    flat = _np(torch.cat([p.grad.reshape(-1) for p in single.parameters()]))
    out.update(loss=np.float64(float(loss)), single_loss=np.float64(float(want)),
               grad_err=np.float64(np.abs(got - flat).max()), grad_scale=np.float64(np.abs(flat).max()))
    return out


def case_sp_tp(c):
    """examples/transformer_lm.py's ``("dp", "sp", "tp")`` mesh at (2, 2, 2):
    the ring on each rank's 2 heads, the global logits."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.models import transformer as tr

    z = _inputs(c)
    mesh = _mesh((2, 2, 2), ("dp", "sp", "tp"))
    cfg = _cfg(sp_axis="sp", tp_axis="tp", use_ring_attention=True)
    model = interop.transformer_params_from_numpy(unpack(z, "sp", 2), cfg, mesh=mesh)
    with torch.no_grad():
        logits = tr.forward(model, _rows(torch.from_numpy(z["sp_tokens"]).long(), mesh), cfg, mesh=mesh)
    return dict(logits=_np(_gather(logits, mesh, ("sp", 1), ("dp", 0))), held_wqkv=np.array(model.layers[0].wqkv.shape))


# ---------------------------------------------------------------- pipeline parallelism


def case_pp(c):
    """tests/test_transformer.py:250 (pp 4 on (2, 4) ``("dp", "pp")``, 4
    microbatches) and :285 (3 microbatches do not divide a dp shard's 4
    rows: it raises); the stage each rank holds and the tree gathered
    back; the ppermutes of one forward."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    z = _inputs(c)
    mesh = _mesh((2, 4), ("dp", "pp"))
    cfg = _cfg(n_layers=4, pp_axis="pp")
    model = interop.transformer_params_from_numpy(unpack(z, "pp", 4), cfg, mesh=mesh)
    rows = _rows(torch.from_numpy(z["pp_tokens"]).long(), mesh)
    coll.reset_collective_counts()
    with torch.no_grad():
        logits = tr.forward_pipelined(model, rows, cfg, mesh=mesh, num_microbatches=4)
    out = dict(logits=_np(_gather(logits, mesh, ("dp", 0))), ppermutes=np.int64(coll.collective_counts()["ppermute"]),
               held_wqkv=np.array(model.stages["wqkv"].shape), stage_wqkv=_np(model.stages["wqkv"]),
               **pack(interop.transformer_params_to_numpy(model), "back"))
    try:
        tr.forward_pipelined(model, rows, cfg, mesh=mesh, num_microbatches=3)
        out["odd"] = np.array("did not raise")
    except ValueError as e:
        out["odd"] = np.array(str(e))
    return out


def case_pp_grads(c):
    """tests/test_transformer.py:262: pp 2 on (4, 2) ``("dp", "pp")``, 2
    microbatches a dp shard; the gradients of ``mean(log_softmax(logits)
    [..., 0])`` summed by the dense step's rule (over pp, then dp); the
    ppermutes of the forward and backward."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    z = _inputs(c)
    mesh = _mesh((4, 2), ("dp", "pp"))
    cfg = _cfg(n_layers=4, pp_axis="pp")
    model = interop.transformer_params_from_numpy(unpack(z, "pp", 4), cfg, mesh=mesh)
    tokens = torch.from_numpy(z["pp_tokens"]).long()
    coll.reset_collective_counts()
    logits = tr.forward_pipelined(model, _rows(tokens, mesh), cfg, mesh=mesh, num_microbatches=2)
    _mean_logp0(logits, mesh, ("dp",)).backward()
    counts = coll.collective_counts()
    return dict(ppermutes=np.int64(counts["ppermute"]), **pack(_summed_grads(model, mesh), "grad"))


def case_pp_sp(c):
    """tests/test_transformer.py:293 and :327: pp × sp on the (2, 2, 2)
    ``("dp", "pp", "sp")`` mesh, the ring inside each stage; the forward's
    global logits (4 layers, 2 microbatches), and the gradients of
    ``mean(log_softmax(logits)[..., 0])`` (2 layers) summed over sp, pp and
    dp."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.models import transformer as tr

    z = _inputs(c)
    mesh = _mesh((2, 2, 2), ("dp", "pp", "sp"))
    cfg = _cfg(n_layers=4, pp_axis="pp", sp_axis="sp", use_ring_attention=True)
    model = interop.transformer_params_from_numpy(unpack(z, "ppsp", 4), cfg, mesh=mesh)
    with torch.no_grad():
        logits = tr.forward_pipelined(model, _rows(torch.from_numpy(z["ppsp_tokens"]).long(), mesh), cfg,
                                      mesh=mesh, num_microbatches=2)
    out = dict(logits=_np(_gather(logits, mesh, ("sp", 1), ("dp", 0))))
    cfg = _cfg(n_layers=2, pp_axis="pp", sp_axis="sp", use_ring_attention=True)
    model = interop.transformer_params_from_numpy(unpack(z, "ppspg", 2), cfg, mesh=mesh)
    tokens = torch.from_numpy(z["ppspg_tokens"]).long()
    logits = tr.forward_pipelined(model, _rows(tokens, mesh), cfg, mesh=mesh, num_microbatches=2)
    _mean_logp0(logits, mesh, ("dp", "sp")).backward()
    out.update(pack(_summed_grads(model, mesh), "grad"))
    return out


def case_pipeline_sweep(c):
    """tests/test_property_extras.py:79: ``pipeline_apply`` for (S, M) in
    (2, 2), (4, 1), (4, 4), (8, 2) on ``(8/S, S)`` ``("dp", "pp")`` meshes
    against the stages applied in turn, forward (the global output) and
    the gradients of ``sum(out**2)`` in x and the stage weights (each pp
    rank's copy of the loss weighing 1/S)."""
    import torch

    from flink_parameter_server_tpu_torch.parallel import collectives as coll
    from flink_parameter_server_tpu_torch.parallel.mesh import axis_index
    from flink_parameter_server_tpu_torch.parallel.pipeline import pipeline_apply, scale_grad

    def block(p, xm):
        return xm * p["w"][0] + torch.tanh(xm) * 0.1

    out = {}
    for S, M in SWEEP:
        mesh = _mesh((8 // S, S), ("dp", "pp"))
        rng = np.random.default_rng(S * 10 + M)
        dp = 8 // S
        x = torch.from_numpy(rng.normal(0, 1, (M * dp * 2, 6)).astype(np.float32))
        w = torch.from_numpy(rng.normal(0, 0.5, (S, 6)).astype(np.float32))
        s = axis_index(mesh, "pp")
        xr = _rows(x, mesh).clone().requires_grad_()
        mine = w[s:s + 1].clone().requires_grad_()
        got = pipeline_apply({"w": mine}, xr, block, mesh=mesh, num_microbatches=M)
        # every pp rank's loss reads the replicated output: each weighs 1/S
        # (forward_pipelined's rule), so the S copies count once
        (scale_grad(got, 1.0 / S) ** 2).sum().backward()
        want_x, want_w = x.clone().requires_grad_(), w.clone().requires_grad_()
        want = want_x
        for i in range(S):
            want = block({"w": want_w[i]}, want)
        (want ** 2).sum().backward()
        tag = f"s{S}m{M}"
        out[f"{tag}_got"] = _np(_gather(got, mesh, ("dp", 0)))
        out[f"{tag}_want"] = _np(want)
        out[f"{tag}_x"], out[f"{tag}_w"] = _np(x), _np(w)
        # x reaches stage 0 only: the other stages' x gradients are zeros
        out[f"{tag}_gx"] = _np(_gather(coll.all_reduce_sum(xr.grad, mesh, "pp"), mesh, ("dp", 0)))
        out[f"{tag}_gw"] = _np(_gather(mine.grad, mesh, ("dp", 0)).sum(0))  # the stage's weight, over dp
        out[f"{tag}_want_gx"], out[f"{tag}_want_gw"] = _np(want_x.grad), _np(want_w.grad[s])
    return out


def case_stack(c):
    """tests/test_property_extras.py:102: ``stack_stage_params`` of 8 layers
    into 4 stages, plain and on the (2, 4) ``("dp", "pp")`` mesh (each rank
    its stage's block, gathered over pp)."""
    import torch

    from flink_parameter_server_tpu_torch.parallel.pipeline import stack_stage_params

    mesh = _mesh((2, 4), ("dp", "pp"))
    rng = np.random.default_rng(0)
    layers = [{"w": torch.from_numpy(rng.normal(0, 1, (3, 5)).astype(np.float32)),
               "b": torch.from_numpy(rng.normal(0, 1, (5,)).astype(np.float32))} for _ in range(8)]
    plain = stack_stage_params(layers, 4)
    mine = stack_stage_params(layers, 4, mesh=mesh)
    return dict(plain_w=_np(plain["w"]), plain_b=_np(plain["b"]), held=np.array(mine["w"].shape),
                sharded_w=_np(_gather(mine["w"], mesh, ("pp", 0))), sharded_b=_np(_gather(mine["b"], mesh, ("pp", 0))))


# ---------------------------------------------------------------- the dense step on tp


def case_zero1_tp_specs(c):
    """tests/test_zero1.py:186 on a (4, 2) ``("dp", "tp")`` mesh: a module
    holding a rank's blocks of a column-parallel (16, 8), a row-parallel
    (8, 16) and a replicated (16,) leaf, its layout recorded; ZeRO-1's
    specs merge dp into the first free axis."""
    import torch
    from torch import nn

    from flink_parameter_server_tpu_torch.core import dense, optim

    mesh = _mesh((4, 2), ("dp", "tp"))
    module = nn.ParameterDict({"wqkv": nn.Parameter(torch.zeros(16, 4)), "wo": nn.Parameter(torch.zeros(4, 16)),
                               "b": nn.Parameter(torch.zeros(16))})
    dense.set_model_layout(module, mesh, {"wqkv": (None, "tp"), "wo": ("tp", None)})
    opt = optim.adam(1e-2)(module.parameters())
    specs = dense.opt_state_zero1_specs(opt, mesh, params=module)
    return dict(names=np.array([n for n, _ in module.named_parameters()]), specs=np.array([str(s) for s in specs]))


def case_tp_regimes(c):
    """The LM with ``tp_axis="tp"`` on the (2, 4) ``("dp", "tp")`` mesh
    (one head a rank) for 2 steps of ``transform_dense(batch_sharding=
    mesh)``, replicated, ZeRO-1 and FSDP, from the reference's weights:
    the losses and the whole trained tree; the shapes a rank holds of
    ``wqkv`` and of its Adam moment under ZeRO-1."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.core import dense, optim
    from flink_parameter_server_tpu_torch.models import transformer as tr

    z = _inputs(c)
    mesh = _mesh((2, 4), ("dp", "tp"))
    cfg = _cfg(tp_axis="tp")
    tree = unpack(z, "train", 2)
    batches = [{"tokens": z[f"train_tokens{i}"]} for i in range(2)]
    out = {}
    for regime in REGIMES:
        server = interop.dense_server_from_numpy(tree, cfg, optim.adamw(LR, eps=EPS), mesh=mesh,
                                                 fsdp=regime == "fsdp")
        res = dense.transform_dense(batches, lambda m, b: tr.lm_loss(m, b, cfg, mesh=mesh), server,
                                    batch_sharding=None if regime == "fsdp" else mesh,
                                    shard_opt_state=regime == "zero1")
        out[f"{regime}_loss"] = np.array([float(x) for x in res.worker_outputs])
        out.update(pack(interop.transformer_params_to_numpy(res.server_outputs[0]), regime))
        out[f"{regime}_held_wqkv"] = np.array(res.server_outputs[0].layers[0].wqkv.shape)
    server = interop.dense_server_from_numpy(tree, cfg, optim.adamw(LR, eps=EPS), mesh=mesh)
    step = dense.make_dense_train_step(lambda m, b: tr.lm_loss(m, b, cfg, mesh=mesh), mesh=mesh, shard_opt_state=True,
                                       opt_specs=dense.opt_state_zero1_specs(server.opt, mesh, params=server.params))
    p, o, _ = step(server.params, server.opt, {"tokens": torch.from_numpy(batches[0]["tokens"])})
    out["zero1_mu_wqkv"] = np.array(o.state[p.layers[0].wqkv]["exp_avg"].shape)
    return out


# ---------------------------------------------------------------- MoE, tp and pp beside each other


def _layout_cfg(name, capacity):
    moe = dict(num_experts=MOE_EXPERTS, moe_capacity=capacity) if capacity else {}
    return _cfg(**LAYOUTS[name][2], **moe)


def _layout_run(c, name, capacity, plant=None):
    """One layout's run from the reference's tree: the global logits, the
    gradients of ``mean(log_softmax(logits)[..., 0])`` summed by the dense
    step's rule (gathered whole), and each routing call's (tokens, kept)
    in the forward.  ``plant``: "slice", "shard" or "tp_sum" (LAYOUTS)."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.models import moe as moe_mod
    from flink_parameter_server_tpu_torch.models import transformer as tr
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    shape, axes, fields, micro, _, _ = LAYOUTS[name]
    mesh = _mesh(shape, axes)
    cfg = _layout_cfg(name, capacity)
    z = _inputs(c)
    model = interop.transformer_params_from_numpy(unpack(z, "moe" if capacity else "tp", 2), cfg, mesh=mesh)
    rows = _rows(torch.from_numpy(z["moe_tokens"]).long(), mesh)
    routed, real_route, real_axes = [], moe_mod._route, tr._moe_token_axes

    def spy(x, w, E, C):
        r = real_route(x, w, E, C)
        routed.append((int(x.shape[0]), int(r[2].sum())))
        return r

    moe_mod._route = spy
    if plant == "slice":
        tr._moe_token_axes = lambda m, cf: [a for a in real_axes(m, cf) if a[0] != cf.sp_axis]
    try:
        if micro:
            logits = tr.forward_pipelined(model, rows, cfg, mesh=mesh,
                                          num_microbatches=1 if plant == "shard" else micro)
        else:
            logits = tr.forward(model, rows, cfg, mesh=mesh)
    finally:
        moe_mod._route, tr._moe_token_axes = real_route, real_axes
    sp = tr._ring_on(mesh, cfg)
    _mean_logp0(logits, mesh, ("dp", "sp") if sp else ("dp",)).backward()
    if plant == "tp_sum":
        with torch.no_grad():
            for n, p in model.named_parameters():
                if ".moe." in n or n.startswith("stages."):
                    p.grad = coll.all_reduce_sum(p.grad, mesh, "tp")
    gathered = _gather(logits.detach(), mesh, *((("sp", 1),) if sp else ()), ("dp", 0))
    return _np(gathered), _summed_grads(model, mesh), np.array(routed, np.int64).reshape(-1, 2)


def case_layouts(c):
    """Each of LAYOUTS on its mesh of the 8 ranks, at its dropping capacity
    and at NO_DROP: the global logits, the summed gradients and the
    routing calls' (tokens, kept) (the capacity rule: the tokens each call
    routes together); at the dropping capacity its planted fault's logits
    ("slice", "shard") or gradients ("tp_sum")."""
    out = {}
    for name, (shape, axes, fields, micro, drop, fault) in LAYOUTS.items():
        for cap in layout_capacities(name):
            tag = f"{name}_c{cap or 0}"
            logits, grads, routed = _layout_run(c, name, cap)
            out[f"{tag}_logits"], out[f"{tag}_routed"] = logits, routed
            out.update(pack(grads, f"{tag}_grad"))
        logits, grads, _ = _layout_run(c, name, drop, plant=fault)
        if fault == "tp_sum":
            out.update(pack(grads, f"{name}_fault_grad"))
        else:
            out[f"{name}_fault_logits"] = logits
    return out


def case_moe_regimes(c):
    """The MoE LM on each of MOE_REGIMES's meshes, at its dropping
    capacity, for 2 steps of ``transform_dense(batch_sharding=mesh)``,
    replicated, ZeRO-1 and FSDP, from the reference's tree: the losses and
    the whole trained tree; the shape a rank holds of ``w_up`` (FSDP: cut
    over dp) and of its ZeRO-1 Adam moment."""
    import torch

    from flink_parameter_server_tpu_torch import interop
    from flink_parameter_server_tpu_torch.core import dense, optim
    from flink_parameter_server_tpu_torch.models import transformer as tr

    z = _inputs(c)
    tree = unpack(z, "moe", 2)
    batches = [{"tokens": z[f"train_tokens{i}"]} for i in range(2)]
    out = {}
    for name in MOE_REGIMES:
        shape, axes, _, _, drop, _ = LAYOUTS[name]
        mesh = _mesh(shape, axes)
        cfg = _layout_cfg(name, drop)
        for regime in REGIMES:
            server = interop.dense_server_from_numpy(tree, cfg, optim.adamw(LR, eps=EPS), mesh=mesh,
                                                     fsdp=regime == "fsdp")
            res = dense.transform_dense(batches, lambda m, b: tr.lm_loss(m, b, cfg, mesh=mesh), server,
                                        batch_sharding=None if regime == "fsdp" else mesh,
                                        shard_opt_state=regime == "zero1")
            out[f"{name}_{regime}_loss"] = np.array([float(x) for x in res.worker_outputs])
            out.update(pack(interop.transformer_params_to_numpy(res.server_outputs[0]), f"{name}_{regime}"))
            out[f"{name}_{regime}_held_w_up"] = np.array(res.server_outputs[0].layers[0].moe["w_up"].shape)
        server = interop.dense_server_from_numpy(tree, cfg, optim.adamw(LR, eps=EPS), mesh=mesh)
        step = dense.make_dense_train_step(lambda m, b: tr.lm_loss(m, b, cfg, mesh=mesh), mesh=mesh,
                                           shard_opt_state=True,
                                           opt_specs=dense.opt_state_zero1_specs(server.opt, mesh, params=server.params))
        p, o, _ = step(server.params, server.opt, {"tokens": torch.from_numpy(batches[0]["tokens"])})
        out[f"{name}_zero1_mu_w_up"] = np.array(o.state[p.layers[0].moe["w_up"]]["exp_avg"].shape)
    return out


def case_refusals(c):
    """Layouts the reference does not run raise ``ValueError`` naming why:
    tp not dividing the heads, sp > 1 without the ring, a mesh axis the
    config does not name, and the plain forward of a pipeline model.  tp
    inside pipeline stages, which the reference runs, builds and runs."""
    import torch

    from flink_parameter_server_tpu_torch.models import transformer as tr

    pp_tp = _mesh((2, 2, 2), ("dp", "pp", "tp"))
    tries = {
        "heads": lambda: tr.init_params(_cfg(n_heads=2, tp_axis="tp"), mesh=_mesh((2, 4), ("dp", "tp"))),
        "pp_tp": lambda: tr.forward_pipelined(tr.init_params(_cfg(pp_axis="pp", tp_axis="tp"), mesh=pp_tp),
                                              torch.zeros(2, 8, dtype=torch.int64), _cfg(pp_axis="pp", tp_axis="tp"),
                                              mesh=pp_tp, num_microbatches=2),
        "no_ring": lambda: tr.init_params(_cfg(sp_axis="sp"), mesh=c.mesh),
        "stray": lambda: tr.init_params(_cfg(), mesh=c.mesh),
        "plain_forward": lambda: tr.forward(tr.init_params(_cfg(pp_axis="pp"), mesh=_mesh((4, 2), ("dp", "pp"))),
                                            torch.zeros(2, 8, dtype=torch.int64), _cfg(pp_axis="pp")),
    }
    out = {}
    for name, fn in tries.items():
        try:
            got = fn()
            out[name] = np.array(f"did not raise: {tuple(got.shape)}" if isinstance(got, torch.Tensor)
                                 else "did not raise")
        except ValueError as e:
            out[name] = np.array(str(e))
    return out


CASES = {"mp": [case_ring, case_ring_sweep, case_tp, case_tp_flash, case_sp_lm, case_sp_tp, case_pp, case_pp_grads, case_pp_sp,
                case_pipeline_sweep, case_stack, case_zero1_tp_specs, case_tp_regimes, case_refusals, case_layouts,
                case_moe_regimes]}
