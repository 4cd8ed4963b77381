"""The port's tensor, sequence (ring) and pipeline parallelism against the
JAX package on its 8 virtual devices.

Mirrors, each at the reference test's own bar:

* ring attention: tests/test_transformer.py:38 (causal) and :44
  (non-causal), atol 2e-5; :50 (gradients of ``sum(out**2)``), atol 5e-4;
  :141 (bfloat16 inputs, float32 accumulators), atol 0.03;
  tests/test_property_extras.py:63 (the shape sweep), atol 3e-5;
* tensor parallelism: :100 (``tp_axis="ps"`` on ``make_mesh(2, 4)``),
  atol 2e-4; the gradients summed over dp against the mesh-less model's
  (atol 1e-5), where the planted fault (``copy_to_tp`` made the identity)
  is far outside;
* sequence parallelism: :117 (the ring LM on the (2, 4) ``("dp", "sp")``
  mesh), atol 3e-4; its loss (rtol 1e-5) and summed gradients (atol 1e-5)
  against the mesh-less ones; the ``("dp", "sp", "tp")`` mesh of
  examples/transformer_lm.py, atol 3e-4;
* pipeline parallelism: ``TestPipelineParallel`` :250 (forward, atol
  3e-4), :262 (gradients, atol 5e-5), :285 (microbatches that do not
  divide a dp shard raise), and the pp × sp tests :293 (atol 3e-4) and
  :327 (atol 5e-5), each held against the reference's
  ``forward_pipelined`` / ``jax.grad`` of it (they pass on this jax; the
  reference's own tests skip them on jax >= 0.4.37) and against its dense
  forward;
* tests/test_flash_attention.py:257 ("on" raises in ``forward_pipelined``),
  and the tp flash gate: "auto" and "on" call ``flash_mha`` on each rank's
  heads and match "off" (logits atol 1e-5, loss rtol 1e-5, the rank's
  ``wqkv`` gradient atol 1e-5);
* tests/test_property_extras.py:79 (the ``pipeline_apply`` schedule sweep,
  atol 1e-5, gradients too) and :102 (``stack_stage_params``, bitwise);
* tests/test_zero1.py:186 (ZeRO-1's specs merge dp into a tp layout);
* tp × replicated / ZeRO-1 / FSDP: 2 steps of ``transform_dense`` on the
  (2, 4) ``("dp", "tp")`` mesh against the reference's same regime on the
  same mesh (losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-6 + 1e-3·lr,
  tests/test_torch_zero1.py's LM bars);
* weights cross both ways: the reference's tree onto tp and pp ranks and
  back, bitwise, ``wqkv``'s ``[q | k | v]`` order included;
* the layouts beside those (``_torch_mp_cases.LAYOUTS``): MoE layers beside
  tp, ep beside tp and sp, MoE on an sp ring without ep, MoE in pipeline
  stages (alone, beside an ep axis, under the ring) and dense tp inside
  stages, each against the reference's run of the same layout on its 8
  devices at a capacity that drops tokens under the layout's rule and at
  one that drops none (logits atol 3e-4, gradients atol 5e-5, the bars of
  :293 and :327), each with a planted fault outside the bar; the MoE LM's
  replicated, ZeRO-1 and FSDP steps on (dp 2, tp 4) and (dp 2, ep 2, tp 2)
  against the reference's same regimes (the LM bars above).

The port runs in 8 spawned gloo ranks on the CPU (``tests/_torch_mesh_child.py``
with ``tests/_torch_mp_cases.py``: the ``mp`` battery, one spawn); inputs
come from seeds with numpy and the reference's initialisers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_mp_cases as mc
from _torch_mesh_child import run_battery
from flink_parameter_server_tpu.core import dense as ref_dense
from flink_parameter_server_tpu.models import transformer as ref_tr
from flink_parameter_server_tpu.parallel.mesh import make_mesh as ref_make_mesh
from flink_parameter_server_tpu.parallel.pipeline import pipeline_apply as ref_pipeline_apply
from flink_parameter_server_tpu.parallel.ring_attention import reference_attention as ref_attention
from flink_parameter_server_tpu.parallel.ring_attention import ring_attention as ref_ring

LM_BAR = dict(rtol=1e-4, atol=1e-6 + 1e-3 * mc.LR)  # tests/test_torch_zero1.py


def _ref_cfg(**kw):
    return ref_tr.TransformerConfig(**dict(mc.TINY, **kw), dtype=jnp.float32)


def _tree(name):
    n_layers, key = mc.TREES[name]
    moe = dict(num_experts=mc.MOE_EXPERTS, moe_capacity=mc.NO_DROP) if name == "moe" else {}
    params = ref_tr.init_params(jax.random.PRNGKey(key), _ref_cfg(n_layers=n_layers, **moe))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _qkv(B=2, T=32, H=4, D=8, seed=0):
    """tests/test_transformer.py's ``TestRingAttention._qkv``."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (B, T, H, D)).astype(np.float32) for _ in range(3)]


def _tokens():
    rng = np.random.default_rng(4)
    out = {"tp_tokens": np.random.default_rng(0).integers(0, 64, (4, 16)).astype(np.int32),
           "sp_tokens": np.random.default_rng(1).integers(0, 64, (4, 32)).astype(np.int32),
           "pp_tokens": np.random.default_rng(3).integers(0, 64, (8, 16)).astype(np.int32),
           "ppsp_tokens": np.random.default_rng(7).integers(0, 64, (8, 16)).astype(np.int32),
           "ppspg_tokens": np.random.default_rng(9).integers(0, 64, (4, 16)).astype(np.int32),
           "moe_tokens": np.random.default_rng(11).integers(0, 64, (8, 16)).astype(np.int32)}
    for i in range(2):
        out[f"train_tokens{i}"] = rng.integers(0, 64, (8, 16)).astype(np.int32)
    return out


TOKENS = _tokens()


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp")
    inputs = dict(TOKENS)
    for name in mc.TREES:
        inputs.update(mc.pack(_tree(name), name))
    for tag, kw in (("causal", {}), ("noncausal", dict(seed=1)), ("grad", dict(T=16, seed=2))):
        inputs.update({f"ring_{tag}_{n}": a for n, a in zip("qkv", _qkv(**kw))})
    rng = np.random.default_rng(5)  # tests/test_transformer.py:141
    inputs.update({f"ring_bf16_{n}": rng.normal(0, 1, (2, 32, 4, 8)).astype(np.float32) for n in "qkv"})
    np.savez(out / "inputs.npz", **inputs)
    return run_battery("mp", out, timeout=240)


def case(res, name):
    """Every rank's outputs of one case; fails with the rank's traceback."""
    per_rank = res.get(name)
    assert per_rank is not None, f"case {name} wrote nothing:\n{res['_log'][-4000:]}"
    for r, out in enumerate(per_rank):
        assert isinstance(out, dict), f"case {name}, rank {r}:\n{out}"
    return per_rank


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_tree(out, prefix, tree, err, **bar):
    """``out``'s ``prefix`` entries (mc.pack's layout) against a tree."""
    for k, v in mc.pack(tree, prefix).items():
        if bar:
            np.testing.assert_allclose(out[k], np.asarray(v), **bar, err_msg=f"{err} {k}")
        else:
            np.testing.assert_array_equal(out[k], np.asarray(v), err_msg=f"{err} {k}")


@pytest.fixture(scope="module")
def sp_mesh():
    return ref_make_mesh(2, 4, axis_names=("dp", "sp"))


# ---------------------------------------------------------------- ring attention


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_ring_attention_matches_reference(mp, sp_mesh, causal):
    """tests/test_transformer.py:38 and :44: the port's ring on the (2, 4)
    ``("dp", "sp")`` mesh against the unsharded attention and the
    reference's ring, atol 2e-5."""
    tag = "causal" if causal else "noncausal"
    q, k, v = (jnp.asarray(a) for a in _qkv(seed=0 if causal else 1))
    want = np.asarray(ref_attention(q, k, v, causal=causal))
    ring = np.asarray(ref_ring(q, k, v, mesh=sp_mesh, causal=causal))
    for r, out in enumerate(case(mp, "ring")):
        np.testing.assert_allclose(out[tag], want, atol=2e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out[tag], ring, atol=2e-5, err_msg=f"rank {r}")


def test_ring_attention_gradients(mp, sp_mesh):
    """tests/test_transformer.py:50: the gradients of ``sum(ring**2)`` in
    q, k and v against ``jax.grad`` of the unsharded attention's, atol
    5e-4; every rank holds the whole gradients; one forward and its
    backward make 3 + 3 ppermutes of the stacked K/V over sp 4."""
    q, k, v = (jnp.asarray(a) for a in _qkv(T=16, seed=2))
    want = jax.grad(lambda a, b, c: jnp.sum(ref_attention(a, b, c) ** 2), argnums=(0, 1, 2))(q, k, v)
    for r, out in enumerate(case(mp, "ring")):
        for n, g in zip("qkv", want):
            np.testing.assert_allclose(out[f"grad_{n}"], np.asarray(g), atol=5e-4, err_msg=f"d{n} rank {r}")
        assert int(out["grad_ppermutes"]) == 6


def test_ring_attention_bf16_fp32_accumulators(mp):
    """tests/test_transformer.py:141: bfloat16 inputs give a bfloat16
    output within atol 0.03 of the float32 reference."""
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(rng.normal(0, 1, (2, 32, 4, 8)).astype(np.float32)) for _ in range(3))
    want = np.asarray(ref_attention(q, k, v))
    for r, out in enumerate(case(mp, "ring")):
        assert str(out["bf16_dtype"]) == "torch.bfloat16"
        np.testing.assert_allclose(out["bf16"], want, atol=0.03, err_msg=f"rank {r}")


@pytest.mark.parametrize("B,T,H,D,sp", mc.RING_SWEEP)
def test_ring_attention_shape_sweep(mp, B, T, H, D, sp):
    """tests/test_property_extras.py:63: the ring with ``dp_axis=None`` on
    ``(8/sp, sp)`` meshes against the unsharded attention, atol 3e-5 (the
    inputs are the reference test's draws)."""
    tag = f"b{B}t{T}h{H}d{D}sp{sp}"
    rng = np.random.default_rng(B * T + H)
    q, k, v = (jnp.asarray(rng.normal(0, 1, (B, T, H, D)).astype(np.float32)) for _ in range(3))
    want = np.asarray(ref_attention(q, k, v))
    for r, out in enumerate(case(mp, "ring_sweep")):
        np.testing.assert_array_equal(out[tag + "_q"], np.asarray(q))
        np.testing.assert_allclose(out[tag], want, atol=3e-5, err_msg=f"rank {r}")


# ---------------------------------------------------------------- tensor parallelism


def test_tp_sharded_matches_single_device(mp):
    """tests/test_transformer.py:100: ``tp_axis="ps"`` on ``make_mesh(2,
    4)``: the global logits against the reference's mesh-less and tp-mesh
    forwards, atol 2e-4; a rank holds 1 head's columns of each of q, k and
    v, and the tree gathers back bitwise, ``[q | k | v]`` order included."""
    tree = _tree("tp")
    tokens = jnp.asarray(TOKENS["tp_tokens"])
    want = np.asarray(ref_tr.forward(_jtree(tree), tokens, _ref_cfg()))
    mesh = ref_make_mesh(2, 4)
    cfg = _ref_cfg(tp_axis="ps")
    params = ref_tr.init_params(jax.random.PRNGKey(1), cfg, mesh)
    on_mesh = np.asarray(jax.jit(lambda p, t: ref_tr.forward(p, t, cfg, mesh=mesh))(params, tokens))
    for r, out in enumerate(case(mp, "tp")):
        np.testing.assert_allclose(out["logits"], want, atol=2e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["logits"], on_mesh, atol=2e-4, err_msg=f"rank {r}")
        assert tuple(out["held_wqkv"]) == (32, 24) and tuple(out["held_wo"]) == (8, 32)
        assert tuple(out["held_w_up"]) == (32, 16)
        assert_tree(out, "back", tree, f"rank {r}")


def test_tp_replicated_leaves_need_no_tp_sum(mp):
    """The conjugate pair makes a tp-replicated leaf's gradient whole on
    every tp rank: ``lm_loss``'s gradients on the tp mesh, summed over dp
    only, equal the mesh-less model's within atol 1e-5 (the gradient of
    ``attn_norm`` among them).  With ``copy_to_tp`` made the identity (the
    planted fault) each rank sees only its heads' share, and the error is
    over 100 times that bar; the fault's run makes fewer all-reduces."""
    for r, out in enumerate(case(mp, "tp")):
        assert out["grad_err"] < 1e-5, (r, out["grad_err"])
        np.testing.assert_allclose(out["grad_attn_norm"], out["single_attn_norm"], atol=1e-5)
        assert out["fault_err"] > 100 * 1e-5, (r, out["fault_err"])
        assert int(out["fault_all_reduces"]) < int(out["grad_all_reduces"])


def test_tp_gate_runs_flash_on_each_ranks_heads(mp):
    """On the (2, 4) ``("dp", "tp")`` mesh at the kernels' shape the gate
    opens with ``tp_axis`` (and not without it); "auto" and "on" call
    ``flash_mha`` once a layer a pass on the rank's (2, 128, 1, 64) tensors
    and match "off" (logits atol 1e-5, loss rtol 1e-5, the rank's ``wqkv``
    gradient atol 1e-5).  tests/test_flash_attention.py:257: "on" raises in
    ``forward_pipelined``."""
    for r, out in enumerate(case(mp, "tp_flash")):
        assert out["gate_tp"] and not out["gate_no_tp"], f"rank {r}"
        assert out["off_calls"].size == 0
        for mode in ("auto", "on"):
            assert out[f"{mode}_calls"].tolist() == [[2, 128, 1, 64]] * 2, (mode, r)
            np.testing.assert_allclose(out[f"{mode}_logits"], out["off_logits"], atol=1e-5, err_msg=f"rank {r}")
            np.testing.assert_allclose(out[f"{mode}_loss"], out["off_loss"], rtol=1e-5)
            np.testing.assert_allclose(out[f"{mode}_grad_wqkv"], out["off_grad_wqkv"], atol=1e-5)
        assert "not supported in forward_pipelined" in str(out["pp_on"]), out["pp_on"]


def test_zero1_specs_compose_with_tp(mp):
    """tests/test_zero1.py:186: dp merges into the first free axis of a tp
    leaf, never over its layout: the column-parallel leaf ``("dp", "tp")``,
    the row-parallel ``("tp", "dp")``, the replicated vector ``("dp",)``."""
    for out in case(mp, "zero1_tp_specs"):
        specs = dict(zip(out["names"].tolist(), out["specs"].tolist()))
        assert specs == {"wqkv": "('dp', 'tp')", "wo": "('tp', 'dp')", "b": "('dp',)"}


@pytest.fixture(scope="module")
def reference_tp_runs():
    """The reference's 2 steps on its (2, 4) ``("dp", "tp")`` mesh in each
    regime: {regime: (losses, final tree)}."""
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "tp"))
    cfg = _ref_cfg(tp_axis="tp")
    opt = optax.adamw(mc.LR, eps=mc.EPS)
    sh = NamedSharding(mesh, P("dp"))

    def loss_fn(p, b):
        return ref_tr.lm_loss(p, b, cfg, mesh=mesh)

    runs = {}
    for regime in mc.REGIMES:
        params = ref_tr.init_params(jax.random.PRNGKey(mc.TREES["train"][1]), cfg, mesh)
        batches = [{"tokens": jax.device_put(jnp.asarray(TOKENS[f"train_tokens{i}"]), sh)} for i in range(2)]
        if regime == "zero1":
            specs = ref_dense.opt_state_zero1_specs(opt.init(params), mesh)
            step = jax.jit(ref_dense.make_dense_train_step(loss_fn, opt, mesh=mesh, shard_opt_state=True,
                                                           opt_specs=specs))
            p, o, losses = params, opt.init(params), []
            for b in batches:
                p, o, lo = step(p, o, b)
                losses.append(float(lo))
            runs[regime] = (np.array(losses), p)
            continue
        if regime == "fsdp":
            params = ref_dense.fsdp_place(params, mesh)
        res = ref_dense.transform_dense(batches, loss_fn, ref_dense.DenseParameterServer(params, opt))
        runs[regime] = (np.array([float(x) for x in res.worker_outputs]), res.server_outputs[0])
    return runs


@pytest.mark.parametrize("regime", mc.REGIMES)
def test_tp_regimes_match_the_reference(mp, reference_tp_runs, regime):
    """2 steps of ``transform_dense`` on the (2, 4) ``("dp", "tp")`` mesh
    against the reference's same regime on the same mesh: losses rtol 1e-5,
    the whole trained tree at the LM bar; every rank alike; a rank holds
    ``wqkv`` (32, 24) (FSDP: cut over dp on its rows) and, under ZeRO-1,
    its moment (16, 24)."""
    losses, params = reference_tp_runs[regime]
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    per_rank = case(mp, "tp_regimes")
    for r, out in enumerate(per_rank):
        np.testing.assert_allclose(out[f"{regime}_loss"], losses, rtol=1e-5, err_msg=f"{regime} rank {r}")
        assert_tree(out, regime, tree, f"{regime} rank {r}", **LM_BAR)
        for k in mc.pack(tree, regime):
            np.testing.assert_array_equal(out[k], per_rank[0][k], err_msg=f"{k} rank {r}")
        assert tuple(out[f"{regime}_held_wqkv"]) == ((16, 24) if regime == "fsdp" else (32, 24))
        assert tuple(out["zero1_mu_wqkv"]) == (16, 24)


# ---------------------------------------------------------------- sequence parallelism


def test_sp_ring_transformer_matches_dense(mp, sp_mesh):
    """tests/test_transformer.py:117: the ring LM on the (2, 4) ``("dp",
    "sp")`` mesh, a rank holding 8 of the 32 positions of its 2 rows: the
    global logits against the reference's dense forward and its sp-mesh
    forward, atol 3e-4."""
    tree = _tree("sp")
    tokens = jnp.asarray(TOKENS["sp_tokens"])
    want = np.asarray(ref_tr.forward(_jtree(tree), tokens, _ref_cfg()))
    cfg = _ref_cfg(sp_axis="sp", use_ring_attention=True)
    tok = jax.device_put(tokens, NamedSharding(sp_mesh, P("dp", "sp")))
    ring = np.asarray(jax.jit(lambda p, t: ref_tr.forward(p, t, cfg, mesh=sp_mesh))(_jtree(tree), tok))
    for r, out in enumerate(case(mp, "sp_lm")):
        assert int(out["local_len"]) == 8
        np.testing.assert_allclose(out["logits"], want, atol=3e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["logits"], ring, atol=3e-4, err_msg=f"rank {r}")


def test_sp_loss_and_gradients_match_mesh_less(mp):
    """``lm_loss`` on the sp mesh (each rank's last position's target is
    the next slice's first token; only the global last position masked)
    equals the mesh-less loss (rtol 1e-5), and its gradients summed over dp
    and sp equal the mesh-less gradients (atol 1e-5), against the
    reference's ``lm_loss`` too."""
    tree = _tree("sp")
    want = float(ref_tr.lm_loss(_jtree(tree), {"tokens": jnp.asarray(TOKENS["sp_tokens"])}, _ref_cfg()))
    for r, out in enumerate(case(mp, "sp_lm")):
        np.testing.assert_allclose(out["loss"], out["single_loss"], rtol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["loss"], want, rtol=1e-5, err_msg=f"rank {r}")
        assert out["grad_err"] < 1e-5, (r, out["grad_err"], out["grad_scale"])


def test_sp_tp_mesh_matches_dense(mp):
    """examples/transformer_lm.py's ``("dp", "sp", "tp")`` mesh at (2, 2,
    2): the ring on each rank's 2 heads, the global logits against the
    reference's dense forward, atol 3e-4."""
    want = np.asarray(ref_tr.forward(_jtree(_tree("sp")), jnp.asarray(TOKENS["sp_tokens"]), _ref_cfg()))
    for r, out in enumerate(case(mp, "sp_tp")):
        assert tuple(out["held_wqkv"]) == (32, 48)
        np.testing.assert_allclose(out["logits"], want, atol=3e-4, err_msg=f"rank {r}")


# ---------------------------------------------------------------- pipeline parallelism


def _ref_pipelined(name, mesh_shape, names, n_layers, num_microbatches, **kw):
    """The reference's ``forward_pipelined`` of tree ``name``."""
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(mesh_shape), names)
    cfg = _ref_cfg(n_layers=n_layers, pp_axis="pp", **kw)
    tokens = jnp.asarray(TOKENS[f"{name}_tokens"])
    return mesh, cfg, tokens


def test_pipelined_forward_matches_dense(mp):
    """tests/test_transformer.py:250: pp 4 on (2, 4) ``("dp", "pp")``, 4
    microbatches a dp shard: the global logits against the dense forward
    and the reference's ``forward_pipelined``, atol 3e-4; a rank holds its
    stage, ``wqkv`` (1, 1, 32, 96) (layer s of the tree), and the tree
    gathers back bitwise; a forward makes S + M - 1 = 7 ppermutes."""
    tree = _tree("pp")
    mesh, cfg, tokens = _ref_pipelined("pp", (2, 4), ("dp", "pp"), 4, 4)
    want = np.asarray(ref_tr.forward(_jtree(tree), tokens, cfg))
    piped = np.asarray(jax.jit(lambda p, t: ref_tr.forward_pipelined(p, t, cfg, mesh=mesh, num_microbatches=4))(
        _jtree(tree), tokens))
    for r, out in enumerate(case(mp, "pp")):
        np.testing.assert_allclose(out["logits"], want, atol=3e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["logits"], piped, atol=3e-4, err_msg=f"rank {r}")
        assert tuple(out["held_wqkv"]) == (1, 1, 32, 96)
        np.testing.assert_array_equal(out["stage_wqkv"][0, 0], tree["layers"][r % 4]["wqkv"])
        assert_tree(out, "back", tree, f"rank {r}")
        assert int(out["ppermutes"]) == 7


def test_microbatch_divisibility_asserted(mp):
    """tests/test_transformer.py:285: 3 microbatches do not divide a dp
    shard's 4 rows: it raises."""
    for out in case(mp, "pp"):
        assert "num_microbatches=3 must divide" in str(out["odd"]), out["odd"]


def _ref_grads(name, mesh_shape, names, n_layers, **kw):
    """``jax.grad`` of ``mean(log_softmax(logits)[..., 0])`` through the
    reference's ``forward_pipelined`` (2 microbatches) and its dense
    forward."""
    tree = _jtree(_tree(name))
    mesh, cfg, tokens = _ref_pipelined(name, mesh_shape, names, n_layers, 2, **kw)
    dense_cfg = dataclasses.replace(cfg, pp_axis=None, sp_axis=None, use_ring_attention=False)

    def loss_pp(p):
        lg = ref_tr.forward_pipelined(p, tokens, cfg, mesh=mesh, num_microbatches=2)
        return jnp.mean(jax.nn.log_softmax(lg)[..., 0])

    def loss_dense(p):
        return jnp.mean(jax.nn.log_softmax(ref_tr.forward(p, tokens, dense_cfg))[..., 0])

    to_np = lambda g: jax.tree.map(lambda x: np.asarray(x, np.float32), g)  # noqa: E731
    return to_np(jax.jit(jax.grad(loss_pp))(tree)), to_np(jax.grad(loss_dense)(tree))


def test_pipelined_gradients_match(mp):
    """tests/test_transformer.py:262: pp 2 on (4, 2), 2 microbatches: the
    gradients, summed by the dense step's rule (the logits' gradient
    scaled 1/pp, the replicated leaves summed over pp, then dp), against
    ``jax.grad`` through the reference's ``forward_pipelined`` and its
    dense forward, atol 5e-5; 3 ppermutes forward and 3 backward."""
    piped, dense = _ref_grads("pp", (4, 2), ("dp", "pp"), 4)
    for r, out in enumerate(case(mp, "pp_grads")):
        assert_tree(out, "grad", dense, f"rank {r}", atol=5e-5)
        assert_tree(out, "grad", piped, f"rank {r}", atol=5e-5)
        assert int(out["ppermutes"]) == 6


def test_pipelined_ring_attention_composition(mp):
    """tests/test_transformer.py:293: pp × sp on (2, 2, 2) ``("dp", "pp",
    "sp")``, the ring inside each stage, 2 microbatches: the global logits
    against the dense forward and the reference's ``forward_pipelined``,
    atol 3e-4."""
    tree = _tree("ppsp")
    mesh, cfg, tokens = _ref_pipelined("ppsp", (2, 2, 2), ("dp", "pp", "sp"), 4, 2, sp_axis="sp",
                                       use_ring_attention=True)
    want = np.asarray(ref_tr.forward(_jtree(tree), tokens, _ref_cfg(n_layers=4)))
    piped = np.asarray(jax.jit(lambda p, t: ref_tr.forward_pipelined(p, t, cfg, mesh=mesh, num_microbatches=2))(
        _jtree(tree), tokens))
    for r, out in enumerate(case(mp, "pp_sp")):
        np.testing.assert_allclose(out["logits"], want, atol=3e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["logits"], piped, atol=3e-4, err_msg=f"rank {r}")


def test_pipelined_ring_attention_gradients(mp):
    """tests/test_transformer.py:327: pp × sp gradients (2 layers) summed
    over sp, pp and dp against ``jax.grad`` through the reference's
    ``forward_pipelined`` and its dense forward, atol 5e-5."""
    piped, dense = _ref_grads("ppspg", (2, 2, 2), ("dp", "pp", "sp"), 2, sp_axis="sp", use_ring_attention=True)
    for r, out in enumerate(case(mp, "pp_sp")):
        assert_tree(out, "grad", dense, f"rank {r}", atol=5e-5)
        assert_tree(out, "grad", piped, f"rank {r}", atol=5e-5)


@pytest.mark.parametrize("S,M", mc.SWEEP)
def test_pipeline_schedule_sweep(mp, S, M):
    """tests/test_property_extras.py:79: ``pipeline_apply`` equals the
    stages applied in turn (atol 1e-5) and the reference's
    ``pipeline_apply`` on its ``(8/S, S)`` mesh; the gradients in x and in
    each stage's weight equal the sequential ones (atol 1e-5)."""
    tag = f"s{S}m{M}"
    out0 = case(mp, "pipeline_sweep")[0]
    mesh = ref_make_mesh(8 // S, S, axis_names=("dp", "pp"))
    x, w = jnp.asarray(out0[f"{tag}_x"]), jnp.asarray(out0[f"{tag}_w"])
    ref = np.asarray(ref_pipeline_apply(w, x, lambda p, xm: xm * p[0] + jnp.tanh(xm) * 0.1, mesh=mesh,
                                        num_microbatches=M))
    for r, out in enumerate(case(mp, "pipeline_sweep")):
        np.testing.assert_allclose(out[f"{tag}_got"], out[f"{tag}_want"], atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{tag}_got"], ref, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{tag}_gx"], out[f"{tag}_want_gx"], atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{tag}_gw"], out[f"{tag}_want_gw"], atol=1e-5, err_msg=f"rank {r}")


def test_stack_stage_params_sharded_matches_unsharded(mp):
    """tests/test_property_extras.py:102: each rank's stage block of 8
    layers in 4 stages, gathered over pp, equals the plain stack bitwise."""
    for out in case(mp, "stack"):
        assert tuple(out["held"]) == (1, 2, 3, 5)
        np.testing.assert_array_equal(out["sharded_w"], out["plain_w"])
        np.testing.assert_array_equal(out["sharded_b"], out["plain_b"])


def test_layouts_the_reference_does_not_run_raise(mp):
    """``check_lm_mesh``: tp must divide the heads; sp > 1 needs the ring
    (a rank holds only its slice); an axis larger than 1 that the config
    does not name raises; a pipeline model's plain forward points to
    ``forward_pipelined``.  tp inside pipeline stages, which the reference
    runs (its stages run whole with ``mesh=None``), no longer raises: the
    model builds and ``forward_pipelined`` gives the rank's logits."""
    want = {"heads": "must divide n_heads", "pp_tp": "did not raise: (2, 8, 64)",
            "no_ring": "needs use_ring_attention=True", "stray": "name none of the config's axes",
            "plain_forward": "runs through forward_pipelined"}
    for out in case(mp, "refusals"):
        for name, text in want.items():
            assert text in str(out[name]), (name, out[name])


# ---------------------------------------------------------------- MoE, tp and pp beside each other

# what one routing call routes together under each layout's capacity rule, of the (8, 16) moe_tokens
ROUTED_TOKENS = {"moe_tp": 128, "moe_ep_tp": 64, "moe_ep_sp": 64, "moe_sp": 128, "moe_pp": 16, "moe_pp_ep": 32,
                 "moe_pp_sp": 16}
LOGITS_ATOL, GRAD_ATOL = 3e-4, 5e-5  # the float32 bars of the tests above (:293, :327)
_REF_LAYOUTS = {}


def _ref_layout(name, capacity):
    """The reference's run of a layout: its logits on the layout's mesh
    of 8 host devices (``forward``, or ``forward_pipelined`` with the
    layout's microbatches), and ``jax.grad`` of ``mean(log_softmax(logits)
    [..., 0])`` through it, as numpy trees."""
    key = (name, capacity)
    if key not in _REF_LAYOUTS:
        shape, axes, fields, micro, _, _ = mc.LAYOUTS[name]
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), axes)
        moe = dict(num_experts=mc.MOE_EXPERTS, moe_capacity=capacity) if capacity else {}
        cfg = _ref_cfg(**fields, **moe)
        seq = "sp" if "sp" in axes and not micro else None
        tokens = jax.device_put(jnp.asarray(TOKENS["moe_tokens"]), NamedSharding(mesh, P("dp", seq)))

        def loss(p):
            if micro:
                lg = ref_tr.forward_pipelined(p, tokens, cfg, mesh=mesh, num_microbatches=micro)
            else:
                lg = ref_tr.forward(p, tokens, cfg, mesh=mesh)
            return jnp.mean(jax.nn.log_softmax(lg)[..., 0]), lg

        (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(_jtree(_tree("moe" if capacity else "tp")))
        _REF_LAYOUTS[key] = (np.asarray(logits), jax.tree.map(lambda x: np.asarray(x, np.float32), grads))
    return _REF_LAYOUTS[key]


LAYOUT_RUNS = [(name, cap) for name in mc.LAYOUTS for cap in mc.layout_capacities(name)]


@pytest.mark.parametrize("name,capacity", LAYOUT_RUNS, ids=[f"{n}-cap{c}" for n, c in LAYOUT_RUNS])
def test_layout_matches_the_reference(mp, name, capacity):
    """MoE layers beside tp (dp 2, tp 4), ep beside tp and sp (each (2, 2,
    2)), MoE on an sp ring without ep (dp 2, sp 4), MoE in pipeline stages
    ((dp 4, pp 2), (2, 2, 2) with an ep or an sp axis) and dense tp inside
    stages ((2, 2, 2)): the global logits (atol 3e-4) and the gradients
    summed by the dense step's rule (atol 5e-5) against the reference's
    run of the same layout, at a capacity that drops tokens under the
    layout's rule and at one that drops none; every rank alike."""
    logits, grads = _ref_layout(name, capacity)
    tag = f"{name}_c{capacity or 0}"
    for r, out in enumerate(case(mp, "layouts")):
        np.testing.assert_allclose(out[f"{tag}_logits"], logits, atol=LOGITS_ATOL, err_msg=f"{tag} rank {r}")
        assert_tree(out, f"{tag}_grad", grads, f"{tag} rank {r}", atol=GRAD_ATOL)


@pytest.mark.parametrize("name", [n for n in mc.LAYOUTS if n in ROUTED_TOKENS])
def test_layout_capacity_rule(mp, name):
    """Each routing call of an MoE layout's forward routes the tokens its
    rule names (the global batch's 128, a dp shard's 64, a pipeline
    microbatch's, or its sp slice's), drops some at the layout's dropping
    capacity and none at 128."""
    drop = mc.LAYOUTS[name][4]
    for r, out in enumerate(case(mp, "layouts")):
        for cap in (drop, mc.NO_DROP):
            routed = out[f"{name}_c{cap}_routed"]
            assert len(routed) and (routed[:, 0] == ROUTED_TOKENS[name]).all(), (name, cap, r, routed)
            dropped = int((routed[:, 0] - routed[:, 1]).sum())
            assert (dropped > 0) == (cap == drop), (name, cap, r, dropped)


@pytest.mark.parametrize("name", list(mc.LAYOUTS))
def test_layout_planted_fault_falls_outside_the_bar(mp, name):
    """Each layout's planted fault, at its dropping capacity, lands
    outside the bar it is held to: an sp rank's MoE routing its own
    positions alone (the logits), a pipeline stage's MoE routing the whole
    dp shard instead of its microbatch (the logits), the tp-replicated
    experts' or stages' gradients summed over tp (the gradients)."""
    drop, fault = mc.LAYOUTS[name][4:]
    logits, grads = _ref_layout(name, drop)
    for r, out in enumerate(case(mp, "layouts")):
        if fault == "tp_sum":
            err = max(np.abs(out[k] - np.asarray(v)).max() for k, v in mc.pack(grads, f"{name}_fault_grad").items())
            assert err > 10 * GRAD_ATOL, (name, r, err)
        else:
            err = np.abs(out[f"{name}_fault_logits"] - logits).max()
            assert err > 10 * LOGITS_ATOL, (name, r, err)


def test_sp_moe_routes_the_global_batch(mp):
    """MoE layers on an sp ring without ep route the whole global batch, as
    the reference's ``moe_dense`` under GSPMD does: on (dp 2, sp 4) at
    capacity 8 (each of the 8 ranks holds 2 rows of 4 positions) the
    logits match the reference's sp-mesh forward and its mesh-less forward
    within 3e-4; routing each rank's slice alone misses by far more."""
    cfg = _ref_cfg(num_experts=mc.MOE_EXPERTS, moe_capacity=8)
    whole = np.asarray(ref_tr.forward(_jtree(_tree("moe")), jnp.asarray(TOKENS["moe_tokens"]), cfg))
    on_mesh, _ = _ref_layout("moe_sp", 8)
    for r, out in enumerate(case(mp, "layouts")):
        np.testing.assert_allclose(out["moe_sp_c8_logits"], on_mesh, atol=LOGITS_ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["moe_sp_c8_logits"], whole, atol=LOGITS_ATOL, err_msg=f"rank {r}")
        assert np.abs(out["moe_sp_fault_logits"] - whole).max() > 10 * LOGITS_ATOL


@pytest.fixture(scope="module")
def reference_moe_runs():
    """The reference's 2 steps of the MoE LM on each of MOE_REGIMES's
    meshes in each regime: {(layout, regime): (losses, final tree)}."""
    runs = {}
    opt = optax.adamw(mc.LR, eps=mc.EPS)
    for name in mc.MOE_REGIMES:
        shape, axes, fields, _, drop, _ = mc.LAYOUTS[name]
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), axes)
        cfg = _ref_cfg(**fields, num_experts=mc.MOE_EXPERTS, moe_capacity=drop)
        sh = NamedSharding(mesh, P("dp"))

        def loss_fn(p, b, cfg=cfg, mesh=mesh):
            return ref_tr.lm_loss(p, b, cfg, mesh=mesh)

        for regime in mc.REGIMES:
            params = ref_tr.init_params(jax.random.PRNGKey(mc.TREES["moe"][1]), cfg, mesh)
            batches = [{"tokens": jax.device_put(jnp.asarray(TOKENS[f"train_tokens{i}"]), sh)} for i in range(2)]
            if regime == "zero1":
                specs = ref_dense.opt_state_zero1_specs(opt.init(params), mesh)
                step = jax.jit(ref_dense.make_dense_train_step(loss_fn, opt, mesh=mesh, shard_opt_state=True,
                                                               opt_specs=specs))
                p, o, losses = params, opt.init(params), []
                for b in batches:
                    p, o, lo = step(p, o, b)
                    losses.append(float(lo))
                runs[name, regime] = (np.array(losses), p)
                continue
            if regime == "fsdp":
                params = ref_dense.fsdp_place(params, mesh)
            res = ref_dense.transform_dense(batches, loss_fn, ref_dense.DenseParameterServer(params, opt))
            runs[name, regime] = (np.array([float(x) for x in res.worker_outputs]), res.server_outputs[0])
    return runs


@pytest.mark.parametrize("name", mc.MOE_REGIMES)
@pytest.mark.parametrize("regime", mc.REGIMES)
def test_moe_regimes_match_the_reference(mp, reference_moe_runs, name, regime):
    """2 steps of ``transform_dense`` of the MoE LM on (dp 2, tp 4) and on
    (dp 2, ep 2, tp 2), capacity 8 (tokens drop under each rule), against
    the reference's same regime on the same mesh: losses rtol 1e-5, the
    whole trained tree at the LM bar; every rank alike; a rank holds the
    experts of its ep rank whole over tp (FSDP: cut over dp on the first
    free axis), and under ZeRO-1 its moment cut the same way."""
    losses, params = reference_moe_runs[name, regime]
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    experts = mc.MOE_EXPERTS // (2 if "ep" in name else 1)
    per_rank = case(mp, "moe_regimes")
    for r, out in enumerate(per_rank):
        err = f"{name} {regime} rank {r}"
        np.testing.assert_allclose(out[f"{name}_{regime}_loss"], losses, rtol=1e-5, err_msg=err)
        assert_tree(out, f"{name}_{regime}", tree, err, **LM_BAR)
        for k in mc.pack(tree, f"{name}_{regime}"):
            np.testing.assert_array_equal(out[k], per_rank[0][k], err_msg=f"{k} rank {r}")
        # dp merges into the first free axis: the expert axis without ep, the next one beside ep's
        cut = (2, 16, 64) if "ep" in name else (2, 32, 64)
        assert tuple(out[f"{name}_{regime}_held_w_up"]) == (cut if regime == "fsdp" else (experts, 32, 64))
        assert tuple(out[f"{name}_zero1_mu_w_up"]) == cut
