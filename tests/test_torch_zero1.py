"""The port's dense data parallelism (replicated, ZeRO-1, FSDP) at dp 4
against the JAX package's on its 8 virtual devices.

Mirrors tests/test_zero1.py (all but ``:186``
``test_zero1_specs_compose_with_tp``, which needs ``tp``: the next port
slice) and the three checks of tests/test_zero1_memory.py, and runs the
small LM through ``transform_dense(batch_sharding=)`` beside the
reference's.

The port runs in four spawned gloo ranks on a ``("dp",)`` mesh
(``tests/_torch_mesh_child.py`` with ``tests/_torch_dense_cases.py``, one
spawn for every case); the reference runs here.  Inputs come from seeds
with numpy; the LM's weights are the reference's ``init_params``, carried
through ``interop``.  Tolerances:

* tests/test_zero1.py's MLP under Adam(1e-2): parameters rtol 1e-5 / atol
  1e-6 and losses rtol 1e-5, against the reference's replicated, ZeRO-1
  and FSDP runs and the port's own unsharded step, for the plain mean loss
  and a masked mean whose ranks hold different counts of valid rows;
* the LM (2 layers, d_model 128, 2 heads, T 128, float32) under
  AdamW(1e-2, eps 1e-4) over 3 steps: losses rtol 1e-5, parameters rtol
  1e-4 / atol 1e-6 + 1e-3·lr (tests/test_torch_dense.py's AdamW bar: an
  update divides by the gradient's own size, so a gradient element at
  float32 noise moves by up to lr), with and without a (B,) row mask that
  leaves the ranks 2, 1, 0 and 1 valid rows;
* memory: a rank's ZeRO-1 optimizer state within (0.9/n, 1.5/n) of the
  replicated one's and its parameters no larger; FSDP's parameters plus
  optimizer state within (0.9/n, 1.8/n); every regime's loss finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_dense_cases as dc
from _torch_mesh_child import run_battery
from flink_parameter_server_tpu.core import dense as ref_dense
from flink_parameter_server_tpu.models import transformer as ref_tr

DP = 4
MLP_BAR = dict(rtol=1e-5, atol=1e-6)
LM_BAR = dict(rtol=1e-4, atol=1e-6 + 1e-3 * dc.LM_LR)
LM_MASK = np.array([1, 1, 1, 0, 0, 0, 1, 0], np.float32)  # 2, 1, 0, 1 valid rows at dp 4; 3, 1 at dp 2


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:8]), ("dp",))


def lm_reference_inputs(steps=3):
    """The reference's LM weights and the token batches, as numpy."""
    ref_cfg = ref_tr.TransformerConfig(**dc.LM_CFG, dtype=jnp.float32)
    params = ref_tr.init_params(jax.random.PRNGKey(0), ref_cfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    rng = np.random.default_rng(7)
    out = {"lm_embed": tree["embed"], "lm_final_norm": tree["final_norm"], "lm_steps": np.int64(steps),
           "lm_mask": LM_MASK}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"lm_layer{i}_{k}": v for k, v in layer.items()})
    for i in range(steps):
        out[f"lm_tokens{i}"] = rng.integers(0, dc.LM_CFG["vocab_size"], (8, 128)).astype(np.int32)
    return ref_cfg, params, out


def spawn(battery, tmp_path_factory):
    out = tmp_path_factory.mktemp(battery)
    _, _, inputs = lm_reference_inputs()
    np.savez(out / "inputs.npz", **inputs)
    return run_battery(battery, out, timeout=240)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return spawn("dense", tmp_path_factory)


def case(res, name):
    """Every rank's outputs of one case; fails with the rank's traceback."""
    per_rank = res.get(name)
    assert per_rank is not None, f"case {name} wrote nothing:\n{res['_log'][-4000:]}"
    for r, out in enumerate(per_rank):
        assert isinstance(out, dict), f"case {name}, rank {r}:\n{out}"
    return per_rank


def _ref_mlp_loss(p, b):
    h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] - b["y"]) ** 2)


def _ref_masked_loss(p, b):
    err = jnp.sum((jnp.tanh(b["x"] @ p["w1"] + p["b1"]) @ p["w2"] - b["y"]) ** 2, axis=-1)
    return jnp.sum(err * b["mask"]) / jnp.maximum(jnp.sum(b["mask"]), 1.0)


def reference_mlp(regime, masked, mesh):
    """tests/test_zero1.py's runs: (final params, losses) of ``regime``."""
    params = jax.tree.map(jnp.asarray, dc.mlp_init())
    opt = optax.adam(dc.MLP_LR)
    loss = _ref_masked_loss if masked else _ref_mlp_loss
    if regime == "fsdp":
        params = ref_dense.fsdp_place(params, mesh)
    step = jax.jit(ref_dense.make_dense_train_step(
        loss, opt, mesh=mesh if regime == "zero1" else None, shard_opt_state=regime == "zero1"))
    p, o = params, opt.init(params)
    sh = NamedSharding(mesh, P("dp"))
    losses = []
    for b in dc.mlp_batches():
        b = {k: jax.device_put(jnp.asarray(v), sh) if regime != "replicated" else jnp.asarray(v)
             for k, v in b.items()}
        p, o, lo = step(p, o, b)
        losses.append(float(lo))
    return jax.tree.map(np.asarray, p), np.array(losses)


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked_mean"])
@pytest.mark.parametrize("regime", dc.REGIMES)
def test_zero1_matches_replicated(dense, jmesh, regime, masked):
    """tests/test_zero1.py :50 / :140 (``test_fsdp_matches_replicated``
    in the fsdp rows): each regime at dp 4 against the reference's same
    regime on 8 devices and against the port's unsharded step, every rank
    alike."""
    want_p, want_loss = reference_mlp(regime, masked, jmesh)
    tag = f"{regime}{'_masked' if masked else ''}"
    for r, out in enumerate(case(dense, "mlp")):
        single = f"single{'_masked' if masked else ''}"
        for name in ("w1", "b1", "w2"):
            np.testing.assert_allclose(out[f"{tag}_{name}"], want_p[name], **MLP_BAR, err_msg=f"{name} rank {r}")
            np.testing.assert_allclose(out[f"{tag}_{name}"], out[f"{single}_{name}"], **MLP_BAR)
        np.testing.assert_allclose(out[f"{tag}_loss"], want_loss, rtol=1e-5)
        np.testing.assert_allclose(out[f"{tag}_loss"], out[f"{single}_loss"], rtol=1e-5)
        # the memory win: Adam's moments of every divisible leaf come back
        # dp-sharded along their first axis; FSDP holds parameter slices too
        full = {"w1": (16, 32), "b1": (32,), "w2": (32, 4)}
        for name, shape in full.items():
            cut = (shape[0] // DP,) + shape[1:]
            assert tuple(out[f"{tag}_mu_shape_{name}"]) == (shape if regime == "replicated" else cut)
            assert tuple(out[f"{tag}_held_{name}"]) == (cut if regime == "fsdp" else shape)


def test_the_masked_mean_weights_ranks_by_their_rows(dense):
    """The masks leave the ranks different valid-row counts, so the mean of
    the ranks' own masked means is another number than the whole batch's
    masked mean, far past the bar: the losses agreeing above is the
    global_mean route at work, not a coincidence of the data."""
    b = dc.mlp_batches()[0]
    counts = b["mask"].reshape(DP, -1).sum(1)
    assert len(set(counts.tolist())) == DP
    p = dc.mlp_init()
    err = ((np.tanh(b["x"] @ p["w1"] + p["b1"]) @ p["w2"] - b["y"]) ** 2).sum(-1) * b["mask"]
    whole = err.sum() / b["mask"].sum()
    per_rank = np.mean(err.reshape(DP, -1).sum(1) / np.maximum(counts, 1))
    assert abs(per_rank - whole) > 1e-2 * whole
    out = case(dense, "mlp")[0]
    np.testing.assert_allclose(out["replicated_masked_loss"][0], whole, rtol=1e-5)


def test_zero1_non_divisible_leaf_stays_replicated(dense, jmesh):
    """tests/test_zero1.py :84: the (3, 5) leaf keeps a whole moment, the
    (16, 32) one is cut over dp; the specs are the reference's; the step
    trains (its result against the reference's step)."""
    per_rank = case(dense, "odd_leaf")
    out = per_rank[0]
    assert tuple(out["mu_shape_odd"]) == (3, 5) and tuple(out["mu_shape_w"]) == (16 // DP, 32)
    assert list(out["specs"]) == ["None", "('dp', None)"]
    rng = np.random.default_rng(0)
    params = {"w": jnp.asarray(rng.normal(0, 0.1, (16, 32)), jnp.float32),
              "odd": jnp.asarray(rng.normal(0, 0.1, (3, 5)), jnp.float32)}
    opt = optax.adam(dc.MLP_LR)
    # the reference's specs for the same leaves: odd replicated, w on dp
    specs = ref_dense.opt_state_zero1_specs(opt.init(params), jmesh)
    assert specs[0].mu["odd"] is None and tuple(specs[0].mu["w"].spec) == ("dp", None)

    def loss_fn(p, b):
        return jnp.mean((b["x"] @ p["w"]) ** 2) + jnp.sum(p["odd"] ** 2)

    step = jax.jit(ref_dense.make_dense_train_step(loss_fn, opt, mesh=jmesh, shard_opt_state=True))
    x = jax.device_put(jnp.asarray(out["x"]), NamedSharding(jmesh, P("dp")))
    p, _, loss = step(params, opt.init(params), {"x": x})
    for r, res in enumerate(per_rank):
        assert np.isfinite(res["loss"])
        np.testing.assert_allclose(res["loss"], float(loss), rtol=1e-5)
        for name in ("w", "odd"):
            np.testing.assert_allclose(res[name], np.asarray(p[name]), **MLP_BAR, err_msg=f"{name} rank {r}")


def test_zero1_refusals(dense):
    """tests/test_zero1.py :114 / :121: ZeRO-1 without a mesh and a mesh
    without ``dp`` raise, as the reference's do; so do a multi-axis mesh
    without ``opt_specs`` (the reference's :209) and a batch dp does not
    divide (the reference's flash_mha_dp rule)."""
    for out in case(dense, "refusals"):
        said = list(out["said"])
        assert "requires mesh" in said[0]
        assert "not in mesh axes" in said[1] and "data" in said[1]
        assert "opt_specs" in said[2]
        assert "does not split into dp=4" in said[3]


def test_a_regulariser_on_global_mean_raises(dense):
    """``global_mean(...) + reg`` is on neither gradient route (the sum
    route would count ``reg`` dp times, the mean route the global part
    1/dp): the step raises and names both.  The regulariser added to a
    mean over equal slices takes the mean route and reports the whole
    batch's loss."""
    for out in case(dense, "loss_routes"):
        said = str(out["mixed"])
        assert "sum route" in said and "mean route" in said, said
        np.testing.assert_allclose(float(out["mean_route_loss"]), float(out["whole_loss"]), rtol=1e-6)


def test_moe_on_a_dp_mesh_raises(dense):
    """The LM with MoE layers on a dp mesh no longer raises: it builds with
    every expert on each rank and routes the whole batch, as
    ``moe_capacity`` counts the whole batch's tokens, so its global logits
    are the mesh-less run's on the whole batch (tests/test_torch_moe_ep.py
    holds it against the reference, with tokens dropped)."""
    for out in case(dense, "loss_routes"):
        assert int(out["moe_init"]) == 4
        assert out["moe_forward"].shape == (DP, 16, dc.LM_CFG["vocab_size"])
        assert np.isfinite(out["moe_forward"]).all()
        np.testing.assert_allclose(out["moe_forward"], out["moe_whole"], atol=2e-4)


def test_memory_is_one_over_dp(dense):
    """tests/test_zero1_memory.py's three checks, from the bytes a rank
    holds after one step of its small LM."""
    for out in case(dense, "memory"):
        repl_p, repl_o = int(out["replicated_params"]), int(out["replicated_opt"])
        ratio = int(out["zero1_opt"]) / repl_o
        assert 0.9 / DP < ratio < 1.5 / DP, ratio
        assert int(out["zero1_params_before"]) == repl_p and int(out["zero1_params"]) <= repl_p
        total = (int(out["fsdp_params"]) + int(out["fsdp_opt"])) / (repl_p + repl_o)
        assert 0.9 / DP < total < 1.8 / DP, total
        for regime in dc.REGIMES:
            assert np.isfinite(out[f"{regime}_loss"]), regime


def reference_lm(regime, masked, mesh):
    """The reference's LM run on ``mesh``: (losses, final pytree)."""
    ref_cfg, params, inputs = lm_reference_inputs()
    batches = [{"tokens": jnp.asarray(inputs[f"lm_tokens{i}"])} for i in range(3)]
    if masked:
        batches = [dict(b, mask=jnp.asarray(LM_MASK)) for b in batches]
    opt = optax.adamw(dc.LM_LR, eps=dc.LM_EPS)

    def loss_fn(p, b):
        return ref_tr.lm_loss(p, b, ref_cfg, mesh=mesh)

    sh = NamedSharding(mesh, P("dp"))
    if regime == "zero1":
        step = jax.jit(ref_dense.make_dense_train_step(loss_fn, opt, mesh=mesh, shard_opt_state=True))
        p, o, losses = params, opt.init(params), []
        for b in batches:
            p, o, lo = step(p, o, {k: jax.device_put(v, sh) for k, v in b.items()})
            losses.append(float(lo))
        return np.array(losses), p
    if regime == "fsdp":
        params = ref_dense.fsdp_place(params, mesh)
    res = ref_dense.transform_dense(batches, loss_fn, ref_dense.DenseParameterServer(params, opt),
                                    batch_sharding=sh)
    return np.array([float(x) for x in res.worker_outputs]), res.server_outputs[0]


def assert_lm_matches(out, tag, losses, params, err):
    np.testing.assert_allclose(out[f"{tag}_loss"], losses, rtol=1e-5, err_msg=err)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    np.testing.assert_allclose(out[f"{tag}_embed"], tree["embed"], **LM_BAR, err_msg=err)
    np.testing.assert_allclose(out[f"{tag}_final_norm"], tree["final_norm"], **LM_BAR, err_msg=err)
    for i, layer in enumerate(tree["layers"]):
        for k, v in layer.items():
            np.testing.assert_allclose(out[f"{tag}_layer{i}_{k}"], v, **LM_BAR, err_msg=f"{err} layer {i} {k}")


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "row_mask"])
@pytest.mark.parametrize("regime", dc.REGIMES)
def test_lm_on_a_dp_mesh_matches_the_reference(dense, jmesh, regime, masked):
    """``transform_dense(batch_sharding=mesh)`` with ``lm_loss(mesh=)`` at
    dp 4 against the reference's same regime on its 8-device mesh, and
    against the port's unsharded run; the row-masked batches leave the
    ranks 2, 1, 0 and 1 valid rows."""
    losses, params = reference_lm(regime, masked, jmesh)
    tag = f"{regime}{'_masked' if masked else ''}"
    for r, out in enumerate(case(dense, "lm")):
        assert_lm_matches(out, tag, losses, params, f"{tag} rank {r}")
        np.testing.assert_allclose(out[f"{tag}_loss"], out[f"single{'_masked' if masked else ''}_loss"], rtol=1e-5)
