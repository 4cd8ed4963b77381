"""The port's expert parallelism (``models/moe.moe_apply`` over an ``ep``
axis, the MoE LM on ``("dp", "ep")`` and dp-only meshes, the dense step's
three regimes on the ep mesh) against the JAX package on its 8 virtual
devices.

Mirrors tests/test_moe.py's expert-parallel tests: ``:29`` / ``:42``
(``moe_apply`` against ``moe_reference`` on each dp shard, atol 2e-5),
``:54`` (capacity 1 drops tokens), ``:69`` (gradients against ``jax.grad``
of the oracle, atol 5e-4; an ``ep``-times expert gradient, the planted
fault, must fail that bar) and ``:88`` (the MoE LM on (2, 4) against the
mesh-less logits, atol 3e-4).  Beyond them:

* the dp-only mesh routes the GLOBAL batch (capacity 6 of 64 tokens, so
  tokens drop): logits within 2e-4 of the reference's dp-mesh forward
  (the mesh-less LM bar of tests/test_torch_transformer.py) and of the
  port's mesh-less run, while a per-rank routing of the same batch is
  more than 100 times that bar away; two training steps on the mesh
  against the mesh-less ones at tests/test_torch_zero1.py's LM bars;
* replicated, ZeRO-1 and FSDP on (2, 4) at a capacity where tokens drop,
  each against the reference's replicated dense step on the same mesh
  (tests/test_torch_zero1.py's bars: losses rtol 1e-5, parameters rtol
  1e-4 / atol 1e-6 + 1e-3·lr);
* ZeRO-1's specs equal the reference's ``_merged_dp_specs`` of the same
  tree (an expert leaf ``("ep", "dp", None)``);
* the flash gate takes the ep axis: the MoE LM at the kernels' shape on
  (2, 4) calls ``flash_mha`` on each rank's rows and matches "off" and the
  reference's forward on each dp shard.

The port runs in spawned gloo ranks on the CPU (``tests/_torch_mesh_child.py``
with ``tests/_torch_moe_cases.py``: ``ep8`` at (1, 8), ``ep24`` at (2, 4),
``moe_dp`` at dp 4, one spawn a battery); inputs come from seeds with
numpy and the reference's initialisers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_moe_cases as mc
from _torch_mesh_child import run_battery
from flink_parameter_server_tpu.core import dense as ref_dense
from flink_parameter_server_tpu.models import moe as ref_moe
from flink_parameter_server_tpu.models import transformer as ref_tr
from flink_parameter_server_tpu.parallel.mesh import make_mesh as ref_make_mesh

MOE_BAR = dict(atol=2e-5)  # tests/test_moe.py
GRAD_BAR = dict(atol=5e-4)  # tests/test_moe.py:69
EP_LM_BAR = dict(atol=3e-4)  # tests/test_moe.py:88
DP_LM_BAR = dict(atol=2e-4)  # tests/test_torch_transformer.py's LM logits
LM_BAR = dict(rtol=1e-4, atol=1e-6 + 1e-3 * mc.LM_LR)  # tests/test_torch_zero1.py
APPLY_INPUTS = {"ep8": (0, 0), "ep24": (1, 2)}  # (init key, x seed): tests/test_moe.py :29 and :42


def _x(n, seed):
    return np.random.default_rng(seed).normal(0, 1, (n, mc.MOE_CFG["d_model"])).astype(np.float32)


def _ref_cfg(capacity):
    return ref_moe.MoEConfig(**mc.MOE_CFG, capacity=capacity)


def _ref_params(key, capacity=16):
    return {k: np.asarray(v, np.float32)
            for k, v in ref_moe.init_moe_params(jax.random.PRNGKey(key), _ref_cfg(capacity)).items()}


def _ref_lm_cfg(capacity, **kw):
    return ref_tr.TransformerConfig(**mc.LM_CFG, moe_capacity=capacity, dtype=jnp.float32, **kw)


def lm_inputs(steps=3):
    """The reference's MoE LM weights (tests/test_moe.py:88's key 5) and
    (8, 8) token batches, as numpy."""
    params = ref_tr.init_params(jax.random.PRNGKey(5), _ref_lm_cfg(mc.LM_CAPACITY))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    rng = np.random.default_rng(6)
    out = {"lm_embed": tree["embed"], "lm_final_norm": tree["final_norm"], "lm_steps": np.int64(steps)}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"lm_layer{i}_{k}": v for k, v in layer.items() if k != "moe"})
        out.update({f"lm_layer{i}_moe_{k}": v for k, v in layer["moe"].items()})
    for i in range(steps):
        out[f"lm_tokens{i}"] = rng.integers(0, mc.LM_CFG["vocab_size"], (8, 8)).astype(np.int32)
    return tree, out


def spawn(battery, tmp_path_factory):
    out = tmp_path_factory.mktemp(battery)
    key, seed = APPLY_INPUTS.get(battery, (0, 0))
    inputs = dict(apply_x=_x(64, seed), drop_x=_x(64, 3), grad_x=_x(32, 4))
    for tag, k in (("apply", key), ("drop", 2), ("grad", 3)):
        inputs.update({f"{tag}_{n}": v for n, v in _ref_params(k).items()})
    inputs.update(lm_inputs()[1])
    np.savez(out / "inputs.npz", **inputs)
    return run_battery(battery, out, timeout=240)


@pytest.fixture(scope="module")
def ep8(tmp_path_factory):
    return spawn("ep8", tmp_path_factory)


@pytest.fixture(scope="module")
def ep24(tmp_path_factory):
    return spawn("ep24", tmp_path_factory)


@pytest.fixture(scope="module")
def moe_dp(tmp_path_factory):
    return spawn("moe_dp", tmp_path_factory)


@pytest.fixture
def battery(request):
    """(name, results) of the battery named by the parameter."""
    return request.param, request.getfixturevalue(request.param)


def case(res, name):
    """Every rank's outputs of one case; fails with the rank's traceback."""
    per_rank = res.get(name)
    assert per_rank is not None, f"case {name} wrote nothing:\n{res['_log'][-4000:]}"
    for r, out in enumerate(per_rank):
        assert isinstance(out, dict), f"case {name}, rank {r}:\n{out}"
    return per_rank


def _shards(dp, ep):
    """(rank, dp index, ep index) of every rank of the row-major mesh."""
    return [(d * ep + e, d, e) for d in range(dp) for e in range(ep)]


def _oracle_per_shard(params, x, capacity, dp):
    """tests/test_moe.py:42's rule: the oracle on each dp shard."""
    n = x.shape[0] // dp
    p = {k: jnp.asarray(v) for k, v in params.items()}
    return [np.asarray(ref_moe.moe_reference(p, jnp.asarray(x[i * n:(i + 1) * n]), _ref_cfg(capacity)))
            for i in range(dp)]


SHAPES = {"ep8": (1, 8), "ep24": (2, 4)}


@pytest.mark.parametrize("battery", ["ep8", "ep24"], indirect=True)
def test_ep_matches_oracle_per_dp_shard(battery):
    """tests/test_moe.py:29 at (1, 8) and :42 at (2, 4): every rank's
    output is the oracle's on its dp shard; the ep ranks of a dp row
    agree bitwise; one forward makes two all-to-all trips of this rank's
    (E, C, d) buckets, and a backward two more."""
    name, res = battery
    dp, ep = SHAPES[name]
    key, seed = APPLY_INPUTS[name]
    want = _oracle_per_shard(_ref_params(key), _x(64, seed), 16, dp)
    per_rank = case(res, "moe_apply")
    for r, d, e in _shards(dp, ep):
        out = per_rank[r]
        np.testing.assert_allclose(out["apply"], want[d], **MOE_BAR, err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["apply"], per_rank[d * ep]["apply"])
        assert int(out["apply_a2a_calls"]) == 2 and int(out["fwd_bwd_a2a_calls"]) == 4
        assert int(out["apply_a2a_bytes"]) == 2 * mc.MOE_CFG["num_experts"] * 16 * mc.MOE_CFG["d_model"] * 4
        assert "does not split over ep" in str(out["odd_experts"]), out["odd_experts"]


@pytest.mark.parametrize("battery", ["ep8", "ep24"], indirect=True)
def test_capacity_overflow_drops_tokens(battery):
    """tests/test_moe.py:54: at capacity 1 at most E·C tokens of a dp
    shard produce output, and the per-shard oracle agrees."""
    name, res = battery
    dp, ep = SHAPES[name]
    per_rank = case(res, "moe_apply")
    want = _oracle_per_shard(_ref_params(2), _x(64, 3), 1, dp)
    for r, d, _ in _shards(dp, ep):
        got = per_rank[r]["drop"]
        nonzero = int((np.abs(got).sum(axis=1) > 1e-7).sum())
        assert 0 < nonzero <= mc.MOE_CFG["num_experts"] * 1
        np.testing.assert_allclose(got, want[d], **MOE_BAR, err_msg=f"rank {r}")


def _oracle_grads(dp):
    """``jax.grad`` of the sum over dp shards of ``sum(moe_reference**2)``."""
    p = {k: jnp.asarray(v) for k, v in _ref_params(3).items()}
    x = _x(32, 4)
    n = 32 // dp

    def loss(q):
        return sum(jnp.sum(ref_moe.moe_reference(q, jnp.asarray(x[i * n:(i + 1) * n]), _ref_cfg(16)) ** 2)
                   for i in range(dp))

    return {k: np.asarray(v) for k, v in jax.grad(loss)(p).items()}


@pytest.mark.parametrize("battery", ["ep8", "ep24"], indirect=True)
def test_ep_gradients_match_oracle(battery):
    """tests/test_moe.py:69: the gradients, summed over dp (the dense
    step's rule), are ``jax.grad`` of the oracle's within atol 5e-4: each
    rank's expert leaves are its experts' slice, ``w_gate`` whole.  The
    planted fault (the experts' division by ep taken out) is outside that
    bar on every rank: the test sees an ``ep``-times expert gradient."""
    name, res = battery
    dp, ep = SHAPES[name]
    per_rank = case(res, "grad")
    want = _oracle_grads(dp)
    per = mc.MOE_CFG["num_experts"] // ep
    for e in range(ep):
        sl = slice(e * per, (e + 1) * per)
        for tag in ("grad", "fault"):
            summed = {k: sum(per_rank[d * ep + e][f"{tag}_{k}"] for d in range(dp))
                      for k in ("w_gate", "w_up", "w_down")}
            if tag == "grad":
                np.testing.assert_allclose(summed["w_gate"], want["w_gate"], **GRAD_BAR, err_msg=f"ep {e}")
                for k in ("w_up", "w_down"):
                    np.testing.assert_allclose(summed[k], want[k][sl], **GRAD_BAR, err_msg=f"{k} ep {e}")
            else:
                for k in ("w_up", "w_down"):
                    np.testing.assert_allclose(summed[k], ep * want[k][sl], rtol=1e-4, atol=1e-6)
                    assert not np.allclose(summed[k], want[k][sl], rtol=0, **GRAD_BAR), f"{k} ep {e}"


@pytest.mark.parametrize("battery", ["ep8", "ep24"], indirect=True)
def test_init_keeps_each_ranks_experts(battery):
    """``init_moe_params(mesh=)``: rank e of ep holds experts
    ``[e·E/ep, (e+1)·E/ep)`` of the whole draw, bitwise; ``w_gate`` whole."""
    name, res = battery
    ep = SHAPES[name][1]
    per_rank = case(res, "init")
    E = mc.MOE_CFG["num_experts"]
    for r, out in enumerate(per_rank):
        e = r % ep
        assert (int(out["start"]), int(out["stop"])) == (e * E // ep, (e + 1) * E // ep)
        for k in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(out[f"mine_{k}"], out[f"whole_{k}"], err_msg=f"{k} rank {r}")


def test_transformer_with_moe_layers_matches_unsharded(ep24):
    """tests/test_moe.py:88: the MoE LM on (2, 4) (capacity 64, no drops)
    against the reference's mesh-less logits, atol 3e-4; each rank holds
    2 of the 8 experts and the tree gathers back whole, bitwise."""
    tree, inputs = lm_inputs()
    cfg = _ref_lm_cfg(mc.LM_CAPACITY)
    want = np.asarray(ref_tr.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(inputs["lm_tokens0"][:4]), cfg))
    for r, out in enumerate(case(ep24, "lm")):
        np.testing.assert_allclose(out["logits"], want, **EP_LM_BAR, err_msg=f"rank {r}")
        assert tuple(out["held_w_up"]) == (2, 16, 32)
        np.testing.assert_array_equal(out["back_w_up"], tree["layers"][0]["moe"]["w_up"])
        np.testing.assert_array_equal(out["back_w_down"], tree["layers"][1]["moe"]["w_down"])
        np.testing.assert_array_equal(out["back_wqkv"], tree["layers"][0]["wqkv"])


def test_flash_runs_on_each_ep_rank(ep24):
    """Attention on the (2, 4) ``("dp", "ep")`` mesh: the gate takes the ep
    axis (the ep ranks of a dp row hold the same rows), so "auto" and "on"
    call ``flash_mha`` on the rank's 2 rows once a layer (forward, then
    lm_loss's forward) and match "off" (logits atol 1e-5, loss rtol 1e-5,
    the wqkv gradient atol 1e-5) and the reference's mesh-less forward of
    the same tree (atol 2e-4).  Without the ep axis, or with a batch dp
    does not divide, the gate stays shut."""
    for r, out in enumerate(case(ep24, "flash_ep")):
        assert out["gate_ep"] and not out["gate_no_ep"] and not out["gate_odd"], f"rank {r}"
        rows = mc.FLASH_BATCH // 2
        assert out["off_calls"].tolist() == []
        for mode in ("auto", "on"):
            assert out[f"{mode}_calls"].tolist() == [rows] * (2 * mc.FLASH_LM_CFG["n_layers"]), f"{mode} rank {r}"
            np.testing.assert_allclose(out[f"{mode}_logits"], out["off_logits"], atol=1e-5, err_msg=f"rank {r}")
            np.testing.assert_allclose(out[f"{mode}_loss"], out["off_loss"], rtol=1e-5)
            np.testing.assert_allclose(out[f"{mode}_grad_wqkv"], out["off_grad_wqkv"], atol=1e-5)
    out = case(ep24, "flash_ep")[0]
    layer = {k[len("tree_layer0_"):]: v for k, v in out.items()
             if k.startswith("tree_layer0_") and not k.startswith("tree_layer0_moe_")}
    layer["moe"] = {k: out[f"tree_layer0_moe_{k}"] for k in ("w_gate", "w_up", "w_down")}
    tree = {"embed": out["tree_embed"], "final_norm": out["tree_final_norm"], "layers": [layer]}
    cfg = ref_tr.TransformerConfig(**mc.FLASH_LM_CFG, moe_capacity=mc.FLASH_CAPACITY, dtype=jnp.float32)
    for d in range(2):  # the reference's capacity counts each dp shard: its forward on each shard
        shard = out["tokens"][d * rows:(d + 1) * rows]
        want = np.asarray(ref_tr.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(shard, jnp.int32), cfg))
        np.testing.assert_allclose(out["auto_logits"][d * rows:(d + 1) * rows], want, atol=2e-4)


@pytest.fixture(scope="module")
def reference_ep_run():
    """The reference's replicated dense step on its (2, 4) ``("dp", "ep")``
    mesh over the same 3 batches: (losses, final pytree)."""
    mesh = ref_make_mesh(2, 4, axis_names=("dp", "ep"))
    cfg = _ref_lm_cfg(mc.TRAIN_CAPACITY, ep_axis="ep")
    params = ref_tr.init_params(jax.random.PRNGKey(5), cfg, mesh)
    _, inputs = lm_inputs()
    opt = optax.adamw(mc.LM_LR, eps=mc.LM_EPS)
    step = jax.jit(ref_dense.make_dense_train_step(lambda p, b: ref_tr.lm_loss(p, b, cfg, mesh=mesh), opt))
    o, losses = opt.init(params), []
    for i in range(3):
        tok = jax.device_put(jnp.asarray(inputs[f"lm_tokens{i}"]), NamedSharding(mesh, P("dp")))
        params, o, loss = step(params, o, {"tokens": tok})
        losses.append(float(loss))
    return np.array(losses), jax.tree.map(lambda x: np.asarray(x, np.float32), params)


@pytest.mark.parametrize("regime", mc.REGIMES)
def test_regimes_on_the_ep_mesh_match_the_reference(ep24, reference_ep_run, regime):
    """Replicated, ZeRO-1 and FSDP through ``transform_dense(batch_sharding=
    mesh)`` on (2, 4), capacity 3 a dp shard (tokens drop), against the
    reference's replicated step on the same mesh, every rank alike; a rank
    holds its 2 experts (FSDP: cut over dp on the next axis), ZeRO-1's
    moment of an expert leaf is ``(2, 16 / dp, 32)``."""
    losses, tree = reference_ep_run
    per_rank = case(ep24, "regimes")
    for r, out in enumerate(per_rank):
        err = f"{regime} rank {r}"
        np.testing.assert_allclose(out[f"{regime}_loss"], losses, rtol=1e-5, err_msg=err)
        np.testing.assert_allclose(out[f"{regime}_embed"], tree["embed"], **LM_BAR, err_msg=err)
        np.testing.assert_allclose(out[f"{regime}_final_norm"], tree["final_norm"], **LM_BAR, err_msg=err)
        for i, layer in enumerate(tree["layers"]):
            for k, v in layer.items():
                if k == "moe":
                    for m, w in v.items():
                        np.testing.assert_allclose(out[f"{regime}_layer{i}_moe_{m}"], w, **LM_BAR,
                                                   err_msg=f"{err} layer {i} {m}")
                else:
                    np.testing.assert_allclose(out[f"{regime}_layer{i}_{k}"], v, **LM_BAR,
                                               err_msg=f"{err} layer {i} {k}")
        for key in out:
            if key.startswith(regime) and "held" not in key:
                np.testing.assert_array_equal(out[key], per_rank[0][key], err_msg=f"{key} rank {r}")
        assert tuple(out[f"{regime}_held_w_up"]) == ((2, 8, 32) if regime == "fsdp" else (2, 16, 32))
        assert tuple(out["zero1_mu_w_up"]) == (2, 8, 32)


def test_zero1_specs_equal_the_references(ep24):
    """ZeRO-1's specs for the MoE LM on (2, 4) are the reference's
    ``_merged_dp_specs`` of the same tree, leaf by leaf: dp merged into an
    expert leaf's ``("ep", None, None)`` on its next free axis.  Without
    the module, whose recorded layout they merge into, the call raises
    (it would give the expert leaves dp on their expert axis)."""
    mesh = ref_make_mesh(2, 4, axis_names=("dp", "ep"))
    cfg = _ref_lm_cfg(mc.LM_CAPACITY, ep_axis="ep")
    params = ref_tr.init_params(jax.random.PRNGKey(5), cfg, mesh)
    mu = ref_dense.opt_state_zero1_specs(optax.adamw(mc.LM_LR).init(params), mesh)[0].mu

    def ref_spec(name):
        node = mu
        for part in name.split("."):
            node = node[int(part)] if part.isdigit() else node[part]
        return "None" if node is None else str(tuple(node.spec))

    for r, out in enumerate(case(ep24, "specs")):
        names = [str(n) for n in out["names"]]
        assert list(out["specs"]) == [ref_spec(n) for n in names], f"rank {r}"
        experts = [i for i, n in enumerate(names) if n.endswith(("moe.w_up", "moe.w_down"))]
        assert experts and all(out["specs"][i] == "('ep', 'dp', None)" for i in experts)
        assert "params=" in str(out["bare"]) and "('dp', 'ep')" in str(out["bare"])


def test_dp_only_mesh_routes_the_global_batch(moe_dp):
    """On a dp-only mesh (dp 4) the MoE LM routes the whole batch, as the
    reference's dp-mesh forward does: capacity 6 counts the global
    batch's 64 tokens (some drop in every layer).  The logits are within
    2e-4 of the reference's dp-mesh forward and of the port's mesh-less
    run on the whole batch; routing each rank's 16 tokens alone gives
    other logits, more than 100 times that bar away.  Two training steps
    on the mesh match the mesh-less steps."""
    tree, inputs = lm_inputs()
    cfg = _ref_lm_cfg(mc.DP_CAPACITY)
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    tokens = jax.device_put(jnp.asarray(inputs["lm_tokens0"]), NamedSharding(mesh, P("dp")))
    want = np.asarray(jax.jit(lambda p, t: ref_tr.forward(p, t, cfg, mesh=mesh))(jax.tree.map(jnp.asarray, tree),
                                                                                  tokens))
    for r, out in enumerate(case(moe_dp, "dp_routing")):
        err = f"rank {r}"
        np.testing.assert_allclose(out["dp"], want, **DP_LM_BAR, err_msg=err)
        np.testing.assert_allclose(out["dp"], out["whole"], **DP_LM_BAR, err_msg=err)
        assert np.abs(out["per_rank"] - out["dp"]).max() > 100 * DP_LM_BAR["atol"], err
        kept = out["kept"]
        assert len(kept) == mc.LM_CFG["n_layers"] and all(n == 64 and k < n for k, n in kept), kept
        np.testing.assert_allclose(out["mesh_loss"], out["single_loss"], rtol=1e-5, err_msg=err)
        for k in ("w_up", "w_gate", "wqkv"):
            np.testing.assert_allclose(out[f"mesh_{k}"], out[f"single_{k}"], **LM_BAR, err_msg=f"{k} {err}")
