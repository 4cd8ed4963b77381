"""The port's dense LM at dp 2 and flash attention on each dp rank, against
the JAX package's.

Mirrors tests/test_flash_attention.py :187 (``test_flash_mha_dp_parity``)
and :213 (``test_model_level_dp_flash_gating``), and runs the dp 2 arm of
tests/test_torch_zero1.py's comparisons (the MLP and the small LM, in the
three regimes).  The port runs in two spawned gloo ranks on a ``("dp",)``
mesh (one spawn for every case, ``tests/_torch_dense_cases.py``); the
reference runs here on its virtual devices.  Tolerances:
``flash_mha_dp`` against the reference attention on the whole batch atol
1e-5 (the reference's bar; on the CPU the kernel wrappers take their
plain versions), its gradients rtol 1e-4 / atol 1e-5; model-level logits
"auto" against "off" atol 1e-5 and against the reference's forward atol
2e-4 (tests/test_torch_transformer.py's bar); the MLP and LM bars are
tests/test_torch_zero1.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_dense_cases as dc
from flink_parameter_server_tpu.models import transformer as ref_tr
from test_torch_zero1 import (
    MLP_BAR, assert_lm_matches, case, reference_lm, reference_mlp, spawn,
)

DP = 2


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:8]), ("dp",))


@pytest.fixture(scope="module")
def dense2(tmp_path_factory):
    return spawn("dense2", tmp_path_factory)


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked_mean"])
def test_mlp_regimes_at_dp_2(dense2, jmesh, masked):
    """Replicated, ZeRO-1 and FSDP at dp 2 against the reference's
    replicated run; moments (and FSDP's parameters) cut in halves."""
    want_p, want_loss = reference_mlp("replicated", masked, jmesh)
    for r, out in enumerate(case(dense2, "mlp")):
        for regime in dc.REGIMES:
            tag = f"{regime}{'_masked' if masked else ''}"
            for name in ("w1", "b1", "w2"):
                np.testing.assert_allclose(out[f"{tag}_{name}"], want_p[name], **MLP_BAR,
                                           err_msg=f"{tag} {name} rank {r}")
            np.testing.assert_allclose(out[f"{tag}_loss"], want_loss, rtol=1e-5)
            cut = regime != "replicated"
            assert tuple(out[f"{tag}_mu_shape_w1"]) == ((16 // DP, 32) if cut else (16, 32))
            assert tuple(out[f"{tag}_held_w2"]) == ((32 // DP, 4) if regime == "fsdp" else (32, 4))


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "row_mask"])
def test_lm_regimes_at_dp_2(dense2, jmesh, masked):
    """The small LM through ``transform_dense(batch_sharding=mesh)`` at dp
    2, each regime against the reference's replicated run on 8 devices;
    the row mask leaves the two ranks 3 and 1 valid rows."""
    losses, params = reference_lm("replicated", masked, jmesh)
    for r, out in enumerate(case(dense2, "lm")):
        for regime in dc.REGIMES:
            tag = f"{regime}{'_masked' if masked else ''}"
            assert_lm_matches(out, tag, losses, params, f"{tag} rank {r}")


def test_flash_mha_dp_parity(dense2):
    """tests/test_flash_attention.py :187: flash per dp rank == the
    reference attention on the whole batch (attention never mixes batch
    rows), the global output and the whole gradient on every rank; the
    gate's structural parts."""
    from flink_parameter_server_tpu.parallel.ring_attention import reference_attention

    per_rank = case(dense2, "flash_dp")
    out = per_rank[0]
    want = np.asarray(reference_attention(*(jnp.asarray(out[n]) for n in "qkv")))
    for r, res in enumerate(per_rank):
        np.testing.assert_allclose(res["got"], want, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["got"], res["want"], atol=1e-5)
        for n in "qkv":
            np.testing.assert_allclose(res[f"grad_{n}"], res[f"want_grad_{n}"], rtol=1e-4, atol=1e-5,
                                       err_msg=f"d{n} rank {r}")
        # on the CPU the gate is false; with its CUDA test patched true the
        # shape gate and the dp rules decide
        assert not res["gate_cpu"] and res["gate_ok"]
        assert not res["gate_odd_batch"]  # 3 % 2 != 0
        assert not res["gate_sp"]  # an sp axis larger than 1
        assert not res["gate_short"]  # T 64 < 128
        assert "divisible by dp=2" in str(res["odd"])


def test_model_level_dp_flash_gating(dense2):
    """tests/test_flash_attention.py :213: ``forward(mesh=)`` with "auto"
    on a dp-only mesh, the gate resolving eligible, runs the flash
    kernels' ``flash_mha`` on each rank's rows, with no gather (once a
    layer in the forward and once in lm_loss's), matching "off" and the
    reference's forward."""
    from test_torch_zero1 import lm_reference_inputs

    ref_cfg, params, inputs = lm_reference_inputs()
    want = np.asarray(ref_tr.forward(params, jnp.asarray(inputs["lm_tokens0"]), ref_cfg))
    for r, out in enumerate(case(dense2, "model_flash_dp")):
        assert out["calls"].tolist() == [int(out["rows"])] * (2 * dc.LM_CFG["n_layers"])
        assert int(out["rows"]) * DP == inputs["lm_tokens0"].shape[0]
        np.testing.assert_allclose(out["auto"], out["off"], atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["auto"], want, atol=2e-4)
        ref_loss = float(ref_tr.lm_loss(params, {"tokens": jnp.asarray(inputs["lm_tokens0"])}, ref_cfg))
        np.testing.assert_allclose(out["loss"], ref_loss, rtol=1e-5)
