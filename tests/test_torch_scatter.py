"""Port of the sorted scatter-add (K1): plain version vs the Pallas kernel.

The JAX side runs ``ops/pallas_scatter.scatter_add`` in interpret mode, as
tests/test_pallas_scatter.py does; the port runs on CPU tensors, so its
wrapper takes the kernel's plain torch version.  Float tables: both sum a
run in float32 in stream order, so results agree to rtol 1e-6 (set for the
rare reordering of one add).  Integer tables: exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.ops.pallas_scatter import scatter_add as jax_scatter_add
from flink_parameter_server_tpu_torch.ops.scatter_kernel import (
    run_sum_write_plain,
    scatter_add,
    sorted_scatter_add,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-6


def _both(table, ids, deltas, mask=None, **kw):
    want = np.asarray(
        jax_scatter_add(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(deltas),
            None if mask is None else jnp.asarray(mask), chunk=8, interpret=True, **kw,
        )
    )
    got = scatter_add(
        torch.from_numpy(table.copy()), torch.from_numpy(ids), torch.from_numpy(deltas),
        None if mask is None else torch.from_numpy(mask), **kw,
    ).numpy()
    return got, want


def test_matches_jax_random():
    rng = np.random.default_rng(0)
    table = rng.normal(0, 1, (32, 8)).astype(np.float32)
    ids = rng.integers(0, 32, 50).astype(np.int32)
    deltas = rng.normal(0, 1, (50, 8)).astype(np.float32)
    got, want = _both(table, ids, deltas)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_hot_run_mask_out_of_range_unaligned_capacity():
    """One id over many kernel chunks (the Zipf-hot case) and a Zipf tail,
    with masked, negative and past-the-end lanes, on a capacity that is not
    a multiple of 8 (the reference pads it, a TPU window rule; the port
    needs no padding)."""
    rng = np.random.default_rng(3)
    ids = np.concatenate([np.full(200, 3), (rng.zipf(1.2, 56) - 1) % 30]).astype(np.int32)
    ids[:6] = [-2, 99, 30, 29, 29, 0]
    rng.shuffle(ids)
    table = rng.normal(0, 1, (30, 4)).astype(np.float32)
    deltas = rng.normal(0, 1, (256, 4)).astype(np.float32)
    mask = rng.random(256) > 0.1
    deltas[~mask] = np.nan  # a masked lane's delta must be inert even as NaN
    got, want = _both(table, ids, deltas, mask)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isfinite(got).all()


def test_integer_table_exact_past_f32_mantissa():
    big = 20_000_000  # > 2**24: +1 is lost in a float32 round trip
    table = np.full((8, 128), big, np.int32)
    ids = np.zeros(16, np.int32)
    deltas = np.ones((16, 128), np.int32)
    got, want = _both(table, ids, deltas)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == big + 16 and got[1, 0] == big


@pytest.mark.parametrize("sub_k,width", [(2, 64), (16, 8)])
def test_packed_sub_k(sub_k, width):
    rng = np.random.default_rng(sub_k)
    rows = 8
    table = rng.normal(0, 1, (rows, 128)).astype(np.float32)
    ids = ((rng.zipf(1.3, 96) - 1) % (rows * sub_k + 3)).astype(np.int32)  # some past the end
    deltas = rng.normal(0, 1, (96, width)).astype(np.float32)
    got, want = _both(table, ids, deltas, sub_k=sub_k, sub_width=width)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bfloat16_table():
    """bfloat16: deltas cast to the table type, summed in float32, one
    rounding on the write — bitwise the reference's rule."""
    rng = np.random.default_rng(5)
    table = rng.normal(0, 1, (16, 8)).astype(np.float32)
    ids = ((rng.zipf(1.3, 64) - 1) % 16).astype(np.int32)
    deltas = rng.normal(0, 0.1, (64, 8)).astype(np.float32)
    want = jax_scatter_add(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(ids),
        jnp.asarray(deltas, jnp.bfloat16), chunk=8, interpret=True,
    )
    got = scatter_add(
        torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(ids),
        torch.from_numpy(deltas).to(torch.bfloat16),
    )
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_kernel_entry_checks_its_arguments():
    table = torch.zeros(8, 4)
    ids = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        sorted_scatter_add(table, ids.long(), torch.ones(2, 4))
    with pytest.raises(ValueError, match="dtype"):
        sorted_scatter_add(table, ids, torch.ones(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="exceeds"):
        sorted_scatter_add(table, ids, torch.ones(2, 4), sub_k=2)
    with pytest.raises(ValueError, match="contiguous"):
        sorted_scatter_add(table, ids, torch.ones(4, 2).t())
    wide = torch.zeros(8, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32, bfloat16 or int32"):
        sorted_scatter_add(wide, ids, torch.ones(2, 4, dtype=torch.float64))


def test_plain_version_writes_each_run_once():
    """The plain version sums runs before the write: a bfloat16 row gets
    ONE rounding however long its run (an add per lane would round 64
    times and drift)."""
    table = torch.zeros(2, 1, dtype=torch.bfloat16)
    ids = torch.zeros(64, dtype=torch.int32)
    vals = torch.full((64, 1), 1e-3, dtype=torch.float32)
    run_sum_write_plain(table, ids, vals)
    assert table[0, 0].item() == torch.tensor(64e-3, dtype=torch.float32).to(torch.bfloat16).item()
    assert table[1, 0].item() == 0.0
