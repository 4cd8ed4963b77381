"""Port of the per-id initializers: torch Threefry vs jax.random.

``ranged_random_factor`` must be BITWISE the reference's (every later table
comparison rests on it).  ``normal_factor`` maps the same uniform bits
through ``erfinv``, whose torch and XLA implementations differ by a few
float32 ulps near the tails: rtol 1e-5 (measured worst ~6e-6), atol 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.utils import initializers as ref
from flink_parameter_server_tpu_torch.utils import initializers as port

torch.set_num_threads(2)

IDS = np.concatenate(
    [np.arange(4096), [2**31 - 1, 2**31, 2**32 - 1, 123_456_789]]
).astype(np.uint32)
SHAPES = [(), (1,), (3,), (64,), (2, 5)]


def _port_ids():
    return torch.from_numpy(IDS.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_ranged_random_factor_bitwise(seed, shape):
    want = np.asarray(ref.ranged_random_factor(seed, shape)(jnp.asarray(IDS)))
    got = port.ranged_random_factor(seed, shape)(_port_ids()).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_ranged_random_factor_custom_range_bitwise():
    want = np.asarray(ref.ranged_random_factor(3, (8,), low=-0.5, high=2.0)(jnp.asarray(IDS)))
    got = port.ranged_random_factor(3, (8,), low=-0.5, high=2.0)(_port_ids()).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_int32_ids_match_uint32_view():
    """Negative int32 ids reinterpret as uint32, as ``astype(uint32)`` does."""
    ids = np.asarray([-1, -2, 5], np.int32)
    want = np.asarray(ref.ranged_random_factor(1, (4,))(jnp.asarray(ids)))
    got = port.ranged_random_factor(1, (4,))(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_factor_allclose(shape):
    want = np.asarray(ref.normal_factor(11, shape, stddev=0.02)(jnp.asarray(IDS)))
    got = port.normal_factor(11, shape, stddev=0.02)(_port_ids()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_zeros_and_dtype_guard():
    out = port.zeros((2, 3), torch.int32)(torch.arange(4))
    assert out.shape == (4, 2, 3) and out.dtype == torch.int32 and not out.any()
    with pytest.raises(TypeError, match="float32"):
        port.ranged_random_factor(0, (4,), dtype=torch.bfloat16)

