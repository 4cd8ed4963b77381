"""The 3xTF32 split that the float32 flash backward runs on the tensor cores.

``csrc/mma.cuh`` splits each float32 operand x into big = x rounded to
TF32 (10 mantissa bits, to nearest, ties away from zero) and small = x -
big, which the tensor cores read as TF32 (its 13 low bits dropped), and
takes a product as small_a big_b + big_a small_b + big_a big_b.  Here the
same arithmetic in torch on the CPU: the rounding pinned on exact bit
patterns, and the five products of the backward (q kᵀ, dO vᵀ, dS k, Pᵀ dO,
dSᵀ q) on a dp-4 rank's share of the LM cut to B 1, H 2, T 128, D 64,
held against float64 at the float32 bar the kernels keep (rtol 1e-5, atol
1e-5 of the largest value).  One TF32 product, as a planted contrast,
lands outside that bar.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

BAR = dict(rtol=1e-5, atol=1e-5)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32, to nearest with ties away from zero:
    half a TF32 unit added to the bits of its magnitude, the 13 low bits
    cleared (csrc/mma.cuh ``to_tf32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 register given as TF32: its
    13 low bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32_read(x - big)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from three TF32 products, cross terms first, float32 sums."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def product_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def _f32(*values):
    return torch.tensor(values, dtype=torch.float32)


def test_tf32_rounding_on_exact_bit_patterns():
    one = 1.0
    got = tf32(_f32(one + 2**-11, one + 2**-12, -(one + 2**-11), one + 2**-11 + 2**-23,
                    one + 2**-10 + 2**-11, 2**-149, 0.0))
    want = _f32(one + 2**-10,  # a tie goes away from zero (to even would give 1)
                one,  # below half a unit
                -(one + 2**-10),  # the same for a negative tie
                one + 2**-10,
                one + 2**-9,  # a tie above an odd unit: away from zero
                0.0,  # the smallest subnormal: no TF32 bits
                0.0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    mantissa = tf32(torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32)))
    assert bool(((mantissa.view(torch.int32) & 0x1FFF) == 0).all())


def test_split_carries_float32():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    big, small = split(x)
    assert torch.equal(big + (x - big), x)  # the remainder is exact in float32
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0**-21


def _share(seed=0, B=1, H=2, T=128, D=64):
    """A dp-4 rank's share of the LM's attention, cut to (B, H, T, D): q
    scaled by 1/sqrt(D), k, v, dO, and from them in float64 the causal P,
    dS = P (dP - delta), rounded to float32 as the kernels hold them."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, D)) * 0.8 for _ in range(3))
    q = q.astype(np.float32).astype(np.float64) * D**-0.5
    k, v = (x.astype(np.float32).astype(np.float64) for x in (k, v))
    do = rng.normal(size=(B, H, T, D)).astype(np.float32).astype(np.float64)
    s = q @ k.swapaxes(-1, -2)
    s = np.where(np.triu(np.ones((T, T), dtype=bool), 1), -np.inf, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = p @ v
    ds = p * (do @ v.swapaxes(-1, -2) - (o * do).sum(-1, keepdims=True))
    return {name: torch.from_numpy(x.astype(np.float32))
            for name, x in dict(q=q, k=k, v=v, do=do, p=p, ds=ds).items()}


def _products(t):
    """The backward's five products as (a, b) of a @ b."""
    kt, vt = t["k"].transpose(-1, -2), t["v"].transpose(-1, -2)
    return {
        "q kᵀ": (t["q"], kt),
        "dO vᵀ": (t["do"], vt),
        "dS k": (t["ds"], t["k"]),
        "Pᵀ dO": (t["p"].transpose(-1, -2), t["do"]),
        "dSᵀ q": (t["ds"].transpose(-1, -2), t["q"]),
    }


def _within_bar(got: torch.Tensor, want: torch.Tensor) -> bool:
    atol = BAR["atol"] * float(want.abs().max())
    return bool(torch.allclose(got.double(), want, rtol=BAR["rtol"], atol=atol))


@pytest.mark.parametrize("name", ["q kᵀ", "dO vᵀ", "dS k", "Pᵀ dO", "dSᵀ q"])
def test_three_products_keep_the_float32_bar(name):
    a, b = _products(_share())[name]
    want = a.double() @ b.double()
    assert _within_bar(product_3xtf32(a, b), want)
    assert not _within_bar(product_tf32(a, b), want)  # the planted contrast: one TF32 product
