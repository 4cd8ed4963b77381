"""The port's attention against the JAX package's, on the CPU.

``reference_attention`` against the reference's; the flash path's plain
versions (``flash_mha_plain`` — the tiles, online softmax and explicit
backward the CUDA kernels compute) against the splash kernel run in
interpret mode and against the reference attention.  Bars, those of
tests/test_flash_attention.py: float32 forward atol 1e-5, bfloat16 0.02,
float32 gradients 1e-4; bfloat16 gradients 2**-6 of each gradient's
largest magnitude (two bfloat16 units: the gradients round to bfloat16
from float32 sums taken in another order).  The plain dQ rounds dS to
bfloat16 before ``dS k``, and dK and dV round P and dS before their
products, as splash does; the dQ-only test holds dQ to 2**-9 of its
largest magnitude.  The same inputs, made with numpy, go to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.ops.flash_attention import flash_mha as ref_flash_mha
from flink_parameter_server_tpu.parallel.ring_attention import reference_attention as ref_attention
from flink_parameter_server_tpu_torch.ops import flash_attention as fa
from flink_parameter_server_tpu_torch.parallel.ring_attention import reference_attention

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(B, T, H, D, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    arrs = [(rng.normal(size=(B, T, H, D)) * 0.5).astype(np.float32) for _ in range(3)]
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 0.02)])
def test_reference_attention_matches(dtype, tol):
    (jq, jk, jv), (q, k, v) = _qkv(2, 48, 3, 16, dtype)
    got, want = reference_attention(q, k, v), ref_attention(jq, jk, jv)
    assert got.dtype == q.dtype  # bfloat16 stays bfloat16, as in the reference
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    np.testing.assert_allclose(
        _np(reference_attention(q, k, v, causal=False)), _np(ref_attention(jq, jk, jv, causal=False)),
        atol=tol,
    )


@pytest.mark.parametrize(
    "B,T,H,D,dtype,tol",
    [(2, 128, 2, 64, "float32", 1e-5), (1, 128, 2, 128, "float32", 1e-5), (1, 128, 2, 64, "bfloat16", 0.02)],
)
def test_plain_flash_forward_matches_splash_and_reference(B, T, H, D, dtype, tol):
    (jq, jk, jv), (q, k, v) = _qkv(B, T, H, D, dtype, seed=D)
    got = fa.flash_mha_plain(q, k, v)
    assert got.shape == q.shape and got.dtype == v.dtype
    np.testing.assert_allclose(_np(got), _np(ref_flash_mha(jq, jk, jv, interpret=True)), atol=tol)
    np.testing.assert_allclose(_np(got), _np(ref_attention(jq, jk, jv)), atol=tol)
    # on a CPU tensor flash_mha is the plain path, and launches nothing
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    torch.testing.assert_close(fa.flash_mha(q, k, v), got, rtol=0, atol=0)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == before


def _grads(fn, q, k, v):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    fn(q, k, v).float().sum().backward()
    return q.grad, k.grad, v.grad


def _grad_tol(dtype, want):
    return 1e-4 if dtype == "float32" else 2**-6 * float(np.abs(_np(want)).max())


def test_plain_flash_gradients_match_splash():
    (jq, jk, jv), (q, k, v) = _qkv(1, 128, 2, 64)
    want = jax.grad(lambda a, b, c: ref_flash_mha(a, b, c, interpret=True).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(_grads(fa.flash_mha_plain, q, k, v), want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4)


def test_plain_flash_bfloat16_gradients_match_splash():
    """bfloat16 through both: the plain dK/dV rounds P and dS as splash's
    dK/dV kernel does, so dK and dV land within a unit of splash's."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 128, 2, 64, "bfloat16", seed=7)
    want = jax.grad(lambda a, b, c: ref_flash_mha(a, b, c, interpret=True).astype(jnp.float32).sum(),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(_grads(fa.flash_mha_plain, q, k, v), want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), _np(w), atol=_grad_tol("bfloat16", w))


@pytest.mark.parametrize("shape,seed", [((1, 128, 2, 64), 7), ((1, 256, 1, 128), 5)])
def test_plain_flash_bfloat16_dq_rounds_ds_as_splash(shape, seed):
    """splash's dQ kernel rounds dS to bfloat16 before its product with k
    (``ds.astype(k.dtype)``); the plain dQ does too, so its dQ lands within
    2**-9 of the largest value of splash's.  Kept in float32 there, dQ
    missed by 0.5-0.7 % of the largest value at these inputs."""
    (jq, jk, jv), (q, k, v) = _qkv(*shape, "bfloat16", seed=seed)
    want = jax.grad(lambda a: ref_flash_mha(a, jk, jv, interpret=True).astype(jnp.float32).sum())(jq)
    got = _grads(fa.flash_mha_plain, q, k, v)[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2**-9 * float(np.abs(_np(want)).max()))


_SPLASH_RUNS = {}


def _splash_or_reference(D):
    """Splash in interpret mode where the installed jax runs it at head
    width D (the probe of tests/test_flash_attention.py), else the
    reference attention."""
    if D not in _SPLASH_RUNS:
        z = jnp.zeros((1, 128, 1, D), jnp.float32)
        try:
            ref_flash_mha(z, z, z, interpret=True)
            _SPLASH_RUNS[D] = True
        except NotImplementedError:
            _SPLASH_RUNS[D] = False
    if _SPLASH_RUNS[D]:
        return lambda a, b, c: ref_flash_mha(a, b, c, interpret=True)
    return ref_attention


@pytest.mark.parametrize("D", [192, 256, 320, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_at_wide_heads(D, dtype):
    """Wide heads, which the kernels take (192 and 256 with kernels of their
    own, 320 and 512 through the column-split kernels): forward and
    gradients of the plain path against splash (or the reference)."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 128, 2, D, dtype, seed=D)
    ref = _splash_or_reference(D)
    got = fa.flash_mha_plain(q, k, v)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), _np(ref(jq, jk, jv)), atol=1e-5 if dtype == "float32" else 0.02)
    want = jax.grad(lambda a, b, c: ref(a, b, c).astype(jnp.float32).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(_grads(fa.flash_mha_plain, q, k, v), want):
        np.testing.assert_allclose(_np(g), _np(w), atol=_grad_tol(dtype, w))


def test_causal_tile_skip_at_256(monkeypatch):
    """T 256 is four 64-row tiles: the plain versions skip the six tiles
    above the diagonal and mask inside the four on it."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 256, 2, 64, seed=3)
    np.testing.assert_allclose(_np(fa.flash_mha_plain(q, k, v)), _np(ref_attention(jq, jk, jv)), atol=1e-5)
    want = jax.grad(lambda a, b, c: ref_attention(a, b, c).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(_grads(fa.flash_mha_plain, q, k, v), want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4)
    visited = []
    real = fa._probs

    def spy(qh, kh, lse, rows, cols, diagonal, above):
        visited.append((rows.start // fa.BLOCK, cols.start // fa.BLOCK))
        return real(qh, kh, lse, rows, cols, diagonal, above)

    monkeypatch.setattr(fa, "_probs", spy)
    _grads(fa.flash_mha_plain, q, k, v)
    assert sorted(set(visited)) == [(i, j) for i in range(4) for j in range(i + 1)]
    assert len(visited) == 2 * 10  # dQ and dK/dV each visit the ten kept tiles once


def test_kernel_plain_pieces_fit_together():
    """O and L from the forward, D from the dQ pass: L is the row
    log-sum-exp of the scaled, masked scores and D = rowsum(dO * O)."""
    _, (q, k, v) = _qkv(1, 128, 2, 64, seed=5)
    o, lse = fa.flash_fwd(q, k, v)
    s = torch.einsum("bthd,bshd->bhts", q, k).masked_fill(torch.ones(128, 128, dtype=torch.bool).triu(1),
                                                          float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5, atol=1e-5)
    do = torch.ones_like(o)
    _, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
    torch.testing.assert_close(delta, o.sum(-1).permute(0, 2, 1), rtol=1e-5, atol=1e-5)


def test_shape_gate_and_errors():
    assert fa.supports_shape(128, 64) and fa.supports_shape(2048, 128)
    assert not fa.supports_shape(100, 64) and not fa.supports_shape(128, 65)
    assert not fa.supports_shape(64, 64)
    q = torch.zeros(1, 100, 2, 64)
    with pytest.raises(ValueError, match="T % 128"):
        fa.flash_mha(q, q, q)
    assert not fa.eligible(128, 64, "cpu")
    # the reference's gate: any D % 64 on cuda; the wrappers refuse a head width the kernels lack
    assert fa.eligible(128, 256, "cuda") and fa.eligible(256, 64, "cuda")
    assert not fa.eligible(128, 64, "cuda", mesh=object()) and not fa.eligible(128, 96, "cuda")
    # the dp gate and flash per dp rank (tests/test_torch_dense_dp.py runs
    # them on a gloo mesh): no dp mesh, no flash; flash_mha_dp needs one
    assert not fa.eligible_dp(128, 64, 4, mesh=object()) and not fa.eligible_dp(128, 64, 4, mesh=None)
    with pytest.raises(ValueError, match="not in mesh axes"):
        fa.flash_mha_dp(q, q, q, mesh=None)


@pytest.mark.parametrize(
    "shape,dtype,match",
    [((1, 128, 2, 64), torch.float16, "float32 or bfloat16"), ((1, 128, 2, 96), torch.float32, "head_dim"),
     ((1, 96, 2, 64), torch.float32, "T % 64")],
)
def test_kernel_wrappers_reject_what_the_kernels_lack(shape, dtype, match):
    """The wrappers check on the CPU what the kernels take on the card."""
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa.flash_fwd(x, x, x)


def test_kernel_widths_and_the_error_past_them():
    """The kernels take every head width the reference's gate takes: 64 to
    256 with kernels of their own, any wider multiple of 64 through the
    column-split kernels.  A width off the gate raises, naming the gate."""
    for D in (64, 128, 192, 256, 320, 384, 512):
        assert fa.supports_shape(128, D)
        x = torch.zeros(1, 64, 1, D)
        fa.flash_fwd(x, x, x)  # the CPU takes the plain version; the check passes
    for D in (32, 96, 200):
        assert not fa.supports_shape(128, D)
        x = torch.zeros(1, 64, 1, D)
        with pytest.raises(ValueError, match="head_dim.*multiple of 64"):
            fa.flash_fwd(x, x, x)


def test_rows_aligned_copies_only_what_the_kernels_cannot_read():
    """The tensor-core kernels copy 16 B a thread: rows must be contiguous
    and start on 16-byte boundaries.  The LM's strided k/v views pass as
    they are; a view whose rows start off a boundary is copied."""
    qkv = torch.zeros(2, 128, 3, 2, 64, dtype=torch.bfloat16)
    k = qkv[:, :, 1]
    assert fa._rows_aligned(k) is k
    flat = torch.zeros(2 * 128 * 2 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 128, 2, 64)  # starts 2 B past the allocation
    got = fa._rows_aligned(shifted)
    assert got is not shifted and got.data_ptr() % 16 == 0 and got.is_contiguous()
    transposed = torch.zeros(2, 2, 128, 64, dtype=torch.bfloat16).transpose(1, 2)  # (B, T, H, D) view
    assert fa._rows_aligned(transposed) is transposed  # rows contiguous, strides multiples of 8
    cols = torch.zeros(2, 128, 64, 2, dtype=torch.bfloat16).transpose(2, 3)  # D not contiguous
    assert fa._rows_aligned(cols).stride(-1) == 1
