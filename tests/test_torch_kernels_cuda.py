"""The port's CUDA kernels against their plain torch versions, on the card.

These need an NVIDIA card and skip elsewhere.  This file imports nothing
of JAX, so it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX for the rest of the
suite.)  Tolerances: float32 1e-5 relative (the kernel splits a hot run
over warps and tiles, so its sums are added in another order than the
plain version's, though always the same order); bfloat16 one unit in the
last place of the table's values; int32 exact.  The flash kernels: float32 rtol 1e-5 with atol 1e-5 of the
largest value (float32 dot products in another order; the 3xTF32
products carry each float32 product to about 2**-21); bfloat16 outputs
one bfloat16 unit (rtol 2**-7) with atol 2**-8 of the largest value.
The serving engine on the card against the CPU: ids equal, scores rtol
1e-6 (both sum the products in float64 and round once to float32).  K1 at
the other workloads' row shapes: float32 rtol 1e-5 with atol 1e-5 of the
largest value; sketch-shaped pushes (whole-number counts) exact.  Replica
chains on the card: a caught-up follower, and a shard replayed from its
own log, bitwise.  A float32 switch-MoE LM step with flash on against off:
rtol 1e-4 / atol 1e-6 (the dense LM's bar).  ``transform_hybrid`` over a
``pallas`` store against an ``"xla"`` one: rtol 1e-5 / atol 1e-6.  The hot
cache on the card: ``CachedLookupService.top_k`` against the CPU's, ids
equal, scores rtol 1e-6; a leased row on a card slice exactly the row at
the answered ``seq``.  The two-tier store with its hot tier on the card:
bitwise the same store on the CPU over a seeded Zipf sequence with
evictions, a card-backed tiered shard bitwise a card-backed torch shard;
``drain_shard`` over card slices bitwise.  The nemesis runner on the card:
the ``mid_frame_rst_push`` schedule's verdict table (names, order, ``ok``),
fault classes and executed ops equal the CPU run's, every shard slice a
CUDA tensor.  The shared-memory transport on the card: a thread-shard
cluster over shm bitwise its binary-TCP run, every connection on shm.
The record sources on the card: MF fed by the native loader bitwise the
in-memory feed, with K1 launched once a batch.  A short open-loop soak on
the card: the goodput ledger balances and every verdict holds.
"""
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu_torch.ops import flash_attention as fa
from flink_parameter_server_tpu_torch.ops import mf_kernel, scatter_kernel

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _zipf_ids(rng, n, rows, a=1.2):
    return ((rng.zipf(a, n) - 1) % rows).astype(np.int64)


def _sorted_case(rng, n, rows, hot=0):
    ids = _zipf_ids(rng, n, rows)
    if hot:
        ids[:hot] = 1  # one run over many chunks
    return np.sort(ids).astype(np.int32)


@pytest.mark.parametrize(
    "dtype,n,rows,width,sub_k,hot",
    [
        (torch.float32, 1, 4, 8, 1, 0),
        (torch.float32, 33, 16, 1, 1, 0),
        (torch.float32, 1000, 64, 64, 1, 700),
        (torch.float32, 4096, 512, 200, 1, 0),
        (torch.float32, 5000, 40, 64, 2, 3000),
        (torch.float32, 700, 50, 17, 7, 0),
        (torch.bfloat16, 2000, 64, 64, 1, 900),
        (torch.int32, 3000, 32, 128, 1, 2500),
    ],
)
def test_scatter_kernel_matches_plain(cuda, dtype, n, rows, width, sub_k, hot):
    rng = np.random.default_rng(n)
    W = 128 if sub_k > 1 else width
    ids = torch.from_numpy(_sorted_case(rng, n, rows * sub_k, hot))
    if dtype == torch.int32:
        table = torch.from_numpy(rng.integers(0, 2**30, (rows, W)).astype(np.int32))
        deltas = torch.from_numpy(rng.integers(-5, 6, (n, width)).astype(np.int32))
    else:
        table = torch.from_numpy(rng.normal(0, 1, (rows, W)).astype(np.float32)).to(dtype)
        deltas = torch.from_numpy(rng.normal(0, 0.1, (n, width)).astype(np.float32)).to(dtype)
    want = scatter_kernel.sorted_scatter_add(table.clone(), ids, deltas, sub_k=sub_k)
    before = scatter_kernel.sorted_scatter_add.launches
    got = scatter_kernel.sorted_scatter_add(
        table.to(cuda), ids.to(cuda), deltas.to(cuda), sub_k=sub_k
    )
    torch.cuda.synchronize()
    assert scatter_kernel.sorted_scatter_add.launches == before + 1
    got = got.cpu()
    if dtype == torch.int32:
        assert torch.equal(got, want)
    elif dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-2)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "dtype,n,rows,dim,sub_k,hot",
    [
        (torch.float32, 1, 4, 8, 1, 0),
        (torch.float32, 1000, 64, 128, 1, 700),
        (torch.float32, 3000, 200, 64, 2, 2000),
        (torch.float32, 500, 30, 17, 7, 0),
        (torch.float32, 400, 30, 256, 1, 300),
        (torch.float32, 3000, 100, 256, 1, 2000),  # d 256: 32-lane tiles, a run over ~60 of them
        (torch.bfloat16, 2000, 64, 128, 1, 900),
    ],
)
def test_fused_mf_kernel_matches_plain(cuda, dtype, n, rows, dim, sub_k, hot):
    rng = np.random.default_rng(n + dim)
    W = 128 if sub_k > 1 else dim
    items = torch.from_numpy(_sorted_case(rng, n, rows * sub_k, hot))
    table = torch.from_numpy(rng.normal(0, 0.3, (rows, W)).astype(np.float32)).to(dtype)
    p = torch.from_numpy(rng.normal(0, 0.3, (n, dim)).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32))
    m = torch.from_numpy((rng.random(n) > 0.1).astype(np.float32))
    kw = dict(learning_rate=0.05, regularization=0.01, sub_k=sub_k)
    want_t = table.clone()
    want_u, want_p = mf_kernel.sorted_fused_mf_sgd(want_t, items, p, r, m, **kw)
    before = mf_kernel.sorted_fused_mf_sgd.launches
    got_t = table.to(cuda)
    got_u, got_p = mf_kernel.sorted_fused_mf_sgd(
        got_t, items.to(cuda), p.to(cuda), r.to(cuda), m.to(cuda), **kw
    )
    torch.cuda.synchronize()
    assert mf_kernel.sorted_fused_mf_sgd.launches == before + 1
    torch.testing.assert_close(got_p.cpu(), want_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_u.cpu(), want_u, rtol=1e-5, atol=1e-5)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got_t.cpu().float(), want_t.float(), rtol=2**-7, atol=1e-2)
    else:
        torch.testing.assert_close(got_t.cpu(), want_t, rtol=1e-5, atol=1e-5)


def _edge_ids(n, rows, tile):
    """Sorted ids whose first run ends exactly on the second tile's edge and
    whose second covers the third tile and one lane past it."""
    ids = np.empty(n, np.int64)
    ids[: 2 * tile] = 0
    ids[2 * tile: 3 * tile + 1] = 1
    ids[3 * tile + 1:] = 2 + np.arange(n - 3 * tile - 1) % (rows - 2)
    return torch.from_numpy(np.sort(ids).astype(np.int32))


def _mf_inputs(rng, n, rows, dim):
    table = torch.from_numpy(rng.normal(0, 0.3, (rows, dim)).astype(np.float32))
    p = torch.from_numpy(rng.normal(0, 0.3, (n, dim)).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32))
    m = torch.from_numpy((rng.random(n) > 0.1).astype(np.float32))
    return table, p, r, m


def test_kernels_take_runs_ending_on_a_tile_edge(cuda):
    """K1's tiles are 256 lanes; K2's are 64 at d 128."""
    rng = np.random.default_rng(11)
    ids = _edge_ids(1500, 300, 256)
    table = torch.from_numpy(rng.normal(0, 1, (300, 64)).astype(np.float32))
    deltas = torch.from_numpy(rng.normal(0, 0.1, (1500, 64)).astype(np.float32))
    want = scatter_kernel.run_sum_write_plain(table.clone(), ids, deltas)
    got = scatter_kernel.sorted_scatter_add(table.to(cuda), ids.to(cuda), deltas.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)

    items = _edge_ids(600, 200, 64)
    table, p, r, m = _mf_inputs(rng, 600, 200, 128)
    kw = dict(learning_rate=0.05, regularization=0.01)
    want_t = table.clone()
    want_u, want_p = mf_kernel.fused_mf_sgd_plain(want_t, items, p, r, m, **kw)
    got_t = table.to(cuda)
    got_u, got_p = mf_kernel.sorted_fused_mf_sgd(
        got_t, items.to(cuda), p.to(cuda), r.to(cuda), m.to(cuda), **kw
    )
    for got, want in ((got_p, want_p), (got_u, want_u), (got_t, want_t)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_scatter_kernel_takes_deltas_off_a_16_byte_boundary(cuda):
    """A contiguous deltas view 4 bytes past a boundary takes the scalar copy."""
    rng = np.random.default_rng(12)
    n, d, rows = 3000, 64, 100
    ids = torch.from_numpy(_sorted_case(rng, n, rows, hot=2000))
    flat = torch.from_numpy(rng.normal(0, 0.1, n * d + 1).astype(np.float32)).to(cuda)
    deltas = flat[1:].view(n, d)
    assert deltas.data_ptr() % 16 != 0
    table = torch.from_numpy(rng.normal(0, 1, (rows, d)).astype(np.float32))
    want = scatter_kernel.run_sum_write_plain(table.clone(), ids, deltas.cpu())
    got = scatter_kernel.sorted_scatter_add(table.to(cuda), ids.to(cuda), deltas)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_kernels_are_deterministic_at_the_main_path_shape(cuda):
    """No atomics: two runs on the same inputs give the same bits.  The main
    path's shape: 65,536 Zipf-1.2 lanes over 131,072 rows, K1 at d 64, K2 at
    d 128."""
    rng = np.random.default_rng(0)
    n, rows = 65_536, 131_072
    ids = torch.from_numpy(_sorted_case(rng, n, rows)).to(cuda)
    table = torch.randn(rows, 64, device=cuda)
    deltas = torch.randn(n, 64, device=cuda) * 0.01
    a = scatter_kernel.sorted_scatter_add(table.clone(), ids, deltas)
    b = scatter_kernel.sorted_scatter_add(table.clone(), ids, deltas)
    assert torch.equal(a, b)
    table = torch.randn(rows, 128, device=cuda) * 0.1
    p = torch.randn(n, 128, device=cuda) * 0.1
    r, m = torch.randn(n, device=cuda), (torch.rand(n, device=cuda) > 0.01).float()
    kw = dict(learning_rate=0.01, regularization=0.01)
    runs = []
    for _ in range(2):
        t = table.clone()
        runs.append((t,) + mf_kernel.sorted_fused_mf_sgd(t, ids, p, r, m, **kw))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_kernels_reject_what_they_do_not_take(cuda):
    table = torch.zeros(8, 4, dtype=torch.float64, device=cuda)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32, bfloat16 or int32"):
        scatter_kernel.sorted_scatter_add(table, ids, torch.ones(2, 4, dtype=torch.float64, device=cuda))
    wide = torch.zeros(8, 512, device=cuda)
    ones = torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        mf_kernel.sorted_fused_mf_sgd(
            wide, ids, torch.ones(2, 512, device=cuda), ones, ones,
            learning_rate=0.1, regularization=0.0,
        )


def test_store_push_on_card_goes_through_the_kernel(cuda):
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(_zipf_ids(rng, 512, 40))
    deltas = torch.from_numpy(rng.normal(0, 1, (512, 8)).astype(np.float32))
    cpu = ShardedParamStore.create(40, (8,), scatter_impl="pallas", device="cpu").push(ids, deltas)
    before = scatter_kernel.sorted_scatter_add.launches
    gpu = ShardedParamStore.create(40, (8,), scatter_impl="pallas", device=cuda).push(
        ids.to(cuda), deltas.to(cuda)
    )
    assert scatter_kernel.sorted_scatter_add.launches == before + 1
    torch.testing.assert_close(gpu.values().cpu(), cpu.values(), rtol=1e-5, atol=1e-5)


def _close(got, want, dtype):
    scale = float(want.float().abs().max())
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=2**-8 * scale)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize(
    "B,T,H,D,dtype",
    [(1, 64, 1, 64, torch.float32), (2, 192, 3, 64, torch.float32), (1, 256, 2, 128, torch.float32),
     (2, 128, 2, 64, torch.bfloat16), (1, 192, 2, 128, torch.bfloat16),
     (1, 192, 2, 192, torch.float32), (1, 256, 1, 256, torch.float32),  # 3xTF32 backward, 32-row tiles
     (1, 192, 2, 192, torch.bfloat16), (2, 256, 1, 256, torch.bfloat16),  # tensor cores, split warps
     (1, 1024, 2, 64, torch.bfloat16),  # sixteen tiles a side: the ring refilled many times
     (1, 128, 2, 320, torch.float32), (1, 192, 1, 320, torch.bfloat16),  # column-split kernels
     (1, 128, 1, 512, torch.float32), (2, 128, 1, 512, torch.bfloat16),
     (4, 512, 8, 64, torch.float32), (16, 512, 2, 64, torch.float32),  # a dp-4 and a tp-4 rank's share
     (1, 192, 3, 64, torch.float32),  # odd B * H, three tiles
     (1, 128, 1, 640, torch.float32), (1, 192, 1, 640, torch.bfloat16),  # two forward slices
     (1, 128, 1, 1344, torch.float32), (1, 128, 1, 2496, torch.bfloat16),  # q streamed beside k
     (1, 192, 1, 320, torch.float32),  # the split backward's ring refilled
     (1, 192, 1, 576, torch.float32), (1, 128, 1, 576, torch.bfloat16),  # dQ in 2 slices, dK/dV in 3
     (1, 128, 1, 704, torch.float32),  # float32 dQ streams q and dO
     (1, 128, 1, 1216, torch.bfloat16), (1, 128, 1, 1280, torch.bfloat16)],  # bf16 dQ held whole, then streamed
)
def test_flash_kernels_match_plain(cuda, B, T, H, D, dtype):
    g = torch.Generator(device=cuda).manual_seed(T + D)
    qkv = (torch.randn(B, T, 3, H, D, generator=g, device=cuda) * 0.8).to(dtype)
    q = (qkv[:, :, 0].float() * D**-0.5).to(dtype).contiguous()
    k, v = qkv[:, :, 1], qkv[:, :, 2]  # strided views, as the model passes them
    do = torch.randn(B, T, H, D, generator=g, device=cuda).to(dtype)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(
        c + 1 for c in counts)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v)
    dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o, do, lse)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    _close(o, o_p, dtype)
    for got, want in ((lse, lse_p), (delta, delta_p)):
        _close(got, want, torch.float32)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        _close(got, want, dtype)


def test_flash_float32_backward_is_bitwise_repeatable(cuda):
    """Two float32 backward calls on the same inputs: no atomics and one
    summation order, so dQ, D, dK and dV agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = ((torch.randn(4, 512, 8, 64, generator=g, device=cuda) * 0.8) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v)
    first = [*fa.flash_bwd_dq(q, k, v, o, do, lse)]
    first += fa.flash_bwd_dkv(q, k, v, do, lse, first[1])
    again = [*fa.flash_bwd_dq(q, k, v, o, do, lse)]
    again += fa.flash_bwd_dkv(q, k, v, do, lse, again[1])
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [320, 512, 704, 1280])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_split_backward_is_bitwise_repeatable(cuda, D, dtype):
    """The column-split backward twice on the same inputs: no atomics, and
    every slice builds its scores in one fixed order, so dQ, D, dK and dV
    agree bit for bit, with the own rows held whole and streamed (dQ
    streams q and dO at 704 in float32 and 1,280 in bfloat16; dK/dV streams
    k and v in float32 and from 640 in bfloat16)."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v, do = ((torch.randn(2, 512, 2, D, generator=g, device=cuda) * 0.5).to(dtype) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v)
    first = [*fa.flash_bwd_dq(q, k, v, o, do, lse)]
    first += fa.flash_bwd_dkv(q, k, v, do, lse, first[1])
    again = [*fa.flash_bwd_dq(q, k, v, o, do, lse)]
    again += fa.flash_bwd_dkv(q, k, v, do, lse, again[1])
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_kernels_take_rows_off_a_16_byte_boundary(cuda):
    """bf16 tensors whose rows start 2 B past a boundary: the wrappers copy
    them (cp.async moves 16 B a thread), and the results match."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n = 1 * 128 * 2 * 64
    flat = (torch.randn(3 * n + 1, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(1, 128, 2, 64) for i in range(3))
    o, lse = fa.flash_fwd(q, k, v)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v)
    _close(o, o_p, torch.bfloat16)
    _close(lse, lse_p, torch.float32)


def test_flash_mha_on_card_matches_plain_with_grads(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 256, 2, 64, generator=g, device=cuda) * 0.5 for _ in range(3))

    def run(fn):
        a, b, c = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(a, b, c)
        out.square().sum().backward()
        return [out.detach(), a.grad, b.grad, c.grad]

    for got, want in zip(run(fa.flash_mha), run(fa.flash_mha_plain)):
        _close(got, want, torch.float32)


def test_flash_kernels_reject_what_they_lack(cuda):
    half = torch.zeros(1, 128, 2, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_fwd(half, half, half)
    odd = torch.zeros(1, 128, 2, 96, device=cuda)  # off the reference's gate
    with pytest.raises(ValueError, match="head_dim.*multiple of 64"):
        fa.flash_fwd(odd, odd, odd)


def test_lm_at_a_head_width_off_the_gate_takes_no_kernel(cuda):
    """head_dim 96 fails the reference's gate: "auto" runs the reference
    attention and launches nothing, "on" raises."""
    import dataclasses

    from flink_parameter_server_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(vocab_size=64, d_model=192, n_heads=2, n_layers=1, d_ff=64,
                               max_seq=128, dtype=torch.float32, flash_attention="auto")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    tokens = torch.zeros(1, 128, dtype=torch.int64, device=cuda)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    assert torch.isfinite(tr.forward(model, tokens, cfg)).all()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == counts
    with pytest.raises(ValueError, match="ineligible"):
        tr.forward(model, tokens, dataclasses.replace(cfg, flash_attention="on"))


@pytest.mark.parametrize(
    "d_model,n_heads,mode,dtype",
    [(512, 2, "on", torch.float32), (512, 2, "on", torch.bfloat16),
     (640, 2, "auto", torch.float32), (640, 2, "auto", torch.bfloat16)],
)
def test_lm_at_wide_heads_goes_through_the_flash_kernels(cuda, d_model, n_heads, mode, dtype):
    """head_dim 256 (d_model 512, 2 heads: the 3xTF32 kernels for float32,
    the bf16 tensor-core kernels for bfloat16) and head_dim 320 under
    "auto" (d_model 640, 2 heads: the column-split kernels on the tensor
    cores in both dtypes) run the three kernels
    and match flash_attention="off" (the reference attention).  float32:
    rtol 1e-4 / atol 1e-6, as at head_dim 64.  bfloat16: the two paths
    round in other places (the kernels keep float32 inside, the reference
    rounds its einsums to bfloat16), so each gradient within 2**-4 of its
    largest magnitude, and the loss within 1e-2."""
    import dataclasses

    from flink_parameter_server_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(vocab_size=64, d_model=d_model, n_heads=n_heads, n_layers=1, d_ff=128,
                               max_seq=256, dtype=dtype, flash_attention=mode)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    tokens = torch.randint(0, 64, (2, 256), generator=torch.Generator().manual_seed(1)).to(cuda)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    loss = tr.lm_loss(model, {"tokens": tokens}, cfg)
    loss.backward()
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(
        c + 1 for c in counts)
    got = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    off_loss = tr.lm_loss(model, {"tokens": tokens}, dataclasses.replace(cfg, flash_attention="off"))
    off_loss.backward()
    if dtype == torch.float32:
        torch.testing.assert_close(loss, off_loss, rtol=1e-5, atol=0)
        for a, p in zip(got, model.parameters()):
            torch.testing.assert_close(a, p.grad, rtol=1e-4, atol=1e-6)
    else:
        torch.testing.assert_close(loss.float(), off_loss.float(), rtol=1e-2, atol=0)
        for a, p in zip(got, model.parameters()):
            scale = float(p.grad.float().abs().max())
            torch.testing.assert_close(a.float(), p.grad.float(), rtol=0, atol=2**-4 * scale)


def test_lm_on_card_goes_through_the_flash_kernels(cuda):
    from flink_parameter_server_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_layers=2, d_ff=128,
                               max_seq=128, dtype=torch.float32, flash_attention="on")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    tokens = torch.randint(0, 64, (2, 128), generator=torch.Generator().manual_seed(1)).to(cuda)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    tr.lm_loss(model, {"tokens": tokens}, cfg).backward()
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(
        c + 2 for c in counts)
    got = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    import dataclasses

    off = dataclasses.replace(cfg, flash_attention="off")
    tr.lm_loss(model, {"tokens": tokens}, off).backward()
    for a, p in zip(got, model.parameters()):
        torch.testing.assert_close(a, p.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "xla_sorted", "xla"])
def test_online_mf_twice_on_the_card_is_bitwise_equal(cuda, impl):
    """Two runs of ps_online_mf on the same Zipf stream (many duplicate
    users and items in a batch), deterministic mode off: every arm's item
    table and user state agree bit for bit (the row scatter-adds sum
    duplicates in a fixed order; crash recovery rests on it)."""
    from flink_parameter_server_tpu_torch import ps_online_mf

    assert not torch.are_deterministic_algorithms_enabled()
    rng = np.random.default_rng(3)
    stream = [{"user": rng.integers(0, 500, 4096).astype(np.int32),
               "item": _zipf_ids(rng, 4096, 2048).astype(np.int32),
               "rating": rng.normal(0, 1, 4096).astype(np.float32),
               "mask": np.ones(4096, bool)} for _ in range(4)]
    runs = [ps_online_mf(iter(stream), num_users=500, num_items=2048, dim=32, learning_rate=0.01,
                         scatter_impl=impl, device=cuda, collect_outputs=False) for _ in range(2)]
    assert torch.equal(runs[0].store.values(), runs[1].store.values())
    assert torch.equal(runs[0].worker_state, runs[1].worker_state)


def test_driver_recovers_bitwise_on_the_card(cuda, tmp_path):
    """Crash at step 7, restore step 4, replay the WAL tail: the card's
    tables equal the uninterrupted run's bit for bit."""
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.resilience import FaultPlan, RecoveringDriver, RestartPolicy
    from flink_parameter_server_tpu_torch.training.driver import DriverConfig, StreamingDriver
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    rng = np.random.default_rng(4)
    stream = [{"user": rng.integers(0, 300, 2048).astype(np.int32),
               "item": _zipf_ids(rng, 2048, 1024).astype(np.int32),
               "rating": rng.normal(0, 1, 2048).astype(np.float32),
               "mask": np.ones(2048, bool)} for _ in range(10)]

    def driver(**cfg):
        logic = OnlineMatrixFactorization(300, 16, updater=SGDUpdater(0.01), device=cuda)
        store = ShardedParamStore.create(1024, (16,), init_fn=ranged_random_factor(1, (16,)),
                                         scatter_impl="pallas", device=cuda)
        return StreamingDriver(logic, store, config=DriverConfig(dump_model=False, **cfg))

    oracle = driver().run(iter(stream))
    d = driver(checkpoint_every=4, checkpoint_dir=str(tmp_path / "ckpt"), wal_dir=str(tmp_path / "wal"))
    d.add_group_hook(FaultPlan().crash_at(7).driver_hook())
    rec = RecoveringDriver(d, lambda: iter(stream), policy=RestartPolicy(jitter=0.0, backoff_base_s=0.0))
    res = rec.run()
    assert rec.restarts == 1 and rec.events[0]["restored_step"] == 4 and rec.steps_replayed >= 1
    assert res.store.table.is_cuda
    assert torch.equal(oracle.store.values(), res.store.values())
    assert torch.equal(oracle.worker_state, res.worker_state)


def test_serving_engine_on_the_card_matches_the_cpu(cuda):
    """The same snapshot served on the card and on the CPU: equal top-K ids
    (with and without exclusions), scores within float32 rounding, even
    with TF32 switched on for the process (the engine must not take it)."""
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.serving import QueryEngine, SnapshotManager

    rng = np.random.default_rng(6)
    table = rng.normal(0, 1, (4096, 64)).astype(np.float32)
    uv = rng.normal(0, 1, (300, 64)).astype(np.float32)
    users = rng.integers(0, 300, 64).astype(np.int32)
    exclude = rng.integers(-1, 4096, (64, 50)).astype(np.int32)
    answers = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for dev in (cuda, torch.device("cpu")):
            store = ShardedParamStore.from_values(torch.from_numpy(table), device=dev)
            mgr = SnapshotManager(store.spec)
            mgr.publish(store.table, step=0, aux=torch.from_numpy(uv).to(dev))
            engine = QueryEngine(mgr)
            answers[dev.type] = [engine.top_k(users, 10), engine.top_k(users, 10, exclude=exclude)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for card, cpu in zip(answers["cuda"], answers["cpu"]):
        np.testing.assert_array_equal(card.item_ids, cpu.item_ids)
        np.testing.assert_allclose(card.scores, cpu.scores, rtol=1e-6)


def test_snapshot_stays_frozen_while_k1_updates_the_live_table(cuda):
    """A published snapshot is a copy: K1 and the row scatter-add then
    write into the live item table and user state in place, and the
    snapshot keeps the bits it was published with."""
    from flink_parameter_server_tpu_torch.core import store as store_mod
    from flink_parameter_server_tpu_torch.ops.rows import add_rows_
    from flink_parameter_server_tpu_torch.serving import SnapshotManager
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    store = store_mod.ShardedParamStore.create(4096, (64,), init_fn=ranged_random_factor(1, (64,)),
                                               scatter_impl="pallas", device=cuda)
    state = torch.randn(300, 64, device=cuda)
    mgr = SnapshotManager(store.spec)
    snap = mgr.publish(store.table, step=0, aux=state)
    table_then, state_then = store.table.clone(), state.clone()
    rng = np.random.default_rng(7)
    before = scatter_kernel.sorted_scatter_add.launches
    for _ in range(8):
        ids = torch.from_numpy(_zipf_ids(rng, 8192, 4096)).to(cuda)
        store_mod.push(store.spec, store.table, ids, torch.randn(8192, 64, device=cuda) * 0.01)
        add_rows_(state, torch.from_numpy(rng.integers(0, 300, 8192)).to(cuda),
                  torch.randn(8192, 64, device=cuda) * 0.01)
    torch.cuda.synchronize()
    assert scatter_kernel.sorted_scatter_add.launches == before + 8
    assert torch.equal(snap.table, table_then) and torch.equal(snap.aux, state_then)
    assert not torch.equal(snap.table, store.table) and not torch.equal(snap.aux, state)


# The other batched workloads' pushes (PA, the sketches, SGNS, FM): K1 at
# their row shapes.  Sketch-shaped pushes carry whole-number float32 deltas,
# so every order of summing them gives the same bits: exact.
K1_WORKLOAD_SHAPES = [
    # label, rows, width, sub_k, lanes, whole-number deltas
    ("PA binary dense d 1", 2_000_000, 1, 1, 262_144, False),
    ("PA binary packed sub_k 128 d 1", 15_625, 1, 128, 262_144, False),
    ("count-min packed sub_k 128 d 1", 256, 1, 128, 262_144, True),
    ("PA multiclass dense d 4", 2_000_000, 4, 1, 262_144, False),
    ("FM dense d 17 (unaligned rows)", 4_194_304, 17, 1, 131_072, False),
    ("FM packed sub_k 7 d 17", 599_187, 17, 7, 131_072, False),
    ("SGNS dense d 256", 1_000_000, 256, 1, 229_376, False),
]


def _k1_case(rng, rows, width, sub_k, n, whole):
    ids = np.sort(_zipf_ids(rng, n, rows * sub_k, a=1.3)).astype(np.int32)
    W = 128 if sub_k > 1 else width
    if whole:
        table = rng.integers(-50, 50, (rows, W)).astype(np.float32)
        deltas = rng.choice([-1.0, 1.0], (n, width)).astype(np.float32)
    else:
        table = rng.normal(0, 0.1, (rows, W)).astype(np.float32)
        deltas = rng.normal(0, 0.01, (n, width)).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(table), torch.from_numpy(deltas)


@pytest.mark.parametrize("label,rows,width,sub_k,n,whole", K1_WORKLOAD_SHAPES,
                         ids=[s[0] for s in K1_WORKLOAD_SHAPES])
def test_k1_at_the_workload_shapes(cuda, label, rows, width, sub_k, n, whole):
    """K1 against its plain version (on the CPU) at each workload's row
    shape, twice on the card with the same bits."""
    rng = np.random.default_rng(rows + width)
    ids, table, deltas = _k1_case(rng, rows, width, sub_k, n, whole)
    want = scatter_kernel.run_sum_write_plain(table.clone(), ids, deltas, sub_k=sub_k)
    d_ids, d_table, d_deltas = ids.to(cuda), table.to(cuda), deltas.to(cuda)
    a = scatter_kernel.sorted_scatter_add(d_table.clone(), d_ids, d_deltas, sub_k=sub_k)
    b = scatter_kernel.sorted_scatter_add(d_table.clone(), d_ids, d_deltas, sub_k=sub_k)
    torch.cuda.synchronize()
    assert torch.equal(a, b), label
    if whole:
        assert torch.equal(a.cpu(), want), label
    else:
        torch.testing.assert_close(a.cpu(), want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_k1_takes_the_tug_of_war_push(cuda):
    """The most duplicate-heavy push: every one of 65,536 tokens adds ±1
    to each of 256 estimators, so 16.8 M lanes fall into 256 runs of
    65,536 lanes, each crossing 256 tiles; exact, and the same bits twice."""
    rng = np.random.default_rng(3)
    tokens, est = 65_536, 256
    ids = torch.arange(est, dtype=torch.int32).repeat_interleave(tokens)
    deltas = torch.from_numpy(rng.choice([-1.0, 1.0], (tokens * est, 1)).astype(np.float32))
    table = torch.from_numpy(rng.integers(-1000, 1000, (est, 1)).astype(np.float32))
    want = table + deltas.view(est, tokens).sum(1, keepdim=True)
    d_ids, d_table, d_deltas = ids.to(cuda), table.to(cuda), deltas.to(cuda)
    a = scatter_kernel.sorted_scatter_add(d_table.clone(), d_ids, d_deltas)
    b = scatter_kernel.sorted_scatter_add(d_table.clone(), d_ids, d_deltas)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


def _one_step_both_arms(cuda, logic, make_store, batch):
    from flink_parameter_server_tpu_torch.core.transform import transform_batched

    tables, launches = {}, {}
    for impl in ("pallas", "xla"):
        before = scatter_kernel.sorted_scatter_add.launches
        res = transform_batched([batch], logic, make_store(impl), dump_model=False, collect_outputs=False)
        torch.cuda.synchronize()
        launches[impl] = scatter_kernel.sorted_scatter_add.launches - before
        tables[impl] = res.store.table.cpu()
    assert launches == {"pallas": 1, "xla": 0}
    return tables["pallas"], tables["xla"]


def test_pa_sketch_and_fm_steps_match_the_xla_arm(cuda):
    """One PA, one count-min and one FM step with scatter_impl="pallas"
    (one K1 launch each) against the same step with "xla" on the card:
    PA and FM at rtol 1e-5 with atol 1e-5 of the largest value, the
    sketch exact."""
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.models import factorization_machine as fm
    from flink_parameter_server_tpu_torch.models.passive_aggressive import PassiveAggressiveBinary
    from flink_parameter_server_tpu_torch.models.sketches import CountMinConfig, CountMinSketch
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    rng = np.random.default_rng(1)
    B, K, F = 8192, 32, 200_000
    sparse = {"ids": ((rng.zipf(1.3, (B, K)) - 1) % F).astype(np.int32),
              "values": rng.normal(0, 1, (B, K)).astype(np.float32), "feat_mask": np.ones((B, K), bool),
              "label": rng.choice([-1.0, 1.0], B).astype(np.float32), "mask": np.ones(B, bool)}
    got, want = _one_step_both_arms(cuda, PassiveAggressiveBinary(), lambda impl: ShardedParamStore.create(
        F, (), init_fn=ranged_random_factor(0, ()), scatter_impl=impl, layout="packed", device=cuda), sparse)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))

    sketch = CountMinSketch(CountMinConfig(width=8192, depth=4))
    keys = {"key": ((rng.zipf(1.3, 65_536) - 1) % 1_000_000).astype(np.int32), "mask": np.ones(65_536, bool)}
    got, want = _one_step_both_arms(cuda, sketch, lambda impl: sketch.make_store(scatter_impl=impl, device=cuda),
                                    keys)
    assert torch.equal(got, want)

    cfg = fm.FMConfig(num_features=F, dim=16, learning_rate=0.01)
    got, want = _one_step_both_arms(cuda, fm.FactorizationMachine(cfg), lambda impl: fm.make_store(
        cfg, scatter_impl=impl, device=cuda), sparse)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("backend", ["socket", "mesh"])
def test_cluster_on_card_matches_cpu(cuda, backend):
    """A 2-shard BSP run over TCP (each shard's slice on the card) and a
    mesh run (the one table on the card), 2 workers each, against the
    same run with device="cpu": rtol 1e-4 / atol 1e-6 (the reference's
    cluster bar; two workers' pushes land in either order).  Neither path
    launches a hand-written kernel."""
    from flink_parameter_server_tpu_torch.cluster import ClusterConfig, ClusterDriver
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization,
        SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    nu, ni, dim = 2000, 3000, 32
    batches = list(microbatches(synthetic_ratings(nu, ni, 8 * 1024, seed=3), 1024))
    tables = {}
    wrappers = (scatter_kernel.sorted_scatter_add, mf_kernel.sorted_fused_mf_sgd,
                fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [fn.launches for fn in wrappers]
    for dev in (cuda, torch.device("cpu")):
        logic = OnlineMatrixFactorization(nu, dim, updater=SGDUpdater(0.05), seed=1, device=dev)
        driver = ClusterDriver(logic, capacity=ni, value_shape=(dim,),
                               init_fn=ranged_random_factor(7, (dim,)),
                               config=ClusterConfig(num_shards=2, num_workers=2, store_backend=backend),
                               registry=False, device=dev)
        with driver:
            if backend == "mesh":
                assert driver.mesh_store.table.device.type == dev.type
            else:
                assert all(s.store.table.device.type == dev.type for s in driver.shards)
            tables[dev.type] = driver.run(batches).values
    assert [fn.launches for fn in wrappers] == before
    np.testing.assert_allclose(tables["cuda"], tables["cpu"], rtol=1e-4, atol=1e-6)


def test_dense_combine_on_the_card_is_bitwise_repeatable(cuda):
    """PA's on-device combine (``DenseCombineLogic``, ``accumulate_rows_``:
    a stable sort and one ordered sum per run) twice on the same batch:
    bit for bit equal, and within float32 rtol 1e-5 / atol 1e-6 of the CPU's
    combine (duplicate features summed in another order)."""
    from flink_parameter_server_tpu_torch.core.transform import to_device
    from flink_parameter_server_tpu_torch.workloads import WorkloadParams, create_workload

    p = WorkloadParams(rounds=2, batch=256, num_items=512, seed=0)
    outs = {}
    for dev in (cuda, cuda, torch.device("cpu")):
        pa = create_workload("pa", p, device=dev)
        logic = pa.make_logic()
        batch = to_device(pa.batches()[0], dev)
        pulled = torch.zeros(tuple(batch["ids"].shape), device=dev)
        _, req, _ = logic.step((), batch, pulled)
        outs.setdefault(dev.type, []).append((req.deltas.cpu(), req.mask.cpu()))
    (d1, m1), (d2, m2) = outs["cuda"]
    assert torch.equal(d1.view(torch.int32), d2.view(torch.int32)) and torch.equal(m1, m2)
    dc, mc = outs["cpu"][0]
    assert torch.equal(m1, mc)
    torch.testing.assert_close(d1, dc, rtol=1e-5, atol=1e-6)


def _card_shard(cuda, part, shard_id=0, **kw):
    from flink_parameter_server_tpu_torch.cluster import ParamShard
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    return ParamShard(shard_id, part, (8,), init_fn=ranged_random_factor(3, (8,)),
                      registry=False, device=cuda, **kw)


def test_snapshot_rows_and_load_round_trip_a_card_slice_bitwise(cuda, tmp_path):
    """``xfer``'s snapshot copies a CUDA slice off the card under the lock
    that reads its sequence number; ``load`` writes rows into another
    shard's CUDA slice: both bitwise, and a pull after the load serves the
    loaded rows (the host mirror was dropped)."""
    from flink_parameter_server_tpu_torch.cluster import ConsistentHashPartitioner

    old = ConsistentHashPartitioner(4096, 1, seed=2)
    new = old.grown(2)
    src = _card_shard(cuda, old, wal_dir=str(tmp_path / "src"))
    dst = _card_shard(cuda, new, 1, wal_dir=str(tmp_path / "dst"))
    rng = np.random.default_rng(0)
    ids = np.unique(rng.integers(0, 4096, 1500))
    src.push(ids, rng.normal(size=(len(ids), 8)).astype(np.float32))
    moving = np.arange(4096)[new.shard_of(np.arange(4096)) == 1]
    rows, seq = src.snapshot_rows(moving)
    assert seq == src._push_seq == 1
    assert np.array_equal(rows, src.store.table[src.partitioner.to_local(0, moving)].cpu().numpy())
    dst.pull(moving[:4])  # builds a host mirror the load must drop
    dst.assign_rows(moving, rows)
    assert dst.store.table.device.type == "cuda"
    assert np.array_equal(dst.pull(moving), rows)
    assert np.array_equal(dst.store.table[: len(moving)].cpu().numpy(), rows)
    src.close()
    dst.close()


def test_install_epoch_rebuilds_the_slice_on_the_card(cuda, tmp_path):
    """The flip compacts a CUDA slice to the new owned set and rebuilds it
    as a new tensor on the card; a pull after it serves the post-flip rows
    (no stale mirror), and a shard rebuilt over the WAL's snapshot record
    holds the same slice on the card, bitwise."""
    from flink_parameter_server_tpu_torch.cluster import ConsistentHashPartitioner

    part = ConsistentHashPartitioner(4096, 2, seed=4)
    sh = _card_shard(cuda, part, wal_dir=str(tmp_path / "wal"))
    owned = sh.owned.copy()
    sh.push(owned[:100], np.ones((100, 8), np.float32), pid="a.0")
    before = sh.pull(owned)  # the mirror now holds the pre-flip slice
    grown = part.grown(3)
    keep = grown.owned_ids(0)
    sh.install_epoch(1, grown)
    assert sh.store.table.device.type == "cuda"
    assert len(sh.owned) == len(keep) < len(owned)
    pos = np.searchsorted(owned, keep)
    assert np.array_equal(sh.pull(keep), before[pos])
    assert np.array_equal(sh.values(), before[pos])
    sh.close()
    reborn = _card_shard(cuda, grown, wal_dir=str(tmp_path / "wal"))
    assert reborn.store.table.device.type == "cuda"
    assert np.array_equal(reborn.values(), before[pos])
    reborn.close()


def _chain_on_card(cuda, tmp_path, part, dim):
    """A primary and its follower, each slice on the card, joined by a
    shipper over TCP."""
    from flink_parameter_server_tpu_torch.cluster import ParamShard, ShardServer
    from flink_parameter_server_tpu_torch.replication import ReplHub, ReplicaShard, WALShipper
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    init = ranged_random_factor(5, (dim,))
    primary = ParamShard(0, part, (dim,), init_fn=init, wal_dir=str(tmp_path / "p"), registry=False,
                         device=cuda)
    follower = ReplicaShard(0, part, (dim,), init_fn=init, wal_dir=str(tmp_path / "f"), registry=False,
                            device=cuda)
    fsrv = ShardServer(follower, supervised=False).start()
    hub = ReplHub()
    ship = WALShipper(primary, (fsrv.host, fsrv.port), hub.subscribe(), registry=False).start()
    primary.attach_repl_sink(hub)
    return primary, follower, fsrv, ship


def _wait_applied(follower, head, timeout=60.0):
    import time

    deadline = time.monotonic() + timeout
    while follower.repl_state()["applied"] < head and time.monotonic() < deadline:
        time.sleep(0.005)
    assert follower.repl_state()["applied"] == head


def test_caught_up_follower_is_bitwise_its_primary_on_the_card(cuda, tmp_path):
    """Zipf pushes with duplicate-free ids a frame and a migration load
    ship to a follower whose slice is on the card: once caught up it is
    bitwise its primary (each record goes through the same ``_apply``, one
    record a call, in log order), and a promoted follower keeps it."""
    from flink_parameter_server_tpu_torch.cluster import ConsistentHashPartitioner

    part = ConsistentHashPartitioner(8192, 1, seed=1)
    primary, follower, fsrv, ship = _chain_on_card(cuda, tmp_path, part, 64)
    rng = np.random.default_rng(0)
    try:
        for _ in range(12):
            ids = np.unique(_zipf_ids(rng, 4096, 8192))
            primary.push(ids, rng.normal(0, 0.01, (len(ids), 64)).astype(np.float32))
        primary.assign_rows(np.arange(8), np.ones((8, 64), np.float32))
        _wait_applied(follower, primary.head_seq())
        assert follower.store.table.device.type == "cuda"
        assert primary.values().tobytes() == follower.values().tobytes()
        assert follower.pull(np.arange(16)).tobytes() == primary.pull(np.arange(16)).tobytes()
        ship.stop()
        follower.catch_up()
        follower.promote_to_primary(1)
        assert follower.role == "primary"
        assert primary.values().tobytes() == follower.values().tobytes()
    finally:
        ship.stop()
        fsrv.stop()
        primary.close()
        follower.close()


def test_verify_against_log_holds_on_a_card_shard(cuda, tmp_path):
    """The promotion audit rebuilds its scratch slice on the shard's own
    device: a card shard replayed on the card is bitwise its live slice,
    across an epoch snapshot barrier, and a corrupted row fails it."""
    from flink_parameter_server_tpu_torch.cluster import ConsistentHashPartitioner
    from flink_parameter_server_tpu_torch.replication.failover import verify_against_log

    part = ConsistentHashPartitioner(4096, 2, seed=3)
    sh = _card_shard(cuda, part, wal_dir=str(tmp_path / "wal"))
    rng = np.random.default_rng(1)
    for _ in range(6):
        ids = np.unique(rng.choice(sh.owned, 300))
        sh.push(ids, rng.normal(size=(len(ids), 8)).astype(np.float32))
    assert verify_against_log(sh)
    grown = part.grown(3)
    sh.install_epoch(1, grown)
    for _ in range(3):
        ids = np.unique(rng.choice(sh.owned, 200))
        sh.push(ids, rng.normal(size=(len(ids), 8)).astype(np.float32))
    assert sh.store.table.device.type == "cuda"
    assert verify_against_log(sh)
    sh.store.table[0, 0] += 1.0
    sh._host_mirror = None
    assert not verify_against_log(sh)
    sh.close()


def test_moe_lm_step_with_flash_on_matches_flash_off(cuda):
    """One step of a switch-MoE LM (float32, 8 experts, capacity 80 of 256
    tokens: some dropped) launches each flash kernel once a layer and gives
    the loss and gradients of the reference attention (rtol 1e-4 / atol
    1e-6, the dense LM's card bar; float32 routing agrees exactly)."""
    import dataclasses

    from flink_parameter_server_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_layers=2, d_ff=128, max_seq=128,
                               dtype=torch.float32, flash_attention="on", num_experts=8, moe_capacity=80)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    assert all(hasattr(layer, "moe") for layer in model.layers)
    tokens = torch.randint(0, 64, (2, 128), generator=torch.Generator().manual_seed(1)).to(cuda)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    loss = tr.lm_loss(model, {"tokens": tokens}, cfg)
    loss.backward()
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(
        c + 2 for c in counts)
    got = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    off = tr.lm_loss(model, {"tokens": tokens}, dataclasses.replace(cfg, flash_attention="off"))
    off.backward()
    torch.testing.assert_close(loss, off, rtol=1e-4, atol=1e-6)
    for a, p in zip(got, model.parameters()):
        torch.testing.assert_close(a, p.grad, rtol=1e-4, atol=1e-6)


def test_transform_hybrid_launches_k1_once_a_chunk(cuda):
    """The event MF logic under ``transform_hybrid`` against a
    ``scatter_impl="pallas"`` store on the card: one K1 launch a chunk, and
    the table equals the same run against an ``"xla"`` store within rtol
    1e-5 (K1 sums each run in another order than ``accumulate_rows_``)."""
    from flink_parameter_server_tpu_torch import MFWorkerLogic, SGDUpdater, transform_hybrid
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    rng = np.random.default_rng(2)
    records = [(int(u), int(i), float(r)) for u, i, r in
               zip(rng.integers(0, 50, 600), _zipf_ids(rng, 600, 256), rng.normal(size=600))]
    tables = {}
    for impl in ("pallas", "xla"):
        store = ShardedParamStore.create(256, (16,), init_fn=ranged_random_factor(1, (16,)), scatter_impl=impl,
                                         device=cuda)
        before = scatter_kernel.sorted_scatter_add.launches
        res = transform_hybrid(records, MFWorkerLogic(16, SGDUpdater(0.05), seed=0, device=cuda), store,
                               chunk_size=200)
        torch.cuda.synchronize()
        assert scatter_kernel.sorted_scatter_add.launches - before == (3 if impl == "pallas" else 0)
        tables[impl] = res.store.values()
        assert tables[impl].device.type == "cuda"
    torch.testing.assert_close(tables["pallas"], tables["xla"], rtol=1e-5, atol=1e-6)


def test_hot_key_top_k_ranks_on_the_card(cuda, monkeypatch):
    """A 2-shard cluster on the card with ``hot_keys=True``: the default
    aggregator (``device=None``, the card) ranks the merged candidates with
    ``dense_topk`` on CUDA tensors, and its answer equals a stable host sort
    of every candidate by its reported count (``candidates()`` lists them in
    the space-saving order) and a CPU aggregator's over the same sketches,
    exactly."""
    from flink_parameter_server_tpu_torch.cluster import ClusterConfig, ClusterDriver
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization,
        SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.telemetry import hotkeys
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    ranked_on = []
    dense_topk = hotkeys.dense_topk

    def spy(table, queries, k, **kw):
        ranked_on.append(table.device.type)
        return dense_topk(table, queries, k, **kw)

    monkeypatch.setattr(hotkeys, "dense_topk", spy)
    agg = hotkeys.HotKeyAggregator()
    old = hotkeys.get_aggregator()
    hotkeys.set_aggregator(agg)
    try:
        nu, ni, dim = 2000, 3000, 32
        batches = list(microbatches(synthetic_ratings(nu, ni, 8 * 1024, seed=3), 1024))
        driver = ClusterDriver(OnlineMatrixFactorization(nu, dim, updater=SGDUpdater(0.05), seed=1, device=cuda),
                               capacity=ni, value_shape=(dim,), init_fn=ranged_random_factor(7, (dim,)),
                               config=ClusterConfig(num_shards=2, num_workers=2, hot_keys=True, hot_key_k=32),
                               registry=False, device=cuda)
        with driver:
            assert all(s.store.table.device.type == "cuda" for s in driver.shards)
            driver.run(batches)
            assert agg.labels() == ["shard-0", "shard-1"]
            top = agg.top_k(10)
            assert ranked_on == ["cuda"]
            every = agg.candidates(1 << 20)
            assert len(top) == 10 and top == sorted(every, key=lambda t: -t["count"])[:10]
            cpu = hotkeys.HotKeyAggregator(device="cpu")
            for label in agg.labels():
                cpu.register(label, agg._sketches[label])
            assert cpu.top_k(10) == top
        assert agg.labels() == []
    finally:
        hotkeys.set_aggregator(old)


def test_cached_top_k_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """``CachedLookupService.top_k`` scores each shard's candidate rows and
    merges the partial top-Ks with ``dense_topk`` on CUDA tensors; its
    answer equals the same service's on the CPU: ids equal, scores rtol
    1e-6 (both sum in float64 and round once to float32)."""
    from flink_parameter_server_tpu_torch.cluster import ParamShard, RangePartitioner, ShardServer
    from flink_parameter_server_tpu_torch.hotcache import CachedLookupService, StaticHotSet
    from flink_parameter_server_tpu_torch.hotcache import serving

    ranked_on = []
    dense_topk = serving.dense_topk

    def spy(table, queries, k, **kw):
        ranked_on.append(table.device.type)
        return dense_topk(table, queries, k, **kw)

    monkeypatch.setattr(serving, "dense_topk", spy)
    part = RangePartitioner(4096, 2)
    shards = [ParamShard(s, part, (64,), registry=False, device=cuda) for s in range(2)]
    servers = [ShardServer(sh, port=0).start() for sh in shards]
    addrs = [(sv.host, sv.port) for sv in servers]
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(4096, 64)).astype(np.float32)
    for sh in shards:
        sh.push(sh.owned, rows[sh.owned])
    svcs = {dev: CachedLookupService(addresses=addrs, partitioner=part, value_shape=(64,),
                                     policy=StaticHotSet(np.arange(64)), hedge_after_s=None,
                                     registry=False, device=dev) for dev in ("cuda", "cpu")}
    try:
        for k in (1, 10, 100):
            q = rng.normal(size=64).astype(np.float32)
            cand = rng.choice(4096, 3000, replace=False)
            del ranked_on[:]
            got = svcs["cuda"].top_k(q, cand, k=k)
            assert set(ranked_on) == {"cuda"} and len(ranked_on) == 3  # two shards + the merge
            want = svcs["cpu"].top_k(q, cand, k=k)
            assert np.array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
            oracle = np.argsort(-(rows[np.sort(cand)].astype(np.float64) @ q), kind="stable")[:k]
            assert np.array_equal(got[1], np.sort(cand)[oracle])
    finally:
        for svc in svcs.values():
            svc.close()
        for sv in servers:
            sv.stop()
        for sh in shards:
            sh.close()


def test_leased_rows_on_a_card_shard_are_the_rows_at_the_answered_seq(cuda):
    """``lease_rows`` on a CUDA slice copies the rows off the card under the
    lock that reads ``seq``: with a writer adding 1.0 to every leased id
    per push, each lease's rows equal the initial rows plus its answered
    ``seq``, exactly, and the board holds the grant.  The writer's last
    push waits for the reader's first lease, and the reader takes one
    lease after the writer is done, so at least two different ``seq``
    are leased however the threads are scheduled."""
    import threading

    from flink_parameter_server_tpu_torch.cluster import ParamShard, RangePartitioner

    part = RangePartitioner(2048, 1)
    shard = ParamShard(0, part, (16,), registry=False, device=cuda)
    ids = np.arange(0, 2048, 7, dtype=np.int64)
    ones = np.ones((len(ids), 16), np.float32)
    first_lease, done, errs = threading.Event(), threading.Event(), []

    def writer():
        try:
            for _ in range(300):
                shard.push(ids, ones, sess="writer")
            # one push lands after the reader's first lease, whatever the schedule
            assert first_lease.wait(60), "the reader never took a lease"
            shard.push(ids, ones, sess="writer")
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)
        finally:
            done.set()

    th = threading.Thread(target=writer)
    th.start()
    seen = set()
    while True:
        last = done.is_set()  # a lease taken after the writer is done sees its final seq
        rows, seq, ttl = shard.lease_rows(ids, "reader", ttl=8)
        assert ttl == 8
        np.testing.assert_array_equal(rows, np.full((len(ids), 16), float(seq), np.float32))
        seen.add(seq)
        first_lease.set()
        if last:
            break
    th.join()
    assert not errs, errs
    assert len(seen) > 1  # leases landed between pushes, not only at the ends
    assert shard.leases.holds("reader", int(ids[0]))
    assert shard.store.table.device.type == "cuda"
    shard.close()


def _zipf_rank(rng, n, batch):
    u = rng.random(batch)
    return np.minimum(np.exp(u * np.log(n)).astype(np.int64), n - 1)


def test_tiered_store_on_the_card_matches_the_cpu(cuda):
    """The hot tier on the card (``index_select`` reads, one copy each way a
    batch, pushes through ``accumulate_rows_``) against the same store on the
    CPU over a seeded Zipf sequence whose batches outgrow the hot tier
    (evictions and spills every round): every gather, ``values()`` and the
    counters bitwise / equal."""
    from flink_parameter_server_tpu_torch.tierstore import TieredStore

    rows, dim, hot = 1 << 14, 16, 512
    init = lambda ids: (np.cos(np.asarray(ids)[:, None] * 0.01 + np.arange(dim)) * 0.1
                        ).astype(np.float32)
    stores = {d: TieredStore(rows, (dim,), row_init=init, hot_rows=hot, device=d)
              for d in ("cuda", "cpu")}
    assert stores["cuda"]._hot.device.type == "cuda"
    rng = np.random.default_rng(0)
    try:
        for i in range(40):
            ids = _zipf_rank(rng, rows, 1024)
            got = stores["cuda"].gather(ids)
            assert got.tobytes() == stores["cpu"].gather(ids).tobytes(), i
            d = rng.normal(size=(1024, dim)).astype(np.float32)
            for st in stores.values():
                st.push(ids, d)  # duplicates included: summed in index order
        assert stores["cuda"].values().tobytes() == stores["cpu"].values().tobytes()
        a, b = stores["cuda"].stats(), stores["cpu"].stats()
        drop = ("last_evict_scan_s", "cum_evict_scan_s")
        assert {k: v for k, v in a.items() if k not in drop} == \
            {k: v for k, v in b.items() if k not in drop}
        assert a["evict_scans"] > 0 and a["spills"] > 0
    finally:
        for st in stores.values():
            st.close()


def test_tiered_shard_on_the_card_matches_a_torch_shard(cuda, tmp_path):
    """A card-backed tiered shard (hot tier a quarter of the slice, init
    recomputed on the card per cold miss) against a card-backed torch shard
    on the same client-deduplicated pushes: every pull and the final slice
    bitwise; then a crash and WAL replay through the cold rows, bitwise."""
    from flink_parameter_server_tpu_torch.cluster import ParamShard, RangePartitioner
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    part = RangePartitioner(8192, 1)
    init = ranged_random_factor(11, (32,))
    tiered = ParamShard(0, part, (32,), init_fn=init, registry=False, device=cuda,
                        store_backend="tiered", tier_hot_rows=2048,
                        wal_dir=str(tmp_path / "wal"))
    dense = ParamShard(0, part, (32,), init_fn=init, registry=False, device=cuda)
    rng = np.random.default_rng(1)
    try:
        assert tiered.store._hot.device.type == cuda.type
        for i in range(30):
            ids = np.unique(_zipf_rank(rng, 8192, 2048))
            assert tiered.pull(ids).tobytes() == dense.pull(ids).tobytes(), i
            d = rng.normal(size=(ids.size, 32)).astype(np.float32)
            tiered.push(ids, d)
            dense.push(ids, d)
        want = dense.values()
        assert tiered.values().tobytes() == want.tobytes()
        assert tiered._host_mirror is None
        tiered.crash()
        assert tiered.restart() == 30
        assert tiered.values().tobytes() == want.tobytes()
    finally:
        tiered.close()
        dense.close()


def test_drain_shard_on_card_slices_is_bitwise(cuda, tmp_path):
    """``drain_shard(0)`` at weight 0 on an elastic driver whose slices are
    on the card: every row bitwise what it was before, shard 0 owns no key,
    the migration verified with no mismatch."""
    from flink_parameter_server_tpu_torch.elastic import (
        ElasticClusterConfig,
        ElasticClusterDriver,
    )
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization,
        SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    logic = OnlineMatrixFactorization(64, 16, updater=SGDUpdater(0.05), seed=1, device=cuda)
    d = ElasticClusterDriver(logic, capacity=4096, value_shape=(16,),
                             init_fn=ranged_random_factor(7, (16,)), registry=False,
                             config=ElasticClusterConfig(num_shards=3, wal_dir=str(tmp_path)),
                             device=cuda)
    with d:
        rng = np.random.default_rng(2)
        for sh in d.shards:
            ids = sh.owned[rng.random(len(sh.owned)) < 0.5]
            sh.push(ids, rng.normal(size=(len(ids), 16)).astype(np.float32))
        before = {int(g): r for sh in d.shards for g, r in zip(sh.owned, sh.values())}
        report = d.drain_shard(0)
        assert report.verified and report.mismatches == 0 and report.rows_moved > 0
        assert len(d.shards[0].owned) == 0 and d.partitioner.owned_ids(0).size == 0
        assert all(sh.store.table.device.type == cuda.type for sh in d.shards)
        after = {int(g): r for sh in d.shards for g, r in zip(sh.owned, sh.values())}
        assert sorted(after) == sorted(before)
        assert all(after[g].tobytes() == before[g].tobytes() for g in before)


def test_nemesis_scenario_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """``run_scenario`` on the card (the default device) against
    ``device="cpu"``: the same verdicts, fault classes and executed ops,
    and the card run's shard slices are CUDA tensors."""
    from flink_parameter_server_tpu_torch.nemesis import runner

    s = {x.name: x for x in runner.load_corpus()}["mid_frame_rst_push"]
    slices = []
    build = runner.NemesisElasticDriver._build_shard

    def spy(self, shard_id, partitioner=None):
        shard, server = build(self, shard_id, partitioner)
        slices.append(shard.store.table.device.type)
        return shard, server

    monkeypatch.setattr(runner.NemesisElasticDriver, "_build_shard", spy)
    card = runner.run_scenario(s, wal_root=str(tmp_path))
    card_slices, slices[:] = list(slices), []
    cpu = runner.run_scenario(s, wal_root=str(tmp_path), device="cpu")
    assert card.ok, [v.as_dict() for v in card.verdicts if not v.ok]
    assert [(v.name, v.ok) for v in card.verdicts] == [(v.name, v.ok) for v in cpu.verdicts]
    assert set(card.faults) == set(cpu.faults) and card.ops_executed == cpu.ops_executed == 2
    assert card_slices and set(card_slices) == {"cuda"}
    assert slices and set(slices) == {"cpu"}


def test_shm_cluster_on_card_is_bitwise_its_tcp_run(cuda):
    """A 2-shard BSP run with 2 workers and ``push_aggregate`` (one merged
    push a round, so two runs are comparable bit for bit), each slice on
    the card, over ``wire_proto="shm"`` against ``"auto"``: the tables
    bitwise, every connection of the shm run (the combiner's too) on
    shared memory, none of the TCP run's, and no kernel launched."""
    from flink_parameter_server_tpu_torch.cluster import ClusterConfig, ClusterDriver
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization,
        SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    class KeepConns(ClusterDriver):
        def _make_client(self, worker=None):
            c = super()._make_client(worker)
            dial = c._dial

            def keep(addr):
                conn = dial(addr)
                self.dialed.append(conn)
                return conn

            c._dial = keep
            return c

    nu, ni, dim = 2000, 3000, 32
    batches = list(microbatches(synthetic_ratings(nu, ni, 8 * 1024, seed=3), 1024))
    wrappers = (scatter_kernel.sorted_scatter_add, mf_kernel.sorted_fused_mf_sgd,
                fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [fn.launches for fn in wrappers]
    tables, wires = {}, {}
    for proto in ("auto", "shm"):
        logic = OnlineMatrixFactorization(nu, dim, updater=SGDUpdater(0.05), seed=1, device=cuda)
        driver = KeepConns(logic, capacity=ni, value_shape=(dim,), init_fn=ranged_random_factor(7, (dim,)),
                           config=ClusterConfig(num_shards=2, num_workers=2, push_aggregate=True,
                                                wire_proto=proto),
                           registry=False, device=cuda)
        driver.dialed = []
        with driver:
            assert all(s.store.table.device.type == "cuda" for s in driver.shards)
            tables[proto] = driver.run(batches).values
        wires[proto] = [getattr(c, "wire", "tcp") for c in driver.dialed]
    assert [fn.launches for fn in wrappers] == before
    assert len(wires["shm"]) == 6 and set(wires["shm"]) == {"shm"}, wires
    assert set(wires["auto"]) == {"tcp"}, wires
    assert tables["shm"].tobytes() == tables["auto"].tobytes()


def test_native_fed_mf_on_the_card_is_bitwise_the_in_memory_feed(cuda, tmp_path):
    """``ps_online_mf(scatter_impl="pallas")`` fed by the native loader's
    ``stream_batches`` over a MovieLens file against the same call over the
    in-memory microbatches: the item table and user state bitwise, K1 once
    a batch in each run."""
    from flink_parameter_server_tpu_torch import ps_online_mf
    from flink_parameter_server_tpu_torch.data import native_loader
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches

    native_loader.get_lib()  # no fallback on the card's machine
    data = synthetic_ratings(500, 1024, 4096, seed=5)
    path = tmp_path / "u.data"
    path.write_text("".join(
        f"{u}\t{i}\t{np.format_float_positional(r, unique=True)}\t0\n"
        for u, i, r in zip(data["user"].tolist(), data["item"].tolist(), data["rating"])))
    mf = dict(num_users=500, num_items=1024, dim=16, learning_rate=0.01, scatter_impl="pallas", device=cuda)
    runs = {}
    for feed in ("native", "memory"):
        batches = (native_loader.stream_batches(str(path), 1024) if feed == "native"
                   else microbatches(data, 1024))
        before = scatter_kernel.sorted_scatter_add.launches
        runs[feed] = ps_online_mf(batches, **mf)
        torch.cuda.synchronize()
        assert scatter_kernel.sorted_scatter_add.launches - before == 4
    assert runs["native"].store.values().device.type == "cuda"
    assert torch.equal(runs["native"].store.values(), runs["memory"].store.values())
    assert torch.equal(runs["native"].worker_state, runs["memory"].worker_state)


def test_short_soak_on_the_card_balances_its_ledger(cuda):
    """A 3 s open-loop soak with the shards' slices on the card (the
    default device) and a two-way partition beneath it: every arrival
    classified once, every verdict ok, the partition injected, and no
    kernel launched."""
    from flink_parameter_server_tpu_torch.loadgen.soak import SoakConfig, run_soak
    from flink_parameter_server_tpu_torch.nemesis import runner
    from flink_parameter_server_tpu_torch.nemesis.scenarios import NemesisOp

    slices = []
    build = runner._NemesisMeshMixin._build_shard

    def spy(self, shard_id, partitioner=None):
        shard, server = build(self, shard_id, partitioner)
        slices.append(shard.store.table.device.type)
        return shard, server

    wrappers = (scatter_kernel.sorted_scatter_add, mf_kernel.sorted_fused_mf_sgd,
                fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [fn.launches for fn in wrappers]
    runner._NemesisMeshMixin._build_shard = spy
    try:
        rep = run_soak(SoakConfig(
            duration_s=3.0, offered_rps=80.0, generators=2, train_workers=1, num_users=64, num_items=256,
            dim=4, num_shards=2, link_delay_ms=0.2, slo_ms=200.0, warmup_requests=16, seed=11,
            nemesis=((0.8, NemesisOp(0, "partition", shard=0, mode="both", ms=250.0)),),
        ))
    finally:
        runner._NemesisMeshMixin._build_shard = build
    s = rep.summary
    assert s["arrivals"] == s["ok"] + s["late"] + s["shed"] + s["error"]
    assert s["latency_anchor"] == "arrival"
    assert rep.ok, [v.as_dict() for v in rep.verdicts if not v.ok]
    assert rep.faults.get("partition_both", 0) >= 1
    assert slices and set(slices) == {"cuda"}
    assert [fn.launches for fn in wrappers] == before
