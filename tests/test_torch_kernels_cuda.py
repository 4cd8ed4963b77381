"""The port's CUDA kernels against their plain torch versions, on the card.

These need an NVIDIA card and skip elsewhere.  This file imports nothing
of JAX, so it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX for the rest of the
suite.)  Tolerances: float32 1e-5 relative (the kernel splits a hot run
over warps and tiles, so its sums are added in another order than the
plain version's, though always the same order); bfloat16 one unit in the
last place of the table's values; int32 exact.  The flash kernels: float32 rtol 1e-5 with atol 1e-5 of the
largest value (float32 dot products in another order); bfloat16 outputs
one bfloat16 unit (rtol 2**-7) with atol 2**-8 of the largest value.
The serving engine on the card against the CPU: ids equal, scores rtol
1e-6 (both sum the products in float64 and round once to float32).
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
     (1, 192, 2, 192, torch.float32), (1, 256, 1, 256, torch.float32),  # SIMT, 64- and 32-row tiles
     (1, 192, 2, 192, torch.bfloat16), (2, 256, 1, 256, torch.bfloat16),  # tensor cores, split warps
     (1, 1024, 2, 64, torch.bfloat16),  # sixteen tiles a side: the ring refilled many times
     (1, 128, 2, 320, torch.float32), (1, 192, 1, 320, torch.bfloat16),  # column-split SIMT kernels
     (1, 128, 1, 512, torch.float32), (2, 128, 1, 512, torch.bfloat16)],
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
    """head_dim 256 (d_model 512, 2 heads: SIMT for float32, the tensor-core
    kernels for bfloat16) and head_dim 320 under "auto" (d_model 640, 2
    heads: the column-split kernels in both dtypes) run the three kernels
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
