"""The port's record sources and job parameters against the JAX package's:
``data/socket.py``, ``data/native_loader.py`` and ``utils/config.py``.

Parity (the same inputs through both packages, the port on ``device="cpu"``):
  * ``Parameters`` from the same argv and environment: equal keys and
    lookups;
  * ``batches_from_records`` over the same lines: every batch's columns
    byte for byte, and the ``dropped`` counts;
  * the whole socket edge, TCP lines -> ``batches_from_records`` -> the
    port's ``transform_batched`` against the reference's: item table and
    user state within rtol 1e-5 / atol 1e-6 (the MF bar of
    tests/test_torch_driver.py: float32 sums in another order), and the
    padded tail's row 0 untouched in both;
  * the port's native ``load_ratings`` against the reference's numpy
    ``load_movielens`` (compacted ids, equal ratings);
  * the port's ``csrc/fps_loader.cpp`` byte for byte ``native/fps_loader.cpp``.

Mirrors: tests/test_socket_stream.py (10), tests/test_native_loader.py (6)
and tests/test_config_and_graft.py's six ``Parameters`` tests.  The native
cases skip where ``get_lib()`` cannot build the library (no ``g++``), as
the reference's do.
"""
import socketserver
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.data import socket as ref_socket
from flink_parameter_server_tpu.data.movielens import load_movielens as ref_load_movielens
from flink_parameter_server_tpu.utils.config import Parameters as RefParameters
from flink_parameter_server_tpu_torch.data import native_loader
from flink_parameter_server_tpu_torch.data.movielens import load_movielens
from flink_parameter_server_tpu_torch.data.socket import batches_from_records, socket_text_stream
from flink_parameter_server_tpu_torch.utils.config import Parameters

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-6)


class _OneShotServer(socketserver.TCPServer):
    allow_reuse_address = True


def _serve(payload: bytes):
    """Serve ``payload`` to the first client, then close."""

    class H(socketserver.BaseRequestHandler):
        def handle(self):
            self.request.sendall(payload)

    srv = _OneShotServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.handle_request, daemon=True).start()
    return srv.server_address[1], srv


def _parse_rating(line):
    u, i, r = line.split(",")
    return {"user": np.int32(u), "item": np.int32(i), "rating": np.float32(r)}


# ---------------------------------------------------------------------------
# utils/config.py (tests/test_config_and_graft.py)
# ---------------------------------------------------------------------------


ARGVS = (
    ["--lr", "0.05", "--dim=16", "--use-ring", "--name", "mf"],
    ["--checkpoint_dir=/tmp/my_run_1", "--use_ring", "--dim", "abc"],
    ["--use-ring=false", "--x", "1", "--flag"],
)


@pytest.mark.parametrize("argv", ARGVS)
def test_parameters_match_the_reference(argv, monkeypatch):
    monkeypatch.setenv("FPS_LR", "0.1")
    monkeypatch.setenv("FPS_USE_RING", "1")
    monkeypatch.setenv("FPS_SOME_PATH", "/a_b")
    ours = Parameters.from_env().merged_with(Parameters.from_args(argv))
    theirs = RefParameters.from_env().merged_with(RefParameters.from_args(argv))
    assert ours.keys() == theirs.keys()
    assert repr(ours) == repr(theirs)
    for k in ours.keys():
        assert ours.get(k) == theirs.get(k) and ours.get_bool(k) == theirs.get_bool(k)
    with pytest.raises(ValueError, match="expected --key"):
        Parameters.from_args(["lr", "0.1"])


class TestParameters:
    def test_args_forms(self):
        p = Parameters.from_args(["--lr", "0.05", "--dim=16", "--use-ring", "--name", "mf"])
        assert p.get_float("lr") == 0.05
        assert p.get_int("dim") == 16
        assert p.get_bool("use-ring") is True
        assert p.get("name") == "mf"
        assert p.get("missing", "d") == "d"

    def test_required_and_errors(self):
        p = Parameters.from_args([])
        with pytest.raises(KeyError, match="required parameter --lr"):
            p.required("lr")
        with pytest.raises(ValueError, match="expected --key"):
            Parameters.from_args(["lr", "0.1"])

    def test_env_and_merge(self, monkeypatch):
        monkeypatch.setenv("FPS_LR", "0.1")
        monkeypatch.setenv("FPS_DIM", "8")
        merged = Parameters.from_env().merged_with(Parameters.from_args(["--lr", "0.2"]))
        assert merged.get_float("lr") == 0.2
        assert merged.get_int("dim") == 8


def test_env_dash_normalization(monkeypatch):
    monkeypatch.setenv("FPS_USE_RING", "1")
    env = Parameters.from_env()
    assert env.get_bool("use-ring") is True
    merged = env.merged_with(Parameters.from_args(["--use-ring=false"]))
    assert merged.get_bool("use-ring") is False


def test_numeric_errors_name_the_key():
    p = Parameters.from_args(["--dim", "abc"])
    with pytest.raises(ValueError, match="--dim"):
        p.get_int("dim")


def test_underscore_value_preserved_and_lookup_normalized():
    p = Parameters.from_args(["--checkpoint_dir=/tmp/my_run_1", "--use_ring"])
    assert p.get("checkpoint-dir") == "/tmp/my_run_1"
    assert p.get("checkpoint_dir") == "/tmp/my_run_1"
    assert p.get_bool("use-ring") and p.get_bool("use_ring")
    assert "use_ring" in p


# ---------------------------------------------------------------------------
# data/socket.py: parity
# ---------------------------------------------------------------------------


def _mixed_lines(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        roll = rng.random()
        if roll < 0.1:
            out.append("garbage")
        elif roll < 0.15:
            out.append(f"{k},{k}")  # too few fields
        else:
            out.append(f"{rng.integers(0, 50)},{rng.integers(0, 90)},{rng.normal():.6f}")
    return out


@pytest.mark.parametrize("batch_size,drop_remainder", [(1, False), (7, False), (16, True), (64, False)])
def test_batches_from_records_match_the_reference(batch_size, drop_remainder):
    lines = _mixed_lines(batch_size, 150)
    ours = batches_from_records(iter(lines), batch_size, _parse_rating, drop_remainder=drop_remainder)
    theirs = ref_socket.batches_from_records(iter(lines), batch_size, _parse_rating,
                                             drop_remainder=drop_remainder)
    got, want = list(ours), list(theirs)
    assert ours.dropped == theirs.dropped > 0
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_socket_edge_into_transform_batched_matches_the_reference():
    """TCP lines -> parse -> microbatches -> the batched MF step, in both
    packages over the same bytes: the tables agree at the MF bar, and the
    padded tail's masked lanes (pad id 0) leave row 0 at zero in both."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore as RefStore
    from flink_parameter_server_tpu.core.transform import transform_batched as ref_transform
    from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization,
        SGDUpdater,
    )

    rng = np.random.default_rng(0)
    payload = "".join(f"{rng.integers(0, 16)},{rng.integers(1, 32)},{rng.normal():.4f}\n"
                      for _ in range(22)).encode()
    port, srv = _serve(payload)
    try:
        batches = batches_from_records(socket_text_stream("127.0.0.1", port), 8, _parse_rating)
        res = transform_batched(batches, OnlineMatrixFactorization(16, 4, updater=SGDUpdater(0.05), device=CPU),
                                ShardedParamStore.create(32, (4,), device=CPU), dump_model=False)
    finally:
        srv.server_close()
    port, srv = _serve(payload)
    try:
        ref_batches = ref_socket.batches_from_records(
            ref_socket.socket_text_stream("127.0.0.1", port), 8, _parse_rating)
        want = ref_transform(ref_batches, ref_mf.OnlineMatrixFactorization(16, 4, updater=ref_mf.SGDUpdater(0.05)),
                             RefStore.create(32, (4,)), dump_model=False)
    finally:
        srv.server_close()
    assert len(res.worker_outputs) == len(want.worker_outputs) >= 3
    vals, ref_vals = res.store.values().numpy(), np.asarray(want.store.values())
    np.testing.assert_allclose(vals, ref_vals, **TOL)
    np.testing.assert_allclose(res.worker_state.numpy(), np.asarray(want.worker_state), **TOL)
    np.testing.assert_array_equal(vals[0], np.zeros(4))
    np.testing.assert_array_equal(ref_vals[0], np.zeros(4))
    assert np.abs(vals[1:]).sum() > 0


# ---------------------------------------------------------------------------
# data/socket.py (tests/test_socket_stream.py)
# ---------------------------------------------------------------------------


def test_socket_text_stream_lines_and_trailing_partial():
    port, srv = _serve(b"alpha\nbeta\ngamma")
    try:
        lines = list(socket_text_stream("127.0.0.1", port))
    finally:
        srv.server_close()
    assert lines == ["alpha", "beta", "gamma"]


def test_socket_text_stream_rejects_unbounded_line():
    port, srv = _serve(b"x" * 4096)
    try:
        with pytest.raises(ValueError, match="newline"):
            list(socket_text_stream("127.0.0.1", port, max_line_bytes=1024))
    finally:
        srv.server_close()


def test_batches_from_records_pads_and_counts_drops():
    it = batches_from_records(iter(["1,2,0.5", "3,4,1.0", "garbage", "5,6,-0.5"]), 3, _parse_rating)
    batches = list(it)
    assert it.dropped == 1
    (full,) = batches
    assert full["user"].tolist() == [1, 3, 5]
    assert full["rating"].dtype == np.float32
    assert full["mask"].all()


def test_batches_from_records_tail_mask():
    (b,) = list(batches_from_records(iter(["7,8,0.25"]), 4, _parse_rating))
    assert b["mask"].tolist() == [True, False, False, False]
    assert b["user"][0] == 7 and b["user"][1] == 0


def test_undecodable_bytes_drop_not_crash():
    port, srv = _serve(b"1,2,0.5\n\xff\xfe,oops\n3,4,1.0\n")
    try:
        it = batches_from_records(socket_text_stream("127.0.0.1", port), 2, _parse_rating)
        (b,) = list(it)
    finally:
        srv.server_close()
    assert it.dropped == 1
    assert b["user"].tolist() == [1, 3]


def test_parse_reserved_mask_key_is_loud():
    it = batches_from_records(iter(["x"]), 1, lambda ln: {"mask": np.bool_(True)})
    with pytest.raises(ValueError, match="reserved"):
        list(it)


def test_parse_reserved_mask_key_is_loud_on_any_row():
    def parse(ln):
        if ln == "bad":
            return {"v": np.int32(0), "mask": np.bool_(True)}
        return {"v": np.int32(ln)}

    with pytest.raises(ValueError, match="reserved"):
        list(batches_from_records(iter(["1", "2", "bad"]), 8, parse))


def test_inconsistent_row_keys_drop_not_crash():
    def parse(ln):
        if ln == "extra":
            return {"v": np.int32(7), "bonus": np.int32(1)}
        if ln == "missing":
            return {"w": np.int32(8)}
        return {"v": np.int32(ln)}

    it = batches_from_records(iter(["1", "extra", "2", "missing", "3"]), 2, parse)
    batches = list(it)
    assert it.dropped == 2
    assert [int(v) for b in batches for v, m in zip(b["v"], b["mask"]) if m] == [1, 2, 3]


def test_batcher_invariants_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.one_of(st.integers(min_value=0, max_value=999), st.just(None)), min_size=0, max_size=40),
           st.integers(min_value=1, max_value=9))
    def prop(records, batch_size):
        it = batches_from_records(iter(records), batch_size, lambda rec: {"v": np.int32(rec)})
        batches = list(it)
        valid = [r for r in records if r is not None]
        assert it.dropped == len(records) - len(valid)
        assert all(b["v"].shape == (batch_size,) for b in batches)
        assert sum(int(b["mask"].sum()) for b in batches) == len(valid)
        assert [int(v) for b in batches for v, m in zip(b["v"], b["mask"]) if m] == valid

    prop()


def test_socket_stream_to_train_step_end_to_end():
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization,
        SGDUpdater,
    )

    rng = np.random.default_rng(0)
    payload = "".join(f"{rng.integers(0, 16)},{rng.integers(1, 32)},{rng.normal():.4f}\n"
                      for _ in range(22)).encode()
    port, srv = _serve(payload)
    try:
        batches = batches_from_records(socket_text_stream("127.0.0.1", port), 8, _parse_rating)
        res = transform_batched(batches, OnlineMatrixFactorization(16, 4, updater=SGDUpdater(0.05), device=CPU),
                                ShardedParamStore.create(32, (4,), device=CPU), dump_model=False)
    finally:
        srv.server_close()
    assert len(res.worker_outputs) >= 3
    vals = res.store.values().numpy()
    assert np.isfinite(vals).all()
    np.testing.assert_array_equal(vals[0], np.zeros(4))
    assert np.abs(vals[1:]).sum() > 0


# ---------------------------------------------------------------------------
# data/native_loader.py
# ---------------------------------------------------------------------------


@pytest.fixture
def native():
    try:
        native_loader.get_lib()
    except native_loader.NativeUnavailable as e:
        pytest.skip(f"no C++ toolchain: {e}")
    return native_loader


@pytest.fixture(scope="module")
def ratings_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("data") / "u.data"
    with open(path, "w") as f:
        for _ in range(1000):
            f.write(f"{rng.integers(1, 50)}\t{rng.integers(1, 80)}\t{rng.integers(1, 6)}\t"
                    f"{rng.integers(1e8, 1e9)}\n")
    return str(path)


def test_fps_loader_source_is_the_reference_byte_for_byte():
    assert (ROOT / "flink_parameter_server_tpu_torch" / "csrc" / "fps_loader.cpp").read_bytes() == \
        (ROOT / "native" / "fps_loader.cpp").read_bytes()


def test_native_library_builds_under_build_native(native):
    path = native.library_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert path.name.startswith("libfps_loader-") and path.suffix == ".so"
    assert not list(path.parent.glob("*.tmp"))


def test_native_columns_match_the_reference_numpy_loader(native, tmp_path):
    rng = np.random.default_rng(4)
    ratings = rng.normal(0, 1, 500).astype(np.float32)
    path = tmp_path / "u.data"
    path.write_text("".join(
        f"{u}\t{i}\t{np.format_float_positional(r, unique=True)}\t{n}\n"
        for n, (u, i, r) in enumerate(zip(rng.integers(3, 900, 500), rng.integers(7, 5000, 500), ratings))))
    got = native.load_ratings(str(path))
    want = ref_load_movielens(str(path), normalize=False)
    for k in ("user", "item", "rating"):
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    raw = native.load_ratings(str(path), compact_ids=False)
    assert raw["rating"].tobytes() == ratings.tobytes()
    norm, ref_norm = native.load_ratings(str(path), normalize=True), ref_load_movielens(str(path), normalize=True)
    assert norm["rating"].tobytes() == ref_norm["rating"].tobytes()


def test_parse_matches_numpy_loader(native, ratings_file):
    a = native.load_ratings(ratings_file)
    b = load_movielens(ratings_file, normalize=False)
    np.testing.assert_array_equal(a["user"], b["user"])
    np.testing.assert_array_equal(a["item"], b["item"])
    np.testing.assert_allclose(a["rating"], b["rating"])


def test_parse_csv_and_dat_formats(native, tmp_path):
    csv = tmp_path / "ratings.csv"
    csv.write_text("userId,movieId,rating,timestamp\n1,10,4.5,0\n2,20,3.0,0\n")
    out = native.load_ratings(str(csv), compact_ids=False)
    np.testing.assert_array_equal(out["user"], [1, 2])
    np.testing.assert_array_equal(out["item"], [10, 20])
    np.testing.assert_allclose(out["rating"], [4.5, 3.0])
    dat = tmp_path / "ratings.dat"
    dat.write_text("7::99::5::0\n8::100::1::0\n")
    out = native.load_ratings(str(dat), compact_ids=False)
    np.testing.assert_array_equal(out["user"], [7, 8])
    np.testing.assert_array_equal(out["item"], [99, 100])


def test_stream_batches_covers_all_rows(native, ratings_file):
    batches = list(native.stream_batches(ratings_file, 256, epochs=2))
    assert sum(int(b["mask"].sum()) for b in batches) == 2000
    assert all(b["user"].shape == (256,) for b in batches)


def test_stream_shuffle_changes_order_not_content(native, ratings_file):
    plain = list(native.stream_batches(ratings_file, 128))
    shuf = list(native.stream_batches(ratings_file, 128, shuffle_seed=7))

    def cat(bs, k):
        return np.concatenate([b[k][b["mask"]] for b in bs])

    assert not np.array_equal(cat(plain, "user"), cat(shuf, "user"))
    assert sorted(cat(plain, "user").tolist()) == sorted(cat(shuf, "user").tolist())


def test_stream_feeds_training(native, ratings_file):
    from flink_parameter_server_tpu_torch.models.matrix_factorization import ps_online_mf

    res = ps_online_mf(native.stream_batches(ratings_file, 256, epochs=1, shuffle_seed=0), num_users=64,
                       num_items=128, dim=4, collect_outputs=False, device=CPU)
    assert torch.isfinite(res.store.values()).all()


def test_parse_crlf_and_no_trailing_newline(native, tmp_path):
    p = tmp_path / "crlf.data"
    p.write_bytes(b"1\t10\t4.0\t0\r\n2\t20\t3.5\t0")
    out = native.load_ratings(str(p), compact_ids=False)
    np.testing.assert_array_equal(out["user"], [1, 2])
    np.testing.assert_allclose(out["rating"], [4.0, 3.5])


def test_native_stream_equals_in_memory_microbatches(native, tmp_path):
    """The native stream yields the file's rows in order, raw ids, the
    tail padded with a mask: ``ps_online_mf`` over it is bitwise the same
    call over ``microbatches`` of the arrays (``scatter_impl="pallas"``
    takes K1's plain version on CPU tensors)."""
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import ps_online_mf

    data = synthetic_ratings(200, 300, 1000, seed=2)
    path = tmp_path / "u.data"
    path.write_text("".join(f"{u}\t{i}\t{np.format_float_positional(r, unique=True)}\t0\n"
                            for u, i, r in zip(data["user"].tolist(), data["item"].tolist(), data["rating"])))
    kw = dict(num_users=200, num_items=300, dim=8, learning_rate=0.01, scatter_impl="pallas", device=CPU)
    a = ps_online_mf(native.stream_batches(str(path), 256), **kw)
    b = ps_online_mf(microbatches(data, 256), **kw)
    assert torch.equal(a.store.values(), b.store.values()) and torch.equal(a.worker_state, b.worker_state)


def test_without_a_compiler_the_loaders_fall_back_to_numpy(monkeypatch, ratings_file):
    """The reference's contract: no ``g++`` -> ``load_ratings`` and
    ``stream_batches`` take the numpy loader (compacted ids), and
    ``compact_ids=False`` raises."""
    def unavailable():
        raise native_loader.NativeUnavailable("no g++ here")

    monkeypatch.setattr(native_loader, "get_lib", unavailable)
    cols = native_loader.load_ratings(ratings_file)
    want = load_movielens(ratings_file, normalize=False)
    assert all(cols[k].tobytes() == want[k].tobytes() for k in ("user", "item", "rating"))
    with pytest.raises(native_loader.NativeUnavailable, match="compact_ids"):
        native_loader.load_ratings(ratings_file, compact_ids=False)
    batches = list(native_loader.stream_batches(ratings_file, 300))
    assert sum(int(b["mask"].sum()) for b in batches) == 1000
    assert np.array_equal(np.concatenate([b["user"][b["mask"]] for b in batches]), want["user"])

