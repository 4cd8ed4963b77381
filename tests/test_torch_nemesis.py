"""The port's nemesis fault-injection harness against the JAX package's.

Mirrors every test of tests/test_nemesis.py (26) on the CPU, every
cluster built with ``device="cpu"``: the chaos proxy's fault mechanics
(``TestChaosProxy``), peer half-close as a distinct error
(``TestHalfCloseDistinct``), the decorrelated retry backoff
(``TestRetryBackoff``), a torn push deduplicated (``TestMidFrameRstDedupe``),
the schedules (``TestSchedules``), the checker units (``TestInvariants``)
and the acceptance anchors: the corpus battery, the shrinker and the
search (``TestAcceptance``).

Held against the reference, on the same inputs:
  * the port's corpus files are byte-identical to the reference's;
  * ``Scenario.from_seed(k).to_json()`` for k in range(64), every builtin
    and the seeded violation serialise to equal JSON in both packages;
  * ``_FaultEngine(seed)`` draws the same jittered ``delay_s`` sequence and
    the same one-shot takes;
  * ``probe_request`` gives equal strings for PA and the sketch from equal
    generators;
  * ``oracle_values`` on the corpus shape: MF within rtol 1e-4 / atol 1e-6
    (the reference's cluster parity bar), PA within rtol 1e-5 / atol 1e-6,
    the sketch exactly;
  * the slice as a whole: ``run_scenario`` on five corpus schedules gives
    the same verdict names in the same order with the same ``ok``, the
    same fault classes and the same ``ops_executed`` in both packages.
``_corrupt_row`` keeps the slice on the shard's device and backend, and
the entry points raise without a card unless given ``device="cpu"``.
"""
import dataclasses
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.nemesis import proxy as ref_proxy
from flink_parameter_server_tpu.nemesis import runner as ref_runner
from flink_parameter_server_tpu.nemesis import scenarios as ref_scenarios
from flink_parameter_server_tpu.workloads import (
    WorkloadParams as RefParams,
    create_workload as ref_create_workload,
)
from flink_parameter_server_tpu_torch.cluster import (
    ConsistentHashPartitioner,
    ParamShard,
    RangePartitioner,
    ShardServer,
)
from flink_parameter_server_tpu_torch.cluster.client import (
    ClusterClient,
    ShardConnection,
)
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
from flink_parameter_server_tpu_torch.elastic import MembershipService
from flink_parameter_server_tpu_torch.nemesis import (
    BUILTIN_SCENARIOS,
    ChaosProxy,
    NemesisOp,
    Scenario,
    load_corpus,
    replay_corpus,
    run_scenario,
    search_scenarios,
    shrink,
)
from flink_parameter_server_tpu_torch.nemesis import runner
from flink_parameter_server_tpu_torch.nemesis.invariants import (
    ThreadLedger,
    check_parity,
    check_staleness,
)
from flink_parameter_server_tpu_torch.nemesis.proxy import _FaultEngine
from flink_parameter_server_tpu_torch.nemesis.scenarios import VIOLATION_SCENARIO
from flink_parameter_server_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    set_registry,
)
from flink_parameter_server_tpu_torch.utils.net import (
    LineServer,
    PeerHalfClosed,
    request_lines,
)
from flink_parameter_server_tpu_torch.workloads import (
    WorkloadParams,
    create_workload,
)

pytestmark = pytest.mark.nemesis

torch.set_num_threads(2)

CPU = "cpu"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MF_BAR = dict(rtol=1e-4, atol=1e-6)  # the reference's cluster parity bar
PA_BAR = dict(rtol=1e-5, atol=1e-6)


class _Echo(LineServer):
    """Tiny line server answering ``ok <line>`` — the proxy fixtures'
    backend."""

    def __init__(self, pad: int = 0):
        super().__init__(registry=False)
        self.pad = pad
        self.seen = []

    def respond(self, line):
        self.seen.append(line)
        return "ok " + line + ("x" * self.pad)


@pytest.fixture
def echo_link():
    srv = _Echo(pad=1500).start()
    proxy = ChaosProxy(srv.host, srv.port, registry=False).start()
    yield srv, proxy
    proxy.stop()
    srv.stop()


# ---------------------------------------------------------------------------
# the chaos proxy: fault mechanics
# ---------------------------------------------------------------------------


class TestChaosProxy:
    def test_transparent_relay_pipelined(self, echo_link):
        srv, proxy = echo_link
        out = request_lines(proxy.host, proxy.port, ["a", "b", "c"])
        assert [o.split("x")[0] for o in out] == ["ok a", "ok b", "ok c"]

    def test_two_way_partition_holds_then_heals(self, echo_link):
        _, proxy = echo_link
        proxy.partition("both", duration_s=0.25)
        t0 = time.perf_counter()
        out = request_lines(proxy.host, proxy.port, ["late"], timeout=10)
        assert out[0].startswith("ok late")
        assert time.perf_counter() - t0 >= 0.2
        # healed: the next round trip is fast again
        t0 = time.perf_counter()
        request_lines(proxy.host, proxy.port, ["fast"])
        assert time.perf_counter() - t0 < 0.2

    def test_one_way_partition_is_asymmetric(self, echo_link):
        srv, proxy = echo_link
        # s2c held: the REQUEST still reaches the server (c2s flows),
        # only the response stalls — the asymmetric split
        proxy.partition("s2c")
        s = socket.create_connection((proxy.host, proxy.port), timeout=5)
        s.sendall(b"through\n")
        deadline = time.monotonic() + 5
        while "through" not in srv.seen and time.monotonic() < deadline:
            time.sleep(0.005)
        assert "through" in srv.seen  # server saw it mid-partition
        s.settimeout(0.2)
        with pytest.raises(socket.timeout):
            s.recv(4096)  # ...but the answer is held
        proxy.heal()
        s.settimeout(5)
        assert s.recv(4096).startswith(b"ok through")
        s.close()

    def test_delay_jitter_is_seeded(self):
        draws = []
        for _ in range(2):
            eng = _FaultEngine(seed=9)
            eng.set_delay(5.0, 5.0, "both")
            draws.append([eng.delay_s("c2s") for _ in range(6)])
        assert draws[0] == draws[1]  # same seed ⇒ same jitter stream
        assert len(set(draws[0])) > 1  # and it IS jittered

    def test_drip_caps_bandwidth(self, echo_link):
        _, proxy = echo_link
        proxy.set_drip(10_000.0, "s2c")  # ~1.5 KB response ≈ 150 ms
        t0 = time.perf_counter()
        request_lines(proxy.host, proxy.port, ["dripped"], timeout=10)
        assert time.perf_counter() - t0 >= 0.1
        proxy.clear_drip()

    def test_dup_delivers_frame_twice(self, echo_link):
        srv, proxy = echo_link
        proxy.inject_once("dup", "c2s")
        s = socket.create_connection((proxy.host, proxy.port), timeout=5)
        s.sendall(b"twice\n")
        deadline = time.monotonic() + 5
        while srv.seen.count("twice") < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv.seen.count("twice") == 2
        s.close()

    def test_reorder_swaps_adjacent_frames(self, echo_link):
        srv, proxy = echo_link
        proxy.inject_once("reorder", "c2s")
        s = socket.create_connection((proxy.host, proxy.port), timeout=5)
        s.sendall(b"first\nsecond\n")  # one segment → one pump batch
        deadline = time.monotonic() + 5
        while len(srv.seen) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv.seen == ["second", "first"]
        s.close()

    def test_truncate_rst_mid_frame_immediate(self, echo_link):
        _, proxy = echo_link
        proxy.inject_once("truncate_rst", "s2c", keep_frac=0.5)
        t0 = time.perf_counter()
        with pytest.raises((ConnectionError, OSError)):
            request_lines(proxy.host, proxy.port, ["torn"], timeout=10)
        # the abort must arrive as a reset, NOT as the read deadline (a
        # linger-0 close while a sibling pump sits in recv() defers the
        # RST until that read returns: a full-timeout stall here)
        assert time.perf_counter() - t0 < 1.0
        # and the link works again on the next dial
        assert request_lines(proxy.host, proxy.port, ["ok?"])[0].startswith(
            "ok"
        )

    def test_half_open_accept_hangs_then_recovers(self, echo_link):
        _, proxy = echo_link
        proxy.half_open(1)
        with pytest.raises((socket.timeout, ConnectionError, OSError)):
            request_lines(proxy.host, proxy.port, ["void"], timeout=0.3)
        assert request_lines(proxy.host, proxy.port, ["back"])[0].startswith(
            "ok back"
        )
        assert proxy.faults.get("half_open") == 1

    def test_fault_counters_on_registry(self):
        reg = MetricsRegistry()
        srv = _Echo().start()
        proxy = ChaosProxy(srv.host, srv.port, registry=reg).start()
        try:
            proxy.partition("c2s")
            proxy.heal()
            counts = {
                (i.name, i.labels.get("kind")): i.value
                for i in reg.instruments()
                if i.labels.get("component") == "nemesis"
            }
            assert counts[
                ("nemesis_faults_injected_total", "partition_c2s")
            ] == 1
        finally:
            proxy.stop()
            srv.stop()


# ---------------------------------------------------------------------------
# peer half-close is a distinct, counted, retryable error
# ---------------------------------------------------------------------------


def _scripted_server(script):
    """One-connection server running ``script(conn)`` on its own
    thread; returns (host, port, thread)."""
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    host, port = lst.getsockname()[:2]

    def run():
        conn, _ = lst.accept()
        try:
            script(conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            lst.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return host, port, t


class TestHalfCloseDistinct:
    def test_request_lines_half_close_counted(self):
        reg = MetricsRegistry()
        set_registry(reg)
        try:
            def script(conn):
                conn.recv(4096)
                conn.sendall(b"ok one\n")  # 1 of 2, then FIN

            host, port, t = _scripted_server(script)
            with pytest.raises(PeerHalfClosed):
                request_lines(host, port, ["a", "b"], timeout=5)
            t.join(timeout=5)
            counts = {
                i.labels.get("role"): i.value
                for i in reg.instruments()
                if i.name == "net_half_closed_total"
            }
            assert counts.get("client", 0) >= 1
        finally:
            set_registry(None)

    def test_shard_connection_torn_frame_is_half_close(self):
        def script(conn):
            conn.recv(4096)
            conn.sendall(b"ok b64:AAAA")  # torn: no newline, then FIN

        host, port, t = _scripted_server(script)
        conn = ShardConnection(host, port, timeout=5)
        # the torn prefix must NOT be handed to the parser as a
        # response line — it is the same dead peer, one packet earlier
        with pytest.raises(PeerHalfClosed, match="torn frame"):
            conn.request_many(["pull 1 b64"])
        conn.close()
        t.join(timeout=5)

    def test_timeout_stays_a_timeout(self):
        done = threading.Event()

        def script(conn):
            conn.recv(4096)
            done.wait(2.0)  # say nothing: a SLOW peer, not a dead one

        host, port, t = _scripted_server(script)
        conn = ShardConnection(host, port, timeout=0.3)
        with pytest.raises(socket.timeout):
            conn.request_many(["pull 1 b64"])
        done.set()
        conn.close()
        t.join(timeout=5)


# ---------------------------------------------------------------------------
# retry backoff — capped exponential, decorrelated jitter
# ---------------------------------------------------------------------------


class TestRetryBackoff:
    def _client(self):
        # static client: the ctor never dials, so the backoff ladder is
        # testable without sockets
        return ClusterClient(
            [("127.0.0.1", 9)], RangePartitioner(16, 1), (2,),
            registry=False,
        )

    def test_herd_disperses(self):
        """N workers retrying at the same attempt must NOT arrive in
        lockstep (a fixed, jitter-free ladder gives zero dispersion by
        construction)."""
        clients = [self._client() for _ in range(8)]
        arrivals = []
        for c in clients:
            t = 0.0
            for attempt in range(1, 6):
                t += c._next_retry_sleep(attempt)
            arrivals.append(t)
        assert len(set(arrivals)) == len(arrivals)  # all distinct
        assert float(np.std(arrivals)) > 0.0
        # and every single sleep respects the cap and the base floor
        c = self._client()
        for attempt in range(1, 20):
            s = c._next_retry_sleep(attempt)
            assert c.retry_sleep_s <= s <= c.retry_sleep_cap_s

    def test_ladder_grows_toward_cap_and_resets(self):
        c = self._client()
        sleeps = [c._next_retry_sleep(a) for a in range(1, 30)]
        # decorrelated jitter reaches the cap region under storm
        assert max(sleeps) > c.retry_sleep_s * 4
        c._last_retry_sleep = None  # the per-batch reset
        assert c._next_retry_sleep(1) <= min(
            c.retry_sleep_cap_s, c.retry_sleep_s * 3.0
        )


# ---------------------------------------------------------------------------
# mid-frame RST during a b64 push — exactly-once survives
# ---------------------------------------------------------------------------


class TestMidFrameRstDedupe:
    def test_torn_push_replays_without_duplicate_apply(self, tmp_path):
        part = ConsistentHashPartitioner(32, 1)
        shard = ParamShard(
            0, part, (4,), wal_dir=str(tmp_path / "wal"), registry=False,
            device=CPU,
        )
        srv = ShardServer(shard, supervised=False).start()
        proxy = ChaosProxy(srv.host, srv.port, registry=False).start()
        ms = MembershipService(
            part, [(proxy.host, proxy.port)], registry=False
        )
        client = ClusterClient(
            value_shape=(4,), membership=ms, registry=False,
            retry_timeout=30.0,
        )
        try:
            ids = np.arange(8, dtype=np.int64)
            deltas = np.ones((8, 4), np.float32)
            client.push_batch(ids, deltas)  # warm the connection
            base_applied = shard.rows_applied

            # direction c2s: the push REQUEST dies mid-b64 — the shard
            # never applies it; the replay applies exactly once
            proxy.inject_once("truncate_rst", "c2s", keep_frac=0.3)
            client.push_batch(ids, 2 * deltas)
            assert shard.rows_applied == base_applied + 8

            # direction s2c: the push ACK dies mid-frame — the shard
            # DID apply; the replayed frame carries the same pid and is
            # acked from the (pid,id) window without re-applying
            proxy.inject_once("truncate_rst", "s2c", keep_frac=0.4)
            client.push_batch(ids, 3 * deltas)
            assert shard.rows_applied == base_applied + 16

            # the ledger balances and the table is the exact sum
            assert client.rows_pushed == shard.rows_applied
            got = client.pull_batch(ids)
            np.testing.assert_array_equal(
                got, (1 + 2 + 3) * deltas
            )
            assert shard.stats()["dedupe_pairs"] > 0
        finally:
            client.close()
            proxy.stop()
            srv.stop()
            shard.close()


# ---------------------------------------------------------------------------
# scenario DSL / schedules
# ---------------------------------------------------------------------------


class TestSchedules:
    def test_canonical_json_round_trips_byte_identical(self):
        for s in list(BUILTIN_SCENARIOS) + [VIOLATION_SCENARIO]:
            j = s.to_json()
            assert Scenario.from_json(j).to_json() == j

    def test_from_seed_deterministic(self):
        a, b = Scenario.from_seed(42), Scenario.from_seed(42)
        assert a.to_json() == b.to_json()
        assert Scenario.from_seed(43).to_json() != a.to_json()

    def test_invalid_ops_rejected(self):
        with pytest.raises(ValueError, match="action"):
            NemesisOp(1, "format_disk")
        with pytest.raises(ValueError, match="parity"):
            Scenario("bad", (), staleness_bound=2, parity=True)

    def test_corpus_matches_builtins(self):
        """The committed corpus stays in lockstep with the builtin
        battery."""
        corpus = {s.name: s.to_json() for s in load_corpus()}
        for s in BUILTIN_SCENARIOS:
            assert corpus.get(s.name) == s.to_json(), s.name
        assert "seeded_corruption" in corpus


# ---------------------------------------------------------------------------
# invariant checker units
# ---------------------------------------------------------------------------


class TestInvariants:
    def test_parity_catches_silent_corruption(self):
        oracle = np.zeros((8, 4), np.float32)
        ok = check_parity(oracle.copy(), oracle)
        assert ok.ok
        bad = oracle.copy()
        bad[3, 2] += 1.0
        v = check_parity(bad, oracle)
        assert not v.ok and "mismatched_elems=1" in v.detail

    def test_staleness_bound_allows_one_in_flight(self):
        assert check_staleness([0, 1], 0).ok
        assert not check_staleness([0, 2], 0).ok
        assert check_staleness([5, 9], None).ok  # async: no bound

    def test_thread_ledger_catches_orphan(self):
        ledger = ThreadLedger()
        stop = threading.Event()
        t = threading.Thread(
            target=stop.wait, name="nemesis-orphan", daemon=True
        )
        t.start()
        v = ledger.check(grace_s=0.2)
        assert not v.ok and "nemesis-orphan" in v.detail
        stop.set()
        t.join(timeout=5)
        assert ledger.check(grace_s=2.0).ok


# ---------------------------------------------------------------------------
# the acceptance anchors
# ---------------------------------------------------------------------------


class TestAcceptance:
    def test_corpus_replay_battery(self, tmp_path):
        """Every committed fixed-seed schedule replays on the CPU with
        its recorded outcome — ≥ 8 distinct passing scenarios (incl. the
        asymmetric-partition-during-migration and
        kill-primary-under-partition anchors) satisfy EVERY invariant
        checker; the seeded violation is caught and leaves its
        artifacts."""
        artifacts = tmp_path / "artifacts"
        reports = replay_corpus(
            wal_root=str(tmp_path), artifact_dir=str(artifacts), device=CPU
        )
        by_name = {r.scenario.name: r for r in reports}
        passing = [r for r in reports if r.scenario.expect == "pass"]
        assert len(passing) >= 8
        assert all(r.ok for r in passing)
        for anchor in (
            "asym_partition_during_migration",
            "kill_primary_under_partition",
            "promote_while_client_partitioned",
        ):
            assert by_name[anchor].ok
            # the cluster ops really ran (partition+kill+recovery)
            assert by_name[anchor].ops_executed == len(
                by_name[anchor].scenario.ops
            )
        # every proxy fault class was exercised somewhere in the battery
        classes = set()
        for r in reports:
            classes.update(r.faults)
        assert {
            "partition_both", "partition_c2s", "partition_s2c",
            "delay_frame", "drip_frame", "truncate_rst", "half_open",
        } <= classes
        # one scenario ran under the lockwitness capture and was clean
        witnessed = [
            r for r in reports
            if any(v.name == "no_lock_inversions" for v in r.verdicts)
        ]
        assert witnessed and all(r.ok for r in witnessed)
        # the violation was caught, with parity the violated invariant
        v = by_name["seeded_corruption"]
        assert not v.ok
        assert [x.name for x in v.verdicts if not x.ok] == [
            "final_table_parity"
        ]
        # ...and left the (seed, schedule) + flight-recorder artifacts
        sched = [a for a in v.artifacts if "schedule" in a]
        frec = [a for a in v.artifacts if "flightrec" in a]
        assert sched and frec
        with open(sched[0]) as f:
            assert Scenario.from_json(f.read().strip()).name == (
                "seeded_corruption"
            )
        from tools.check_metric_lines import check_flightrec

        with open(frec[0]) as f:
            assert check_flightrec(json.load(f)) == []

    def test_violation_minimized_and_replays_byte_identical(self, tmp_path):
        """The seeded violation is caught, the shrinker strips every
        non-load-bearing op (leaving exactly the silent corruption), the
        minimized schedule equals the committed corpus file
        BYTE-identically, and replaying it from its JSON still fails the
        same invariant."""
        wal = str(tmp_path)

        def fails(s):
            return not run_scenario(s, wal_root=wal, device=CPU).ok

        mini, runs = shrink(VIOLATION_SCENARIO, fails)
        assert runs <= 24
        assert [o.action for o in mini.ops] == ["corrupt_row"]
        committed = {s.name: s for s in load_corpus()}["seeded_corruption"]
        assert mini.to_json() == committed.to_json()
        with open(os.path.join(runner.CORPUS_DIR, "seeded_corruption.json")) as f:
            assert f.read() == mini.to_json() + "\n"
        replayed = run_scenario(
            Scenario.from_json(mini.to_json()), wal_root=wal, device=CPU
        )
        assert not replayed.ok
        assert [v.name for v in replayed.verdicts if not v.ok] == [
            "final_table_parity"
        ]

    def test_search_failures_reproducible_by_seed(self, tmp_path):
        """The randomized layer: a sampled schedule is a pure function
        of its seed, so any failure the search ever finds replays from
        the seed alone.  (Runs one survivable seed end to end.)"""
        s1 = Scenario.from_seed(7)
        assert s1.to_json() == Scenario.from_seed(7).to_json()
        report = run_scenario(s1, wal_root=str(tmp_path), device=CPU)
        assert report.ok, [
            (v.name, v.detail) for v in report.verdicts if not v.ok
        ]


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------


def test_corpus_files_byte_identical_to_the_reference():
    ref_dir = ref_runner.CORPUS_DIR
    port_dir = runner.CORPUS_DIR
    assert port_dir != ref_dir
    assert port_dir.startswith(
        os.path.join(REPO_ROOT, "flink_parameter_server_tpu_torch")
    )
    names = sorted(os.listdir(ref_dir))
    assert len(names) == 15 and sorted(os.listdir(port_dir)) == names
    for name in names:
        with open(os.path.join(ref_dir, name), "rb") as a, \
                open(os.path.join(port_dir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_schedules_serialise_as_the_reference_does():
    for k in range(64):
        assert (
            Scenario.from_seed(k).to_json()
            == ref_scenarios.Scenario.from_seed(k).to_json()
        ), k
    ours = [s.to_json() for s in BUILTIN_SCENARIOS]
    theirs = [s.to_json() for s in ref_scenarios.BUILTIN_SCENARIOS]
    assert ours == theirs
    assert VIOLATION_SCENARIO.to_json() == (
        ref_scenarios.VIOLATION_SCENARIO.to_json()
    )
    # the device is the runner's argument, never a schedule field
    assert "device" not in {
        f.name for f in dataclasses.fields(Scenario)
    }


def test_fault_engine_draws_as_the_reference_does():
    for seed in (0, 9, 104):
        ours, theirs = _FaultEngine(seed), ref_proxy._FaultEngine(seed)
        for eng in (ours, theirs):
            eng.set_delay(5.0, 7.5, "both")
            eng.inject_once("truncate_rst", "c2s", keep_frac=0.4,
                            cut="header")
            eng.inject_once("dup", "s2c", count=2)
            eng.inject_once("reorder", "c2s")
            eng.arm_half_open(2)
        draws = [
            [(e.delay_s(d), e.take_one_shot(d)) for d in ("c2s", "s2c") * 6]
            for e in (ours, theirs)
        ]
        assert draws[0] == draws[1], seed
        assert len({d for d, _ in draws[0]}) > 1  # jittered
        assert [ours.take_half_open() for _ in range(3)] == [
            theirs.take_half_open() for _ in range(3)
        ]
        assert ours.frames == theirs.frames


@pytest.mark.parametrize("name", ["pa", "sketch"])
def test_probe_request_strings_equal_the_reference(name):
    kw = dict(rounds=3, batch=16, num_users=48, num_items=64, dim=4)
    ours = create_workload(name, WorkloadParams(**kw), device=CPU)
    theirs = ref_create_workload(name, RefParams(**kw))
    a, b = np.random.default_rng(17), np.random.default_rng(17)
    got = [ours.probe_request(a) for _ in range(32)]
    want = [theirs.probe_request(b) for _ in range(32)]
    assert got == want
    assert {cmd for cmd, _ in got} == set(ours.serving_verbs)
    mf = create_workload("mf", WorkloadParams(**kw), device=CPU)
    assert mf.probe_request(np.random.default_rng(0)) is None


@pytest.mark.parametrize("name", ["mf", "pa", "sketch"])
def test_oracle_values_match_the_reference(name):
    """The fault-free oracle on the corpus shape (the scenarios'
    defaults), cached per shape and device."""
    s = dataclasses.replace(BUILTIN_SCENARIOS[0], workload=name)
    got = runner.oracle_values(s, device=CPU)
    want = np.asarray(ref_runner.oracle_values(
        ref_scenarios.Scenario.from_json(s.to_json())
    ))
    assert got.shape == want.shape and np.isfinite(got).all()
    if name == "mf":
        np.testing.assert_allclose(got, want, **MF_BAR)
    elif name == "pa":
        np.testing.assert_allclose(got, want, **PA_BAR)
    else:
        np.testing.assert_array_equal(got, want)
    keys = [k for k in runner._ORACLE_CACHE if k[0] == name]
    assert keys and all(k[-1] == CPU for k in keys)
    assert runner.oracle_values(s, device=CPU) is got


# the one invariant the reference's chain-build race can break
REFERENCE_CHAIN_RACE_BREAKS = "final_table_parity"


@pytest.mark.parametrize("name", [
    "two_way_partition_heal",
    "mid_frame_rst_push",
    "pa_full_stack",
    "sketch_full_stack",
    "seeded_corruption",
])
def test_scenario_verdicts_match_the_reference(name, tmp_path):
    """The slice as a whole: the same committed schedule through both
    packages' runners gives the same verdict table.

    ``sketch_full_stack`` is held apart on one invariant.  The
    reference's chain build starts its WAL shippers before it attaches the
    primary's sink (``replication/chain.py:173-188``), so now and then a
    replica misses a push and the promoted table loses increments: its
    ``final_table_parity`` fails, and only that verdict.  The port
    attaches the sink first.  So there the port's verdicts must ALL be ok,
    every other verdict must equal the reference's, and
    ``final_table_parity`` is compared only when the reference's run kept
    its increments (its integer-exact check found no mismatched cell)."""
    ours = run_scenario(
        {s.name: s for s in load_corpus()}[name],
        wal_root=str(tmp_path), device=CPU,
    )
    theirs = ref_runner.run_scenario(
        {s.name: s for s in ref_runner.load_corpus()}[name],
        wal_root=str(tmp_path),
    )
    table = ([v.as_dict() for v in ours.verdicts],
             [v.as_dict() for v in theirs.verdicts])
    mine = [(v.name, v.ok) for v in ours.verdicts]
    ref = [(v.name, v.ok) for v in theirs.verdicts]
    if name == "sketch_full_stack":
        raced = REFERENCE_CHAIN_RACE_BREAKS
        assert all(ok for _, ok in mine), table
        kept = all("mismatched_cells=0" in v.detail for v in theirs.verdicts if v.name == raced)
        if not kept:
            mine = [(n, ok) for n, ok in mine if n != raced]
            ref = [(n, ok) for n, ok in ref if n != raced]
    assert mine == ref, table
    assert set(ours.faults) == set(theirs.faults)
    assert ours.ops_executed == theirs.ops_executed == len(
        ours.scenario.ops
    )
    assert ours.schedule_json == theirs.schedule_json


def test_corrupt_row_keeps_device_and_backend(tmp_path):
    """``_corrupt_row`` reinstalls the slice through the shard's own
    seam: the same backend on the same device, one row bumped by 1.0,
    the host mirror dropped; run as a scenario, only parity fails."""
    s = {x.name: x for x in load_corpus()}["seeded_corruption"]
    wl = runner._make_workload(s, CPU)
    driver = runner._build_driver(
        s, wl, str(tmp_path / "wal"), MetricsRegistry()
    )
    with driver:
        driver.run(wl.batches()[:2], timeout=60)
        gid = 7
        owner = int(driver.partitioner.shard_of(np.asarray([gid]))[0])
        sh = driver.shards[owner]
        before = sh.values().copy()
        runner._corrupt_row(driver, gid)
        assert isinstance(sh.store, ShardedParamStore)
        assert sh.store.table.device.type == CPU
        assert sh._host_mirror is None
        after = sh.values()
        local = int(sh.partitioner.to_local(
            sh.shard_id, np.asarray([gid], np.int64)
        )[0])
        want = before.copy()
        want[local] += np.float32(1.0)
        assert after.tobytes() == want.tobytes()
    report = run_scenario(s, wal_root=str(tmp_path), device=CPU)
    assert [v.name for v in report.verdicts if not v.ok] == [
        "final_table_parity"
    ]


def test_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    """No fallback hides the card: the default device is the card, and
    asking for it without one raises before anything is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = BUILTIN_SCENARIOS[0]
    with pytest.raises(RuntimeError, match="cuda"):
        run_scenario(s, wal_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        replay_corpus(wal_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        search_scenarios([7], wal_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        runner.oracle_values(s)
    assert os.listdir(tmp_path) == []
