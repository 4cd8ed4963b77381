"""The port's checkpoints (``training/checkpoint.py``), the restore path
(``ShardedParamStore.from_spec_values``) and the tracing hooks
(``training/tracing.py``).

The format is the port's own (``torch.save`` of the reference's payload,
one numbered directory a step), so no test reads an orbax checkpoint; the
re-placement of a payload onto a target spec is held against the JAX
package's ``_payload_to_state`` exactly.  Round trips are bitwise.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.core.store import StoreSpec as RefSpec
from flink_parameter_server_tpu.training import checkpoint as ref_ckpt
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore, StoreSpec
from flink_parameter_server_tpu_torch.resilience import corrupt_latest_checkpoint
from flink_parameter_server_tpu_torch.training import checkpoint as ckpt
from flink_parameter_server_tpu_torch.training import tracing
from flink_parameter_server_tpu_torch.utils.initializers import normal_factor, ranged_random_factor

torch.set_num_threads(2)


def _store(capacity=40, dim=4, **kw):
    return ShardedParamStore.create(capacity, (dim,), init_fn=normal_factor(1, (dim,)), device="cpu", **kw)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(layout="packed"), dict(dtype=torch.bfloat16), dict(scatter_impl="pallas")],
    ids=["dense", "packed", "bf16", "pallas"],
)
def test_save_restore_bitwise(tmp_path, kw):
    store = _store(**kw)
    state = {"users": torch.randn(8, 4), "count": torch.tensor(3)}
    ckpt.save(str(tmp_path / "c"), store, state, step=7, extra={"epoch": 2})
    got, got_state, meta = ckpt.restore(str(tmp_path / "c"), store.spec, "cpu")
    assert got.spec == store.spec  # the full spec, scatter_impl and layout included
    # the logical rows are what a checkpoint keeps: padding restores as
    # zeros, as in the reference
    assert torch.equal(got.values(), store.values())
    assert torch.equal(got_state["users"], state["users"]) and int(got_state["count"]) == 3
    assert meta == {"step": 7, "capacity": 40, "epoch": 2}


def test_payload_holds_the_logical_table_only(tmp_path):
    """A dense store's values() is a view of its padded table: the payload
    must be a copy of the logical rows, not the whole storage."""
    store = _store(capacity=37)
    assert store.table.shape[0] == 40
    payload = ckpt._make_payload(store, None, 1, None)
    assert tuple(payload["table"].shape) == (37, 4)
    assert payload["table"].untyped_storage().nbytes() == 37 * 4 * 4
    assert payload["worker_state"] == ()
    store.table.add_(1.0)  # the live table moves on; the payload does not
    assert not torch.equal(payload["table"], store.values())


@pytest.mark.parametrize("target", [24, 16, 20])
def test_payload_to_state_matches_the_reference(target):
    """Restoring onto another capacity cuts or zero-pads the logical
    table as the reference does."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(24, 3)).astype(np.float32)  # a padded table, logical capacity 20
    payload = {"table": table, "worker_state": (), "meta": {"step": 5, "capacity": 20}}
    want, _, _ = ref_ckpt._payload_to_state(payload, RefSpec(capacity=target, value_shape=(3,)))
    port_payload = dict(payload, table=torch.from_numpy(table))
    got, _, meta = ckpt._payload_to_state(port_payload, StoreSpec(capacity=target, value_shape=(3,)), "cpu")
    assert meta["step"] == 5
    np.testing.assert_array_equal(got.values().numpy(), np.asarray(want.values()))
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))


def test_from_spec_values_keeps_the_spec():
    spec = _store(layout="packed", scatter_impl="pallas").spec
    values = torch.arange(40 * 4, dtype=torch.float64).reshape(40, 4)
    store = ShardedParamStore.from_spec_values(spec, values, device="cpu")
    assert store.spec == spec and store.table.dtype == torch.float32
    assert torch.equal(store.values(), values.float())


def test_manager_retains_two_and_skips_old_steps(tmp_path):
    store = _store()
    mgr = ckpt.JobCheckpointManager(str(tmp_path))
    for step in (1, 2, 3):
        assert mgr.save(step, ShardedParamStore(store.spec, store.table + step))
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not mgr.save(3, store)  # a duplicate step is skipped ...
    assert not mgr.save(2, store)  # ... and so is one below the newest
    got, _, meta = mgr.restore_latest(store.spec, "cpu")
    assert meta["step"] == 3 and torch.equal(got.values(), store.values() + 3)
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]  # no temporary directory left


def test_force_replaces_a_step_without_a_gap(tmp_path, monkeypatch):
    store = _store()
    mgr = ckpt.JobCheckpointManager(str(tmp_path))
    mgr.save(4, store)
    assert mgr.save(4, ShardedParamStore(store.spec, store.table * 2), force=True)
    got, _, _ = mgr.restore_latest(store.spec, "cpu")
    assert torch.equal(got.values(), store.values() * 2)
    assert sorted(os.listdir(tmp_path)) == ["4"]

    # a replacement that fails mid-write puts the old copy back
    def failing_save(obj, f):
        f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(4, ShardedParamStore(store.spec, store.table * 5), force=True)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["4"]
    got, _, _ = mgr.restore_latest(store.spec, "cpu")
    assert torch.equal(got.values(), store.values() * 2)


def test_a_failed_write_leaves_no_step(tmp_path, monkeypatch):
    store = _store()
    mgr = ckpt.JobCheckpointManager(str(tmp_path))
    mgr.save(1, store)
    monkeypatch.setattr(ckpt.torch, "save", lambda obj, f: (_ for _ in ()).throw(OSError("cut")))
    with pytest.raises(OSError):
        mgr.save(2, store)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["1"]
    os.makedirs(tmp_path / ".tmp-9-stale")  # a crash's remnant is swept at open
    ckpt.JobCheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["1"]


def test_async_save_copies_before_returning(tmp_path):
    store = _store()
    want = store.values().clone()
    mgr = ckpt.JobCheckpointManager(str(tmp_path), use_async=True)
    live = store.table.clone()
    assert mgr.save(1, ShardedParamStore(store.spec, live))
    live.add_(100.0)  # the next step, in place, while the writer runs
    mgr.wait()
    got, _, _ = mgr.restore_latest(store.spec, "cpu")
    assert torch.equal(got.values(), want)
    mgr.close()


def test_async_write_error_surfaces_at_wait(tmp_path, monkeypatch):
    mgr = ckpt.JobCheckpointManager(str(tmp_path), use_async=True)
    monkeypatch.setattr(ckpt, "_commit", lambda d, p: (_ for _ in ()).throw(OSError("no space")))
    mgr.save(1, _store())
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr.wait()  # reported once


def test_corrupt_checkpoint_falls_back_to_previous(tmp_path):
    """tests/test_resilience.py's corrupt-latest test on the port's
    layout: the JAX package's chaos helper's file truncation applies to
    it unchanged."""
    d = str(tmp_path / "ckpt")
    store = _store(32)
    want = store.values().clone()
    mgr = ckpt.JobCheckpointManager(d)
    mgr.save(1, store)
    mgr.save(2, ShardedParamStore(store.spec, store.table + 1.0))
    mgr.close()
    assert corrupt_latest_checkpoint(d, seed=0).endswith(os.sep + "2")
    mgr2 = ckpt.JobCheckpointManager(d)
    with pytest.warns(RuntimeWarning, match="falling back"):
        restored = mgr2.restore_latest(store.spec, "cpu")
    st, _state, meta = restored
    assert meta["step"] == 1
    assert torch.equal(st.values(), want)
    shutil.rmtree(os.path.join(d, "2"))
    assert corrupt_latest_checkpoint(d, seed=1).endswith(os.sep + "1")
    with pytest.warns(RuntimeWarning), pytest.raises(RuntimeError, match="no retained checkpoint"):
        ckpt.JobCheckpointManager(d).restore_latest(store.spec, "cpu")


def test_load_model_from_save_and_from_a_manager(tmp_path):
    store = _store(50)
    ckpt.save(str(tmp_path / "one"), store, step=3)
    got = ckpt.load_model(str(tmp_path / "one"), device="cpu", scatter_impl="xla_sorted")
    assert torch.equal(got.values(), store.values()) and got.spec.scatter_impl == "xla_sorted"
    mgr = ckpt.JobCheckpointManager(str(tmp_path / "mgr"))
    mgr.save(5, store)
    mgr.save(9, ShardedParamStore(store.spec, store.table - 1))
    got = ckpt.load_model(str(tmp_path / "mgr"), device="cpu")
    assert torch.equal(got.values(), store.values() - 1)
    with pytest.raises(FileNotFoundError):
        ckpt.load_model(str(tmp_path / "nothing"), device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    """Entry points run on the card unless asked for the CPU: with no card
    a default restore raises instead of landing on the CPU."""
    store = _store()
    ckpt.save(str(tmp_path / "c"), store)
    if torch.cuda.is_available():
        assert ckpt.restore(str(tmp_path / "c"), store.spec)[0].table.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ckpt.restore(str(tmp_path / "c"), store.spec)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tracing.profile_trace(str(tmp_path)):
        with tracing.scope("pull"):
            torch.ones(8).sum()
        tracing.annotate_step(lambda x: x * 2, name="ps_step")(torch.ones(4))
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert {"pull", "ps_step"} <= names


def test_device_memory_stats_on_the_cpu():
    assert tracing.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert tracing.device_memory_stats() == {}
        from flink_parameter_server_tpu_torch.telemetry import MetricsRegistry

        assert tracing.register_device_memory_gauges(MetricsRegistry()) == 0
