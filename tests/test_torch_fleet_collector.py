"""The port's fleet collector (``metrics_tpu_torch.observability.collector``)
on the CPU, held to the JAX package's.

Each contract of ``tests/bases/test_collector.py`` has a case here, run by
both packages' collectors over the same publishers (the same seeded numpy
batches through each package's metrics) on injected clocks only: no
assertion waits on the wall clock. The folds must agree: counts bit for
bit, sketches bit for bit inside their lossless window and within the
curve tests' tolerance past it; ``totals`` match under the same schedule;
the three fleet alarm classes fire and clear through each collector's own
feed (``record_fleet_poll``) into a registry on the injected clock. One
case runs two real publisher subprocesses (``device="cpu"``, each under a
timeout of its own).
"""
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as tobs
from metrics_tpu.observability.timeseries import TimeSeriesRegistry as JaxRegistry
from metrics_tpu_torch.observability.collector import SnapshotQueue
from metrics_tpu_torch.observability.recorder import (
    SERIES_COLLECTOR_BACKLOG,
    SERIES_FOLD_ERRORS,
    SERIES_PUBLISHER_LAG,
)
from metrics_tpu_torch.observability.timeseries import TimeSeriesRegistry

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
T0 = 1_000_000.0
FLEET_ALARMS = {"publisher_stale", "snapshot_backlog", "fold_error"}
#: the sketched curves' tolerance against the JAX package past the window
SKETCH_ATOL = 1e-6


class _Pkg:
    """One package's fleet API and metrics, fed the same numpy batches."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.obs = tobs if name == "port" else jobs

    def collection(self, kind: str = "acc_mse"):
        if self.name == "port":
            cpu = {"device": "cpu"}
            if kind == "acc_mse":
                return tm.MetricCollection(
                    {"acc": tm.classification.Accuracy(num_classes=2, **cpu), "mse": tm.MeanSquaredError(**cpu)}
                )
            if kind == "acc":
                return tm.MetricCollection({"acc": tm.classification.Accuracy(num_classes=2, **cpu)})
            if kind.startswith("cm"):
                return tm.MetricCollection({"cm": tm.ConfusionMatrix(num_classes=int(kind[2:]), **cpu)})
            if kind == "auroc":
                return tm.MetricCollection({"auroc": tm.AUROC(sketch_capacity=64, **cpu)})
            if kind == "sum":
                return tm.aggregation.SumMetric(**cpu)
        else:
            if kind == "acc_mse":
                return jm.MetricCollection({"acc": jm.classification.Accuracy(num_classes=2), "mse": jm.MeanSquaredError()})
            if kind == "acc":
                return jm.MetricCollection({"acc": jm.classification.Accuracy(num_classes=2)})
            if kind.startswith("cm"):
                return jm.MetricCollection({"cm": jm.classification.ConfusionMatrix(num_classes=int(kind[2:]))})
            if kind == "auroc":
                return jm.MetricCollection({"auroc": jm.AUROC(sketch_capacity=64)})
            if kind == "sum":
                return jm.aggregation.SumMetric()
        raise ValueError(kind)

    def tensor(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)) if self.name == "port" else jnp.asarray(x)

    def update(self, col, batch):
        col.update(*(self.tensor(x) for x in batch))

    def encode(self, col, **kw):
        return self.obs.encode_snapshot(states=self.obs.snapshot_states(col), states_template=col, **kw)

    def snapshots(self, pub_index, n_snaps, mode="state", kind="acc_mse", telemetry=None, batches=None):
        """Encoded snapshots of one publisher's evolving collection: each
        cumulative in ``"state"`` mode; in ``"delta"`` mode it resets after
        each publish."""
        col = self.collection(kind)
        out = []
        batches = batches if batches is not None else int_batches(100 + pub_index, n_snaps)
        for seq, batch in enumerate(batches):
            self.update(col, batch)
            out.append(
                self.encode(
                    col, publisher=f"pub{pub_index}", seq=seq, t=T0 + seq, host=f"h{pub_index}", process=pub_index,
                    mode=mode, telemetry=telemetry,
                )
            )
            if mode == "delta":
                col.reset()
        return out


PORT, JAX = _Pkg("port"), _Pkg("jax")


def int_batches(seed, n_batches, bs=16):
    """Integer-exact traffic: sum and count reducers fold bit for bit."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 2, bs).astype(np.int32), rng.randint(0, 2, bs).astype(np.int32)) for _ in range(n_batches)]


def score_batches(seed, n_batches, bs=16):
    rng = np.random.RandomState(seed)
    return [(rng.rand(bs).astype(np.float32), rng.randint(0, 2, bs).astype(np.int32)) for _ in range(n_batches)]


def _np(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.numpy()
    return np.asarray(leaf)


def assert_states_equal(a, b):
    assert set(a) == set(b)
    for m in a:
        assert set(a[m]) == set(b[m])
        for leaf in a[m]:
            x, y = _np(a[m][leaf]), _np(b[m][leaf])
            assert x.shape == y.shape and x.tobytes() == y.tobytes(), (m, leaf)


def states_of(pkg, col):
    return pkg.obs.snapshot_states(col)


def both(fn):
    """``fn(pkg)`` for the port and the JAX package."""
    return fn(PORT), fn(JAX)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

class TestTransport:
    def test_sink_writes_atomic_files_queue_consumes_once(self, tmp_path):
        sink = tobs.SnapshotSink(str(tmp_path), publisher="p0", host="h", process=0)
        sink.publish(telemetry={"process": 0})
        sink.publish(telemetry={"process": 0})
        queue = SnapshotQueue(str(tmp_path))
        assert queue.backlog() == 2
        assert len(queue.poll()) == 2
        assert queue.backlog() == 0 and queue.poll() == []
        assert all(not n.startswith(".") for n in os.listdir(tmp_path))

    def test_poll_cap_drains_oldest_first(self, tmp_path):
        sink = tobs.SnapshotSink(str(tmp_path), publisher="p0")
        for _ in range(5):
            sink.publish(telemetry={"process": 0})
        queue = SnapshotQueue(str(tmp_path))
        first = queue.poll(max_files=2)
        assert len(first) == 2 and queue.backlog() == 3
        assert [json.loads(blob)["seq"] for _, blob in first] == [0, 1]

    def test_sink_seq_monotonic_and_restart_offset(self, tmp_path):
        tobs.SnapshotSink(str(tmp_path), publisher="p0").publish(telemetry={"process": 0})
        tobs.SnapshotSink(str(tmp_path), publisher="p0", seq_start=100).publish(telemetry={"process": 0})
        assert sorted(json.loads(b)["seq"] for _, b in SnapshotQueue(str(tmp_path)).poll()) == [0, 100]

    def test_republish_last_is_byte_identical_dup(self, tmp_path):
        sink = tobs.SnapshotSink(str(tmp_path), publisher="p0")
        assert sink.republish_last() is None
        sink.publish(telemetry={"process": 0})
        dup = sink.republish_last()
        assert dup is not None and dup != sink.last_path
        blobs = [b for _, b in SnapshotQueue(str(tmp_path)).poll()]
        assert len(blobs) == 2 and blobs[0] == blobs[1]


# ---------------------------------------------------------------------------
# state-mode folding, single-job parity, parity with the JAX collector
# ---------------------------------------------------------------------------

class TestStateModeFold:
    def test_fold_matches_single_job_and_the_jax_fold(self, tmp_path):
        def run(pkg):
            d = tmp_path / pkg.name
            collector = pkg.obs.FleetCollector(str(d), template=pkg.collection())
            single = pkg.collection()
            for p in range(3):
                col = pkg.collection()
                sink = pkg.obs.SnapshotSink(str(d), publisher=f"pub{p}", host=f"h{p}", process=p)
                for batch in int_batches(p, 4):
                    pkg.update(col, batch)
                    pkg.update(single, batch)
                sink.publish(states=states_of(pkg, col), states_template=col, t=T0)
            collector.poll(now=T0)
            return collector, single

        (port, port_single), (ref, _) = both(run)
        folded = port.fold_states()
        assert_states_equal(folded, states_of(PORT, port_single))
        assert_states_equal(folded, ref.fold_states())
        values, want, ref_values = port.fold_values(), port_single.compute(), ref.fold_values()
        for k in want:
            assert float(values[k]) == float(want[k]) == pytest.approx(float(ref_values[k]))
            assert values[k].device.type == "cpu"
        assert port.totals() == ref.totals()

    def test_newest_sequence_wins_per_publisher(self):
        blobs = PORT.snapshots(0, 5)
        collector = tobs.FleetCollector(template=PORT.collection())
        for blob in blobs:
            collector.ingest(blob, now=T0)
        fresh = tobs.FleetCollector(template=PORT.collection())
        fresh.ingest(blobs[-1], now=T0)
        assert_states_equal(collector.fold_states(), fresh.fold_states())
        ref = jobs.FleetCollector(template=JAX.collection())
        for blob in JAX.snapshots(0, 5):
            ref.ingest(blob, now=T0)
        assert_states_equal(collector.fold_states(), ref.fold_states())

    @pytest.fixture
    def both_recorders(self):
        recs = (tobs.get_recorder(), jobs.get_recorder())
        for rec in recs:
            rec.reset()
            rec.enable()
        try:
            yield recs
        finally:
            for rec in recs:
                rec.disable()
                rec.reset()

    def test_telemetry_fold_matches_merge_payloads(self, both_recorders):
        m = tm.aggregation.SumMetric(device="cpu")
        m.update(torch.tensor([1.0]))
        payloads = []
        collector = tobs.FleetCollector(template=None)
        for p in range(3):
            payload = tobs.counter_payload(both_recorders[0])
            payload["process"] = p
            payloads.append(payload)
            collector.ingest(tobs.encode_snapshot(publisher=f"pub{p}", seq=0, t=T0, process=p, telemetry=payload), now=T0)
        merged = collector.merged_telemetry()
        expected = tobs.merge_payloads(payloads)
        for fam in ("call_counts", "sync_totals", "footprint_hwm", "call_times"):
            assert merged[fam] == expected[fam]
        assert merged["world_size"] == expected["world_size"]


# ---------------------------------------------------------------------------
# dedup and the late window
# ---------------------------------------------------------------------------

class TestDedupAndLateness:
    def test_duplicates_folded_exactly_once(self, tmp_path):
        def run(pkg):
            d = tmp_path / pkg.name
            sink = pkg.obs.SnapshotSink(str(d), publisher="p0")
            col = pkg.collection()
            pkg.update(col, int_batches(0, 1)[0])
            sink.publish(states=states_of(pkg, col), states_template=col, t=T0)
            sink.republish_last()
            sink.republish_last()
            collector = pkg.obs.FleetCollector(str(d), template=pkg.collection())
            collector.poll(now=T0)
            return collector, col

        (port, col), (ref, _) = both(run)
        assert port.totals()["absorbed"] == 1 and port.totals()["duplicates"] == 2
        assert port.totals() == ref.totals()
        assert_states_equal(port.fold_states(), states_of(PORT, col))
        assert_states_equal(port.fold_states(), ref.fold_states())

    def test_post_watermark_straggler_counted_and_dropped(self):
        def run(pkg):
            collector = pkg.obs.FleetCollector(template=pkg.collection(), late_window_s=5.0)
            fresh = pkg.snapshots(0, 1)[0]
            collector.ingest(fresh, now=T0)
            col = pkg.collection()
            pkg.update(col, int_batches(1, 1)[0])
            straggler = pkg.encode(col, publisher="pub9", seq=0, t=T0 - 30.0)
            assert not collector.ingest(straggler, now=T0)
            return collector, fresh

        (port, fresh), (ref, _) = both(run)
        assert port.totals()["late_dropped"] == 1 and port.totals() == ref.totals()
        clean = tobs.FleetCollector(template=PORT.collection())
        clean.ingest(fresh, now=T0)
        assert_states_equal(port.fold_states(), clean.fold_states())

    def test_in_window_late_arrival_folds(self):
        def run(pkg):
            collector = pkg.obs.FleetCollector(template=pkg.collection(), late_window_s=60.0)
            blobs = pkg.snapshots(0, 3)
            collector.ingest(blobs[2], now=T0)
            collector.ingest(blobs[0], now=T0)
            return collector

        port, ref = both(run)
        assert port.totals()["absorbed"] == 2 and port.totals()["late_dropped"] == 0
        assert port.totals() == ref.totals()


# ---------------------------------------------------------------------------
# delta mode
# ---------------------------------------------------------------------------

class TestDeltaMode:
    @pytest.mark.parametrize("order", [[0, 1, 2, 3], [3, 1, 0, 2]], ids=["in-order", "shuffled"])
    def test_delta_fold_in_seq_order_any_arrival(self, order):
        def run(pkg):
            blobs = pkg.snapshots(0, 4, mode="delta")
            collector = pkg.obs.FleetCollector(template=pkg.collection(), late_window_s=10.0)
            for i in order:
                collector.ingest(blobs[i], now=T0)
            collector.ingest(pkg.obs.encode_snapshot(publisher="pub0", seq=99, t=T0 + 100.0), now=T0 + 100.0)
            collector._advance()
            return collector.fold_states()

        port, ref = both(run)
        single = PORT.collection()
        for batch in int_batches(100, 4):
            PORT.update(single, batch)
        assert_states_equal(port, states_of(PORT, single))
        assert_states_equal(port, ref)

    def test_flush_pending_folds_in_window_deltas(self):
        def run(pkg):
            collector = pkg.obs.FleetCollector(template=pkg.collection(), late_window_s=1e9)
            for blob in pkg.snapshots(0, 3, mode="delta"):
                collector.ingest(blob, now=T0)
            assert collector.fold_states() is None
            collector.flush_pending()
            return collector.fold_states()

        port, ref = both(run)
        single = PORT.collection()
        for batch in int_batches(100, 3):
            PORT.update(single, batch)
        assert_states_equal(port, states_of(PORT, single))
        assert_states_equal(port, ref)

    def test_delta_duplicate_of_folded_seq_dropped(self):
        def run(pkg):
            blobs = pkg.snapshots(0, 2, mode="delta")
            collector = pkg.obs.FleetCollector(template=pkg.collection(), late_window_s=0.0)
            for blob in blobs:
                collector.ingest(blob, now=T0)
            collector._advance()
            before = collector.fold_states()
            assert not collector.ingest(blobs[0], now=T0)
            collector.flush_pending()
            assert_states_equal(collector.fold_states(), before)
            return collector

        port, ref = both(run)
        totals = port.totals()
        assert totals["duplicates"] + totals["late_dropped"] >= 1
        assert totals == ref.totals()
        assert_states_equal(port.fold_states(), ref.fold_states())


# ---------------------------------------------------------------------------
# sketch leaves: bit for bit inside the window, within tolerance past it
# ---------------------------------------------------------------------------

class TestSketchFold:
    @staticmethod
    def _template(pkg):
        # a sketched curve metric learns its data mode from its first batch
        col = pkg.collection("auroc")
        pkg.update(col, score_batches(999, 1)[0])
        col.reset()
        return col

    @pytest.mark.parametrize("batches_per_publisher", [1, 3], ids=["inside-window", "past-window"])
    def test_sketch_fold_against_the_jax_fold(self, batches_per_publisher):
        def run(pkg):
            collector = pkg.obs.FleetCollector(template=self._template(pkg))
            for p in range(3):
                blobs = pkg.snapshots(p, batches_per_publisher, kind="auroc", batches=score_batches(p, batches_per_publisher))
                collector.ingest(blobs[-1], now=T0)
            return collector

        port, ref = both(run)
        folded, want = port.fold_states(), ref.fold_states()
        if batches_per_publisher == 1:
            # 48 rows in a capacity-64 sketch: the concatenation, no compaction
            assert_states_equal(folded, want)
            single = self._template(PORT)
            for p in range(3):
                PORT.update(single, score_batches(p, 1)[0])
            assert_states_equal(folded, states_of(PORT, single))
        np.testing.assert_allclose(
            float(port.fold_values()["auroc"]), float(ref.fold_values()["auroc"]), atol=SKETCH_ATOL, rtol=0
        )

    def test_decoded_sketch_leaves_carry_their_occupancy(self):
        from metrics_tpu_torch.sketches.quantile import fill_bound

        collector = tobs.FleetCollector(template=self._template(PORT))
        for p in range(2):
            collector.ingest(PORT.snapshots(p, 1, kind="auroc", batches=score_batches(p, 1))[-1], now=T0)
        newest = [collector._pubs[f"pub{p}"].newest.states["auroc"]["csketch"] for p in range(2)]
        assert [fill_bound(s) for s in newest] == [16, 16]
        # the union fits the capacity: the merge packs, and the bound says so
        assert fill_bound(collector.fold_states()["auroc"]["csketch"]) == 32

    def test_an_untouched_sketched_template_cannot_compute_in_both(self):
        def run(pkg):
            collector = pkg.obs.FleetCollector(template=pkg.collection("auroc"))
            collector.ingest(pkg.snapshots(0, 1, kind="auroc", batches=score_batches(0, 1))[0], now=T0)
            return collector.fold_values(), collector.totals()["fold_errors"]

        (port_values, port_errors), (ref_values, ref_errors) = both(run)
        assert port_values == {} and ref_values == {} and port_errors == ref_errors == 1


# ---------------------------------------------------------------------------
# fold determinism
# ---------------------------------------------------------------------------

class TestFoldDeterminism:
    def test_any_arrival_order_bit_identical_state_and_exposition(self):
        rec = tobs.get_recorder()
        rec.reset()
        rec.enable()
        try:
            m = tm.aggregation.SumMetric(device="cpu")
            m.update(torch.tensor([1.0]))
            base_payload = tobs.counter_payload(rec)
        finally:
            rec.disable()
            rec.reset()
        blobs = []
        for p in range(3):
            blobs.extend(PORT.snapshots(p, 2, telemetry=dict(base_payload, process=p)))
        items = blobs + [blobs[0]]
        pages, folds = set(), []
        for order in itertools.islice(itertools.permutations(range(len(items))), 0, 24, 5):
            collector = tobs.FleetCollector(template=PORT.collection(), late_window_s=1e6)
            for i in order:
                collector.ingest(items[i], now=T0 + 10.0)
            assert collector.totals()["duplicates"] == 1
            folds.append(collector.fold_states())
            pages.add(collector.render_prometheus(include_collector_families=False, include_fold_values=True))
        for other in folds[1:]:
            assert_states_equal(folds[0], other)
        assert len(pages) == 1
        ref = jobs.FleetCollector(template=JAX.collection(), late_window_s=1e6)
        for p in range(3):
            for blob in JAX.snapshots(p, 2):
                ref.ingest(blob, now=T0 + 10.0)
        assert_states_equal(folds[0], ref.fold_states())

    def test_fold_matches_aggregate_across_hosts_semantics(self):
        rec = tobs.get_recorder()
        rec.reset()
        rec.enable()
        try:
            m = tm.aggregation.SumMetric(device="cpu")
            m.update(torch.tensor([2.0]))
            payloads = []
            for p in range(3):
                payload = tobs.counter_payload(rec)
                payload["process"] = p
                payload["publisher"] = f"pub{p}"
                payloads.append(payload)
            collector = tobs.FleetCollector(template=None)
            for p, payload in enumerate(payloads):
                collector.ingest(tobs.encode_snapshot(publisher=f"pub{p}", seq=0, t=T0, process=p, telemetry=payload), now=T0)
            merged = collector.merged_telemetry()
            assert tobs.render_prometheus(aggregate=merged) == tobs.render_prometheus(aggregate=tobs.merge_payloads(payloads))
        finally:
            rec.disable()
            rec.reset()


# ---------------------------------------------------------------------------
# hierarchy
# ---------------------------------------------------------------------------

class TestHierarchy:
    def test_two_tier_fold_equals_flat_fold(self, tmp_path):
        def run(pkg):
            root = tmp_path / pkg.name
            single = pkg.collection()
            children = []
            for rack in range(2):
                d = root / f"rack{rack}"
                child = pkg.obs.FleetCollector(str(d), template=pkg.collection())
                for p in range(2):
                    idx = rack * 2 + p
                    col = pkg.collection()
                    sink = pkg.obs.SnapshotSink(str(d), publisher=f"pub{idx}", process=idx)
                    for batch in int_batches(idx, 3):
                        pkg.update(col, batch)
                        pkg.update(single, batch)
                    sink.publish(states=states_of(pkg, col), states_template=col, t=T0)
                child.poll(now=T0)
                children.append(child)
            parent = pkg.obs.FleetCollector(str(root / "global"), template=pkg.collection())
            for rack, child in enumerate(children):
                sink = pkg.obs.SnapshotSink(str(root / "global"), publisher=f"rack{rack}", tier="rack")
                assert child.publish_fold(sink, t=T0) is not None
            parent.poll(now=T0)
            return parent, single

        (port, single), (ref, _) = both(run)
        assert_states_equal(port.fold_states(), states_of(PORT, single))
        assert_states_equal(port.fold_states(), ref.fold_states())
        assert [s.tier for s in port.publishers(now=T0)] == ["rack", "rack"]

    def test_publish_fold_empty_collector_is_noop(self, tmp_path):
        collector = tobs.FleetCollector(str(tmp_path / "q"), template=PORT.collection())
        assert collector.publish_fold(tobs.SnapshotSink(str(tmp_path / "parent"), publisher="rack0")) is None


# ---------------------------------------------------------------------------
# the fold_error boundary
# ---------------------------------------------------------------------------

class TestFoldErrors:
    def test_corrupt_file_counted_and_survived(self, tmp_path):
        def run(pkg):
            d = tmp_path / pkg.name
            d.mkdir()
            (d / "bad-000000000000.snap").write_bytes(b"garbage")
            sink = pkg.obs.SnapshotSink(str(d), publisher="p0")
            col = pkg.collection()
            pkg.update(col, int_batches(0, 1)[0])
            sink.publish(states=states_of(pkg, col), states_template=col, t=T0)
            collector = pkg.obs.FleetCollector(str(d), template=pkg.collection())
            collector.poll(now=T0)
            return collector

        port, ref = both(run)
        assert port.totals()["fold_errors"] == 1 and port.totals()["absorbed"] == 1
        assert port.fold_error_details and port.totals() == ref.totals()

    def test_states_without_template_is_fold_error(self):
        collector = tobs.FleetCollector(template=None)
        assert not collector.ingest(PORT.snapshots(0, 1)[0], now=T0)
        assert collector.totals()["fold_errors"] == 1

    def test_layout_skew_is_fold_error(self):
        collector = tobs.FleetCollector(template=PORT.collection("acc"))
        assert not collector.ingest(PORT.snapshots(0, 1)[0], now=T0)
        assert collector.totals()["fold_errors"] == 1
        assert "layout" in collector.fold_error_details[-1]

    def test_future_schema_is_fold_error(self):
        collector = tobs.FleetCollector(template=PORT.collection())
        doc = json.loads(PORT.snapshots(0, 1)[0].decode())
        doc["schema"] = 99
        assert not collector.ingest(json.dumps(doc).encode(), now=T0)
        assert collector.totals()["fold_errors"] == 1

    def test_shape_skew_refused_at_ingest(self):
        collector = tobs.FleetCollector(template=PORT.collection("cm3"))
        skew = PORT.collection("cm5")
        PORT.update(skew, (np.asarray([1, 0]), np.asarray([1, 1])))
        assert not collector.ingest(PORT.encode(skew, publisher="pub0", seq=0, t=T0), now=T0)
        assert collector.totals()["fold_errors"] == 1 and collector.fold_states() is None

    def test_poisonous_keyless_contribution_evicted_not_fatal(self):
        collector = tobs.FleetCollector(template=PORT.collection("cm3"))
        good = PORT.collection("cm3")
        PORT.update(good, (np.asarray([1, 0]), np.asarray([1, 1])))
        collector.ingest(PORT.encode(good, publisher="good", seq=0, t=T0), now=T0)
        skew = PORT.collection("cm5")
        PORT.update(skew, (np.asarray([1, 0]), np.asarray([1, 1])))
        poisoned = tobs.encode_snapshot(publisher="skewed", seq=0, t=T0, states=states_of(PORT, skew))
        assert collector.ingest(poisoned, now=T0)
        folded = collector.fold_states()
        assert folded is not None
        assert_states_equal(folded, states_of(PORT, good))
        assert collector.totals()["fold_errors"] == 1 and "skewed" in collector.fold_error_details[-1]
        assert collector.fold_states() is not None and collector.totals()["fold_errors"] == 1

    def test_error_details_ring_is_bounded(self):
        collector = tobs.FleetCollector(template=None)
        for _ in range(collector.MAX_ERROR_DETAILS + 10):
            collector.ingest(b"junk", now=T0)
        assert len(collector.fold_error_details) == collector.MAX_ERROR_DETAILS


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

class TestLiveness:
    def test_lag_and_staleness_with_injected_clock(self):
        now = [T0]
        collector = tobs.FleetCollector(template=PORT.collection(), stale_after_s=5.0, clock=lambda: now[0])
        collector.ingest(PORT.snapshots(0, 1)[0], now=T0)
        status = collector.publishers()[0]
        assert not status.stale and status.lag_s == pytest.approx(0.0)
        now[0] = T0 + 10.0
        status = collector.publishers()[0]
        assert status.stale and status.lag_s == pytest.approx(10.0)

    def test_retire_publisher_clears_staleness_until_next_snapshot(self):
        now = [T0 + 10.0]
        collector = tobs.FleetCollector(template=PORT.collection(), stale_after_s=5.0, clock=lambda: now[0])
        blobs = PORT.snapshots(0, 2)
        collector.ingest(blobs[0], now=T0)
        assert collector.publishers()[0].stale
        assert collector.retire_publisher("pub0")
        assert not collector.retire_publisher("unknown")
        status = collector.publishers()[0]
        assert status.retired and not status.stale
        collector.ingest(blobs[1], now=now[0])
        assert not collector.publishers()[0].retired


# ---------------------------------------------------------------------------
# recorder, health and Prometheus wiring, on injected clocks
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder():
    rec = tobs.get_recorder()
    rec.reset()
    rec.enable()
    try:
        yield rec
    finally:
        rec.disable()
        rec.detach_timeseries()
        rec.reset()


@pytest.fixture
def jax_recorder():
    rec = jobs.get_recorder()
    rec.reset()
    rec.enable()
    try:
        yield rec
    finally:
        rec.disable()
        rec.detach_timeseries()
        rec.reset()


class TestObservabilityWiring:
    def test_poll_feeds_fleet_series_and_totals(self, tmp_path, recorder):
        now = [T0]
        recorder.attach_timeseries(
            TimeSeriesRegistry(bucket_seconds=1.0, n_buckets=16, sketch_capacity=32, clock=lambda: now[0], device="cpu")
        )
        sink = tobs.SnapshotSink(str(tmp_path), publisher="p0")
        sink.publish(telemetry={"process": 0}, t=T0)
        sink.republish_last()
        (tmp_path / "bad-000000000099.snap").write_bytes(b"junk")
        collector = tobs.FleetCollector(str(tmp_path), template=None, recorder=recorder, clock=lambda: now[0])
        collector.poll(now=T0)
        totals = recorder.fleet_totals()
        assert (totals["absorbed"], totals["duplicates"], totals["fold_errors"]) == (1, 1, 1)
        ts = recorder.timeseries
        assert ts.get(SERIES_COLLECTOR_BACKLOG).count(None) == 1
        assert ts.get(SERIES_PUBLISHER_LAG).count(None) == 1
        assert ts.get(SERIES_FOLD_ERRORS).total(None) == 1.0

    def test_fleet_totals_ride_counter_payload_and_prometheus(self, recorder):
        recorder.record_fleet_poll(
            absorbed=5, duplicates=1, late_dropped=2, fold_errors=1, backlog=7, max_lag_s=3.5, publishers=3
        )
        payload = tobs.counter_payload(recorder)
        assert payload["fleet_totals"]["absorbed"] == 5 and payload["fleet_totals"]["max_backlog"] == 7
        merged = tobs.merge_payloads([payload, payload])
        assert merged["fleet_totals"]["absorbed"] == 10 and merged["fleet_totals"]["max_backlog"] == 7
        page = tobs.render_prometheus(recorder)
        assert 'metrics_tpu_fleet_ingest_total{outcome="absorbed"} 5' in page
        assert 'metrics_tpu_fleet_backlog_snapshots{window="max"} 7' in page
        assert tobs.merge_payloads([{"process": 1}, payload])["fleet_totals"]["absorbed"] == 5

    def test_three_fleet_alarm_classes_fire_and_clear_through_each_collector(self, tmp_path, recorder, jax_recorder):
        """A healthy phase, then a stalled publisher, a pile-up in the queue
        and a corrupt snapshot, then recovery: the collectors' own feed on
        the injected clock trips and clears all three alarm classes, in
        both packages at the same polls."""

        def run(pkg, rec, registry_cls, registry_kw):
            now = [T0]
            registry = registry_cls(bucket_seconds=1.0, n_buckets=64, sketch_capacity=32, clock=lambda: now[0], **registry_kw)
            rec.attach_timeseries(registry)
            monitor = pkg.obs.HealthMonitor(
                pkg.obs.default_rules(window_s=5.0, publisher_lag_limit_s=4.0, backlog_limit=10, fold_errors_per_window=1),
                registry=registry,
            )
            d = tmp_path / pkg.name
            collector = pkg.obs.FleetCollector(str(d), template=None, recorder=rec, clock=lambda: now[0], stale_after_s=4.0)
            sinks = [pkg.obs.SnapshotSink(str(d), publisher=f"p{i}") for i in range(2)]
            firing = []

            def tick(t, publishers=(0, 1), extra=0, corrupt=False):
                now[0] = T0 + t
                for i in publishers:
                    sinks[i].publish(telemetry={"process": i}, t=now[0])
                for j in range(extra):
                    sinks[0].republish_last()
                if corrupt:
                    (d / f"bad-{t:012d}.snap").write_bytes(b"junk")
                collector.poll(now=now[0])
                firing.append(sorted({a.name for a in monitor.evaluate(now=now[0]).firing} & FLEET_ALARMS))

            for t in range(3):
                tick(t)
            tick(3, publishers=(0,))  # p1 goes quiet
            tick(9, publishers=(0,), extra=40, corrupt=True)  # p1 stalled, a pile-up, a corrupt file
            for t in range(10, 20):
                tick(t)
            rec.detach_timeseries()
            return firing, set(monitor.fired_and_cleared()), collector.totals()

        port_firing, port_cleared, port_totals = run(PORT, recorder, TimeSeriesRegistry, {"device": "cpu"})
        jax_firing, jax_cleared, jax_totals = run(JAX, jax_recorder, JaxRegistry, {})
        assert port_firing[:3] == [[], [], []]
        assert set(port_firing[4]) == FLEET_ALARMS
        assert port_firing[-1] == []
        assert port_cleared >= FLEET_ALARMS
        assert port_firing == jax_firing and port_cleared == jax_cleared and port_totals == jax_totals

    def test_collector_prometheus_page_families(self, tmp_path, recorder):
        sink = tobs.SnapshotSink(str(tmp_path), publisher="p0", host="hostA")
        col = PORT.collection()
        PORT.update(col, int_batches(0, 1)[0])
        sink.publish(states=states_of(PORT, col), states_template=col, telemetry=tobs.counter_payload(recorder), t=T0)
        collector = tobs.FleetCollector(str(tmp_path), template=PORT.collection())
        collector.poll(now=T0)
        page = collector.render_prometheus(now=T0, include_fold_values=True)
        assert 'metrics_tpu_fleet_publisher_up{publisher="p0",host="hostA"} 1' in page
        assert 'metrics_tpu_fleet_snapshots_total{outcome="absorbed"} 1' in page
        assert 'metrics_tpu_fleet_metric_value{metric="acc"}' in page
        assert 'publisher="p0"' in page

    def test_periodic_exporter_publishes_heartbeat_snapshots(self, tmp_path, recorder):
        col = PORT.collection()
        PORT.update(col, int_batches(0, 1)[0])
        sink = tobs.SnapshotSink(str(tmp_path / "q"), publisher="svc0")
        exporter = tobs.PeriodicExporter(interval_s=30.0, snapshot_sink=sink, states_fn=lambda: col, recorder=recorder)
        exporter.export_once()
        exporter.export_once()  # an idle tick still heartbeats
        collector = tobs.FleetCollector(str(tmp_path / "q"), template=PORT.collection())
        collector.poll(now=T0)
        assert collector.totals()["absorbed"] == 2
        assert_states_equal(collector.fold_states(), states_of(PORT, col))
        assert collector.fold_telemetry()

    def test_periodic_exporter_dict_states_fn_carries_template_key(self, tmp_path, recorder):
        col = PORT.collection()
        PORT.update(col, int_batches(0, 1)[0])
        sink = tobs.SnapshotSink(str(tmp_path / "q"), publisher="svc0")
        exporter = tobs.PeriodicExporter(
            interval_s=30.0, snapshot_sink=sink, states_fn=lambda: states_of(PORT, col), states_template=col, recorder=recorder
        )
        exporter.export_once()
        ((_, blob),) = SnapshotQueue(str(tmp_path / "q")).poll()
        assert tobs.decode_snapshot(blob).states_key == tobs.states_key(col)

    def test_perfetto_draws_publisher_tracks_linked_to_the_fold(self, tmp_path, recorder):
        with tobs.span("publish_tick"):
            blob = PORT.snapshots(0, 1)[0]
        col = PORT.collection()
        PORT.update(col, int_batches(1, 1)[0])
        sink = tobs.SnapshotSink(str(tmp_path / "q"), publisher="pub1")
        with tobs.span("publish_tick"):
            sink.publish(states=states_of(PORT, col), states_template=col, t=T0)
        collector = tobs.FleetCollector(str(tmp_path / "q"), template=PORT.collection(), recorder=recorder)
        collector.ingest(blob, now=T0)
        collector.poll(now=T0)
        collector.fold_values()
        path = tobs.export_perfetto(str(tmp_path / "trace.json"), collector=collector)
        events = json.loads(Path(path).read_text())["traceEvents"]
        tracks = {e["args"]["name"] for e in events if e.get("name") == "process_name"}
        assert "publisher pub1" in tracks
        starts = [e for e in events if e.get("ph") == "s"]
        finishes = [e for e in events if e.get("ph") == "f"]
        assert starts and {e["id"] for e in finishes} <= {e["id"] for e in starts} and finishes


# ---------------------------------------------------------------------------
# real publisher processes
# ---------------------------------------------------------------------------

_PUBLISHER = """
import sys
import numpy as np
import torch
for name in ("jax", "jaxlib", "metrics_tpu"):
    sys.modules[name] = None
import metrics_tpu_torch as tm
from metrics_tpu_torch.observability import SnapshotSink, snapshot_states
directory, index = sys.argv[1], int(sys.argv[2])
col = tm.MetricCollection({"cm": tm.ConfusionMatrix(num_classes=4, device="cpu"), "mse": tm.MeanSquaredError(device="cpu")})
sink = SnapshotSink(directory, publisher=f"pub{index}", process=index)
rng = np.random.RandomState(200 + index)
for step in range(4):
    preds = rng.randint(0, 4, 32)
    target = rng.randint(0, 4, 32)
    col["cm"].update(torch.from_numpy(preds), torch.from_numpy(target))
    col["mse"].update(torch.from_numpy(preds.astype(np.float32)), torch.from_numpy(target.astype(np.float32)))
    if step % 2 == 1:
        sink.publish(states=snapshot_states(col), states_template=col, mode="delta", t=1000.0 + step + index / 10)
        col.reset()
print("published", index)
"""


def test_two_publisher_processes_fold_to_one_job(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _PUBLISHER, str(tmp_path / "q"), str(i)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    try:
        for i, proc in enumerate(procs):
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            assert f"published {i}" in out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    template = tm.MetricCollection({"cm": tm.ConfusionMatrix(num_classes=4, device="cpu"), "mse": tm.MeanSquaredError(device="cpu")})
    collector = tobs.FleetCollector(str(tmp_path / "q"), template=template, late_window_s=1e6)
    assert collector.poll(now=1010.0) == 4
    collector.flush_pending()
    assert collector.totals()["absorbed"] == 4 and collector.totals()["fold_errors"] == 0
    # one job over both processes' batches, in the port and in the JAX package
    single = tm.MetricCollection({"cm": tm.ConfusionMatrix(num_classes=4, device="cpu"), "mse": tm.MeanSquaredError(device="cpu")})
    ref_cm = jm.classification.ConfusionMatrix(num_classes=4)
    for index in range(2):
        rng = np.random.RandomState(200 + index)
        for _ in range(4):
            preds, target = rng.randint(0, 4, 32), rng.randint(0, 4, 32)
            single["cm"].update(torch.from_numpy(preds), torch.from_numpy(target))
            single["mse"].update(torch.from_numpy(preds.astype(np.float32)), torch.from_numpy(target.astype(np.float32)))
            ref_cm.update(jnp.asarray(preds), jnp.asarray(target))
    folded = collector.fold_states()
    assert torch.equal(folded["cm"]["confmat"], single["cm"].confmat)
    assert np.array_equal(folded["cm"]["confmat"].numpy(), np.asarray(ref_cm.confmat))
    values = collector.fold_values()
    assert float(values["mse"]) == float(single["mse"].compute())
