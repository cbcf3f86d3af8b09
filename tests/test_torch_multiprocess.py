"""Real cross-process sync of the port: two gloo processes on the CPU.

The counterpart of ``tests/bases/test_multiprocess.py``. One spawn of two
worker processes that join a ``torch.distributed`` gloo group and check, in
one run: ``gather_all_arrays`` (a scalar, even and uneven shapes, a rank
with zero rows, ``bool`` and ``bfloat16`` NaN payloads bit for bit), the
MSE and capacity ``AUROC`` lifecycles, an ``exact=True`` metric with an
empty rank (no rank waits), a sketched ``AUROC`` past its capacity,
``sync_pytree`` over a collection, a ``SlicedMetric(MSE, 16)`` sharded
over the two ranks (routed updates, a collective compute, a pass-through
sync that moves nothing), and the telemetry aggregate
(``aggregate_across_hosts``). The workers import no JAX: they write
what they synced to a file, and this process holds it against the JAX
package's sync of the same shards (a simulated world of two).
"""
import os
import socket
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
from metrics_tpu.functional.classification.auroc import auroc as jax_auroc
from metrics_tpu.functional.classification.exact_curve import binary_auroc_fixed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

_WORKER = r"""
import datetime, os, sys, warnings
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist

rank = int(os.environ["RANK"])
dist.init_process_group(
    "gloo", init_method=os.environ["INIT"], rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60)
)
sys.path.insert(0, os.environ["REPO"])
import metrics_tpu_torch as tm
from metrics_tpu_torch.parallel.distributed import (
    collective_counts, distributed_available, gather_all_arrays, reset_collective_counts, sync_pytree,
)
assert "jax" not in sys.modules
assert distributed_available()
out = {}

# gather_all_arrays
out["scalar"] = gather_all_arrays(torch.tensor(float(rank + 1)))
out["even"] = gather_all_arrays(torch.full((2, 3), rank, dtype=torch.float32))
rows = 2 if rank == 0 else 4
out["uneven"] = gather_all_arrays(torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3))
empty = torch.zeros((0,)) if rank == 0 else torch.arange(10, dtype=torch.int64).reshape(5, 2)
out["empty"] = gather_all_arrays(empty)
out["bool"] = gather_all_arrays(torch.tensor([True, False, rank == 1]))
# quiet NaNs with payloads of both signs, 1.0 and -0.0
payload = torch.tensor([0x7FC1 + rank, -61, 0x3F80, -32768], dtype=torch.int16).view(torch.bfloat16)
out["bf16"] = [g.view(torch.int16) for g in gather_all_arrays(payload)]
reset_collective_counts()
gather_all_arrays(torch.zeros(7, 3))
out["counts"] = collective_counts()

# MSE lifecycle: compute syncs, the local states come back
m = tm.MeanSquaredError(device="cpu")
if rank == 0:
    m.update(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 4.0]))
else:
    m.update(torch.tensor([0.0, 1.0, 2.0]), torch.tensor([6.0, 1.0, 2.0]))
out["mse"] = m.compute()
out["mse_local_total"] = m.total

# capacity AUROC: the buffer triple and the overflow tally
rng = np.random.default_rng(7)
preds_all = rng.random(12).astype(np.float32)
target_all = (rng.random(12) < 0.5).astype(np.int64)
target_all[:2] = [0, 1]
lo, hi = (0, 6) if rank == 0 else (6, 12)
cap = tm.AUROC(capacity=16, device="cpu")
cap.update(torch.from_numpy(preds_all[lo:hi]), torch.from_numpy(target_all[lo:hi]))
out["capacity"] = cap.compute()

# exact=True with an empty rank: rank 1 never updates, yet syncs
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    ex = tm.AUROC(exact=True, device="cpu")
if rank == 0:
    ex.update(torch.from_numpy(preds_all), torch.from_numpy(target_all))
    out["exact"] = ex.compute()
else:
    ex.sync()
    out["exact_rows"] = (ex.preds.clone(), ex.target.clone())
    ex.unsync()

# a sketched AUROC past its capacity: each rank overflows alone
sk = tm.AUROC(sketch_capacity=256, device="cpu")
srng = np.random.default_rng(100 + rank)
for _ in range(6):
    p = srng.random(100).astype(np.float32)
    t = (srng.random(100) < 0.3).astype(np.int64)
    sk.update(torch.from_numpy(p), torch.from_numpy(t))
sk.sync()
out["sketch"] = sk.csketch.clone()
out["sketch_seen"] = sk.n_seen.clone()
sk.unsync()
out["sketch_value"] = sk.compute()

# one-round sync of a collection
col = tm.MetricCollection(
    {"mse": tm.MeanSquaredError(device="cpu"), "cm": tm.ConfusionMatrix(num_classes=3, device="cpu"),
     "max": tm.MaxMetric(device="cpu")},
    compute_groups=False,
)
crng = np.random.default_rng(200 + rank)
x = crng.random(10).astype(np.float32)
labels = crng.integers(0, 3, 10)
col["mse"].update(torch.from_numpy(x), torch.from_numpy(x[::-1].copy()))
col["cm"].update(torch.from_numpy(labels), torch.from_numpy(labels[::-1].copy()))
col["max"].update(torch.from_numpy(x))
state = {name: {k: getattr(mm, k) for k in mm._defaults} for name, mm in col.items()}
reset_collective_counts()
out["pytree"] = sync_pytree(state, col.state_reductions())
out["pytree_counts"] = collective_counts()
out["pytree_inputs"] = {"x": x, "labels": labels}

# a sharded SlicedMetric(MSE, 16): routed updates, a collective compute,
# a pass-through sync
from metrics_tpu_torch.sliced import shard_sliced_states, sliced_partition_specs
shard = tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 16)
shard_sliced_states(shard, None)
reset_collective_counts()
for step in range(3):
    srng_ = np.random.default_rng(300 + 10 * rank + step)
    shard.update(torch.from_numpy(srng_.integers(0, 16, 12)), torch.from_numpy(srng_.integers(0, 8, 12).astype(np.float32)),
                 torch.from_numpy(srng_.integers(0, 8, 12).astype(np.float32)))
out["sharded_update_counts"] = collective_counts()
out["sharded_block"] = {k: getattr(shard, k).clone() for k in shard._defaults}
out["sharded_value"] = shard.compute()
sh_state = {k: getattr(shard, k) for k in shard._defaults}
reset_collective_counts()
synced = sync_pytree(sh_state, shard.state_reductions(), partition_specs=sliced_partition_specs(shard, None))
out["sharded_sync_counts"] = collective_counts()
out["sharded_passed"] = all(synced[k] is sh_state[k] for k in sh_state)

# telemetry: every rank's counters merged on every rank, the payloads as
# bytes through gather_all_arrays
from metrics_tpu_torch.observability import aggregate_across_hosts, get_recorder
rec = get_recorder()
rec.reset()
rec.enable()
rec.attach_timeseries(device="cpu", clock=lambda: 1000.0)
tel = tm.SumMetric(device="cpu")
for _ in range(rank + 1):
    tel.update(torch.tensor(1.0))
rec.timeseries.observe("lat", float(rank + 1), t=1000.0)
out["aggregate"] = aggregate_across_hosts(rec)
rec.disable()

torch.save(out, os.path.join(os.environ["OUT"], f"rank{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("sync")
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "INIT": init, "REPO": REPO, "OUT": str(out_dir)}
        env.pop("JAX_PLATFORMS", None)
        procs.append(
            subprocess.Popen([sys.executable, "-c", _WORKER], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        )
    logs = [b""] * len(procs)
    readers = [threading.Thread(target=lambda i=i: logs.__setitem__(i, procs[i].stdout.read())) for i in range(len(procs))]
    for t in readers:
        t.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        # a rank that fails ends the run: the other would wait in a collective
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in readers:
            t.join(10)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.decode(errors="replace")[-4000:]
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_gather_all_arrays_across_processes(worker_results):
    for out in worker_results:
        assert [float(x) for x in out["scalar"]] == [1.0, 2.0]
        assert [tuple(x.shape) for x in out["even"]] == [(2, 3), (2, 3)]
        assert float(out["even"][1][0, 0]) == 1.0
        assert [tuple(x.shape) for x in out["uneven"]] == [(2, 3), (4, 3)] and float(out["uneven"][1][3, 2]) == 11.0
        # the rank with zero rows takes the other's trailing shape and dtype
        assert [tuple(x.shape) for x in out["empty"]] == [(0, 2), (5, 2)]
        assert [x.dtype for x in out["empty"]] == [torch.int64, torch.int64]
        assert out["bool"][0].tolist() == [True, False, False] and out["bool"][1].tolist() == [True, False, True]
        for r, bits in enumerate(out["bf16"]):
            assert bits.tolist() == [0x7FC1 + r, -61, 0x3F80, -32768]
        # a header round (one host read) and one payload round
        assert out["counts"] == {"rounds": 2, "bytes_received": 2 * 11 * 8 + 2 * 7 * 3 * 4, "host_reads": 1}


def test_metric_lifecycles_across_processes(worker_results):
    rng = np.random.default_rng(7)
    preds_all = rng.random(12).astype(np.float32)
    target_all = (rng.random(12) < 0.5).astype(np.int64)
    target_all[:2] = [0, 1]
    want_cap = float(np.asarray(binary_auroc_fixed(jnp.asarray(preds_all), jnp.asarray(target_all), jnp.ones(12, bool))))
    want_exact = float(np.asarray(jax_auroc(jnp.asarray(preds_all), jnp.asarray(target_all))))
    for rank, out in enumerate(worker_results):
        assert abs(float(out["mse"]) - 40.0 / 5.0) < 1e-6
        assert int(out["mse_local_total"]) == (2 if rank == 0 else 3)
        assert abs(float(out["capacity"]) - want_cap) < 1e-6
    assert abs(float(worker_results[0]["exact"]) - want_exact) < 1e-6
    rows = worker_results[1]["exact_rows"]
    assert np.array_equal(rows[0].numpy(), preds_all) and np.array_equal(rows[1].numpy(), target_all)


def _jax_world(metrics):
    """The JAX package's sync of one metric per rank, a thread each."""
    n, slots = len(metrics), [None] * len(metrics)
    barrier = threading.Barrier(n, timeout=60)
    out, errors = [None] * n, []

    def run(rank):
        def gather(x, group=None):
            slots[rank] = x
            barrier.wait()
            got = list(slots)
            barrier.wait()
            return got

        try:
            m = metrics[rank]
            m.sync(dist_sync_fn=gather, distributed_available=lambda: True)
            out[rank] = {k: np.asarray(getattr(m, k)) for k in m._defaults}
            out[rank]["value"] = np.asarray(m._compute())
            m.unsync()
        except BaseException as e:  # noqa: BLE001 -- raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    return out


def test_sketch_past_capacity_matches_jax(worker_results):
    jax_metrics = []
    for rank in range(2):
        m = metrics_tpu.AUROC(sketch_capacity=256)
        srng = np.random.default_rng(100 + rank)
        for _ in range(6):
            p = srng.random(100).astype(np.float32)
            t = (srng.random(100) < 0.3).astype(np.int64)
            m.update(jnp.asarray(p), jnp.asarray(t))
        jax_metrics.append(m)
    want = _jax_world(jax_metrics)
    for rank, out in enumerate(worker_results):
        np.testing.assert_array_equal(out["sketch"].numpy().view(np.int32), want[rank]["csketch"].view(np.int32))
        assert int(out["sketch_seen"]) == int(want[rank]["n_seen"]) == 1200
        assert torch.equal(out["sketch"], worker_results[0]["sketch"])
    # compute() syncs again: every rank reads the merged sketch
    for out in worker_results:
        assert abs(float(out["sketch_value"]) - float(want[0]["value"])) < 1e-5


def test_sync_pytree_across_processes_matches_jax(worker_results):
    jax_cols = []
    for out in worker_results:
        x, labels = out["pytree_inputs"]["x"], out["pytree_inputs"]["labels"]
        mse, cm, mx = metrics_tpu.MeanSquaredError(), metrics_tpu.ConfusionMatrix(num_classes=3), metrics_tpu.MaxMetric()
        mse.update(jnp.asarray(x), jnp.asarray(x[::-1].copy()))
        cm.update(jnp.asarray(labels), jnp.asarray(labels[::-1].copy()))
        mx.update(jnp.asarray(x))
        jax_cols.append({"mse": mse, "cm": cm, "max": mx})
    want = {name: _jax_world([c[name] for c in jax_cols]) for name in ("mse", "cm", "max")}
    for rank, out in enumerate(worker_results):
        for name in ("mse", "cm", "max"):
            for k, v in out["pytree"][name].items():
                w = want[name][rank][k]
                assert v.dtype == torch.from_numpy(np.asarray(w)).dtype, (name, k)
                if np.issubdtype(w.dtype, np.floating) and name == "mse":
                    np.testing.assert_allclose(v.numpy(), w, rtol=1e-6)
                else:
                    np.testing.assert_array_equal(v.numpy(), w)
        # float32 sums, int32 sums and the max: three groups, one gather each
        assert out["pytree_counts"]["rounds"] == 3 and out["pytree_counts"]["host_reads"] == 0


def test_aggregate_across_hosts_merges_both_ranks_like_jax(worker_results):
    from metrics_tpu.observability import merge_payloads as jax_merge_payloads

    aggs = [out["aggregate"] for out in worker_results]
    for agg in aggs:
        assert agg["world_size"] == 2
        assert [p["process"] for p in agg["processes"]] == [0, 1]
        assert agg["call_counts"] == {("SumMetric", "update"): 3}
        (bucket,) = agg["timeseries"]["lat"]["buckets"]
        assert bucket["c"] == 2 and bucket["s"] == 3.0 and sorted(r[1] for r in bucket["sk"]) == [1.0, 2.0]
    # every rank merged the same payloads, as the JAX package merges them
    assert aggs[0]["processes"] == aggs[1]["processes"]
    assert aggs[0] == jax_merge_payloads(aggs[0]["processes"])


def test_sharded_sliced_metric_across_processes_matches_jax(worker_results):
    """Each rank's block of 8 slices and the gathered ``compute()`` against
    the JAX package's SlicedMetric fed each step's rows in rank order; one
    round per update (ids and rows of both ranks), none in the
    pass-through sync."""
    jm = metrics_tpu.sliced.SlicedMetric(metrics_tpu.MeanSquaredError(), num_slices=16)
    for step in range(3):
        cols = []
        for rank in range(2):
            r = np.random.default_rng(300 + 10 * rank + step)
            cols.append((r.integers(0, 16, 12), r.integers(0, 8, 12).astype(np.float32), r.integers(0, 8, 12).astype(np.float32)))
        jm.update(*(jnp.asarray(np.concatenate(c)) for c in zip(*cols)))
    want = np.asarray(jm.compute())
    for rank, out in enumerate(worker_results):
        for k, v in out["sharded_block"].items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jm, k))[rank * 8 : (rank + 1) * 8], err_msg=k)
        np.testing.assert_allclose(out["sharded_value"].numpy(), want, rtol=1e-6, equal_nan=True)
        # per update, 12 rows from each of 2 ranks: an 8-byte id and MSE's two
        # 4-byte leaves (the row counter's ones are not sent)
        assert out["sharded_update_counts"] == {"rounds": 3, "bytes_received": 3 * 2 * 12 * (8 + 2 * 4), "host_reads": 0}
        assert out["sharded_sync_counts"] == {"rounds": 0, "bytes_received": 0, "host_reads": 0}
        assert out["sharded_passed"]
