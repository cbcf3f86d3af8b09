"""Sharded state of the port against the JAX package's, on the CPU.

The JAX package shards a state over a device mesh from one controller; the
port shards it over a process group, one process per rank, with a
collective update. Simulated worlds (``tests/test_torch_distributed.py``'s
``World``: a thread per rank, the gather through ``dist_sync_fn``) hold:

* the spec functions (``match_partition_rules``, ``get_naive_slice_sharding``,
  ``sliced_partition_specs``, ``shard_sliced_states``) against the JAX
  package's on the same trees and world sizes, the specs compared as
  tuples; the layout-manifest consultation counters and the sync's
  layout-claim counters, with a planted implausible claim;
* a sharded ``SlicedMetric`` (MSE, PSNR, Accuracy, SumMetric) at 16 and
  1000 slices over worlds of 2 and 4 ranks: each rank's block and every
  rank's ``compute()``, ``compute(slice_ids=)`` and ``top_k`` against the
  JAX package's metric sharded over a W-device CPU mesh and fed each
  step's rank-order concatenation. The data are integer-valued floats, so
  every sum is exact whatever the order: states bit for bit, values within
  rtol 1e-6 (the two packages' ``log10`` and divisions);
* a sharded ``ConfusionMatrix(16)`` with ``P("rank", None)`` through
  update, compute and reset, and a composition's children, bit for bit;
* ``sync_pytree(partition_specs=)`` on a mixed tree against
  ``sync_pytree_in_mesh`` in ``shard_map``: the sharded leaf passes
  through (0 bytes in the sync event), the replicated one reduces;
* the refusals (a ``cat`` or ``merge`` leaf with a named axis, a leading
  dimension the world does not divide) and the fused update's decline.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import metrics_tpu
import metrics_tpu.sliced as jsliced
import metrics_tpu_torch as tm
from metrics_tpu.analysis import layout as jax_layout
from metrics_tpu.parallel.distributed import layout_verify_counters as jax_layout_verify_counters
from metrics_tpu.parallel.distributed import reset_layout_verify_counters as jax_reset_layout_verify_counters
from metrics_tpu.parallel.distributed import sync_pytree_in_mesh
from metrics_tpu.sliced.sharding import manifest_consultation_counters as jax_consultation_counters
from metrics_tpu.sliced.sharding import reset_manifest_consultation_counters as jax_reset_consultation_counters
from metrics_tpu.utils.compat import shard_map
from metrics_tpu_torch.analysis import layout as port_layout
from metrics_tpu_torch.observability import get_recorder
from metrics_tpu_torch.parallel.distributed import (
    PartitionSpec as P,
    RankMesh,
    RankSharding,
    layout_verify_counters,
    reset_layout_verify_counters,
    sync_pytree,
)
from metrics_tpu_torch.sliced import (
    SLICE_ROWS,
    SlicedMetric,
    get_naive_slice_sharding,
    match_partition_rules,
    shard_sliced_states,
    slice_partition_rules,
    sliced_partition_specs,
)
from metrics_tpu_torch.sliced.sharding import manifest_consultation_counters, reset_manifest_consultation_counters
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.test_torch_distributed import World

torch.set_num_threads(2)

PORT_MANIFEST = pathlib.Path(port_layout.default_layout_manifest_path())


@pytest.fixture(autouse=True)
def _clean_counters():
    for fn in (port_layout.invalidate_layout_cache, jax_layout.invalidate_layout_cache):
        fn()
    for fn in (
        reset_manifest_consultation_counters,
        reset_layout_verify_counters,
        jax_reset_consultation_counters,
        jax_reset_layout_verify_counters,
    ):
        fn()
    yield
    port_layout.invalidate_layout_cache()
    jax_layout.invalidate_layout_cache()


@pytest.fixture
def recorder():
    """The port's recorder enabled for one test, disabled and reset after."""
    rec = get_recorder()
    rec.reset()
    rec.enable()
    try:
        yield rec
    finally:
        rec.disable()
        rec.detach_timeseries()
        rec.reset()


def _mesh(n, axis="slices"):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def _spec(s):
    return tuple(s)


# ---------------------------------------------------------------------------
# the spec functions
# ---------------------------------------------------------------------------


def test_match_partition_rules_paths_agree():
    tree_np = {"m": {"sliced/total": np.zeros(16, np.float32), "scalar": np.float32(0.0), "plain": np.zeros(3, np.float32)}}
    got = match_partition_rules(slice_partition_rules("slices"), {"m": {k: torch.from_numpy(np.asarray(v)) for k, v in tree_np["m"].items()}})
    want = jsliced.match_partition_rules(jsliced.slice_partition_rules("slices"), {"m": {k: jnp.asarray(v) for k, v in tree_np["m"].items()}})
    assert {k: _spec(v) for k, v in got["m"].items()} == {k: _spec(v) for k, v in want["m"].items()}
    assert got["m"]["sliced/total"] == P("slices") and got["m"]["scalar"] == P() and got["m"]["plain"] == P()
    with pytest.raises(MetricsUserError, match="no partition rule"):
        match_partition_rules(((r"^only-this$", P()),), {"other": torch.zeros(4)})
    assert [(pat, _spec(s)) for pat, s in slice_partition_rules("x")] == [
        (pat, _spec(s)) for pat, s in jsliced.slice_partition_rules("x")
    ]


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("rows", [16, 10, 3, 1000])
def test_naive_slice_sharding_divisibility_agrees(world, rows):
    got = get_naive_slice_sharding(torch.zeros(rows), RankMesh(rank=0, world_size=world))
    want = jsliced.get_naive_slice_sharding(jnp.zeros(rows), _mesh(world))
    assert _spec(got.spec) == _spec(want.spec)
    assert got.world_size == world


@pytest.mark.parametrize("num_slices", [10, 13, 16, 64])
def test_partition_specs_follow_replication_fallback(num_slices):
    mesh = _mesh(8)
    jm = jsliced.SlicedMetric(metrics_tpu.MeanSquaredError(), num_slices=num_slices)
    want_shard = jsliced.shard_sliced_states(jm, mesh)
    want_specs = jsliced.sliced_partition_specs(jm, mesh)
    tmesh = RankMesh(rank=3, world_size=8)
    m = SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices)
    got_shard = shard_sliced_states(m, tmesh)
    got_specs = sliced_partition_specs(m, tmesh)
    assert {k: _spec(v.spec) for k, v in got_shard.items()} == {k: _spec(v.spec) for k, v in want_shard.items()}
    assert {k: _spec(v) for k, v in got_specs.items()} == {k: _spec(v) for k, v in want_specs.items()}
    sharded = num_slices % 8 == 0
    assert m.sum_squared_error.shape == ((num_slices // 8,) if sharded else (num_slices,))


def _port_probe_specs(monkeypatch, m, mesh):
    with monkeypatch.context() as mp:
        mp.setenv("METRICS_TPU_TORCH_NO_MANIFEST", "1")
        port_layout.invalidate_layout_cache()
        specs = sliced_partition_specs(m, mesh)
    port_layout.invalidate_layout_cache()
    return specs


def _counters_after(fn_port, fn_jax):
    reset_manifest_consultation_counters()
    jax_reset_consultation_counters()
    out = fn_port(), fn_jax()
    return out, manifest_consultation_counters(), jax_consultation_counters()


@pytest.mark.parametrize(
    "case",
    ["sliced64", "sliced13", "plain", "invisible"],
)
def test_manifest_consultation_agrees(monkeypatch, case):
    """The consultation's specs and its counters, case for case with the
    JAX package's on its own manifest (tests/bases/test_layout_manifest.py)."""
    tmesh, jmesh = RankMesh(rank=0, world_size=8), _mesh(8)
    if case.startswith("sliced"):
        n = int(case[6:])
        pm, jm = SlicedMetric(tm.MeanSquaredError(device="cpu"), n), jsliced.SlicedMetric(metrics_tpu.MeanSquaredError(), n)
    elif case == "plain":
        pm, jm = tm.MeanSquaredError(device="cpu"), metrics_tpu.MeanSquaredError()
    else:  # StatScores registers its leaves in a loop: no manifest can vouch
        pm, jm = tm.Accuracy(num_classes=3, device="cpu"), metrics_tpu.Accuracy(num_classes=3)
    (got, want), pc, jc = _counters_after(lambda: sliced_partition_specs(pm, tmesh), lambda: jsliced.sliced_partition_specs(jm, jmesh))
    assert {k: _spec(v) for k, v in got.items()} == {k: _spec(v) for k, v in want.items()}
    assert pc == jc
    assert got == _port_probe_specs(monkeypatch, pm, tmesh)


def test_shard_sliced_states_fast_path_and_custom_rules(monkeypatch):
    tmesh = RankMesh(rank=1, world_size=8)
    fast_m = SlicedMetric(tm.MeanSquaredError(device="cpu"), 64)
    reset_manifest_consultation_counters()
    fast = shard_sliced_states(fast_m, tmesh)
    assert manifest_consultation_counters()["probe_skips"] == 1
    with monkeypatch.context() as mp:
        mp.setenv("METRICS_TPU_TORCH_NO_MANIFEST", "1")
        port_layout.invalidate_layout_cache()
        probe_m = SlicedMetric(tm.MeanSquaredError(device="cpu"), 64)
        probed = shard_sliced_states(probe_m, tmesh)
    port_layout.invalidate_layout_cache()
    assert fast == probed
    assert all(s == RankSharding(tmesh, P("slices")) for s in fast.values())
    reset_manifest_consultation_counters()
    shard_sliced_states(SlicedMetric(tm.MeanSquaredError(device="cpu"), 64), tmesh, rules=slice_partition_rules())
    assert manifest_consultation_counters()["probe_skips"] == 0


def test_verify_mode_cross_checks_and_catches_divergence(monkeypatch):
    tmesh, jmesh = RankMesh(rank=0, world_size=8), _mesh(8)
    monkeypatch.setenv("METRICS_TPU_TORCH_VERIFY_MANIFEST", "1")
    monkeypatch.setenv("METRICS_TPU_VERIFY_MANIFEST", "1")
    m = SlicedMetric(tm.MeanSquaredError(device="cpu"), 64)
    reset_manifest_consultation_counters()
    specs = sliced_partition_specs(m, tmesh)
    assert manifest_consultation_counters() == {"probe_skips": 0, "stale_fallbacks": 0, "verify_mismatches": 0}
    assert all(s == P("slices") for s in specs.values())
    # the manifest's arithmetic sees 13 slices, the live states have 64 rows
    pm, jm = SlicedMetric(tm.MeanSquaredError(device="cpu"), 64), jsliced.SlicedMetric(metrics_tpu.MeanSquaredError(), 64)
    pm.num_slices = jm.num_slices = 13
    with pytest.warns(UserWarning, match="disagree with the probe"):
        (got, want), pc, jc = _counters_after(lambda: sliced_partition_specs(pm, tmesh), lambda: jsliced.sliced_partition_specs(jm, jmesh))
    assert pc == jc == {"probe_skips": 0, "stale_fallbacks": 0, "verify_mismatches": 1}
    assert {k: _spec(v) for k, v in got.items()} == {k: _spec(v) for k, v in want.items()}
    assert all(s == P("slices") for s in got.values())  # the probe's verdict


def test_stale_manifest_file_falls_back(monkeypatch, tmp_path):
    doctored = json.loads(PORT_MANIFEST.read_text())
    del doctored["classes"]["regression/mse.py::MeanSquaredError"]["leaves"]["total"]
    stale = tmp_path / "layout_manifest.json"
    stale.write_text(json.dumps(doctored))
    monkeypatch.setenv(port_layout.ENV_LAYOUT_MANIFEST_PATH, str(stale))
    port_layout.invalidate_layout_cache()
    m = SlicedMetric(tm.MeanSquaredError(device="cpu"), 64)
    reset_manifest_consultation_counters()
    specs = sliced_partition_specs(m, RankMesh(rank=0, world_size=8))
    assert manifest_consultation_counters() == {"probe_skips": 0, "stale_fallbacks": 1, "verify_mismatches": 0}
    assert all(s == P("slices") for s in specs.values())


def test_failed_gather_is_not_a_stale_manifest():
    """Sharding a metric that took batches gathers every rank's
    accumulation; a gather that fails raises at once, with no stale-manifest
    warning and no second entry into the collective."""
    calls = []

    def failing_gather(value, group=None):
        calls.append(value.shape)
        raise RuntimeError("gather failed")

    m = SlicedMetric(tm.MeanSquaredError(device="cpu"), 64, dist_sync_fn=failing_gather)
    m.update(torch.tensor([0, 9]), torch.tensor([1.0, 2.0]), torch.tensor([0.0, 0.0]))
    reset_manifest_consultation_counters()
    with pytest.raises(RuntimeError, match="gather failed"):
        shard_sliced_states(m, RankMesh(rank=0, world_size=8))
    assert len(calls) == 1
    assert manifest_consultation_counters() == {"probe_skips": 1, "stale_fallbacks": 0, "verify_mismatches": 0}
    assert not m._shardings and m.sum_squared_error.shape == (64,)


def _replicated_only_leaf():
    """A leaf name the port's layout manifest knows only as replicated."""
    data = json.loads(PORT_MANIFEST.read_text())
    return next(
        name
        for entry in data["classes"].values()
        for name, rec in entry["leaves"].items()
        if rec["shard_axis"] == port_layout.AXIS_REPLICATED and not port_layout.leaf_shard_axes(name)
    )


@pytest.mark.parametrize("claim", ["off", "plausible", "implausible"])
def test_layout_claim_counters(monkeypatch, claim):
    """The sync's audit of sharded claims, as the JAX package's
    ``TestSyncVerify``: off by default; a plausible claim checked; a
    planted implausible one warned, counted and still passed through."""
    leaf = {"off": "data_leaf_unknown", "plausible": SLICE_ROWS, "implausible": _replicated_only_leaf()}[claim]
    if claim != "off":
        monkeypatch.setenv("METRICS_TPU_TORCH_VERIFY_MANIFEST", "1")
    block = torch.arange(16, dtype=torch.float32)
    run = lambda: sync_pytree(  # noqa: E731
        {"m": {leaf: block}},
        {"m": {leaf: "sum"}},
        dist_sync_fn=lambda x, group=None: [x, x],
        partition_specs={"m": {leaf: P("slices")}},
        axis_name="slices",
    )
    if claim == "implausible":
        with pytest.warns(UserWarning, match="knows it only as replicated"):
            out = run()
    else:
        out = run()
    assert out["m"][leaf] is block
    counters = layout_verify_counters()
    if claim == "off":
        assert counters == {"claims_checked": 0, "implausible_claims": 0}
    else:
        assert counters["claims_checked"] == 1
        assert counters["implausible_claims"] == (1 if claim == "implausible" else 0)


def test_device_mesh_axis_is_the_group():
    """A ``DeviceMesh`` with the named axis stands for its group (a
    one-process gloo group here); an axis it lacks raises."""
    import socket

    from torch.distributed.device_mesh import init_device_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("slices",))
        resolved = get_naive_slice_sharding(torch.zeros(16), mesh)
        assert resolved.spec == P("slices") and (resolved.rank, resolved.world_size) == (0, 1)
        m = SlicedMetric(tm.MeanSquaredError(device="cpu"), 16)
        shardings = shard_sliced_states(m, mesh)
        assert all(s.spec == P("slices") for s in shardings.values()) and m.sum_squared_error.shape == (16,)
        m.update(torch.tensor([3, 3]), torch.tensor([1.0, 2.0]), torch.tensor([0.0, 0.0]))
        assert float(m.compute()[3]) == 2.5
        with pytest.raises(MetricsUserError, match="no axis 'rank'"):
            get_naive_slice_sharding(torch.zeros(16), mesh, axis_name="rank")
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# sharded SlicedMetric against the JAX package's over a W-device mesh
# ---------------------------------------------------------------------------

N_CLASSES = 4


def _sliced_batches(kind, num_slices, world, steps=3, rows=24, seed=0):
    """Per step, per rank: (ids, *args) as numpy, integer-valued floats."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        step = []
        for _ in range(world):
            ids = rng.integers(-1, num_slices + 1, rows)  # a few ids out of range drop
            if kind == "acc":
                p = rng.random((rows, N_CLASSES)).astype(np.float32)
                args = (p / p.sum(-1, keepdims=True), rng.integers(0, N_CLASSES, rows).astype(np.int32))
            elif kind == "sum":
                args = (rng.integers(0, 8, rows).astype(np.float32),)
            elif kind == "psnr":
                target = rng.integers(0, 8, (rows, 2, 3)).astype(np.float32)
                args = (target + rng.integers(-2, 3, (rows, 2, 3)).astype(np.float32), target)
            else:
                args = (rng.integers(0, 8, rows).astype(np.float32), rng.integers(0, 8, rows).astype(np.float32))
            step.append((ids,) + args)
        out.append(step)
    return out


def _template(pkg, kind, **kw):
    return {
        "mse": lambda: pkg.MeanSquaredError(**kw),
        "psnr": lambda: pkg.PeakSignalNoiseRatio(**kw),
        "acc": lambda: pkg.Accuracy(**kw),
        "sum": lambda: pkg.SumMetric(nan_strategy="ignore", **kw),
    }[kind]()


def _jax_reference(kind, num_slices, world, batches):
    m = jsliced.SlicedMetric(_template(metrics_tpu, kind), num_slices=num_slices)
    jsliced.shard_sliced_states(m, _mesh(world))
    for step in batches:
        cols = list(zip(*step))
        m.update(*(jnp.asarray(np.concatenate(c)) for c in cols))
    return m


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("num_slices", [16, 1000])
@pytest.mark.parametrize("kind", ["mse", "psnr", "acc", "sum"])
def test_sharded_sliced_metric_matches_jax_mesh(kind, num_slices, world):
    batches = _sliced_batches(kind, num_slices, world)
    jm = _jax_reference(kind, num_slices, world, batches)
    want_value = np.asarray(jm.compute())
    subset = np.array([0, num_slices - 1, 3, num_slices // 2, 3])
    want_subset = np.asarray(jm.compute(slice_ids=jnp.asarray(subset)))
    want_top_ids, want_top = (np.asarray(x) for x in jm.compute(top_k=5))

    def body(rank, gather):
        m = SlicedMetric(_template(tm, kind, device="cpu"), num_slices, dist_sync_fn=gather)
        shard_sliced_states(m, RankMesh(rank=rank, world_size=world))
        for step in batches:
            m.update(*(torch.from_numpy(x) for x in step[rank]))
        block = {k: getattr(m, k).clone() for k in m._defaults}
        top_ids, top = m.compute(top_k=5)
        return block, m.compute(), m.compute(slice_ids=torch.from_numpy(subset)), top_ids, top, m.slice_counts

    results = World(world).run(body)
    rows = num_slices // world
    for rank, (block, value, sub, top_ids, top, counts) in enumerate(results):
        for name, got in block.items():
            want = np.asarray(getattr(jm, name))[rank * rows : (rank + 1) * rows]
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"rank {rank} {name}")
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jm.slice_counts))
        for got, want in ((value, want_value), (sub, want_subset), (top, want_top)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0, equal_nan=True)
        np.testing.assert_array_equal(top_ids.numpy(), want_top_ids)
        # every rank the same bits
        assert value.numpy().tobytes() == results[0][1].numpy().tobytes()


@pytest.mark.parametrize("how", ["sync", "sync_context", "passthrough", "mixed"])
def test_sharded_sliced_reads_while_synced(how):
    """Reads of a sharded metric while it is synced: after a full sync the
    states are the whole ``[S]`` and global ids index them; after a
    pass-through sync they are still the rank's blocks and reads take the
    owner route. ``compute()`` refuses a synced metric, as the base's does,
    and gives the whole ``[S]`` again after ``unsync``. A sync that gathered
    some states and passed others leaves nothing to read."""
    world, num_slices = 2, 16
    batches = _sliced_batches("mse", num_slices, world)
    jm = _jax_reference("mse", num_slices, world, batches)
    subset = np.array([3, 12, 9, 0, num_slices - 1])
    want_value = np.asarray(jm.compute())
    want_subset = np.asarray(jm.compute(slice_ids=jnp.asarray(subset)))
    want_top_ids, want_top = (np.asarray(x) for x in jm.compute(top_k=5))

    def body(rank, gather):
        mesh = RankMesh(rank=rank, world_size=world)
        m = SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices, dist_sync_fn=gather)
        shard_sliced_states(m, mesh)
        for step in batches:
            m.update(*(torch.from_numpy(x) for x in step[rank]))
        specs = sliced_partition_specs(m, mesh)

        def reads():
            with pytest.raises(MetricsUserError, match="already been synced"):
                m.compute()
            top_ids, top = m.compute(top_k=5)
            return m.compute(slice_ids=torch.from_numpy(subset)), top_ids, top, m.slice_counts.clone()

        if how == "sync_context":
            with m.sync_context():
                got = reads()
        elif how == "mixed":
            m.sync(partition_specs={SLICE_ROWS: specs[SLICE_ROWS]}, axis_name="slices")
            with pytest.raises(MetricsUserError, match="gathered some of its states"):
                m.compute(slice_ids=torch.from_numpy(subset))
            m.unsync()
            return None
        else:
            m.sync(**({"partition_specs": specs, "axis_name": "slices"} if how == "passthrough" else {}))
            got = reads()
            m.unsync()
        return got + (m.compute(), tuple(m.sum_squared_error.shape))

    for out in World(world).run(body):
        if how == "mixed":
            assert out is None
            continue
        sub, top_ids, top, counts, value, block_shape = out
        assert block_shape == (num_slices // world,)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jm.slice_counts))
        np.testing.assert_array_equal(top_ids.numpy(), want_top_ids)
        for got, want in ((sub, want_subset), (top, want_top), (value, want_value)):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0, equal_nan=True)


def test_sharded_hot_rows_count_only_held_slices(recorder):
    """The hot-slice row count of a sharded update counts the rows of the
    rank's own slices: rows of other ranks' blocks fall in none of them."""
    world, num_slices = 2, 8
    ids = [np.array([1] * 6 + [5] * 2), np.array([6] * 3 + [2] * 5)]
    recorder.attach_timeseries(device="cpu", clock=lambda: 50.0)

    def body(rank, gather):
        m = SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices, dist_sync_fn=gather)
        shard_sliced_states(m, RankMesh(rank=rank, world_size=world))
        m.update(torch.from_numpy(ids[rank]), torch.zeros(8), torch.ones(8))

    World(world).run(body)
    scatters = [e for e in recorder.events() if e["type"] == "sliced_scatter"]
    # rank 0 holds slices 0-3 (slice 1: 6 rows), rank 1 slices 4-7 (slice 6: 3 rows)
    assert sorted(e["hot_rows"] for e in scatters) == [3, 6]
    assert all(e["n_rows"] == 16 for e in scatters)


def test_sharded_sliced_reset_clone_and_lifecycle():
    """reset keeps the blocks; clone, to_device, set_dtype, state_footprint
    (the rank's bytes), merge_states, persistent and a state_dict round
    trip on a sharded metric."""
    world, num_slices = 2, 16
    batches = _sliced_batches("mse", num_slices, world, steps=2)

    def body(rank, gather):
        m = SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices, dist_sync_fn=gather)
        shard_sliced_states(m, RankMesh(rank=rank, world_size=world))
        for step in batches:
            m.update(*(torch.from_numpy(x) for x in step[rank]))
        out = {"footprint": m.state_footprint(), "saved": m.state_dict()}
        twin = m.clone()
        assert twin._shardings == m._shardings
        out["merged"] = m.merge_states(m.state_dict(), twin.state_dict())
        m.persistent(True)
        out["persistent"] = dict(m._persistent)
        m.reset()
        out["reset_shape"] = tuple(m.sum_squared_error.shape)
        out["reset_dirty"] = tuple(m._dirty.shape)
        m.load_state_dict(out["saved"])
        out["restored"] = m.compute()
        twin.to_device("cpu")
        out["moved_dirty"] = tuple(twin._dirty.shape)
        twin.set_dtype(torch.float64)
        out["float64"] = twin.compute()
        return out

    results = World(world).run(body)
    one = SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices)
    for step in batches:
        one.update(*(torch.from_numpy(np.concatenate(c)) for c in zip(*step)))
    for rank, out in enumerate(results):
        lo, hi = rank * 8, (rank + 1) * 8
        assert out["footprint"] == {"sliced/sum_squared_error": 32, "sliced/total": 32, f"sliced/{SLICE_ROWS}": 32}
        assert out["reset_shape"] == (8,) and out["reset_dirty"] == (9,) and out["moved_dirty"] == (9,)
        assert torch.equal(out["merged"]["sum_squared_error"], 2 * one.sum_squared_error[lo:hi])
        assert all(out["persistent"].values())
        assert torch.equal(out["restored"], one.compute())
        assert out["float64"].dtype == torch.float64
        np.testing.assert_allclose(out["float64"].numpy(), one.compute().numpy(), rtol=1e-6)


def test_sharded_sliced_forward_is_the_world_batch():
    world, num_slices = 2, 16
    batches = _sliced_batches("mse", num_slices, world, steps=1)

    def body(rank, gather):
        m = SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices, dist_sync_fn=gather)
        shard_sliced_states(m, RankMesh(rank=rank, world_size=world))
        return m(*(torch.from_numpy(x) for x in batches[0][rank]))

    one = SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices)
    want = one(*(torch.from_numpy(np.concatenate(c)) for c in zip(*batches[0])))
    for got in World(world).run(body):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# a sharded ConfusionMatrix: the generic delta route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_confusion_matrix_matches_jax_mesh(world):
    rng = np.random.default_rng(0)
    preds = [rng.integers(0, 16, 50) for _ in range(world)]
    target = [rng.integers(0, 16, 50) for _ in range(world)]
    jm = metrics_tpu.ConfusionMatrix(num_classes=16)
    jmesh = _mesh(world, "rank")
    jm.shard_states(NamedSharding(jmesh, JP("rank", None)))
    jm.update(jnp.asarray(np.concatenate(preds)), jnp.asarray(np.concatenate(target)))
    want = np.asarray(jm.compute())
    jm.reset()
    assert _spec(jm.confmat.sharding.spec) == ("rank", None)

    def body(rank, gather):
        mesh = RankMesh(rank=rank, world_size=world)
        m = tm.ConfusionMatrix(num_classes=16, device="cpu", dist_sync_fn=gather)
        m.shard_states(RankSharding(mesh, P("rank", None)))
        m.update(torch.from_numpy(preds[rank]), torch.from_numpy(target[rank]))
        block, value = m.confmat.clone(), m.compute()
        m.reset()
        reset_shape = tuple(m.confmat.shape)
        m.update(torch.from_numpy(preds[rank]), torch.from_numpy(target[rank]))
        again = m.compute()
        comp = tm.ConfusionMatrix(num_classes=16, device="cpu", dist_sync_fn=gather) + tm.ConfusionMatrix(
            num_classes=16, device="cpu", dist_sync_fn=gather
        )
        comp.shard_states(RankSharding(mesh, P("rank", None)))
        comp.update(torch.from_numpy(preds[rank]), torch.from_numpy(target[rank]))
        shapes = (tuple(comp.metric_a.confmat.shape), tuple(comp.metric_b.confmat.shape))
        return block, value, reset_shape, again, shapes, comp.compute()

    rows = 16 // world
    for rank, (block, value, reset_shape, again, shapes, comp) in enumerate(World(world).run(body)):
        np.testing.assert_array_equal(block.numpy(), want[rank * rows : (rank + 1) * rows])
        np.testing.assert_array_equal(value.numpy(), want)
        assert reset_shape == (rows, 16) and shapes == ((rows, 16), (rows, 16))
        np.testing.assert_array_equal(again.numpy(), want)
        np.testing.assert_array_equal(comp.numpy(), 2 * want)


def test_sharding_after_updates_folds_every_rank():
    """A metric sharded after it took batches folds every rank's local
    accumulation into its block (the JAX package's state is global)."""
    world = 2
    rng = np.random.default_rng(1)
    preds = [rng.integers(0, 8, 40) for _ in range(world)]
    target = [rng.integers(0, 8, 40) for _ in range(world)]

    def body(rank, gather):
        m = tm.ConfusionMatrix(num_classes=8, device="cpu", dist_sync_fn=gather)
        m.update(torch.from_numpy(preds[rank]), torch.from_numpy(target[rank]))
        m.shard_states(RankSharding(RankMesh(rank=rank, world_size=world), P("rank", None)))
        return m.confmat.clone(), m.compute()

    want = np.zeros((8, 8), np.int64)
    np.add.at(want, (np.concatenate(target), np.concatenate(preds)), 1)
    for rank, (block, value) in enumerate(World(world).run(body)):
        np.testing.assert_array_equal(block.numpy(), want[rank * 4 : (rank + 1) * 4])
        np.testing.assert_array_equal(value.numpy(), want)


class _Extrema(tm.Metric):
    """Per-position running max (float32) and min (int32)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("hi", default=torch.full((8,), -1.0), dist_reduce_fx="max")
        self.add_state("lo", default=torch.full((8,), 1000, dtype=torch.int32), dist_reduce_fx="min")

    def _update(self, x):
        self.hi = torch.maximum(self.hi, x)
        self.lo = torch.minimum(self.lo, x.to(torch.int32))

    def _compute(self):
        return self.hi, self.lo


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_max_and_min_states(world):
    """The delta route's scratch starts at each fold's identity (-inf for a
    float max, the int32 maximum for a min), so a block folds exactly the
    world's rows, whatever the defaults."""
    rng = np.random.default_rng(2)
    xs = [[rng.integers(-5, 50, 8).astype(np.float32) for _ in range(world)] for _ in range(3)]

    def body(rank, gather):
        m = _Extrema(device="cpu", dist_sync_fn=gather)
        m.shard_states(RankSharding(RankMesh(rank=rank, world_size=world), P("rank")))
        for step in xs:
            m.update(torch.from_numpy(step[rank]))
        return m.hi.clone(), m.lo.clone(), m.compute()

    every = np.stack([x for step in xs for x in step])
    want_hi = np.maximum(every.max(0), -1.0).astype(np.float32)
    want_lo = np.minimum(every.min(0), 1000).astype(np.int32)
    rows = 8 // world
    for rank, (hi, lo, (full_hi, full_lo)) in enumerate(World(world).run(body)):
        np.testing.assert_array_equal(hi.numpy(), want_hi[rank * rows : (rank + 1) * rows])
        np.testing.assert_array_equal(lo.numpy(), want_lo[rank * rows : (rank + 1) * rows])
        np.testing.assert_array_equal(full_hi.numpy(), want_hi)
        np.testing.assert_array_equal(full_lo.numpy(), want_lo)


# ---------------------------------------------------------------------------
# sync_pytree(partition_specs=) against sync_pytree_in_mesh
# ---------------------------------------------------------------------------


def test_sync_pytree_partition_specs_mixed_tree():
    n, s = 8, 16
    sliced_leaf = np.arange(s, dtype=np.float32)
    per_rank = np.arange(n, dtype=np.float32)[:, None]

    def jbody(sl, scalar):
        out = sync_pytree_in_mesh(
            {"m": {"sl": sl, "scalar": scalar[0]}},
            {"m": {"sl": "sum", "scalar": "sum"}},
            "slices",
            partition_specs={"m": {"sl": JP("slices"), "scalar": JP()}},
        )
        return out["m"]["sl"], out["m"]["scalar"]

    want_sl, want_scalar = jax.jit(
        shard_map(jbody, mesh=_mesh(n), in_specs=(JP("slices"), JP("slices")), out_specs=(JP("slices"), JP()))
    )(jnp.asarray(sliced_leaf), jnp.asarray(per_rank))
    rec = get_recorder()
    rec.reset()
    rec.enable()
    try:

        def body(rank, gather):
            rows = s // n
            block = torch.from_numpy(sliced_leaf[rank * rows : (rank + 1) * rows].copy())
            out = sync_pytree(
                {"m": {"sl": block, "scalar": torch.from_numpy(per_rank[rank, 0:1].copy()).reshape(())}},
                {"m": {"sl": "sum", "scalar": "sum"}},
                dist_sync_fn=gather,
                partition_specs={"m": {"sl": P("slices"), "scalar": P()}},
                axis_name="slices",
            )
            assert out["m"]["sl"] is block
            return out["m"]["sl"], out["m"]["scalar"]

        results = World(n).run(body)
        events = [e for e in rec.events() if e.get("type") == "sync" and e.get("source") == "sync_pytree"]
    finally:
        rec.disable()
        rec.reset()
    np.testing.assert_array_equal(np.concatenate([r[0].numpy() for r in results]), np.asarray(want_sl))
    for _, scalar in results:
        assert float(scalar) == float(np.asarray(want_scalar).reshape(-1)[0])
    assert len(events) == n and all(e["sliced_passthrough"] == 1 for e in events)
    # the replicated scalar moved, the sharded leaf did not: 4 bytes from each rank
    assert all(e["gather_bytes"] == 4 * n for e in events)


def test_metric_sync_passes_sharded_claims_through():
    """``Metric.sync(partition_specs=)``: a claimed leaf keeps the rank's
    block; without the claim the blocks are gathered into the full state."""
    world = 2

    def body(rank, gather):
        m = SlicedMetric(tm.MeanSquaredError(device="cpu"), 8, dist_sync_fn=gather)
        shard_sliced_states(m, RankMesh(rank=rank, world_size=world))
        m.update(torch.tensor([rank * 4, 7]), torch.tensor([2.0, 1.0]), torch.tensor([0.0, 0.0]))
        specs = sliced_partition_specs(m, RankMesh(rank=rank, world_size=world))
        m.sync(partition_specs=specs, axis_name="slices")
        passed = tuple(m.sum_squared_error.shape)
        m.unsync()
        m.sync()
        full = m.sum_squared_error.clone()
        m.unsync()
        return passed, full

    for passed, full in World(world).run(body):
        assert passed == (4,)
        np.testing.assert_array_equal(full.numpy(), [4.0, 0, 0, 0, 4.0, 0, 0, 2.0])


# ---------------------------------------------------------------------------
# refusals and the fused decline
# ---------------------------------------------------------------------------


class _CatTensor(tm.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("rows", default=torch.zeros(8), dist_reduce_fx="cat")
        self.add_state("seen", default=torch.zeros(8), dist_reduce_fx="sum")

    def _update(self, x):
        self.seen = self.seen + x

    def _compute(self):
        return self.seen


def test_refusals():
    mesh = RankMesh(rank=0, world_size=2)
    with pytest.raises(MetricsUserError, match="'rows'.*only sum, max and min"):
        _CatTensor(device="cpu").shard_states(RankSharding(mesh, P("rank")))
    sketched = tm.AUROC(device="cpu")
    merge_leaf = next(k for k, r in sketched._reductions.items() if getattr(r, "merge_like", False))
    with pytest.raises(MetricsUserError, match=f"'{merge_leaf}'.*only sum, max and min"):
        sketched.shard_states({merge_leaf: RankSharding(mesh, P("rank"))})
    # the JAX package places them: a deliberate difference
    jmesh = _mesh(2, "rank")
    jsk = metrics_tpu.AUROC()
    jsk.shard_states({merge_leaf: NamedSharding(jmesh, JP("rank"))})
    # list states are skipped, as in the JAX package
    cat = tm.CatMetric(device="cpu")
    cat.shard_states(RankSharding(mesh, P("rank")))
    assert cat._shardings == {}
    with pytest.raises(MetricsUserError, match="does not divide"):
        tm.ConfusionMatrix(num_classes=5, device="cpu").shard_states(RankSharding(mesh, P("rank", None)))
    with pytest.raises(MetricsUserError, match="past the leading dimension"):
        RankSharding(mesh, P(None, "rank"))
    # replicated specs change nothing
    m = tm.ConfusionMatrix(num_classes=4, device="cpu")
    m.shard_states(RankSharding(mesh, P()))
    assert m._shardings == {} and tuple(m.confmat.shape) == (4, 4)


def test_fused_update_declines_a_sharded_member():
    world, num_slices = 2, 16
    batches = _sliced_batches("mse", num_slices, world, steps=3)

    def body(rank, gather):
        m = SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices, dist_sync_fn=gather)
        shard_sliced_states(m, RankMesh(rank=rank, world_size=world))
        col = tm.MetricCollection({"tenants": m})
        handle = col.compile_update()
        for step in batches:
            col.update(*(torch.from_numpy(x) for x in step[rank]))
        return handle.declined, {k: getattr(m, k).clone() for k in m._defaults}

    one = SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices)
    for step in batches:
        one.update(*(torch.from_numpy(np.concatenate(c)) for c in zip(*step)))
    for rank, (declined, block) in enumerate(World(world).run(body)):
        assert "sharded states" in declined.get("tenants", ""), declined
        for name, got in block.items():
            assert torch.equal(got, getattr(one, name)[rank * 8 : (rank + 1) * 8]), name
