"""Partition rules for sliced metric state: state-leaf paths -> ``PartitionSpec``.

Counterpart of ``metrics_tpu/sliced/sharding.py``. At 10^5-10^6 slices the
state of a :class:`~metrics_tpu_torch.sliced.SlicedMetric` is worth
splitting across a job's processes. This module maps state-leaf *paths*
to specs with regex rules and places the states over a process group:

    shard_sliced_states(metric, None)     # [S] leaves split over the default group

**The process group is the mesh axis.** Where the JAX package takes a
``jax.sharding.Mesh``, the port takes a process group, a
``torch.distributed.device_mesh.DeviceMesh`` with the named axis, a
:class:`~metrics_tpu_torch.parallel.distributed.RankMesh` (a simulated
world's explicit rank and size) or None, the default group; the port's
:class:`~metrics_tpu_torch.parallel.distributed.RankSharding` takes the
place of ``NamedSharding`` and its own
:class:`~metrics_tpu_torch.parallel.distributed.PartitionSpec` (a tuple)
of ``jax.sharding.PartitionSpec``. Rank ``r`` of ``W`` owns the rows
``[r*N/W, (r+1)*N/W)`` of a sharded leaf. A leading dimension that ``W``
does not divide, or that is shorter than ``W``, stays replicated
(``PartitionSpec()``), and the spec functions say so too: a sync that
passed a replicated leaf through would skip the reduction it needs.

The JAX package is single-controller: its update takes the global batch
and XLA routes each row to the device that owns its slice. The port runs
one process per rank, so a sharded metric's update and reads are
collective: every rank calls them in the same order (see
``sliced/metric.py`` for the routed fold). A slice-sharded leaf then syncs
with no traffic: :func:`~metrics_tpu_torch.parallel.distributed.sync_pytree`
with ``partition_specs=`` passes it through, while the replicated leaves
keep their reduction.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.parallel.distributed import PartitionSpec, RankSharding, rank_mesh
from metrics_tpu_torch.sliced.metric import SLICED_FOOTPRINT_PREFIX
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

#: default name of the mesh axis the slice dimension shards over
SLICE_AXIS = "slices"

# ---------------------------------------------------------------------------
# layout-manifest consultation
# ---------------------------------------------------------------------------
#
# The port's layout manifest (analysis/layout_manifest.json, regenerated by
# `python -m metrics_tpu_torch.analysis --manifest`) records per class, per
# leaf, the reducer and shard axis the abstract interpreter derived. For a
# template class the manifest proved sliceable, every SlicedMetric leaf has
# leading dimension `num_slices` BY CONSTRUCTION, so ONE divisibility check
# answers every leaf and the per-leaf probe is skipped.
# `METRICS_TPU_TORCH_VERIFY_MANIFEST=1` runs the probe anyway and
# cross-checks (mismatches warn, count, and trust the probe); a manifest
# whose leaf set disagrees with the live object falls back to the probe and
# counts a stale fallback.

_MANIFEST_COUNTERS = {"probe_skips": 0, "stale_fallbacks": 0, "verify_mismatches": 0}


def manifest_consultation_counters() -> Dict[str, int]:
    """Snapshot of the layout-manifest consultation counters:
    ``probe_skips`` (metrics answered from the manifest with no probe),
    ``stale_fallbacks`` (the manifest could not vouch for the live object:
    its leaf set or sliceability disagreed; probe used) and
    ``verify_mismatches`` (``METRICS_TPU_TORCH_VERIFY_MANIFEST``
    cross-checks that caught a divergence; probe trusted)."""
    return dict(_MANIFEST_COUNTERS)


def reset_manifest_consultation_counters() -> None:
    for key in _MANIFEST_COUNTERS:
        _MANIFEST_COUNTERS[key] = 0


def _verify_manifest() -> bool:
    from metrics_tpu_torch.analysis.manifest import ENV_VERIFY_MANIFEST

    return os.environ.get(ENV_VERIFY_MANIFEST, "").strip().lower() not in ("", "0", "false", "no", "off")


def _global_shape(m: Any, name: str) -> Tuple[int, ...]:
    """A state's shape across the whole group: a sharded block's leading
    rows times the world size."""
    value = getattr(m, name)
    shape = tuple(getattr(value, "shape", ()))
    sharding = m._shardings.get(name)
    if sharding is not None:
        shape = (shape[0] * sharding.world_size,) + shape[1:]
    return shape


def _manifest_fast_specs(m: Any, mesh: Any, axis_name: str) -> Optional[Dict[str, PartitionSpec]]:
    """Per-state-name spec answered from the layout manifest alone (no state
    access), or None when the manifest is absent, disabled, or cannot vouch
    for this object."""
    from metrics_tpu_torch.analysis import layout as _layout
    from metrics_tpu_torch.sliced.metric import SLICE_ROWS, SlicedMetric

    if not _layout.runtime_layout():
        return None
    if isinstance(m, SlicedMetric):
        entry = _layout.layout_for_class(type(m.wrapped))
        expected = set(m._defaults) - {SLICE_ROWS}
        if (
            not isinstance(entry, dict)
            or entry.get("sliceable") is not True
            or set(entry.get("leaves") or ()) != expected
        ):
            _MANIFEST_COUNTERS["stale_fallbacks"] += 1
            return None
        axis_size = rank_mesh(mesh, axis_name).world_size
        n = int(m.num_slices)
        spec = PartitionSpec(axis_name) if n % axis_size == 0 and n >= axis_size else PartitionSpec()
        return {name: spec for name in m._defaults}
    entry = _layout.layout_for_class(type(m))
    if not isinstance(entry, dict) or set(entry.get("leaves") or ()) != set(m._defaults):
        _MANIFEST_COUNTERS["stale_fallbacks"] += 1
        return None
    if SLICE_ROWS in m._defaults:
        # a plain state literally named `_slice_rows` matches the
        # suffix-anchored default rule; only the probe can size it
        return None
    return {name: PartitionSpec() for name in m._defaults}


def slice_partition_rules(axis_name: str = SLICE_AXIS) -> Tuple[Tuple[str, PartitionSpec], ...]:
    """Default rules for sliced metric state: every leaf registered by a
    ``SlicedMetric`` (its ``state_footprint`` paths carry the
    ``SLICED_FOOTPRINT_PREFIX``, and the row counter matches by name)
    shards its leading ``[S]`` dimension over ``axis_name``; anything else
    replicates."""
    return (
        (rf"(^|/){re.escape(SLICED_FOOTPRINT_PREFIX)}", PartitionSpec(axis_name)),
        (r"(^|/)_slice_rows$", PartitionSpec(axis_name)),
        (r".*", PartitionSpec()),
    )


def _iter_paths(tree: Any, path: str = "", sep: str = "/"):
    if isinstance(tree, dict):
        for key, value in tree.items():
            sub = f"{path}{sep}{key}" if path else str(key)
            yield from _iter_paths(value, sub, sep)
    else:
        yield path, tree


def _rebuild(tree: Any, flat: Dict[str, Any], path: str = "", sep: str = "/") -> Any:
    if isinstance(tree, dict):
        return {
            key: _rebuild(value, flat, f"{path}{sep}{key}" if path else str(key), sep) for key, value in tree.items()
        }
    return flat[path]


def match_partition_rules(
    rules: Sequence[Tuple[str, PartitionSpec]],
    tree: Dict[str, Any],
    sep: str = "/",
) -> Dict[str, Any]:
    """A tree of specs matching ``tree`` (nested string-keyed dicts of
    tensors: the shape ``Metric.state_dict()`` and
    ``MetricCollection.state_reductions()`` give), chosen by the first rule
    whose regex searches the ``sep``-joined leaf path. Scalars (and
    one-element tensors) never partition. Raises when no rule matches: a
    silent replicate-by-default would hide a mistyped rule."""
    flat: Dict[str, Any] = {}
    for path, leaf in _iter_paths(tree, sep=sep):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            flat[path] = PartitionSpec()
            continue
        for pattern, spec in rules:
            if re.search(pattern, path) is not None:
                flat[path] = spec
                break
        else:
            raise MetricsUserError(f"no partition rule matched state leaf {path!r}")
    return _rebuild(tree, flat, sep=sep)


def get_naive_slice_sharding(x: Any, mesh: Any, axis_name: str = SLICE_AXIS) -> RankSharding:
    """Shard ``x``'s leading dimension over ``axis_name`` when the group's
    size divides it evenly, else replicate. ``x`` is anything with a
    ``shape``."""
    mesh = rank_mesh(mesh, axis_name)
    shape = tuple(getattr(x, "shape", ()))
    if len(shape) >= 1 and shape[0] % mesh.world_size == 0 and shape[0] >= mesh.world_size:
        return RankSharding(mesh, PartitionSpec(axis_name))
    return RankSharding(mesh, PartitionSpec())


def sliced_partition_specs(metric: Any, mesh: Any, axis_name: str = SLICE_AXIS) -> Dict[str, Any]:
    """Partition specs for a metric's (or collection's) state tree:
    ``{leaf: PartitionSpec}`` nested like ``state_reductions()``, the shape
    ``sync_pytree(partition_specs=...)`` takes.

    ``mesh`` is REQUIRED and must be the one given to
    :func:`shard_sliced_states`: a ``SlicedMetric`` leaf is claimed
    sharded only when the divisibility rule shards it; a leaf the rule left
    replicated gets ``PartitionSpec()``, so the sync still reduces it. An
    unconditional claim on a replicated leaf would pass it through and drop
    the cross-rank reduction it needs. Other metrics replicate everywhere.
    Sizes are the states' sizes across the group (a sharded block's rows
    times the world size).

    When the layout manifest vouches for the metric's class the answer comes
    from the manifest with no per-leaf probe (see
    :func:`manifest_consultation_counters`); set
    ``METRICS_TPU_TORCH_VERIFY_MANIFEST=1`` to probe anyway and cross-check,
    or ``METRICS_TPU_TORCH_NO_MANIFEST=1`` to disable consultation."""
    from metrics_tpu_torch.sliced.metric import SlicedMetric

    mesh = rank_mesh(mesh, axis_name)

    def probe(m: Any) -> Dict[str, Any]:
        if isinstance(m, SlicedMetric):
            return {
                name: get_naive_slice_sharding(
                    torch.empty(_global_shape(m, name), device="meta"), mesh, axis_name=axis_name
                ).spec
                for name in m._defaults
            }
        return {name: PartitionSpec() for name in m._defaults}

    def spec_for(m: Any) -> Dict[str, Any]:
        fast = _manifest_fast_specs(m, mesh, axis_name)
        if fast is None:
            return probe(m)
        if _verify_manifest():
            probed = probe(m)
            if probed != fast:
                _MANIFEST_COUNTERS["verify_mismatches"] += 1
                rank_zero_warn(
                    "layout-manifest partition specs disagree with the probe for "
                    f"{type(m).__name__}; trusting the probe. The layout manifest is stale: "
                    "regenerate it with `python -m metrics_tpu_torch.analysis --manifest`.",
                    UserWarning,
                )
            return probed
        _MANIFEST_COUNTERS["probe_skips"] += 1
        return fast

    if hasattr(metric, "_metrics"):  # MetricCollection duck-type
        return {name: spec_for(m) for name, m in metric._metrics.items()}
    return spec_for(metric)


def shard_sliced_states(
    metric: Any,
    mesh: Any,
    axis_name: str = SLICE_AXIS,
    rules: Optional[Sequence[Tuple[str, PartitionSpec]]] = None,
) -> Dict[str, Any]:
    """Shard a metric's (or collection's) states over the process group by
    ``rules`` (default: :func:`slice_partition_rules`) and return the
    applied ``{state: RankSharding}`` tree.

    Uses ``Metric.shard_states`` underneath, so the reset defaults are
    blocks too and ``reset()`` keeps the layout. A leaf whose leading
    dimension the group does not divide stays replicated rather than
    raising: pad ``num_slices`` up to a multiple of the world size to shard
    evenly. A rule's spec names the axis for the LEADING (slice) dimension;
    specs without a named axis replicate. Every rank calls this, as it
    calls an update.

    With the DEFAULT rules, a metric the layout manifest vouches for is
    placed without the per-leaf probe; custom ``rules`` always take the
    probe. A manifest-seeded placement that fails to apply falls back to
    the probe (one warning) and counts a stale fallback.
    """
    use_default_rules = rules is None
    rules = tuple(rules) if rules is not None else slice_partition_rules(axis_name)
    mesh = rank_mesh(mesh, axis_name)

    def probe_shardings(m: Any) -> Dict[str, RankSharding]:
        shapes = {name: _global_shape(m, name) for name in m._defaults if not isinstance(m._defaults[name], list)}
        # footprint keys carry the SLICED_FOOTPRINT_PREFIX for SlicedMetric
        # leaves; rule-match against those paths with the SAME matcher (and
        # the same raise-on-no-match contract) as match_partition_rules,
        # then strip back to state names
        by_path = {
            key: torch.empty(shapes[name], device="meta")
            for key in m.state_footprint(include_children=False)
            if (name := key.split("/", 1)[1] if key.startswith(SLICED_FOOTPRINT_PREFIX) else key) in shapes
        }
        spec_by_path = match_partition_rules(rules, by_path)
        shardings: Dict[str, RankSharding] = {}
        for key, spec in spec_by_path.items():
            name = key.split("/", 1)[1] if key.startswith(SLICED_FOOTPRINT_PREFIX) else key
            # a rule spec names at most one axis for the leading dimension;
            # anything without a named leading axis replicates
            axis = next((a for a in tuple(spec) if isinstance(a, str)), None)
            if axis is None:
                shardings[name] = RankSharding(mesh, PartitionSpec())
                continue
            shardings[name] = get_naive_slice_sharding(by_path[key], mesh, axis_name=axis)
        return shardings

    def place(m: Any) -> Dict[str, Any]:
        fast = _manifest_fast_specs(m, mesh, axis_name) if use_default_rules else None
        if fast is not None:
            shardings = {
                name: RankSharding(mesh, spec) for name, spec in fast.items() if not isinstance(m._defaults[name], list)
            }
            if _verify_manifest():
                probed = probe_shardings(m)
                if probed != shardings:
                    _MANIFEST_COUNTERS["verify_mismatches"] += 1
                    rank_zero_warn(
                        "layout-manifest shardings disagree with the probe for "
                        f"{type(m).__name__}; trusting the probe. Regenerate the layout "
                        "manifest with `python -m metrics_tpu_torch.analysis --manifest`.",
                        UserWarning,
                    )
                    shardings = probed
            else:
                _MANIFEST_COUNTERS["probe_skips"] += 1
            try:
                m.shard_states(shardings)
            except MetricsUserError:
                # stale-manifest safety net (the FusedUpdate pattern): the
                # placement trusted a manifest verdict the runtime refuted;
                # shard_states checks every state before it changes any, so
                # re-derive from the live states and retry once. Only that
                # refusal: a failed gather (a metric that took batches folds
                # every rank's accumulation) raises on every rank
                _MANIFEST_COUNTERS["stale_fallbacks"] += 1
                rank_zero_warn(
                    "manifest-seeded sharding failed to apply for "
                    f"{type(m).__name__}; the layout manifest is stale. Falling back to the "
                    "probe -- regenerate it with `python -m metrics_tpu_torch.analysis --manifest`.",
                    UserWarning,
                )
                shardings = probe_shardings(m)
                m.shard_states(shardings)
            return shardings
        shardings = probe_shardings(m)
        m.shard_states(shardings)
        return shardings

    if hasattr(metric, "_metrics"):  # MetricCollection duck-type
        return {name: place(m) for name, m in metric._metrics.items()}
    return place(metric)
