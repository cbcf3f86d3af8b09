"""MetricCollection: chain metrics with one call pattern, with compute-group
state sharing.

Counterpart of ``metrics_tpu/collections.py``: dict behaviour, per-metric
kwarg filtering, prefix/postfix, clone, ``state_dict``, and compute groups
(every metric starts as its own group; after the first update, groups whose
states and shared hyperparameters are equal merge, and later updates touch
only each group's leader), the fused update (``compile_update``: one CUDA
graph per batch signature, ``core/fused.py``) and the async update pipeline
(``compile_update_async``, ``core/pipeline.py``). With the default
recorder enabled, ``update``/``forward``/``compute`` open spans that parent
their members' spans, a group leader's update events carry the members
they serve (``compute_group``), and ``freshness()`` folds the collection's
ingest span, every member's stamp and the async handle's.
"""
from collections import OrderedDict
from copy import deepcopy
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.observability.freshness import FreshnessStamp, merge_stamps
from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as _TELEMETRY
from metrics_tpu_torch.observability.trace import span as _span
from metrics_tpu_torch.parallel.distributed import distributed_available as _dist_available
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _flatten_dict(x: Dict) -> Dict:
    """Flatten dict-valued results into the parent."""
    new_dict = {}
    for key, value in x.items():
        if isinstance(value, dict):
            new_dict.update(value)
        else:
            new_dict[key] = value
    return new_dict


def _equal_values(v1: Any, v2: Any) -> bool:
    if isinstance(v1, Metric) or isinstance(v2, Metric):
        # ``==`` between metrics builds a composition: compare by identity
        return v1 is v2
    if isinstance(v1, torch.Tensor) or isinstance(v2, torch.Tensor):
        return (
            isinstance(v1, torch.Tensor)
            and isinstance(v2, torch.Tensor)
            and v1.shape == v2.shape
            and v1.device == v2.device
            and bool(torch.equal(v1, v2))
        )
    if isinstance(v1, np.ndarray) or isinstance(v2, np.ndarray):
        return isinstance(v1, np.ndarray) and isinstance(v2, np.ndarray) and np.array_equal(v1, v2)
    return bool(v1 == v2)


class MetricCollection:
    """Chain metrics that have the same call pattern into one object.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUROC, ConfusionMatrix
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.5, 0.3], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metrics = MetricCollection([ConfusionMatrix(num_classes=3, device="cpu"),
        ...                             AUROC(num_classes=3, capacity=8, device="cpu")])
        >>> metrics.update(preds, target)
        >>> metrics.compute()["AUROC"]
        tensor(1.)
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
    ) -> None:
        self._metrics: "OrderedDict[str, Metric]" = OrderedDict()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups: Dict[int, List[str]] = {}
        self._groups_checked: bool = False
        self._fused = None  # FusedUpdate handle once compile_update() is called
        self._async = None  # AsyncUpdateHandle once compile_update_async() is called
        self._bulk_insert = False
        # wall clock of the first/last batch (telemetry-enabled updates only)
        self._ingest_first_t: Optional[float] = None
        self._ingest_last_t: Optional[float] = None
        self.add_metrics(metrics, *additional_metrics)

    # ------------------------------------------------------------------
    # dict-like access
    # ------------------------------------------------------------------
    def __getitem__(self, key: str) -> Metric:
        return self._metrics[key]

    def __setitem__(self, key: str, value: Metric) -> None:
        self._metrics[key] = value
        if not self._bulk_insert:
            self._on_membership_change()

    def _on_membership_change(self) -> None:
        """A membership change drops the fused and async handles (their
        member set is stale) and reseeds the compute groups."""
        self._groups_checked = False
        self._invalidate_compiled()
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {}

    def _invalidate_compiled(self) -> None:
        """Drop the fused handle and close an open async handle, discarding
        its queued batches; ``compile_update[_async]()`` resumes."""
        self._fused = None
        if self._async is not None:
            self._async.close(drain=False)
            self._async = None

    def __contains__(self, key: str) -> bool:
        return key in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def __iter__(self) -> Iterable[str]:
        return iter(self._metrics)

    def keys(self, keep_base: bool = False) -> Iterable[str]:
        if keep_base:
            return self._metrics.keys()
        return self._to_renamed_ordered_dict().keys()

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:
        if keep_base:
            return self._metrics.items()
        return self._to_renamed_ordered_dict().items()

    def values(self) -> Iterable[Metric]:
        return self._metrics.values()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call forward for each metric; kwargs are filtered per metric. An
        open async handle is drained first: forward reads and restores
        every state."""
        if not _TELEMETRY.enabled:
            return self._forward_impl(*args, **kwargs)
        with _span("MetricCollection.forward", n_metrics=len(self._metrics)):
            return self._forward_impl(*args, **kwargs)

    def _forward_impl(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        self._drain_async()
        res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self.items(keep_base=True)}
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Call update for each metric (only group leaders once groups are
        known); through the open async handle (FIFO with its queued
        batches) or the fused handle when there is one."""
        if not _TELEMETRY.enabled:
            self._update_impl(*args, **kwargs)
            return
        now = time.time()
        if self._ingest_first_t is None:
            self._ingest_first_t = now
        self._ingest_last_t = now
        # the collection span parents every member's own span
        with _span("MetricCollection.update", n_metrics=len(self._metrics)):
            self._update_impl(*args, **kwargs)

    def _update_impl(self, *args: Any, **kwargs: Any) -> None:
        if self._async is not None and not self._async.closed:
            self._async.update_blocking(*args, **kwargs)
            return
        if self._fused is not None:
            self._fused(*args, **kwargs)
            return
        if self._groups_checked:
            for cg in self._groups.values():
                m0 = self._metrics[cg[0]]
                if _TELEMETRY.enabled and len(cg) > 1:
                    # the leader's one update event names the members it serves
                    with _TELEMETRY.group_attribution(cg):
                        m0.update(*args, **m0._filter_kwargs(**kwargs))
                else:
                    m0.update(*args, **m0._filter_kwargs(**kwargs))
        else:
            for m in self._metrics.values():
                m.update(*args, **m._filter_kwargs(**kwargs))
            if self._enable_compute_groups:
                self._merge_compute_groups()
                self._groups_checked = True

    def _merge_compute_groups(self) -> None:
        """Pairwise-merge groups whose member states are identical."""
        n_groups = len(self._groups)
        while True:
            for cg_idx1, cg_members1 in deepcopy(self._groups).items():
                for cg_idx2, cg_members2 in deepcopy(self._groups).items():
                    if cg_idx1 == cg_idx2:
                        continue
                    metric1 = self._metrics[cg_members1[0]]
                    metric2 = self._metrics[cg_members2[0]]
                    if self._equal_metric_states(metric1, metric2):
                        self._groups[cg_idx1].extend(self._groups.pop(cg_idx2))
                        break
                if len(self._groups) != n_groups:
                    break
            if len(self._groups) == n_groups:
                break
            n_groups = len(self._groups)

        self._groups = {idx: values for idx, values in enumerate(deepcopy(self._groups).values())}

    @staticmethod
    def _equal_update_attrs(metric1: Metric, metric2: Metric) -> bool:
        """True if every public attribute the two metrics share compares
        equal: metrics differing in a hyperparameter never share a group,
        even when their states coincide on the first batch. Sliced and
        windowed metrics keep their real update configuration on the wrapped
        template (and a window's decay factor), which must agree too."""
        t1, t2 = getattr(metric1, "_template", None), getattr(metric2, "_template", None)
        if (t1 is None) != (t2 is None) or getattr(metric1, "_alpha", None) != getattr(metric2, "_alpha", None):
            return False
        if t1 is not None and (type(t1) is not type(t2) or not MetricCollection._equal_update_attrs(t1, t2)):
            return False
        skip = set(metric1._defaults) | set(metric2._defaults)
        attrs1 = {k: v for k, v in vars(metric1).items() if not k.startswith("_") and k not in skip}
        attrs2 = {k: v for k, v in vars(metric2).items() if not k.startswith("_") and k not in skip}
        for key in attrs1.keys() & attrs2.keys():
            v1, v2 = attrs1[key], attrs2[key]
            if v1 is v2:
                continue
            try:
                if not _equal_values(v1, v2):
                    return False
            except Exception:  # incomparable values: refuse to merge
                return False
        return True

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """True if the two metrics' state definitions, shared
        hyperparameters and state values are identical."""
        if metric1._defaults.keys() != metric2._defaults.keys() or not metric1._defaults:
            return False
        # a wrapper's or composition's states are its children's
        if metric1._children or metric2._children:
            return False
        if not MetricCollection._equal_update_attrs(metric1, metric2):
            return False
        for key in metric1._defaults:
            d1, d2 = metric1._defaults[key], metric2._defaults[key]
            if type(d1) is not type(d2) or metric1._reductions[key] is not metric2._reductions[key]:
                return False
            if isinstance(d1, torch.Tensor) and (d1.shape != d2.shape or d1.dtype != d2.dtype):
                return False

        for key in metric1._defaults:
            state1, state2 = getattr(metric1, key), getattr(metric2, key)
            if type(state1) is not type(state2):
                return False
            if isinstance(state1, (int, float)):
                if state1 != state2:
                    return False
            elif isinstance(state1, torch.Tensor):
                if state1.shape != state2.shape or not bool(torch.allclose(state1, state2)):
                    return False
            elif isinstance(state1, list):
                if len(state1) != len(state2):
                    return False
                if not all(s1.shape == s2.shape and bool(torch.allclose(s1, s2)) for s1, s2 in zip(state1, state2)):
                    return False
        return True

    def compute(self) -> Dict[str, Any]:
        """Compute each metric; group members borrow the leader's state.
        With an async handle open, a bounded-staleness snapshot: wait until
        at most ``max_staleness`` accepted batches are unapplied, then read
        between whole batches; a compute that syncs across processes drains
        the handle first."""
        if not _TELEMETRY.enabled:
            return self._compute_impl()
        with _span("MetricCollection.compute", n_metrics=len(self._metrics)):
            return self._compute_impl()

    def _compute_impl(self) -> Dict[str, Any]:
        handle = self._async if self._async is not None and not self._async.closed else None
        if handle is None:
            return self._compute_metrics()
        if _dist_available() or any(m.dist_sync_fn is not None for m in self._metrics.values()):
            # a synced read folds every rank's states: none may be behind
            # the batches accepted here, whatever the staleness bound
            handle._wait_drained()
        handle._before_compute()
        applied_mark = handle.applied
        try:
            with handle.snapshot():
                return self._compute_metrics()
        finally:
            if handle.applied != applied_mark:
                # batches landed while computing: a value cached now is stale
                for m in self._metrics.values():
                    m._computed = None

    def freshness(self, now: Optional[float] = None) -> FreshnessStamp:
        """The collection's freshness stamp: the merge of the collection's
        ingest span, every member's own stamp and, with an async handle
        open, the handle's (applied span and in-flight age). Ingest times
        are stamped by telemetry-enabled updates only."""
        stamps: List[FreshnessStamp] = [
            FreshnessStamp(min_event_t=self._ingest_first_t, max_event_t=self._ingest_last_t)
        ]
        stamps.extend(m.freshness_stamp(now) for m in self._metrics.values())
        if self._async is not None and not self._async.closed:
            stamps.append(self._async.freshness(now))
        return merge_stamps(stamps)

    def _compute_metrics(self) -> Dict[str, Any]:
        if self._enable_compute_groups and self._groups_checked:
            for cg in self._groups.values():
                m0 = self._metrics[cg[0]]
                for name in cg[1:]:
                    mi = self._metrics[name]
                    for state in m0._defaults:
                        object.__setattr__(mi, state, getattr(m0, state))
                    mi._update_called = m0._update_called
                    mi._states_donated = m0._states_donated
                    # installing the leader's states is an out-of-band write
                    # only when the leader advanced since the last borrow
                    src_epoch = (cg[0], m0._write_epoch)
                    if getattr(mi, "_borrowed_epoch", None) != src_epoch:
                        mi._mark_state_written()
                        mi._borrowed_epoch = src_epoch
        res = {k: m.compute() for k, m in self.items(keep_base=True)}
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def compile_update(
        self,
        buckets: Optional[Sequence[int]] = None,
        donate: Optional[bool] = None,
        use_manifest: Optional[bool] = None,
    ) -> Any:
        """Fuse the whole collection's update: returns a
        :class:`~metrics_tpu_torch.core.fused.FusedUpdate` and routes later
        :meth:`update` calls through it. Every fusible member's update (one
        per compute group) runs in one function, captured on the card as one
        CUDA graph per batch signature; members flagged ``__jit_unsafe__``,
        list-state members and members that fail the probe run eagerly in
        the same call.

        ``buckets`` -- ascending batch sizes for pad-and-mask bucketing:
        ragged batches pad to the nearest bucket and share its graph.
        ``donate`` -- install the graphs' static state buffers as the states
        (default on the card): callers must not hold state tensors across an
        update. ``use_manifest`` (default on) seeds fusibility from the
        static analysis' manifest: a class proved ``fusible`` skips the
        probe; ``use_manifest=False`` probes every member.

        A matching handle is kept (warm reuse after ``reset()``);
        ``forward`` keeps the eager semantics; ``clone()`` and
        ``add_metrics()`` drop the handle.
        """
        from metrics_tpu_torch.core.fused import FusedUpdate

        matches = self._fused is not None and self._fused.config_matches(
            buckets=buckets, donate=donate, use_manifest=use_manifest
        )
        if matches:
            return self._fused
        if self._async is not None and not self._async.closed:
            raise MetricsUserError(
                "compile_update() with a different config while an async handle is open; close() the"
                " handle (or reset(), or call compile_update_async() with the new config) first"
            )
        self._fused = FusedUpdate(self, buckets=buckets, donate=donate, use_manifest=use_manifest)
        return self._fused

    @property
    def fused_update(self) -> Any:
        """The active :class:`~metrics_tpu_torch.core.fused.FusedUpdate`, or None (eager)."""
        return self._fused

    def compile_update_async(
        self,
        buckets: Optional[Sequence[int]] = None,
        donate: Optional[bool] = None,
        use_manifest: Optional[bool] = None,
        *,
        queue_depth: int = 2,
        policy: str = "block",
        max_staleness: int = 0,
    ) -> Any:
        """The fused update with the async pipeline in front of it: returns
        an :class:`~metrics_tpu_torch.core.pipeline.AsyncUpdateHandle` whose
        ``update_async(batch)`` enqueues into a bounded queue (depth
        ``queue_depth``) and returns; a worker thread drains it through the
        fused update, on its own CUDA stream on the card.

        ``buckets``/``donate``/``use_manifest`` go to :meth:`compile_update`.
        ``policy`` is the full-queue behaviour (``"block"``, ``"drop"``,
        ``"error"``); ``max_staleness`` the default ``compute()`` bound in
        unapplied batches (0: drain, then compute). While the handle is
        open, ``update()`` routes through it, ``compute`` honours the bound
        and ``forward`` drains first; ``reset()`` and ``add_metrics()``
        close it, ``clone()`` drops it.
        """
        from metrics_tpu_torch.core.pipeline import AsyncUpdateHandle

        if self._async is not None:
            # a poisoned handle raises its error here rather than vanish
            self._async._raise_pending_error()
            self._async.close(drain=True)
        fused = self.compile_update(buckets=buckets, donate=donate, use_manifest=use_manifest)
        self._async = AsyncUpdateHandle(
            self, fused, queue_depth=queue_depth, policy=policy, max_staleness=max_staleness
        )
        return self._async

    @property
    def async_update(self) -> Any:
        """The active :class:`~metrics_tpu_torch.core.pipeline.AsyncUpdateHandle`, or None."""
        return self._async

    def update_async(self, *args: Any, **kwargs: Any) -> bool:
        """Enqueue one batch into the async pipeline and return: True if
        accepted, False if the ``drop`` policy discarded it."""
        if self._async is None or self._async.closed:
            raise MetricsUserError("update_async() requires an open async handle; call compile_update_async() first")
        return self._async.update_async(*args, **kwargs)

    def state_reductions(self) -> Dict[str, Dict[str, Any]]:
        """Per-metric reducer specs (name -> ``Metric.state_reductions()``)."""
        return {name: m.state_reductions() for name, m in self._metrics.items()}

    def reset(self) -> None:
        """Reset all metrics; discovered compute groups and a fused handle
        are kept. An open async handle is closed (its queued batches
        discarded: the states are being wiped)."""
        if self._async is not None:
            self._async.close(drain=False)
            self._async = None
        self._ingest_first_t = None
        self._ingest_last_t = None
        for m in self._metrics.values():
            m.reset()

    def _drain_async(self) -> None:
        """Apply the open async handle's queued batches before the states
        are read, copied or replaced (raises a kept worker error)."""
        if self._async is not None and not self._async.closed:
            self._async._wait_drained()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """A deep copy; the fused and async handles are not copied (the
        clone compiles its own)."""
        self._drain_async()
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self._metrics.values():
            m.persistent(mode)

    def to_device(self, device: Any) -> "MetricCollection":
        """Move every member to ``device``. The fused and async handles are
        dropped: their graphs and buffers live on the old device."""
        self._drain_async()
        self._invalidate_compiled()
        for m in self._metrics.values():
            m.to_device(device)
        return self

    def set_dtype(self, dst_type: Any) -> "MetricCollection":
        """Cast every member's floating states (``Metric.set_dtype``), after
        draining an open async handle, as :meth:`to_device` does. A compiled
        update stays: it keys its graphs on the states' dtypes, so the next
        fused update captures anew over the cast states."""
        self._drain_async()
        for m in self._metrics.values():
            m.set_dtype(dst_type)
        return self

    def state_dict(self) -> Dict[str, Any]:
        self._drain_async()
        destination: Dict[str, Any] = {}
        for name, m in self._metrics.items():
            m.state_dict(destination, prefix=f"{name}.")
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self._drain_async()
        for name, m in self._metrics.items():
            m.load_state_dict(state_dict, prefix=f"{name}.")

    def state_footprint(self) -> Dict[str, Dict[str, int]]:
        """Bytes per state of each member (``Metric.state_footprint``);
        the members of a compute group report the same states, so
        :meth:`total_state_bytes` is the total."""
        return {name: m.state_footprint() for name, m in self._metrics.items()}

    def total_state_bytes(self) -> int:
        """Bytes of unique states: once compute groups are known, only each
        group's leader counts (the members borrow its states). With an open
        async handle, the bytes of its queued batches and of the states a
        donating update is writing count too
        (``AsyncUpdateHandle.in_flight_bytes``)."""
        if self._enable_compute_groups and self._groups_checked:
            names = [cg[0] for cg in self._groups.values()]
        else:
            names = list(self._metrics)
        total = sum(self._metrics[name].total_state_bytes() for name in names)
        if self._async is not None and not self._async.closed:
            total += self._async.in_flight_bytes
        return total

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence) and not isinstance(metrics, str):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        # one membership update after the whole batch of inserts: an explicit
        # compute_groups list is validated against the complete membership
        self._bulk_insert = True
        try:
            if isinstance(metrics, dict):
                for name in sorted(metrics.keys()):
                    metric = metrics[name]
                    if not isinstance(metric, Metric):
                        raise ValueError(f"Value {metric} belonging to key {name} is not an instance of `Metric`")
                    self[name] = metric
            elif isinstance(metrics, Sequence):
                for metric in metrics:
                    if not isinstance(metric, Metric):
                        raise ValueError(f"Input {metric} to `MetricCollection` is not a instance of `Metric`")
                    name = metric.__class__.__name__
                    if name in self:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self[name] = metric
            else:
                raise ValueError("Unknown input to MetricCollection.")
        finally:
            self._bulk_insert = False

        self._on_membership_change()

    def _init_compute_groups(self) -> None:
        if isinstance(self._enable_compute_groups, list):
            self._groups = {i: k for i, k in enumerate(self._enable_compute_groups)}
            for v in self._groups.values():
                for metric in v:
                    if metric not in self:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the"
                            f" collection. Please make sure that {self._enable_compute_groups} matches"
                            f" {list(self.keys(keep_base=True))}"
                        )
                self._check_explicit_group(v)
            self._groups_checked = True
        else:
            self._groups = {i: [str(k)] for i, k in enumerate(self._metrics.keys())}

    def _check_explicit_group(self, group: List[str]) -> None:
        """Every member of an explicit group must take the leader's states
        as they are: each of its states registered by the leader with the
        same shape and dtype. Otherwise ``compute`` would install states of
        another layout into the member (a macro average reading a micro
        leader's 0-d counts computes the micro value). The JAX package
        raises at ``compute``, by accident of an axis check; here the
        construction raises."""
        leader = self._metrics[group[0]]
        wrong = []
        for name in group[1:]:
            member = self._metrics[name]
            for key, default in member._defaults.items():
                lead = leader._defaults.get(key)
                if (
                    key not in leader._defaults
                    or isinstance(default, list) != isinstance(lead, list)
                    or (isinstance(default, torch.Tensor) and (default.shape != lead.shape or default.dtype != lead.dtype))
                ):
                    wrong.append(name)
                    break
        if wrong:
            raise ValueError(
                f"Explicit compute group {group} cannot share the states of its leader {group[0]!r}:"
                f" the states of {wrong} differ from the leader's in name, shape or dtype"
            )

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    # ------------------------------------------------------------------
    # naming
    # ------------------------------------------------------------------
    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _to_renamed_ordered_dict(self) -> "OrderedDict[str, Metric]":
        od: "OrderedDict[str, Metric]" = OrderedDict()
        for k, v in self._metrics.items():
            od[self._set_name(k)] = v
        return od

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        for name, m in self._metrics.items():
            repr_str += f"\n  {name}: {repr(m)}"
        if self.prefix:
            repr_str += f"\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f"\n  postfix={self.postfix}"
        return repr_str + "\n)" if len(self._metrics) else repr_str + ")"
