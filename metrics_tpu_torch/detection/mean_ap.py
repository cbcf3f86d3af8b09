"""Modular MeanAveragePrecision (COCO mAP/mAR) for object detection.

Counterpart of ``metrics_tpu/detection/mean_ap.py``, with the same state
modes, inputs, errors and result keys:

* **default**: each image's detections and ground truths are packed into
  one fixed-width row of a reservoir table
  (:mod:`metrics_tpu_torch.sketches.reservoir`): ``det_slots`` capped
  detections, ``gt_slots`` ground truths and the image's global arrival
  index, flattened into ``[max_images, 1 + row_cols]`` float32 on the
  metric's device. Admission is by the hash key of the global image index
  (:func:`~metrics_tpu_torch.sketches.reservoir_key`), so the admitted set
  is a pure function of the index set. While ``images_seen <= max_images``
  the table holds every image in arrival order and ``compute()`` equals
  the list mode bit for bit; past capacity it evaluates the ``max_images``
  images of highest key.
* ``exact=True``: the reference's unbounded per-image lists (and its
  large-memory warning).

``update`` takes the reference's list of per-image dicts, or batched
padded dicts (``boxes [B, D, 4]``, ``scores [B, D]``, ``labels [B, D]``,
``n [B]`` for predictions; ``boxes [B, G, 4]``, ``labels [B, G]``, ``n
[B]`` for targets) with an optional ``n_valid`` that masks trailing pad
images. Neither reads the card: the list form is validated by shapes and
packed on the device. ``compute()`` reads the table to the host once,
packs ``(image, class)`` units there, matches them in chunks on the
metric's device (the batched IoU kernel on the card) and reduces the
precision/recall tables on the host in float64.

Capacity caveats, as in the JAX package: detections are capped per image
at ``det_slots`` (top scores, arrival order kept; a stricter cut than the
reference's per-(image, class) ``max_det`` only when one image carries
more than ``det_slots`` detections over all classes); an image with more
than ``gt_slots`` ground truths raises; image indices are stored as
float32, exact below 2**24 images.
"""
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.detection.mean_ap import (
    _calculate_precision_recall,
    _match_units,
    _pack_units,
    _summarize,
)
from metrics_tpu_torch.parallel.distributed import process_index
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.sketches.moments import moments_merge_fx
from metrics_tpu_torch.sketches.reservoir import (
    detection_table_init,
    reservoir_insert_keyed,
    reservoir_key,
    reservoir_merge_fx,
)
from metrics_tpu_torch.utils.data import _as_tensor

Tensor = torch.Tensor

#: cap on chunk_size * D * G: bounds the device IoU buffer at 16 MB of float32
_UNIT_CHUNK_ELEMS = 1 << 22

_BBOX_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}

_NEG_INF = -np.inf

_EXACT_STATES = (
    "detection_boxes",
    "detection_scores",
    "detection_labels",
    "groundtruth_boxes",
    "groundtruth_labels",
)


def _input_validator(preds: Sequence[dict], targets: Sequence[dict]) -> None:
    """Validate the list-of-dicts input format (the reference's checks and messages)."""
    if not isinstance(preds, Sequence):
        raise ValueError("Expected argument `preds` to be of type Sequence")
    if not isinstance(targets, Sequence):
        raise ValueError("Expected argument `target` to be of type Sequence")
    if len(preds) != len(targets):
        raise ValueError("Expected argument `preds` and `target` to have the same length")

    for k in ["boxes", "scores", "labels"]:
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in ["boxes", "labels"]:
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")

    def _is_arr(x: Any) -> bool:
        return isinstance(x, (Tensor, np.ndarray))

    if any(not _is_arr(p["boxes"]) for p in preds):
        raise ValueError("Expected all boxes in `preds` to be of type Tensor")
    if any(not _is_arr(p["scores"]) for p in preds):
        raise ValueError("Expected all scores in `preds` to be of type Tensor")
    if any(not _is_arr(p["labels"]) for p in preds):
        raise ValueError("Expected all labels in `preds` to be of type Tensor")
    if any(not _is_arr(t["boxes"]) for t in targets):
        raise ValueError("Expected all boxes in `target` to be of type Tensor")
    if any(not _is_arr(t["labels"]) for t in targets):
        raise ValueError("Expected all labels in `target` to be of type Tensor")

    for i, item in enumerate(targets):
        n_boxes = item["boxes"].shape[0] if item["boxes"].ndim > 1 else len(item["boxes"])
        if n_boxes != len(item["labels"]):
            raise ValueError(
                f"Input boxes and labels of sample {i} in targets have a"
                f" different length (expected {n_boxes} labels, got {len(item['labels'])})"
            )
    for i, item in enumerate(preds):
        n_boxes = item["boxes"].shape[0] if item["boxes"].ndim > 1 else len(item["boxes"])
        if not (n_boxes == len(item["labels"]) == len(item["scores"])):
            raise ValueError(
                f"Input boxes, labels and scores of sample {i} in predictions have a"
                f" different length (expected {n_boxes} labels and scores,"
                f" got {len(item['labels'])} labels and {len(item['scores'])} scores)"
            )


def _unique_classes(det_labels: List[np.ndarray], gt_labels: List[np.ndarray]) -> List[int]:
    """Sorted unique class ids across detections and ground truths."""
    labels = list(det_labels) + list(gt_labels)
    if not labels:
        return []
    cat = np.concatenate([np.asarray(lab).reshape(-1) for lab in labels])
    return sorted(int(c) for c in np.unique(cat))


def _to_host(parts: List[Tensor]) -> List[np.ndarray]:
    """Per-image tensors read to the host in one copy (concatenated, then split)."""
    if not parts:
        return []
    flat = torch.cat(parts).cpu().numpy()
    return np.split(flat, np.cumsum([p.shape[0] for p in parts])[:-1])


class MeanAveragePrecision(Metric):
    """COCO-style mean average precision and recall for object detection.

    Inputs are per-image dicts: predictions with ``boxes`` ``[n, 4]``,
    ``scores`` ``[n]``, ``labels`` ``[n]``; targets with ``boxes`` and
    ``labels``; or the batched padded dicts described in the module
    docstring.

    Args:
        box_format: input box layout, "xyxy", "xywh" or "cxcywh".
        iou_thresholds / rec_thresholds / max_detection_thresholds /
            class_metrics: the reference's evaluation grid.
        max_images: table capacity in images; lossless (equal to the list
            mode) while the stream fits, the images of highest hash key
            past it.
        det_slots: per-image detection capacity (default: the largest
            ``max_detection_thresholds`` entry); extra detections are
            dropped lowest score first.
        gt_slots: per-image ground-truth capacity (default ``det_slots``);
            an image exceeding it raises.
        exact: keep the reference's unbounded per-image lists instead.
        device: where the states live and the matching runs (the card
            unless ``device="cpu"``).

    Example:
        >>> import torch
        >>> preds = [dict(
        ...     boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
        ...     scores=torch.tensor([0.536]),
        ...     labels=torch.tensor([0]))]
        >>> target = [dict(
        ...     boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]]),
        ...     labels=torch.tensor([0]))]
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["map"]), 4)
        0.6
    """

    #: the static analysis classifies the default mode: branches on
    #: ``self._exact`` belong to the opt-in exact (list-state) mode
    __exact_mode_attr__ = "_exact"
    is_differentiable = False
    higher_is_better = True
    __fused_mask_valid__ = True

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        max_images: int = 4096,
        det_slots: Optional[int] = None,
        gt_slots: Optional[int] = None,
        exact: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_thresholds = list(iou_thresholds) if iou_thresholds else [0.5 + 0.05 * i for i in range(10)]
        self.rec_thresholds = list(rec_thresholds) if rec_thresholds else [0.01 * i for i in range(101)]
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        self.bbox_area_ranges = dict(_BBOX_AREA_RANGES)

        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics

        last_max_det = self.max_detection_thresholds[-1]
        det_slots = last_max_det if det_slots is None else det_slots
        gt_slots = det_slots if gt_slots is None else gt_slots
        for name, val in (("max_images", max_images), ("det_slots", det_slots), ("gt_slots", gt_slots)):
            if not (isinstance(val, int) and val > 0):
                raise ValueError(f"Argument `{name}` expected to be a positive int, got {val}")
        if det_slots < last_max_det:
            raise ValueError(
                f"Argument `det_slots` ({det_slots}) must cover the largest"
                f" max_detection threshold ({last_max_det})"
            )
        self._det_slots = det_slots
        self._gt_slots = gt_slots
        self._max_images = max_images
        # row: [global_idx, rank, n_det, n_gt, det boxes 4D, scores D,
        #       labels D, gt boxes 4G, labels G]
        self._row_cols = 4 + 6 * det_slots + 5 * gt_slots

        self._exact = bool(exact)
        if self._exact:
            register_exact_list_states(self, _EXACT_STATES, dist_reduce_fx=None)
            warn_exact_buffer("MeanAveragePrecision", "detections and ground truths")
        else:
            self.add_state(
                "table",
                default=detection_table_init(max_images, self._row_cols, self.device),
                dist_reduce_fx=reservoir_merge_fx(),
            )
            # element-wise addition across ranks, through the moments
            # reducer as in the JAX package
            self.add_state(
                "images_seen",
                default=torch.zeros((), dtype=torch.int32, device=self.device),
                dist_reduce_fx=moments_merge_fx(),
            )

    def _boxes_to_xyxy(self, boxes: Tensor) -> Tensor:
        """``[..., 4]`` boxes in ``self.box_format`` to xyxy."""
        if self.box_format == "xyxy":
            return boxes
        a, b, c, d = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
        if self.box_format == "xywh":
            return torch.stack([a, b, a + c, b + d], dim=-1)
        return torch.stack([a - c / 2, b - d / 2, a + c / 2, b + d / 2], dim=-1)  # cxcywh

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------
    def _pack_images(self, preds: Sequence[dict], target: Sequence[dict]) -> Tuple[dict, dict]:
        """The (validated, non-empty) list-of-dicts input as padded dict
        batches on the metric's device: each field concatenated over the
        images and scattered into its padded layout, by shapes alone. Detections keep
        ``max(det_slots, most in one image)`` slots, so the padded path's
        per-image cap applies; an image with more than ``gt_slots`` ground
        truths raises."""
        device, b = self.device, len(preds)

        def flat(x: Any, width: int = 0) -> Tensor:
            t = _as_tensor(x, device).to(device)
            return t.reshape(-1, width) if width else t.reshape(-1)

        d_boxes = [flat(p["boxes"], 4) for p in preds]
        g_boxes = [flat(t["boxes"], 4) for t in target]
        nd = np.array([x.shape[0] for x in d_boxes], np.int64)
        ng = np.array([x.shape[0] for x in g_boxes], np.int64)
        over = np.flatnonzero(ng > self._gt_slots)
        if over.size:
            i = int(over[0])
            raise ValueError(
                f"Image {i} carries {ng[i]} ground-truth boxes but the streaming table"
                f" holds {self._gt_slots} per image — raise `gt_slots` (or use `exact=True`)"
            )
        d_in = max(self._det_slots, int(nd.max(initial=0)))

        def scatter(parts: List[Tensor], counts: np.ndarray, slots: int) -> Tensor:
            values = torch.cat(parts).to(torch.float32)
            out = torch.zeros((b * slots,) + tuple(values.shape[1:]), dtype=torch.float32, device=device)
            if values.shape[0]:
                pos = np.arange(values.shape[0]) - np.repeat(np.cumsum(counts) - counts, counts)
                idx = np.repeat(np.arange(b), counts) * slots + pos
                out[torch.from_numpy(idx).to(device)] = values
            return out.reshape((b, slots) + tuple(values.shape[1:]))

        pred_batch = dict(
            boxes=scatter(d_boxes, nd, d_in),
            scores=scatter([flat(p["scores"]) for p in preds], nd, d_in),
            labels=scatter([flat(p["labels"]) for p in preds], nd, d_in),
            n=torch.from_numpy(nd.astype(np.int32)).to(device),
        )
        target_batch = dict(
            boxes=scatter(g_boxes, ng, self._gt_slots),
            labels=scatter([flat(t["labels"]) for t in target], ng, self._gt_slots),
            n=torch.from_numpy(ng.astype(np.int32)).to(device),
        )
        return pred_batch, target_batch

    def _update_exact(self, preds: Sequence[dict], target: Sequence[dict]) -> None:
        _input_validator(preds, target)
        device = self.device

        def boxes_xyxy(x: Any) -> Tensor:
            t = _as_tensor(x, device).to(device=device, dtype=torch.float32)
            return self._boxes_to_xyxy(t.reshape(-1, 4))

        for item in preds:
            self.detection_boxes.append(boxes_xyxy(item["boxes"]))
            self.detection_labels.append(_as_tensor(item["labels"], device).to(device).reshape(-1).to(torch.int32))
            self.detection_scores.append(_as_tensor(item["scores"], device).to(device).reshape(-1).to(torch.float32))
        for item in target:
            self.groundtruth_boxes.append(boxes_xyxy(item["boxes"]))
            self.groundtruth_labels.append(_as_tensor(item["labels"], device).to(device).reshape(-1).to(torch.int32))

    def _update(self, preds: Any, target: Any, n_valid: Optional[Any] = None) -> None:
        if self._exact:
            self._update_exact(preds, target)
            return
        if not isinstance(preds, dict):
            _input_validator(preds, target)
            if not preds:  # tracelint: disable=TL-TRACE (the list-of-dicts input: its length, not a tensor)
                return
            preds, target = self._pack_images(preds, target)
        device = self.device

        def field(x: Any, dtype: torch.dtype) -> Tensor:
            return _as_tensor(x, device).to(device=device, dtype=dtype)

        d_boxes = self._boxes_to_xyxy(field(preds["boxes"], torch.float32))
        d_scores = field(preds["scores"], torch.float32)
        d_labels = field(preds["labels"], torch.float32)
        d_n = field(preds["n"], torch.int32)
        g_boxes = self._boxes_to_xyxy(field(target["boxes"], torch.float32))
        g_labels = field(target["labels"], torch.float32)
        g_n = field(target["n"], torch.int32)

        b, d_in = d_scores.shape
        if b == 0:
            return
        g_in = g_labels.shape[1]
        if g_in > self._gt_slots:
            raise ValueError(
                f"got {g_in} ground-truth slots but the streaming table holds"
                f" {self._gt_slots} per image — raise `gt_slots`"
            )
        if d_in > self._det_slots:
            # per-image cap: the det_slots best live scores (a stable sort of
            # -score, ties to the lower slot, dead slots keyed NaN so they
            # sort after every live one), restored to arrival order
            live = torch.arange(d_in, device=device)[None, :] < d_n[:, None]
            key = torch.where(live, -d_scores, torch.nan)
            idx = torch.sort(key, dim=1, stable=True).indices[:, : self._det_slots]
            idx = torch.sort(idx, dim=1).values
            d_boxes = torch.gather(d_boxes, 1, idx[:, :, None].expand(-1, -1, 4))
            d_scores = torch.gather(d_scores, 1, idx)
            d_labels = torch.gather(d_labels, 1, idx)
            d_n = torch.clamp(d_n, max=self._det_slots)
            d_in = self._det_slots

        # zero dead slots so admitted rows are bit-deterministic, then pad
        # the slot axes to the table's capacity
        d_live = torch.arange(d_in, device=device)[None, :] < d_n[:, None]
        d_boxes = torch.where(d_live[:, :, None], d_boxes, 0.0)
        d_scores = torch.where(d_live, d_scores, 0.0)
        d_labels = torch.where(d_live, d_labels, 0.0)
        g_live = torch.arange(g_in, device=device)[None, :] < g_n[:, None]
        g_boxes = torch.where(g_live[:, :, None], g_boxes, 0.0)
        g_labels = torch.where(g_live, g_labels, 0.0)
        dpad = self._det_slots - d_in
        gpad = self._gt_slots - g_in
        if dpad:
            d_boxes = F.pad(d_boxes, (0, 0, 0, dpad))
            d_scores = F.pad(d_scores, (0, dpad))
            d_labels = F.pad(d_labels, (0, dpad))
        if gpad:
            g_boxes = F.pad(g_boxes, (0, 0, 0, gpad))
            g_labels = F.pad(g_labels, (0, gpad))

        # hash-key admission over global image indices: pad images (masked
        # by n_valid) advance neither the index nor the table. The process
        # index joins the hash input so ranks holding the same local
        # indices draw different priorities.
        arange_b = torch.arange(b, device=device)
        valid = arange_b < field(n_valid, torch.int64) if n_valid is not None else torch.ones_like(arange_b, dtype=torch.bool)
        global_idx = self.images_seen + torch.cumsum(valid.to(torch.int32), dim=0, dtype=torch.int32) - 1
        rank = process_index()
        keys = reservoir_key(global_idx.to(torch.int64) + rank * (1 << 24))
        rows = torch.cat(
            [
                global_idx.to(torch.float32)[:, None],
                torch.full((b, 1), float(rank), dtype=torch.float32, device=device),
                d_n.to(torch.float32)[:, None],
                g_n.to(torch.float32)[:, None],
                d_boxes.reshape(b, -1),
                d_scores,
                d_labels,
                g_boxes.reshape(b, -1),
                g_labels,
            ],
            dim=1,
        )
        self.table = reservoir_insert_keyed(self.table, rows, keys, n_valid=n_valid)
        self.images_seen = self.images_seen + valid.sum(dtype=torch.int32)

    # ------------------------------------------------------------------
    # compute
    # ------------------------------------------------------------------
    def _compute(self) -> Dict[str, Tensor]:
        if self._exact:
            return self._compute_from_lists(*(_to_host(getattr(self, name)) for name in _EXACT_STATES))

        # the admitted rows, read once, back into per-image host arrays in
        # rank-major arrival order (equal to the list mode while lossless)
        leaf = self.table.cpu().numpy()
        rows = leaf[leaf[:, 0] > _NEG_INF, 1:]
        rows = rows[np.lexsort((rows[:, 0], rows[:, 1]))]
        D, G = self._det_slots, self._gt_slots
        n = rows.shape[0]
        nd = rows[:, 2].astype(np.int32)
        ng = rows[:, 3].astype(np.int32)
        off = 4
        db = rows[:, off : off + 4 * D].astype(np.float32).reshape(n, D, 4)
        off += 4 * D
        ds = rows[:, off : off + D].astype(np.float32)
        off += D
        dl = rows[:, off : off + D].astype(np.int32)
        off += D
        gb = rows[:, off : off + 4 * G].astype(np.float32).reshape(n, G, 4)
        off += 4 * G
        gl = rows[:, off : off + G].astype(np.int32)
        return self._compute_from_lists(
            [db[i, : nd[i]] for i in range(n)],
            [ds[i, : nd[i]] for i in range(n)],
            [dl[i, : nd[i]] for i in range(n)],
            [gb[i, : ng[i]] for i in range(n)],
            [gl[i, : ng[i]] for i in range(n)],
        )

    def _match(self, packed: Any) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Match the packed units on the metric's device, in chunks of at
        most ``_UNIT_CHUNK_ELEMS`` IoU entries, so device memory stays
        bounded whatever the number of units."""
        device = self.device
        U, D = packed.det_valid.shape
        G = packed.gt_valid.shape[1]
        chunk = max(1, _UNIT_CHUNK_ELEMS // max(D * G, 1))
        iou_thrs = torch.tensor(self.iou_thresholds, dtype=torch.float32, device=device)
        areas = torch.from_numpy(np.asarray(list(self.bbox_area_ranges.values()), np.float32)).to(device)
        parts = []
        for lo in range(0, U, chunk):
            hi = min(lo + chunk, U)
            inputs = (packed.det_boxes, packed.det_valid, packed.gt_boxes, packed.gt_valid)
            out = _match_units(*(torch.from_numpy(x[lo:hi]).to(device) for x in inputs), iou_thrs, areas)
            parts.append([t.cpu().numpy() for t in out])
        det_matches, det_area_out, npig = (np.concatenate(p) for p in zip(*parts))
        return det_matches, det_area_out, npig

    def _compute_from_lists(
        self,
        det_boxes: List[np.ndarray],
        det_scores: List[np.ndarray],
        det_labels: List[np.ndarray],
        gt_boxes: List[np.ndarray],
        gt_labels: List[np.ndarray],
    ) -> Dict[str, Tensor]:
        classes = _unique_classes(det_labels, gt_labels)
        num_classes = len(classes)
        num_areas = len(self.bbox_area_ranges)
        T = len(self.iou_thresholds)
        R = len(self.rec_thresholds)
        M = len(self.max_detection_thresholds)
        last_max_det = self.max_detection_thresholds[-1]

        packed = _pack_units(
            [np.asarray(b) for b in det_boxes],
            [np.asarray(s, np.float64) for s in det_scores],
            [np.asarray(lab) for lab in det_labels],
            [np.asarray(b) for b in gt_boxes],
            [np.asarray(lab) for lab in gt_labels],
            classes,
            last_max_det,
        )

        if packed is None:
            precision = -np.ones((T, R, num_classes, num_areas, M))
            recall = -np.ones((T, num_classes, num_areas, M))
        else:
            det_matches, det_area_out, npig = self._match(packed)
            precision, recall = _calculate_precision_recall(
                packed,
                det_matches,
                det_area_out,
                npig,
                num_classes,
                num_areas,
                self.iou_thresholds,
                self.rec_thresholds,
                self.max_detection_thresholds,
            )

        area_keys = list(self.bbox_area_ranges.keys())

        def summ(
            avg_prec: bool,
            iou_thr: Optional[float] = None,
            area: str = "all",
            mdet: int = last_max_det,
            prec: np.ndarray = precision,
            rec: np.ndarray = recall,
        ) -> float:
            return _summarize(
                prec,
                rec,
                avg_prec,
                self.iou_thresholds,
                iou_threshold=iou_thr,
                area_idx=area_keys.index(area),
                mdet_idx=self.max_detection_thresholds.index(mdet),
            )

        # the reference's top-level `map` keeps _summarize's max_dets=100
        # default: with custom thresholds lacking 100 it is -1
        has_100 = 100 in self.max_detection_thresholds

        values: Dict[str, Any] = {}
        values["map"] = summ(True, mdet=100) if has_100 else -1.0
        values["map_50"] = summ(True, iou_thr=0.5) if 0.5 in self.iou_thresholds else -1.0
        values["map_75"] = summ(True, iou_thr=0.75) if 0.75 in self.iou_thresholds else -1.0
        values["map_small"] = summ(True, area="small")
        values["map_medium"] = summ(True, area="medium")
        values["map_large"] = summ(True, area="large")
        for mdet in self.max_detection_thresholds:
            values[f"mar_{mdet}"] = summ(False, mdet=mdet)
        values["mar_small"] = summ(False, area="small")
        values["mar_medium"] = summ(False, area="medium")
        values["mar_large"] = summ(False, area="large")

        map_per_class = [-1.0]
        mar_per_class = [-1.0]
        if self.class_metrics and num_classes:
            map_per_class = []
            mar_per_class = []
            for k in range(num_classes):
                cls_prec = precision[:, :, k : k + 1]
                cls_rec = recall[:, k : k + 1]
                map_per_class.append(summ(True, mdet=100, prec=cls_prec, rec=cls_rec) if has_100 else -1.0)
                mar_per_class.append(summ(False, mdet=last_max_det, prec=cls_prec, rec=cls_rec))
        values["map_per_class"] = map_per_class
        values[f"mar_{last_max_det}_per_class"] = mar_per_class
        return {k: torch.tensor(v, dtype=torch.float32, device=self.device) for k, v in values.items()}
