"""COCO mean-average-precision kernels.

Counterpart of ``metrics_tpu/functional/detection/mean_ap.py``, in three
stages as there:

1. **Host packing** (numpy, copied from the JAX package): ragged per-image
   detections and ground truths become ``(image, class)`` evaluation units
   padded to power-of-two buckets ``[U, D]`` / ``[U, G]``, detections
   sorted by score (descending) within each unit.
2. **Device matching** (:func:`_match_units`, torch on the units' device):
   the IoU of every unit's detections and ground truths through
   :func:`metrics_tpu_torch.ops.box_iou` (the batched IoU kernel on the
   card), then the greedy COCO matching as a loop over detection rank,
   vectorised over units, area ranges and IoU thresholds.
3. **Host PR reduction** (numpy float64, copied): the reference's
   mergesort score order, right-to-left precision envelope and recall-grid
   truncation.
"""
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.functional.classification.sketch_curve import coco_precision_recall_grid
from metrics_tpu_torch.functional.detection.box_ops import box_area
from metrics_tpu_torch.ops.box_iou import box_iou

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# device matching
# ---------------------------------------------------------------------------
def _match_units(
    det_boxes: Tensor,  # [U, D, 4] xyxy, sorted by score desc per unit, zero-padded
    det_valid: Tensor,  # [U, D] bool
    gt_boxes: Tensor,  # [U, G, 4] xyxy, zero-padded
    gt_valid: Tensor,  # [U, G] bool
    iou_thresholds: Tensor,  # [T] f32
    area_ranges: Tensor,  # [A, 2] f32 (lo, hi)
) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy COCO matching for all units x area ranges x IoU thresholds.

    Returns ``det_matches [U, A, T, D]`` (the detection matched an
    unignored ground truth), ``det_area_out [U, A, D]`` (the detection box
    lies outside the area range: unmatched, it is ignored) and
    ``npig [U, A]`` int32 (the number of unignored ground truths). Per IoU
    threshold each detection, in score order, takes the unmatched,
    unignored ground truth of largest IoU (the first of equal ones, as
    ``jnp.argmax`` and ``torch.argmax`` take) iff that IoU is strictly
    above the threshold. Counterpart of the JAX package's
    ``_match_units_kernel``, with its masks and order.
    """
    U, D, _ = det_boxes.shape
    G = gt_boxes.shape[1]

    gt_areas = box_area(gt_boxes)  # [U, G]
    lo = area_ranges[None, :, 0, None]  # [1, A, 1]
    hi = area_ranges[None, :, 1, None]
    gt_area_out = (gt_areas[:, None, :] < lo) | (gt_areas[:, None, :] > hi)  # [U, A, G]
    gt_ignore = gt_area_out | ~gt_valid[:, None, :]
    npig = (gt_valid[:, None, :] & ~gt_area_out).sum(dim=-1).to(torch.int32)  # [U, A]

    det_areas = box_area(det_boxes)  # [U, D]
    det_area_out = (det_areas[:, None, :] < lo) | (det_areas[:, None, :] > hi)  # [U, A, D]

    ious = box_iou(det_boxes, gt_boxes)  # [U, D, G]: the batched IoU kernel on the card
    ious = ious * (det_valid[:, :, None] & gt_valid[:, None, :])

    gt_slot = torch.arange(G, device=det_boxes.device)
    gt_matched = torch.zeros((U, area_ranges.shape[0], iou_thresholds.shape[0], G), dtype=torch.bool, device=det_boxes.device)
    matches: List[Tensor] = []
    for d in range(D):
        blocked = gt_matched | gt_ignore[:, :, None, :]  # [U, A, T, G]
        cand = ious[:, d][:, None, None, :] * ~blocked
        best = cand.amax(dim=-1)  # [U, A, T]
        m = cand.argmax(dim=-1)
        ok = best > iou_thresholds
        gt_matched = gt_matched | ((gt_slot == m[..., None]) & ok[..., None])
        matches.append(ok)
    return torch.stack(matches, dim=-1), det_area_out, npig


# ---------------------------------------------------------------------------
# host packing
# ---------------------------------------------------------------------------
class _PackedUnits(NamedTuple):
    """Static-shape evaluation units plus per-unit host metadata."""

    det_boxes: np.ndarray  # [U, D, 4]
    det_valid: np.ndarray  # [U, D]
    gt_boxes: np.ndarray  # [U, G, 4]
    gt_valid: np.ndarray  # [U, G]
    scores: np.ndarray  # [U, D] score-descending, padding = -inf
    unit_class: np.ndarray  # [U] index into the classes list
    n_det: np.ndarray  # [U]


def _bucket(n: int) -> int:
    """Round up to a power of two (min 1) to bound jit recompilations."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _pack_units_loop(
    det_boxes: Sequence[np.ndarray],
    det_scores: Sequence[np.ndarray],
    det_labels: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    classes: Sequence[int],
    max_det: int,
) -> Optional[_PackedUnits]:
    """Build padded ``(image, class)`` evaluation units.

    A unit exists for image *i*, class *c* iff the image has at least one
    detection AND at least one ground truth overall, and at least one of
    them is of class *c* — the exact skip conditions of reference
    ``_evaluate_image`` (map.py:391-396).
    """
    units = []  # (img, class_idx, det_idx_sorted, gt_idx)
    for i in range(len(gt_boxes)):
        dl = det_labels[i]
        gl = gt_labels[i]
        if len(dl) == 0 or len(gl) == 0:
            # reference map.py:391-392: images with no detections at all or
            # no ground truths at all contribute nothing for any class
            continue
        for k, c in enumerate(classes):
            det_idx = np.flatnonzero(dl == c)
            gt_idx = np.flatnonzero(gl == c)
            if len(det_idx) == 0 and len(gt_idx) == 0:
                continue
            if len(det_idx):
                order = np.argsort(-det_scores[i][det_idx], kind="stable")
                det_idx = det_idx[order][:max_det]
            units.append((i, k, det_idx, gt_idx))

    if not units:
        return None

    D = _bucket(max((len(u[2]) for u in units), default=1) or 1)
    G = _bucket(max((len(u[3]) for u in units), default=1) or 1)
    U = len(units)

    p_det = np.zeros((U, D, 4), np.float32)
    p_det_valid = np.zeros((U, D), bool)
    p_gt = np.zeros((U, G, 4), np.float32)
    p_gt_valid = np.zeros((U, G), bool)
    p_scores = np.full((U, D), -np.inf, np.float64)
    p_class = np.zeros((U,), np.int64)
    p_ndet = np.zeros((U,), np.int64)

    for u, (i, k, det_idx, gt_idx) in enumerate(units):
        nd, ng = len(det_idx), len(gt_idx)
        if nd:
            p_det[u, :nd] = det_boxes[i][det_idx]
            p_det_valid[u, :nd] = True
            p_scores[u, :nd] = det_scores[i][det_idx]
        if ng:
            p_gt[u, :ng] = gt_boxes[i][gt_idx]
            p_gt_valid[u, :ng] = True
        p_class[u] = k
        p_ndet[u] = nd

    return _PackedUnits(p_det, p_det_valid, p_gt, p_gt_valid, p_scores, p_class, p_ndet)


def _pack_units(
    det_boxes: Sequence[np.ndarray],
    det_scores: Sequence[np.ndarray],
    det_labels: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    classes: Sequence[int],
    max_det: int,
) -> Optional[_PackedUnits]:
    """Vectorized unit packing (same output as ``_pack_units_loop``).

    One global lexsort of all detections by (image, class, -score) and one of
    all ground truths by (image, class) replace the per-image/per-class
    Python loops; unit order (image-major, class-minor) and within-unit
    tie order are preserved exactly, which matters because the PR
    reduction's mergesort tie-breaking follows unit order.
    """
    n_imgs = len(gt_boxes)
    class_arr = np.asarray(list(classes), dtype=np.int64)
    num_classes = len(class_arr)
    if n_imgs == 0 or num_classes == 0:
        return None

    # images contributing anything: >=1 detection AND >=1 ground truth
    has_det = np.array([len(l) > 0 for l in det_labels], bool)
    has_gt = np.array([len(l) > 0 for l in gt_labels], bool)
    keep_img = has_det & has_gt
    if not keep_img.any():
        return None

    def _flatten(boxes_seq, labels_seq, scores_seq=None):
        imgs, boxes, labels, scores = [], [], [], []
        for i in np.flatnonzero(keep_img):
            n = len(labels_seq[i])
            imgs.append(np.full(n, i, np.int64))
            boxes.append(np.asarray(boxes_seq[i], np.float32).reshape(n, 4))
            labels.append(np.asarray(labels_seq[i], np.int64).reshape(n))
            if scores_seq is not None:
                scores.append(np.asarray(scores_seq[i], np.float64).reshape(n))
        return (
            np.concatenate(imgs),
            np.concatenate(boxes),
            np.concatenate(labels),
            np.concatenate(scores) if scores_seq is not None else None,
        )

    d_img, d_box, d_label, d_score = _flatten(det_boxes, det_labels, det_scores)
    g_img, g_box, g_label, _ = _flatten(gt_boxes, gt_labels)

    d_cls = np.searchsorted(class_arr, d_label)
    g_cls = np.searchsorted(class_arr, g_label)

    # stable global sorts: detections by (img, class, -score), gts by (img, class)
    d_order = np.lexsort((-d_score, d_cls, d_img))
    d_img, d_box, d_cls, d_score = d_img[d_order], d_box[d_order], d_cls[d_order], d_score[d_order]
    g_order = np.lexsort((g_cls, g_img))
    g_img, g_box, g_cls = g_img[g_order], g_box[g_order], g_cls[g_order]

    # unit ids: unique (img, class) keys over BOTH sides, image-major order
    d_key = d_img * num_classes + d_cls
    g_key = g_img * num_classes + g_cls
    unit_keys = np.unique(np.concatenate([d_key, g_key]))
    U = len(unit_keys)
    d_unit = np.searchsorted(unit_keys, d_key)
    g_unit = np.searchsorted(unit_keys, g_key)

    def _ranks(unit_ids):
        """Position of each element within its (sorted, contiguous) unit run."""
        n = len(unit_ids)
        if n == 0:
            return np.zeros(0, np.int64)
        pos = np.arange(n)
        start = np.zeros(n, np.int64)
        new_run = np.flatnonzero(np.diff(unit_ids)) + 1
        start[new_run] = new_run
        return pos - np.maximum.accumulate(start)

    d_rank = _ranks(d_unit)
    keep = d_rank < max_det  # per-unit detection cap, score-descending
    d_unit_k, d_rank_k = d_unit[keep], d_rank[keep]
    g_rank = _ranks(g_unit)

    n_det = np.bincount(d_unit_k, minlength=U).astype(np.int64)
    n_gt = np.bincount(g_unit, minlength=U).astype(np.int64)
    D = max(_bucket(max(int(n_det.max()), 1)), 1)
    G = max(_bucket(max(int(n_gt.max()), 1)), 1)

    p_det = np.zeros((U, D, 4), np.float32)
    p_det_valid = np.zeros((U, D), bool)
    p_scores = np.full((U, D), -np.inf, np.float64)
    p_det[d_unit_k, d_rank_k] = d_box[keep]
    p_det_valid[d_unit_k, d_rank_k] = True
    p_scores[d_unit_k, d_rank_k] = d_score[keep]

    p_gt = np.zeros((U, G, 4), np.float32)
    p_gt_valid = np.zeros((U, G), bool)
    p_gt[g_unit, g_rank] = g_box
    p_gt_valid[g_unit, g_rank] = True

    p_class = (unit_keys % num_classes).astype(np.int64)
    return _PackedUnits(p_det, p_det_valid, p_gt, p_gt_valid, p_scores, p_class, n_det)


# ---------------------------------------------------------------------------
# host PR reduction (exact float64, reference map.py:608-672 semantics)
# ---------------------------------------------------------------------------
def _calculate_precision_recall(
    packed: _PackedUnits,
    det_matches: np.ndarray,  # [U, A, T, D] bool
    det_area_out: np.ndarray,  # [U, A, D] bool
    npig_units: np.ndarray,  # [U, A] int
    num_classes: int,
    num_areas: int,
    iou_thresholds: Sequence[float],
    rec_thresholds: Sequence[float],
    max_detection_thresholds: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Integrate matches into the COCO precision/recall tables.

    Returns ``precision [T, R, K, A, M]`` and ``recall [T, K, A, M]``
    initialized to -1 (reference map.py:553-554). The per-cell reduction
    (sort, cumulate, zigzag, recall-grid projection) is the shared
    :func:`~metrics_tpu_torch.functional.classification.sketch_curve.coco_precision_recall_grid`;
    this function only assembles each cell's scores/matches/ignore views.
    """
    T = len(iou_thresholds)
    R = len(rec_thresholds)
    M = len(max_detection_thresholds)
    rec_thrs = np.asarray(rec_thresholds, np.float64)

    precision = -np.ones((T, R, num_classes, num_areas, M))
    recall = -np.ones((T, num_classes, num_areas, M))

    # per-max_det validity masks over the padded det axis: element (u, d) is
    # live iff d < min(n_det[u], max_det). Boolean row-major indexing with
    # these masks reproduces the reference's per-unit concatenation order
    # (units ascending, then detection rank) without per-unit Python slicing.
    D = packed.scores.shape[1]
    det_rank = np.arange(D)[None, :]
    live_masks = [
        det_rank < np.minimum(packed.n_det, max_det)[:, None]
        for max_det in max_detection_thresholds
    ]

    for k in range(num_classes):
        sel = np.flatnonzero(packed.unit_class == k)
        if len(sel) == 0:
            continue
        scores_k = packed.scores[sel]  # [S, D]
        matches_k = det_matches[sel]  # [S, A, T, D]
        area_out_k = det_area_out[sel]  # [S, A, D]
        for a in range(num_areas):
            npig = int(npig_units[sel, a].sum())
            if npig == 0:
                continue  # reference map.py:641-642
            for mi, max_det in enumerate(max_detection_thresholds):
                live = live_masks[mi][sel]  # [S, D]
                scores = scores_k[live]  # [nd], unit-major order
                matches = np.moveaxis(matches_k[:, a], 1, 0)[:, live]  # [T, nd]
                ignore = (~matches) & area_out_k[:, a][live][None, :]
                prec_cell, rec_cell = coco_precision_recall_grid(
                    scores, matches, ignore, npig, rec_thrs
                )
                precision[:, :, k, a, mi] = prec_cell
                recall[:, k, a, mi] = rec_cell
    return precision, recall


def _summarize(
    precision: np.ndarray,  # [T, R, K, A, M]
    recall: np.ndarray,  # [T, K, A, M]
    avg_prec: bool,
    iou_thresholds: Sequence[float],
    iou_threshold: Optional[float] = None,
    area_idx: int = 0,
    mdet_idx: int = -1,
) -> float:
    """Mean of table entries > -1 for one (iou, area, maxdet) selection.

    Parity with reference ``_summarize`` (map.py:478-521).
    """
    vals = precision if avg_prec else recall
    if iou_threshold is not None:
        t = list(iou_thresholds).index(iou_threshold)
        vals = vals[t : t + 1]
    vals = vals[..., area_idx, mdet_idx]
    found = vals[vals > -1]
    return float(found.mean()) if found.size else -1.0
