"""The plain code beside ``criteo-kaggle.json``: its inputs, its collection,
its reference, its control and its comparison.

The sketched AUROC's own error against the exact value is wide enough that a
sketch kept in lower precision could pass on the values alone, so each
checked pass also holds the program's sketches against a plain float64
copy of the absorb fed the same batches in the same order
(``reference.sketch_insert``): the earth mover's distance of their weighted
key distributions (of the weight and of the positive mass), and the gap of
their total weight and positive mass. The values are held
against the weighted curves over the reference's sketch.
"""
from typing import Any, Dict, List

import torch

from portbench import generators, program, roofline
from portbench import reference as ref


def _capacity(cfg: Dict[str, Any]) -> int:
    """The sketch capacity every member is built with (one for all)."""
    (capacity,) = {kwargs["sketch_capacity"] for _, kwargs in cfg["collection"].values()}
    return capacity


def make_sets(cfg: Dict[str, Any], seed: int, n_sets: int, device: torch.device, rank: int, world: int) -> List[Dict[str, Any]]:
    g = generators.generator(seed, device)
    share = program.rank_bounds(cfg["rows"], rank, world)
    sets = []
    for _ in range(n_sets):
        score, clicked = generators.click_stream(g, cfg["rows"], cfg["positive_rate"], cfg["score_lift"], device)
        sets.append(
            {"score": score, "clicked": clicked, "batches": generators.batches((score, clicked), cfg["batch"], share.start, share.stop)}
        )
    return sets


def build_collection(cfg: Dict[str, Any], device: torch.device) -> Any:
    return program.build_collection(cfg["collection"], device)


def rows_per_pass(cfg: Dict[str, Any]) -> int:
    return cfg["rows"]


def snapshot(collection: Any) -> Dict[str, torch.Tensor]:
    """A copy of each member's sketch, taken before ``reset()``."""
    return {key: m.csketch.clone() for key, m in collection.items() if hasattr(m, "csketch")}


def _sketch_values(cfg: Dict[str, Any], data: Dict[str, Any], store_dtype: torch.dtype) -> Dict[str, Any]:
    sketch = ref.sketch_init(_capacity(cfg), 1, data["score"].device)
    for score, clicked in data["batches"]:
        sketch = ref.sketch_insert(sketch, score, clicked.to(torch.float64)[:, None], store_dtype)
    w, key, y = sketch[:, 0], sketch[:, 1], sketch[:, 2]
    return {"sketch": sketch, "auroc": ref.weighted_auroc(key, y, w), "ap": ref.weighted_average_precision(key, y, w)}


def reference(cfg: Dict[str, Any], data: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's sketch and values over one prediction set (the rows
    this rank fed, in order), in float64."""
    return _sketch_values(cfg, data, torch.float64)


def control(cfg: Dict[str, Any], data: Dict[str, Any]) -> Dict[str, Any]:
    """The reference in the program's place one precision down: inputs and
    the kept sketch rows in bfloat16."""
    out = _sketch_values(cfg, data, torch.bfloat16)
    sketch = out.pop("sketch")
    return {"values": out, "snapshot": {key: sketch for key in cfg["collection"]}}


def compare(cfg: Dict[str, Any], values: Dict[str, Any], snapshot: Dict[str, torch.Tensor], expected: Dict[str, Any]) -> Dict[str, float]:
    want = expected["sketch"]
    missing = [key for key in cfg["collection"] if key not in (snapshot or {})]
    w1 = [ref.sketch_w1_gap(s, want) for s in snapshot.values()] if not missing else [float("inf")]
    mass = [ref.sketch_mass_gap(s, want) for s in snapshot.values()] if not missing else [float("inf")]
    return {
        "sketch_w1_gap": max(w1),
        "sketch_mass_gap": max(mass),
        "auroc_gap": abs(float(values["auroc"]) - expected["auroc"]),
        "ap_gap": abs(float(values["ap"]) - expected["ap"]),
    }


def _compactions(cfg: Dict[str, Any], batch_rows: List[int]) -> List[int]:
    """Rows of each compaction one sketch runs over a pass: a chunk of at
    most ``capacity`` rows compacts once the rows it may hold pass the
    capacity (the program's occupancy bound)."""
    capacity = _capacity(cfg)
    bound, rows = 0, []
    for n in batch_rows:
        for lo in range(0, n, capacity):
            chunk = min(capacity, n - lo)
            if bound + chunk <= capacity:
                bound += chunk
            else:
                rows.append(capacity + chunk)
                bound = capacity
    return rows


def kernel_work(cfg: Dict[str, Any], traced: List[Dict[str, Any]], world: int) -> Dict[str, float]:
    """Bytes per pass that each sketch member's compactions need: K3 over the
    packed rows, K1 over the weighted rows by bucket (int32 ids, ``capacity
    // 2 + 4`` segments)."""
    sketches = sum(1 for cls, _ in cfg["collection"].values() if cls in ("AUROC", "AveragePrecision"))
    segments = _capacity(cfg) // 2 + 4
    k3 = k1 = 0.0
    for data in traced:
        for n in _compactions(cfg, [b[0].shape[0] for b in data["batches"]]):
            k3 += sketches * roofline.qsketch_sort_bucket_bytes(n, 3)
            k1 += sketches * roofline.segment_sum_f32_bytes(roofline.next_pow2(n), 3, 4, segments)
    passes = max(len(traced), 1)
    return {"qsketch_sort_bucket.update": k3 / passes, "segment_sum_f32.update": k1 / passes}
