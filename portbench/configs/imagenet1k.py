"""The plain code beside ``imagenet1k.json``: its inputs, its collection,
its reference, its control and its comparison.

Compared, for every checked pass: the confusion matrix cell by cell (exact:
counts), the largest gap of a class's AUROC (float64 midranks; a class
undefined on one side and not the other counts as infinitely far), and the
gaps of top-1 and top-5 accuracy, to the reference's values over the same
prediction set. The macro mean of AUROC moves too little for scores held in
bfloat16 to show (its readings overlap the program's); single classes do.
"""
from typing import Any, Dict, List

import torch

from portbench import generators, program, roofline
from portbench import reference as ref


def make_sets(cfg: Dict[str, Any], seed: int, n_sets: int, device: torch.device, rank: int, world: int) -> List[Dict[str, Any]]:
    g = generators.generator(seed, device)
    share = program.rank_bounds(cfg["rows"], rank, world)
    sets = []
    for _ in range(n_sets):
        preds, target = generators.softmax_classes(g, cfg["rows"], cfg["classes"], cfg["assumed"]["logit_margin"], device)
        sets.append(
            {"preds": preds, "target": target, "batches": generators.batches((preds, target), cfg["batch"], share.start, share.stop)}
        )
    return sets


def build_collection(cfg: Dict[str, Any], device: torch.device) -> Any:
    return program.build_collection(cfg["collection"], device)


def rows_per_pass(cfg: Dict[str, Any]) -> int:
    return cfg["rows"]


def snapshot(collection: Any) -> None:
    return None


def _values(cfg: Dict[str, Any], preds: torch.Tensor, target: torch.Tensor) -> Dict[str, Any]:
    c = cfg["classes"]
    return {
        "confmat": ref.confusion_matrix(preds, target, c).cpu(),
        "auroc": ref.multiclass_auroc(preds, target, c)[0].cpu(),
        "top1": ref.topk_accuracy(preds, target, 1),
        "top5": ref.topk_accuracy(preds, target, 5),
    }


def reference(cfg: Dict[str, Any], data: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's values over one prediction set, in float64."""
    return _values(cfg, data["preds"], data["target"])


def control(cfg: Dict[str, Any], data: Dict[str, Any]) -> Dict[str, Any]:
    """The reference in the program's place one precision down: the scores
    held in bfloat16. Returns ``{"values", "snapshot"}`` as a pass does."""
    return {"values": _values(cfg, data["preds"].to(torch.bfloat16), data["target"]), "snapshot": None}


def _gap(got: Any, want: float) -> float:
    return abs(float(got) - want)


def _class_gap(got: Any, want: torch.Tensor) -> float:
    got = torch.as_tensor(got, dtype=torch.float64).reshape(-1)
    if got.shape != want.shape or bool((torch.isnan(got) != torch.isnan(want)).any()):
        return float("inf")
    defined = ~torch.isnan(want)
    return float((got[defined] - want[defined]).abs().max()) if bool(defined.any()) else 0.0


def compare(cfg: Dict[str, Any], values: Dict[str, Any], snapshot: Any, expected: Dict[str, Any]) -> Dict[str, float]:
    confmat = torch.as_tensor(values["confmat"]).to(torch.int64)
    off = int((confmat != expected["confmat"]).sum()) if confmat.shape == expected["confmat"].shape else confmat.numel()
    return {
        "confmat_cells_off": float(off),
        "auroc_class_gap": _class_gap(values["auroc"], expected["auroc"]),
        "top1_gap": _gap(values["top1"], expected["top1"]),
        "top5_gap": _gap(values["top5"], expected["top5"]),
    }


def kernel_work(cfg: Dict[str, Any], traced: List[Dict[str, Any]], world: int) -> Dict[str, float]:
    """Bytes per pass that the kernels' work needs, averaged over the traced
    passes' prediction sets: the confusion matrix's bincount per update
    (int64 ids ``target * C + argmax``, each touched bin written once) and
    the rank sums of compute (``[capacity, 2]`` float32 rows, int64 labels,
    ``C`` segments; ``world`` ranks' buffers once synced)."""
    c = cfg["classes"]
    capacity = cfg["collection"]["auroc"][1]["capacity"]
    bincount = 0.0
    for data in traced:
        for preds, target in data["batches"]:
            ids = target * c + preds.argmax(dim=1)
            bincount += roofline.bincount_i32_bytes(ids.numel(), 8, int(torch.unique(ids).numel()))
    return {
        "bincount_i32.update": bincount / max(len(traced), 1),
        "segment_sum_f32.compute": float(roofline.segment_sum_f32_bytes(capacity * world, 2, 8, c)),
    }
