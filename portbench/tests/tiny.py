"""Configurations of the benchmark's cells cut to sizes a test run holds on
the CPU (the overrides a test hands ``harness.run_cell``)."""

# 200 classes over 3000 rows: enough close top scores that bfloat16 ties
# some of them, which the control needs in order to fail
IMAGENET = {
    "rows": 3000,
    "classes": 200,
    "batch": 512,
    "collection": {
        "confmat": ["ConfusionMatrix", {"num_classes": 200}],
        "auroc": ["AUROC", {"num_classes": 200, "capacity": 4096, "average": None}],
        "top1": ["Accuracy", {}],
        "top5": ["Accuracy", {"top_k": 5}],
    },
}

CRITEO = {
    "rows": 5000,
    "batch": 1024,
    "collection": {
        "auroc": ["AUROC", {"sketch_capacity": 256}],
        "ap": ["AveragePrecision", {"sketch_capacity": 256}],
    },
    # at 5000 rows one row is 2e-4 of the mass: a row that float32 rounding
    # puts in the next bucket moves the tiny sketch (and its AP) far more
    # than it moves the cell's 6,553,600-row one
    "limits": {"sketch_w1_gap": 2e-4, "sketch_mass_gap": 1e-5, "auroc_gap": 2e-5, "ap_gap": 3e-4},
}

BY_CELL = {
    "imagenet1k.val-fused": IMAGENET,
    "imagenet1k.val-eager": IMAGENET,
    "criteo-kaggle.eval-fused": CRITEO,
}

#: the four-rank cell that ``traffic/val-ddp4.json`` and
#: ``layer_metrics/sync_ms.py`` are ready for: not in BENCHMARK.json until it
#: has run on four cards, so the tests add its entries to a copy
DDP_CELL = "imagenet1k.val-ddp4"


def with_ddp_cell(root, tmp_path):
    """A copy of the benchmark under ``tmp_path`` whose BENCHMARK.json also
    names the four-rank cell and its ``sync_ms`` metric; returns the copy's root."""
    import json
    import shutil

    shutil.copytree(root / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": DDP_CELL, "config": "imagenet1k", "traffic": "val-ddp4", "chips": 4, "why": "four NCCL ranks, states gathered in compute()"}
    )
    bench["per_layer"].append(
        {"name": "sync_ms", "unit": "ms", "better": "lower", "source": "program_span", "layer": "sync: parallel/distributed.py", "moves": "result_ms_p95", "workloads": [DDP_CELL]}
    )
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path

SEED = 2**40 + 7
