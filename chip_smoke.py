"""Drive the PyTorch/CUDA port (metrics_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build   -- compile csrc/segment_sum.cu, csrc/segment_extremum.cu,
   csrc/qsketch.cu, csrc/box_iou.cu and csrc/row_topk.cu with nvcc, one
   process per source, started together (seconds, ptxas report);
2. parity  -- each kernel against its plain PyTorch version on the same card
   tensors (run after the retrieval phases, whose input it takes):
   bincount_i32 at the ConfusionMatrix shape (4096 ids, 10**6
   bins) plus negative and out-of-range ids, bit-exact; segment_sum_f32 at
   [4096,2]->1000 (the rank-AUROC sums), [4096,1]->10**6, [32768,16]->2052
   and [4096,130]->1000, bit-exact on integer-valued data and within the
   float32 summation bound otherwise, bit-identical to the plain version run
   on the CPU (both add each output in row order), and bit-identical across
   two runs; segment_sum_f32 at its skewed inputs too -- the sketch's own
   compaction input [16384,3]->4100 captured from a sketch-binary update
   (the pad rows share one bucket), the retrieval insert's own
   [2048]->8192 counter input, [65536,3]->4100 with 90% of the rows in one
   segment, [16384,2002]->4100 and [1048576]->64 -- each bit-identical to
   the plain version on the CPU, across two runs and with int32 against
   int64 ids, with its ms and device ms; qsketch_sort_bucket (the sketch compaction's sort, prefix sum
   and bucket map) at [1024,3], [16384,3], [32768,16], [12288,2002], a
   ragged [5001,4] with tied keys and zero-weight rows, [4096,3] with every
   key equal, with every weight 0, with NaN keys of both signs and with +-0
   keys, [1,3] and [131072,3] (four merge passes), on integer weights:
   weighted rows, bucket ids and permutation bit-exact against the plain
   version on the card and on the CPU (NaN by position) and across two
   runs, and the whole compaction chain bit-exact against its plain
   version; parity_box_iou:
   box_iou_pairwise (K5) at [1024,1024], [4096,4096] and [1000,3000] and
   box_iou_batched (K6) at [65536,8,8], [4096,128,32], [1024,128,128],
   [16384,64,16] and [1000,100,30], with zero-area, touching, inverted and
   zero-padded boxes; widths 1, 2 and 3 mod 4 (K5 [1000,3001], [999,3002],
   [1001,3003]; K6 [1000,100,30], [4096,16,5], [4096,16,7]), one-box rows
   and units (K5 [1,4096], [4096,1]; K6 [65536,1,8], [65536,8,1],
   [65536,1,1]); float64 at [4096,4096] and [65536,8,8]; and boxes of NaN
   of both signs, +-0, +-inf, a subnormal and a huge value (K5 [2048,2047],
   K6 [8192,8,6], float32 and float64): bit-exact against the plain version
   on the card and on the CPU and a second call against the first, ms per
   call for each case; and K5 at [32768,65540], past 2**31 outputs (64-bit
   offsets), against the plain version on the card and run to run;
   parity_row_topk: row_topk (K4) at [2048,2176] k=64 (an insert chunk's
   widened rows) with 8 rows of the row mask set, [8192,2176] k=64 with 8
   rows set and with every row, [16384,256] k=128, [64,256] k=16,
   [8192,2048] k=1024, a ragged [1000,3000] k=100 and [16,40000] k=10 (past
   one block's shared memory), on ties, NaN of both signs, signed zeros,
   +-inf, invalid slots and rows with fewer valid slots than k; then rows
   whose keys tie at the threshold, rows of only NaN and -inf, k=1, k=n,
   masked rows with fewer valid slots than k and [16,40000] k=20000
   (survivors sorted in global memory): bit-exact against the plain version
   on the card and on the CPU and across two runs, ms per call for each
   shape; parity_segment_extremum:
   segment_max_f32 and segment_min_f32 (K2) at [256]->1000 (the sliced
   update), [4096]->1000, [4096]->100000, [8192,256]->128 (the TPU route's
   width cap), [4096,1000]->64 (past it), [1048576]->64, the same with
   every row in one segment, and [16,3]->5, on
   ties, NaN of both signs, signed zeros, +-inf, empty segments and ids
   that drop (negative, past S, int64 past int32), and segment_sum_i32 at
   [4096]->1000, ->100000, [1048576]->64 and the same in one segment, on
   wrapping int32 sums: bit-exact (NaN by
   position) against the plain version on the card and on the CPU, across
   two runs, int32 ids equal to int64 ids; ms, device ms (a fold and the
   combine of its row splits summed), plain ms, the library call's ms
   (scatter_reduce_ / index_add_), host us per call and the byte bound for
   each shape;
3. flagship -- the main path: 50 pre-stacked 4096x1000 softmax batches
   (seed 42, the fixture of bench.py), per step ConfusionMatrix.update_state
   plus auroc_rank_multiclass; launch counters reset just before and read
   just after; the confusion matrix checked bit-exactly against np.bincount
   and the last batch's AUROC against scipy midranks to 1e-6; then three
   steps under torch.profiler: device time per step, the device's idle
   share, and a table by kernel on standard error;
4. stateful -- MetricCollection(ConfusionMatrix, AUROC(capacity=65536)) over
   12 batches (49,152 rows), launch counters reset and read likewise,
   computed values checked against the same numpy references;
4b. classification-collection -- bench.py's bench_fused data (seed 7, 10
   classes, softmax rows in batches of 1900/2000/2048 cycled ten times: 30
   updates) through the port's eager MetricCollection of Accuracy, macro
   Precision, Recall and F1Score, ConfusionMatrix, CohenKappa,
   MatthewsCorrCoef and JaccardIndex (three compute groups); the first
   update forms the groups, then the launch counters are reset and the
   other 29 timed (one bincount_i32 launch each); gates: every state bit
   for bit against the same run on the CPU and against a second card run,
   every value within rtol 1e-6 / atol 1e-7 of the CPU (kappa and MCC
   atol 1e-5), top-1 accuracy equal to numpy's count and the confusion
   matrix to np.bincount; updates/s, ms per update, compute ms, host syncs
   per update (warnings of torch.cuda.set_sync_debug_mode("warn") over
   three updates), device ms per update, idle share and top device ops
   (three updates under torch.profiler), the compute groups;
4c. classification-flagship -- 12 flagship batches through eleven metrics
   (Accuracy, Accuracy(top_k=5), macro Precision, Recall and F1Score,
   weighted Specificity, HammingDistance, StatScores(reduce="macro"),
   MatthewsCorrCoef, quadratic CohenKappa, JaccardIndex, all at 1000
   classes), the same gates (top-1 and top-5 counts against numpy's argmax
   and stable argsort, every group's confusion matrix against np.bincount)
   and the same fields;
4d. curve-binary -- bench.py's bench_sketch stream (seed 10, 245 batches
   of 4096 uniform scores, positives at rate 0.35) through
   MetricCollection([ROC(), PrecisionRecallCurve(), AveragePrecision(),
   AUROC()]) (the sketched defaults, capacity 8192; the first update forms
   the compute groups, then the launch counters are reset), then
   AUROC(exact=True), AveragePrecision(exact=True) and
   AveragePrecision(capacity=2**20); gates: after 2 batches (the lossless
   window) every sketched output equal bit for bit to its exact=True twin
   on the card; over the stream exact AP and AUROC within 1e-6 of float64
   numpy (step sums, scipy midranks), the capacity AP within 1e-6 of
   float64 (its float32 sum is another formula than the exact curve's, so
   not bit-equal to it), the sketched AP, AUROC and ROC area within 5e-3 of
   exact; over the first 16 batches every state and both curves bit-equal
   to the CPU run and all outputs to a second card run, the summed values
   within 1e-6 of the CPU; qsketch_sort_bucket and segment_sum_f32 launched
   once per compaction of each sketch group; ms per update, device ms per
   update, idle share, host syncs per update, the groups, compute ms per
   metric and state bytes;
4e. curve-multiclass -- 12 flagship batches through AveragePrecision(1000
   classes, weighted, exact=True) (one bincount_i32 of [49152] -> 1000 at
   compute), the sketched AveragePrecision(num_classes=1000) (K3 and K1 at
   2002 columns), ROC(num_classes=1000, capacity=65536),
   BinnedAveragePrecision(1000 classes, 100 thresholds) (two bincount_i32
   of [4096000] -> 100000 per update: every sample, the positives) and
   CalibrationError(15 bins) in l1 and max (one segment_sum_f32 of
   [4111, 3] -> 15 per update each: the 15 old bin sums, then the batch);
   gates: the binned TPs/FPs/FNs equal numpy's counts, CalibrationError's
   counts exact, its sums bit-equal to the CPU run and within the float32
   row-order summation bound ((n - 1) 2**-24 of the total) of float64, the exact weighted AP within 1e-5 of float64 per-class step
   sums, the sketched macro AP within 5e-3 of float64's, the capacity
   ROC's points bit-equal to the exact per-class ROC; the same fields and
   the peak memory;
5. sketch-binary -- the sketched default AUROC() (capacity 8192) streams
   800 batches of 8192 (6,553,600 samples, seed 42: y = rand < 0.26, score
   = sigmoid(randn + 1.2 y)); launch counters reset and read likewise (every
   batch after the first compacts once: 799 launches of each kernel); ms per
   update, warm compute() ms (median of 5 after a cold one), state bytes,
   and five updates under torch.profiler; gates: AUROC within 5e-3 of the
   float64 midrank AUROC of the whole stream, total sketch weight exactly
   6,553,600, and within 1e-6 of the same stream through the port on the
   CPU (the count of sketch rows that differ bitwise is printed);
6. sketch-window -- AUROC() over the first 8192 samples (inside the
   lossless window: no compaction) within 1e-6 of scipy, and the binary
   capacity mode AUROC(capacity=8192) on the same samples likewise;
7. sketch-multiclass -- AUROC(num_classes=1000) over 12 flagship batches
   (sketch rows of 2002 columns, 10 compactions), checked against the port
   on the CPU within the float32 summation bound; its error against scipy
   is printed;
8. map-coco -- the main path of K6: COCO mAP over the COCO-shaped fixture
   of bench.py at the size of COCO val2017 (5000 images, seed 3, 91
   classes, 10-100 detections and 1-30 ground truths per image), fed as
   lists of per-image card tensors, 16 images per update (313 updates),
   through MeanAveragePrecision(class_metrics=True, max_images=8192);
   launch counters reset before the updates and read after the cold
   compute(); ms per update, cold and warm (median of 3) compute seconds,
   images/s, table bytes, peak device memory; gates: every result key equal
   bit for bit to the port's CPU run of the same stream and to an
   exact=True run on the card, and images_seen 5000;
9. map-default -- the same stream through the default capacity (4096
   images, past capacity): the admitted images equal the 4096 ids of
   highest hash key computed in numpy, and card and CPU results are equal
   bit for bit;
10. map-pycoco -- the two-batch COCO fixture of the JAX package's tests
   within its tolerance (1e-1) of pycocotools' official numbers; the
   largest deviation per key is printed;
11. retrieval-mslr -- the main path of K4: bench.py's config-4 fixture
   (seed 7, 5000 queries of 40-199 documents, 587,354 documents, 8%
   relevant) as card tensors in updates of 16,384 documents through
   MetricCollection([RetrievalNormalizedDCG(max_queries=8192),
   RetrievalMAP(max_queries=8192)]) (two compute groups, so two tables, each
   287 insert chunks); launch counters reset before the updates and read
   after the cold compute() (one row_topk and three segment_sum_f32
   launches per chunk and table); ms per update, cold and warm compute ms,
   queries/s, table bytes, peak device memory, two updates under
   torch.profiler; gates: tables and results bit-identical to the port's
   CPU run of the stream, every row's NSEEN/POS/NEG equal to numpy's
   per-query counts, every compacted row holding 64 to 128 documents;
12. retrieval-window -- the same stream with max_docs=256 (lossless): the
   table's layout equal bit for bit to the exact=True pack, NDCG and MAP
   within 1e-6 of exact=True on the card and within 1e-5 of numpy float64;
13. retrieval-sampled -- the defaults (1024 queries, past capacity): the
   admitted queries equal the 1024 of highest (hash key, -id) in numpy, card
   and CPU bit-identical;
14. retrieval-merge -- the stream split at its middle document into two
   collections merged with merge_states: at max_docs=128 card and CPU
   bit-identical, one row_topk launch per merged table; at max_docs=256 the
   merged layout equal to the single stream's;
15. sliced-psnr -- the main path of K2: SlicedMetric(PeakSignalNoiseRatio(),
   num_slices=1000) on the card over 16 updates of 256 images of 3x256x256
   (targets uniform, preds the targets plus 0.05 N(0,1), tenant ids uniform
   over 1000 with six dropped rows; each update made on the card from its
   own seed); launch counters reset before the updates and read after the
   cold compute() (per update one segment_max_f32, one segment_min_f32,
   one segment_sum_f32 and two segment_sum_i32); gates: the states after 4
   updates equal to the port's CPU run bit for bit; after 16 the min/max,
   counts and rows exact and the squared error within rtol 1e-5 of float64,
   compute() within 1e-4 dB of the float64 PSNR with NaN exactly on the
   empty tenants, compute(slice_ids=) and compute(top_k=10) equal to
   gathers of compute(); ms per update, images/s, compute ms, state bytes,
   peak memory, two profiled updates and the device's idle share;
16. sliced-mse -- bench.py's bench_sliced fixture (seed 8, integer-valued
   rows in batches of 3072/3584/4096) at 1000 tenants (12 batches) and
   100,000 (6 batches), states bit-identical to a numpy per-slice
   fan-out, rows/s, and segment_sum_f32's device time at each shape;
17. windowed-psnr -- WindowedMetric(SlicedMetric(PSNR(), 1000), window=8,
   updates_per_bucket=4) over 40 updates of the same traffic (the ring
   wraps); compute(), compute(window=2) and compute(window=3, before=1),
   in that order and reversed, each against a fresh SlicedMetric fed that
   window's updates (regenerated from their seeds): max/min/count leaves
   exact, squared error within rtol 1e-6, values within 1e-4 dB;
18. windowed-decay -- bench.py's bench_windowed stream (seed 12, 120
   updates of about 2048 rows) through WindowedMetric(MSE(), mode="decay",
   decay=0.99) and the ring WindowedMetric(MSE(), window=8,
   updates_per_bucket=4): card and CPU states bit for bit, decay within
   1e-5 of a float64 recurrence, the ring equal to its window's batches;
19. the kernels line: per kernel its launches on its main path (flagship for
   K1, sketch-binary for K3, map-coco for K6, the entry point ops.box_iou
   on 2-D boxes for K5, retrieval-mslr for K4, sliced-psnr for K2 and
   segment_sum_i32), its error against the plain
   version, and its time, the plain version's time, the library call's
   time (none computes box IoU) and the byte bound, all at the main paths'
   shapes (K4 at a chunk's own widened [2048,2176] rows and overflow mask,
   and with every row active; K2 and segment_sum_i32 at the sliced
   update's [256] -> 1000; segment_sum_f32 also at the sketch-binary
   compaction's and the retrieval insert's own skewed inputs, each with its
   path's launches; bincount_i32 also at the classification phases' own
   ids, [2048] -> 100 bins and [4096] -> 10**6, with each phase's
   launches; the curve phases' own inputs, each with its launches at that
   shape: bincount_i32 at the binned [4096000] -> 100000 (beside the
   device time of segment_sum_f32 computing the same counts from
   [4096000, 2] rows) and at the weighted AP's [49152] -> 1000,
   segment_sum_f32 at CalibrationError's [4111, 3] -> 15, K3 at
   curve-binary's compaction input); each device time per wrapper call (every CUDA kernel
   the wrapper issues, merge passes and combines included, summed) with the
   number of profiler windows it took (a window that saw no launch is taken
   again, at most three in all).

PERF.md gives the run times measured on an H100 and where they go. Then the card's name
and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the script exits non-zero and prints no result line; it does the
same without CUDA, or without the metrics_tpu_torch package beside it.
"""
import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from importlib import import_module

import numpy as np

BATCH = 4096
NUM_CLASSES = 1000
ITERS = 50
WARMUP = 1
CAPACITY = 65536
STATEFUL_BATCHES = 12
#: classification-collection: bench.py's bench_fused data (10 classes, three
#: ragged batch shapes cycled ten times); classification-flagship: 12 batches
CLS_CLASSES = 10
CLS_SHAPES = (1900, 2000, 2048)
CLS_REPEATS = 10
CLS_FLAGSHIP_BATCHES = 12
#: curve-binary: bench.py's bench_sketch stream (seed 10, 245 batches of 4096
#: uniform scores, positives at rate 0.35); the first 2 batches fill the
#: sketch (its lossless window), the first 16 are also run on the CPU
CURVE_SEED = 10
CURVE_BATCH = 4096
CURVE_BATCHES = 245
CURVE_POSITIVE_RATE = 0.35
CURVE_WINDOW_BATCHES = 2
CURVE_CPU_BATCHES = 16
CURVE_AP_CAPACITY = 2**20
#: curve-multiclass: 12 flagship batches; the capacity ROC's buffer, the
#: binned AP's thresholds and CalibrationError's bins
CURVE_MC_BATCHES = 12
CURVE_ROC_CAPACITY = 65536
CURVE_THRESHOLDS = 100
CURVE_CE_BINS = 15
#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), for the byte bounds
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "metrics_tpu_torch/csrc/segment_sum.cu"
REPLACES = "metrics_tpu/ops/scatter_pallas.py:68"
QSKETCH_SOURCE = "metrics_tpu_torch/csrc/qsketch.cu"
QSKETCH_REPLACES = "metrics_tpu/ops/qsketch_pallas.py:149"
TIMING_LAUNCHES = 200
# torch.profiler windows taken at most for one kernel's device time
PROFILE_WINDOWS = 5
#: the sketched default: capacity, batch, batches (one test day of a
#: display-ads click log) and the positive rate of that stream
SKETCH_CAPACITY = 8192
SKETCH_BATCH = 8192
SKETCH_BATCHES = 800
CTR_POSITIVE_RATE = 0.26
SKETCH_MC_BATCHES = 12
COMPUTE_REPEATS = 5
#: box IoU: the sources and TPU kernels, the parity shapes ([N, M] for K5;
#: [U, D, G] for K6: the COCO fixture's chunk, the TPU route's measured
#: shapes and a ragged one) and the byte-bound shapes of the kernels line
BOX_IOU_SOURCE = "metrics_tpu_torch/csrc/box_iou.cu"
K5_REPLACES = "metrics_tpu/ops/box_iou_pallas.py:54"
K6_REPLACES = "metrics_tpu/ops/box_iou_pallas.py:104"
#: the edge shapes: widths 1, 2, 3 mod 4 (runs of 1 or 2 columns), one-box
#: rows and units
K5_PARITY_SHAPES = (
    (1024, 1024), (4096, 4096), (1000, 3000), (1000, 3001), (999, 3002), (1001, 3003), (1, 4096), (4096, 1),
)
K6_PARITY_SHAPES = (
    (65536, 8, 8), (4096, 128, 32), (1024, 128, 128), (16384, 64, 16), (1000, 100, 30),
    (4096, 16, 5), (4096, 16, 7), (65536, 1, 8), (65536, 8, 1), (65536, 1, 1),
)
K5_LINE_SHAPE = (4096, 4096)
K6_LINE_SHAPE = (65536, 8, 8)
#: past 2**31 outputs (8.6 GB): the kernel's 64-bit offsets
K5_WIDE_SHAPE = (32768, 65540)
#: the coordinates of the edge-value boxes: NaN of both signs, +-0, +-inf, a
#: subnormal and a huge value, beside small integers
IOU_EDGE_VALUES = (0.0, -0.0, 1.0, -1.0, 2.0, 3.0, 7.5, 1e-40, 3e38, float("inf"), float("-inf"), float("nan"), float("-nan"))
#: the COCO-val-sized detection stream: images, images per update, classes,
#: seed, and a table capacity that holds them all
MAP_IMAGES = 5000
MAP_BATCH = 16
MAP_CLASSES = 91
MAP_SEED = 3
MAP_LOSSLESS_CAPACITY = 8192
#: per-row top-k (K4): the source, the TPU kernel, and the parity cases
#: (name, rows, columns, k, active rows or None for all, inputs): the table
#: insert's widened rows with the overflow mask of about 7 rows and with all
#: rows, the merge, bench.py's parity shape, the TPU route's cap, a ragged
#: shape and a width past one block's 16384 keys, on mixed inputs (ties, NaN
#: of both signs, signed zeros, +-inf, invalid slots); then rows whose keys
#: tie at the threshold ("tied": three values, every other row one value),
#: rows of only NaN and -inf ("nan_inf"), k = 1, k = n, masked rows with
#: fewer valid slots than k ("few_valid"), and survivors past one block's
#: shared memory (sorted in global memory)
ROW_TOPK_SOURCE = "metrics_tpu_torch/csrc/row_topk.cu"
K4_REPLACES = "metrics_tpu/ops/topk_pallas.py:124"
K4_PARITY_CASES = (
    ("[2048,2176] masked", 2048, 2176, 64, 8, "mixed"),
    ("[8192,2176] masked", 8192, 2176, 64, 8, "mixed"),
    ("[8192,2176]", 8192, 2176, 64, None, "mixed"),
    ("[16384,256]", 16384, 256, 128, None, "mixed"),
    ("[64,256]", 64, 256, 16, None, "mixed"),
    ("[8192,2048]", 8192, 2048, 1024, None, "mixed"),
    ("[1000,3000]", 1000, 3000, 100, None, "mixed"),
    ("[16,40000]", 16, 40000, 10, None, "mixed"),
    ("[256,2176] keys tied at the threshold", 256, 2176, 64, None, "tied"),
    ("[256,2176] only NaN and -inf keys", 256, 2176, 64, None, "nan_inf"),
    ("[2048,2176] k=1", 2048, 2176, 1, None, "mixed"),
    ("[512,2176] k=n", 512, 2176, 2176, None, "mixed"),
    ("[2048,2176] masked, fewer valid slots than k", 2048, 2176, 64, 8, "few_valid"),
    ("[16,40000] k=20000 (survivors sorted in global memory)", 16, 40000, 20000, None, "mixed"),
)
#: the MSLR-WEB30K-shaped stream of bench.py's config 4: queries, seed,
#: documents per update, and a query capacity that admits every query
RETRIEVAL_QUERIES = 5000
RETRIEVAL_SEED = 7
RETRIEVAL_UPDATE_DOCS = 16384
RETRIEVAL_MAX_QUERIES = 8192
#: segment max/min (K2): the source, the TPU kernel, the parity cases (name,
#: rows, columns, segments: the sliced update's shape, a batch over 1000 and
#: 100,000 tenants, the TPU route's width cap, past it, a long batch, the
#: same with every row in one segment, a small ragged one) and
#: segment_sum_i32's (name, rows, segments)
SEGEXT_SOURCE = "metrics_tpu_torch/csrc/segment_extremum.cu"
K2_REPLACES = "metrics_tpu/ops/scatter_pallas.py:218"
K2_PARITY_CASES = (
    ("[256,1]->1000", 256, 1, 1000),
    ("[4096,1]->1000", 4096, 1, 1000),
    ("[4096,1]->100000", 4096, 1, 100_000),
    ("[8192,256]->128", 8192, 256, 128),
    ("[4096,1000]->64", 4096, 1000, 64),
    ("[1048576,1]->64", 1 << 20, 1, 64),
    ("[1048576,1]->64 one segment", 1 << 20, 1, 64),
    ("[16,3]->5", 16, 3, 5),
)
I32_PARITY_CASES = (
    ("[4096]->1000", 4096, 1000),
    ("[4096]->100000", 4096, 100_000),
    ("[1048576]->64", 1 << 20, 64),
    ("[1048576]->64 one segment", 1 << 20, 64),
)
#: per-tenant image quality (sliced-psnr, windowed-psnr): tenants, updates,
#: images per update, image shape, noise scale, rows checked against the CPU,
#: seeds (one per update)
PSNR_TENANTS = 1000
PSNR_UPDATES = 16
PSNR_BATCH = 256
PSNR_IMAGE = (3, 256, 256)
PSNR_NOISE = 0.05
PSNR_CPU_UPDATES = 4
PSNR_SEED = 5000
WINDOW_UPDATES = 40
WINDOW_SEED = 7000
#: bench.py's fixtures: bench_sliced's batch sizes, bench_windowed's stream
SLICED_SIZES = (3072, 3584, 4096)
DECAY_UPDATES = 120
DECAY_SHAPES = (1536, 2048, 1948)
DECAY_ALPHA = 0.99
#: K3 parity cases: (name, rows, columns, share of zero-weight rows, keys:
#: "randn", "tied" (integers 0..49), "equal", "nan" (NaN of both signs among
#: normal keys) or "signed_zero" (halves, about half the zeros -0.0)); the
#: last, [131072, 3], takes four merge passes
QSKETCH_PARITY_CASES = (
    ("[1024,3]", 1024, 3, 0.0, "randn"),
    ("[16384,3]", 16384, 3, 0.0, "randn"),
    ("[32768,16]", 32768, 16, 0.0, "randn"),
    ("[12288,2002]", 12288, 2002, 0.0, "randn"),
    ("[5001,4] tied keys, zero-weight rows", 5001, 4, 0.3, "tied"),
    ("[4096,3] every key equal", 4096, 3, 0.0, "equal"),
    ("[4096,3] every weight 0", 4096, 3, 1.0, "randn"),
    ("[1,3] n = 1", 1, 3, 0.0, "randn"),
    ("[4096,3] NaN keys of both signs", 4096, 3, 0.1, "nan"),
    ("[4096,3] +-0 keys", 4096, 3, 0.1, "signed_zero"),
    ("[131072,3]", 131072, 3, 0.0, "randn"),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_data(n_batches):
    """The seed-42 softmax fixture of bench.py (``_make_data``)."""
    rng = np.random.RandomState(42)
    shape = (n_batches, BATCH, NUM_CLASSES)
    logits = rng.rand(*shape).astype(np.float32) * 4
    preds = np.exp(logits - logits.max(axis=-1, keepdims=True))
    preds /= preds.sum(axis=-1, keepdims=True)
    target = rng.randint(0, NUM_CLASSES, size=shape[:-1]).astype(np.int64)
    return preds, target


def time_ms(torch, fn, launches=TIMING_LAUNCHES):
    """Mean device time of ``fn()`` over ``launches`` back-to-back calls (CUDA events)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def _self_device_us(evt):
    us = getattr(evt, "self_device_time_total", None)
    return us if us is not None else evt.self_cuda_time_total


def kernel_device_time(torch, fn, kernel_names, launches=50):
    """``{"device_ms": ..., "device_windows": ...}``: the device time of one
    call of ``fn``, from torch.profiler: every kernel named in
    ``kernel_names`` (a name or a tuple of the CUDA kernels its wrapper may
    issue, each any number of times a call: a merge pass, a combine) summed
    and divided by the ``launches`` calls made; and the profiling windows
    taken to read it. The wrappers' host work and the output zeroing are not
    in it. ``device_ms`` is None, with a line on standard error, when no
    window recorded a launch: the launches themselves are counted and held
    against the plain versions elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel_names,) if isinstance(kernel_names, str) else tuple(kernel_names)
    fn()
    torch.cuda.synchronize()
    # a window now and then records none of a kernel's launches, in a
    # process that has run other work (three in a row once, for 50 launches
    # of bincount_i32; scripts/profiler_windows.py saw none in 360 windows of
    # a process that runs nothing else): such a window is taken again
    for windows in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        found = [evt for evt in prof.key_averages() if evt.count > 0 and any(name in evt.key for name in names)]
        if found:
            break
    if not found:
        print(f"chip_smoke: the profiler recorded no launch of {names} in {windows} windows", file=sys.stderr, flush=True)
        return {"device_ms": None, "device_windows": windows}
    total_ms = 0.0
    for evt in found:
        # the profiler may miss an event at the edge of its window: a
        # kernel's time per launch it saw, times its launches per call
        per_call = max(1, round(evt.count / launches))
        total_ms += _self_device_us(evt) / evt.count * per_call / 1e3
    return {"device_ms": total_ms, "device_windows": windows}


def device_profile(torch, step, steps):
    """``step(i)`` for ``i < steps`` under torch.profiler: wall and device
    time per step and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device rows (kernels, memsets, copies) have no CPU time of their own
    device = [evt for evt in prof.key_averages() if evt.self_cpu_time_total == 0 and _self_device_us(evt) > 0]
    device_us = sum(_self_device_us(evt) for evt in device)
    top = sorted(device, key=_self_device_us, reverse=True)[:8]
    return {
        "profiled_wall_ms_per_step": wall_s / steps * 1e3,
        "device_busy_ms_per_step": device_us / steps / 1e3,
        "device_us_per_step_by_kernel": {evt.key[:80]: _self_device_us(evt) / steps for evt in top},
    }


def host_us_per_call(torch, fn, calls=200):
    """Host time to issue one call (no synchronisation inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def numpy_auroc(scores, target, num_classes):
    """Per-class one-vs-rest AUROC from scipy midranks, in float64."""
    from scipy.stats import rankdata

    n = scores.shape[0]
    ranks = rankdata(scores.astype(np.float64), axis=0)
    own = ranks[np.arange(n), target]
    rank_sum = np.bincount(target, weights=own, minlength=num_classes)
    n_pos = np.bincount(target, minlength=num_classes).astype(np.float64)
    n_neg = n - n_pos
    defined = (n_pos > 0) & (n_neg > 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        per_class = np.where(defined, (rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg), np.nan)
    return per_class, float(np.mean(per_class[defined]))


def midrank_auroc(score, y):
    """Binary AUROC from scipy midranks of the whole stream, in float64."""
    from scipy.stats import rankdata

    ranks = rankdata(score.astype(np.float64))
    positive = y.astype(bool)
    n_pos = int(positive.sum())
    n_neg = positive.size - n_pos
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def make_ctr_stream(rows):
    """A click log of ``rows`` samples from seed 42: a click with
    probability 0.26, the model's score sigmoid(randn + 1.2 * click), float32
    scores and int64 labels."""
    rng = np.random.default_rng(42)
    clicked = rng.random(rows) < CTR_POSITIVE_RATE
    score = 1.0 / (1.0 + np.exp(-(rng.standard_normal(rows) + 1.2 * clicked)))
    return score.astype(np.float32), clicked.astype(np.int64)


def median_ms(torch, fn, repeats=COMPUTE_REPEATS):
    """Median wall time of ``fn()`` with a synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bitwise_rows_differ(torch, a, b):
    """Rows of two float32 sketches that differ in any bit."""
    return int((a.cpu().view(torch.int32) != b.cpu().view(torch.int32)).any(dim=1).sum())


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def qsketch_rows(torch, gen, n, cols, zero_share=0.0, keys="randn"):
    """Sketch rows ``[w, key, payload...]``: integer weights 1..4 (0 for about
    ``zero_share`` of the rows), keys of the kind ``keys`` (see
    ``QSKETCH_PARITY_CASES``), integer payloads."""
    rows = torch.zeros(n, cols)
    rows[:, 0] = torch.randint(1, 5, (n,), generator=gen).float()
    rows[:, 0][torch.rand(n, generator=gen) < zero_share] = 0
    if keys == "tied":
        rows[:, 1] = torch.randint(0, 50, (n,), generator=gen).float()
    elif keys == "equal":
        rows[:, 1] = 0.25
    elif keys == "signed_zero":
        key = torch.randint(-2, 3, (n,), generator=gen).float() / 2
        rows[:, 1] = torch.where((key == 0) & (torch.rand(n, generator=gen) < 0.5), -0.0, key)
    else:
        rows[:, 1] = torch.randn(n, generator=gen)
        if keys == "nan":
            pick = torch.rand(n, generator=gen)
            rows[:, 1][pick < 0.05] = float("nan")
            rows[:, 1][(pick >= 0.05) & (pick < 0.1)] = -float("nan")
    rows[:, 2:] = torch.randint(0, 3, (n, cols - 2), generator=gen).float()
    return rows


def same_nan_by_position(torch, a, b):
    """Bit for bit where ``a`` is not NaN, and NaN where it is NaN (a
    product with a NaN key keeps the NaN's sign and payload on the CPU and
    not on the card)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def qsketch_parity_phase(torch, ops, card):
    """qsketch_sort_bucket against its plain version; launches here are not counted."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    results = []
    for name, n, cols, zero_share, keys in QSKETCH_PARITY_CASES:
        host = qsketch_rows(torch, gen, n, cols, zero_share, keys)
        rows = host.cuda()
        got = ops.qsketch_sort_bucket(rows, SKETCH_CAPACITY)
        again = ops.qsketch_sort_bucket(rows, SKETCH_CAPACITY)
        plain = ops.qsketch_sort_bucket_reference(rows, SKETCH_CAPACITY)
        plain_cpu = ops.qsketch_sort_bucket_reference(host, SKETCH_CAPACITY)
        torch.cuda.synchronize()
        for part, a, b, c, d in zip(("weighted rows", "bucket ids", "permutation"), got, again, plain, plain_cpu):
            check(same_bits(torch, [a], [b]), f"qsketch_sort_bucket {name}: two runs differ in the {part}")
            check(same_nan_by_position(torch, a, c), f"qsketch_sort_bucket {name}: the {part} differ from the plain version")
            check(same_nan_by_position(torch, a, d), f"qsketch_sort_bucket {name}: the {part} differ from the plain version on the CPU")
        # the whole compaction (K3, K1's float form, the epilogue) at a
        # capacity these rows overflow, where they fill its centroids
        capacity = min(SKETCH_CAPACITY, n // 16 * 8)
        if capacity >= 8:
            compacted = ops.qsketch_compact_dispatch(rows, capacity)
            check(
                same_nan_by_position(torch, compacted, ops.compact_rows_reference(host, capacity)),
                f"qsketch compaction {name}: differs from its plain version",
            )
        else:
            capacity = None
        finite = torch.isfinite(got[0]) & torch.isfinite(plain[0])
        results.append(
            {
                "case": name,
                "max_abs_err": float((got[0] - plain[0])[finite].abs().max()) if bool(finite.any()) else 0.0,
                "buckets_differ": int((got[1] != plain[1]).sum()),
                "compaction_capacity": capacity,
                "ms": time_ms(torch, lambda: ops.qsketch_sort_bucket(rows, SKETCH_CAPACITY), launches=20),
                "card": card,
            }
        )
    emit({"phase": "parity_qsketch", "qsketch_sort_bucket": results})


def sketch_binary_phase(torch, ops, card, AUROC):
    """The sketched default over one day of a click log (the main path of K3)."""
    rows = SKETCH_BATCH * SKETCH_BATCHES
    t0 = time.perf_counter()
    score_np, y_np = make_ctr_stream(rows)
    score, y = torch.from_numpy(score_np).cuda(), torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def batch(i):
        return score[i * SKETCH_BATCH : (i + 1) * SKETCH_BATCH], y[i * SKETCH_BATCH : (i + 1) * SKETCH_BATCH]

    metric = AUROC()
    check(metric.device.type == "cuda", f"AUROC() defaults to {metric.device}, not the card")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(SKETCH_BATCHES):
        if i == SKETCH_BATCHES // 2:  # record the compaction's K1 input (the wrapper still launches)
            captured = capture_calls([("metrics_tpu_torch.ops.qsketch", "segment_sum_f32")], lambda: metric.update(*batch(i)))
        else:
            metric.update(*batch(i))
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    # the first batch fills the empty sketch; every later one may overflow
    # it, so each compacts once
    compactions = SKETCH_BATCHES - 1
    for name in ("qsketch_sort_bucket", "segment_sum_f32"):
        check(launches.get(name) == compactions, f"sketch-binary launched {name} {launches.get(name)} times, expected {compactions}")

    t0 = time.perf_counter()
    value = float(metric.compute())
    cold_compute_ms = (time.perf_counter() - t0) * 1e3
    state = {name: getattr(metric, name) for name in ("csketch", "n_seen")}
    warm_compute_ms = median_ms(torch, lambda: metric.compute_state(state))
    total_weight = float(metric.csketch[:, 0].double().sum())
    check(total_weight == rows, f"sketch total weight {total_weight}, expected {rows}")
    reference = midrank_auroc(score_np, y_np)
    err = abs(value - reference)
    check(err <= 5e-3, f"sketched AUROC {value} is {err} off the float64 midrank AUROC {reference}")

    cpu_metric = AUROC(device="cpu")
    for i in range(SKETCH_BATCHES):
        lo, hi = i * SKETCH_BATCH, (i + 1) * SKETCH_BATCH
        cpu_metric.update(torch.from_numpy(score_np[lo:hi]), torch.from_numpy(y_np[lo:hi]))
    cpu_value = float(cpu_metric.compute())
    check(abs(value - cpu_value) <= 1e-6, f"sketch-binary: card {value} and CPU {cpu_value} differ")
    rows_differ = bitwise_rows_differ(torch, metric.csketch, cpu_metric.csketch)
    ms_per_update = update_s / SKETCH_BATCHES * 1e3
    profile = device_profile(torch, lambda i: metric.update(*batch(i)), 5)
    emit(
        {
            "phase": "sketch-binary",
            "card": card,
            "rows": rows,
            "batch": SKETCH_BATCH,
            "sketch_capacity": SKETCH_CAPACITY,
            "setup_s": setup_s,
            "ms_per_update": ms_per_update,
            "samples_per_s": rows / update_s,
            "cold_compute_ms": cold_compute_ms,
            "warm_compute_ms": warm_compute_ms,
            "state_bytes": sum(t.numel() * t.element_size() for t in state.values()),
            "launches": launches,
            "auroc": value,
            "float64_midrank_auroc": reference,
            "abs_err_vs_midrank": err,
            "cpu_auroc": cpu_value,
            "abs_diff_card_cpu": abs(value - cpu_value),
            "sketch_rows_differ_bitwise": rows_differ,
            "total_weight": total_weight,
            **profile,
            "device_idle_share": 1 - profile["device_busy_ms_per_step"] / ms_per_update,
        }
    )
    return launches, score_np, y_np, metric, batch, captured["segment_sum_f32"][0]


def sketch_window_phase(torch, ops, card, AUROC, score_np, y_np):
    """The default inside its lossless window: exact, no compaction; and the
    binary capacity mode on the same samples."""
    score = torch.from_numpy(score_np[:SKETCH_CAPACITY]).cuda()
    y = torch.from_numpy(y_np[:SKETCH_CAPACITY]).cuda()
    metric = AUROC()
    ops.reset_launch_counts()
    metric.update(score, y)
    value = float(metric.compute())
    launches = ops.launch_counts()
    check(launches.get("qsketch_sort_bucket", 0) == 0, f"sketch-window compacted: {launches}")
    reference = midrank_auroc(score_np[:SKETCH_CAPACITY], y_np[:SKETCH_CAPACITY])
    err = abs(value - reference)
    check(err <= 1e-6, f"sketch-window AUROC {value} is {err} off scipy's {reference}")
    capacity_metric = AUROC(capacity=SKETCH_CAPACITY)
    capacity_metric.update(score, y)
    capacity_err = abs(float(capacity_metric.compute()) - reference)
    check(capacity_err <= 1e-6, f"binary AUROC(capacity) is {capacity_err} off scipy's {reference}")
    emit(
        {
            "phase": "sketch-window",
            "card": card,
            "rows": SKETCH_CAPACITY,
            "auroc": value,
            "abs_err_vs_scipy": err,
            "binary_capacity_abs_err_vs_scipy": capacity_err,
            "launches": launches,
        }
    )


def sketch_multiclass_phase(torch, ops, card, AUROC, preds_all, target_all, preds_np, target_np):
    """AUROC(num_classes=1000) in the sketched default: 2002-column rows."""
    metric = AUROC(num_classes=NUM_CLASSES)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(SKETCH_MC_BATCHES):
        metric.update(preds_all[i], target_all[i])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    # two batches fill the empty sketch; each later one compacts once
    compactions = SKETCH_MC_BATCHES - SKETCH_CAPACITY // BATCH
    check(launches.get("qsketch_sort_bucket") == compactions, f"sketch-multiclass launches {launches}")
    t0 = time.perf_counter()
    value = float(metric.compute())
    cold_compute_ms = (time.perf_counter() - t0) * 1e3
    state = {name: getattr(metric, name) for name in ("csketch", "n_seen")}
    warm_compute_ms = median_ms(torch, lambda: metric.compute_state(state))

    cpu_metric = AUROC(num_classes=NUM_CLASSES, device="cpu")
    for i in range(SKETCH_MC_BATCHES):
        cpu_metric.update(torch.from_numpy(preds_np[i]), torch.from_numpy(target_np[i]))
    cpu_value = float(cpu_metric.compute())
    # the weighted kernels read at most `capacity` rows per class: the card's
    # and the CPU's cumulative sums of n float32 terms differ by at most
    # (n - 1) 2**-24 of their totals, in each rate and in the trapezoid sum
    bound = 3 * SKETCH_CAPACITY * 2.0**-24
    diff = abs(value - cpu_value)
    check(diff <= bound, f"sketch-multiclass: card {value} and CPU {cpu_value} differ by {diff} > {bound}")
    rows = SKETCH_MC_BATCHES * BATCH
    _, reference = numpy_auroc(preds_np[:SKETCH_MC_BATCHES].reshape(rows, -1), target_np[:SKETCH_MC_BATCHES].reshape(-1), NUM_CLASSES)
    emit(
        {
            "phase": "sketch-multiclass",
            "card": card,
            "rows": rows,
            "sketch_cols": int(metric.csketch.shape[1]),
            "ms_per_update": update_s / SKETCH_MC_BATCHES * 1e3,
            "cold_compute_ms": cold_compute_ms,
            "warm_compute_ms": warm_compute_ms,
            "state_bytes": sum(t.numel() * t.element_size() for t in state.values()),
            "launches": launches,
            "macro_auroc": value,
            "cpu_macro_auroc": cpu_value,
            "abs_diff_card_cpu": diff,
            "summation_bound": bound,
            "sketch_rows_differ_bitwise": bitwise_rows_differ(torch, metric.csketch, cpu_metric.csketch),
            "scipy_macro_auroc": reference,
            "abs_err_vs_scipy": abs(value - reference),
        }
    )


def skewed_sum_cases(torch, sketch_k1, retrieval_k1):
    """segment_sum_f32's skewed parity cases (name, values, ids, S): the
    sketch's and the retrieval insert's own inputs, captured on their main
    paths, and three made from seed 3 on the host."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    hot = torch.randint(0, 4100, (65536,), generator=gen)
    hot[torch.rand(65536, generator=gen) < 0.9] = 4097
    return [
        ("sketch compaction [16384,3]->4100 (captured)", *sketch_k1),
        ("retrieval insert [2048]->8192 (captured)", *retrieval_k1),
        ("[65536,3]->4100, 90% of rows in one segment", torch.randn((65536, 3), generator=gen), hot, 4100),
        ("[16384,2002]->4100", torch.rand((16384, 2002), generator=gen), torch.randint(-2, 4102, (16384,), generator=gen), 4100),
        ("[1048576]->64", torch.randn(1 << 20, generator=gen), torch.randint(0, 64, (1 << 20,), generator=gen), 64),
    ]


def parity_phase(torch, ops, card, flagship_ids, rank_vals, auroc_ids, skewed):
    """Kernels against their plain versions on the card; launches here are
    not counted. ``skewed`` adds segment_sum_f32 cases (name, values, ids, S)
    held bit for bit against the plain version on the CPU, run to run and
    with int32 against int64 ids."""
    results = {}
    # bincount_i32: the ConfusionMatrix ids plus ids the kernel must drop
    extra = torch.tensor([-1, -5, NUM_CLASSES**2, 2**40, NUM_CLASSES**2 - 1, 0], device=flagship_ids.device)
    for name, ids in (("flagship", flagship_ids), ("flagship+dropped", torch.cat([flagship_ids, extra]))):
        for dtype in (torch.int64, torch.int32):
            if dtype == torch.int32 and name != "flagship":
                continue  # 2**40 does not fit; int32 ids are covered in range
            got = ops.bincount_i32(ids.to(dtype), NUM_CLASSES**2)
            want = ops.bincount_reference(ids, NUM_CLASSES**2)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            check(torch.equal(got, want), f"bincount_i32 {name} {dtype} differs from its plain version")
            results.setdefault("bincount_i32", []).append({"case": f"{name} {str(dtype)[6:]}", "max_abs_err": err})

    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = [("rank-auroc sums", rank_vals, auroc_ids, NUM_CLASSES)]
    for b, d, s in ((4096, 1, NUM_CLASSES**2), (32768, 16, 2052), (4096, 130, 1000)):
        ids = torch.randint(-3, s + 3, (b,), generator=gen)
        cases.append((f"[{b},{d}]->{s} integer", torch.randint(-9, 9, (b, d), generator=gen).float(), ids, s))
        cases.append((f"[{b},{d}]->{s} float", torch.rand((b, d), generator=gen), ids, s))
    for name, vals, ids, s in cases:
        vals, ids = vals.cuda(), ids.cuda()
        got = ops.segment_sum_f32(vals, ids, s)
        again = ops.segment_sum_f32(vals, ids, s)
        plain = ops.segment_sum_reference(vals, ids, s)
        plain_cpu = ops.segment_sum_reference(vals.cpu(), ids.cpu(), s)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"segment_sum_f32 {name}: two runs differ")
        check(torch.equal(got.cpu(), plain_cpu), f"segment_sum_f32 {name}: differs from the row-order plain version")
        err = float((got - plain).abs().max())
        row = {"case": name, "max_abs_err": err}
        if "float" in name:
            row["max_rel_err"] = float(((got - plain).abs() / plain.abs().clamp(min=1e-30)).max())
            # any two summation orders of k float32 terms differ by at most
            # 2 (k - 1) 2**-24 sum|v| (the card's index_add_ adds with atomics)
            k = ops.segment_sum_reference(torch.ones_like(vals[:, :1]), ids, s).double()
            bound = 2 * (k - 1).clamp(min=0) * 2.0**-24 * ops.segment_sum_reference(vals.abs().double(), ids, s)
            check(bool(((got - plain).abs().double() <= bound).all()), f"segment_sum_f32 {name}: past the bound")
        else:
            check(torch.equal(got, plain), f"segment_sum_f32 {name}: differs on integer-valued data")
        row["ms"] = time_ms(torch, lambda: ops.segment_sum_f32(vals, ids, s), launches=20)
        row["card"] = card
        results.setdefault("segment_sum_f32", []).append(row)
    for name, vals, ids, s in skewed:
        vals, ids = vals.cuda(), ids.cuda()
        ids64, ids32 = ids.to(torch.int64), ids.to(torch.int32)
        got = ops.segment_sum_f32(vals, ids64, s)
        again = ops.segment_sum_f32(vals, ids64, s)
        narrow = ops.segment_sum_f32(vals, ids32, s)
        plain_cpu = ops.segment_sum_reference(vals.cpu(), ids64.cpu(), s)
        torch.cuda.synchronize()
        check(same_bits(torch, [got], [again]), f"segment_sum_f32 {name}: two runs differ")
        check(same_bits(torch, [got], [narrow]), f"segment_sum_f32 {name}: int32 and int64 ids differ")
        check(same_bits(torch, [got.cpu()], [plain_cpu]), f"segment_sum_f32 {name}: differs from the row-order plain version")
        live = ids64[(ids64 >= 0) & (ids64 < s)]
        results["segment_sum_f32"].append(
            {
                "case": name,
                "shape": [list(vals.shape), s],
                "largest_segment_rows": int(torch.bincount(live, minlength=s).max()) if live.numel() else 0,
                "max_abs_err": 0.0,
                "ms": time_ms(torch, lambda: ops.segment_sum_f32(vals, ids64, s), launches=20),
                **kernel_device_time(torch, lambda: ops.segment_sum_f32(vals, ids64, s), "segment_sum_f32_kernel", launches=20),
                "card": card,
            }
        )
    emit({"phase": "parity", **results})
    # the error at the main path's own inputs (the first case of each kernel)
    return {name: rows[0]["max_abs_err"] for name, rows in results.items()}


def iou_boxes(torch, gen, n, scale=500.0):
    """``[n, 4]`` xyxy boxes (float32, CPU) with the degenerate kinds the
    kernels must take: zero width and height, a touching pair, an inverted
    box, and zero padding at the end."""
    xy = torch.rand((n, 2), generator=gen) * scale
    boxes = torch.cat([xy, xy + torch.rand((n, 2), generator=gen) * scale / 3], dim=1)
    if n >= 8:
        boxes[0] = torch.tensor([10.0, 10.0, 10.0, 30.0])
        boxes[1] = torch.tensor([10.0, 10.0, 30.0, 10.0])
        boxes[2] = torch.tensor([30.0, 30.0, 10.0, 10.0])
        boxes[3] = boxes[4] + torch.stack([boxes[4, 2] - boxes[4, 0], torch.tensor(0.0)]).repeat(2)
        boxes[-2:] = 0
    return boxes


def iou_edge_boxes(torch, gen, n, dtype):
    """``[n, 4]`` boxes whose coordinates come from :data:`IOU_EDGE_VALUES`
    (half of them ordered pairs over those values), in ``dtype``."""
    values = torch.tensor(IOU_EDGE_VALUES, dtype=torch.float64)
    boxes = values[torch.randint(0, len(IOU_EDGE_VALUES), (n, 4), generator=gen)]
    boxes[: n // 2, 2:] += boxes[: n // 2, :2]
    return boxes.to(dtype)


def box_iou_parity_phase(torch, ops, card):
    """K5 and K6 against their plain version, on card tensors and on the CPU,
    bit for bit, and a second call against the first; launches here are not
    counted."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(2)
    results = {"box_iou_pairwise": [], "box_iou_batched": []}
    cases = [("box_iou_pairwise", (n,), (m,), torch.float32, False) for n, m in K5_PARITY_SHAPES]
    cases += [("box_iou_batched", (u, d), (u, g), torch.float32, False) for u, d, g in K6_PARITY_SHAPES]
    # float64 at the line shapes, and the edge values in both dtypes
    cases += [("box_iou_pairwise", K5_LINE_SHAPE[:1], K5_LINE_SHAPE[1:], torch.float64, False)]
    cases += [("box_iou_batched", K6_LINE_SHAPE[:2], K6_LINE_SHAPE[::2], torch.float64, False)]
    for dtype in (torch.float32, torch.float64):
        cases += [("box_iou_pairwise", (2048,), (2047,), dtype, True), ("box_iou_batched", (8192, 8), (8192, 6), dtype, True)]
    for kernel, lead1, lead2, dtype, edge in cases:
        n1, n2 = int(np.prod(lead1)), int(np.prod(lead2))
        if edge:
            host1, host2 = iou_edge_boxes(torch, gen, n1, dtype), iou_edge_boxes(torch, gen, n2, dtype)
        else:
            host1, host2 = iou_boxes(torch, gen, n1).to(dtype), iou_boxes(torch, gen, n2).to(dtype)
        host1, host2 = host1.reshape(*lead1, 4), host2.reshape(*lead2, 4)
        if kernel == "box_iou_batched" and not edge:
            # each unit's ground truths zero-padded past a random count, as the mAP packing leaves them
            live = torch.arange(lead2[1])[None, :] < torch.randint(1, lead2[1] + 1, (lead2[0], 1), generator=gen)
            host2 = host2 * live[:, :, None]
        name = f"[{','.join(map(str, lead1 + lead2[-1:]))}]"
        view = torch.int64 if dtype == torch.float64 else torch.int32
        b1, b2 = host1.cuda(), host2.cuda()
        fn = getattr(ops, kernel)
        got = fn(b1, b2)
        again = fn(b1, b2)
        plain = ops.box_iou_reference(b1, b2)
        plain_cpu = ops.box_iou_reference(host1, host2)
        torch.cuda.synchronize()
        what = f"{kernel} {name} {str(dtype)[6:]}{' edge values' if edge else ''}"
        check(got.dtype == dtype and got.shape == plain_cpu.shape, f"{what}: dtype or shape differs")
        check(torch.equal(got.view(view), again.view(view)), f"{what}: two runs differ")
        check(torch.equal(got.view(view), plain.view(view)), f"{what}: differs from the plain version")
        check(torch.equal(got.cpu().view(view), plain_cpu.view(view)), f"{what}: differs from the plain version on the CPU")
        results[kernel].append(
            {
                "case": name,
                "dtype": str(dtype)[6:],
                "edge_values": edge,
                "max_abs_err": float((got - plain).abs().max()),
                "ms": time_ms(torch, lambda: fn(b1, b2), launches=20),
                "card": card,
            }
        )
    # past 2**31 outputs the wrapper takes 64-bit offsets: held against the
    # plain version on the card, 1024 rows at a time, and run to run
    b1, b2 = (iou_boxes(torch, gen, n).cuda() for n in K5_WIDE_SHAPE)
    check(import_module("metrics_tpu_torch.ops.box_iou").box_iou_geometry(1, *K5_WIDE_SHAPE)[2], "no 64-bit offsets")
    got = ops.box_iou_pairwise(b1, b2)
    check(torch.equal(got.view(torch.int32), ops.box_iou_pairwise(b1, b2).view(torch.int32)), "box_iou_pairwise wide: two runs differ")
    for i in range(0, K5_WIDE_SHAPE[0], 1024):
        plain = ops.box_iou_reference(b1[i : i + 1024], b2)
        check(torch.equal(got[i : i + 1024].view(torch.int32), plain.view(torch.int32)), f"box_iou_pairwise wide: rows {i}+ differ")
    wide_ms = time_ms(torch, lambda: ops.box_iou_pairwise(b1, b2), launches=5)
    del got, plain
    wide_case = f"[{K5_WIDE_SHAPE[0]},{K5_WIDE_SHAPE[1]}]"
    results["box_iou_pairwise"].append({"case": wide_case, "dtype": "float32", "max_abs_err": 0.0, "ms": wide_ms, "card": card})
    emit({"phase": "parity_box_iou", "seconds": time.perf_counter() - t_phase, **results})


def make_detection_data(n_imgs, n_classes=MAP_CLASSES, seed=MAP_SEED):
    """The COCO-shaped fixture of bench.py (``_make_detection_data``): 91
    classes, 10-100 detections and 1-30 ground truths per image, float32
    boxes, scores and int32 labels."""
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n_imgs):
        nd = int(rng.integers(10, 101))
        ng = int(rng.integers(1, 31))

        def boxes(n):
            x1 = rng.uniform(0, 500, n)
            y1 = rng.uniform(0, 500, n)
            w = rng.uniform(4, 150, n)
            h = rng.uniform(4, 150, n)
            return np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)

        preds.append(
            dict(
                boxes=boxes(nd),
                scores=rng.uniform(0, 1, nd).astype(np.float32),
                labels=rng.integers(0, n_classes, nd).astype(np.int32),
            )
        )
        target.append(dict(boxes=boxes(ng), labels=rng.integers(0, n_classes, ng).astype(np.int32)))
    return preds, target


def images_on(torch, images, device):
    """Per-image dicts of tensors on ``device``: each field concatenated on
    the host, moved in one copy and split back into per-image views."""
    out = [dict() for _ in images]
    for key in images[0]:
        parts = [image[key] for image in images]
        whole = torch.from_numpy(np.concatenate(parts)).to(device)
        for image, view in zip(out, torch.split(whole, [len(p) for p in parts])):
            image[key] = view
    return out


def feed_map(metric, preds, target):
    for lo in range(0, len(preds), MAP_BATCH):
        metric.update(preds[lo : lo + MAP_BATCH], target[lo : lo + MAP_BATCH])


def keys_that_differ(torch, a, b):
    """Keys whose float32 values differ in any bit."""
    check(list(a) == list(b), f"result keys differ: {list(a)} and {list(b)}")
    return [k for k in a if not torch.equal(a[k].cpu().reshape(-1).view(torch.int32), b[k].cpu().reshape(-1).view(torch.int32))]


def numpy_reservoir_key(ids):
    """The reservoir's hash priority, computed independently in numpy uint32."""
    x = ids.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return ((x >> np.uint32(8)).astype(np.float32) + np.float32(1.0)) / np.float32(1 << 24)


def map_phases(torch, ops, card, MeanAveragePrecision):
    """map-coco (the main path of K6), map-default and map-pycoco."""
    t_phase = t0 = time.perf_counter()
    preds_np, target_np = make_detection_data(MAP_IMAGES)
    preds, target = images_on(torch, preds_np, "cuda"), images_on(torch, target_np, "cuda")
    preds_cpu, target_cpu = images_on(torch, preds_np, "cpu"), images_on(torch, target_np, "cpu")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_updates = -(-MAP_IMAGES // MAP_BATCH)

    # map-coco: lossless capacity, the K6 main path
    torch.cuda.synchronize()
    memory_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    metric = MeanAveragePrecision(class_metrics=True, max_images=MAP_LOSSLESS_CAPACITY)
    check(metric.device.type == "cuda", f"MeanAveragePrecision() defaults to {metric.device}, not the card")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    feed_map(metric, preds, target)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = metric.compute()
    torch.cuda.synchronize()
    cold_compute_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches.get("box_iou_batched", 0) > 0, f"map-coco launched no box_iou_batched: {launches}")
    check(int(metric.images_seen) == MAP_IMAGES, f"images_seen {int(metric.images_seen)}, expected {MAP_IMAGES}")
    peak = torch.cuda.max_memory_allocated()
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        metric.compute_state(metric.state_dict())
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    breakdown = compute_breakdown(torch, metric)
    compute_profile = device_profile(torch, lambda i: metric.compute_state(metric.state_dict()), 1)

    t0 = time.perf_counter()
    cpu_metric = MeanAveragePrecision(class_metrics=True, max_images=MAP_LOSSLESS_CAPACITY, device="cpu")
    feed_map(cpu_metric, preds_cpu, target_cpu)
    cpu_result = cpu_metric.compute()
    cpu_s = time.perf_counter() - t0
    differ_cpu = keys_that_differ(torch, result, cpu_result)
    check(not differ_cpu, f"map-coco: card and CPU differ in {differ_cpu}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exact = MeanAveragePrecision(class_metrics=True, exact=True)
    feed_map(exact, preds, target)
    t0 = time.perf_counter()
    exact_result = exact.compute()
    exact_compute_s = time.perf_counter() - t0
    differ_exact = keys_that_differ(torch, result, exact_result)
    check(not differ_exact, f"map-coco: table and exact=True differ in {differ_exact}")
    table = metric.table
    emit(
        {
            "phase": "map-coco",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "images": MAP_IMAGES,
            "batch_images": MAP_BATCH,
            "updates": n_updates,
            "max_images": MAP_LOSSLESS_CAPACITY,
            "setup_s": setup_s,
            "ms_per_update": update_s / n_updates * 1e3,
            "cold_compute_s": cold_compute_s,
            "warm_compute_s_median_of_3": float(np.median(warm)),
            "images_per_s": MAP_IMAGES / (update_s + cold_compute_s),
            "launches": launches,
            "table_bytes": table.numel() * table.element_size(),
            "peak_memory_bytes": peak,
            "memory_before_phase_bytes": memory_before,
            "peak_memory_of_phase_bytes": peak - memory_before,
            "warm_compute_breakdown_s": breakdown,
            "compute_device_busy_ms": compute_profile["device_busy_ms_per_step"],
            "compute_device_idle_share": 1 - compute_profile["device_busy_ms_per_step"] / compute_profile["profiled_wall_ms_per_step"],
            "compute_device_us_by_kernel": compute_profile["device_us_per_step_by_kernel"],
            "map": float(result["map"]),
            "map_50": float(result["map_50"]),
            "mar_100": float(result["mar_100"]),
            "keys_differ_card_cpu": differ_cpu,
            "keys_differ_table_exact": differ_exact,
            "cpu_run_s": cpu_s,
            "exact_compute_s": exact_compute_s,
        }
    )

    # map-default: the default capacity (4096) past capacity
    t_phase = time.perf_counter()
    default = MeanAveragePrecision(class_metrics=True)
    t0 = time.perf_counter()
    feed_map(default, preds, target)
    torch.cuda.synchronize()
    default_update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    default_result = default.compute()
    default_compute_s = time.perf_counter() - t0
    capacity = default.table.shape[0]
    leaf = default.table.cpu().numpy()
    admitted = np.sort(leaf[leaf[:, 0] > -np.inf, 1].astype(np.int64))
    ids = np.arange(MAP_IMAGES, dtype=np.int64)
    want = np.sort(ids[np.lexsort((ids, -numpy_reservoir_key(ids)))[:capacity]])
    check(np.array_equal(admitted, want), "map-default: the admitted images are not the top ids by hash")
    cpu_default = MeanAveragePrecision(class_metrics=True, device="cpu")
    feed_map(cpu_default, preds_cpu, target_cpu)
    differ_default = keys_that_differ(torch, default_result, cpu_default.compute())
    check(not differ_default, f"map-default: card and CPU differ in {differ_default}")
    emit(
        {
            "phase": "map-default",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "images": MAP_IMAGES,
            "max_images": capacity,
            "admitted": int(admitted.size),
            "admitted_equal_numpy_top_by_hash": True,
            "ms_per_update": default_update_s / n_updates * 1e3,
            "compute_s": default_compute_s,
            "images_per_s": MAP_IMAGES / (default_update_s + default_compute_s),
            "map": float(default_result["map"]),
            "map_50": float(default_result["map_50"]),
            "mar_100": float(default_result["mar_100"]),
            "keys_differ_card_cpu": differ_default,
        }
    )

    # map-pycoco: the two-batch COCO fixture with pycocotools' numbers
    t_phase = time.perf_counter()
    pycoco = MeanAveragePrecision(class_metrics=True)
    for batch_preds, batch_target in zip(PYCOCO_PREDS, PYCOCO_TARGET):
        pycoco.update([pycoco_sample(torch, p) for p in batch_preds], [pycoco_sample(torch, t) for t in batch_target])
    got = pycoco.compute()
    deviation = {
        key: float(np.max(np.abs(got[key].cpu().numpy() - np.asarray(expected, np.float32))))
        for key, expected in PYCOCO_EXPECTED.items()
    }
    worst = max(deviation.values())
    check(worst <= PYCOCO_ATOL, f"map-pycoco: {worst} off pycocotools (atol {PYCOCO_ATOL})")
    emit(
        {
            "phase": "map-pycoco",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "atol": PYCOCO_ATOL,
            "max_abs_dev_by_key": deviation,
        }
    )
    return launches


def compute_breakdown(torch, metric):
    """Seconds of one warm ``compute()`` in its stages: the host unit
    packing, the matching on the card (chunk copies, matcher, K6, reads
    back), the host float64 PR reduction, and the rest (the table read,
    the unpack, the summaries). The stages are timed by wrapping them for
    this one call."""
    module = import_module("metrics_tpu_torch.detection.mean_ap")
    seconds = {"pack_units": 0.0, "match": 0.0, "precision_recall": 0.0}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
            return out

        return wrapper

    saved = (module._pack_units, module._calculate_precision_recall, module.MeanAveragePrecision._match)
    module._pack_units = timed("pack_units", saved[0])
    module._calculate_precision_recall = timed("precision_recall", saved[1])
    module.MeanAveragePrecision._match = timed("match", saved[2])
    try:
        t0 = time.perf_counter()
        metric.compute_state(metric.state_dict())
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        module._pack_units, module._calculate_precision_recall, module.MeanAveragePrecision._match = saved
    return {**seconds, "rest": total - sum(seconds.values()), "total": total}


def pycoco_sample(torch, sample):
    out = {k: torch.tensor(v, dtype=torch.float32, device="cuda") for k, v in sample.items() if k != "labels"}
    out["labels"] = torch.tensor(sample["labels"], dtype=torch.int32, device="cuda")
    return out


#: the COCO subset of the JAX package's test suite (tests/detection/test_map.py,
#: from pycocotools' instances_val2014_fakebbox100 results) and the official
#: pycocotools values, held at that test's tolerance
PYCOCO_PREDS = [
    [
        dict(boxes=[[258.15, 41.29, 606.41, 285.07]], scores=[0.236], labels=[4]),
        dict(boxes=[[61.00, 22.75, 565.00, 632.42], [12.66, 3.32, 281.26, 275.23]], scores=[0.318, 0.726], labels=[3, 2]),
    ],
    [
        dict(
            boxes=[
                [87.87, 276.25, 384.29, 379.43],
                [0.00, 3.66, 142.15, 316.06],
                [296.55, 93.96, 314.97, 152.79],
                [328.94, 97.05, 342.49, 122.98],
                [356.62, 95.47, 372.33, 147.55],
                [464.08, 105.09, 495.74, 146.99],
                [276.11, 103.84, 291.44, 150.72],
            ],
            scores=[0.546, 0.3, 0.407, 0.611, 0.335, 0.805, 0.953],
            labels=[4, 1, 0, 0, 0, 0, 0],
        ),
        dict(boxes=[[0.00, 2.87, 601.00, 421.52]], scores=[0.699], labels=[5]),
    ],
]
PYCOCO_TARGET = [
    [
        dict(boxes=[[214.1500, 41.2900, 562.4100, 285.0700]], labels=[4]),
        dict(boxes=[[13.00, 22.75, 548.98, 632.42], [1.66, 3.32, 270.26, 275.23]], labels=[2, 2]),
    ],
    [
        dict(
            boxes=[
                [61.87, 276.25, 358.29, 379.43],
                [2.75, 3.66, 162.15, 316.06],
                [295.55, 93.96, 313.97, 152.79],
                [326.94, 97.05, 340.49, 122.98],
                [356.62, 95.47, 372.33, 147.55],
                [462.08, 105.09, 493.74, 146.99],
                [277.11, 103.84, 292.44, 150.72],
            ],
            labels=[4, 1, 0, 0, 0, 0, 0],
        ),
        dict(boxes=[[13.99, 2.87, 640.00, 421.52]], labels=[5]),
    ],
]
PYCOCO_EXPECTED = {
    "map": 0.706,
    "map_50": 0.901,
    "map_75": 0.846,
    "map_small": 0.689,
    "map_medium": 0.800,
    "map_large": 0.701,
    "mar_1": 0.592,
    "mar_10": 0.716,
    "mar_100": 0.716,
    "mar_small": 0.767,
    "mar_medium": 0.800,
    "mar_large": 0.700,
    "map_per_class": [0.725, 0.800, 0.454, -1.000, 0.650, 0.900],
    "mar_100_per_class": [0.780, 0.800, 0.450, -1.000, 0.650, 0.900],
}
PYCOCO_ATOL = 1e-1


def row_topk_inputs(torch, gen, r, n, nan_share=0.02, kind="mixed"):
    """``[r, n]`` float32 preds, payload and valid on the host. "mixed":
    quantized scores (ties), NaN of both signs, signed zeros, +-inf, about
    30% invalid slots, and rows with fewer valid slots than any k here
    (every 7th row keeps three); "tied": every slot valid, scores of three
    values and every other row of one; "nan_inf": NaN of both signs and
    -inf, some slots invalid; "few_valid": mixed, with 3 to 40 valid slots
    a row."""
    if kind == "tied":
        preds = torch.randint(0, 3, (r, n), generator=gen).float() / 2
        preds[::2] = 0.5
        valid = torch.ones((r, n))
    elif kind == "nan_inf":
        pick = torch.rand((r, n), generator=gen)
        preds = torch.where(pick < 0.3, float("nan"), torch.where(pick < 0.6, -float("nan"), -float("inf")))
        valid = (torch.rand((r, n), generator=gen) < 0.7).float()
    else:
        preds = torch.randint(-64, 64, (r, n), generator=gen).float() / 8
        pick = torch.rand((r, n), generator=gen)
        preds[pick < nan_share] = float("nan")
        preds[(pick >= nan_share) & (pick < 2 * nan_share)] = -float("nan")
        preds[(pick >= 0.1) & (pick < 0.12)] = -0.0
        preds[(pick >= 0.12) & (pick < 0.13)] = float("inf")
        preds[(pick >= 0.13) & (pick < 0.14)] = -float("inf")
        valid = (torch.rand((r, n), generator=gen) < 0.7).float()
        valid[::7, 3:] = 0
        if kind == "few_valid":
            keep = torch.randint(3, 41, (r, 1), generator=gen)
            valid = torch.where(torch.arange(n)[None, :] < keep, valid.clamp(min=1.0), 0.0)
    payload = torch.randint(0, 1000, (r, n), generator=gen).float()
    return preds, payload, valid


def bits(torch, x):
    """The tensor's bits on the host (bool as bytes, 4-byte types as int32)."""
    x = x.detach().cpu().contiguous()
    return x.view(torch.int8) if x.dtype == torch.bool else x.view(torch.int32)


def same_bits(torch, a, b):
    return all(torch.equal(bits(torch, x), bits(torch, y)) for x, y in zip(a, b))


def row_topk_parity_phase(torch, ops, card):
    """K4 against its plain version on card tensors and on the CPU and
    across two runs, bit for bit; launches here are not counted."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(4)
    results = []
    for name, r, n, k, active, kind in K4_PARITY_CASES:
        host = row_topk_inputs(torch, gen, r, n, kind=kind)
        rows_host = None
        if active is not None:
            rows_host = torch.zeros(r, dtype=torch.bool)
            rows_host[torch.randperm(r, generator=gen)[:active]] = True
        card_in = [x.cuda() for x in host]
        rows = None if rows_host is None else rows_host.cuda()
        got = ops.row_topk_f32(*card_in, k, rows=rows)
        again = ops.row_topk_f32(*card_in, k, rows=rows)
        plain = ops.row_topk_reference(*card_in, k, rows=rows)
        plain_cpu = ops.row_topk_reference(*host, k, rows=rows_host)
        torch.cuda.synchronize()
        check(same_bits(torch, got, again), f"row_topk {name}: two runs differ")
        check(same_bits(torch, got, plain), f"row_topk {name}: differs from the plain version")
        check(same_bits(torch, got, plain_cpu), f"row_topk {name}: differs from the plain version on the CPU")
        finite = torch.isfinite(got[0]) & torch.isfinite(plain[0])
        results.append(
            {
                "case": name,
                "k": k,
                "active_rows": r if active is None else active,
                "max_abs_err": float((got[0] - plain[0])[finite].abs().max()) if bool(finite.any()) else 0.0,
                "ms": time_ms(torch, lambda: ops.row_topk_f32(*card_in, k, rows=rows), launches=20),
                "card": card,
            }
        )
    emit({"phase": "parity_row_topk", "seconds": time.perf_counter() - t_phase, "row_topk": results})


def make_mslr_stream():
    """bench.py's config-4 fixture (``bench_retrieval``): seed 7, 5000
    queries of 40-199 documents, uniform scores, 8% relevant."""
    rng = np.random.RandomState(RETRIEVAL_SEED)
    counts = rng.randint(40, 200, RETRIEVAL_QUERIES)
    idx = np.repeat(np.arange(RETRIEVAL_QUERIES), counts)
    preds = rng.rand(len(idx)).astype(np.float32)
    target = (rng.rand(len(idx)) < 0.08).astype(np.int32)
    return idx, preds, target


def retrieval_collection(torch, tret, MetricCollection, device=None, **kw):
    """The config-4 pair, NDCG and MAP, as a user builds it (two compute
    groups: NDCG allows graded targets and MAP does not)."""
    return MetricCollection(
        [tret.RetrievalNormalizedDCG(device=device, **kw), tret.RetrievalMAP(device=device, **kw)]
    )


def feed_retrieval(collection, stream, lo=0, hi=None):
    idx, preds, target = stream
    hi = idx.shape[0] if hi is None else hi
    for start in range(lo, hi, RETRIEVAL_UPDATE_DOCS):
        end = min(start + RETRIEVAL_UPDATE_DOCS, hi)
        collection.update(preds[start:end], target[start:end], indexes=idx[start:end])


def stream_on(torch, stream_np, device):
    return tuple(torch.from_numpy(x).to(device) for x in stream_np)


def results_differ(torch, a, b):
    return [k for k in a if not torch.equal(bits(torch, a[k]), bits(torch, b[k]))]


def tables_differ(torch, a, b):
    return [f"{k}.qtable" for k in a.keys(keep_base=True) if not torch.equal(bits(torch, a[k].qtable), bits(torch, b[k].qtable))]


def numpy_ndcg_map(idx, preds, target):
    """Mean NDCG and MAP over every query in float64 numpy (queries without a
    relevant document count 0, the default policy)."""
    n = idx.shape[0]
    order = np.lexsort((np.arange(n), -preds.astype(np.float64), idx))
    q, t = idx[order], target[order].astype(np.float64)
    starts = np.r_[0, np.nonzero(np.diff(q))[0] + 1]
    counts = np.diff(np.r_[starts, n])
    rank = np.arange(n) - np.repeat(starts, counts) + 1.0
    cum = np.cumsum(t)
    cum_in_query = cum - np.repeat(np.r_[0.0, cum[starts[1:] - 1]], counts)
    num_pos = np.add.reduceat(t, starts)
    ap = np.add.reduceat(t * cum_in_query / rank, starts) / np.maximum(num_pos, 1)
    dcg = np.add.reduceat(t / np.log2(rank + 1), starts)
    ideal_t = t[np.lexsort((-t, q))]
    idcg = np.add.reduceat(ideal_t / np.log2(rank + 1), starts)
    ndcg = np.where(idcg > 0, dcg / np.where(idcg > 0, idcg, 1), 0.0)
    return float(ndcg.mean()), float(np.where(num_pos > 0, ap, 0.0).mean())


def query_counts(idx, target):
    """Per-query documents, positive mass and negatives, from numpy."""
    return np.bincount(idx), np.bincount(idx, weights=target), np.bincount(idx, weights=target == 0)


def table_rows(torch, table, tret):
    """(query id, NSEEN, POS, NEG, FILL) of the occupied rows of a table, on the host."""
    t = table.cpu()
    occ = t[:, tret.table.COL_KEY] > 0
    qid = tret.table._join_qid(t[:, tret.table.COL_QHI], t[:, tret.table.COL_QLO])[occ].numpy()
    cols = [tret.table.COL_NSEEN, tret.table.COL_POS, tret.table.COL_NEG, tret.table.COL_FILL]
    return (qid, *(t[occ, c].numpy() for c in cols))


def capture_retrieval_calls(torch, tret, stream):
    """The main-path inputs of K4 and K1 in the first update's chunks,
    replayed on a fresh metric (the wrappers are wrapped for this replay
    only): the row_topk launch with the most overflowing rows, and the
    segment_sum_dispatch call (a per-query counter, [2048] -> 8192) whose
    largest segment holds the most rows."""
    module = import_module("metrics_tpu_torch.retrieval.table")
    calls = []
    saved = module.row_topk

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return saved(*args, **kwargs)

    module.row_topk = recording
    try:
        metric = tret.RetrievalMAP(max_queries=RETRIEVAL_MAX_QUERIES)
        sums = capture_calls(
            [("metrics_tpu_torch.retrieval.table", "segment_sum_dispatch")],
            lambda: metric.update(*(x[:RETRIEVAL_UPDATE_DOCS] for x in (stream[1], stream[2], stream[0]))),
        )["segment_sum_dispatch"]
    finally:
        module.row_topk = saved
    args, kwargs = max(calls, key=lambda call: int(call[1]["rows"].sum()))

    def largest_segment(call):
        vals, ids, s = call
        return int(torch.bincount(ids[(ids >= 0) & (ids < s)], minlength=s).max())

    return (args, kwargs["rows"]), max(sums, key=largest_segment)


def retrieval_phases(torch, ops, card, MetricCollection):
    """retrieval-mslr (the main path of K4), retrieval-window,
    retrieval-sampled and retrieval-merge."""
    tret = import_module("metrics_tpu_torch.retrieval")
    padded = import_module("metrics_tpu_torch.functional.retrieval.padded")
    t_phase = t0 = time.perf_counter()
    stream_np = make_mslr_stream()
    stream = stream_on(torch, stream_np, "cuda")
    stream_cpu = stream_on(torch, stream_np, "cpu")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_docs = stream_np[0].shape[0]
    n_updates = -(-n_docs // RETRIEVAL_UPDATE_DOCS)
    chunks = sum(-(-min(RETRIEVAL_UPDATE_DOCS, n_docs - lo) // 2048) for lo in range(0, n_docs, RETRIEVAL_UPDATE_DOCS))
    docs_per_query, pos_per_query, neg_per_query = query_counts(*stream_np[::2])

    # retrieval-mslr: every query admitted, queries past 128 docs compacted
    torch.cuda.synchronize()
    memory_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mslr = retrieval_collection(torch, tret, MetricCollection, max_queries=RETRIEVAL_MAX_QUERIES)
    check(all(m.device.type == "cuda" for m in mslr.values()), "the retrieval metrics do not default to the card")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    feed_retrieval(mslr, stream)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    values = mslr.compute()
    torch.cuda.synchronize()
    cold_compute_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    n_tables = len(mslr.compute_groups)
    check(launches.get("row_topk") == n_tables * chunks, f"retrieval-mslr row_topk launches {launches}, expected {n_tables} x {chunks}")
    check(launches.get("segment_sum_f32") == 3 * n_tables * chunks, f"retrieval-mslr segment_sum_f32 launches {launches}")
    peak = torch.cuda.max_memory_allocated()

    def warm():
        for m in mslr.values():
            m._computed = None
        mslr.compute()

    warm_ms = median_ms(torch, warm, repeats=3)
    profile = device_profile(
        torch, lambda i: feed_retrieval(retrieval_collection(torch, tret, MetricCollection, max_queries=RETRIEVAL_MAX_QUERIES), stream, 0, RETRIEVAL_UPDATE_DOCS), 2
    )
    t0 = time.perf_counter()
    mslr_cpu = retrieval_collection(torch, tret, MetricCollection, device="cpu", max_queries=RETRIEVAL_MAX_QUERIES)
    feed_retrieval(mslr_cpu, stream_cpu)
    values_cpu = mslr_cpu.compute()
    cpu_s = time.perf_counter() - t0
    differ = results_differ(torch, values, values_cpu) + tables_differ(torch, mslr, mslr_cpu)
    check(not differ, f"retrieval-mslr: card and CPU differ in {differ}")
    compacted = 0
    for name, metric in mslr.items(keep_base=True):
        qid, nseen, pos, neg, fill = table_rows(torch, metric.qtable, tret)
        check(qid.size == RETRIEVAL_QUERIES, f"{name}: {qid.size} queries admitted, expected all {RETRIEVAL_QUERIES}")
        check(np.array_equal(nseen, docs_per_query[qid]), f"{name}: NSEEN differs from numpy")
        check(np.array_equal(pos, pos_per_query[qid]), f"{name}: POS differs from numpy")
        check(np.array_equal(neg, neg_per_query[qid]), f"{name}: NEG differs from numpy")
        over = nseen > 128
        check(bool(((fill[over] >= 64) & (fill[over] <= 128)).all()), f"{name}: a compacted row holds too few or too many docs")
        compacted = int(over.sum())
    table = mslr["RetrievalMAP"].qtable
    emit(
        {
            "phase": "retrieval-mslr",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "queries": RETRIEVAL_QUERIES,
            "documents": n_docs,
            "docs_per_update": RETRIEVAL_UPDATE_DOCS,
            "updates": n_updates,
            "chunks_per_table": chunks,
            "tables": n_tables,
            "compute_groups": {str(k): v for k, v in mslr.compute_groups.items()},
            "max_queries": RETRIEVAL_MAX_QUERIES,
            "compacted_queries": compacted,
            "setup_s": setup_s,
            "ms_per_update": update_s / n_updates * 1e3,
            "cold_compute_ms": cold_compute_s * 1e3,
            "warm_compute_ms_median_of_3": warm_ms,
            "queries_per_s": RETRIEVAL_QUERIES / (update_s + cold_compute_s),
            "launches": launches,
            "table_bytes": table.numel() * table.element_size(),
            "peak_memory_bytes": peak,
            "peak_memory_of_phase_bytes": peak - memory_before,
            "update_device_busy_ms": profile["device_busy_ms_per_step"],
            "update_profiled_wall_ms": profile["profiled_wall_ms_per_step"],
            "update_device_us_by_kernel": profile["device_us_per_step_by_kernel"],
            "ndcg": float(values["RetrievalNormalizedDCG"]),
            "map": float(values["RetrievalMAP"]),
            "differ_card_cpu": differ,
            "cpu_run_s": cpu_s,
        }
    )

    # retrieval-window: max_docs 256 holds every query whole
    t_phase = time.perf_counter()
    window = retrieval_collection(torch, tret, MetricCollection, max_queries=RETRIEVAL_MAX_QUERIES, max_docs=256)
    feed_retrieval(window, stream)
    window_values = window.compute()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exact = MetricCollection([tret.RetrievalNormalizedDCG(exact=True), tret.RetrievalMAP(exact=True)])
    feed_retrieval(exact, stream)
    exact_values = exact.compute()
    m_exact = exact["RetrievalMAP"]
    pack = padded.pack_queries(torch.cat(m_exact.indexes), torch.cat(m_exact.preds), torch.cat(m_exact.target))
    layout = tret.retrieval_table_layout(window["RetrievalMAP"].qtable)
    q, d = pack[0].shape
    check(same_bits(torch, [x[:q, :d] for x in layout[:3]], pack), "retrieval-window: layout differs from the exact pack")
    check(not bool(layout[2][q:].any()) and not bool(layout[2][:, d:].any()), "retrieval-window: slots past the exact pack are occupied")
    ref_ndcg, ref_map = numpy_ndcg_map(*stream_np)
    err_exact = {k: abs(float(window_values[k]) - float(exact_values[k])) for k in window_values}
    err_numpy = {
        "RetrievalNormalizedDCG": abs(float(window_values["RetrievalNormalizedDCG"]) - ref_ndcg),
        "RetrievalMAP": abs(float(window_values["RetrievalMAP"]) - ref_map),
    }
    check(max(err_exact.values()) <= 1e-6, f"retrieval-window: {err_exact} off exact=True")
    check(max(err_numpy.values()) <= 1e-5, f"retrieval-window: {err_numpy} off numpy float64")
    emit(
        {
            "phase": "retrieval-window",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "max_docs": 256,
            "layout_equals_exact_pack": True,
            "abs_err_vs_exact": err_exact,
            "abs_err_vs_numpy_float64": err_numpy,
            "ndcg": float(window_values["RetrievalNormalizedDCG"]),
            "map": float(window_values["RetrievalMAP"]),
        }
    )

    # retrieval-sampled: the defaults (1024 queries) evict
    t_phase = time.perf_counter()
    sampled = retrieval_collection(torch, tret, MetricCollection)
    t0 = time.perf_counter()
    feed_retrieval(sampled, stream)
    torch.cuda.synchronize()
    sampled_update_s = time.perf_counter() - t0
    sampled_values = sampled.compute()
    sampled_cpu = retrieval_collection(torch, tret, MetricCollection, device="cpu")
    feed_retrieval(sampled_cpu, stream_cpu)
    differ_sampled = results_differ(torch, sampled_values, sampled_cpu.compute()) + tables_differ(torch, sampled, sampled_cpu)
    check(not differ_sampled, f"retrieval-sampled: card and CPU differ in {differ_sampled}")
    ids = np.arange(RETRIEVAL_QUERIES, dtype=np.int64)
    capacity = sampled["RetrievalMAP"].max_queries
    want = np.sort(ids[np.lexsort((ids, -numpy_reservoir_key(ids)))[:capacity]])
    for name, metric in sampled.items(keep_base=True):
        admitted = np.sort(table_rows(torch, metric.qtable, tret)[0])
        check(np.array_equal(admitted, want), f"retrieval-sampled: {name} admitted other queries than the top {capacity} by hash")
    emit(
        {
            "phase": "retrieval-sampled",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "max_queries": capacity,
            "admitted_equal_numpy_top_by_hash": True,
            "ms_per_update": sampled_update_s / n_updates * 1e3,
            "ndcg": float(sampled_values["RetrievalNormalizedDCG"]),
            "map": float(sampled_values["RetrievalMAP"]),
            "differ_card_cpu": differ_sampled,
        }
    )

    # retrieval-merge: two halves of the stream merged through merge_states
    t_phase = time.perf_counter()
    half = n_docs // 2
    merged_out = {}
    for max_docs in (128, 256):
        for device, source in (("cuda", stream), ("cpu", stream_cpu)):
            if max_docs == 256 and device == "cpu":
                continue
            sides = []
            for lo, hi in ((0, half), (half, n_docs)):
                side = retrieval_collection(torch, tret, MetricCollection, device=device, max_queries=RETRIEVAL_MAX_QUERIES, max_docs=max_docs)
                feed_retrieval(side, source, lo, hi)
                sides.append(side)
            if device == "cuda":
                torch.cuda.synchronize()
                ops.reset_launch_counts()
            merged = {}
            for name, metric in sides[0].items(keep_base=True):
                state = metric.merge_states({"qtable": metric.qtable}, {"qtable": sides[1][name].qtable})
                merged[name] = (state["qtable"], metric.compute_state(state))
            if device == "cuda":
                torch.cuda.synchronize()
                merged_out[max_docs, "launches"] = ops.launch_counts()
            merged_out[max_docs, device] = merged
    merge_launches = merged_out[128, "launches"].get("row_topk", 0)
    check(merge_launches == 2, f"retrieval-merge: {merge_launches} row_topk launches, expected one per merged table")
    differ_merge = [
        name
        for name, (table, value) in merged_out[128, "cuda"].items()
        if not same_bits(torch, (table, value), merged_out[128, "cpu"][name])
    ]
    check(not differ_merge, f"retrieval-merge: card and CPU differ in {differ_merge}")
    for name, (table, _) in merged_out[256, "cuda"].items():
        got = tret.retrieval_table_layout(table)
        want = tret.retrieval_table_layout(window[name].qtable)
        check(same_bits(torch, got, want), f"retrieval-merge: {name} merged layout differs from the single stream's")
    emit(
        {
            "phase": "retrieval-merge",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "split_at_document": half,
            "row_topk_launches_in_merges_max_docs_128": merge_launches,
            "differ_card_cpu_max_docs_128": differ_merge,
            "merged_layout_equals_single_stream_max_docs_256": True,
        }
    )
    k4_captured, k1_captured = capture_retrieval_calls(torch, tret, stream)
    return launches, k4_captured, k1_captured


def row_topk_line(torch, ops, launches, captured):
    """K4's entry of the kernels line, at the main path's own inputs: a
    chunk's [2048, 2176] widened rows with the overflow mask it had, and the
    same rows all active."""
    (preds, payload, valid, k), rows = captured
    kernel_names = import_module("metrics_tpu_torch.ops.row_topk").CUDA_KERNELS
    active = rows.nonzero()[:, 0]
    r, n = preds.shape
    got = ops.row_topk_f32(preds, payload, valid, k, rows=rows)
    plain = ops.row_topk_reference(preds, payload, valid, k, rows=rows)
    check(same_bits(torch, got, plain), "row_topk at its main-path input differs from the plain version")
    keys = torch.where(valid > 0, preds, -torch.inf)

    def library(select):
        order = torch.sort(keys[select], dim=-1, descending=True, stable=True).indices[:, :k]
        return keys[select].gather(-1, order), payload[select].gather(-1, order), valid[select].gather(-1, order)

    all_rows = torch.arange(r, device=preds.device)

    def bound_ms(n_active, mask_bytes):
        # the active rows' three inputs read once and three outputs written
        # once, and the row mask read once (the callers keep no other row)
        return (n_active * (n + k) * 4 * 3 + mask_bytes) / HBM_BYTES_PER_S * 1e3

    finite = torch.isfinite(got[0]) & torch.isfinite(plain[0])
    return {
        "name": "row_topk",
        "route": "cuda",
        "source": ROW_TOPK_SOURCE,
        "replaces": K4_REPLACES,
        "shape": [r, n],
        "k": k,
        "active_rows": int(active.numel()),
        "launches": launches["row_topk"],
        "max_abs_err": float((got[0] - plain[0])[finite].abs().max()) if bool(finite.any()) else 0.0,
        "ms": time_ms(torch, lambda: ops.row_topk_f32(preds, payload, valid, k, rows=rows)),
        "plain_ms": time_ms(torch, lambda: ops.row_topk_reference(preds, payload, valid, k, rows=rows), launches=20),
        "bound_ms": bound_ms(int(active.numel()), r),
        "bound_by": "bytes",
        "library_ms": time_ms(torch, lambda: library(active)),
        "library_note": "torch.sort(descending=True, stable=True) of the active rows' keys and two gathers (torch.topk is not tie-stable)",
        "host_us_per_call": host_us_per_call(torch, lambda: ops.row_topk_f32(preds, payload, valid, k, rows=rows)),
        **kernel_device_time(torch, lambda: ops.row_topk_f32(preds, payload, valid, k, rows=rows), kernel_names),
        "all_rows": {
            "ms": time_ms(torch, lambda: ops.row_topk_f32(preds, payload, valid, k), launches=20),
            **kernel_device_time(torch, lambda: ops.row_topk_f32(preds, payload, valid, k), kernel_names, launches=10),
            "plain_ms": time_ms(torch, lambda: ops.row_topk_reference(preds, payload, valid, k), launches=10),
            "library_ms": time_ms(torch, lambda: library(all_rows), launches=20),
            "bound_ms": bound_ms(r, 0),
        },
    }


def extremum_inputs(torch, gen, b, d, s, one_segment=False):
    """K2 parity inputs on the host: ``[b, d]`` float32 values with ties,
    NaN of both signs, +-0.0 and +-inf; int64 ids over ``[-2, s + 2)`` (with
    ``one_segment``, every id but the far ones is ``s // 2``) with a few far
    past int32's range (all of these drop), segment ``s - 1`` always empty;
    and the same ids as int32, with the far ones set to -1."""
    vals = torch.randint(-64, 64, (b, d), generator=gen).float() / 8
    pick = torch.rand((b, d), generator=gen)
    vals[pick < 0.01] = float("nan")
    vals[(pick >= 0.01) & (pick < 0.02)] = -float("nan")
    vals[(pick >= 0.1) & (pick < 0.15)] = -0.0
    vals[(pick >= 0.15) & (pick < 0.16)] = float("inf")
    vals[(pick >= 0.16) & (pick < 0.17)] = -float("inf")
    ids = torch.randint(-2, s + 2, (b,), generator=gen)
    ids[ids == s - 1] = s
    if one_segment:
        ids[:] = s // 2
    far = torch.rand(b, generator=gen) < 0.01
    ids[far] = torch.where(torch.rand(b, generator=gen)[far] < 0.5, 2**33 + 1, -(2**33))
    return vals, ids, torch.where(far, -1, ids).to(torch.int32)


def int_sum_inputs(torch, gen, b, s, one_segment=False):
    """segment_sum_i32 parity inputs: int32 values over the whole range (so
    sums wrap), ids as :func:`extremum_inputs` makes them."""
    vals = torch.randint(-(2**31), 2**31 - 1, (b,), generator=gen, dtype=torch.int64).to(torch.int32)
    _, ids, ids32 = extremum_inputs(torch, gen, b, 1, s, one_segment)
    return vals, ids, ids32


def fold_kernel_names(device_name, vals, s):
    """The kernels one call of a row-order segment wrapper launches: its
    fold, and its combine when the geometry splits the rows."""
    from metrics_tpu_torch.ops.segment_sum import segment_fold_geometry

    d = vals.shape[1] if vals.ndim == 2 else 1
    order_free = not device_name.startswith("segment_sum_f32")
    if segment_fold_geometry(vals.shape[0], d, s, order_free).splits > 1:
        return (device_name, device_name.replace("_kernel", "_combine_kernel"))
    return device_name


def segment_line(torch, kernel_fn, plain_fn, library_fn, vals, ids, s, device_name, plain_launches=20):
    """Times of one segment kernel at one shape: CUDA-event ms, device ms
    (profiler; a fold and its combine summed), the plain version's ms, the
    library call's ms, the wrapper's host time and the byte bound (values
    and ids read once, output written once)."""
    d = vals.shape[1] if vals.ndim == 2 else 1
    bound = (vals.numel() * vals.element_size() + ids.numel() * ids.element_size() + s * d * vals.element_size())
    return {
        "ms": time_ms(torch, lambda: kernel_fn(vals, ids, s)),
        **kernel_device_time(torch, lambda: kernel_fn(vals, ids, s), fold_kernel_names(device_name, vals, s)),
        "plain_ms": time_ms(torch, lambda: plain_fn(vals, ids, s), launches=plain_launches),
        "library_ms": time_ms(torch, library_fn),
        "host_us_per_call": host_us_per_call(torch, lambda: kernel_fn(vals, ids, s)),
        "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


def library_extremum(torch, vals, ids, s, is_max):
    """One scatter_reduce_ call computing K2's function but for signed zeros
    (it keeps the first zero it meets): the ids are mapped past S beforehand
    (into a row that is dropped), outside the timed call."""
    d = vals.shape[1] if vals.ndim == 2 else 1
    rows = vals.reshape(-1, d)
    index = torch.where((ids >= 0) & (ids < s), ids, s).reshape(-1, 1).expand(rows.shape).contiguous()
    fill = -torch.inf if is_max else torch.inf
    out = torch.full((s + 1, d), fill, device=vals.device)
    mode = "amax" if is_max else "amin"
    return lambda: out.fill_(fill).scatter_reduce_(0, index, rows, mode, include_self=True)


def library_index_add(torch, vals, ids, s):
    """One index_add_ call: the plain segment sum (atomics), ids mapped past S beforehand."""
    index = torch.where((ids >= 0) & (ids < s), ids, s)
    out = torch.zeros((s + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return lambda: out.zero_().index_add_(0, index, vals)


def segment_extremum_parity_phase(torch, ops, card):
    """K2 (segment_max_f32 / segment_min_f32) and segment_sum_i32 against
    their plain versions on card tensors and on the CPU, with int32 and
    int64 ids and across two runs, bit for bit; launches here are not
    counted."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(2)
    results = []
    for name, b, d, s in K2_PARITY_CASES:
        vals, ids, ids32 = extremum_inputs(torch, gen, b, d, s, "one segment" in name)
        if d == 1:  # [B] values, as the sliced scalar leaves give them
            vals = vals[:, 0]
        vals_c, ids_c, ids32_c = vals.cuda(), ids.cuda(), ids32.cuda()
        case = {"case": name, "nan": int(vals.isnan().sum()), "dropped_ids": int(((ids < 0) | (ids >= s)).sum())}
        for is_max, kernel in ((True, ops.segment_max_f32), (False, ops.segment_min_f32)):
            got = kernel(vals_c, ids32_c, s)
            again = kernel(vals_c, ids_c, s)
            third = kernel(vals_c, ids_c, s)
            plain = ops.segment_extremum_reference(vals_c, ids_c, s, is_max)
            plain_cpu = ops.segment_extremum_reference(vals, ids, s, is_max)
            torch.cuda.synchronize()
            label = f"{kernel.__name__} {name}"
            check(same_bits(torch, [got], [again]), f"{label}: int32 and int64 ids differ")
            check(same_bits(torch, [again], [third]), f"{label}: two runs differ")
            check(same_bits(torch, [got], [plain]), f"{label}: differs from the plain version")
            check(same_bits(torch, [got], [plain_cpu]), f"{label}: differs from the plain version on the CPU")
            check(bool(torch.isinf(got.reshape(s, -1)[s - 1]).all()), f"{label}: the empty segment is not filled with inf")
            if is_max:
                case["empty_segments"] = int(torch.isinf(got.reshape(s, -1)).all(dim=1).sum())
                case["max_abs_err"] = 0.0
                case.update(
                    segment_line(
                        torch, kernel,
                        lambda v, i, n: ops.segment_extremum_reference(v, i, n, True),
                        library_extremum(torch, vals_c, ids_c, s, True),
                        vals_c, ids_c, s, "segment_max_f32_kernel",
                        plain_launches=5 if b * d > 1 << 20 else 20,
                    ),
                    card=card,
                )
        results.append(case)
    i32 = []
    for name, b, s in I32_PARITY_CASES:
        vals, ids, ids32 = int_sum_inputs(torch, gen, b, s, "one segment" in name)
        vals_c, ids_c, ids32_c = vals.cuda(), ids.cuda(), ids32.cuda()
        got = ops.segment_sum_i32(vals_c, ids32_c, s)
        again = ops.segment_sum_i32(vals_c, ids_c, s)
        third = ops.segment_sum_i32(vals_c, ids_c, s)
        plain = ops.segment_sum_reference(vals_c, ids_c, s)
        plain_cpu = ops.segment_sum_reference(vals, ids, s)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"segment_sum_i32 {name}: int32 and int64 ids differ")
        check(torch.equal(again, third), f"segment_sum_i32 {name}: two runs differ")
        check(torch.equal(got, plain), f"segment_sum_i32 {name}: differs from the plain version")
        check(torch.equal(got.cpu(), plain_cpu), f"segment_sum_i32 {name}: differs from the plain version on the CPU")
        i32.append(
            {
                "case": name,
                "max_abs_err": 0,
                **segment_line(
                    torch, ops.segment_sum_i32, ops.segment_sum_reference,
                    library_index_add(torch, vals_c, ids_c, s), vals_c, ids_c, s, "segment_sum_i32_kernel",
                ),
                "card": card,
            }
        )
    emit(
        {
            "phase": "parity_segment_extremum",
            "seconds": time.perf_counter() - t_phase,
            "library_note": "scatter_reduce_('amax'/'amin', include_self=True) computes the same function except for signed zeros (it keeps the first zero it meets); index_add_ for segment_sum_i32",
            "segment_max_f32": results,
            "segment_sum_i32": i32,
        }
    )


def psnr_batch(torch, seed):
    """One update of the per-tenant image-quality traffic, made on the card
    from ``seed``: 256 images of 3 x 256 x 256, targets uniform in [0, 1),
    preds the targets plus 0.05 N(0, 1) noise, tenant ids uniform over 1000
    with six rows (ids -1 and 1000) that must drop."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (PSNR_BATCH,) + PSNR_IMAGE
    target = torch.rand(shape, generator=gen, device="cuda")
    preds = target + PSNR_NOISE * torch.randn(shape, generator=gen, device="cuda")
    ids = torch.randint(0, PSNR_TENANTS, (PSNR_BATCH,), generator=gen, device="cuda")
    ids[::97] = -1
    ids[1::97] = PSNR_TENANTS
    return ids, preds, target


def psnr_float64(torch, batches):
    """Per-tenant states in float64 / int64 from the batches (an independent
    computation): sum of squared error, pixel count, running min and max of
    the targets (from the metric's 0.0 defaults), rows."""
    s = PSNR_TENANTS
    dev = batches[0][0].device
    sse = torch.zeros(s + 1, dtype=torch.float64, device=dev)
    total = torch.zeros(s + 1, dtype=torch.int64, device=dev)
    rows = torch.zeros(s + 1, dtype=torch.int64, device=dev)
    lo = torch.zeros(s + 1, dtype=torch.float64, device=dev)
    hi = torch.zeros(s + 1, dtype=torch.float64, device=dev)
    for ids, preds, target in batches:
        idx = torch.where((ids >= 0) & (ids < s), ids, s)
        diff = preds.double() - target.double()
        sse.index_add_(0, idx, (diff * diff).flatten(1).sum(dim=1))
        total.index_add_(0, idx, torch.full_like(idx, target[0].numel()))
        rows.index_add_(0, idx, torch.ones_like(idx))
        lo.scatter_reduce_(0, idx, target.double().flatten(1).amin(dim=1), "amin")
        hi.scatter_reduce_(0, idx, target.double().flatten(1).amax(dim=1), "amax")
    return {"sum_squared_error": sse[:s], "total": total[:s], "min_target": lo[:s], "max_target": hi[:s], "_slice_rows": rows[:s]}


def psnr_from_float64(torch, ref):
    data_range = ref["max_target"] - ref["min_target"]
    return (2 * torch.log(data_range) - torch.log(ref["sum_squared_error"] / ref["total"])) * (10 / np.log(10.0))


def state_bits_differ(torch, a, b):
    """Names of the leaves of two state dicts that differ in any bit."""
    return [name for name in a if not same_bits(torch, [a[name]], [b[name]])]


def capture_calls(targets, fn):
    """Run ``fn()`` with the functions ``targets`` (``(module, name)``
    pairs) wrapped to record their arguments; returns ``{name: [args, ...]}``."""
    modules = {name: import_module(module) for module, name in targets}
    saved = {name: getattr(modules[name], name) for name in modules}
    calls = {name: [] for name in modules}

    def recorder(name):
        def recording(*args):
            calls[name].append(args)
            return saved[name](*args)

        return recording

    for name, module in modules.items():
        setattr(module, name, recorder(name))
    try:
        fn()
    finally:
        for name, module in modules.items():
            setattr(module, name, saved[name])
    return calls


def sliced_psnr_phase(torch, ops, card, SlicedMetric, PeakSignalNoiseRatio):
    """sliced-psnr: the main path of K2, per-tenant PSNR at full width."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches = [psnr_batch(torch, PSNR_SEED + i) for i in range(PSNR_UPDATES)]
    torch.cuda.synchronize()
    data_bytes = sum(x.numel() * x.element_size() for batch in batches for x in batch)
    # warm-up on a throwaway metric, recording the kernels' main-path inputs
    warm = SlicedMetric(PeakSignalNoiseRatio(), num_slices=PSNR_TENANTS)
    captured = capture_calls(
        [("metrics_tpu_torch.ops.segment_extremum", "segment_max_f32"), ("metrics_tpu_torch.ops.segment_extremum", "segment_min_f32"),
         ("metrics_tpu_torch.ops.segment_sum", "segment_sum_i32")],
        lambda: warm.update(*batches[0]),
    )
    warm.compute()  # the first vmapped compute of a process pays a one-time set-up

    metric = SlicedMetric(PeakSignalNoiseRatio(), num_slices=PSNR_TENANTS)
    check(metric.device.type == "cuda", "SlicedMetric does not default to the card")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        metric.update(*batch)
        if i + 1 == PSNR_CPU_UPDATES:
            after_cpu_updates = metric.state_dict()
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    values = metric.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    expected = {"segment_max_f32": PSNR_UPDATES, "segment_min_f32": PSNR_UPDATES, "segment_sum_f32": PSNR_UPDATES, "segment_sum_i32": 2 * PSNR_UPDATES}
    for name, n in expected.items():
        check(launches.get(name) == n, f"sliced-psnr {name} launched {launches.get(name)} times, expected {n}")
    peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(v.numel() * v.element_size() for v in metric.state_dict().values())

    # the card against the port's CPU run of the first updates, bit for bit
    t0 = time.perf_counter()
    cpu_metric = SlicedMetric(PeakSignalNoiseRatio(device="cpu"), num_slices=PSNR_TENANTS)
    for batch in batches[:PSNR_CPU_UPDATES]:
        cpu_metric.update(*(x.cpu() for x in batch))
    differ = state_bits_differ(torch, after_cpu_updates, cpu_metric.state_dict())
    check(not differ, f"sliced-psnr: card and CPU states differ after {PSNR_CPU_UPDATES} updates in {differ}")
    cpu_s = time.perf_counter() - t0

    # the states and values against an independent float64 computation
    ref = psnr_float64(torch, batches)
    state = metric.state_dict()
    for name in ("min_target", "max_target", "total", "_slice_rows"):
        check(torch.equal(state[name].double(), ref[name].double()), f"sliced-psnr {name} differs from the float64 reference")
    sse_rel = float(((state["sum_squared_error"].double() - ref["sum_squared_error"]).abs() / ref["sum_squared_error"].clamp(min=1e-30)).max())
    check(sse_rel <= 1e-5, f"sliced-psnr sum_squared_error off the float64 reference by rtol {sse_rel}")
    want = psnr_from_float64(torch, ref)
    empty = ref["_slice_rows"] == 0
    check(torch.equal(torch.isnan(values), torch.isnan(want)) and torch.equal(torch.isnan(want), empty), "sliced-psnr: NaN slices differ from the empty ones")
    psnr_err = float((values.double() - want)[~empty].abs().max())
    check(psnr_err <= 1e-4, f"sliced-psnr compute() off the float64 PSNR by {psnr_err} dB")
    subset = torch.tensor([0, 17, PSNR_TENANTS - 1, 17, 500], device="cuda")
    check(same_bits(torch, [metric.compute(slice_ids=subset)], [values[subset]]), "compute(slice_ids=) differs from a gather of compute()")
    top_ids, top_values = metric.compute(top_k=10)
    want_ids = torch.sort(ref["_slice_rows"], descending=True, stable=True).indices[:10]
    check(torch.equal(top_ids.long(), want_ids), "compute(top_k=10) picked other slices than a stable sort of the counts")
    check(same_bits(torch, [top_values], [values[want_ids]]), "compute(top_k=10) differs from a gather of compute()")

    # the read after a serving batch: one more update dirties the slices it
    # writes, and a subset read refolds only the dirty ones among its ids
    extra = psnr_batch(torch, PSNR_SEED + PSNR_UPDATES)
    metric.update(*extra)
    written = torch.unique(extra[0][(extra[0] >= 0) & (extra[0] < PSNR_TENANTS)])
    dirty = metric._dirty[:PSNR_TENANTS].clone()
    check(torch.equal(torch.nonzero(dirty).flatten(), written), "sliced-psnr: the dirty slices are not the ones the update wrote")
    part_ids = torch.cat([written[:8], torch.nonzero(~dirty).flatten()[:8]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = metric.compute(slice_ids=part_ids)
    torch.cuda.synchronize()
    partial_read_ms = (time.perf_counter() - t0) * 1e3
    dirty[part_ids] = False
    check(torch.equal(metric._dirty[:PSNR_TENANTS], dirty), "sliced-psnr: the subset read folded other slices than its dirty ones")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = metric.compute()
    torch.cuda.synchronize()
    refold_read_ms = (time.perf_counter() - t0) * 1e3
    fresh = SlicedMetric(PeakSignalNoiseRatio(), num_slices=PSNR_TENANTS)
    for batch in batches + [extra]:
        fresh.update(*batch)
    state, fresh_state = metric.state_dict(), fresh.state_dict()
    for name in ("min_target", "max_target", "total", "_slice_rows"):
        check(same_bits(torch, [state[name]], [fresh_state[name]]), f"sliced-psnr refold: {name} differs from a fresh SlicedMetric")
    sse, want_sse = state["sum_squared_error"].double(), fresh_state["sum_squared_error"].double()
    refold_sse_rel = float(((sse - want_sse).abs() / want_sse.clamp(min=1e-30)).max())
    check(refold_sse_rel <= 1e-6, f"sliced-psnr refold: sum_squared_error off a fresh SlicedMetric by rtol {refold_sse_rel}")
    want_full = fresh.compute()
    refold_rel = 0.0
    for name, got, want in (("compute(slice_ids=)", part, want_full[part_ids]), ("compute()", full, want_full)):
        check(torch.equal(torch.isnan(got), torch.isnan(want)), f"sliced-psnr refold {name}: NaN slices differ from a fresh SlicedMetric")
        finite = ~torch.isnan(want)
        rel = float(((got - want)[finite].abs() / want[finite].abs()).max())
        check(rel <= 1e-6, f"sliced-psnr refold {name}: off a fresh SlicedMetric by rtol {rel}")
        refold_rel = max(refold_rel, rel)
    del fresh, extra

    # two profiled updates: device time and the device's idle share
    profiled = SlicedMetric(PeakSignalNoiseRatio(), num_slices=PSNR_TENANTS)
    profile = device_profile(torch, lambda i: profiled.update(*batches[i]), 2)
    ms_per_update = update_s / PSNR_UPDATES * 1e3
    emit(
        {
            "phase": "sliced-psnr",
            "card": card,
            "tenants": PSNR_TENANTS,
            "updates": PSNR_UPDATES,
            "images_per_update": PSNR_BATCH,
            "image_shape": list(PSNR_IMAGE),
            "ms_per_update": ms_per_update,
            "images_per_s": PSNR_UPDATES * PSNR_BATCH / update_s,
            "compute_ms": compute_s * 1e3,
            "launches": launches,
            "state_bytes": state_bytes,
            "data_bytes_on_card": data_bytes,
            "peak_memory_bytes": peak,
            "tenants_empty": int(empty.sum()),
            "sse_max_rel_err_vs_float64": sse_rel,
            "psnr_max_abs_err_db_vs_float64": psnr_err,
            "cpu_run_s": cpu_s,
            "refold_dirty_slices": int(written.numel()),
            "partial_read_ms": partial_read_ms,
            "refold_read_ms": refold_read_ms,
            "refold_max_rel_err_vs_fresh": refold_rel,
            **profile,
            "device_idle_share": 1 - profile["device_busy_ms_per_step"] / ms_per_update,
            "seconds": time.perf_counter() - t_phase,
        }
    )
    del batches
    return launches, captured


def sliced_mse_phase(torch, ops, card, SlicedMetric, MeanSquaredError):
    """sliced-mse: bench.py's bench_sliced fixture as card tensors, against
    a numpy per-slice fan-out, bit for bit (the data are integers)."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(8)
    out = {"phase": "sliced-mse", "card": card}
    for num_slices, n_batches in ((1000, 12), (100_000, 6)):
        host = []
        for i in range(n_batches):
            b = SLICED_SIZES[i % len(SLICED_SIZES)]
            host.append((rng.randint(0, num_slices, b), rng.randint(0, 8, b).astype(np.float32), rng.randint(0, 8, b).astype(np.float32)))
        batches = [tuple(torch.from_numpy(x).cuda() for x in batch) for batch in host]
        metric = SlicedMetric(MeanSquaredError(), num_slices=num_slices)
        metric.update(*batches[0])
        metric.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            metric.update(*batch)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        ids = np.concatenate([b[0] for b in host])
        err = np.concatenate([(b[1] - b[2]).astype(np.float64) ** 2 for b in host])
        want_sse = np.bincount(ids, weights=err, minlength=num_slices).astype(np.float32)
        want_total = np.bincount(ids, minlength=num_slices).astype(np.int32)
        check(np.array_equal(metric.sum_squared_error.cpu().numpy().view(np.int32), want_sse.view(np.int32)), f"sliced-mse S={num_slices}: sum_squared_error differs from numpy")
        check(np.array_equal(metric.total.cpu().numpy(), want_total), f"sliced-mse S={num_slices}: total differs from numpy")
        check(np.array_equal(metric.slice_counts.cpu().numpy(), want_total), f"sliced-mse S={num_slices}: slice counts differ from numpy")
        rows = sum(b[0].shape[0] for b in host)
        # the float sum at this shape: one row's squared error per id
        last_ids, last_preds, last_target = batches[-1]
        row_err = (last_preds - last_target) ** 2
        out[f"S={num_slices}"] = {
            "batches": n_batches,
            "rows": rows,
            "rows_per_s": rows / update_s,
            "ms_per_update": update_s / n_batches * 1e3,
            "segment_sum_f32": {
                "shape": [int(row_err.shape[0])],
                "segments": num_slices,
                **kernel_device_time(torch, lambda: ops.segment_sum_f32(row_err, last_ids, num_slices), "segment_sum_f32_kernel"),
            },
        }
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)


def windowed_psnr_phase(torch, ops, card, SlicedMetric, WindowedMetric, PeakSignalNoiseRatio):
    """windowed-psnr: the per-tenant live view over 40 updates (the ring
    wraps), its reads held against fresh SlicedMetrics fed each window's
    updates, regenerated from their seeds."""
    t_phase = time.perf_counter()
    metric = WindowedMetric(SlicedMetric(PeakSignalNoiseRatio(), num_slices=PSNR_TENANTS), window=8, updates_per_bucket=4)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    update_s = 0.0
    for i in range(WINDOW_UPDATES):
        batch = psnr_batch(torch, WINDOW_SEED + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.update(*batch)
        torch.cuda.synchronize()
        update_s += time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches.get("segment_max_f32") == WINDOW_UPDATES, f"windowed-psnr launches {launches}")
    check(launches.get("segment_sum_i32") == 2 * WINDOW_UPDATES, f"windowed-psnr launches {launches}")
    # 40 updates of 4 per bucket: buckets 0-9, the ring of 8 holds 2-9
    reads = (
        ("compute()", {}, range(8, 40)),
        ("compute(window=2)", {"window": 2}, range(32, 40)),
        ("compute(window=3, before=1)", {"window": 3, "before": 1}, range(24, 36)),
    )
    fresh = {}
    for name, _, updates in reads:
        m = SlicedMetric(PeakSignalNoiseRatio(), num_slices=PSNR_TENANTS)
        for i in updates:
            m.update(*psnr_batch(torch, WINDOW_SEED + i))
        fresh[name] = (m.state_dict(), m.compute())
    worst = {}
    read_ms = {}
    for order in (reads, reads[::-1]):
        for name, kw, _ in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = metric.compute(**kw)
            torch.cuda.synchronize()
            read_ms.setdefault(name, (time.perf_counter() - t0) * 1e3)
            state = metric.window_state(kw.get("window"), before=kw.get("before", 0))
            want_state, want = fresh[name]
            for leaf in ("min_target", "max_target", "total", "_slice_rows"):
                check(same_bits(torch, [state[leaf]], [want_state[leaf]]), f"windowed-psnr {name}: {leaf} differs from a fresh SlicedMetric")
            sse, want_sse = state["sum_squared_error"].double(), want_state["sum_squared_error"].double()
            rel = float(((sse - want_sse).abs() / want_sse.clamp(min=1e-30)).max())
            check(rel <= 1e-6, f"windowed-psnr {name}: sum_squared_error off a fresh SlicedMetric by rtol {rel}")
            check(torch.equal(torch.isnan(got), torch.isnan(want)), f"windowed-psnr {name}: NaN slices differ")
            finite = ~torch.isnan(want)
            err = float((got - want)[finite].abs().max())
            check(err <= 1e-4, f"windowed-psnr {name}: off a fresh SlicedMetric by {err} dB")
            worst[name] = max(worst.get(name, 0.0), err)
    emit(
        {
            "phase": "windowed-psnr",
            "card": card,
            "updates": WINDOW_UPDATES,
            "window": 8,
            "updates_per_bucket": 4,
            "ms_per_update": update_s / WINDOW_UPDATES * 1e3,
            "images_per_s": WINDOW_UPDATES * PSNR_BATCH / update_s,
            "launches": launches,
            "read_ms": read_ms,
            "max_abs_err_db_vs_fresh": worst,
            "state_bytes": sum(v.numel() * v.element_size() for v in metric.state_dict().values()),
            "seconds": time.perf_counter() - t_phase,
        }
    )


def windowed_decay_phase(torch, ops, card, WindowedMetric, MeanSquaredError):
    """windowed-decay: bench.py's bench_windowed stream through the decay and
    the ring MSE, card against the port's CPU run bit for bit, decay against
    a float64 recurrence, the ring against the window's batches."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(12)
    host = []
    for i in range(DECAY_UPDATES):
        n = DECAY_SHAPES[i % len(DECAY_SHAPES)]
        host.append((rng.randint(0, 2, n).astype(np.int32), rng.randint(0, 2, n).astype(np.int32)))
    card_batches = [tuple(torch.from_numpy(x).cuda() for x in batch) for batch in host]
    cpu_batches = [tuple(torch.from_numpy(x) for x in batch) for batch in host]
    out = {"phase": "windowed-decay", "card": card, "updates": DECAY_UPDATES}
    makers = {
        "decay": lambda device: WindowedMetric(MeanSquaredError(device=device), mode="decay", decay=DECAY_ALPHA),
        "ring": lambda device: WindowedMetric(MeanSquaredError(device=device), window=8, updates_per_bucket=4),
    }
    for mode, make in makers.items():
        metric, cpu_metric = make(None), make("cpu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in card_batches:
            metric.update(*batch)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        for batch in cpu_batches:
            cpu_metric.update(*batch)
        differ = state_bits_differ(torch, metric.state_dict(), cpu_metric.state_dict())
        check(not differ, f"windowed-decay {mode}: card and CPU states differ in {differ}")
        value = float(metric.compute())
        if mode == "decay":
            sse = total = 0.0
            for preds, target in host:
                sse = DECAY_ALPHA * sse + float(((preds - target).astype(np.float64) ** 2).sum())
                total = DECAY_ALPHA * total + preds.size
            err = abs(value - sse / total)
            check(err <= 1e-5, f"windowed-decay: off the float64 recurrence by {err}")
        else:
            # 120 updates of 4 per bucket: buckets 0-29, the ring holds 22-29
            fresh = MeanSquaredError()
            for batch in card_batches[88:]:
                fresh.update(*batch)
            err = abs(value - float(fresh.compute()))
            check(err == 0.0, f"windowed-decay ring: off the window's batches by {err}")
        out[mode] = {"ms_per_update": update_s / DECAY_UPDATES * 1e3, "value": value, "abs_err": err}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)


def segment_fold_line(torch, ops, name, source, replaces, launches, args, plain_fn, library_fn, device_name, exact_fn=None):
    """A kernels-line entry of a row-order segment kernel at its main-path
    input ``args`` (values, ids, S), held bit for bit against ``exact_fn``
    (default: the plain version ``plain_fn``)."""
    vals, ids, s = args
    kernel_fn = getattr(ops, name)
    got, plain = kernel_fn(vals, ids, s), (exact_fn or plain_fn)(vals, ids, s)
    check(same_bits(torch, [got], [plain]), f"{name} at its main-path input differs from the plain version")
    finite = torch.isfinite(got) if got.is_floating_point() else torch.ones_like(got, dtype=torch.bool)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "shape": [list(vals.shape), s],
        "launches": launches[name],
        "max_abs_err": float((got - plain)[finite].abs().max()) if bool(finite.any()) else 0.0,
        **segment_line(torch, kernel_fn, plain_fn, library_fn, vals, ids, s, device_name),
    }


def fused_batches():
    """bench.py's ``bench_fused`` data: ``RandomState(7)``, one batch of each
    ragged shape over 10 classes (rows of ``rand`` normalised, then the labels)."""
    rng = np.random.RandomState(7)
    batches = []
    for n in CLS_SHAPES:
        p = rng.rand(n, CLS_CLASSES).astype(np.float32)
        p /= p.sum(-1, keepdims=True)
        batches.append((p, rng.randint(0, CLS_CLASSES, n)))
    return batches


def fused_collection(tm, device):
    """bench_fused's six metrics plus MatthewsCorrCoef and JaccardIndex."""
    c = CLS_CLASSES
    return tm.MetricCollection(
        [
            tm.Accuracy(device=device),
            tm.Precision(num_classes=c, average="macro", device=device),
            tm.Recall(num_classes=c, average="macro", device=device),
            tm.F1Score(num_classes=c, average="macro", device=device),
            tm.ConfusionMatrix(num_classes=c, device=device),
            tm.CohenKappa(num_classes=c, device=device),
            tm.MatthewsCorrCoef(num_classes=c, device=device),
            tm.JaccardIndex(num_classes=c, device=device),
        ]
    )


def flagship_collection(tm, device):
    """Eleven metrics over the flagship's 1000 classes."""
    c = NUM_CLASSES
    return tm.MetricCollection(
        {
            "Accuracy": tm.Accuracy(device=device),
            "AccuracyTop5": tm.Accuracy(top_k=5, device=device),
            "Precision": tm.Precision(num_classes=c, average="macro", device=device),
            "Recall": tm.Recall(num_classes=c, average="macro", device=device),
            "F1Score": tm.F1Score(num_classes=c, average="macro", device=device),
            "Specificity": tm.Specificity(num_classes=c, average="weighted", device=device),
            "HammingDistance": tm.HammingDistance(device=device),
            "StatScores": tm.StatScores(reduce="macro", num_classes=c, device=device),
            "MatthewsCorrCoef": tm.MatthewsCorrCoef(c, device=device),
            "CohenKappa": tm.CohenKappa(c, weights="quadratic", device=device),
            "JaccardIndex": tm.JaccardIndex(c, device=device),
        }
    )


def cls_tolerance(key):
    """(rtol, atol) of a value, card against CPU: kappa and MCC by an
    absolute bound (float32 cancellation near 0), the rest as the tests."""
    return (0.0, 1e-5) if key in ("CohenKappa", "MatthewsCorrCoef") else (1e-6, 1e-7)


def collection_states(torch, collection):
    """Every metric's states, on the host."""
    return metric_states(torch, dict(collection.items(keep_base=True)))


def run_collection(torch, ops, make, batches):
    """One run: a fresh collection, its first update (which forms the compute
    groups), the launch counters reset, the other updates timed, then a cold
    compute(). Returns the collection, values, states and timings."""
    collection = make()
    sync = torch.cuda.synchronize if batches[0][0].is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    collection.update(*batches[0])
    sync()
    first_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for preds, target in batches[1:]:
        collection.update(preds, target)
    sync()
    update_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    t0 = time.perf_counter()
    values = collection.compute()
    sync()
    compute_s = time.perf_counter() - t0
    return {
        "collection": collection,
        "values": {k: v.detach().cpu() for k, v in values.items()},
        "states": collection_states(torch, collection),
        "launches": launches,
        "first_update_s": first_s,
        "update_s": update_s,
        "compute_s": compute_s,
    }


def host_syncs_per_update(torch, collection, batches):
    """Host synchronisations per update (steady state), counted as the
    warnings of ``torch.cuda.set_sync_debug_mode("warn")`` (the mode's own
    one-time notice that it is a prototype is not one)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for preds, target in batches:
                collection.update(preds, target)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    return len(syncs) / len(batches)


def classification_phase(torch, ops, card, name, make, card_batches, cpu_batches, numpy_checks):
    """The port's eager MetricCollection.update on the card over
    ``card_batches``, against the same run on the CPU (every state bit for
    bit, every value within its tolerance) and a second card run (bit for
    bit), with ``numpy_checks(values, states)``; then host syncs per
    update and three updates under torch.profiler."""
    run = run_collection(torch, ops, lambda: make("cuda"), card_batches)
    again = run_collection(torch, ops, lambda: make("cuda"), card_batches)
    cpu = run_collection(torch, ops, lambda: make("cpu"), cpu_batches)
    groups = {str(k): v for k, v in run["collection"].compute_groups.items()}
    check(groups == {str(k): v for k, v in cpu["collection"].compute_groups.items()}, f"{name}: card and CPU groups differ")
    for key, state in run["states"].items():
        check(state.dtype == cpu["states"][key].dtype, f"{name}: {key} dtype {state.dtype}")
        check(torch.equal(state, cpu["states"][key]), f"{name}: state {key} differs between the card and the CPU")
        check(torch.equal(state, again["states"][key]), f"{name}: state {key} differs between two card runs")
    errors = {}
    for key, value in run["values"].items():
        want = cpu["values"][key]
        check(torch.equal(value, again["values"][key]), f"{name}: {key} differs between two card runs")
        rtol, atol = cls_tolerance(key)
        err = float((value.double() - want.double()).abs().max())
        check(bool(torch.isfinite(value).all()), f"{name}: {key} is not finite: {value}")
        check(err <= atol + rtol * float(want.double().abs().max()), f"{name}: {key} off the CPU by {err}")
        errors[key] = err
    numpy_checks(run["values"], run["states"])
    steady = len(card_batches) - 1
    check(run["launches"].get("bincount_i32") == steady, f"{name}: bincount_i32 launches {run['launches']}")

    collection = make("cuda")
    collection.update(*card_batches[0])
    syncs = host_syncs_per_update(torch, collection, card_batches[1:4])
    ms_per_update = run["update_s"] / steady * 1e3
    profile = device_profile(torch, lambda i: collection.update(*card_batches[1 + i]), 3)
    emit(
        {
            "phase": name,
            "card": card,
            "updates": len(card_batches),
            "rows": sum(int(p.shape[0]) for p, _ in card_batches),
            "updates_per_s": steady / run["update_s"],
            "ms_per_update": ms_per_update,
            "ms_per_update_second_run": again["update_s"] / steady * 1e3,
            "first_update_ms": run["first_update_s"] * 1e3,
            "compute_ms": run["compute_s"] * 1e3,
            "cpu_ms_per_update": cpu["update_s"] / steady * 1e3,
            **profile,
            "device_idle_share": 1 - profile["device_busy_ms_per_step"] / ms_per_update,
            "host_syncs_per_update": syncs,
            "compute_groups": groups,
            "launches": run["launches"],
            "values": {k: v.tolist() for k, v in run["values"].items() if v.numel() <= 8},
            "max_abs_err_vs_cpu": errors,
        }
    )
    return run


def classification_phases(torch, ops, card, tm, preds_all, target_all, preds_np, target_np):
    """classification-collection (bench_fused's data and collection plus
    MCC and Jaccard) and classification-flagship (12 flagship batches
    through eleven metrics). Returns each phase's bincount_i32 launches and
    its ids, for the kernels line."""
    fused = fused_batches()
    epoch = [fused[i % len(fused)] for i in range(len(fused) * CLS_REPEATS)]
    card_epoch = [(torch.from_numpy(p).cuda(), torch.from_numpy(t).cuda()) for p, t in epoch]
    cpu_epoch = [(torch.from_numpy(p), torch.from_numpy(t)) for p, t in epoch]
    fused_preds = np.concatenate([p for p, _ in epoch])
    fused_target = np.concatenate([t for _, t in epoch])

    def fused_numpy(values, states):
        labels = fused_preds.argmax(axis=1)
        count = int((labels == fused_target).sum())
        check(int(states["Accuracy.tp"]) == count, f"classification-collection: top-1 count {int(states['Accuracy.tp'])} != {count}")
        want = np.float32(count) / np.float32(fused_target.size)
        check(float(values["Accuracy"]) == float(want), f"classification-collection: accuracy {float(values['Accuracy'])} != {want}")
        cm = np.bincount(fused_target * CLS_CLASSES + labels, minlength=CLS_CLASSES**2).reshape(CLS_CLASSES, CLS_CLASSES)
        check(np.array_equal(values["ConfusionMatrix"].numpy(), cm), "classification-collection: confusion matrix differs from np.bincount")

    collection_run = classification_phase(
        torch, ops, card, "classification-collection", lambda d: fused_collection(tm, d), card_epoch, cpu_epoch, fused_numpy
    )

    n = CLS_FLAGSHIP_BATCHES
    card_batches = [(preds_all[i], target_all[i]) for i in range(n)]
    cpu_batches = [(p.cpu(), t.cpu()) for p, t in card_batches]
    flat_preds = preds_np[:n].reshape(n * BATCH, NUM_CLASSES)
    flat_target = target_np[:n].reshape(-1)

    def flagship_numpy(values, states):
        rows = np.float32(flat_target.size)
        labels = flat_preds.argmax(axis=1)
        top5 = np.argsort(-flat_preds, axis=1, kind="stable")[:, :5]
        for key, count in (
            ("Accuracy", int((labels == flat_target).sum())),
            ("AccuracyTop5", int((top5 == flat_target[:, None]).any(axis=1).sum())),
        ):
            check(int(states[f"{key}.tp"]) == count, f"classification-flagship: {key} count {int(states[f'{key}.tp'])} != {count}")
            check(float(values[key]) == float(np.float32(count) / rows), f"classification-flagship: {key} {float(values[key])}")
        cm = np.bincount(flat_target * NUM_CLASSES + labels, minlength=NUM_CLASSES**2).reshape(NUM_CLASSES, NUM_CLASSES)
        for key in ("MatthewsCorrCoef", "CohenKappa", "JaccardIndex"):
            check(np.array_equal(states[f"{key}.confmat"].numpy(), cm), f"classification-flagship: {key} confmat differs from np.bincount")

    flagship_run = classification_phase(
        torch, ops, card, "classification-flagship", lambda d: flagship_collection(tm, d), card_batches, cpu_batches, flagship_numpy
    )
    collection_ids = card_epoch[2][1] * CLS_CLASSES + card_epoch[2][0].argmax(dim=1)
    return {
        "classification-collection": (collection_run["launches"], collection_ids, CLS_CLASSES**2),
        "classification-flagship": (flagship_run["launches"], target_all[0] * NUM_CLASSES + preds_all[0].argmax(dim=1), NUM_CLASSES**2),
    }


def make_curve_stream():
    """bench.py's ``bench_sketch`` stream: ``RandomState(10)``, per batch 4096
    uniform float32 scores, then int32 labels positive at rate 0.35."""
    rng = np.random.RandomState(CURVE_SEED)
    scores, labels = [], []
    for _ in range(CURVE_BATCHES):
        scores.append(rng.rand(CURVE_BATCH).astype(np.float32))
        labels.append((rng.rand(CURVE_BATCH) < CURVE_POSITIVE_RATE).astype(np.int32))
    return np.stack(scores), np.stack(labels)


def flat_outputs(out):
    """A metric's output (a tensor, or tuples and lists of them) as a flat list."""
    if isinstance(out, (list, tuple)):
        return [t for item in out for t in flat_outputs(item)]
    return [out]


def same_outputs(torch, a, b):
    """Two outputs equal bit for bit, NaN by position."""
    a, b = flat_outputs(a), flat_outputs(b)
    return len(a) == len(b) and all(x.shape == y.shape and same_nan_by_position(torch, x, y) for x, y in zip(a, b))


def metric_states(torch, metrics):
    """Every state of every metric (list states concatenated), on the host."""
    out = {}
    for key, metric in metrics.items():
        for name in metric._defaults:
            value = getattr(metric, name)
            out[f"{key}.{name}"] = (torch.cat(value) if isinstance(value, list) else value).detach().cpu()
    return out


def state_bytes(metric):
    total = 0
    for name in metric._defaults:
        value = getattr(metric, name)
        for t in value if isinstance(value, list) else [value]:
            total += t.numel() * t.element_size()
    return total


def numpy_step_ap(scores, y):
    """Binary average precision in float64 (numpy): the step sum over the
    distinct thresholds, each positive weighted by the precision at the end
    of its tie run."""
    order = np.argsort(-scores.astype(np.float64), kind="stable")
    s, yy = scores[order], y[order].astype(np.float64)
    tp = np.cumsum(yy)
    last = np.append(s[1:] != s[:-1], True)
    idx = np.arange(s.size)
    run_end = np.minimum.accumulate(np.where(last, idx, s.size - 1)[::-1])[::-1]
    return float(np.sum(tp[run_end] / (run_end + 1) * yy) / yy.sum())


def timed(torch, fn):
    """``(result, ms)`` of one call of ``fn`` with a synchronise after it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def curve_binary_metrics(tm, device):
    """The sketched collection of the four curve metrics, and the exact and
    capacity twins of AUROC and AveragePrecision."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the exact modes' memory warning
        return {
            "collection": tm.MetricCollection(
                [tm.ROC(device=device), tm.PrecisionRecallCurve(device=device), tm.AveragePrecision(device=device), tm.AUROC(device=device)]
            ),
            "AUROC_exact": tm.AUROC(exact=True, device=device),
            "AveragePrecision_exact": tm.AveragePrecision(exact=True, device=device),
            "AveragePrecision_capacity": tm.AveragePrecision(capacity=CURVE_AP_CAPACITY, device=device),
        }


def feed(metrics, batches):
    for preds, target in batches:
        for metric in metrics.values():
            metric.update(preds, target)


def curve_binary_states(torch, metrics):
    """Every state of the binary metric set, the collection's members by name."""
    twins = {k: v for k, v in metrics.items() if k != "collection"}
    return {**collection_states(torch, metrics["collection"]), **metric_states(torch, twins)}


def curve_binary_phase(torch, ops, card, tm):
    """curve-binary: the curve family's sketched defaults, exact and capacity
    modes over bench.py's bench_sketch stream (K3 and K1's float form)."""
    score_np, y_np = make_curve_stream()
    score, y = torch.from_numpy(score_np).cuda(), torch.from_numpy(y_np).cuda()
    batches = [(score[i], y[i]) for i in range(CURVE_BATCHES)]
    names = ("ROC", "PrecisionRecallCurve", "AveragePrecision", "AUROC")

    # the lossless window: two batches, every sketched output against its
    # exact twin, on the card
    window = curve_binary_metrics(tm, "cuda")["collection"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        twins = {name: getattr(tm, name)(exact=True) for name in names}
    ops.reset_launch_counts()
    for preds, target in batches[:CURVE_WINDOW_BATCHES]:
        window.update(preds, target)
        for twin in twins.values():
            twin.update(preds, target)
    window_values = window.compute()
    check(ops.launch_counts().get("qsketch_sort_bucket", 0) == 0, "curve-binary: the window compacted")
    for name in names:
        check(same_outputs(torch, window_values[name], twins[name].compute()), f"curve-binary: sketched {name} differs from exact=True in the window")

    # the stream through the sketched collection (the main path), then the
    # exact and capacity twins
    metrics = curve_binary_metrics(tm, "cuda")
    collection = metrics["collection"]
    check(all(m.device.type == "cuda" for m in metrics.values() if hasattr(m, "device")), "curve-binary: a metric is not on the card")
    collection.update(*batches[0])  # forms the compute groups
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(1, CURVE_BATCHES):
        if i == CURVE_BATCHES // 2:  # K3's input on this path (the wrapper still launches)
            captured = capture_calls([("metrics_tpu_torch.ops.qsketch", "qsketch_sort_bucket")], lambda: collection.update(*batches[i]))
        else:
            collection.update(*batches[i])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    groups = {str(k): v for k, v in collection.compute_groups.items()}
    # the first 2 batches fill each group's sketch; each later one compacts once
    compactions = len(groups) * (CURVE_BATCHES - CURVE_WINDOW_BATCHES)
    for name in ("qsketch_sort_bucket", "segment_sum_f32"):
        check(launches.get(name) == compactions, f"curve-binary: {name} launched {launches.get(name)} times, expected {compactions}")
    twins_only = {k: v for k, v in metrics.items() if k != "collection"}
    t0 = time.perf_counter()
    for preds, target in batches:
        for metric in twins_only.values():
            metric.update(preds, target)
    torch.cuda.synchronize()
    twins_update_s = time.perf_counter() - t0

    values, collection_compute_ms = timed(torch, collection.compute)
    compute_ms = {"collection": collection_compute_ms}
    for name, metric in collection.items(keep_base=True):
        state = {k: getattr(metric, k) for k in metric._defaults}
        _, compute_ms[name] = timed(torch, lambda: metric.compute_state(state))
    for key, metric in twins_only.items():
        values[key], compute_ms[key] = timed(torch, metric.compute)

    # the whole stream against float64 numpy, and the modes against each other
    flat_score, flat_y = score_np.reshape(-1), y_np.reshape(-1)
    ref_ap, ref_auroc = numpy_step_ap(flat_score, flat_y), midrank_auroc(flat_score, flat_y)
    scalars = {k: float(values[k]) for k in ("AveragePrecision", "AUROC", "AUROC_exact", "AveragePrecision_exact", "AveragePrecision_capacity")}
    errors = {
        "AveragePrecision_exact_vs_float64": abs(scalars["AveragePrecision_exact"] - ref_ap),
        "AUROC_exact_vs_float64": abs(scalars["AUROC_exact"] - ref_auroc),
        "AveragePrecision_capacity_vs_float64": abs(scalars["AveragePrecision_capacity"] - ref_ap),
        "AveragePrecision_capacity_vs_exact": abs(scalars["AveragePrecision_capacity"] - scalars["AveragePrecision_exact"]),
        "AveragePrecision_sketched_vs_exact": abs(scalars["AveragePrecision"] - scalars["AveragePrecision_exact"]),
        "AUROC_sketched_vs_exact": abs(scalars["AUROC"] - scalars["AUROC_exact"]),
    }
    for key in ("AveragePrecision_exact_vs_float64", "AUROC_exact_vs_float64", "AveragePrecision_capacity_vs_float64"):
        check(errors[key] <= 1e-6, f"curve-binary: {key} {errors[key]}")
    for key in ("AveragePrecision_sketched_vs_exact", "AUROC_sketched_vs_exact"):
        check(errors[key] <= 5e-3, f"curve-binary: {key} {errors[key]}")
    fpr, tpr, _ = values["ROC"]
    errors["ROC_sketched_area_vs_exact_AUROC"] = abs(float(torch.trapezoid(tpr, fpr)) - scalars["AUROC_exact"])
    check(errors["ROC_sketched_area_vs_exact_AUROC"] <= 5e-3, f"curve-binary: sketched ROC area {errors['ROC_sketched_area_vs_exact_AUROC']} off")
    precision, recall, thresholds = values["PrecisionRecallCurve"]
    check(
        bool(torch.isfinite(precision).all() and torch.isfinite(recall).all()) and precision.shape == recall.shape == (thresholds.shape[0] + 1,),
        "curve-binary: sketched PR curve is not finite or of the wrong shape",
    )

    # the first 16 batches: the card's states and outputs against a second
    # card run (bit for bit) and the CPU run (states and curves bit for
    # bit; the summed values within 1e-6)
    head = batches[:CURVE_CPU_BATCHES]
    runs = []
    for device, run_batches in (("cuda", head), ("cuda", head), ("cpu", [(p.cpu(), t.cpu()) for p, t in head])):
        run = curve_binary_metrics(tm, device)
        feed(run, run_batches)
        out = run["collection"].compute()
        out.update({k: m.compute() for k, m in run.items() if k != "collection"})
        runs.append((curve_binary_states(torch, run), out))
    (card_states, card_out), (again_states, again_out), (cpu_states, cpu_out) = runs
    for key, state in card_states.items():
        check(same_nan_by_position(torch, state, again_states[key]), f"curve-binary: state {key} differs between two card runs")
        check(same_nan_by_position(torch, state, cpu_states[key]), f"curve-binary: state {key} differs between the card and the CPU")
    value_diffs = {}
    for key, out in card_out.items():
        check(same_outputs(torch, out, again_out[key]), f"curve-binary: {key} differs between two card runs")
        if key in ("ROC", "PrecisionRecallCurve"):
            check(same_outputs(torch, out, cpu_out[key]), f"curve-binary: {key} curve differs between the card and the CPU")
        else:
            value_diffs[key] = abs(float(out) - float(cpu_out[key]))
            check(value_diffs[key] <= 1e-6, f"curve-binary: {key} card and CPU differ by {value_diffs[key]}")

    # host syncs and device time per update, past the window
    fresh = curve_binary_metrics(tm, "cuda")["collection"]
    for preds, target in batches[:3]:
        fresh.update(preds, target)
    syncs = host_syncs_per_update(torch, fresh, batches[3:6])
    ms_per_update = update_s / (CURVE_BATCHES - 1) * 1e3
    profile = device_profile(torch, lambda i: collection.update(*batches[6 + i]), 5)
    emit(
        {
            "phase": "curve-binary",
            "card": card,
            "rows": CURVE_BATCHES * CURVE_BATCH,
            "batch": CURVE_BATCH,
            "ms_per_update": ms_per_update,
            "exact_and_capacity_ms_per_update": twins_update_s / CURVE_BATCHES * 1e3,
            **profile,
            "device_idle_share": 1 - profile["device_busy_ms_per_step"] / ms_per_update,
            "host_syncs_per_update": syncs,
            "compute_groups": groups,
            "launches": launches,
            "cold_compute_ms": compute_ms,
            "state_bytes": {
                **{name: state_bytes(m) for name, m in collection.items(keep_base=True)},
                **{k: state_bytes(m) for k, m in twins_only.items()},
            },
            "values": scalars,
            "float64_ap": ref_ap,
            "float64_auroc": ref_auroc,
            "abs_errors": errors,
            "abs_diff_card_cpu_16_batches": value_diffs,
            "curve_points": {"ROC": int(fpr.numel()), "PrecisionRecallCurve": int(precision.numel())},
        }
    )
    return launches, captured["qsketch_sort_bucket"][0]


def count_shapes(module_name, fn_names, fn):
    """Run ``fn()`` counting the calls of each ``module.<name>`` by (name,
    shape of the first argument, last argument)."""
    module = import_module(module_name)
    saved = {name: getattr(module, name) for name in fn_names}
    counts = {}

    def counting(name):
        def count(*args):
            key = (name, tuple(args[0].shape), args[-1])
            counts[key] = counts.get(key, 0) + 1
            return saved[name](*args)

        return count

    for name in fn_names:
        setattr(module, name, counting(name))
    try:
        fn()
    finally:
        for name in fn_names:
            setattr(module, name, saved[name])
    return counts


def curve_multiclass_metrics(tm, device):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c = NUM_CLASSES
        return tm.MetricCollection(
            {
                "AveragePrecision_weighted_exact": tm.AveragePrecision(num_classes=c, average="weighted", exact=True, device=device),
                "AveragePrecision_sketched": tm.AveragePrecision(num_classes=c, device=device),
                "ROC_capacity": tm.ROC(num_classes=c, capacity=CURVE_ROC_CAPACITY, device=device),
                "BinnedAveragePrecision": tm.BinnedAveragePrecision(num_classes=c, thresholds=CURVE_THRESHOLDS, device=device),
                "CalibrationError_l1": tm.CalibrationError(n_bins=CURVE_CE_BINS, device=device),
                "CalibrationError_max": tm.CalibrationError(n_bins=CURVE_CE_BINS, norm="max", device=device),
            }
        )


def float64_class_ap(torch, preds, target):
    """Per-class one-vs-rest average precision in float64 on the card: a
    stable descending sort per class, float64 cumulative counts, each
    positive weighted by the precision at the end of its tie run."""
    scores = preds.T.contiguous()  # [C, N]
    c, n = scores.shape
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    s = torch.gather(scores, 1, order)
    yy = (torch.gather(target[None, :].expand(c, n), 1, order) == torch.arange(c, device=preds.device)[:, None]).double()
    tp = torch.cumsum(yy, dim=1)
    last = torch.cat([s[:, 1:] != s[:, :-1], torch.ones((c, 1), dtype=torch.bool, device=s.device)], dim=1)
    idx = torch.arange(n, device=s.device).expand(c, n)
    run_end = torch.cummin(torch.where(last, idx, n - 1).flip(1), dim=1).values.flip(1)
    precision = torch.gather(tp, 1, run_end) / (run_end + 1).double()
    support = yy.sum(1)
    return ((precision * yy).sum(1) / support).cpu().numpy(), support.cpu().numpy()


def curve_multiclass_phase(torch, ops, card, tm, preds_all, target_all, preds_np, target_np):
    """curve-multiclass: the curve family at 1000 classes over 12 flagship
    batches (K1's bincount and float sums, K3 at 2002 columns)."""
    n = CURVE_MC_BATCHES
    batches = [(preds_all[i], target_all[i]) for i in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collection = curve_multiclass_metrics(tm, "cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()

    def run_updates():
        for preds, target in batches:
            collection.update(preds, target)

    shapes = count_shapes("metrics_tpu_torch.ops.segment_sum", ("segment_sum_f32", "bincount_i32"), run_updates)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    groups = {str(k): v for k, v in collection.compute_groups.items()}
    # no two of these metrics share their states, so each computes from its own
    check(len(groups) == len(collection), f"curve-multiclass: unexpected compute groups {groups}")
    compute_ms, values = {}, {}

    def run_computes():
        for name, metric in collection.items(keep_base=True):
            values[name], compute_ms[name] = timed(torch, metric.compute)

    for key, count in count_shapes("metrics_tpu_torch.ops.segment_sum", ("segment_sum_f32", "bincount_i32"), run_computes).items():
        shapes[key] = shapes.get(key, 0) + count
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    compactions = n - SKETCH_CAPACITY // BATCH
    check(launches.get("qsketch_sort_bucket") == compactions, f"curve-multiclass: K3 launches {launches}")
    # per update: two counts of the binned curve, one sum per CalibrationError;
    # at compute: the weighted AP's supports
    check(launches.get("bincount_i32") == 2 * n + 1, f"curve-multiclass: bincount_i32 launches {launches}")
    check(launches.get("segment_sum_f32") == 2 * n + compactions, f"curve-multiclass: segment_sum_f32 launches {launches}")

    rows = n * BATCH
    flat_preds = preds_np[:n].reshape(rows, NUM_CLASSES)
    flat_target = target_np[:n].reshape(-1)
    cat_preds = torch.cat([p for p, _ in batches])
    cat_target = torch.cat([t for _, t in batches])

    # the binned counts against numpy's
    binned = collection["BinnedAveragePrecision"]
    thr = binned.thresholds.cpu().numpy()
    bins = np.searchsorted(thr, flat_preds, side="right") - 1
    cls = np.broadcast_to(np.arange(NUM_CLASSES), bins.shape)
    keep = bins >= 0
    ids = (cls * CURVE_THRESHOLDS + bins)[keep]
    positive = (flat_target[:, None] == cls)[keep]
    size = NUM_CLASSES * CURVE_THRESHOLDS
    pos_bin = np.bincount(ids[positive], minlength=size).reshape(NUM_CLASSES, -1)
    all_bin = np.bincount(ids, minlength=size).reshape(NUM_CLASSES, -1)
    tp = np.cumsum(pos_bin[:, ::-1], axis=1)[:, ::-1]
    pred_pos = np.cumsum(all_bin[:, ::-1], axis=1)[:, ::-1]
    support = np.bincount(flat_target, minlength=NUM_CLASSES)
    for key, want in (("TPs", tp), ("FPs", pred_pos - tp), ("FNs", support[:, None] - tp)):
        check(np.array_equal(getattr(binned, key).cpu().numpy(), want.astype(np.float32)), f"curve-multiclass: binned {key} differ from numpy's counts")

    # calibration: counts exact, sums within rtol 1e-6 of float64, the card
    # bit-equal to the CPU
    conf = flat_preds.max(axis=1)
    acc = (flat_preds.argmax(axis=1) == flat_target).astype(np.float64)
    edges = collection["CalibrationError_l1"].bin_boundaries.cpu().numpy()
    ce_bins = np.clip(np.searchsorted(edges, conf, side="left") - 1, 0, CURVE_CE_BINS - 1)
    cpu_ce = {
        k: tm.CalibrationError(n_bins=CURVE_CE_BINS, norm=norm, device="cpu")
        for k, norm in (("CalibrationError_l1", "l1"), ("CalibrationError_max", "max"))
    }
    for preds, target in batches:
        for metric in cpu_ce.values():
            metric.update(preds.cpu(), target.cpu())
    ce_err = {}
    for key, cpu_metric in cpu_ce.items():
        metric = collection[key]
        check(np.array_equal(metric.bin_count.cpu().numpy(), np.bincount(ce_bins, minlength=CURVE_CE_BINS)), f"curve-multiclass: {key} counts differ")
        counts = np.bincount(ce_bins, minlength=CURVE_CE_BINS)
        for state, weights in (("bin_conf", conf.astype(np.float64)), ("bin_acc", acc)):
            want = np.bincount(ce_bins, weights=weights, minlength=CURVE_CE_BINS)
            got = getattr(metric, state).cpu().numpy().astype(np.float64)
            # a float32 sum of n terms in row order (the JAX package's) is
            # within (n - 1) 2**-24 of its terms' total magnitude
            bound = np.maximum(counts - 1, 0) * 2.0**-24 * want
            ce_err[f"{key}.{state}"] = float(np.max(np.abs(got - want) / np.maximum(want, 1e-30)))
            check(bool(np.all(np.abs(got - want) <= bound)), f"curve-multiclass: {key}.{state} off float64 by rtol {ce_err[f'{key}.{state}']}")
        for state in ("bin_count", "bin_conf", "bin_acc"):
            check(same_bits(torch, [getattr(metric, state)], [getattr(cpu_metric, state)]), f"curve-multiclass: {key}.{state} differs from the CPU")
        ce_err[f"{key}.card_vs_cpu"] = abs(float(values[key]) - float(cpu_metric.compute()))
        check(ce_err[f"{key}.card_vs_cpu"] <= 1e-6, f"curve-multiclass: {key} value off the CPU by {ce_err[f'{key}.card_vs_cpu']}")

    # average precision against float64 per-class step sums
    ref_ap, ref_support = float64_class_ap(torch, cat_preds, cat_target)
    defined = ref_support > 0
    ref_weighted = float(np.sum(ref_ap[defined] * ref_support[defined]) / np.sum(ref_support[defined]))
    ref_macro = float(np.mean(ref_ap[defined]))
    ap_errors = {
        "weighted_exact_vs_float64": abs(float(values["AveragePrecision_weighted_exact"]) - ref_weighted),
        "sketched_macro_vs_float64_macro": abs(float(values["AveragePrecision_sketched"]) - ref_macro),
    }
    check(ap_errors["weighted_exact_vs_float64"] <= 1e-5, f"curve-multiclass: weighted exact AP off float64 by {ap_errors['weighted_exact_vs_float64']}")
    check(ap_errors["sketched_macro_vs_float64_macro"] <= 5e-3, f"curve-multiclass: sketched AP off by {ap_errors['sketched_macro_vs_float64_macro']}")

    # the capacity ROC's points against the exact per-class ROC
    fpr, tpr, thresholds, mask = (t.cpu() for t in values["ROC_capacity"])
    roc_fn = import_module("metrics_tpu_torch.functional").roc
    exact_roc, exact_roc_ms = timed(torch, lambda: roc_fn(cat_preds, cat_target, num_classes=NUM_CLASSES))
    for c in range(NUM_CLASSES):
        m = mask[c]
        got = [fpr[c][m], tpr[c][m], thresholds[c][m]]
        want = [exact_roc[0][c].cpu(), exact_roc[1][c].cpu(), exact_roc[2][c].cpu()]
        check(same_bits(torch, got, want) and all(g.shape == w.shape for g, w in zip(got, want)), f"curve-multiclass: capacity ROC class {c} differs from the exact ROC")

    fresh = curve_multiclass_metrics(tm, "cuda")
    for preds, target in batches[:2]:
        fresh.update(preds, target)
    syncs = host_syncs_per_update(torch, fresh, batches[2:5])
    ms_per_update = update_s / n * 1e3
    profile = device_profile(torch, lambda i: fresh.update(*batches[5 + i]), 3)
    emit(
        {
            "phase": "curve-multiclass",
            "card": card,
            "rows": rows,
            "num_classes": NUM_CLASSES,
            "ms_per_update": ms_per_update,
            **profile,
            "device_idle_share": 1 - profile["device_busy_ms_per_step"] / ms_per_update,
            "host_syncs_per_update": syncs,
            "compute_groups": groups,
            "launches": launches,
            "kernel_calls_by_shape": {f"{k[0]} {list(k[1])}->{k[2]}": v for k, v in shapes.items()},
            "cold_compute_ms": compute_ms,
            "exact_per_class_roc_ms": exact_roc_ms,
            "state_bytes": {name: state_bytes(m) for name, m in collection.items(keep_base=True)},
            "peak_memory_bytes": peak,
            # the binned AP per class: its mean over the classes
            "values": {k: float(torch.stack(v).mean() if isinstance(v, list) else v) for k, v in values.items() if k != "ROC_capacity"},
            "float64_weighted_ap": ref_weighted,
            "float64_macro_ap": ref_macro,
            "ap_abs_errors": ap_errors,
            "calibration_errors": ce_err,
        }
    )
    # the kernels' inputs on this path, for the kernels line
    binned_in = capture_calls([("metrics_tpu_torch.ops.segment_sum", "bincount_i32")], lambda: binned.update(*batches[0]))
    ce_in = capture_calls([("metrics_tpu_torch.ops.segment_sum", "segment_sum_f32")], lambda: collection["CalibrationError_l1"].update(*batches[0]))
    return {
        "launches": launches,
        "shapes": shapes,
        "binned": binned_in["bincount_i32"],
        "calibration": ce_in["segment_sum_f32"][0],
        "supports": cat_target.to(torch.int32),
    }


def curve_kernel_lines(torch, ops, curve_mc, curve_launches, curve_k3):
    """The kernels-line entries at the curve phases' own inputs, each with its
    launches at that shape: bincount_i32 at the binned curve's counts (with
    the time of segment_sum_f32 computing the same counts from [N*C, 2]
    rows, the float form's row order) and at the weighted AP's supports,
    segment_sum_f32 at CalibrationError's sums, K3 at curve-binary's
    compaction input."""
    shapes = curve_mc["shapes"]
    lines = []
    (all_ids, bins), (pos_ids, _) = curve_mc["binned"]
    line = bincount_line(torch, ops, "curve-multiclass (binned)", {"bincount_i32": shapes.get(("bincount_i32", tuple(all_ids.shape), bins), 0)}, all_ids, bins)
    rows = torch.stack([(pos_ids >= 0).float(), (all_ids >= 0).float()], dim=1)
    f32 = ops.segment_sum_f32(rows, all_ids, bins)
    check(torch.equal(f32[:, 1], ops.bincount_i32(all_ids, bins).float()), "binned counts: segment_sum_f32 and bincount_i32 differ")
    line["segment_sum_f32_same_counts"] = {
        "shape": [list(rows.shape), bins],
        **kernel_device_time(torch, lambda: ops.segment_sum_f32(rows, all_ids, bins), "segment_sum_f32_kernel", launches=5),
    }
    lines.append(line)
    supports = curve_mc["supports"]
    lines.append(bincount_line(torch, ops, "curve-multiclass (weighted AP supports)", {"bincount_i32": shapes.get(("bincount_i32", tuple(supports.shape), NUM_CLASSES), 0)}, supports, NUM_CLASSES))
    vals, ids, s = curve_mc["calibration"]
    line = segment_fold_line(
        torch, ops, "segment_sum_f32", KERNEL_SOURCE, REPLACES,
        {"segment_sum_f32": shapes.get(("segment_sum_f32", tuple(vals.shape), s), 0)}, (vals, ids, s),
        ops.segment_sum_reference, library_index_add(torch, vals, ids, s), "segment_sum_f32_kernel",
        exact_fn=lambda v, i, n: ops.segment_sum_reference(v.cpu(), i.cpu(), n).to(v.device),
    )
    lines.append({**line, "path": "curve-multiclass (CalibrationError)"})
    lines.append(qsketch_line(torch, ops, "curve-binary", curve_launches, *curve_k3))
    return lines


def qsketch_line(torch, ops, path, launches, rows, capacity):
    """A kernels-line entry of K3 at a path's own compaction input."""
    got, plain = ops.qsketch_sort_bucket(rows, capacity), ops.qsketch_sort_bucket_reference(rows, capacity)
    check(all(torch.equal(a, b) for a, b in zip(got[1:], plain[1:])), f"K3 at the {path} input: buckets or order differ")
    keys = torch.where(rows[:, 0] > 0, rows[:, 1], torch.inf)
    n_pad = got[0].shape[0]

    def call():
        return ops.qsketch_sort_bucket(rows, capacity)

    return {
        "name": "qsketch_sort_bucket",
        "route": "cuda",
        "source": QSKETCH_SOURCE,
        "replaces": QSKETCH_REPLACES,
        "path": path,
        "shape": list(rows.shape),
        "launches": launches.get("qsketch_sort_bucket", 0),
        "max_abs_err": float((got[0] - plain[0]).abs().max()),
        "ms": time_ms(torch, call),
        "plain_ms": time_ms(torch, lambda: ops.qsketch_sort_bucket_reference(rows, capacity)),
        # rows read once; weighted rows, bucket ids and permutation written once
        "bound_ms": (rows.numel() * 4 + n_pad * (rows.shape[1] * 4 + 4 + 4)) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(torch, lambda: torch.sort(keys, stable=True)),
        "host_us_per_call": host_us_per_call(torch, call),
        **kernel_device_time(torch, call, import_module("metrics_tpu_torch.ops.qsketch").CUDA_KERNELS),
    }


def bincount_line(torch, ops, path, launches, ids, bins):
    """A kernels-line entry of ``bincount_i32`` at a path's own ids."""
    got, plain = ops.bincount_i32(ids, bins), ops.bincount_reference(ids, bins)
    check(torch.equal(got, plain), f"bincount_i32 at the {path} ids differs from the plain version")

    def call():
        return ops.bincount_i32(ids, bins)

    return {
        "name": "bincount_i32",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "path": path,
        "shape": [list(ids.shape), bins],
        "launches": launches.get("bincount_i32", 0),
        "max_abs_err": float((got - plain).abs().max()),
        "ms": time_ms(torch, call),
        "plain_ms": time_ms(torch, lambda: ops.bincount_reference(ids, bins)),
        # ids read once, counts written once
        "bound_ms": (ids.numel() * ids.element_size() + bins * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": library_bincount_ms(torch, ids, bins),
        "host_us_per_call": host_us_per_call(torch, call),
        **kernel_device_time(torch, call, "bincount_i32_kernel"),
    }


def library_bincount_ms(torch, ids, bins):
    """One torch.bincount call; ids that K1 drops (negative ones) are mapped
    into an extra bin beforehand (torch.bincount refuses them)."""
    if bool((ids < 0).any()):
        ids, bins = torch.where(ids >= 0, ids, bins), bins + 1
    return time_ms(torch, lambda: torch.bincount(ids, minlength=bins))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()

    from metrics_tpu_torch import (
        AUROC,
        ConfusionMatrix,
        MeanAveragePrecision,
        MeanSquaredError,
        MetricCollection,
        PeakSignalNoiseRatio,
        SlicedMetric,
        WindowedMetric,
    )
    from metrics_tpu_torch import ops
    from metrics_tpu_torch.functional import auroc_rank_multiclass
    from metrics_tpu_torch.ops.build import build
    from metrics_tpu_torch.ops.qsketch import pack_rows

    device = torch.device("cuda")
    torch.manual_seed(0)

    # 1. build: one nvcc per source, all started together
    modules = [
        import_module(f"metrics_tpu_torch.ops.{name}")
        for name in ("segment_sum", "segment_extremum", "qsketch", "box_iou", "row_topk")
    ]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        built = list(pool.map(build, [module.SOURCE for module in modules]))
    build_wall_s = time.perf_counter() - t0
    for module in modules:
        module.load_library()
    emit(
        {
            "phase": "build",
            "wall_seconds": build_wall_s,
            "libraries": [
                {"library": path.name, "seconds": seconds, "ptxas": [line.strip() for line in log.splitlines() if "Used" in line]}
                for path, seconds, log in built
            ],
        }
    )

    # set-up: the fixture, made on the host and moved to the card once
    t0 = time.perf_counter()
    preds_np, target_np = make_data(ITERS)
    preds_all = torch.from_numpy(preds_np).to(device)
    target_all = torch.from_numpy(target_np).to(device)
    torch.cuda.synchronize()
    emit({"phase": "data", "seconds": time.perf_counter() - t0, "bytes_on_card": preds_all.numel() * 4})

    # the main path's kernel inputs, for parity and timing
    flagship_ids = target_all[0] * NUM_CLASSES + preds_all[0].argmax(dim=1)
    rank_vals = torch.stack(
        [torch.randint(2, 2 * BATCH + 1, (BATCH,), device=device).float() / 2, torch.ones(BATCH, device=device)], dim=1
    )
    auroc_ids = target_all[0]

    # 2. kernel parity (segment_sum_f32's after the sketch and retrieval
    # phases, whose inputs it takes)
    qsketch_parity_phase(torch, ops, card)
    box_iou_parity_phase(torch, ops, card)
    row_topk_parity_phase(torch, ops, card)
    segment_extremum_parity_phase(torch, ops, card)

    # 3. the flagship epoch (the main path)
    confmat = ConfusionMatrix(num_classes=NUM_CLASSES)

    def epoch():
        state = confmat.init_state()
        auc = None
        for i in range(ITERS):
            state = confmat.update_state(state, preds_all[i], target_all[i])
            auc = auroc_rank_multiclass(preds_all[i], target_all[i], NUM_CLASSES, average="macro")
        return state, auc

    for _ in range(WARMUP):
        epoch()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, auc = epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    main_launches = ops.launch_counts()
    for name in ("bincount_i32", "segment_sum_f32"):
        check(main_launches.get(name) == ITERS, f"{name} launched {main_launches.get(name)} times, expected {ITERS}")

    # split: the same 50 steps, confmat update alone and rank AUROC alone
    t0 = time.perf_counter()
    split_state = confmat.init_state()
    for i in range(ITERS):
        split_state = confmat.update_state(split_state, preds_all[i], target_all[i])
    torch.cuda.synchronize()
    confmat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(ITERS):
        auroc_rank_multiclass(preds_all[i], target_all[i], NUM_CLASSES, average="macro")
    torch.cuda.synchronize()
    auroc_s = time.perf_counter() - t0

    pred_labels = preds_np.argmax(axis=-1)
    want_cm = np.bincount((target_np * NUM_CLASSES + pred_labels).ravel(), minlength=NUM_CLASSES**2)
    got_cm = state["confmat"].cpu().numpy()
    check(got_cm.dtype == np.int32, f"confmat dtype {got_cm.dtype}")
    check(np.array_equal(got_cm.reshape(-1), want_cm), "flagship confusion matrix differs from np.bincount")
    ref_per_class, ref_macro = numpy_auroc(preds_np[-1], target_np[-1], NUM_CLASSES)
    per_class = auroc_rank_multiclass(preds_all[-1], target_all[-1], NUM_CLASSES, average=None).cpu().numpy()
    defined = ~np.isnan(ref_per_class)
    check(np.array_equal(np.isnan(per_class), ~defined), "AUROC undefined classes differ")
    auc_err = float(np.max(np.abs(per_class[defined] - ref_per_class[defined])))
    macro_err = abs(float(auc) - ref_macro)
    check(auc_err <= 1e-6 and macro_err <= 1e-6, f"AUROC off the scipy reference: {auc_err}, {macro_err}")
    emit(
        {
            "phase": "flagship",
            "card": card,
            "steps": ITERS,
            "batch": BATCH,
            "num_classes": NUM_CLASSES,
            "epoch_s": epoch_s,
            "samples_per_s": ITERS * BATCH / epoch_s,
            "ms_per_step": epoch_s / ITERS * 1e3,
            "confmat_update_ms_per_step": confmat_s / ITERS * 1e3,
            "rank_auroc_ms_per_step": auroc_s / ITERS * 1e3,
            "launches": main_launches,
            "macro_auroc": float(auc),
            "auroc_max_abs_err_vs_scipy": auc_err,
            "macro_abs_err_vs_scipy": macro_err,
            "confmat_total": int(got_cm.sum()),
        }
    )

    write_profile(torch, confmat, preds_all, target_all, auroc_rank_multiclass, epoch_s / ITERS)

    # 4. the stateful path: AUROC(capacity) and ConfusionMatrix in a collection
    torch.cuda.reset_peak_memory_stats()
    collection = MetricCollection(
        [ConfusionMatrix(num_classes=NUM_CLASSES), AUROC(num_classes=NUM_CLASSES, capacity=CAPACITY)]
    )
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(STATEFUL_BATCHES):
        collection.update(preds_all[i], target_all[i])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    values = collection.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    stateful_launches = ops.launch_counts()
    check(stateful_launches.get("bincount_i32") == STATEFUL_BATCHES, f"stateful bincount launches {stateful_launches}")
    check(stateful_launches.get("segment_sum_f32") == 1, f"stateful segment_sum launches {stateful_launches}")
    rows = STATEFUL_BATCHES * BATCH
    flat_preds, flat_target = preds_np[:STATEFUL_BATCHES].reshape(rows, -1), target_np[:STATEFUL_BATCHES].reshape(-1)
    _, ref_macro = numpy_auroc(flat_preds, flat_target, NUM_CLASSES)
    stateful_err = abs(float(values["AUROC"]) - ref_macro)
    check(stateful_err <= 1e-6, f"stateful AUROC off the scipy reference by {stateful_err}")
    want_cm = np.bincount(
        (flat_target * NUM_CLASSES + flat_preds.argmax(axis=-1)), minlength=NUM_CLASSES**2
    ).reshape(NUM_CLASSES, NUM_CLASSES)
    check(np.array_equal(values["ConfusionMatrix"].cpu().numpy(), want_cm), "stateful confusion matrix differs")
    auroc_metric = collection["AUROC"]
    state_bytes = sum(getattr(auroc_metric, k).numel() * getattr(auroc_metric, k).element_size() for k in ("preds", "target", "valid"))
    emit(
        {
            "phase": "stateful",
            "card": card,
            "rows": rows,
            "capacity": CAPACITY,
            "auroc_state_bytes": state_bytes,
            "update_ms_per_batch": update_s / STATEFUL_BATCHES * 1e3,
            "compute_ms": compute_s * 1e3,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": stateful_launches,
            "macro_auroc": float(values["AUROC"]),
            "macro_abs_err_vs_scipy": stateful_err,
            "compute_groups": {str(k): v for k, v in collection.compute_groups.items()},
        }
    )

    # the stat-scores and confusion-matrix family: bench_fused's collection
    # and eleven metrics over flagship batches (K1's bincount_i32)
    tm = import_module("metrics_tpu_torch")
    cls_k1 = classification_phases(torch, ops, card, tm, preds_all, target_all, preds_np, target_np)
    # the curve family: binary over bench_sketch's stream, then 1000 classes
    curve_launches, curve_k3 = curve_binary_phase(torch, ops, card, tm)
    curve_mc = curve_multiclass_phase(torch, ops, card, tm, preds_all, target_all, preds_np, target_np)

    # 5-7. the sketched default: binary (the main path of K3), inside its
    # window, and at 1000 classes
    sketch_launches, score_np, y_np, sketch_metric, sketch_batch, sketch_k1 = sketch_binary_phase(torch, ops, card, AUROC)
    sketch_window_phase(torch, ops, card, AUROC, score_np, y_np)
    sketch_multiclass_phase(torch, ops, card, AUROC, preds_all, target_all, preds_np, target_np)

    # 9-11. COCO mAP: the main path of K6, past capacity, and pycocotools
    map_launches = map_phases(torch, ops, card, MeanAveragePrecision)
    # retrieval: the main path of K4, the window, the sampled default, merges
    retrieval_launches, k4_captured, retrieval_k1 = retrieval_phases(torch, ops, card, MetricCollection)
    # K1's (and bincount's) parity, segment_sum_f32 at the captured skewed inputs too
    max_err = parity_phase(
        torch, ops, card, flagship_ids, rank_vals, auroc_ids, skewed_sum_cases(torch, sketch_k1, retrieval_k1)
    )
    # per-tenant sliced and windowed state: the main path of K2
    sliced_launches, k2_captured = sliced_psnr_phase(torch, ops, card, SlicedMetric, PeakSignalNoiseRatio)
    sliced_mse_phase(torch, ops, card, SlicedMetric, MeanSquaredError)
    windowed_psnr_phase(torch, ops, card, SlicedMetric, WindowedMetric, PeakSignalNoiseRatio)
    windowed_decay_phase(torch, ops, card, WindowedMetric, MeanSquaredError)
    # K5 is reached by 2-D boxes through the entry point ops.box_iou
    gen = torch.Generator(device="cpu").manual_seed(5)
    k5_inputs = [(iou_boxes(torch, gen, n).cuda(), iou_boxes(torch, gen, m).cuda()) for n, m in K5_PARITY_SHAPES]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b1, b2 in k5_inputs:
        ops.box_iou(b1, b2)
    torch.cuda.synchronize()
    pairwise_launches = ops.launch_counts().get("box_iou_pairwise", 0)
    check(pairwise_launches == len(K5_PARITY_SHAPES), f"ops.box_iou launched box_iou_pairwise {pairwise_launches} times")

    # K3's input on its main path: the sketch and one batch of unit rows,
    # packed occupied-first, as an absorb hands them to the compaction
    batch_score, batch_y = sketch_batch(0)
    unit_rows = torch.stack([torch.ones_like(batch_score), batch_score, batch_y.float()], dim=1)
    k3_rows = pack_rows(torch.cat([sketch_metric.csketch, unit_rows]))

    # 8. kernel times at the main path's shapes (these launches are not
    # counted). "ms", "plain_ms" and "library_ms" are CUDA-event times per
    # call over back-to-back calls, so they include any host time the card
    # waits for; "device_ms" is the kernel alone (profiler) and
    # "host_us_per_call" the wrapper's issue time.
    def bincount_call():
        return ops.bincount_i32(flagship_ids, NUM_CLASSES**2)

    def segment_sum_call():
        return ops.segment_sum_f32(rank_vals, auroc_ids, NUM_CLASSES)

    def index_add_call():
        return torch.zeros((NUM_CLASSES, 2), device=device).index_add_(0, auroc_ids, rank_vals)

    bincount_bytes = flagship_ids.numel() * flagship_ids.element_size() + NUM_CLASSES**2 * 4
    seg_bytes = rank_vals.numel() * 4 + auroc_ids.numel() * auroc_ids.element_size() + NUM_CLASSES * 2 * 4
    kernels = [
        {
            "name": "bincount_i32",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": main_launches["bincount_i32"],
            "max_abs_err": max_err["bincount_i32"],
            "ms": time_ms(torch, bincount_call),
            "plain_ms": time_ms(torch, lambda: ops.bincount_reference(flagship_ids, NUM_CLASSES**2)),
            "bound_ms": bincount_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(torch, lambda: torch.bincount(flagship_ids, minlength=NUM_CLASSES**2)),
            "host_us_per_call": host_us_per_call(torch, bincount_call),
            **kernel_device_time(torch, bincount_call, "bincount_i32_kernel"),
        },
        {
            "name": "segment_sum_f32",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": main_launches["segment_sum_f32"],
            "max_abs_err": max_err["segment_sum_f32"],
            "ms": time_ms(torch, segment_sum_call),
            "plain_ms": time_ms(torch, lambda: ops.segment_sum_reference(rank_vals, auroc_ids, NUM_CLASSES)),
            "bound_ms": seg_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(torch, index_add_call),
            "host_us_per_call": host_us_per_call(torch, segment_sum_call),
            **kernel_device_time(torch, segment_sum_call, "segment_sum_f32_kernel"),
        },
        qsketch_line(torch, ops, "sketch-binary", sketch_launches, k3_rows, SKETCH_CAPACITY),
    ]
    k5_b1, k5_b2 = (iou_boxes(torch, gen, n).cuda() for n in K5_LINE_SHAPE)
    u, d, g = K6_LINE_SHAPE
    k6_b1 = iou_boxes(torch, gen, u * d).reshape(u, d, 4).cuda()
    k6_b2 = iou_boxes(torch, gen, u * g).reshape(u, g, 4).cuda()
    iou_note = "no single PyTorch call computes box IoU: torchvision is absent, and the plain broadcast is not a library kernel"
    for name, replaces, launches, b1, b2, read_boxes, outputs in (
        ("box_iou_pairwise", K5_REPLACES, pairwise_launches, k5_b1, k5_b2, sum(K5_LINE_SHAPE), int(np.prod(K5_LINE_SHAPE))),
        ("box_iou_batched", K6_REPLACES, map_launches["box_iou_batched"], k6_b1, k6_b2, u * (d + g), u * d * g),
    ):
        fn = getattr(ops, name)
        got, plain = fn(b1, b2), ops.box_iou_reference(b1, b2)
        check(torch.equal(got.view(torch.int32), plain.view(torch.int32)), f"{name} at its line shape differs from the plain version")
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": BOX_IOU_SOURCE,
                "replaces": replaces,
                "shape": [list(b1.shape), list(b2.shape)],
                "launches": launches,
                "max_abs_err": float((got - plain).abs().max()),
                "ms": time_ms(torch, lambda: fn(b1, b2)),
                "plain_ms": time_ms(torch, lambda: ops.box_iou_reference(b1, b2), launches=20),
                # boxes read once (16 bytes each), IoUs written once
                "bound_ms": (read_boxes * 16 + outputs * 4) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": None,
                "library_note": iou_note,
                "host_us_per_call": host_us_per_call(torch, lambda: fn(b1, b2)),
                **kernel_device_time(torch, lambda: fn(b1, b2), import_module("metrics_tpu_torch.ops.box_iou").CUDA_KERNELS),
            }
        )
    kernels.append(row_topk_line(torch, ops, retrieval_launches, k4_captured))
    for name, is_max in (("segment_max_f32", True), ("segment_min_f32", False)):
        vals, ids, s = k2_captured[name][0]
        kernels.append(
            segment_fold_line(
                torch, ops, name, SEGEXT_SOURCE, K2_REPLACES, sliced_launches, (vals, ids, s),
                lambda v, i, n, is_max=is_max: ops.segment_extremum_reference(v, i, n, is_max),
                library_extremum(torch, vals, ids, s, is_max), f"{name}_kernel",
            )
        )
    vals, ids, s = k2_captured["segment_sum_i32"][0]
    kernels.append(
        segment_fold_line(
            torch, ops, "segment_sum_i32", KERNEL_SOURCE, REPLACES, sliced_launches, (vals, ids, s),
            ops.segment_sum_reference, library_index_add(torch, vals, ids, s), "segment_sum_i32_kernel",
        )
    )
    # segment_sum_f32 at its skewed main-path inputs: the sketch's compaction
    # (one bucket takes the pad rows) and the retrieval insert's counters
    for path, launches, (vals, ids, s) in (
        ("sketch-binary", sketch_launches, sketch_k1),
        ("retrieval-mslr", retrieval_launches, retrieval_k1),
    ):
        # the bits against the plain version on the CPU (row order); the
        # plain version on the card adds with atomics
        line = segment_fold_line(
            torch, ops, "segment_sum_f32", KERNEL_SOURCE, REPLACES, launches, (vals, ids, s),
            ops.segment_sum_reference, library_index_add(torch, vals, ids, s), "segment_sum_f32_kernel",
            exact_fn=lambda v, i, n: ops.segment_sum_reference(v.cpu(), i.cpu(), n).to(v.device),
        )
        kernels.append({**line, "path": path})
    # bincount_i32 at the classification phases' own ids, with their launches
    for path, (launches, ids, bins) in cls_k1.items():
        kernels.append(bincount_line(torch, ops, path, launches, ids, bins))
    # the curve phases' own inputs: segment_sum_f32 at the binned curve's and
    # CalibrationError's sums (launches at that shape), bincount_i32 at the
    # weighted AP's supports, K3 at curve-binary's compactions
    kernels += curve_kernel_lines(torch, ops, curve_mc, curve_launches, curve_k3)
    emit({"phase": "kernel_times", "card": card})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit(
        {
            "ok": True,
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
        }
    )
    return 0


def write_profile(torch, confmat, preds_all, target_all, auroc_fn, step_s):
    """Device time by kernel over three flagship steps (torch.profiler), and
    the device's idle share of the unprofiled step time ``step_s``."""
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    state = confmat.init_state()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state = confmat.update_state(state, preds_all[i], target_all[i])
            auroc_fn(preds_all[i], target_all[i], NUM_CLASSES, average="macro")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    # device rows (kernels, memsets, copies) have no CPU time of their own
    device_us = sum(_self_device_us(evt) for evt in averages if evt.self_cpu_time_total == 0)
    print(averages.table(sort_by="cuda_time_total", row_limit=25), file=sys.stderr, flush=True)
    emit(
        {
            "phase": "profile",
            "steps": steps,
            "profiled_wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": device_us / steps / 1e3,
            "device_idle_share": 1 - device_us / steps / 1e6 / step_s,
        }
    )


if __name__ == "__main__":
    sys.exit(main())
