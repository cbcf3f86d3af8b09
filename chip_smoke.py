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
18b. the fused update on CUDA graphs (``compile_update``), each phase an
   eager leg against a fused leg over the same batches (each leg's first
   update eager: it forms the compute groups), every state and value bit
   for bit, ms per update, device ms per update and idle share (three
   updates under torch.profiler), host syncs per update, launches, captures,
   each graph's launches per replay and the members on the eager leg:
   fused-classification -- classification-collection's 30 updates with
   buckets=(2048,): one capture, 0 host syncs per fused update, and
   bincount_i32 launched as the graph recorded it times its replays (2 per
   replay: the batch and the pad row's delta); fused-flagship --
   ConfusionMatrix(1000) and AUROC(1000, capacity=65536) over 12 flagship
   batches (no buckets: the capacity buffers are "cat" states), launches
   equal on both legs; fused-sketch -- bench_sketch's fused collection,
   Accuracy() and AUROC(), over 64 batches of curve-binary's stream with
   buckets=(4096,): one K3 and one K1 launch per replay (a captured absorb
   always compacts), and the extra device time of a replay inside the
   lossless window; fused-sliced -- SlicedMetric(PSNR(), 1000) over
   sliced-psnr's 16 updates, K1 and K2 inside the graph; fused-windowed --
   windowed-decay's stream through the ring and the decay
   WindowedMetric(MSE()) with buckets=(2048,) (n_valid, the pads corrected
   in the live slot); fused-retrieval -- 12 of retrieval-mslr's updates
   (the last one short and padded) with buckets=(16384,), or the member the
   probe declined and why;
18c. async -- bench_async's serving loop on classification-collection's
   metrics: a sleep of about one blocking update, then the batch through
   compile_update() or compile_update_async(queue_depth=2); steps per second
   of each (best of 3 epochs of 100), enqueue µs, 0 dropped, final states
   bit for bit;
18d. regression-depth -- per-pixel depth evaluation as a monocular-depth
   training loop logs it on NYU-Depth v2's test split (640 x 480 frames,
   depth 0.5-10 m; 654 images cut to 128): 16 updates of 8 images made on
   the card from a seed (2,457,600 pairs each, predictions = depth x a
   log-normal factor) through MSE, MAE, MAPE, SMAPE, MSLE,
   TweedieDevianceScore(power=1.5), ExplainedVariance, R2Score,
   PearsonCorrCoef and SpearmanCorrCoef (the rank sketch) over the flat
   pairs and CosineSimilarity over the [8, 307200] image rows, each
   collection eager and through compile_update(); gates: every state bit
   for bit between the legs and against a second card run, every value
   within rtol 1e-5 of the port's CPU run over the first 2 updates and
   within 1e-6 (relative above 1) of float64 over the whole stream (float64
   on the card, its formulas held within 1e-12 of numpy and
   scipy.stats.spearmanr on two images first; Spearman's is
   SpearmanCorrCoef(exact=True) over the 39.3M pairs), the sketched
   Spearman within 4 (1 - rho**2) / sqrt(8192) of exact; ms per update,
   device ms, idle share, host syncs per update and state bytes per leg;
18e. sketch-bf16 -- AUROC() over curve-binary's stream after
   set_dtype(torch.bfloat16), eager and fused: half-precision sketch rows
   compact widened to float32 (K3, then segment_sum_f32) and round back
   once; gates: K3 and segment_sum_f32 launched once per compaction (243
   eager), both bit-equal to their plain versions at a captured bfloat16
   compaction, the states bit-equal to the port's CPU run over the first
   16 batches, the value within 1e-4 of the float32 run's;
18f. windowed-sketch -- the ring of sketch leaves:
   WindowedMetric(AUROC(pos_label=1)) at window 2 and 8 over curve-binary's
   stream (no compaction while a bucket's batch fits) and
   WindowedMetric(SpearmanCorrCoef(), window=8) over regression-depth's
   last 8 updates; gates: the window-2 read bit-equal to a fresh AUROC fed
   the last 2 batches, the window-8 AUROC within 5e-3 of exact (float64
   midranks), one K3 and one segment_sum_f32 launch per merge of a read,
   bit-equal to their plain versions at a captured fold, and the windowed
   Spearman within 4 standard errors of exact over its window;
18g. wrappers-flagship -- a training loop's MetricTracker over
   MetricCollection({loss: MeanMetric(), loss_max: MaxMetric(), acc:
   Accuracy(1000), err: 1 - Accuracy(1000)}) (three steps of 4 flagship
   batches; the loss the per-sample NLL, made on the card), and beside it
   BootStrapper(CohenKappa(1000), 10 copies, multinomial, seed 0),
   ClasswiseWrapper(JaccardIndex(1000, reduction="none")) and
   MinMaxMetric(Accuracy(1000)) through forward; gates: bincount_i32
   launched 2 x (10 + 1) times per batch (each forward updates twice) and
   the profiler's count equal to the counters, every state bit for bit
   against a second card run and the CPU's first step, the tracker's values
   and best_metric(return_step=True) equal to the CPU's, the wrappers'
   values within the classification tolerances of the CPU; then the
   collection eager against compile_update(): err declined by name, the
   other members' states bit for bit, 0 host syncs inside the replays;
18h. bootstrap-auroc -- BootStrapper(AUROC(), 50 copies, seed 0) over
   curve-binary's first 24 batches (every copy passes the sketch's 8192
   rows): one K3 and one segment_sum_f32 launch per copy per compacting
   update (counted from the seed's draws before the run), bit for bit
   against the CPU over 2 updates, mean and std within 5e-3 of the exact
   AUROC's bootstrap (float64 midranks on the card, the same indices);
18i. multioutput-regression -- MultioutputWrapper(R2Score(), 3) and
   MultioutputWrapper(MeanAbsoluteError(), 3) over 16 updates of 8 unit
   surface-normal maps of 640 x 480 (2,457,600 rows x 3 per update, 10% of
   the rows with a NaN in one output, removed), no kernel launched, states
   bit for bit against a second card run, values within rtol 1e-5 of the
   CPU over 2 updates and 1e-6 (relative above 1) of float64;
18j. pairwise-embeddings -- cosine, linear and euclidean over [8192, 512]
   embeddings and manhattan over [2048, 512], reduction None and "mean",
   one input and two: each within 1e-6 of its largest float64 value,
   bit-equal with TF32 switched on by the caller, 0 host syncs;
18k. the sync families: two ranks spawned on cuda:0 in one gloo
   group (the collectives take the card tensors; the folds run on the
   card), every rank's stream split by batch (rank r: r, r + 2, ...):
   sync-flagship -- ConfusionMatrix(1000) and AUROC(1000, capacity=65536)
   over the 12 seed-42 batches, and Accuracy(1000, dist_sync_on_step=True)
   through forward; sync-sketch -- AUROC() over sketch-binary's 6,553,600
   samples (each rank past capacity: K3 + K1 once per merge), the first
   8192 samples split (inside the window: no K3, against one without the
   exchanged occupancy bounds), ROC() and AveragePrecision() over
   curve-binary; sync-retrieval -- RetrievalNormalizedDCG and RetrievalMAP
   (max_docs 256: lossless) over config 4 with documents dealt in chunks of
   64, so most queries live on both ranks (one K4 per table merge);
   sync-map -- MeanAveragePrecision(class_metrics=True) over config 3's
   5000 images; sync-sliced -- SlicedMetric(PSNR(), 1000) over
   sliced-psnr's 16 updates and WindowedMetric(MSE(), window=8) over 40.
   Each sync is recorded: its ms, bytes gathered, collective rounds, host
   reads and each kernel's launches (held to world - 1 per sketch and table
   leaf, none elsewhere), every rank's synced states equal (sha256 of their
   bits), and rank 0's held bit for bit against the CPU's plain folds of the
   same gathers; each synced compute() timed (median of 3). Gates: the
   confusion matrix bit-equal to one process over all 12 batches, AUROC
   within 1e-6 of scipy, each forward value the global batch's accuracy;
   the sketched values within 5e-3 of exact, the window bit-equal to one
   process; NDCG and MAP bit-equal to one process's exact=True and to its
   table; every mAP key bit-equal to one process; sliced and
   windowed counts, max and min bit-equal to one process, float sums and
   values within rtol 1e-6;
18l. sync-bundle -- BASELINE config 6 on the card: eight ranks on cuda:0,
   each with a ConfusionMatrix(1000) and a binary AUROC(capacity=65536)
   (about 4.6 MB), synced per metric (Metric.sync) and in one sync_pytree
   call over the collection's state_reductions(), 3 + 20 times each: p50 and
   p95 ms per rank, bytes and rounds; the synced bundle equal on every rank
   and between the two paths;
18m. nccl-world1 -- the NCCL transport in a one-process group: card
   tensors of every state dtype (bfloat16 NaN payloads of both signs
   among them) all-gathered as bytes, the same bits back (multi-rank NCCL
   needs a card per rank: not measured);
18n. ssim -- BASELINE config 5: 64 restoration outputs of 3 x 192 x 192
   against their ground truth (uniform targets plus N(0, 0.1) noise,
   clipped; made on the card from a seed) through
   StructuralSimilarityIndexMeasure(), MultiScaleStructuralSimilarityIndexMeasure()
   and UniversalImageQualityIndex(), 4 updates of 16 then compute(); gates:
   0 host syncs per update, no launch of a kernel of ours, each functional
   over all 64 bit-equal to its metric's compute(), image_gradients bit-equal
   to the CPU's, every value within rtol 1e-5 of the port's CPU run and of a
   float64 evaluation on the CPU; images/s, update and compute ms, device ms
   and idle share of one profiled compute, its top device kernels, state
   bytes, peak memory;
18o. fid-inception -- BASELINE config 5b: 16 real and 16 fake uint8 [64, 3,
   299, 299] batches (random colour fields of two generators, made on the
   card from a seed) through FrechetInceptionDistance(2048),
   KernelInceptionDistance(subset_size=1000) and InceptionScore() on the
   InceptionV3 at full width (seeded random weights written to the JAX
   package's .npz layout by convert.inception_to_flax, BatchNorm statistics
   calibrated on a seeded batch), each eager and through compile_update();
   gates: states and values bit-equal between the legs, nothing declined, 0
   host syncs per fused update, streaming FID within rtol 1e-3 of
   exact=True's float64 value, KID in its reservoir window (1024 <= 2048
   rows) bit-equal to exact=True, the features bit-equal with the caller's
   TF32 flags all on and all off (each flag found as set after the call);
   images/s, device ms and idle share per batch, compute ms, state bytes,
   peak memory, and the features' gap were TF32 on inside (information);
18p. lpips -- LearnedPerceptualImagePatchSimilarity alex and vgg over 64
   pairs of 3 x 256 x 256 in [-1, 1] (4 updates of 16; seeded random weights
   through convert.lpips_to_flax), eager and fused; gates: states and values
   bit-equal between the legs, nothing declined, 0 host syncs per fused
   update, the first update's value within rtol 1e-5 of the port's CPU run;
   pairs/s, device ms and idle share per update, peak memory; (ssim also
   checks that uint8 images are refused with a TypeError by each
   functional and each class's update, on the card);
18q. sliced-probability -- SlicedMetric(Accuracy(num_classes=10), 1000)
   over 8 updates of 4096 softmax rows made on the card from a seed (the
   vmapped top-1 mask of probability rows); gate: the per-tenant values
   bit-equal to the port's CPU run; ms per update, launches per update;
18r. text-corpus -- a synthetic corpus of WMT newstest size (3000 pairs,
   see TEXT_SEED) in batches of 64 through BLEU, SacreBLEU (13a and char),
   chrF, chrF++, TER and EED (their first 512 pairs), ROUGE (rouge1, rouge2,
   rougeL), WER, CER, MER, WIL and WIP on the first reference, and SQuAD on
   a seeded QA set of 3000 questions; CPU workers spawned at the phase's
   start run the same metrics with device="cpu"; gates: every value and
   state on the card bit-equal to theirs, one host-to-device copy per
   update (counted at the dispatcher), 0 host syncs per update, no launch
   of a kernel of ours; sentences/s, ms per update, compute ms, device ms
   per update, state bytes;
18s. bertscore-base -- BASELINE config 5c: bert_score over 24 batches of
   64 seeded sequences of 128 tokens on the port's BERT at BertConfig()'s
   widths (BERT-base, seeded weights from a generator on the card, full
   float32); gates: 1536 finite precision/recall/F1 values, the first
   batch's within 1e-4 of a float64 copy of the encoder on the card, no
   launch of a kernel of ours; pairs/s, ms and device ms per encoder batch,
   idle share, the encoder's share of the float32 peak, the gap TF32 inside
   would make on the last hidden state (information), peak memory;
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
   again, at most five in all; when all miss, the CUDA-event time of the
   back-to-back calls, and ``device_ms_source`` says which); and each
   kernel's launches inside the sync phases' syncs, by phase and rank
   (``sync_launches``).

PERF.md gives the run times measured on an H100 and where they go. Then the card's name
and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the script exits non-zero and prints no result line; it does the
same without CUDA, or without the metrics_tpu_torch package beside it.
"""
import gc
import hashlib
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
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
#: the CUDA kernel that each wrapper of a fused phase launches once per call
#: (a merge, scan or combine pass may follow it)
WRAPPER_KERNEL = {
    "bincount_i32": "bincount_i32_kernel",
    "segment_sum_f32": "segment_sum_f32_kernel",
    "segment_sum_i32": "segment_sum_i32_kernel",
    "segment_max_f32": "segment_max_f32_kernel",
    "segment_min_f32": "segment_min_f32_kernel",
    "qsketch_sort_bucket": "sort_tiles_kernel",
    "row_topk": "topk_select_kernel",
}
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

# the fused update and the async pipeline
FUSED_BUCKET = 2048
FUSED_SKETCH_BATCHES = 64
ASYNC_BATCH = 2048
ASYNC_POOL = 8
ASYNC_STEPS = 100
ASYNC_EPOCHS = 3
FUSED_RETRIEVAL_UPDATES = 12
# regression-depth: NYU-Depth v2's test frames (640 x 480, depth 0.5-10 m),
# cut from 654 images to 128
DEPTH_IMAGES = 8
DEPTH_SHAPE = (480, 640)
DEPTH_UPDATES = 16
DEPTH_CPU_UPDATES = 2
DEPTH_SEED = 12000
DEPTH_RANGE = (0.5, 10.0)
DEPTH_NOISE = 0.1
RANK_CAPACITY = 8192
# wrappers-flagship: 12 flagship batches, a tracker step every 4, ten
# bootstrap copies
WRAP_BATCHES = 12
WRAP_STEP_BATCHES = 4
WRAP_BOOTSTRAPS = 10
# bootstrap-auroc: 50 copies over curve-binary's first 24 batches
BOOT_BATCHES = 24
BOOT_COPIES = 50
BOOT_CPU_UPDATES = 2
# multioutput-regression: surface normals at regression-depth's frame size
# cross-process sync: ranks spawned on cuda:0 in a gloo group
SYNC_DEVICE = "cuda"
SYNC_WORLD = 2
SYNC_TIMEOUT_S = 600
SYNC_COMPUTE_REPEATS = 3
SYNC_RETRIEVAL_CHUNK = 64
SYNC_RETRIEVAL_MAX_DOCS = 256
BUNDLE_WORLD = 8
BUNDLE_TIMEOUT_S = 300
BUNDLE_WARMUP = 3
BUNDLE_ITERS = 20
#: the kernels a sync's launches are held to (K1-K6)
SYNC_GATED_KERNELS = (
    "bincount_i32",
    "segment_sum_f32",
    "segment_sum_i32",
    "segment_max_f32",
    "segment_min_f32",
    "qsketch_sort_bucket",
    "row_topk",
    "box_iou_pairwise",
    "box_iou_batched",
)

NORMAL_SEED = 13000
NORMAL_NOISE = 0.1
NORMAL_INVALID = 0.1
# pairwise-embeddings: CLIP ViT-B/32 widths (512), 8192 rows (2048 for the
# manhattan distance's [N, M, d] work); every result within 1e-6 of its
# largest float64 value (a float32 rounding of each term and at most
# log2(512) rounded additions)
PAIRWISE_SEED = 14000
PAIRWISE_ROWS = 8192
PAIRWISE_DIM = 512
PAIRWISE_L1_ROWS = 2048
PAIRWISE_RTOL = 1e-6
# ssim: BASELINE config 5 (64 x 3 x 192 x 192 float32), a restoration
# model's outputs (the targets plus N(0, 0.1) noise, clipped to [0, 1])
# against their ground truth, made on the card from a seed; 4 updates of 16;
# values within rtol 1e-5 of the port's CPU run and of a float64 evaluation
# on the CPU
SSIM_SEED = 15000
#: where the image phases make their data (the CPU only for a rehearsal)
IMAGE_DEVICE = "cuda"
SSIM_IMAGES = 64
SSIM_SHAPE = (3, 192, 192)
SSIM_UPDATES = 4
SSIM_NOISE = 0.1
SSIM_RTOL = 1e-5
# fid-inception: BASELINE config 5b, uint8 [64, 3, 299, 299] batches made on
# the card from a seed: random colour fields (8 x 8 cells over 0..255 for the
# real images; 12 x 12 over 32..200 for a generator's, a duller one)
# upsampled bilinearly to 299 x 299, plus N(0, 8) pixel noise; 16 real and
# 16 fake batches. The InceptionV3 at full width with seeded random weights:
# tests/image/test_fid_kid_is.py's recipe (the default initialisation under
# seed 0, BatchNorm weights U(0.5, 1.5), biases N(0, 0.1)), but the
# BatchNorm running statistics taken from a calibration batch of both
# generators: with the recipe's random statistics the activations vanish
# with depth, and the 2048 pooled features are the same for every input
# (a within-batch standard deviation of 6.6e-9 on the CPU), which leaves FID
# nothing to measure. Streaming FID within rtol 1e-3 of exact=True's float64
# value (the JAX package's device tolerance).
FID_SEED = 16000
FID_BATCH = 64
FID_BATCHES = 16
#: (cells per side, low, high) of the colour fields of each generator
FID_REAL = (8, 0, 256)
FID_FAKE = (12, 32, 201)
FID_PIXEL_NOISE = 8.0
FID_CALIBRATION = 64
FID_RTOL = 1e-3
KID_SUBSET = 1000
# lpips: alex and vgg over 64 pairs of 3 x 256 x 256 in [-1, 1] (the second
# image the first plus N(0, 0.2) noise, clipped), 4 updates of 16, seeded
# random weights (tests/image/test_lpips.py's recipe); the value within rtol
# 1e-5 of the port's CPU run over the first update's pairs
LPIPS_SEED = 17000
LPIPS_PAIRS = 64
LPIPS_SHAPE = (3, 256, 256)
LPIPS_UPDATES = 4
LPIPS_NOISE = 0.2
LPIPS_RTOL = 1e-5
# sliced-probability: SlicedMetric(Accuracy(num_classes=10), 1000) on
# softmax rows (the vmapped top-1 mask): 8 updates of 4096 rows made on the
# card from a seed, the per-tenant values bit-equal to the port's CPU run
SLICED_PROB_SEED = 18000
SLICED_PROB_ROWS = 4096
SLICED_PROB_UPDATES = 8
SLICED_PROB_CLASSES = 10
SLICED_PROB_TENANTS = 1000
# text-corpus: a synthetic corpus of a WMT newstest set's size (3000
# sentence pairs), made from a seed: hypotheses of 10-40 words drawn from a
# Zipf vocabulary of 5000 seeded pseudo-words (a capital first letter, a
# full stop), two references each made from the hypothesis by seeded
# substitutions (10%), deletions (5%), insertions and one shifted span of
# 2-4 words; batches of 64; a seeded QA set of the same size for SQuAD.
# TER and EED (pure-Python dynamic programs on the host: about 12 and 38 ms a
# pair on this corpus on the CPU) take the first TEXT_SLOW_PAIRS pairs. The same metrics run on the CPU in
# TEXT_CPU_WORKERS spawned processes while the card leg runs; every value
# and state on the card bit-equal to theirs.
TEXT_SEED = 19000
TEXT_PAIRS = 3000
TEXT_VOCAB = 5000
TEXT_WORDS = (10, 40)
TEXT_BATCH = 64
TEXT_SLOW_PAIRS = 512
TEXT_CPU_WORKERS = 4
TEXT_TIMEOUT_S = 300
#: where the sliced-probability, text and BERTScore phases run (the CPU
#: only for a rehearsal)
TEXT_DEVICE = "cuda"
# bertscore-base: BASELINE config 5c, BERTScore on the port's BERT at
# BertConfig()'s widths (BERT-base: vocab 30522, hidden 768, 12 layers, 12
# heads, intermediate 3072, 512 positions; seeded weights, about 440 MB in
# float32) over 24 batches of 64 seeded sequences of 128 tokens (lengths
# 24-128, the rest padding) through bert_score on pre-tokenized input_ids /
# attention_mask dicts; precision, recall and F1 of the first batch within
# BERT_ATOL of a float64 copy of the same module on the card
BERT_SEED = 20000
BERT_BATCH = 64
BERT_BATCHES = 24
BERT_SEQ = 128
BERT_ATOL = 1e-4
#: BertConfig overrides (none: BERT-base; a rehearsal on the CPU shrinks it)
BERT_WIDTHS = {}
#: the float32 rate of one H100 outside the tensor cores (SXM data sheet):
#: the encoder runs at full float32 with TF32 off
FP32_FLOPS_PER_S = 67e12
# sketch-bf16: |bfloat16 - float32| of AUROC() over curve-binary's stream;
# 1.70e-5 measured on the CPU (scripts/reference_properties.py)
BF16_SKETCH_BOUND = 1e-4
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
    taken to read it, with ``device_ms_source`` "profiler". The wrappers'
    host work and the output zeroing are not in it. When no window recorded
    a launch, ``device_ms`` is the CUDA-event time of ``launches``
    back-to-back calls instead (source "cuda_events": the wrappers' issue
    gaps are in it, so it bounds the kernel's time from above), with a
    line on standard error."""
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
        print(
            f"chip_smoke: the profiler recorded no launch of {names} in {windows} windows; timing {launches} calls with CUDA events",
            file=sys.stderr,
            flush=True,
        )
        return {"device_ms": time_ms(torch, fn, launches=launches), "device_windows": windows, "device_ms_source": "cuda_events"}
    total_ms = 0.0
    for evt in found:
        # the profiler may miss an event at the edge of its window: a
        # kernel's time per launch it saw, times its launches per call
        per_call = max(1, round(evt.count / launches))
        total_ms += _self_device_us(evt) / evt.count * per_call / 1e3
    return {"device_ms": total_ms, "device_windows": windows, "device_ms_source": "profiler"}


def device_profile(torch, step, steps, host_ops=True):
    """``step(i)`` for ``i < steps`` under torch.profiler: wall and device
    time per step and the kernels that took the most device time.
    ``host_ops=False`` records the device alone (a step of thousands of
    host ops takes seconds to profile with them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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
        "kernel_calls": {evt.key: evt.count for evt in device},
    }


def device_launches(kernel_calls):
    """Each wrapper's launches as the device ran them: the calls of its
    first kernel (``WRAPPER_KERNEL``) in a profile, graph replays included."""
    out = {}
    for wrapper, kernel in WRAPPER_KERNEL.items():
        pattern = re.compile(rf"(?<!\w){kernel}(?!\w)")
        n = sum(count for key, count in kernel_calls.items() if pattern.search(key))
        if n:
            out[wrapper] = n
    return out


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
    word = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(nan, torch.isnan(b)) and a.dtype == b.dtype and torch.equal(a[~nan].view(word), b[~nan].view(word))


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
    """The tensor's bits on the host (bool as bytes, 2-byte types as int16,
    the others as int32)."""
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bool:
        return x.view(torch.int8)
    return x.view(torch.int16) if x.element_size() == 2 else x.view(torch.int32)


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


# ---------------------------------------------------------------------------
# the fused update on CUDA graphs, and the async pipeline
# ---------------------------------------------------------------------------


def syncs_per_update(torch, update, batches):
    """Host synchronisations per ``update(batch)`` (steady state), counted
    as the warnings of ``torch.cuda.set_sync_debug_mode("warn")``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for batch in batches:
                update(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    return len(syncs) / len(batches)


def update_args(collection, batch):
    collection.update(*batch)


def fused_legs(torch, ops, name, make, batches, compile_kw, update=update_args):
    """The eager and the fused leg of one phase over the same batches. Each
    leg is a fresh collection whose first update runs eagerly (it forms the
    compute groups); the fused leg then calls ``compile_update(**compile_kw)``.
    The launch counters are reset before the second update, whose time (on
    the fused leg: the probe, the capture and one replay) is kept apart from
    the steady updates after it. Every state of the two legs is held bit for
    bit, and every computed value. Returns ``{leg: record}``."""
    legs = {}
    for leg in ("eager", "fused"):
        collection = make()
        update(collection, batches[0])
        handle = collection.compile_update(**compile_kw) if leg == "fused" else None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        update(collection, batches[1])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for batch in batches[2:]:
            update(collection, batch)
        torch.cuda.synchronize()
        steady_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        values = collection.compute()
        legs[leg] = {
            "label": f"{name} {leg}",
            "collection": collection,
            "handle": handle,
            "first_update_ms": first_ms,
            "ms_per_update": steady_s / (len(batches) - 2) * 1e3,
            "launches": launches,
            "updates": len(batches) - 1,
            "values": values,
            "states": collection_states(torch, collection),
        }
    eager, fused = legs["eager"], legs["fused"]
    differ = state_bits_differ(torch, eager["states"], fused["states"])
    check(not differ, f"{name}: the fused leg's states differ from the eager leg's in {differ}")
    check(eager["states"].keys() == fused["states"].keys(), f"{name}: the legs hold different states")
    for key, value in eager["values"].items():
        check(same_outputs(torch, value, fused["values"][key]), f"{name}: fused {key} differs from eager")
    return legs


def leg_report(torch, ops, leg, update, batches, profiled=3):
    """ms per update, device ms per update and idle share (``profiled``
    updates under torch.profiler), host syncs per update (three more) and
    the launches of one leg. In the profiled window the launches that the
    device ran (``device_launches``) must equal the launch counters, and on
    the fused leg each graph's launches recorded at capture times its
    replays there: so the counters stand for kernels that ran inside the
    graphs. A window that missed launches is taken again (up to
    ``PROFILE_WINDOWS``), each from a reset collection."""
    collection = leg["collection"]
    handle = leg["handle"]
    entries = list(handle._cache.values()) if handle is not None else []
    for windows in range(1, PROFILE_WINDOWS + 1):
        collection.reset()  # keeps the fused handle; the capacity buffers refill
        calls0 = [entry.calls for entry in entries]
        ops.reset_launch_counts()
        profile = device_profile(torch, lambda i: update(collection, batches[i]), profiled)
        counted = {k: n for k, n in ops.launch_counts().items() if n}
        seen = device_launches(profile["kernel_calls"])
        if seen == counted:
            break
    check(seen == counted, f"{leg['label']}: the device ran {seen} launches in {windows} profiled windows, the counters say {counted}")
    replayed = {}
    for entry, c0 in zip(entries, calls0):
        for kernel, n in entry.launches.items():
            replayed[kernel] = replayed.get(kernel, 0) + n * (entry.calls - c0)
    if handle is not None:
        replayed = {k: n for k, n in replayed.items() if n}
        check(seen == replayed, f"{leg['label']}: the device ran {seen} launches, the graphs' replays hold {replayed}")
    out = {
        "ms_per_update": leg["ms_per_update"],
        "first_update_ms": leg["first_update_ms"],
        "device_ms_per_update": profile["device_busy_ms_per_step"],
        "profiled_wall_ms_per_update": profile["profiled_wall_ms_per_step"],
        "device_idle_share": 1 - profile["device_busy_ms_per_step"] / leg["ms_per_update"],
        "host_syncs_per_update": syncs_per_update(torch, lambda b: update(collection, b), batches[3:6]),
        "launches": leg["launches"],
        "device_launches_profiled": seen,
        "profiled_windows": windows,
        "top_device_us": profile["device_us_per_step_by_kernel"],
    }
    if handle is not None:
        out.update(
            cache_size=handle.cache_size,
            captures=handle.n_compiles,
            launches_per_replay=[dict(entry.launches) for entry in entries],
            replays=sum(entry.calls for entry in entries),
            eager_leg=sorted(handle._eager_names),
            declined=dict(handle.declined),
        )
    return out


def check_replay_launches(name, legs, kernel, eager_expected):
    """Launches of ``kernel`` over each leg's run (the fused leg's replays
    counted): some on the fused leg, and ``eager_expected`` on the eager
    leg. That they ran inside the graphs is ``leg_report``'s gate."""
    updates = legs["fused"]["updates"]
    eager_n = legs["eager"]["launches"].get(kernel, 0)
    fused_n = legs["fused"]["launches"].get(kernel, 0)
    check(fused_n > 0, f"{name}: {kernel} launched no time on the fused leg")
    check(eager_n == eager_expected, f"{name}: {kernel} launched {eager_n} times on the eager leg, expected {eager_expected}")
    return {"eager": eager_n, "fused": fused_n, "fused_per_replay": fused_n / updates, "updates": updates}


def check_kept_values(torch, name, compute, update, batches, collection):
    """A value that ``compute()`` returned does not change under later
    updates: a donating handle's replays overwrite the states in place, so
    compute hands out copies of any result that shares a state buffer. The
    kept values are read once while the updates may still run (on the async
    worker's stream) and once after ``collection.compute()`` has waited for
    them."""
    kept = compute()
    frozen = {key: [t.clone() for t in flat_outputs(v)] for key, v in kept.items()}
    held = {
        getattr(m, k).untyped_storage().data_ptr()
        for m in collection.values()
        for k in m._defaults
        if isinstance(getattr(m, k), torch.Tensor)
    }
    shared = [key for key, v in kept.items() if any(t.untyped_storage().data_ptr() in held for t in flat_outputs(v))]
    for batch in batches:
        update(batch)
    changed = {}
    for when in ("during", "after"):
        if when == "after":
            collection.compute()
            torch.cuda.synchronize()
        changed[when] = [
            key for key, v in kept.items() if not all(torch.equal(a, b) for a, b in zip(flat_outputs(v), frozen[key]))
        ]
    check(not shared and not any(changed.values()), f"{name}: kept compute() values share state buffers {shared} or changed {changed}")
    return sorted(kept)


def fused_classification_phase(torch, ops, card, tm):
    """fused-classification: bench_fused's 30 updates (1900/2000/2048 rows
    cycled) through classification-collection's eight metrics, eager
    against compile_update(buckets=(2048,))."""
    t_phase = time.perf_counter()
    fused = fused_batches()
    epoch = [fused[i % len(fused)] for i in range(len(fused) * CLS_REPEATS)]
    batches = [(torch.from_numpy(p).cuda(), torch.from_numpy(t).cuda()) for p, t in epoch]
    legs = fused_legs(torch, ops, "fused-classification", lambda: fused_collection(tm, "cuda"), batches, {"buckets": (FUSED_BUCKET,)})
    report = {leg: leg_report(torch, ops, legs[leg], update_args, batches) for leg in legs}
    fused_r = report["fused"]
    check(fused_r["cache_size"] == 1 and fused_r["captures"] == 1, f"fused-classification: {fused_r['captures']} captures, cache {fused_r['cache_size']}")
    check(not fused_r["eager_leg"], f"fused-classification: members on the eager leg {fused_r['declined']}")
    check(fused_r["host_syncs_per_update"] == 0, f"fused-classification: {fused_r['host_syncs_per_update']} host syncs per fused update")
    # each replay counts the batch's bincount and the pad row's (the
    # k * delta(last_row) correction runs the update on one row)
    k1 = check_replay_launches("fused-classification", legs, "bincount_i32", len(batches) - 1)
    check(fused_r["launches_per_replay"][0].get("bincount_i32") == 2, f"fused-classification: graph launches {fused_r['launches_per_replay']}")
    emit({"phase": "fused-classification", "card": card, "updates": len(batches), "bucket": FUSED_BUCKET,
          "bincount_i32": k1, "compute_groups": {str(k): v for k, v in legs["fused"]["collection"].compute_groups.items()},
          **report, "seconds": time.perf_counter() - t_phase})
    return legs


def fused_flagship_phase(torch, ops, card, tm, preds_all, target_all):
    """fused-flagship: MetricCollection([ConfusionMatrix(1000),
    AUROC(num_classes=1000, capacity=65536)]) over the 12 flagship batches,
    eager against compile_update() (the capacity buffers are "cat" states,
    so no buckets: one graph for the one shape)."""
    t_phase = time.perf_counter()
    batches = [(preds_all[i], target_all[i]) for i in range(STATEFUL_BATCHES)]

    def make():
        return tm.MetricCollection([tm.ConfusionMatrix(num_classes=NUM_CLASSES), tm.AUROC(num_classes=NUM_CLASSES, capacity=CAPACITY)])

    legs = fused_legs(torch, ops, "fused-flagship", make, batches, {})
    report = {leg: leg_report(torch, ops, legs[leg], update_args, batches) for leg in legs}
    fused_r = report["fused"]
    check(fused_r["cache_size"] == 1 and fused_r["captures"] == 1, f"fused-flagship: {fused_r['captures']} captures")
    check(not fused_r["eager_leg"], f"fused-flagship: members on the eager leg {fused_r['declined']}")
    check(fused_r["host_syncs_per_update"] == 0, f"fused-flagship: {fused_r['host_syncs_per_update']} host syncs per fused update")
    k1 = check_replay_launches("fused-flagship", legs, "bincount_i32", len(batches) - 1)
    check(k1["eager"] == k1["fused"], f"fused-flagship: bincount_i32 launches {k1}")
    overflow = int(legs["fused"]["collection"]["AUROC"].overflow)
    check(overflow == 0, f"fused-flagship: {overflow} samples overflowed the capacity")
    col = legs["fused"]["collection"]
    kept = check_kept_values(torch, "fused-flagship", col.compute,
                             lambda b: col.update(*b), batches[:2], col)
    emit({"phase": "fused-flagship", "card": card, "updates": len(batches), "bincount_i32": k1, **report,
          "kept_values_unchanged": kept, "seconds": time.perf_counter() - t_phase})


def fused_sketch_phase(torch, ops, card, tm):
    """fused-sketch: bench_sketch's fused collection,
    MetricCollection([Accuracy(), AUROC()]), over curve-binary's stream,
    eager against compile_update(buckets=(4096,)). A captured absorb always
    compacts (K3, then K1's float sum) and selects on the device, so the
    extra cost inside the lossless window is measured too."""
    t_phase = time.perf_counter()
    score_np, y_np = make_curve_stream()
    score, y = torch.from_numpy(score_np).cuda(), torch.from_numpy(y_np).cuda()
    batches = [(score[i], y[i]) for i in range(FUSED_SKETCH_BATCHES)]

    def make():
        return tm.MetricCollection([tm.Accuracy(), tm.AUROC()])

    legs = fused_legs(torch, ops, "fused-sketch", make, batches, {"buckets": (CURVE_BATCH,)})
    report = {leg: leg_report(torch, ops, legs[leg], update_args, batches) for leg in legs}
    fused_r = report["fused"]
    check(fused_r["cache_size"] == 1 and not fused_r["eager_leg"], f"fused-sketch: cache {fused_r['cache_size']}, eager {fused_r['declined']}")
    per_replay = fused_r["launches_per_replay"][0]
    check(per_replay.get("qsketch_sort_bucket") == 1 and per_replay.get("segment_sum_f32") == 1, f"fused-sketch: graph launches {per_replay}")
    # the eager leg compacts once the stream may pass the capacity: from the
    # third batch on (two batches fill the lossless window)
    k3 = check_replay_launches("fused-sketch", legs, "qsketch_sort_bucket", len(batches) - 2)
    # inside the lossless window: one update of an empty sketch, eager (no
    # compaction) against a replay (a compaction whose result is not kept)
    window = {}
    for leg in ("eager", "fused"):
        collection = legs[leg]["collection"]
        collection.reset()  # keeps the fused handle and its graph
        window[leg] = device_profile(torch, lambda i: collection.update(*batches[i]), 1)["device_busy_ms_per_step"]
        check(int(collection["AUROC"].n_seen) == CURVE_BATCH, f"fused-sketch: {leg} window update saw {int(collection['AUROC'].n_seen)} rows")
    emit({"phase": "fused-sketch", "card": card, "updates": len(batches), "bucket": CURVE_BATCH,
          "qsketch_sort_bucket": k3, "k3_k1_per_replay": per_replay,
          "window_device_ms": window, "window_extra_device_ms": window["fused"] - window["eager"],
          **report, "seconds": time.perf_counter() - t_phase})


def fused_sliced_windowed_phase(torch, ops, card, tm, SlicedMetric, WindowedMetric):
    """fused-sliced: SlicedMetric(PSNR(), 1000) over sliced-psnr's 16
    updates, eager against compile_update() (K1 and K2 inside the graph);
    fused-windowed: windowed-decay's stream (1536/2048/1948 rows) through
    the ring and the decay WindowedMetric(MSE()) with buckets=(2048,), the
    pad rows corrected in the live slot through n_valid."""
    t_phase = time.perf_counter()
    batches = [psnr_batch(torch, PSNR_SEED + i) for i in range(PSNR_UPDATES)]

    def make_sliced():
        return tm.MetricCollection([SlicedMetric(tm.PeakSignalNoiseRatio(), num_slices=PSNR_TENANTS)])

    legs = fused_legs(torch, ops, "fused-sliced", make_sliced, batches, {})
    report = {leg: leg_report(torch, ops, legs[leg], update_args, batches) for leg in legs}
    check(report["fused"]["cache_size"] == 1 and not report["fused"]["eager_leg"], f"fused-sliced: {report['fused']['declined']}")
    kernels = {name: check_replay_launches("fused-sliced", legs, name, n * (len(batches) - 1)) for name, n in (
        ("segment_max_f32", 1), ("segment_min_f32", 1), ("segment_sum_f32", 1), ("segment_sum_i32", 2))}
    emit({"phase": "fused-sliced", "card": card, "updates": len(batches), "launches_by_kernel": kernels, **report,
          "seconds": time.perf_counter() - t_phase})
    del legs, batches

    t_phase = time.perf_counter()
    rng = np.random.RandomState(12)
    stream = []
    for i in range(DECAY_UPDATES):
        n = DECAY_SHAPES[i % len(DECAY_SHAPES)]
        stream.append(tuple(torch.from_numpy(rng.randint(0, 2, n).astype(np.int32)).cuda() for _ in range(2)))
    out = {"phase": "fused-windowed", "card": card, "updates": DECAY_UPDATES, "bucket": FUSED_BUCKET}
    makers = {
        "ring": lambda: tm.MetricCollection([WindowedMetric(tm.MeanSquaredError(), window=8, updates_per_bucket=4)]),
        "decay": lambda: tm.MetricCollection([WindowedMetric(tm.MeanSquaredError(), mode="decay", decay=DECAY_ALPHA)]),
    }
    for mode, make in makers.items():
        legs = fused_legs(torch, ops, f"fused-windowed {mode}", make, stream, {"buckets": (FUSED_BUCKET,)})
        handle = legs["fused"]["handle"]
        check(handle.cache_size == 1 and not handle._eager_names, f"fused-windowed {mode}: cache {handle.cache_size}, {handle.declined}")
        out[mode] = {leg: {"ms_per_update": legs[leg]["ms_per_update"], "first_update_ms": legs[leg]["first_update_ms"]} for leg in legs}
        out[mode]["captures"] = handle.n_compiles
        out[mode]["value"] = float(legs["fused"]["values"]["WindowedMetric"])
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)


def fused_retrieval_phase(torch, ops, card, MetricCollection):
    """fused-retrieval: retrieval-mslr's updates of 16,384 documents (the
    first FUSED_RETRIEVAL_UPDATES - 1 and the last, shorter one, which pads
    to the bucket: the insert masks rows past n_valid), eager against
    compile_update(buckets=(16384,)), every table bit for bit. Where the
    probe declines the insert, the phase prints the member and the reason
    and does not fail."""
    t_phase = time.perf_counter()
    tret = import_module("metrics_tpu_torch.retrieval")
    idx, preds, target = stream_on(torch, make_mslr_stream(), "cuda")
    batches = [
        (preds[lo : lo + RETRIEVAL_UPDATE_DOCS], target[lo : lo + RETRIEVAL_UPDATE_DOCS], idx[lo : lo + RETRIEVAL_UPDATE_DOCS])
        for lo in range(0, idx.shape[0], RETRIEVAL_UPDATE_DOCS)
    ]
    batches = batches[: FUSED_RETRIEVAL_UPDATES - 1] + batches[-1:]

    def update(collection, batch):
        collection.update(batch[0], batch[1], indexes=batch[2])

    def make():
        return retrieval_collection(torch, tret, MetricCollection, max_queries=RETRIEVAL_MAX_QUERIES)

    legs = fused_legs(torch, ops, "fused-retrieval", make, batches, {"buckets": (RETRIEVAL_UPDATE_DOCS,)}, update)
    handle = legs["fused"]["handle"]
    if handle._eager_names:  # the probe declined the insert: eager on both legs
        emit({"phase": "fused-retrieval", "card": card, "captured": False, "declined": dict(handle.declined),
              "seconds": time.perf_counter() - t_phase})
        return
    # one profiled update: an eager one issues about 5000 kernels
    report = {leg: leg_report(torch, ops, legs[leg], update, batches, profiled=1) for leg in legs}
    tables = len(legs["eager"]["collection"].compute_groups)
    chunks = sum(-(-batch[0].shape[0] // 2048) for batch in batches[1:])
    k4 = check_replay_launches("fused-retrieval", legs, "row_topk", tables * chunks)
    emit({"phase": "fused-retrieval", "card": card, "captured": True, "updates": len(batches), "row_topk": k4, **report,
          "seconds": time.perf_counter() - t_phase})


def async_phase(torch, ops, card, tm):
    """async: bench_async's serving loop on the fused-classification
    collection (2048-row batches from a pool of 8, seed 7): each step waits
    for a request (a sleep calibrated to about 1x the blocking update), then
    accounts the batch, blocking through compile_update() or enqueued
    through compile_update_async(queue_depth=2). Steps per second of each
    side (best of the alternating epochs); the final states bit for bit."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(7)
    pool = []
    for _ in range(ASYNC_POOL):
        p = rng.rand(ASYNC_BATCH, CLS_CLASSES).astype(np.float32)
        p /= p.sum(-1, keepdims=True)
        pool.append((torch.from_numpy(p).cuda(), torch.from_numpy(rng.randint(0, CLS_CLASSES, ASYNC_BATCH)).cuda()))
    epoch = [pool[i % len(pool)] for i in range(ASYNC_STEPS)]

    blocking = fused_collection(tm, "cuda")
    blocking.update(*pool[0])
    blocking.compile_update()
    for batch in pool[:4]:
        blocking.update(*batch)
    torch.cuda.synchronize()
    per_group = []
    for _ in range(3):
        t0 = time.perf_counter()
        for batch in pool[:4]:
            blocking.update(*batch)
        torch.cuda.synchronize()
        per_group.append((time.perf_counter() - t0) / 4)
    wait_s = min(per_group)

    asynchronous = fused_collection(tm, "cuda")
    asynchronous.update(*pool[0])
    handle = asynchronous.compile_update_async(queue_depth=2)
    # while the worker probes and captures, this thread synchronises (an
    # eager collection's value checks): the probe must not forbid it
    eager = fused_collection(tm, "cuda")
    for batch in pool[:4] * 4:  # the blocking side's warm-up and calibration
        handle.update_async(*batch)
        eager.update(*batch)
    handle.flush()
    best = {"blocking": 0.0, "async": 0.0}
    enqueue_us = []
    for _ in range(ASYNC_EPOCHS):
        t0 = time.perf_counter()
        for batch in epoch:
            time.sleep(wait_s)
            blocking.update(*batch)
        torch.cuda.synchronize()
        best["blocking"] = max(best["blocking"], ASYNC_STEPS / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for batch in epoch:
            time.sleep(wait_s)
            t_call = time.perf_counter()
            handle.update_async(*batch)
            enqueue_us.append((time.perf_counter() - t_call) * 1e6)
        handle.flush()
        torch.cuda.synchronize()
        best["async"] = max(best["async"], ASYNC_STEPS / (time.perf_counter() - t0))
    check(handle.dropped == 0, f"async: {handle.dropped} batches dropped under the block policy")
    check(handle.applied == handle.enqueued, f"async: {handle.applied} of {handle.enqueued} batches applied")
    blocking.compute()
    asynchronous.compute()
    differ = state_bits_differ(torch, collection_states(torch, blocking), collection_states(torch, asynchronous))
    check(not differ, f"async: the async side's states differ from the blocking side's in {differ}")
    kept = check_kept_values(torch, "async", handle.compute, lambda b: handle.update_async(*b), pool[:4], asynchronous)
    handle.close()
    emit({"phase": "async", "card": card, "kept_values_unchanged": kept, "steps": ASYNC_STEPS, "epochs": ASYNC_EPOCHS, "batch": ASYNC_BATCH,
          "request_wait_ms": wait_s * 1e3, "blocking_steps_per_s": best["blocking"], "async_steps_per_s": best["async"],
          "async_vs_blocking": best["async"] / best["blocking"], "dropped": handle.dropped,
          "enqueue_us_p50": float(np.percentile(enqueue_us, 50)), "enqueue_us_p99": float(np.percentile(enqueue_us, 99)),
          "seconds": time.perf_counter() - t_phase})


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
    syncs = syncs_per_update(torch, lambda b: collection.update(*b), card_batches[1:4])
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
    syncs = syncs_per_update(torch, lambda b: fresh.update(*b), batches[3:6])
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
    syncs = syncs_per_update(torch, lambda b: fresh.update(*b), batches[2:5])
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


def depth_batches(torch):
    """regression-depth's stream, made on the card from a seed: per update 8
    images of 640 x 480 depths uniform in [0.5, 10] m (an NYU-Depth v2
    test frame's size and range) and predictions = depth x a log-normal
    factor (sigma 0.1), as ``[8, 307200]`` rows."""
    gen = torch.Generator(device="cuda").manual_seed(DEPTH_SEED)
    lo, hi = DEPTH_RANGE
    out = []
    for _ in range(DEPTH_UPDATES):
        depth = lo + (hi - lo) * torch.rand((DEPTH_IMAGES,) + DEPTH_SHAPE, generator=gen, device="cuda")
        noise = torch.exp(DEPTH_NOISE * torch.randn(depth.shape, generator=gen, device="cuda"))
        out.append(((depth * noise).reshape(DEPTH_IMAGES, -1), depth.reshape(DEPTH_IMAGES, -1)))
    return out


def regression_collections(tm, device=None):
    """The regression family as a depth loop logs it: ten metrics over the
    flat pairs, and CosineSimilarity over the ``[8, 307200]`` image rows."""
    flat = tm.MetricCollection(
        [
            tm.MeanSquaredError(device=device),
            tm.MeanAbsoluteError(device=device),
            tm.MeanAbsolutePercentageError(device=device),
            tm.SymmetricMeanAbsolutePercentageError(device=device),
            tm.MeanSquaredLogError(device=device),
            tm.TweedieDevianceScore(power=1.5, device=device),
            tm.ExplainedVariance(device=device),
            tm.R2Score(device=device),
            tm.PearsonCorrCoef(device=device),
            tm.SpearmanCorrCoef(device=device),
        ]
    )
    return flat, tm.MetricCollection([tm.CosineSimilarity(device=device)])


def flat_args(collection, batch):
    collection.update(batch[0].reshape(-1), batch[1].reshape(-1))


def float64_ranks(torch, x):
    """Tie-averaged 1-based ranks of a float64 vector on the card (the
    reference's float64 rank transform, as ``scipy.stats.rankdata``)."""
    sorted_x, order = torch.sort(x, stable=True)
    _, inverse, counts = torch.unique_consecutive(sorted_x, return_inverse=True, return_counts=True)
    ends = torch.cumsum(counts, 0).to(torch.float64)
    mean_rank = ends - (counts.to(torch.float64) - 1) / 2
    return torch.empty_like(x).scatter_(0, order, mean_rank[inverse])


def float64_pearson(torch, x, y):
    x, y = x - x.mean(), y - y.mean()
    return float((x * y).sum() / torch.sqrt((x * x).sum() * (y * y).sum()))


def float64_regression(torch, preds, target):
    """The regression family over the whole stream in float64 on the card:
    ``preds``/``target`` are ``[updates, 8, 307200]``. Spearman ranks with
    ties averaged (``float64_ranks``); the script holds these formulas to
    numpy and ``scipy.stats.spearmanr`` on a prefix first."""
    rows_p, rows_t = preds.reshape(-1, preds.shape[-1]).double(), target.reshape(-1, target.shape[-1]).double()
    p, t = rows_p.reshape(-1), rows_t.reshape(-1)
    d = p - t
    eps = 1.17e-06
    dev = 2 * (torch.sqrt(t) / (-0.5 * 0.5) - t / torch.sqrt(p) / -0.5 + torch.sqrt(p) / 0.5)
    cos = (rows_p * rows_t).sum(-1) / (torch.linalg.norm(rows_p, dim=-1) * torch.linalg.norm(rows_t, dim=-1))
    out = {
        "MeanSquaredError": (d * d).mean(),
        "MeanAbsoluteError": d.abs().mean(),
        "MeanAbsolutePercentageError": (d.abs() / torch.clamp(t.abs(), min=eps)).mean(),
        "SymmetricMeanAbsolutePercentageError": (2 * d.abs() / torch.clamp(t.abs() + p.abs(), min=eps)).mean(),
        "MeanSquaredLogError": ((torch.log1p(p) - torch.log1p(t)) ** 2).mean(),
        "TweedieDevianceScore": dev.mean(),
        "ExplainedVariance": 1 - torch.var(t - p, correction=0) / torch.var(t, correction=0),
        "R2Score": 1 - (d * d).sum() / ((t - t.mean()) ** 2).sum(),
        "PearsonCorrCoef": float64_pearson(torch, p, t),
        "SpearmanCorrCoef": float64_pearson(torch, float64_ranks(torch, p), float64_ranks(torch, t)),
        "CosineSimilarity": cos.sum(),
    }
    return {k: float(v) for k, v in out.items()}


def numpy_regression(preds, target):
    """The same family in float64 numpy and scipy (host arrays, one update)."""
    from scipy.stats import spearmanr

    rows_p, rows_t = preds.reshape(-1, preds.shape[-1]).astype(np.float64), target.reshape(-1, target.shape[-1]).astype(np.float64)
    p, t = rows_p.reshape(-1), rows_t.reshape(-1)
    d = p - t
    eps = 1.17e-06
    dev = 2 * (np.sqrt(t) / (-0.5 * 0.5) - t / np.sqrt(p) / -0.5 + np.sqrt(p) / 0.5)
    cos = (rows_p * rows_t).sum(-1) / (np.linalg.norm(rows_p, axis=-1) * np.linalg.norm(rows_t, axis=-1))
    return {
        "MeanSquaredError": np.mean(d * d),
        "MeanAbsoluteError": np.mean(np.abs(d)),
        "MeanAbsolutePercentageError": np.mean(np.abs(d) / np.maximum(np.abs(t), eps)),
        "SymmetricMeanAbsolutePercentageError": np.mean(2 * np.abs(d) / np.maximum(np.abs(t) + np.abs(p), eps)),
        "MeanSquaredLogError": np.mean((np.log1p(p) - np.log1p(t)) ** 2),
        "TweedieDevianceScore": np.mean(dev),
        "ExplainedVariance": 1 - np.var(t - p) / np.var(t),
        "R2Score": 1 - np.sum(d * d) / np.sum((t - t.mean()) ** 2),
        "PearsonCorrCoef": np.corrcoef(p, t)[0, 1],
        "SpearmanCorrCoef": spearmanr(p, t)[0],
        "CosineSimilarity": cos.sum(),
    }


def path_kernel_parity(torch, ops, path, captured):
    """K3 and ``segment_sum_f32`` at one call each of a path (``captured``
    by ``capture_calls``): K3 against its plain version on the card and on
    the CPU, K1 against its plain version on the CPU (row order), bit for
    bit; returns the shapes and the largest difference."""
    rows, capacity = captured["qsketch_sort_bucket"][0]
    got = ops.qsketch_sort_bucket(rows, capacity)
    for part, a, b, c in zip(
        ("weighted rows", "bucket ids", "permutation"),
        got,
        ops.qsketch_sort_bucket_reference(rows, capacity),
        ops.qsketch_sort_bucket_reference(rows.cpu(), capacity),
    ):
        check(same_nan_by_position(torch, a, b), f"{path}: K3's {part} differ from the plain version")
        check(same_nan_by_position(torch, a, c), f"{path}: K3's {part} differ from the plain version on the CPU")
    vals, ids, s = captured["segment_sum_f32"][0]
    summed = ops.segment_sum_f32(vals, ids, s)
    plain = ops.segment_sum_reference(vals.cpu(), ids.cpu(), s)
    check(same_nan_by_position(torch, summed, plain), f"{path}: segment_sum_f32 differs from the plain version on the CPU")
    return {
        "qsketch_sort_bucket": list(rows.shape),
        "segment_sum_f32": [list(vals.shape), s],
        "max_abs_err": float((summed.cpu() - plain).abs().max()),
    }


QSKETCH_CALLS = [("metrics_tpu_torch.ops.qsketch", "qsketch_sort_bucket"), ("metrics_tpu_torch.ops.qsketch", "segment_sum_f32")]


def regression_depth_phase(torch, ops, card, tm):
    """regression-depth: the regression family over per-pixel depth, eager
    and fused, against a second card run, the CPU and float64."""
    t_phase = time.perf_counter()
    batches = depth_batches(torch)
    torch.cuda.synchronize()
    report, legs_of = {}, {}
    for label, index, update in (("flat", 0, flat_args), ("rows", 1, update_args)):
        legs = fused_legs(torch, ops, f"regression-depth ({label})", lambda: regression_collections(tm)[index], batches, {}, update=update)
        legs_of[label] = legs
        report[label] = {leg: leg_report(torch, ops, legs[leg], update, batches) for leg in legs}
        check(report[label]["fused"]["cache_size"] == 1 and not report[label]["fused"]["eager_leg"], f"regression-depth ({label}): {report[label]['fused']['declined']}")
        check(report[label]["fused"]["host_syncs_per_update"] == 0, f"regression-depth ({label}): the fused update reads the card")
    values = {**legs_of["flat"]["eager"]["values"], **legs_of["rows"]["eager"]["values"]}
    # a second card run over the same updates, kept after the CPU's prefix
    flat, rows = regression_collections(tm)
    for i, batch in enumerate(batches):
        flat_args(flat, batch)
        rows.update(*batch)
        if i + 1 == DEPTH_CPU_UPDATES:
            head = {**flat.compute(), **rows.compute()}
    for label, collection in (("flat", flat), ("rows", rows)):
        differ = state_bits_differ(torch, collection_states(torch, collection), legs_of[label]["eager"]["states"])
        check(not differ, f"regression-depth: states {differ} differ between two card runs")
    # the port on the CPU over the first updates
    flat_cpu, rows_cpu = regression_collections(tm, "cpu")
    for batch in batches[:DEPTH_CPU_UPDATES]:
        cpu_batch = (batch[0].cpu(), batch[1].cpu())
        flat_args(flat_cpu, cpu_batch)
        rows_cpu.update(*cpu_batch)
    cpu = {**flat_cpu.compute(), **rows_cpu.compute()}
    rel_cpu = {k: abs(float(head[k]) - float(cpu[k])) / max(abs(float(cpu[k])), 1e-30) for k in cpu}
    for key, diff in rel_cpu.items():
        check(diff <= 1e-5, f"regression-depth: {key} card and CPU differ by {diff} (relative)")
    # float64 over the whole stream; Spearman exact=True over all pairs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exact = tm.SpearmanCorrCoef(exact=True)
    for batch in batches:
        flat_args(exact, batch)
    spearman_exact, exact_ms = timed(torch, exact.compute)
    # the float64 formulas on the card, held to numpy and scipy over the
    # first update's first two images, then over the whole stream
    t0 = time.perf_counter()
    first = float64_regression(torch, batches[0][0][None, :2], batches[0][1][None, :2])
    host = numpy_regression(batches[0][0][:2].cpu().numpy(), batches[0][1][:2].cpu().numpy())
    ref_vs_numpy = {k: abs(first[k] - float(host[k])) for k in host}
    for key, diff in ref_vs_numpy.items():
        check(diff <= 1e-12 * max(1.0, abs(float(host[key]))), f"regression-depth: the float64 {key} differs from numpy/scipy by {diff}")
    ref = float64_regression(torch, torch.stack([b[0] for b in batches]), torch.stack([b[1] for b in batches]))
    float64_s = time.perf_counter() - t0
    scalars = {k: float(v) for k, v in values.items()}
    scalars["SpearmanCorrCoef_exact"] = float(spearman_exact)
    errors = {}
    for key, want in ref.items():
        got = scalars["SpearmanCorrCoef_exact" if key == "SpearmanCorrCoef" else key]
        errors[key] = abs(got - want)
        check(errors[key] <= 1e-6 * max(1.0, abs(want)), f"regression-depth: {key} {got} off float64 {want}")
    rho = float(ref["SpearmanCorrCoef"])
    bound = 4 * (1 - rho * rho) / math.sqrt(RANK_CAPACITY)
    errors["SpearmanCorrCoef_sketch_vs_exact"] = abs(scalars["SpearmanCorrCoef"] - scalars["SpearmanCorrCoef_exact"])
    check(errors["SpearmanCorrCoef_sketch_vs_exact"] <= bound, f"regression-depth: the sketched Spearman is {errors['SpearmanCorrCoef_sketch_vs_exact']} off exact (4 SE {bound})")
    emit(
        {
            "phase": "regression-depth",
            "card": card,
            "updates": DEPTH_UPDATES,
            "pairs_per_update": DEPTH_IMAGES * DEPTH_SHAPE[0] * DEPTH_SHAPE[1],
            "reduced": "654 NYU-Depth v2 test images cut to 128 (16 updates of 8) to save time",
            "legs": report,
            "state_bytes": {name: state_bytes(m) for c in (flat, rows) for name, m in c.items()},
            "values": scalars,
            "float64": ref,
            "float64_vs_numpy_two_images": ref_vs_numpy,
            "abs_errors_vs_float64": errors,
            "sketch_bound_4se": bound,
            "rel_diff_card_cpu": rel_cpu,
            "cpu_updates": DEPTH_CPU_UPDATES,
            "exact_spearman_compute_ms": exact_ms,
            "float64_reference_s": float64_s,
            "seconds": time.perf_counter() - t_phase,
        }
    )
    return batches


def sketch_bf16_phase(torch, ops, card, tm):
    """sketch-bf16: AUROC() over curve-binary's stream after
    set_dtype(torch.bfloat16), eager and fused; half-precision rows compact
    widened to float32 through K3 and K1 and round back once."""
    t_phase = time.perf_counter()
    score_np, y_np = make_curve_stream()
    score, y = torch.from_numpy(score_np).cuda(), torch.from_numpy(y_np).cuda()
    batches = [(score[i], y[i]) for i in range(CURVE_BATCHES)]

    def make(device=None):
        collection = tm.MetricCollection([tm.AUROC(device=device)])
        return collection.set_dtype(torch.bfloat16)

    legs = fused_legs(torch, ops, "sketch-bf16", make, batches, {})
    report = {leg: leg_report(torch, ops, legs[leg], update_args, batches) for leg in legs}
    check(report["fused"]["cache_size"] == 1 and not report["fused"]["eager_leg"], f"sketch-bf16: {report['fused']['declined']}")
    check(legs["eager"]["collection"]["AUROC"].csketch.dtype == torch.bfloat16, "sketch-bf16: the sketch is not bfloat16")
    # the first two batches fill the lossless window; each later one compacts once
    compactions = CURVE_BATCHES - CURVE_WINDOW_BATCHES
    k3 = check_replay_launches("sketch-bf16", legs, "qsketch_sort_bucket", compactions)
    k1 = check_replay_launches("sketch-bf16", legs, "segment_sum_f32", compactions)
    # the card against the CPU over curve-binary's first 16 batches, bit for bit
    head = batches[:CURVE_CPU_BATCHES]
    card_run, cpu_run = make(), make("cpu")
    for i, (preds, target) in enumerate(head):
        if i == CURVE_CPU_BATCHES // 2:
            captured = capture_calls(QSKETCH_CALLS, lambda: card_run.update(preds, target))
        else:
            card_run.update(preds, target)
        cpu_run.update(preds.cpu(), target.cpu())
    differ = state_bits_differ(torch, collection_states(torch, card_run), collection_states(torch, cpu_run))
    check(not differ, f"sketch-bf16: states {differ} differ between the card and the CPU")
    check(same_outputs(torch, card_run.compute()["AUROC"], cpu_run.compute()["AUROC"]), "sketch-bf16: the value differs between the card and the CPU")
    parity = path_kernel_parity(torch, ops, "sketch-bf16", captured)
    # the float32 run over the whole stream
    f32 = tm.AUROC()
    for batch in batches:
        f32.update(*batch)
    value, value_f32 = float(legs["eager"]["values"]["AUROC"]), float(f32.compute())
    check(abs(value - value_f32) <= BF16_SKETCH_BOUND, f"sketch-bf16: {value} is {abs(value - value_f32)} off the float32 run's {value_f32}")
    weight = float(legs["eager"]["states"]["AUROC.csketch"][:, 0].float().sum())
    emit({"phase": "sketch-bf16", "card": card, "updates": len(batches), "compactions": compactions,
          "qsketch_sort_bucket": k3, "segment_sum_f32": k1, "kernel_parity": parity, **report,
          "value": value, "value_float32": value_f32, "diff_vs_float32": value - value_f32, "bound": BF16_SKETCH_BOUND,
          "total_weight": weight, "rows": CURVE_BATCHES * CURVE_BATCH,
          "state_bytes": state_bytes(legs["eager"]["collection"]["AUROC"]), "seconds": time.perf_counter() - t_phase})


def windowed_sketch_phase(torch, ops, card, tm, WindowedMetric, depth):
    """windowed-sketch: the ring of sketch leaves. WindowedMetric(AUROC)
    at window 2 and 8 over curve-binary's stream, and
    WindowedMetric(SpearmanCorrCoef(), window=8) over regression-depth's
    last 8 updates; reads fold the window's sketches oldest first with the
    sketch's own merge (K3 and K1 on the card)."""
    t_phase = time.perf_counter()
    score_np, y_np = make_curve_stream()
    score, y = torch.from_numpy(score_np).cuda(), torch.from_numpy(y_np).cuda()
    batches = [(score[i], y[i]) for i in range(CURVE_BATCHES)]
    rings = {w: WindowedMetric(tm.AUROC(pos_label=1), window=w) for w in (2, 8)}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for batch in batches:
        for ring in rings.values():
            ring.update(*batch)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    update_launches = ops.launch_counts()
    check(not update_launches.get("qsketch_sort_bucket"), f"windowed-sketch: a bucket compacted while its batch fit ({update_launches})")
    reads, values = {}, {}
    for w, ring in rings.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        captured = capture_calls(QSKETCH_CALLS, lambda: values.__setitem__(w, ring.compute()))
        torch.cuda.synchronize()
        reads[w] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": ops.launch_counts()}
        # one compaction per merge of the fold: w - 1
        for name in ("qsketch_sort_bucket", "segment_sum_f32"):
            check(reads[w]["launches"].get(name) == w - 1, f"windowed-sketch: the window-{w} read launched {name} {reads[w]['launches'].get(name)} times")
        reads[w]["kernel_parity"] = path_kernel_parity(torch, ops, f"windowed-sketch (window {w})", captured)
    fresh = tm.AUROC(pos_label=1)
    for batch in batches[-2:]:
        fresh.update(*batch)
    check(same_outputs(torch, values[2], fresh.compute()), "windowed-sketch: the window-2 read differs from a fresh AUROC")
    exact8 = midrank_auroc(score_np[-8:].reshape(-1), y_np[-8:].reshape(-1))
    err8 = abs(float(values[8]) - exact8)
    check(err8 <= 5e-3, f"windowed-sketch: the window-8 AUROC is {err8} off exact")
    # the ring of reservoirs: Spearman over the last 8 depth updates
    spearman = WindowedMetric(tm.SpearmanCorrCoef(), window=8)
    tail = depth[-8:]
    for batch in tail:
        flat_args(spearman, batch)
    rho_sketch, spearman_read_ms = timed(torch, spearman.compute)
    rho = float(import_module("metrics_tpu_torch.functional").spearman_corrcoef(torch.cat([b[0].reshape(-1) for b in tail]), torch.cat([b[1].reshape(-1) for b in tail])))
    se = (1 - rho * rho) / math.sqrt(RANK_CAPACITY)
    check(abs(float(rho_sketch) - rho) <= 4 * se, f"windowed-sketch: the windowed Spearman {float(rho_sketch)} is more than 4 SE off exact {rho}")
    emit({"phase": "windowed-sketch", "card": card, "updates": len(batches), "update_ms": update_ms,
          "update_launches": update_launches, "reads": {str(w): r for w, r in reads.items()},
          "values": {str(w): float(v) for w, v in values.items()}, "auroc_window8_exact": exact8, "auroc_window8_abs_err": err8,
          "spearman_window8": float(rho_sketch), "spearman_window8_exact": rho, "spearman_abs_err": abs(float(rho_sketch) - rho),
          "spearman_standard_error": se, "spearman_read_ms": spearman_read_ms,
          "state_bytes": {str(w): state_bytes(r) for w, r in rings.items()} | {"spearman": state_bytes(spearman)},
          "seconds": time.perf_counter() - t_phase})


def tree_states(torch, metrics):
    """Every state of every metric and of its children (``state_dict``: list
    states concatenated, ``MinMaxMetric``'s extremes too), on the host."""
    out = {}
    for key, metric in metrics.items():
        for name, value in metric.state_dict().items():
            out[f"{key}.{name}"] = (torch.cat(value) if isinstance(value, list) else value).detach().cpu()
    return out


def profiled_updates(torch, ops, label, make, step, profiled=3):
    """Device ms per update and the profiler-seen launches over ``profiled``
    updates of fresh objects (``make()``, ``step(objects, i)``), held equal
    to the launch counters (a window that missed is taken again), then host
    syncs per update over three more."""
    for windows in range(1, PROFILE_WINDOWS + 1):
        objects = make()
        ops.reset_launch_counts()
        profile = device_profile(torch, lambda i: step(objects, i), profiled, host_ops=False)
        counted = {k: n for k, n in ops.launch_counts().items() if n}
        seen = device_launches(profile["kernel_calls"])
        if seen == counted:
            break
    check(seen == counted, f"{label}: the device ran {seen} launches in {windows} profiled windows, the counters say {counted}")
    objects = make()
    return {
        "device_ms_per_update": profile["device_busy_ms_per_step"],
        "profiled_wall_ms_per_update": profile["profiled_wall_ms_per_step"],
        "device_launches_profiled": seen,
        "profiled_windows": windows,
        "top_device_us": profile["device_us_per_step_by_kernel"],
        "host_syncs_per_update": syncs_per_update(torch, lambda i: step(objects, i), list(range(3))),
    }


def syncs_inside(torch, obj, attr, run):
    """Host synchronisations inside the calls of ``obj.attr`` while
    ``run()`` runs (``set_sync_debug_mode("warn")`` only around them)."""
    inner = getattr(obj, attr)
    caught = []

    def watched(*args, **kwargs):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return inner(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                caught.extend(seen)

    setattr(obj, attr, watched)
    try:
        run()
    finally:
        delattr(obj, attr)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def flagship_loss(torch, preds, target):
    """The per-sample negative log-likelihood of a softmax batch."""
    return -torch.log(preds.gather(1, target[:, None]).squeeze(1))


def wrappers_flagship_objects(tm, device=None):
    """wrappers-flagship's tracker over the training-loop collection, and
    the three wrappers beside it."""
    collection = tm.MetricCollection(
        {
            "loss": tm.MeanMetric(device=device),
            "loss_max": tm.MaxMetric(device=device),
            "acc": tm.Accuracy(num_classes=NUM_CLASSES, device=device),
            "err": 1 - tm.Accuracy(num_classes=NUM_CLASSES, device=device),
        }
    )
    wrappers = {
        "bootstrap": tm.BootStrapper(
            tm.CohenKappa(num_classes=NUM_CLASSES, device=device),
            num_bootstraps=WRAP_BOOTSTRAPS,
            sampling_strategy="multinomial",
            seed=0,
        ),
        "classwise": tm.ClasswiseWrapper(tm.JaccardIndex(num_classes=NUM_CLASSES, reduction="none", device=device)),
        "minmax": tm.MinMaxMetric(tm.Accuracy(num_classes=NUM_CLASSES, device=device)),
    }
    return tm.MetricTracker(collection), wrappers


def wrappers_flagship_step(objects, batch, i):
    """One training-loop step: a tracker increment every WRAP_STEP_BATCHES
    batches, the collection's update, each wrapper's forward."""
    tracker, wrappers = objects
    preds, target, loss = batch
    if i % WRAP_STEP_BATCHES == 0:
        tracker.increment()
    tracker.update(value=loss, preds=preds, target=target)
    return {name: w(preds, target) for name, w in wrappers.items()}


def wrappers_flagship_phase(torch, ops, card, tm, preds_all, target_all):
    """wrappers-flagship: a training loop's MetricTracker over a collection
    with aggregators and a composition, and BootStrapper, ClasswiseWrapper
    and MinMaxMetric through forward, over 12 flagship batches; then the
    collection once more through compile_update()."""
    t_phase = time.perf_counter()
    batches = [(preds_all[i], target_all[i], flagship_loss(torch, preds_all[i], target_all[i])) for i in range(WRAP_BATCHES)]
    torch.cuda.synchronize()

    def run(device=None, n=WRAP_BATCHES, snapshot_at=None):
        objects = wrappers_flagship_objects(tm, device)
        snap = None
        for i in range(n):
            batch = batches[i] if device is None else tuple(t.cpu() for t in batches[i])
            wrappers_flagship_step(objects, batch, i)
            if snapshot_at == i + 1:
                snap = tree_states(torch, objects[1])
        return objects, snap

    objects = wrappers_flagship_objects(tm)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        wrappers_flagship_step(objects, batch, i)
        if i + 1 == WRAP_STEP_BATCHES:
            torch.cuda.synchronize()
            first_states = tree_states(torch, objects[1])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    marks = {"card_run": time.perf_counter()}
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    tracker, wrappers = objects
    # per batch: each forward updates twice; BootStrapper's copies and the
    # Jaccard each launch bincount_i32 once per update
    want = {"bincount_i32": WRAP_BATCHES * 2 * (WRAP_BOOTSTRAPS + 1)}
    check(launches == want, f"wrappers-flagship: launches {launches}, expected {want}")
    values = {name: w.compute() for name, w in wrappers.items()}
    steps = tracker.compute_all()
    best = tracker.best_metric(return_step=True)
    # a second card run, every state and value bit for bit
    again, _ = run()
    marks["second_card_run"] = time.perf_counter()
    differ = state_bits_differ(torch, tree_states(torch, again[1]), tree_states(torch, wrappers))
    check(not differ, f"wrappers-flagship: states {differ} differ between two card runs")
    for name, w in again[1].items():
        check(same_outputs(torch, list(w.compute().values()), list(values[name].values())), f"wrappers-flagship: {name} differs between two card runs")
    again_steps = again[0].compute_all()
    check(all(same_outputs(torch, again_steps[k], steps[k]) for k in steps), "wrappers-flagship: the tracker differs between two card runs")
    # the port on the CPU: the wrappers over the first step, the tracker over all
    cpu, _ = run("cpu", n=WRAP_STEP_BATCHES)
    differ = state_bits_differ(torch, tree_states(torch, cpu[1]), first_states)
    check(not differ, f"wrappers-flagship: states {differ} differ from the CPU's")
    cpu_tracker = tm.MetricTracker(wrappers_flagship_objects(tm, "cpu")[0]._base_metric)
    for i, (p, t, l) in enumerate(batches):
        if i % WRAP_STEP_BATCHES == 0:
            cpu_tracker.increment()
        cpu_tracker.update(value=l.cpu(), preds=p.cpu(), target=t.cpu())
    cpu_steps = cpu_tracker.compute_all()
    check(all(same_outputs(torch, steps[k].cpu(), cpu_steps[k]) for k in steps), "wrappers-flagship: the tracker's values differ from the CPU's")
    check(best == cpu_tracker.best_metric(return_step=True), f"wrappers-flagship: best_metric {best} differs from the CPU's")
    # the first step's wrapper values against the CPU's (each copy's kappa
    # sums floats in the device's order)
    first, _ = run(n=WRAP_STEP_BATCHES)
    diff_cpu = {}
    for name in wrappers:
        got, want_cpu = first[1][name].compute(), cpu[1][name].compute()
        rtol, atol = cls_tolerance("CohenKappa" if name == "bootstrap" else name)
        for key in want_cpu:
            diff = float((got[key].cpu().double() - want_cpu[key].double()).abs().max())
            check(diff <= atol + rtol * float(want_cpu[key].double().abs().max()), f"wrappers-flagship: {name} {key} off the CPU by {diff}")
            diff_cpu[name] = max(diff_cpu.get(name, 0.0), diff)
    marks["cpu_and_second_runs"] = time.perf_counter()

    profile = profiled_updates(
        torch, ops, "wrappers-flagship", lambda: wrappers_flagship_objects(tm), lambda o, i: wrappers_flagship_step(o, batches[i], i)
    )
    marks["profile"] = time.perf_counter()

    # the collection fused: the composition declined by name, the others'
    # states bit-equal to the eager leg, no host sync inside the replays
    def make_collection():
        return wrappers_flagship_objects(tm)[0]._base_metric

    def update(collection, batch):
        collection.update(value=batch[2], preds=batch[0], target=batch[1])

    legs = fused_legs(torch, ops, "wrappers-flagship (fused)", make_collection, batches, {}, update=update)
    fused = legs["fused"]
    check(set(fused["handle"].declined) == {"err"}, f"wrappers-flagship: declined {fused['handle'].declined}")
    replay_syncs = syncs_inside(torch, fused["handle"], "_run_fused", lambda: [update(fused["collection"], b) for b in batches[3:6]])
    check(replay_syncs == 0, f"wrappers-flagship: {replay_syncs} host syncs inside three replays")
    report = {leg: leg_report(torch, ops, legs[leg], update, batches) for leg in legs}
    marks["fused"] = time.perf_counter()
    emit(
        {
            "phase": "wrappers-flagship",
            "card": card,
            "batches": WRAP_BATCHES,
            "ms_per_update": run_s / WRAP_BATCHES * 1e3,
            **profile,
            "device_idle_share": 1 - profile["device_ms_per_update"] / (run_s / WRAP_BATCHES * 1e3),
            "launches": launches,
            "launches_expected": want,
            "best_metric": best,
            "tracker_values": {k: v.tolist() for k, v in steps.items()},
            "bootstrap": {k: v.tolist() for k, v in values["bootstrap"].items()},
            "minmax": {k: float(v) for k, v in values["minmax"].items()},
            "max_abs_diff_vs_cpu_first_step": diff_cpu,
            "seconds_by_part": {k: v - t_phase for k, v in marks.items()},
            "tracker_state_bytes": tracker.total_state_bytes(),
            "wrapper_state_bytes": {name: w.total_state_bytes() for name, w in wrappers.items()},
            "fused": {leg: {k: v for k, v in r.items() if k != "top_device_us"} for leg, r in report.items()},
            "fused_replay_host_syncs": replay_syncs,
            "seconds": time.perf_counter() - t_phase,
        }
    )


def float64_auroc(torch, scores, labels):
    """AUROC from float64 midranks on the card (ties share their mean rank)."""
    values, inverse, counts = torch.unique(scores, return_inverse=True, return_counts=True)
    before = torch.cumsum(counts, 0) - counts
    ranks = (before.double() + (counts.double() + 1) / 2)[inverse]
    pos = labels.bool()
    n_pos = pos.sum().double()
    n_neg = labels.numel() - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def bootstrap_auroc_phase(torch, ops, card, tm):
    """bootstrap-auroc: BootStrapper(AUROC(), 50) over the first 24 batches
    of curve-binary's stream: every copy passes the sketch's capacity."""
    from metrics_tpu_torch.wrappers.bootstrapping import _bootstrap_sampler

    t_phase = time.perf_counter()
    score_np, y_np = make_curve_stream()
    score = torch.from_numpy(score_np[:BOOT_BATCHES]).cuda()
    y = torch.from_numpy(y_np[:BOOT_BATCHES]).cuda()
    # the draws, replayed from the seed: each copy compacts on every update
    # from the one whose rows pass the capacity on
    rng = np.random.RandomState(0)
    draws = [[_bootstrap_sampler(CURVE_BATCH, "poisson", rng) for _ in range(BOOT_COPIES)] for _ in range(BOOT_BATCHES)]
    rows = np.cumsum([[len(d) for d in update] for update in draws], axis=0)
    compactions = int((rows > SKETCH_CAPACITY).sum())
    check((rows[-1] > SKETCH_CAPACITY).all(), "bootstrap-auroc: a copy stays inside the lossless window")
    want = {"qsketch_sort_bucket": compactions, "segment_sum_f32": compactions}

    def make(device=None):
        return tm.BootStrapper(tm.AUROC(device=device), num_bootstraps=BOOT_COPIES, seed=0)

    metric = make()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(BOOT_BATCHES):
        metric.update(score[i], y[i])
        if i + 1 == BOOT_CPU_UPDATES:
            torch.cuda.synchronize()
            head = tree_states(torch, {"b": metric})
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    check(launches == want, f"bootstrap-auroc: launches {launches}, expected {want}")
    out, compute_ms = timed(torch, metric.compute)
    fill = {name: max(m.sketch_fill_ratios().values()) for name, m in metric._iter_child_metrics()}
    # the CPU over the first updates, bit for bit
    cpu = make("cpu")
    for i in range(BOOT_CPU_UPDATES):
        cpu.update(torch.from_numpy(score_np[i]), torch.from_numpy(y_np[i]))
    differ = state_bits_differ(torch, tree_states(torch, {"b": cpu}), head)
    check(not differ, f"bootstrap-auroc: states {differ} differ from the CPU's")
    # the exact AUROC of each copy's resampled stream, float64 on the card
    flat_score, flat_y = score.reshape(-1), y.reshape(-1)
    exact = []
    for c in range(BOOT_COPIES):
        idx = torch.from_numpy(np.concatenate([u * CURVE_BATCH + draws[u][c] for u in range(BOOT_BATCHES)])).cuda()
        exact.append(float64_auroc(torch, flat_score[idx], flat_y[idx]))
    exact = np.asarray(exact)
    errors = {
        "mean": abs(float(out["mean"]) - exact.mean()),
        "std": abs(float(out["std"]) - exact.std(ddof=1)),
    }
    for key, err in errors.items():
        check(err <= 5e-3, f"bootstrap-auroc: {key} {err} off the exact bootstrap's")
    def past_capacity():
        # a fresh bootstrap fed three batches: every copy compacts from then on
        m = make()
        for i in range(3):
            m.update(score[i], y[i])
        return m

    profile = profiled_updates(torch, ops, "bootstrap-auroc", past_capacity, lambda m, i: m.update(score[3 + i], y[3 + i]))
    emit(
        {
            "phase": "bootstrap-auroc",
            "card": card,
            "updates": BOOT_BATCHES,
            "copies": BOOT_COPIES,
            "rows_per_copy": rows[-1].tolist()[:5],
            "ms_per_update": run_s / BOOT_BATCHES * 1e3,
            **profile,
            "device_idle_share": 1 - profile["device_ms_per_update"] / (run_s / BOOT_BATCHES * 1e3),
            "launches": launches,
            "launches_expected": want,
            "compute_ms": compute_ms,
            "mean": float(out["mean"]),
            "std": float(out["std"]),
            "exact_mean": float(exact.mean()),
            "exact_std": float(exact.std(ddof=1)),
            "abs_errors_vs_exact_bootstrap": errors,
            "state_bytes": metric.total_state_bytes(),
            "sketch_fill_min_max": [min(fill.values()), max(fill.values())],
            "cpu_updates": BOOT_CPU_UPDATES,
            "seconds": time.perf_counter() - t_phase,
        }
    )


def normal_batches(torch):
    """multioutput-regression's stream, made on the card from a seed: per
    update 8 maps of 640 x 480 unit surface normals (``[2457600, 3]``), the
    predictions the targets plus 0.1 N(0, 1) renormalised; 10% of the rows
    hold a NaN in one output of the target (invalid pixels)."""
    gen = torch.Generator(device="cuda").manual_seed(NORMAL_SEED)
    rows = DEPTH_IMAGES * DEPTH_SHAPE[0] * DEPTH_SHAPE[1]
    out = []
    for _ in range(DEPTH_UPDATES):
        target = torch.nn.functional.normalize(torch.randn(rows, 3, generator=gen, device="cuda"), dim=1)
        preds = torch.nn.functional.normalize(target + NORMAL_NOISE * torch.randn(rows, 3, generator=gen, device="cuda"), dim=1)
        invalid = torch.rand(rows, generator=gen, device="cuda") < NORMAL_INVALID
        output = torch.randint(0, 3, (rows,), generator=gen, device="cuda")
        nan = invalid[:, None] & (torch.arange(3, device="cuda")[None, :] == output[:, None])
        out.append((preds, torch.where(nan, float("nan"), target)))
    return out


def float64_multioutput(torch, batches):
    """R2 and MAE per output over every update, NaN rows dropped, float64."""
    preds = torch.cat([b[0] for b in batches]).double()
    target = torch.cat([b[1] for b in batches]).double()
    out = {"R2Score": [], "MeanAbsoluteError": []}
    for k in range(3):
        keep = ~(torch.isnan(preds[:, k]) | torch.isnan(target[:, k]))
        p, t = preds[keep, k], target[keep, k]
        out["R2Score"].append(float(1 - ((t - p) ** 2).sum() / ((t - t.mean()) ** 2).sum()))
        out["MeanAbsoluteError"].append(float((p - t).abs().mean()))
    return out


def multioutput_regression_phase(torch, ops, card, tm):
    """multioutput-regression: MultioutputWrapper(R2Score(), 3) and
    MultioutputWrapper(MeanAbsoluteError(), 3) over 16 updates of surface
    normals at NYU-Depth v2's frame size, invalid pixels removed."""
    t_phase = time.perf_counter()
    batches = normal_batches(torch)
    torch.cuda.synchronize()

    def make(device=None):
        return {
            "R2Score": tm.MultioutputWrapper(tm.R2Score(device=device), 3),
            "MeanAbsoluteError": tm.MultioutputWrapper(tm.MeanAbsoluteError(device=device), 3),
        }

    def step(wrappers, batch):
        for w in wrappers.values():
            w.update(*batch)

    wrappers = make()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for batch in batches:
        step(wrappers, batch)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    check(not launches, f"multioutput-regression: launches {launches}, expected none")
    values = {name: [float(v) for v in w.compute()] for name, w in wrappers.items()}
    # a second card run, read after the CPU's updates too
    again = make()
    for i, batch in enumerate(batches):
        step(again, batch)
        if i + 1 == DEPTH_CPU_UPDATES:
            head = {name: [float(v) for v in w.compute()] for name, w in again.items()}
    differ = state_bits_differ(torch, tree_states(torch, again), tree_states(torch, wrappers))
    check(not differ, f"multioutput-regression: states {differ} differ between two card runs")
    cpu = make("cpu")
    for batch in batches[:DEPTH_CPU_UPDATES]:
        step(cpu, tuple(t.cpu() for t in batch))
    rel_cpu = {}
    for name, w in cpu.items():
        for k, v in enumerate(w.compute()):
            diff = abs(head[name][k] - float(v)) / max(abs(float(v)), 1e-30)
            check(diff <= 1e-5, f"multioutput-regression: {name}[{k}] card and CPU differ by {diff} (relative)")
            rel_cpu[f"{name}[{k}]"] = diff
    ref = float64_multioutput(torch, batches)
    errors = {}
    for name, want in ref.items():
        for k, w64 in enumerate(want):
            errors[f"{name}[{k}]"] = abs(values[name][k] - w64)
            check(errors[f"{name}[{k}]"] <= 1e-6 * max(1.0, abs(w64)), f"multioutput-regression: {name}[{k}] {values[name][k]} off float64 {w64}")
    profile = profiled_updates(torch, ops, "multioutput-regression", make, lambda w, i: step(w, batches[i]))
    emit(
        {
            "phase": "multioutput-regression",
            "card": card,
            "updates": DEPTH_UPDATES,
            "rows_per_update": batches[0][0].shape[0],
            "reduced": "654 NYU-Depth v2 test frames cut to 128 (16 updates of 8), as regression-depth",
            "ms_per_update": run_s / DEPTH_UPDATES * 1e3,
            **profile,
            "device_idle_share": 1 - profile["device_ms_per_update"] / (run_s / DEPTH_UPDATES * 1e3),
            "values": values,
            "float64": ref,
            "abs_errors_vs_float64": errors,
            "rel_diff_card_cpu": rel_cpu,
            "cpu_updates": DEPTH_CPU_UPDATES,
            "state_bytes": {name: w.total_state_bytes() for name, w in wrappers.items()},
            "seconds": time.perf_counter() - t_phase,
        }
    )


def float64_pairwise(torch, name, x, y, zero_diagonal):
    x, y = x.double(), y.double()
    if name == "pairwise_cosine_similarity":
        out = (x / x.norm(dim=1, keepdim=True)) @ (y / y.norm(dim=1, keepdim=True)).T
    elif name == "pairwise_linear_similarity":
        out = x @ y.T
    elif name == "pairwise_euclidean_distance":
        out = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2 * x @ y.T).clamp(min=0).sqrt()
    else:
        out = torch.cat([(x[i : i + 64, None, :] - y[None]).abs().sum(-1) for i in range(0, x.shape[0], 64)])
    if zero_diagonal:
        n = min(out.shape)
        out[torch.arange(n), torch.arange(n)] = 0
    return out


def pairwise_embeddings_phase(torch, ops, card, tm):
    """pairwise-embeddings: the pairwise functionals over CLIP ViT-B/32-width
    embeddings, against float64 on the card, with and without TF32."""
    from metrics_tpu_torch.functional import pairwise

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(PAIRWISE_SEED)
    x = torch.randn(PAIRWISE_ROWS, PAIRWISE_DIM, generator=gen, device="cuda")
    y = torch.randn(PAIRWISE_ROWS, PAIRWISE_DIM, generator=gen, device="cuda")
    cases = [
        (name, reduction, two)
        for name in ("pairwise_cosine_similarity", "pairwise_linear_similarity", "pairwise_euclidean_distance")
        for reduction in (None, "mean")
        for two in (False, True)
    ] + [("pairwise_manhattan_distance", reduction, two) for reduction in (None, "mean") for two in (False, True)]
    flag, precision = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    results = []
    ops.reset_launch_counts()
    for name, reduction, two in cases:
        rows = PAIRWISE_L1_ROWS if name == "pairwise_manhattan_distance" else PAIRWISE_ROWS
        a, b = x[:rows], (y[:rows] if two else None)
        fn = getattr(pairwise, name)

        def call():
            return fn(a, b, reduction=reduction)

        got, ms = timed(torch, call)
        syncs = syncs_per_update(torch, lambda _: call(), [0])
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
            tf32 = call()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag
            torch.set_float32_matmul_precision(precision)
        check(torch.equal(got.view(torch.int32), tf32.view(torch.int32)), f"pairwise-embeddings: {name} {reduction} differs under TF32")
        ref = float64_pairwise(torch, name, a, a if b is None else b, zero_diagonal=b is None)
        if reduction == "mean":
            ref = ref.mean(dim=-1)
        err = float((got.double() - ref).abs().max())
        scale = float(ref.abs().max())
        check(err <= PAIRWISE_RTOL * scale, f"pairwise-embeddings: {name} {reduction} {err} off float64 (scale {scale})")
        check(syncs == 0, f"pairwise-embeddings: {name} {reduction} synchronised {syncs} times")
        results.append(
            {"name": name, "reduction": reduction, "inputs": 2 if two else 1, "rows": rows, "ms": ms, "max_abs_err": err, "scale": scale, "host_syncs": syncs}
        )
        del got, tf32, ref
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    check(not launches, f"pairwise-embeddings: launches {launches}, expected none")
    profile = profiled_updates(
        torch, ops, "pairwise-embeddings", lambda: None, lambda _, i: pairwise.pairwise_cosine_similarity(x, y), profiled=3
    )
    emit(
        {
            "phase": "pairwise-embeddings",
            "card": card,
            "shape": [PAIRWISE_ROWS, PAIRWISE_DIM],
            "manhattan_rows": PAIRWISE_L1_ROWS,
            "rtol_of_max": PAIRWISE_RTOL,
            "cases": results,
            "cosine_two_inputs": {k: v for k, v in profile.items() if k != "top_device_us"},
            "top_device_us_cosine": profile["top_device_us"],
            "seconds": time.perf_counter() - t_phase,
        }
    )


# ---------------------------------------------------------------------------
# the image family: SSIM / MS-SSIM / UQI, FID / KID / IS, LPIPS
# ---------------------------------------------------------------------------


def free_card(torch):
    """Release what earlier phases left: a fused handle and its collection
    reference each other, so their graphs' memory pools wait for the
    cyclic collector; then hand the cached blocks back. Returns the bytes
    still allocated (the phase's starting point for its peak)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def ssim_images(torch):
    """BASELINE config 5's pairs, made on the card: targets uniform in
    [0, 1], predictions the targets plus N(0, SSIM_NOISE) clipped."""
    gen = torch.Generator(device=IMAGE_DEVICE).manual_seed(SSIM_SEED)
    shape = (SSIM_IMAGES,) + SSIM_SHAPE
    target = torch.rand(shape, generator=gen, device=IMAGE_DEVICE)
    preds = (target + SSIM_NOISE * torch.randn(shape, generator=gen, device=IMAGE_DEVICE)).clamp_(0.0, 1.0)
    return preds, target


def ssim_phase(torch, ops, card, tm):
    """ssim: SSIM, MS-SSIM and UQI modular over 4 updates of 16 of config 5,
    then compute(); the functionals over all 64 and image_gradients; against
    the port on the CPU and a float64 evaluation on the CPU."""
    from metrics_tpu_torch import functional as tmf

    t_phase = time.perf_counter()
    base = free_card(torch)
    preds, target = ssim_images(torch)
    per = SSIM_IMAGES // SSIM_UPDATES
    batches = [(preds[i * per : (i + 1) * per], target[i * per : (i + 1) * per]) for i in range(SSIM_UPDATES)]
    metrics = {
        "SSIM": (tm.StructuralSimilarityIndexMeasure, tmf.structural_similarity_index_measure),
        "MS-SSIM": (tm.MultiScaleStructuralSimilarityIndexMeasure, tmf.multiscale_structural_similarity_index_measure),
        "UQI": (tm.UniversalImageQualityIndex, tmf.universal_image_quality_index),
    }
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    report, values = {}, {}
    for name, (make, functional) in metrics.items():
        probe = make()
        syncs = syncs_per_update(torch, lambda b: probe.update(*b), batches[:3])
        metric = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            metric.update(*batch)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        value, cold_ms = timed(torch, metric.compute)
        warm_ms = median_ms(torch, metric._compute)
        profile = device_profile(torch, lambda i: metric._compute(), 1, host_ops=False)
        whole = functional(preds, target)
        check(torch.equal(whole, value), f"ssim: the {name} functional over all {SSIM_IMAGES} images differs from the metric's compute()")
        values[name] = value
        report[name] = {
            "value": float(value),
            "images_per_s": SSIM_IMAGES / (update_s + warm_ms / 1e3),
            "update_ms": update_s / SSIM_UPDATES * 1e3,
            "cold_compute_ms": cold_ms,
            "warm_compute_ms": warm_ms,
            "compute_device_ms": profile["device_busy_ms_per_step"],
            "compute_idle_share": 1 - profile["device_busy_ms_per_step"] / warm_ms,
            "top_device_us": profile["device_us_per_step_by_kernel"],
            "host_syncs_per_update": syncs,
            "state_bytes": state_bytes(metric),
        }
        check(syncs == 0, f"ssim: a {name} update synchronised {syncs} times")
    gradients = tmf.image_gradients(preds)
    gradients_ms = median_ms(torch, lambda: tmf.image_gradients(preds))
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    check(not launches, f"ssim: launches {launches}, expected none (no kernel of ours on this path)")
    peak = torch.cuda.max_memory_allocated()
    # the same port code on the CPU, and a float64 evaluation there
    t0 = time.perf_counter()
    preds_cpu, target_cpu = preds.cpu(), target.cpu()
    cpu_grad = tmf.image_gradients(preds_cpu)
    for got, want in zip(gradients, cpu_grad):
        check(torch.equal(got.cpu(), want), "ssim: image_gradients differ between the card and the CPU")
    rel_cpu, rel_f64, float64 = {}, {}, {}
    for name, (make, functional) in metrics.items():
        cpu_metric = make(device="cpu")
        for lo in range(0, SSIM_IMAGES, per):
            cpu_metric.update(preds_cpu[lo : lo + per], target_cpu[lo : lo + per])
        cpu_value = float(cpu_metric.compute())
        float64[name] = float(functional(preds_cpu.double(), target_cpu.double()))
        rel_cpu[name] = abs(float(values[name]) - cpu_value) / abs(cpu_value)
        rel_f64[name] = abs(float(values[name]) - float64[name]) / abs(float64[name])
        check(rel_cpu[name] <= SSIM_RTOL, f"ssim: {name} card and CPU differ by {rel_cpu[name]} (relative)")
        check(rel_f64[name] <= SSIM_RTOL, f"ssim: {name} {float(values[name])} off float64 {float64[name]} by {rel_f64[name]}")
    cpu_s = time.perf_counter() - t0
    # integer images are refused on the card before anything is computed
    refused = {}
    as_int = (preds * 255).to(torch.uint8), (target * 255).to(torch.uint8)
    for name, (make, functional) in metrics.items():
        for how, call in (("functional", lambda: functional(*as_int)), ("update", lambda: make().update(*as_int))):
            try:
                call()
            except TypeError as err:
                refused[f"{name} {how}"] = str(err)[:60]
            else:
                check(False, f"ssim: the {name} {how} accepted uint8 images")
    emit(
        {
            "phase": "ssim",
            "integer_images_refused": refused,
            "card": card,
            "images": SSIM_IMAGES,
            "shape": list(SSIM_SHAPE),
            "updates": SSIM_UPDATES,
            "metrics": report,
            "image_gradients_ms": gradients_ms,
            "peak_memory_bytes": peak,
            "memory_at_start_bytes": base,
            "float64_cpu": float64,
            "rel_diff_card_cpu": rel_cpu,
            "rel_diff_card_float64": rel_f64,
            "cpu_reference_s": cpu_s,
            "seconds": time.perf_counter() - t_phase,
        }
    )


def fid_images(torch, gen, real, n):
    """``n`` uint8 images of one generator: random colour fields upsampled
    bilinearly to 299 x 299, plus pixel noise."""
    cells, low, high = FID_REAL if real else FID_FAKE
    x = torch.randint(low, high, (n, 3, cells, cells), generator=gen, device=IMAGE_DEVICE).to(torch.float32)
    x = torch.nn.functional.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
    x = x + FID_PIXEL_NOISE * torch.randn(x.shape, generator=gen, device=IMAGE_DEVICE)
    return x.clamp_(0.0, 255.0).to(torch.uint8)


def fid_batches(torch):
    """BASELINE config 5b: 16 real and 16 fake uint8 [64, 3, 299, 299]
    batches made on the card, interleaved as ``(images, real)``."""
    gen = torch.Generator(device=IMAGE_DEVICE).manual_seed(FID_SEED)
    out = []
    for _ in range(FID_BATCHES):
        out.append((fid_images(torch, gen, True, FID_BATCH), True))
        out.append((fid_images(torch, gen, False, FID_BATCH), False))
    return out


def inception_weights(torch, directory):
    """An ``.npz`` of seeded random InceptionV3 weights in the JAX package's
    layout: the default initialisation under seed 0 and random BatchNorm
    affine parameters (tests/image/test_fid_kid_is.py's recipe), the
    running statistics from a seeded calibration batch of both generators
    (see FID_SEED)."""
    from metrics_tpu_torch.convert import inception_to_flax
    from metrics_tpu_torch.models.inception import InceptionV3FID

    torch.manual_seed(0)
    model = InceptionV3FID()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.normal_(0.0, 0.1)
                mod.momentum = None  # a cumulative average: the batch's own statistics
                mod.reset_running_stats()
        gen = torch.Generator(device=IMAGE_DEVICE).manual_seed(FID_SEED + 1)
        half = FID_CALIBRATION // 2
        calibration = torch.cat([fid_images(torch, gen, True, half), fid_images(torch, gen, False, half)])
        model.to(IMAGE_DEVICE).train()(calibration)
    path = os.path.join(directory, "inception.npz")
    np.savez(path, variables=np.asarray(inception_to_flax(model.state_dict()), dtype=object))
    return path


def fid_update(collection, batch):
    collection.update(batch[0], real=batch[1])


def is_update(collection, batch):
    collection.update(batch[0])


def tf32_gate(torch, extractor, images):
    """The extractor's features with the caller's TF32 flags all on and all
    off: bit-equal, and each setting found again after the call. Returns
    the features and the gap of a forward run with TF32 on inside."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, torch.get_float32_matmul_precision())
    out = {}
    try:
        for label, on in (("tf32_on", True), ("tf32_off", False)):
            cudnn.allow_tf32, matmul.allow_tf32 = on, on
            torch.set_float32_matmul_precision("high" if on else "highest")
            out[label] = extractor(images)
            torch.cuda.synchronize()
            found = (cudnn.allow_tf32, matmul.allow_tf32, torch.get_float32_matmul_precision())
            check(found == (on, on, "high" if on else "highest"), f"fid-inception: the extractor left the flags at {found}")
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved[0], saved[1]
        torch.set_float32_matmul_precision(saved[2])
    check(torch.equal(out["tf32_on"], out["tf32_off"]), "fid-inception: the features depend on the caller's TF32 flags")
    with torch.no_grad(), cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=True):
        inside = extractor.model(images, extractor.feature)
    gap = (inside.double() - out["tf32_off"].double()).abs()
    scale = out["tf32_off"].double().abs().max()
    return out["tf32_off"], {"max_abs": float(gap.max()), "max_rel_of_max": float(gap.max() / scale)}


def fid_inception_phase(torch, ops, card, tm):
    """fid-inception: config 5b through FrechetInceptionDistance(2048),
    KernelInceptionDistance(subset_size=1000) and InceptionScore(), eager
    and fused, against exact=True; the TF32 independence of the features."""
    t_phase = time.perf_counter()
    base = free_card(torch)
    directory = tempfile.mkdtemp(prefix="chip_smoke_inception_")
    try:
        path = inception_weights(torch, directory)
        batches = fid_batches(torch)
        torch.cuda.synchronize()
        makers = {
            "FID": lambda: tm.FrechetInceptionDistance(2048, feature_extractor_weights_path=path),
            "KID": lambda: tm.KernelInceptionDistance(2048, subset_size=KID_SUBSET, seed=0, feature_extractor_weights_path=path),
            "IS": lambda: tm.InceptionScore(feature_extractor_weights_path=path),
        }
        fake_only = [b for b in batches if not b[1]]
        report, eager_values, metrics = {}, {}, {}
        for name, make in makers.items():
            stream, update = (fake_only, is_update) if name == "IS" else (batches, fid_update)
            legs = fused_legs(torch, ops, f"fid-inception ({name})", lambda: tm.MetricCollection([make()]), stream, {}, update=update)
            metric = next(iter(legs["eager"]["collection"].values()))
            eager_values[name] = next(iter(legs["eager"]["values"].values()))
            metrics[name] = metric
            # compute over the whole stream (leg_report resets the states)
            compute_ms = median_ms(torch, metric._compute, repeats=3)
            leg_reports = {leg: leg_report(torch, ops, legs[leg], update, stream) for leg in legs}
            fused = leg_reports["fused"]
            check(not fused["eager_leg"] and not fused["declined"], f"fid-inception ({name}): {fused['declined']}")
            check(fused["host_syncs_per_update"] == 0, f"fid-inception ({name}): the fused update reads the card")
            report[name] = {
                leg: {**r, "images_per_s": FID_BATCH / (r["ms_per_update"] / 1e3)} for leg, r in leg_reports.items()
            }
            report[name]["compute_ms"] = compute_ms
            report[name]["state_bytes"] = state_bytes(metric)
            report[name]["value"] = [float(v) for v in flat_outputs(eager_values[name])]
            del legs, leg_reports, fused
            gc.collect()  # the fused leg's graphs (a handle-collection cycle)
        # exact=True on the same batches: the features are the same bits
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            exact = tm.MetricCollection(
                [
                    tm.FrechetInceptionDistance(2048, feature_extractor_weights_path=path, exact=True),
                    tm.KernelInceptionDistance(2048, subset_size=KID_SUBSET, seed=0, feature_extractor_weights_path=path, exact=True),
                ]
            )
        for batch in batches:
            fid_update(exact, batch)
        exact_values, exact_ms = timed(torch, exact.compute)
        fid_exact = float(exact_values["FrechetInceptionDistance"])
        fid_rel = abs(float(eager_values["FID"]) - fid_exact) / abs(fid_exact)
        check(fid_rel <= FID_RTOL, f"fid-inception: streaming FID {float(eager_values['FID'])} off exact float64 {fid_exact} by {fid_rel}")
        kid_exact = exact_values["KernelInceptionDistance"]
        check(
            all(torch.equal(a, b) for a, b in zip(eager_values["KID"], kid_exact)),
            f"fid-inception: KID in its window {[float(v) for v in eager_values['KID']]} differs from exact=True {[float(v) for v in kid_exact]}",
        )
        features, tf32_gap = tf32_gate(torch, metrics["FID"].inception, batches[1][0])
        check(tuple(features.shape) == (FID_BATCH, 2048) and bool(torch.isfinite(features).all()), "fid-inception: bad features")
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    emit(
        {
            "phase": "fid-inception",
            "card": card,
            "batch": FID_BATCH,
            "real_batches": FID_BATCHES,
            "fake_batches": FID_BATCHES,
            "metrics": report,
            "fid_exact_float64": fid_exact,
            "fid_rel_diff_streaming_exact": fid_rel,
            "kid_exact": [float(v) for v in kid_exact],
            "exact_compute_ms": exact_ms,
            "tf32_gap_if_on_inside": tf32_gap,
            "peak_memory_bytes": peak,
            "memory_at_start_bytes": base,
            "seconds": time.perf_counter() - t_phase,
        }
    )


def lpips_weights(torch, net_type, directory):
    """An ``.npz`` of seeded random LPIPS weights in the JAX package's
    layout, as tests/image/test_lpips.py makes its mirror's: the default
    initialisation under seed 1, the heads uniform in [0, 0.2]."""
    from metrics_tpu_torch.convert import lpips_to_flax
    from metrics_tpu_torch.models.lpips import LPIPSNet

    torch.manual_seed(1)
    model = LPIPSNet(net_type).eval()
    with torch.no_grad():
        for k in range(5):
            getattr(model, f"lin{k}").model[1].weight.uniform_(0.0, 0.2)
    path = os.path.join(directory, f"lpips_{net_type}.npz")
    np.savez(path, variables=np.asarray(lpips_to_flax(model.state_dict(), net_type), dtype=object))
    return path


def lpips_phase(torch, ops, card, tm):
    """lpips: alex and vgg over 64 pairs of 3 x 256 x 256, eager and fused,
    against the port on the CPU."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=IMAGE_DEVICE).manual_seed(LPIPS_SEED)
    shape = (LPIPS_PAIRS,) + LPIPS_SHAPE
    img1 = torch.rand(shape, generator=gen, device=IMAGE_DEVICE) * 2 - 1
    img2 = (img1 + LPIPS_NOISE * torch.randn(shape, generator=gen, device=IMAGE_DEVICE)).clamp_(-1.0, 1.0)
    per = LPIPS_PAIRS // LPIPS_UPDATES
    batches = [(img1[i * per : (i + 1) * per], img2[i * per : (i + 1) * per]) for i in range(LPIPS_UPDATES)]
    directory = tempfile.mkdtemp(prefix="chip_smoke_lpips_")
    report = {}
    try:
        for net_type in ("alex", "vgg"):
            path = lpips_weights(torch, net_type, directory)

            def make(device=None):
                return tm.LearnedPerceptualImagePatchSimilarity(net_type=net_type, net_weights_path=path, device=device)

            base = free_card(torch)
            legs = fused_legs(torch, ops, f"lpips ({net_type})", lambda: tm.MetricCollection([make()]), batches, {})
            leg_reports = {leg: leg_report(torch, ops, legs[leg], update_args, batches) for leg in legs}
            fused = leg_reports["fused"]
            check(not fused["eager_leg"] and not fused["declined"], f"lpips ({net_type}): {fused['declined']}")
            check(fused["host_syncs_per_update"] == 0, f"lpips ({net_type}): the fused update reads the card")
            # the first update's pairs on the card and on the CPU
            card_metric, cpu_metric = make(), make("cpu")
            card_metric.update(*batches[0])
            cpu_metric.update(batches[0][0].cpu(), batches[0][1].cpu())
            head, cpu = float(card_metric.compute()), float(cpu_metric.compute())
            rel_cpu = abs(head - cpu) / abs(cpu)
            check(rel_cpu <= LPIPS_RTOL, f"lpips ({net_type}): card {head} and CPU {cpu} differ by {rel_cpu} (relative)")
            value = float(next(iter(legs["eager"]["values"].values())))
            check(math.isfinite(value) and value > 0, f"lpips ({net_type}): value {value}")
            report[net_type] = {
                **{leg: {**r, "pairs_per_s": per / (r["ms_per_update"] / 1e3)} for leg, r in leg_reports.items()},
                "value": value,
                "first_update_value": head,
                "first_update_cpu": cpu,
                "rel_diff_card_cpu": rel_cpu,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "memory_at_start_bytes": base,
            }
            del legs, leg_reports, fused
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    emit(
        {
            "phase": "lpips",
            "card": card,
            "pairs": LPIPS_PAIRS,
            "shape": list(LPIPS_SHAPE),
            "updates": LPIPS_UPDATES,
            "nets": report,
            "seconds": time.perf_counter() - t_phase,
        }
    )


# ---------------------------------------------------------------------------
# cross-process sync: ranks spawned on the one card, joined in a gloo group
# ---------------------------------------------------------------------------


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world, args, timeout_s):
    """``fn(rank, world, port, out_dir, *args)`` in ``world`` spawned
    processes; returns each rank's JSON result. A rank that raises or exits
    fails the phase (its error is raised here), and so does the deadline;
    every rank still running then is killed."""
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    ctx = mp.start_processes(
        fn, args=(world, free_port(), out_dir) + tuple(args), nprocs=world, join=False, start_method="spawn"
    )
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=5.0):
            check(time.monotonic() < deadline, f"{fn.__name__}: ranks still running after {timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            results.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    return results


def join_gloo(torch, rank, world, port):
    import datetime

    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo",
        init_method=f"tcp://127.0.0.1:{port}",
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=SYNC_TIMEOUT_S),
    )


def digest(torch, *tensors):
    """sha256 of the tensors' bits (host copies: the cross-rank check only)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(bits(torch, t).numpy().tobytes())
    return h.hexdigest()


def alone(x, group=None):
    """A gather over a world of one: a metric built with it inside a process
    group computes on its own states (the one-process references)."""
    return [x]


def timed_collective(torch, ops, dist_mod, fn):
    """``fn()`` once, all ranks started together, with the kernel launch and
    collective counters reset: ``(result, ms, launches, collectives)``."""
    torch.cuda.synchronize()
    torch.distributed.barrier()
    ops.reset_launch_counts()
    dist_mod.reset_collective_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    return result, ms, launches, dist_mod.collective_counts()


def recording(dist_mod, log):
    """The process group's gather, keeping what each call returned."""

    def gather(x, group=None):
        out = dist_mod.gather_all_arrays(x, group)
        log.append(out)
        return out

    return gather


def cpu_replay_sync(torch, metric, log):
    """Sync ``metric`` (a CPU copy of a card metric, taken before its sync)
    with the gathers the card's sync recorded, copied to the host with their
    occupancy bounds: the plain folds on the CPU."""
    from metrics_tpu_torch.sketches.quantile import _FILL_BOUND, fill_bound, with_fill_bound

    calls = iter(log)

    def gather(x, group=None):
        out = []
        for g in next(calls):
            host = g.detach().cpu()
            if hasattr(g, _FILL_BOUND):
                with_fill_bound(host, fill_bound(g))
            out.append(host)
        return out

    metric.sync(dist_sync_fn=gather)
    states = {k: getattr(metric, k) for k in metric._defaults}
    metric.unsync()
    return states


def checked_sync(torch, ops, dist_mod, rank, metric, expected_launches, label):
    """One sync of ``metric`` through the process group, recorded: its ms,
    launches (held to ``expected_launches``) and collectives; on rank 0 the
    synced states held bit for bit against the CPU's plain folds of the same
    gathers. Returns ``(report, synced states)``; the metric is unsynced."""
    twin = metric.clone().to_device("cpu") if rank == 0 else None
    log = []
    _, ms, launches, coll = timed_collective(torch, ops, dist_mod, lambda: metric.sync(dist_sync_fn=recording(dist_mod, log)))
    synced = {k: getattr(metric, k) for k in metric._defaults}
    check(metric._is_synced, f"{label}: the metric did not sync")
    for kernel, want in expected_launches.items():
        check(launches.get(kernel, 0) == want, f"{label}: {kernel} launched {launches.get(kernel, 0)} times in a sync, expected {want}")
    unexpected = {k: v for k, v in launches.items() if k not in expected_launches and k in SYNC_GATED_KERNELS}
    check(not unexpected, f"{label}: kernels launched in a sync where none was expected: {unexpected}")
    report = {
        "sync_ms": ms,
        "bytes_gathered": coll["bytes_received"],
        "rounds": coll["rounds"],
        "host_reads": coll["host_reads"],
        "launches": launches,
        "state_bytes": metric.total_state_bytes(),
        "states_digest": digest(torch, *[v for v in synced.values() if isinstance(v, torch.Tensor)]),
    }
    if rank == 0:
        cpu = cpu_replay_sync(torch, twin, log)
        differ = [k for k, v in synced.items() if isinstance(v, torch.Tensor) and not torch.equal(bits(torch, v), bits(torch, cpu[k]))]
        check(not differ, f"{label}: synced states differ from the CPU's plain folds: {differ}")
        report["cpu_plain_folds_equal"] = True
    metric.unsync()
    # one more sync under torch.profiler: the device's share of a sync
    torch.distributed.barrier()
    prof = device_profile(torch, lambda i: metric.sync(), 1, host_ops=False)
    metric.unsync()
    report["profiled_sync"] = {
        "wall_ms": prof["profiled_wall_ms_per_step"],
        "device_ms": prof["device_busy_ms_per_step"],
        "device_idle_share": 1 - prof["device_busy_ms_per_step"] / prof["profiled_wall_ms_per_step"],
        "device_us_by_kernel": prof["device_us_per_step_by_kernel"],
        "wrapper_kernels_seen": device_launches(prof["kernel_calls"]),
    }
    return report, synced


def synced_compute(torch, ops, dist_mod, metric, repeats=SYNC_COMPUTE_REPEATS):
    """``compute()`` (sync, compute, unsync) ``repeats`` times in step on
    every rank: the last value, the median ms and the first one's launches
    and collectives."""
    times, first = [], None
    for _ in range(repeats):
        metric._computed = None
        value, ms, launches, coll = timed_collective(torch, ops, dist_mod, metric.compute)
        times.append(ms)
        first = first or (launches, coll)
    check(not metric._is_synced, "compute() left the metric synced")
    return value, {"compute_ms": float(np.median(times)), "compute_ms_all": times, "compute_launches": first[0], "compute_collectives": first[1]}


def sync_flagship_rank(torch, ops, tm, dist_mod, rank, world):
    """ConfusionMatrix(1000) + AUROC(1000, capacity=65536) over the 12 seed-42
    batches, rank r taking batches r, r + world, ...; Accuracy(1000,
    dist_sync_on_step=True) through forward on the same batches."""
    device = torch.device(SYNC_DEVICE)
    preds_np, target_np = make_data(STATEFUL_BATCHES)
    mine = list(range(rank, STATEFUL_BATCHES, world))
    preds = torch.from_numpy(preds_np[mine]).to(device)
    target = torch.from_numpy(target_np[mine]).to(device)
    cm = tm.ConfusionMatrix(num_classes=NUM_CLASSES)
    auroc = tm.AUROC(num_classes=NUM_CLASSES, capacity=CAPACITY)
    for i in range(len(mine)):
        cm.update(preds[i], target[i])
        auroc.update(preds[i], target[i])
    out = {}
    out["confmat_sync"], synced_cm = checked_sync(torch, ops, dist_mod, rank, cm, {}, "sync-flagship confmat")
    out["auroc_sync"], _ = checked_sync(torch, ops, dist_mod, rank, auroc, {}, "sync-flagship auroc")
    auc, out["auroc_compute"] = synced_compute(torch, ops, dist_mod, auroc)
    check(out["auroc_compute"]["compute_launches"].get("segment_sum_f32") == 1, f"sync-flagship: compute launches {out['auroc_compute']['compute_launches']}")
    _, out["confmat_compute"] = synced_compute(torch, ops, dist_mod, cm)
    out["macro_auroc"] = float(auc)
    if rank == 0:
        one = tm.ConfusionMatrix(num_classes=NUM_CLASSES, dist_sync_fn=alone)
        all_preds, all_target = torch.from_numpy(preds_np).to(device), torch.from_numpy(target_np).to(device)
        for i in range(STATEFUL_BATCHES):
            one.update(all_preds[i], all_target[i])
        check(torch.equal(synced_cm["confmat"], one.confmat), "sync-flagship: synced confusion matrix differs from one process")
        rows = STATEFUL_BATCHES * BATCH
        _, ref = numpy_auroc(preds_np.reshape(rows, -1), target_np.reshape(-1), NUM_CLASSES)
        out["auroc_abs_err_vs_scipy"] = abs(float(auc) - ref)
        check(out["auroc_abs_err_vs_scipy"] <= 1e-6, f"sync-flagship: AUROC off the scipy reference by {out['auroc_abs_err_vs_scipy']}")
        del all_preds, all_target
    # forward with dist_sync_on_step: each step's value is the global batch's
    acc = tm.Accuracy(num_classes=NUM_CLASSES, dist_sync_on_step=True)
    values, times = [], []
    for i in range(len(mine)):
        value, ms, _, _ = timed_collective(torch, ops, dist_mod, lambda: acc(preds[i], target[i]))
        values.append(float(value))
        times.append(ms)
    pred_labels = preds_np.argmax(axis=-1)
    for step, value in enumerate(values):
        batch = list(range(step * world, min((step + 1) * world, STATEFUL_BATCHES)))
        want = float(np.float32((pred_labels[batch] == target_np[batch]).sum()) / np.float32(len(batch) * BATCH))
        check(abs(value - want) <= 1e-7, f"sync-flagship: forward step {step} gave {value}, the global batch {want}")
    local = float((pred_labels[mine] == target_np[mine]).mean())
    acc.dist_sync_fn = alone  # the local accumulation
    check(abs(float(acc.compute()) - local) <= 1e-6, "sync-flagship: forward changed the local accumulation")
    out["forward_values"] = values
    out["forward_ms"] = float(np.median(times))
    return out


def sketch_sync_parts(torch, ops, dist_mod, rank, metric, label):
    """A sketched metric's checked sync past capacity (K3 + K1 world - 1
    times for its sketch leaf) and its synced compute."""
    world = torch.distributed.get_world_size()
    expected = {"qsketch_sort_bucket": world - 1, "segment_sum_f32": world - 1}
    report, synced = checked_sync(torch, ops, dist_mod, rank, metric, expected, label)
    value, compute = synced_compute(torch, ops, dist_mod, metric)
    return {**report, **compute}, synced, value


def sync_sketch_rank(torch, ops, tm, dist_mod, rank, world):
    """AUROC() over sketch-binary's click log (rank r: batches r, r + world,
    ...), the lossless window's first 8192 samples split, and ROC() and
    AveragePrecision() over curve-binary's stream."""
    from metrics_tpu_torch.sketches import sketch_merge_fx

    device = torch.device(SYNC_DEVICE)
    score_np, y_np = make_ctr_stream(SKETCH_BATCHES * SKETCH_BATCH)
    score, y = torch.from_numpy(score_np).to(device), torch.from_numpy(y_np).to(device)
    out = {}
    m = tm.AUROC()
    for b in range(rank, SKETCH_BATCHES, world):
        m.update(score[b * SKETCH_BATCH : (b + 1) * SKETCH_BATCH], y[b * SKETCH_BATCH : (b + 1) * SKETCH_BATCH])
    out["auroc"], synced, value = sketch_sync_parts(torch, ops, dist_mod, rank, m, "sync-sketch auroc")
    out["auroc"]["value"] = float(value)
    if rank == 0:
        exact = midrank_auroc(score_np, y_np)
        out["auroc"]["abs_err_vs_exact"] = abs(float(value) - exact)
        check(out["auroc"]["abs_err_vs_exact"] <= 5e-3, f"sync-sketch: AUROC {float(value)} off exact {exact}")
        check(float(synced["csketch"][:, 0].sum()) == SKETCH_BATCHES * SKETCH_BATCH, "sync-sketch: synced sketch weight")
    # the lossless window: the first 8192 samples, rank r the r-th part
    part = SKETCH_CAPACITY // world
    w = tm.AUROC()
    w.update(score[rank * part : (rank + 1) * part], y[rank * part : (rank + 1) * part])
    out["window"], synced_w = checked_sync(
        torch, ops, dist_mod, rank, w, {"qsketch_sort_bucket": 0, "segment_sum_f32": 0}, "sync-sketch window"
    )
    gathered = dist_mod.gather_all_arrays(w.csketch)
    bare = torch.stack([g.clone() for g in gathered])  # without the ranks' occupancy bounds
    ops.reset_launch_counts()
    bare_merge = sketch_merge_fx()(bare)
    torch.cuda.synchronize()
    out["window"]["launches_without_bounds"] = {k: v for k, v in ops.launch_counts().items() if v}
    check(torch.equal(bits(torch, bare_merge), bits(torch, synced_w["csketch"])), "sync-sketch: the bounds changed the merged window")
    if rank == 0:
        one = tm.AUROC(dist_sync_fn=alone)
        one.update(score[: part * world], y[: part * world])
        check(torch.equal(bits(torch, synced_w["csketch"]), bits(torch, one.csketch)), "sync-sketch: synced window differs from one process")
        check(torch.equal(synced_w["n_seen"], one.n_seen), "sync-sketch: synced window count differs")
    # ROC and AveragePrecision, sketched, over curve-binary's stream
    curve_scores, curve_labels = make_curve_stream()
    cs, cl = torch.from_numpy(curve_scores).to(device), torch.from_numpy(curve_labels).to(device)
    roc, ap = tm.ROC(), tm.AveragePrecision()
    for b in range(rank, CURVE_BATCHES, world):
        roc.update(cs[b], cl[b])
        ap.update(cs[b], cl[b])
    out["roc"], _, (fpr, tpr, _) = sketch_sync_parts(torch, ops, dist_mod, rank, roc, "sync-sketch roc")
    out["ap"], _, ap_value = sketch_sync_parts(torch, ops, dist_mod, rank, ap, "sync-sketch ap")
    roc_area = float(torch.trapezoid(tpr.double(), fpr.double()))
    out["roc"]["area"], out["ap"]["value"] = roc_area, float(ap_value)
    if rank == 0:
        flat_s, flat_y = curve_scores.reshape(-1), curve_labels.reshape(-1)
        out["roc"]["abs_err_vs_exact"] = abs(roc_area - midrank_auroc(flat_s, flat_y))
        out["ap"]["abs_err_vs_exact"] = abs(float(ap_value) - numpy_step_ap(flat_s, flat_y))
        check(out["roc"]["abs_err_vs_exact"] <= 5e-3 and out["ap"]["abs_err_vs_exact"] <= 5e-3, f"sync-sketch: ROC/AP off exact {out['roc']}, {out['ap']}")
    return out


def retrieval_split(n_docs, rank, world):
    """Document positions of rank ``rank``: chunks of SYNC_RETRIEVAL_CHUNK
    documents dealt in turn, so most queries live on every rank."""
    pos = np.arange(n_docs)
    return pos[(pos // SYNC_RETRIEVAL_CHUNK) % world == rank]


def sync_retrieval_rank(torch, ops, tm, dist_mod, rank, world):
    """RetrievalNormalizedDCG + RetrievalMAP (lossless tables) over config 4,
    documents dealt to the ranks by chunk; one K4 per table merge."""
    device = torch.device(SYNC_DEVICE)
    idx_np, preds_np, target_np = make_mslr_stream()
    mine = retrieval_split(idx_np.shape[0], rank, world)
    stream = stream_on(torch, (idx_np[mine], preds_np[mine], target_np[mine]), device)
    kw = dict(max_queries=RETRIEVAL_MAX_QUERIES, max_docs=SYNC_RETRIEVAL_MAX_DOCS)
    ndcg, rmap = tm.RetrievalNormalizedDCG(**kw), tm.RetrievalMAP(**kw)
    idx, preds, target = stream
    for start in range(0, idx.shape[0], RETRIEVAL_UPDATE_DOCS):
        sl = slice(start, start + RETRIEVAL_UPDATE_DOCS)
        ndcg.update(preds[sl], target[sl], indexes=idx[sl])
        rmap.update(preds[sl], target[sl], indexes=idx[sl])
    out = {}
    values = {}
    for name, m in (("ndcg", ndcg), ("map", rmap)):
        out[name], _ = checked_sync(torch, ops, dist_mod, rank, m, {"row_topk": world - 1}, f"sync-retrieval {name}")
        value, compute = synced_compute(torch, ops, dist_mod, m)
        out[name].update(compute)
        values[name] = value
        out[name]["value"] = float(value)
    if rank == 0:
        whole = stream_on(torch, (idx_np, preds_np, target_np), device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            exact = {
                "ndcg": tm.RetrievalNormalizedDCG(exact=True, dist_sync_fn=alone),
                "map": tm.RetrievalMAP(exact=True, dist_sync_fn=alone),
            }
        tables = {"ndcg": tm.RetrievalNormalizedDCG(dist_sync_fn=alone, **kw), "map": tm.RetrievalMAP(dist_sync_fn=alone, **kw)}
        for start in range(0, idx_np.shape[0], RETRIEVAL_UPDATE_DOCS):
            sl = slice(start, start + RETRIEVAL_UPDATE_DOCS)
            for m in (*exact.values(), *tables.values()):
                m.update(whole[1][sl], whole[2][sl], indexes=whole[0][sl])
        for name in ("ndcg", "map"):
            ex, one = exact[name].compute(), tables[name].compute()
            out[name]["abs_diff_vs_exact"] = abs(float(values[name]) - float(ex))
            out[name]["bit_equal_to_exact"] = bool(torch.equal(bits(torch, values[name]), bits(torch, ex)))
            out[name]["bit_equal_to_one_process_table"] = bool(torch.equal(bits(torch, values[name]), bits(torch, one)))
            check(
                out[name]["bit_equal_to_exact"] and out[name]["bit_equal_to_one_process_table"],
                f"sync-retrieval: {name} {float(values[name])} is not one process's exact=True {float(ex)} or table {float(one)}",
            )
    return out


def sync_map_rank(torch, ops, tm, dist_mod, rank, world):
    """MeanAveragePrecision over config 3's 5000 images, batches of 16 dealt
    to the ranks in turn; every key against one process over all images."""
    device = torch.device(SYNC_DEVICE)
    preds_np, target_np = make_detection_data(MAP_IMAGES)
    starts = list(range(0, MAP_IMAGES, MAP_BATCH))
    m = tm.MeanAveragePrecision(class_metrics=True, max_images=MAP_LOSSLESS_CAPACITY)
    for lo in starts[rank::world]:
        m.update(images_on(torch, preds_np[lo : lo + MAP_BATCH], device), images_on(torch, target_np[lo : lo + MAP_BATCH], device))
    out, _ = checked_sync(torch, ops, dist_mod, rank, m, {}, "sync-map")
    value, compute = synced_compute(torch, ops, dist_mod, m, repeats=1)
    out.update(compute)
    check(compute["compute_launches"].get("box_iou_batched", 0) >= 1, f"sync-map: compute launches {compute['compute_launches']}")
    out["map"] = float(value["map"])
    out["values_digest"] = digest(torch, *[value[k] for k in sorted(value)])
    if rank == 0:
        one = tm.MeanAveragePrecision(class_metrics=True, max_images=MAP_LOSSLESS_CAPACITY, dist_sync_fn=alone)
        for lo in starts:
            one.update(images_on(torch, preds_np[lo : lo + MAP_BATCH], device), images_on(torch, target_np[lo : lo + MAP_BATCH], device))
        want = one.compute()
        differ = [k for k in want if not torch.equal(bits(torch, value[k]), bits(torch, want[k]))]
        out["keys_differing_from_one_process"] = differ
        check(not differ, f"sync-map: keys differ from one process: {differ}")
    return out


def sync_sliced_rank(torch, ops, tm, dist_mod, rank, world):
    """SlicedMetric(PSNR(), 1000) over sliced-psnr's 16 updates (rank r:
    updates r, r + world, ...), and WindowedMetric(MSE(), window=8) over 40
    updates, against one process over all updates."""
    from metrics_tpu_torch.utils.data import dim_zero_sum

    sliced = tm.SlicedMetric(tm.PeakSignalNoiseRatio(), PSNR_TENANTS)
    for i in range(rank, PSNR_UPDATES, world):
        sliced.update(*psnr_batch(torch, PSNR_SEED + i))
    window = tm.WindowedMetric(tm.MeanSquaredError(), window=8)
    for i in range(rank, WINDOW_UPDATES, world):
        window.update(*psnr_batch(torch, WINDOW_SEED + i)[1:])
    out = {}
    out["sliced"], synced_s = checked_sync(torch, ops, dist_mod, rank, sliced, {}, "sync-sliced sliced")
    value_s, compute = synced_compute(torch, ops, dist_mod, sliced)
    out["sliced"].update(compute)
    out["windowed"], synced_w = checked_sync(torch, ops, dist_mod, rank, window, {}, "sync-sliced windowed")
    value_w, compute = synced_compute(torch, ops, dist_mod, window)
    out["windowed"].update(compute)
    if rank == 0:
        one_s = tm.SlicedMetric(tm.PeakSignalNoiseRatio(), PSNR_TENANTS, dist_sync_fn=alone)
        for i in range(PSNR_UPDATES):
            one_s.update(*psnr_batch(torch, PSNR_SEED + i))
        # each rank's bucket b is update b of its share: one process puts
        # two updates in a bucket
        one_w = tm.WindowedMetric(tm.MeanSquaredError(), window=8, updates_per_bucket=world, dist_sync_fn=alone)
        for i in range(WINDOW_UPDATES):
            one_w.update(*psnr_batch(torch, WINDOW_SEED + i)[1:])
        worst = 0.0
        for m, synced, one, skip in ((sliced, synced_s, one_s, ()), (window, synced_w, one_w, ("_ring_count",))):
            for name, red in m._reductions.items():
                if name in skip:
                    continue
                got, want = synced[name], getattr(one, name)
                if got.is_floating_point() and (red is dim_zero_sum or getattr(red, "inner_reduce", None) == "sum"):
                    # float sums: the rank-order fold adds in another order
                    rel = float(((got.double() - want.double()).abs() / want.double().abs().clamp(min=1e-30)).max())
                    worst = max(worst, rel)
                    check(rel <= 1e-6, f"sync-sliced: {name} off one process by rtol {rel}")
                else:  # integer counts, max and min
                    check(torch.equal(bits(torch, got), bits(torch, want)), f"sync-sliced: {name} differs from one process")
        out["float_sum_max_rel_err"] = worst
        for label, got, want in (("sliced", value_s, one_s.compute()), ("windowed", value_w, one_w.compute())):
            same_nan = torch.equal(torch.isnan(got), torch.isnan(want))
            ok = ~torch.isnan(want)
            rel = float(((got[ok].double() - want[ok].double()).abs() / want[ok].double().abs()).max()) if ok.any() else 0.0
            out[label]["value_max_rel_err"] = rel
            check(same_nan and rel <= 1e-6, f"sync-sliced: {label} values off one process by rtol {rel}")
    return out


SYNC_PHASES = {
    "sync-flagship": sync_flagship_rank,
    "sync-sketch": sync_sketch_rank,
    "sync-retrieval": sync_retrieval_rank,
    "sync-map": sync_map_rank,
    "sync-sliced": sync_sliced_rank,
}


def sync_families_rank(rank, world, port, out_dir, phases):
    """One rank of the 2-rank sync families: each phase in turn, then its
    results to ``out_dir``."""
    import torch

    join_gloo(torch, rank, world, port)
    try:
        from metrics_tpu_torch import ops

        tm = import_module("metrics_tpu_torch")
        dist_mod = import_module("metrics_tpu_torch.parallel.distributed")
        out = {}
        for name in phases:
            t0 = time.perf_counter()
            out[name] = SYNC_PHASES[name](torch, ops, tm, dist_mod, rank, world)
            out[name]["phase_seconds"] = time.perf_counter() - t0
            torch.distributed.barrier()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def bundle_rank(rank, world, port, out_dir):
    """BASELINE config 6 on the card: a ConfusionMatrix(1000) and a binary
    AUROC(capacity=65536) per rank, synced per metric (Metric.sync) and in
    one sync_pytree round, each 3 + 20 times."""
    import torch

    join_gloo(torch, rank, world, port)
    try:
        from metrics_tpu_torch import ops

        tm = import_module("metrics_tpu_torch")
        dist_mod = import_module("metrics_tpu_torch.parallel.distributed")
        device = torch.device(SYNC_DEVICE)
        gen = torch.Generator(device=SYNC_DEVICE).manual_seed(rank)
        col = tm.MetricCollection(
            {"confmat": tm.ConfusionMatrix(num_classes=NUM_CLASSES), "auroc": tm.AUROC(capacity=CAPACITY)}, compute_groups=False
        )
        n = CAPACITY // world
        col["confmat"].update(
            torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen, device=device), torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen, device=device)
        )
        col["auroc"].update(torch.rand(n, generator=gen, device=device), torch.randint(0, 2, (n,), generator=gen, device=device))
        metrics = list(col.values())

        def per_metric():
            for m in metrics:
                m.sync()

        def unsync_all():
            for m in metrics:
                m.unsync()

        state = {name: {k: getattr(m, k) for k in m._defaults} for name, m in col.items()}
        reductions = col.state_reductions()
        out = {"state_bytes": sum(m.total_state_bytes() for m in metrics)}
        for label, run, after in (
            ("per_metric_sync", per_metric, unsync_all),
            ("sync_pytree", lambda: dist_mod.sync_pytree(state, reductions), lambda: None),
        ):
            times = []
            for i in range(BUNDLE_WARMUP + BUNDLE_ITERS):
                result, ms, launches, coll = timed_collective(torch, ops, dist_mod, run)
                if i == 0:
                    if label == "per_metric_sync":
                        flat = [getattr(m, k).reshape(-1) for m in metrics for k in m._defaults]
                    else:
                        flat = [result[name][k].reshape(-1) for name, m in col.items() for k in m._defaults]
                    out[f"{label}_digest"] = digest(torch, *flat)
                    out[f"{label}_collectives"] = coll
                    out[f"{label}_launches"] = launches
                after()
                if i >= BUNDLE_WARMUP:
                    times.append(ms)
            out[f"{label}_p50_ms"] = float(np.percentile(times, 50))
            out[f"{label}_p95_ms"] = float(np.percentile(times, 95))
            out[f"{label}_ms"] = times
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def sync_phases(torch, card):
    """The 2-rank sync families in one spawn, then the 8-rank bundle; each
    phase's line carries every rank's numbers. Returns each kernel's
    launches in the syncs, by phase and rank."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(sync_families_rank, SYNC_WORLD, (list(SYNC_PHASES),), SYNC_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    kernel_launches = {}
    for name in SYNC_PHASES:
        per_rank = [r[name] for r in ranks]
        # every rank holds the same synced states and values
        for key, section in per_rank[0].items():
            if isinstance(section, dict) and "states_digest" in section:
                check(all(r[key]["states_digest"] == section["states_digest"] for r in per_rank), f"{name}: {key} synced states differ across ranks")
                for r, rank_out in enumerate(per_rank):
                    for kernel, count in rank_out[key]["launches"].items():
                        kernel_launches.setdefault(kernel, {}).setdefault(f"{name} {key}" if key else name, []).append(count)
        if "states_digest" in per_rank[0]:
            check(all(r["states_digest"] == per_rank[0]["states_digest"] for r in per_rank), f"{name}: synced states differ across ranks")
            for rank_out in per_rank:
                for kernel, count in rank_out["launches"].items():
                    kernel_launches.setdefault(kernel, {}).setdefault(name, []).append(count)
        if "values_digest" in per_rank[0]:
            check(all(r["values_digest"] == per_rank[0]["values_digest"] for r in per_rank), f"{name}: synced values differ across ranks")
        emit({"phase": name, "card": card, "world": SYNC_WORLD, "backend": "gloo", "device": f"{SYNC_DEVICE}:0", "ranks": per_rank})
    t0 = time.perf_counter()
    bundle = spawn_ranks(bundle_rank, BUNDLE_WORLD, (), BUNDLE_TIMEOUT_S)
    bundle_s = time.perf_counter() - t0
    for key in ("per_metric_sync_digest", "sync_pytree_digest"):
        check(all(r[key] == bundle[0][key] for r in bundle), f"sync-bundle: {key} differs across ranks")
    check(bundle[0]["per_metric_sync_digest"] == bundle[0]["sync_pytree_digest"], "sync-bundle: sync_pytree differs from per-metric sync")
    emit(
        {
            "phase": "sync-bundle",
            "card": card,
            "world": BUNDLE_WORLD,
            "backend": "gloo",
            "device": f"{SYNC_DEVICE}:0",
            "state_bytes_per_rank": bundle[0]["state_bytes"],
            "per_metric_sync": {
                "p50_ms": [r["per_metric_sync_p50_ms"] for r in bundle],
                "p95_ms": [r["per_metric_sync_p95_ms"] for r in bundle],
                "collectives": bundle[0]["per_metric_sync_collectives"],
            },
            "sync_pytree": {
                "p50_ms": [r["sync_pytree_p50_ms"] for r in bundle],
                "p95_ms": [r["sync_pytree_p95_ms"] for r in bundle],
                "collectives": bundle[0]["sync_pytree_collectives"],
            },
            "launches": bundle[0]["per_metric_sync_launches"],
            "spawn_seconds": bundle_s,
        }
    )
    emit({"phase": "sync-spawns", "families_seconds": spawn_s, "bundle_seconds": bundle_s})
    return kernel_launches


def nccl_world1_phase(torch, card):
    """The NCCL transport in a one-process group: card tensors of every state
    dtype, viewed as bytes, all-gathered; the bits that come back are the
    bits that went in (multi-rank NCCL needs a card per rank)."""
    dist = torch.distributed
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        gen = torch.Generator(device=SYNC_DEVICE).manual_seed(9)
        base = torch.randn(4097, generator=gen, device=SYNC_DEVICE) * 1e3
        nan_payload = torch.tensor([0x7FC1, -61, 0x7F81, -32768], dtype=torch.int16, device=SYNC_DEVICE)
        cases = {
            "float32": base,
            "float64": base.double(),
            "float16": base.half(),
            "bfloat16": torch.cat([base.bfloat16(), nan_payload.view(torch.bfloat16)]),
            "int32": base.int(),
            "int64": base.long(),
            "bool": base > 0,
            "uint8": base.to(torch.uint8),
        }
        results = {}
        for name, x in cases.items():
            raw = x.contiguous().view(torch.uint8) if x.dtype != torch.uint8 else x
            out = [torch.empty_like(raw)]
            t0 = time.perf_counter()
            dist.all_gather(out, raw)
            torch.cuda.synchronize()
            back = out[0].view(x.dtype) if x.dtype != torch.uint8 else out[0]
            same = torch.equal(out[0], raw) and torch.equal(back.view(torch.uint8) if x.dtype != torch.uint8 else back, raw)
            check(same, f"nccl-world1: {name} bits changed")
            results[name] = {"bytes": raw.numel(), "ms": (time.perf_counter() - t0) * 1e3}
    finally:
        dist.destroy_process_group()
    emit({"phase": "nccl-world1", "card": card, "backend": "nccl", "world": 1, "dtypes": results, "multi_rank_nccl": "not measured: one card"})


# ---------------------------------------------------------------------------
# sliced-probability (the vmapped top-1 mask on the card)
# ---------------------------------------------------------------------------


def sliced_probability_phase(torch, ops, card, tm):
    """sliced-probability: SlicedMetric(Accuracy(10), 1000) over softmax rows
    made on the card from a seed, against the port's CPU run bit for bit."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=TEXT_DEVICE).manual_seed(SLICED_PROB_SEED)
    batches = []
    for _ in range(SLICED_PROB_UPDATES):
        logits = torch.randn(SLICED_PROB_ROWS, SLICED_PROB_CLASSES, generator=gen, device=TEXT_DEVICE)
        target = torch.randint(0, SLICED_PROB_CLASSES, (SLICED_PROB_ROWS,), generator=gen, device=TEXT_DEVICE)
        ids = torch.randint(0, SLICED_PROB_TENANTS, (SLICED_PROB_ROWS,), generator=gen, device=TEXT_DEVICE)
        batches.append((ids, torch.softmax(logits, dim=1), target))
    metric = tm.SlicedMetric(tm.Accuracy(num_classes=SLICED_PROB_CLASSES, device=TEXT_DEVICE), SLICED_PROB_TENANTS)
    metric.update(*batches[0])  # the first update builds the vmapped update
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for batch in batches[1:]:
        metric.update(*batch)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / (SLICED_PROB_UPDATES - 1) * 1e3
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    value, compute_ms = timed(torch, metric.compute)
    cpu = tm.SlicedMetric(tm.Accuracy(num_classes=SLICED_PROB_CLASSES, device="cpu"), SLICED_PROB_TENANTS)
    for batch in batches:
        cpu.update(*(x.cpu() for x in batch))
    want = cpu.compute()
    check(value.dtype == want.dtype == torch.float32, f"sliced-probability: dtypes {value.dtype} and {want.dtype}")
    check(bitwise_rows_differ(torch, value.cpu().reshape(-1, 1), want.reshape(-1, 1)) == 0, "sliced-probability: card and CPU differ")
    emit(
        {
            "phase": "sliced-probability",
            "card": card,
            "tenants": SLICED_PROB_TENANTS,
            "rows_per_update": SLICED_PROB_ROWS,
            "updates": SLICED_PROB_UPDATES,
            "ms_per_update": update_ms,
            "compute_ms": compute_ms,
            "launches_per_update": {k: n / (SLICED_PROB_UPDATES - 1) for k, n in launches.items()},
            "mean_accuracy": float(value.nanmean()),
            "seconds": time.perf_counter() - t_phase,
        }
    )


# ---------------------------------------------------------------------------
# text-corpus and bertscore-base
# ---------------------------------------------------------------------------


def text_corpus():
    """``(hypotheses, references, qa_preds, qa_targets)`` of the text-corpus
    phase, from TEXT_SEED (see the constants)."""
    rng = np.random.default_rng(TEXT_SEED)
    letters = rng.integers(0, 26, (TEXT_VOCAB, 10))
    sizes = rng.integers(2, 11, TEXT_VOCAB)
    vocab = ["".join(chr(97 + c) for c in letters[i, : sizes[i]]) for i in range(TEXT_VOCAB)]
    cdf = np.cumsum(1.0 / np.arange(1, TEXT_VOCAB + 1))
    cdf /= cdf[-1]

    def draw(k):
        return list(np.minimum(np.searchsorted(cdf, rng.random(k)), TEXT_VOCAB - 1))

    def sentence(ids):
        words = [vocab[i] for i in ids]
        return " ".join([words[0].capitalize()] + words[1:]) + "."

    lengths = rng.integers(TEXT_WORDS[0], TEXT_WORDS[1] + 1, TEXT_PAIRS)
    ids = draw(int(lengths.sum()))
    starts = np.concatenate([[0], np.cumsum(lengths)])
    hyps, refs = [], []
    for k in range(TEXT_PAIRS):
        hyp = ids[starts[k] : starts[k + 1]]
        pair = []
        for _ in range(2):
            ref = [w if rng.random() >= 0.1 else draw(1)[0] for w in hyp]
            ref = [w for w in ref if rng.random() >= 0.05]
            for _ in range(rng.binomial(3, 0.3)):
                ref.insert(int(rng.integers(len(ref) + 1)), draw(1)[0])
            at, size = int(rng.integers(0, len(ref) - 4)), int(rng.integers(2, 5))
            span = ref[at : at + size]
            del ref[at : at + size]
            to = int(rng.integers(len(ref) + 1))
            ref[to:to] = span
            pair.append(sentence(ref))
        hyps.append(sentence(hyp))
        refs.append(pair)
    qa_preds, qa_targets = [], []
    for k in range(TEXT_PAIRS):
        answers = [" ".join(vocab[i] for i in draw(int(rng.integers(1, 6)))) for _ in range(int(rng.integers(1, 4)))]
        pick = rng.random()
        if pick < 0.3:
            pred = "The " + answers[0] + "."
        elif pick < 0.8:
            words = answers[-1].split()
            pred = " ".join(words[: max(1, len(words) - 1)] + [vocab[i] for i in draw(2)])
        else:
            pred = " ".join(vocab[i] for i in draw(3))
        qa_preds.append({"prediction_text": pred, "id": str(k)})
        qa_targets.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": str(k)})
    return hyps, refs, qa_preds, qa_targets


#: label -> (class name, keyword arguments, inputs: "refs", "first" or "squad")
TEXT_METRICS = {
    "TER": ("TranslationEditRate", {}, "refs"),
    "EED": ("ExtendedEditDistance", {}, "refs"),
    "chrF++": ("CHRFScore", {"n_word_order": 2}, "refs"),
    "chrF": ("CHRFScore", {"n_word_order": 0}, "refs"),
    "SacreBLEU-char": ("SacreBLEUScore", {"tokenize": "char"}, "refs"),
    "CER": ("CharErrorRate", {}, "first"),
    "ROUGE": ("ROUGEScore", {"rouge_keys": ("rouge1", "rouge2", "rougeL")}, "refs"),
    "BLEU": ("BLEUScore", {}, "refs"),
    "SacreBLEU-13a": ("SacreBLEUScore", {"tokenize": "13a"}, "refs"),
    "WER": ("WordErrorRate", {}, "first"),
    "MER": ("MatchErrorRate", {}, "first"),
    "WIL": ("WordInfoLost", {}, "first"),
    "WIP": ("WordInfoPreserved", {}, "first"),
    "SQuAD": ("SQuAD", {}, "squad"),
}


def text_batches(corpus, label):
    """The update batches of one text metric (TER and EED over the first
    TEXT_SLOW_PAIRS pairs)."""
    hyps, refs, qa_preds, qa_targets = corpus
    kind = TEXT_METRICS[label][2]
    n = TEXT_SLOW_PAIRS if label in ("TER", "EED") else TEXT_PAIRS
    if kind == "squad":
        preds, targets = qa_preds[:n], qa_targets[:n]
    else:
        preds, targets = hyps[:n], (refs[:n] if kind == "refs" else [r[0] for r in refs[:n]])
    return [(preds[lo : lo + TEXT_BATCH], targets[lo : lo + TEXT_BATCH]) for lo in range(0, n, TEXT_BATCH)]


def text_result(torch, metric, value):
    """A text metric's value and states as CPU tensors (a list state by its
    concatenation)."""
    states = {}
    for name in metric._defaults:
        state = getattr(metric, name)
        states[name] = torch.cat([s.reshape(-1) for s in state]).cpu() if isinstance(state, list) else state.cpu()
    if isinstance(value, dict):
        value = {k: v.cpu() for k, v in value.items()}
    else:
        value = value.cpu()
    return {"value": value, "states": states}


def text_cpu_worker(index, labels, out_dir):
    """A spawned process: the text metrics ``labels[index::TEXT_CPU_WORKERS]``
    on the CPU over the same corpus."""
    import torch

    import metrics_tpu_torch as tm

    torch.set_num_threads(1)
    corpus = text_corpus()
    out = {}
    for label in labels[index::TEXT_CPU_WORKERS]:
        name, kwargs, _ = TEXT_METRICS[label]
        metric = getattr(tm, name)(device="cpu", **kwargs)
        for batch in text_batches(corpus, label):
            metric.update(*batch)
        out[label] = text_result(torch, metric, metric.compute())
    torch.save(out, os.path.join(out_dir, f"worker{index}.pt"))


def h2d_copies_per_update(torch, update, batches):
    """Host-to-device copies per ``update(batch)``, counted at PyTorch's
    dispatcher (every ``_to_copy``/``copy_`` from a CPU tensor to a CUDA
    one), with the device time per update and the memcpy rows that
    torch.profiler saw (a profiler window may miss an event, so it gates
    nothing)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    to_copy, copy_ = torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default

    class CountCopies(TorchDispatchMode):
        copies = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is to_copy or func is copy_:
                src, dst = (args[1], args[0]) if func is copy_ else (args[0], out)
                if isinstance(src, torch.Tensor) and src.device.type == "cpu" and dst.device.type == "cuda":
                    CountCopies.copies += 1
            return out

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, CountCopies():
        for batch in batches:
            update(batch)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    seen = sum(evt.count for evt in rows if "HtoD" in evt.key)
    device_us = sum(_self_device_us(evt) for evt in rows if evt.self_cpu_time_total == 0)
    n = len(batches)
    return CountCopies.copies / n, device_us / n / 1e3, seen / n


def same_text_result(torch, label, got, want):
    def same(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)

    value, cpu_value = got["value"], want["value"]
    if isinstance(cpu_value, dict):
        ok = set(value) == set(cpu_value) and all(same(value[k], cpu_value[k]) for k in cpu_value)
    else:
        ok = same(value, cpu_value)
    check(ok, f"text-corpus: {label}'s value on the card {value} differs from the CPU's {cpu_value}")
    for name, state in want["states"].items():
        check(same(got["states"][name], state), f"text-corpus: {label}'s state {name} differs between the card and the CPU")


def text_corpus_phase(torch, ops, card, tm):
    """text-corpus: BLEU, SacreBLEU (13a, char), chrF, chrF++, TER, EED,
    ROUGE, the WER family and SQuAD over the corpus on the card; each value
    and state bit-equal to the CPU run of spawned workers."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    labels = list(TEXT_METRICS)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_text_")
    workers = mp.start_processes(
        text_cpu_worker, args=(labels, out_dir), nprocs=TEXT_CPU_WORKERS, join=False, start_method="spawn"
    )
    try:
        t0 = time.perf_counter()
        corpus = text_corpus()
        corpus_s = time.perf_counter() - t0
        base = free_card(torch)
        ops.reset_launch_counts()
        report, results = {}, {}
        for label in labels:
            name, kwargs, _ = TEXT_METRICS[label]
            batches = text_batches(corpus, label)
            metric = getattr(tm, name)(device=TEXT_DEVICE, **kwargs)
            # the first two updates count host syncs, the next two the
            # copies (under the profiler); the rest are timed
            syncs = syncs_per_update(torch, lambda b: metric.update(*b), batches[:2])
            copies, device_ms, profiled = h2d_copies_per_update(torch, lambda b: metric.update(*b), batches[2:4])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in batches[4:]:
                metric.update(*batch)
            torch.cuda.synchronize()
            update_s = time.perf_counter() - t0
            value, compute_ms = timed(torch, metric.compute)
            sentences = sum(len(b[0]) for b in batches[4:])
            results[label] = text_result(torch, metric, value)
            shown = {k: float(v) for k, v in value.items()} if isinstance(value, dict) else float(value)
            report[label] = {
                "sentences": sum(len(b[0]) for b in batches),
                "timed_sentences": sentences,
                "sentences_per_s": sentences / (update_s + compute_ms / 1e3),
                "update_ms": update_s / (len(batches) - 4) * 1e3,
                "compute_ms": compute_ms,
                "h2d_copies_per_update": copies,
                "profiler_htod_rows_per_update": profiled,
                "host_syncs_per_update": syncs,
                "device_ms_per_update": device_ms,
                "state_bytes": state_bytes(metric),
                "value": shown,
            }
            check(syncs == 0, f"text-corpus: a {label} update synchronised {syncs} times")
            check(copies == 1, f"text-corpus: a {label} update made {copies} host-to-device copies, expected 1")
        card_s = time.perf_counter() - t_phase
        launches = {k: n for k, n in ops.launch_counts().items() if n}
        check(not launches, f"text-corpus: launches {launches}, expected none (no kernel of ours on this path)")
        peak = torch.cuda.max_memory_allocated()
        deadline = time.monotonic() + TEXT_TIMEOUT_S
        while not workers.join(timeout=2.0):
            check(time.monotonic() < deadline, f"text-corpus: the CPU workers still run after {TEXT_TIMEOUT_S} s")
    finally:
        for proc in workers.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
    cpu = {}
    for index in range(TEXT_CPU_WORKERS):
        cpu.update(torch.load(os.path.join(out_dir, f"worker{index}.pt")))
    shutil.rmtree(out_dir, ignore_errors=True)
    check(set(cpu) == set(labels), f"text-corpus: the CPU workers returned {sorted(cpu)}")
    for label in labels:
        same_text_result(torch, label, results[label], cpu[label])
    emit(
        {
            "phase": "text-corpus",
            "card": card,
            "pairs": TEXT_PAIRS,
            "slow_pairs": TEXT_SLOW_PAIRS,
            "batch": TEXT_BATCH,
            "corpus_seconds": corpus_s,
            "metrics": report,
            "card_leg_seconds": card_s,
            "cpu_workers_wait_seconds": time.perf_counter() - t_phase - card_s,
            "peak_memory_bytes": peak,
            "memory_at_start_bytes": base,
            "bit_equal_to_cpu": True,
            "seconds": time.perf_counter() - t_phase,
        }
    )


def bert_inputs(torch, vocab):
    """BASELINE config 5c's inputs on the card: 24 x 64 sequences of 128
    token ids ([CLS], 22-126 word pieces from ids 1000 up, [SEP], padding)
    and, as the references, the same sequences with 15% of the word pieces
    redrawn."""
    gen = torch.Generator(device=TEXT_DEVICE).manual_seed(BERT_SEED)
    n = BERT_BATCH * BERT_BATCHES
    lengths = torch.randint(24, BERT_SEQ + 1, (n,), generator=gen, device=TEXT_DEVICE)
    pos = torch.arange(BERT_SEQ, device=TEXT_DEVICE)[None]
    mask = (pos < lengths[:, None]).to(torch.int64)
    ids = torch.randint(1000, vocab, (n, BERT_SEQ), generator=gen, device=TEXT_DEVICE)
    ids = torch.where(pos == 0, 101, ids)
    ids = torch.where(pos == lengths[:, None] - 1, 102, ids)
    ids = ids * mask
    redraw = (torch.rand(ids.shape, generator=gen, device=TEXT_DEVICE) < 0.15) & (ids >= 1000)
    other = torch.randint(1000, vocab, ids.shape, generator=gen, device=TEXT_DEVICE)
    target = torch.where(redraw, other, ids)
    return {"input_ids": ids, "attention_mask": mask}, {"input_ids": target, "attention_mask": mask}


def bert_flops(config, batch, seq):
    """Multiply-adds x 2 of one encoder batch: the four projections and the
    two feed-forward products per token and layer, and the two attention
    products per sequence and layer."""
    h, i, layers = config.hidden_size, config.intermediate_size, config.num_hidden_layers
    per_layer = batch * seq * 2 * (4 * h * h + 2 * h * i) + batch * 4 * seq * seq * h
    return layers * per_layer


def bertscore_phase(torch, ops, card, tm):
    """bertscore-base: BERTScore at BERT-base widths on the card; the first
    batch against a float64 copy of the encoder on the card."""
    import copy

    from metrics_tpu_torch.functional.text.bert import bert_score
    from metrics_tpu_torch.models.bert import BertConfig, bert_forward, build_bert

    t_phase = time.perf_counter()
    base = free_card(torch)
    config = BertConfig(**BERT_WIDTHS)
    model, build_ms = timed(torch, lambda: build_bert(config, seed=BERT_SEED, device=torch.device(TEXT_DEVICE)))
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    preds, target = bert_inputs(torch, config.vocab_size)
    first = {k: v[:BERT_BATCH] for k, v in preds.items()}, {k: v[:BERT_BATCH] for k, v in target.items()}
    bert_score(*first, model=model, batch_size=BERT_BATCH, device=TEXT_DEVICE)  # warm-up (cuBLAS handles, the allocator)
    ops.reset_launch_counts()
    out, score_ms = timed(torch, lambda: bert_score(preds, target, model=model, batch_size=BERT_BATCH, device=TEXT_DEVICE))
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    check(not launches, f"bertscore-base: launches {launches}, expected none (no kernel of ours on this path)")
    pairs = BERT_BATCH * BERT_BATCHES
    for key in ("precision", "recall", "f1"):
        check(len(out[key]) == pairs and all(math.isfinite(x) for x in out[key]), f"bertscore-base: {key} is not {pairs} finite values")
    # the encoder alone, one batch: wall and device time
    ids, mask = first[0]["input_ids"], first[0]["attention_mask"]
    encoder_ms = median_ms(torch, lambda: bert_forward(model, ids, mask))
    profile = device_profile(torch, lambda i: bert_forward(model, ids, mask), 3, host_ops=False)
    flops = bert_flops(config, BERT_BATCH, BERT_SEQ)
    bound_ms = flops / FP32_FLOPS_PER_S * 1e3
    # the gate: the first batch against a float64 copy of the encoder on the card
    model64 = copy.deepcopy(model).to(torch.float64)
    exact = bert_score(*first, model=model64, batch_size=BERT_BATCH, device=TEXT_DEVICE)
    del model64
    gaps = {key: max(abs(a - b) for a, b in zip(out[key][:BERT_BATCH], exact[key])) for key in ("precision", "recall", "f1")}
    for key, gap in gaps.items():
        check(gap <= BERT_ATOL, f"bertscore-base: {key} of the first batch is {gap} off the float64 encoder's")
    # information: the last hidden state with TF32 on inside the encoder
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        with torch.no_grad():
            tf32 = model(ids, mask).last_hidden_state
    finally:
        matmul.allow_tf32 = saved
    full = bert_forward(model, ids, mask)[-1]
    tf32_gap = (tf32.double() - full.double()).abs()
    emit(
        {
            "phase": "bertscore-base",
            "card": card,
            "config": {"vocab": config.vocab_size, "hidden": config.hidden_size, "layers": config.num_hidden_layers,
                       "heads": config.num_attention_heads, "intermediate": config.intermediate_size, "seq": BERT_SEQ},
            "weight_bytes": weight_bytes,
            "build_ms": build_ms,
            "pairs": pairs,
            "bert_score_ms": score_ms,
            "pairs_per_s": pairs / (score_ms / 1e3),
            "encoder_batches": 2 * BERT_BATCHES,
            "encoder_ms_per_batch": encoder_ms,
            "encoder_device_ms_per_batch": profile["device_busy_ms_per_step"],
            "encoder_idle_share": 1 - profile["device_busy_ms_per_step"] / encoder_ms,
            "encoder_top_device_us": profile["device_us_per_step_by_kernel"],
            "encoder_gflop_per_batch": flops / 1e9,
            "encoder_fp32_bound_ms": bound_ms,
            "encoder_share_of_fp32_peak": bound_ms / profile["device_busy_ms_per_step"],
            "first_batch_gap_to_float64": gaps,
            "tolerance": BERT_ATOL,
            "tf32_gap_last_hidden": {"max_abs": float(tf32_gap.max()), "max_rel_of_max": float(tf32_gap.max() / full.abs().max())},
            "mean_f1": float(np.mean(out["f1"])),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "memory_at_start_bytes": base,
            "seconds": time.perf_counter() - t_phase,
        }
    )


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
    # the fused update on CUDA graphs against the eager update, and the
    # async pipeline against the blocking fused update
    fused_classification_phase(torch, ops, card, tm)
    fused_flagship_phase(torch, ops, card, tm, preds_all, target_all)
    fused_sketch_phase(torch, ops, card, tm)
    fused_sliced_windowed_phase(torch, ops, card, tm, SlicedMetric, WindowedMetric)
    fused_retrieval_phase(torch, ops, card, MetricCollection)
    async_phase(torch, ops, card, tm)
    # the regression family, half-precision sketch leaves, the ring of sketches
    depth = regression_depth_phase(torch, ops, card, tm)
    sketch_bf16_phase(torch, ops, card, tm)
    windowed_sketch_phase(torch, ops, card, tm, WindowedMetric, depth)
    del depth
    # the wrappers, the aggregators and a composition; pairwise functionals
    wrappers_flagship_phase(torch, ops, card, tm, preds_all, target_all)
    bootstrap_auroc_phase(torch, ops, card, tm)
    multioutput_regression_phase(torch, ops, card, tm)
    pairwise_embeddings_phase(torch, ops, card, tm)
    # cross-process sync: 2 ranks (the families), 8 (the bundle), NCCL alone
    sync_launches = sync_phases(torch, card)
    nccl_world1_phase(torch, card)
    # the image family: SSIM/MS-SSIM/UQI (config 5), FID/KID/IS on the
    # InceptionV3 (config 5b), LPIPS; no kernel of ours on their paths
    ssim_phase(torch, ops, card, tm)
    fid_inception_phase(torch, ops, card, tm)
    lpips_phase(torch, ops, card, tm)
    # sliced classification on probability rows (the vmapped top-1 mask)
    sliced_probability_phase(torch, ops, card, tm)
    # the text family: host string handling with float32 count states on
    # the card (no kernel of ours), and BERTScore at BERT-base widths
    text_corpus_phase(torch, ops, card, tm)
    bertscore_phase(torch, ops, card, tm)
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
    # each kernel's launches inside the sync phases' syncs, by phase and rank
    for entry in kernels:
        entry["sync_launches"] = sync_launches.get(entry["name"], {})
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
