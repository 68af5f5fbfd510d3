#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # full HHAR scale, needs one CUDA card
    python3 chip_smoke.py --rows 400000 --series 64 --long-series 2
                                     # a quicker run

Phases (each raises on failure, and the script then exits non-zero):

A. Build the ten CUDA sources of ``tempo_tpu_torch/csrc`` (one nvcc
   per source, in parallel; ``ring.cuh`` is a header of three of them)
   and print the build seconds.
B. Hold each kernel against its plain PyTorch version on the card, in
   float32, at the shapes the main paths give it: the merge join
   bitwise, against the plain version and the row walk's CPU mirror
   (``asof_merge_walk_plain``), at the HHAR shape (index form, the row
   walk), phase D's value form, bin-packed rows (sid fence) and a
   sequence tie-break through both forms (row walk and tiles), skipNulls
   both ways, and few long rows ([8, 25000], the tiles by the shape
   pick); range stats, both forms, bitwise in all seven stats and
   ``clipped`` against the plain version run at the kernel's own centres
   (``_center_out``), at the HHAR shape, on a forward window with bounds
   small enough to clip both ways, and (row form) on 8 of phase F's rows
   at the six-hour bounds, and ``count``/``clipped`` bitwise, the rest
   within 1e-5 (``stddev`` as the variance; ``sum`` within 2e-3 on the
   six-hour rows) of the plain version's own centre, the row form timed
   at the HHAR shape and at phase F's six-hour shape and split into its
   two kernels; the EMA ladder bitwise against the plain version and
   its tiled mirror (``ema_tiled_plain``), alpha 0.2 and 1, at the HHAR
   shape, phase D's, the one-launch limit of 16,384 lanes and rows of
   T * 2^j + 1 lanes with -0.0, NaN and +-inf (phase F's rows in the
   third slice's part).  Print kernel, plain and library times
   (``torch.searchsorted`` for the join's last-row index, timed here
   only as a yardstick; the port never calls it).  Then the
   second slice's kernels, all bitwise: the valid-index scans on the
   masks of the 1-second interpolation grid of the right frame (rows of
   19,304 bytes: every other one starts 8 bytes into a 16-byte word) and
   on that mask cut into rows of 1003 lanes from byte 8,
   ``last_valid_scan`` on its packed ``wx`` column and on rows of 1003
   lanes from byte 8 of the mask and lane 2 of x, and ``resample_ema``
   (both forms, also against its tiled mirror ``resample_ema_tiled_plain``)
   at its packed shape, on seconds shifted before 1970 with a scale, on
   phase F's long rows (steps 60 and 7), and on rows of 16,384 lanes (the
   one-launch limit) and 16,385 (two launches), each timed
   (``torch.cummax`` of the candidate lanes is the last-valid-index
   yardstick).  Then the
   third slice's kernels, all bitwise, at phase F's packed shape: the
   lookback merge at ``max_lookback`` 0, 1, 4 and 16, ``skipNulls`` both
   ways (at 0 also against the merge kernel), its value form, a
   tie-heavy case, runs of equal keys longer than a tile and, at smaller
   shapes, bin-packed rows (sid fence; also with every series boundary on
   a tile edge, at the kernel's tiles and at 16) and a sequence
   tie-break (also at tiles of 4), and its time on one series of
   1,000,000 rows; the rank on the windowed engine's int32 seconds and
   on int64 nanoseconds, both sides, pads clamped, on runs of equal keys
   longer than a tile, on [4, 10^6] keys x [4, 10^3] queries and the
   reverse, and on one series of 2^24 + 1 keys, each timed beside its
   bound (``torch.searchsorted`` is its yardstick); ``cumsum3`` on a one-tile row, a row of 8193
   lanes (T * 2^3 + 1), the same with -0.0, NaN and +-inf, phase D's
   [K, 8192] and phase F's row, against the plain ladder and the tiled
   plain version, each timed beside ``torch.cumsum``; the EMA ladder's
   two-stage form on phase F's rows, bitwise, timed and split by kernel.
   Then the fourth slice's legacy stats kernel: ``count``, ``min``,
   ``max`` and ``clipped`` bitwise, the rest as range stats are held, on
   the HHAR left frame's packed ``x`` with the row bounds of a 10 s and
   a 60 s window, on a two-column stack, on tie-heavy keys with
   bounds (4, 1) that clip both ways, with bounds (600, 40) on 64 of
   the series (a halo past one window) and with a valid NaN in four rows
   (NaN centres, finite windows away from it), and every stat bitwise
   against the plain version at the kernel's centres (no library call
   computes it).
   Then the fifth slice's bucket-stats kernel: ``count``, ``min`` and
   ``max`` bitwise, the rest as range stats are held, on phase H's
   inputs (the HHAR left frame's 1-minute bucket ids over x, the joined
   right_wx and EMA_x, from the mesh chain on the card: [3, 1024,
   12760]), on x alone, on x with 30% more nulls, on a [64, 4096] case
   with pad lanes, an all-null and an all-pad row, on x in hourly buckets
   (about 2,400 lanes) and on phase F's long rows in 1-minute buckets and
   in one bucket a row; no library call computes it.  Every case also
   holds the row form bitwise against its tiled mirror
   (``bucket_stats_tiled_plain``, run on the card with the kernel's
   centres) and runs the staged form at the default ring depth, bitwise
   equal to the row form (rows with a bucket longer than 1024 lanes
   left to the row form, and counted); the row form is timed at each
   shape and split by kernel.
   Then the staging ring (``csrc/ring.cuh``, the port of
   ``pallas_stream._make_ring_kernel``) in each of its three users at its
   main-path shape (range stats at phase C's [1, 1024, 12760], the
   resample EMA at phase E's [1024, 12760], bucket stats at phase H's
   [3, 1024, 12760]), at ``TEMPO_TPU_DMA_BUFFERS`` 2, 3 and 8 (set
   in-process and restored): the staged form bitwise equal to the row
   form and to itself across depths, within the row form's tolerance of
   the plain version, the kernel's shared-memory total equal to the
   planner's (``ops/stream.py``); each depth timed beside the row form,
   with the tile and depth the planner chose.  Then one row just past each
   limit the kernels had before their class stages could run windowed and
   before range stats counted clipped lanes in integers: the EMA and the
   resample EMA at [1, 14,876,673], ``cumsum3`` at [1, 9,917,441] (bitwise
   against the plain versions and the tiled mirrors, the EMA also at alpha
   0.001, where the class stages show in the bits), bucket stats' row form
   at [1, 4,958,209] in 1-minute buckets, one bucket a row and buckets of
   300,000 lanes (count/min/max bitwise against the plain version, every
   output against the tiled mirror at the kernel's centres) and range
   stats, both forms, at [1, 2^24 + 1] and [1, 2^24 + 5] with every lane
   clipped (bitwise at the kernel's centres, ``clipped`` equal to the exact
   count rounded once to float32), each timed beside its bound.
C. The main path at full scale, as a user calls it: pandas frames shaped
   like the reference quickstart's HHAR phone<->watch join (13,062,475
   rows a side, 1024 series) -> ``TSDF`` -> ``asofJoin`` ->
   ``withRangeStats`` (10 s range window; the frame asserts the kernel's
   ``clipped`` audit is zero) -> exact ``EMA`` -> pandas.  The launch
   counters are zeroed just before and read just after; every kernel
   must have launched.  A small slice of the same data is checked
   against the plain versions (``device="cpu"``, float64).
D. ``entry.forward_step`` at [1024, 8192], its counters read the same
   way, ``clipped`` zero, its range stats (20 rows behind, 8 ahead) and
   EMA held against the plain versions on the same card tensors.
E. The resample / interpolate path at the same scale on the right
   (watch) frame, 5% null ``wx``: ``resample("1 second", "mean")
   .interpolate(method="linear")``, ``resampleEMA("1 minute", "wx")``
   and the public op ``ops.last_valid_scan`` on the packed column, the
   counters zeroed before and read after; each of the four kernels must
   have launched.  Then, on 8 users, all five fills (and the
   ``TSDF.interpolate`` form of the linear one) and ``resampleEMA`` on
   the card (float32) against ``device="cpu"`` (float64): timestamps,
   keys and flags equal, values within 1e-4.
F. The third slice at full width: the same 13,062,475 rows a side over
   128 series (102,050 rows each) -> ``TSDF`` -> ``asofJoin(maxLookback=
   16)`` (204,112 merged lanes pass the single-program limit, so the
   auto pick takes the ``chunked`` engine: the lookback kernel) ->
   ``withRangeStats`` over one day (about 57,600 rows of extent, past
   ``TEMPO_TPU_STREAM_MAX_ROWS``: the windowed engine, two rank launches
   and ``cumsum3``) -> exact ``EMA`` -> pandas, the counters zeroed
   before and read after.  Then 8 of the series on the card (float32)
   against ``device="cpu"`` (float64): joins and counts equal, the
   statistics and the EMA within 1e-4, ``sum`` within 2e-3: it is the
   difference of two float32 prefix sums of ~100,000 centred values,
   which reach a few hundred (float32 spacing ~3e-5), each rounded at
   17 ladder levels, plus the float32 centre times a count of ~57,600;
   a quick run (2 series of 200,000 rows) measured 1.3e-3.  Then, on
   the same long rows, a six-hour ``withRangeStats`` (about 14,400 rows
   of extent: no ring slot holds the halo) and ``resampleEMA("1
   minute", "x")`` (past the ladder's one-launch limit, two launches),
   both counted: they must take the row forms.
G. The fourth slice on the HHAR left frame (13,062,475 rows, 1024
   series), each step timed with the card synchronised and the counters
   zeroed before and read after: ``withRangeStats`` (10 s) under
   ``TEMPO_TPU_WINDOW_ENGINE=legacy`` (the legacy kernel must launch and
   the row-bounded one must not; held against the same call under auto:
   ``count`` equal, the rest within 1e-5), ``withGroupedStats("1
   minute")``, ``vwap("m")`` on a trades-shaped copy (``price = 100 +
   |x|``, seeded volumes 1-999), ``describe``, ``autocorr("x", 1)``,
   ``fourier_transform(1, "x")``, ``lookbackTensor(["x"], 10)``, and
   ``filter("x > 0")`` then ``selectExpr``.  Then, on 8 users, each step
   and ``withLookbackFeatures`` (it builds a Python list per row, so it
   runs on the 8 users only) on the card (float32) against
   ``device="cpu"`` (float64): keys, timestamps, counts and the host
   steps equal, values within 1e-4, the FFT within 1e-5 * ||x||_2 a
   series (``fft_tolerance``).  ``withGroupedStats``, ``vwap`` and
   ``resample("1 minute", "mean")`` called twice on the card must be
   bitwise equal (segment sums in a fixed order).
H. The fifth slice: the series-sharded ``DistributedTSDF`` on
   ``make_mesh()`` (one shard on the card) at HHAR scale:
   ``left.on_mesh().asofJoin(right.on_mesh())`` -> ``withRangeStats``
   (10 s) -> exact ``EMA`` -> ``withGroupedStats`` of x, right_wx and
   EMA_x by the minute -> ``collect()``, each step timed with the card
   synchronised, beside phase C's chain seconds of the same run; the
   counters zeroed before and read after: the merge and EMA kernels and
   the staged range-stats and bucket-stats forms must launch, with 2
   packs and 1 fetch; ``on_mesh()`` with no mesh must take
   ``make_mesh()``.  The chain again under ``TEMPO_TPU_DMA_BUFFERS=4``
   must equal it bitwise, and ``withGroupedStats("1 hour")`` of its x
   (buckets of about 2,400 lanes) must leave its rows to the bucket row
   form.  Then
   ``resample("1 minute", "mean").interpolate(method="linear")`` of the
   EMA frame still on the card and ``vwap("m")`` of phase G's trades
   copy (1 pack, 2 fetches).  Then, on 64 users, the same three chains
   on two shards of cuda:0 (bitwise equal to one shard) and on a CPU
   mesh (float64): keys, timestamps and counts equal, values within
   1e-4, stddev as the variance.

I. One series of 2^24 + 1 rows, one a second, 5% null x, on the card:
   ``withRangeStats`` (10 s) -> exact ``EMA``, the counters zeroed before
   and read after: each row's count equals the valid rows of its 11
   seconds and ``EMA_x`` is bitwise the plain ladder's.

J. The sixth slice: the native packer, checkpoints, the store and Parquet
   ingest.  a. Build the C++ packer (``tempo_tpu_torch/native``) and
   print the compiler's version line and ``TEMPO_TPU_NATIVE_THREADS``.
   b. On phase C's two frames and phase F's two frames: ``_sort_layout``,
   ``take``, ``pack_column`` and ``unpack_column`` (host), native, numpy
   (``TEMPO_TPU_NATIVE=0``) and native again, each timed, the native
   results bitwise the numpy ones.  c. Phases C and H ran on the native
   packer (the default); their chains again under ``TEMPO_TPU_NATIVE=0``
   must give bitwise the same frames, both wall times printed step by
   step.  d. ``io.ingest.sweep_slabs`` over phase H's left frame in 8
   slabs of series (load: a host pack; compute: one upload, then
   ``withRangeStats`` (10 s) and exact ``EMA`` on the card, read from the
   launch counters; drain: a fetch) at ring depths 1, 2 and 3, bitwise
   equal.  e. ``checkpoint.save_state`` of the planes of phase H's mesh
   frame: a flipped byte in one array raises ``CheckpointError`` naming
   it; a clean copy, loaded and uploaded, equals the planes bitwise.
   f. Where pyarrow is installed: ``checkpoint.save``/``load`` of phase
   H's joined mesh frame onto ``make_mesh()``, the chain continued
   bitwise; ``TSDF.write`` of 64 users -> ``io.ingest.from_parquet`` onto
   ``make_mesh()`` -> ``collect`` equal to the source (x as float32).
   Without pyarrow one line says these parts did not run.

K. The seventh slice: the mesh's time axis on one card (four mesh
   entries of cuda:0) at HHAR scale.  a. Phase H's chain on
   ``make_mesh({"series": 2, "time": 2})`` and ``{"series": 1, "time":
   4}`` with ``time_axis="time"``, each step timed with the card
   synchronised beside phase H's; the counters must show the merge join,
   a range-stats form, the EMA ladder and a bucket-stats form, with 2
   packs and 1 fetch; against phase H's frame of the same run, the
   join's columns and the range stats bitwise, ``EMA_x`` (ladder a time
   block plus a ``torch.cumprod`` carry) and its grouped stats within
   1e-5; ``relayout_comm_bytes`` of the two layout switches printed.
   b. ``withRangeStats(strategy="halo")`` at ``halo_fraction`` 0.5 on
   the ``time: 4`` mesh: the rank and ``cumsum3`` kernels launch; the
   audit's count printed; on every row the audit leaves uncut, counts
   equal the exact strategy's, mean, min, max and zscore within 1e-5,
   sum within 1e-4 and the variance within 2e-3 (the windowed engine's
   sums are differences of float32 prefix sums over the extended
   block).
   c. ``reshard_frame`` there and back on the ``series: 2, time: 2``
   frame, every plane bitwise; phase H's tail (resample -> interpolate,
   vwap) on that mesh equals phase H's (EMA_x within 1e-5).  d. Two
   gloo ranks, subprocesses of this script (``--rank-worker``), each
   with its shards on cuda:0 and a 240 s timeout: ``distributed_init``
   -> ``process_series_range`` -> ``shard_series_global`` -> phase H's
   chain on 64 users over a ``series: 2`` mesh spread over both ranks;
   what each rank collects equals one process's run bitwise.
   e. The same ranks save the 64-user frame as one sharded checkpoint
   (``shard_p0`` / ``shard_p1``, a manifest with ``n_processes`` 2) and
   load it, then run ``run_resumable(sharded=True)`` (range stats, EMA,
   resample) killed by ``testing.faults`` while both save step 2, and
   resume it from step 1: each rank's collects bitwise one process's.

L. The planner (``TEMPO_TPU_PLAN=1``) at HHAR scale.  a. The planned
   ``on_mesh -> asofJoin -> withRangeStats(10 s) -> EMA`` on
   ``make_mesh()``: ``explain()`` shows one ``fused_asof_stats_ema``
   node; the first call builds the plan and captures the node as a CUDA
   graph, the second hits the cache and replays it (no capture, no
   kernel build); every plane of both results is bitwise phase H's; the
   calls' wall seconds beside phase H's steps to the EMA, and the
   graph pool's bytes.  b. ``resample(floor) -> EMA(exact)`` on the
   right frame fuses onto ``resampleEMA`` and equals it bitwise.  c. A
   stitched ``resample -> interpolate -> EMA -> withRangeStats`` run,
   captured then replayed, every plane bitwise the op-by-op chain's.
   d. A checkpointed plan on 64 users killed while saving its second
   barrier resumes from the first, bitwise the uninterrupted run.  e.
   ``filter`` / ``selectExpr`` lowered through ``plan/sql_compile.py``,
   equal to the eager frame.  Then the cost priors of ``plan/cost.py``
   measured on the card (``L cost priors``).

M. Serving one stream (``tempo_tpu_torch.serve``), the launch counters
   zeroed just before each stream's warm-up and read just after its last
   push, before its batch operators run: the streams must launch
   ``ema_scan`` (their graphs' warm-up and capture runs: a replay goes
   through no wrapper, so the traced M.b pushes must show the kernel on
   the card once a right push).  The batch operators' launches are
   counted apart and must include the lookback and merge kernels.
   a. The reference benchmark's config 11
   verbatim (``bench.py`` ``bench_serving``: 16 series, bid/ask, a 10 s
   window of at most 32 rows, EMA 0.2, ``maxLookback`` 64,
   ``MicroBatchExecutor(batch_rows=16)``, ``warmup(16)``, 600 warm and
   4,000 measured Poisson ticks, 25% left, 5% NaN, seed 11): zero builds
   and captures over the measured part, ``clipped`` 0, every emission
   bitwise the batch operators on the card over the concatenated stream
   (``sortmerge.asof_merge_values``, row 4's lookback kernel;
   ``window_stats_batch``; ``ema_scan`` over the whole history); ticks/s
   and p50/p99 per side.  b. Phase C's 1024 series as one stream: the
   first 1,048,576 right (watch ``wx``) rows in time order and the left
   (phone) rows up to the last of them, each series in merged order,
   pushed straight in side-homogeneous batches of at most 64 rows a
   series (10 s window of at most 64 rows, EMA 0.2, ``maxLookback`` 16):
   the same checks, events/s, the share of host time in admission, the
   replays and the CUDA graphs' pool bytes.  c. The first 262,144 right
   rows of b. and their left rows at ``maxLookback`` 0, ``skip_nulls``
   both ways, bitwise ``sortmerge.asof_merge_values`` (row 1's merge
   kernel).
N. Serving cohorts (``tempo_tpu_torch.serve.StreamCohort``).  a. The
   reference benchmark's config 14 verbatim: 10,240 single-series
   streams, a 10 s window of <= 8 rows, EMA 0.2, ``maxLookback`` 32,
   ``CohortExecutor(batch_rows=32, queue_depth=64, coalesce_s=0.004)``
   after ``warmup(32)``, 4,000 warm and 40,000 measured Poisson ticks in
   ``submit_many`` chunks of 2,048; zero builds and captures measured,
   ``clipped`` 0, every stream driven, 64 sampled streams' emissions
   bitwise the batch operators on the card; aggregate ticks/s, per-ticket
   p50/p99, the graphs' pool bytes; then the same mix through 10,240
   ``StreamingTSDF``s (the median of three windows of 500 pushes) and
   the ratio.  b. The same mix through ``submit_block`` after
   ``warmup(32, max_block=2048)``: bitwise a.'s results, zero builds and
   captures, the block programs' route counted.  c. 2,048 streams over a
   ``["cuda:0"] * 2`` stream mesh bitwise a meshless cohort, capacity
   rounded to the axis, ``parallel.mesh.transfer`` never called, and a
   traced window whose only device-to-device copies are the shards' own
   graph replays'.  d. The spill tier at a resident budget of 1/8 of
   1,024 streams, bitwise an unspilled cohort.  e. Differential
   snapshots, a kill inside a dispatch of the executor's worker
   (``testing.faults``), ``CohortExecutor.resume`` and the tails
   replayed byte for byte; a full and a differential snapshot's bytes.
   200 of a.'s dispatches run traced: ``ema_scan_kernel`` once a right
   dispatch.

O. The query service (``tempo_tpu_torch.service``).  a. A cold race
   first: two tenants submit two new mesh signatures at once (a fused
   join -> stats -> EMA node and a stitched resample -> interpolate ->
   EMA -> stats node, each captured as a CUDA graph) on two workers of
   ``QueryService(workers=4)`` while two more tenants keep host queries
   running; both succeed, two captures, bitwise their eager twins.  Then
   the reference benchmark's config 13 (``bench.py``
   ``bench_query_service``): 8 tenant threads x 24 queries (join,
   join_stats, stats_ema over shared [8, 512] frames, exponential gaps
   at a 2 ms mean) after one warm-up a shape; qps, per-tenant p50/p99,
   the cache hit rate, the starvation ratio (<= 1.5), zero builds and
   captures measured, every answer bitwise its warm-up twin and every
   warm-up bitwise the eager chain on the card; the measured phase once
   more traced.  b. Phase L.a's chain at HHAR scale through ``submit``
   under an ``hbm_budget`` of the card's free memory: every plane
   bitwise phase L.a's (phase H's), the projected ``Footprint`` beside
   the measured peak, and the projection under the default 2 GiB.  c.
   Config 19 (``bench_sql``): three SQL statements x 40 rounds through
   ``submit_sql`` at [8, 2048], bitwise their planned twins and the
   eager frames, zero builds, ``explain`` showing ``sql_filter`` /
   ``sql_project`` with ``eval[sql]=``.  d. The fault domain, each case
   counted in ``stats()``: a query over the shared-memory budget
   rejected by name, one over the free device memory queued then run, a
   poisoned signature quarantined after ``TEMPO_TPU_BREAKER_THRESHOLD``
   failures, a deadline named by its stage, ``close(timeout)`` draining.
   Before a., admission's shared memory a block is held to the kernels'
   own figures (``cuda_lib.range_row_smem`` and the like).
P. Standing queries (``tempo_tpu_torch.query``): the reference
   benchmark's config 20 (``bench_standing``) at its published counts,
   1,536 delta subscriptions (EMA at alpha 0.2 and 0.35), 384 stateless
   and 128 remainder over one ``StreamTable`` on the card, 6 warm-up and
   24 measured pushes of 128 rows on a Poisson timeline: pushes/s,
   rows/s, notifications/s, p50/p99 a push, registrations/s, the
   planes' graph pool bytes, zero builds and captures measured,
   ``dropped``, sampled results (delta at both alphas, stateless,
   remainder) bitwise the batch re-run of the canonical plan, whose
   ``ema_stream`` launches ``ema_scan``; one more push traced.  Then a
   join-delta subscription over two tables bitwise its batch twin, a
   ``snapshot_subscription`` / ``resume_subscription`` round trip with a
   byte-identical tail, and a ``sync_to_store`` round trip equal to its
   pandas twin.  The batch twins' launches are counted apart from the
   standing engine's and must include ``ema_scan`` and
   ``asof_merge_lookback``.

Traces: phases C and H wrap pack, join, stats, EMA and collect in
``profiling.annotate`` spans; one extra run each of C's chain, H's
chain, L.a's cache hit, L.c's op-by-op run and 200 pushes of M.b's
steady state runs under ``profiling.trace`` (the timed runs stay
untraced; M.b's pushes in a child process, ``--trace-worker``, whose
trace is its first: a long process's later profiling runs lose device
records), and for each the script prints the top 10 device kernels and
copies, the top 10 host spans, the host<->device copy bytes and time,
and the card's busy share of the traced window (``trace_summary``).
Phase B also holds ``ema_scan`` (``csrc/ema_scan.cu``) against its plain
version bitwise at [2, 1024, 4096], M.b's push shape [2, 1024, 64],
[1, 16, 64], [10240, 8] (phase N's cohort step), [2100, 333], [4100, 5],
float64 [3, 700, 1366] and [1, 2^20] (plain on the CPU there), with split
runs bitwise one run, and times each shape eagerly and as CUDA-graph
replays in turns with the kernel's earlier form
(``csrc/yardstick/ema_scan_warp.cu``, built apart), beside its byte
bound and its chain bound (a one-thread probe's step times L, with
``clocks.sm``).

Q. The chaos campaigns (``tempo_tpu_torch.testing.chaos``) on the card:
   ``run_campaign``'s two planes at the reference bench's config 15
   size (48 streams x 80 events), each between its own counter reads;
   ``run_store_campaign`` at config 17's (200,000 rows in 20,000-row
   segments, 64 streams over a resident budget of 12, 24 events a
   stream); ``run_pipeline_campaign`` at config 16's slab (4,000,000
   physical rows, 32 keys) on a mesh of four ``cuda:0`` entries, so the
   ingest kill lands between shards of one card, its sweep cut to 8
   slabs (``rows_total`` 32,000,000, a barrier every 3 slabs and 6
   windows, against the reference's 10^9, 10 and 8: in 8 slabs only
   fewer than 7 windows all compile before the kill; each cut printed
   beside it).  Each campaign asserts its own invariants (no hung
   ticket, bounded recovery, zero new builds and captures after
   recovery, bitwise tails and resumed artifacts, refusals by name, no
   capture left open by a kill), and must have launched its kernels on
   the card: serving ``ema_scan``, the service the EMA ladder, the
   pipeline the merge join, range stats (by the engine its shape picks)
   and the EMA ladder.  These launches are printed apart, never added to
   the main paths' counts.
R. The tuner on the card: the smoke sweep (``python -m
   tempo_tpu_torch.tune --smoke``, ``stream_medium`` and ``serve_batch``
   in child processes) writing a profile to a temporary directory, run
   beside phase Q (its children share the card with the campaigns; the
   sweep's audits, not its rates, are what this phase checks): zero
   audit failures and exit 0, then a ``strict`` load of that profile,
   with ``ops.stream.dma_buffers()`` and ``MicroBatchExecutor``'s
   ``batch_rows`` returning its knobs, then a ``strict`` load of the
   checked-in profile of this card (``tempo_tpu_torch/tune/profiles/``),
   printing its knobs and ``measured``.  Every earlier phase ran under
   that checked-in profile, as a user's process does.  Then the two
   stream classes' probe in this process at ring depths 2-8 (rates, the
   plan each depth ran, bitwise across depths).  Last, a saxpy
   stream rate over a 256 MiB plane, and ``profiling.window_roofline``
   of phase B's staged range stats at the HHAR shape (row 2, at each
   depth and at the profile's) against it.

S. The compiled contracts (``tempo_tpu_torch/plan/contracts.py``) on the
   card: ``build_all`` builds every registry program at its contract
   shape on a mesh of eight entries of the card (the fused and service
   nodes, the serving, cohort and standing steps captured as CUDA
   graphs), then every rule of ``plan/contract_rules.py``: zero findings
   beyond the declared barriers.  One line a program: its graphs' node
   counts by type, kernel nodes by name and memcpy bytes by direction
   (``profiling.graph_nodes``, the graph walk through libcuda), or its eager
   record, and the bytes moved between mesh entries against the model.
   The fused and ``service.dispatch_ema`` graphs must name the merge
   join's, range stats' and the EMA ladder's kernels, the serving and
   standing steps' ``ema_scan_kernel``.  Then two planted programs must
   be flagged: a capture copying a pinned host tensor with
   ``non_blocking=True`` (``no-host-transfer``) and a float64 [8, 32] op
   (``no-f64-leak``).  Phase L.a's captured node and phase M.b's push
   step are walked the same way on their own lines (the fused node's
   kernels and ``ema_scan_kernel``), the first check that a replayed
   graph runs the port's kernels.  Phase O.b holds admission's
   projection (``service.admission.project_footprint``: the reference's
   model plus the fused graph's bytes, estimated with the cache cold,
   read from the cached graph after a hit) against the measured peaks of
   a cold and a hit run: each peak must be at most its projection.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line
(each kernel's launches summed over the main-path runs of phases C, E,
F, G's legacy step, H, I, K, M, N, O and P, ``ema_scan``'s phase P
share also as ``launches_phase_p``; the staged forms' rows, one a
depth, name their counter; phase L's planned runs are not counted: a
replayed graph launches through no wrapper, and phases M, N and P's
``ema_scan`` counts their streams', cohorts' and standing planes'
warm-up and capture runs, not the batch operators' nor the batch twins',
which are counted apart and printed apart),
and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository's ``tempo_tpu_torch`` package
beside it, it prints no result and exits with 2.
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
NS = 1_000_000_000
# the kernels each main path must launch: phases C and D, phase E (the
# staged forms of range stats and the resample EMA at these widths)
SLICE1_KERNELS = ("asof_merge", "range_stats_ring", "ema_ladder")
SLICE2_KERNELS = ("last_valid_index", "first_valid_index",
                  "last_valid_scan", "resample_ema_ring")
# the staging ring's depths held against each other and the row forms
RING_DEPTHS = (2, 3, 8)
# the bucket-stats staged form's times PERF.md records (ms at depths 2, 3
# and 8, NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's
RING_PERF_MD_MS = {"bucket_stats": {2: 0.99141, 3: 1.16508, 8: 1.81517}}
SLICE3_KERNELS = ("asof_merge_lookback", "merge_rank", "cumsum3",
                  "ema_ladder")
LOOKBACK = 16                 # bench.py's serve-bench maxLookback
CONTRACT_PLANT = (8, 32)      # phase S's planted programs: [K, L]
DAY = 86_400


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after a
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def env_set(name: str, value):
    """The environment variable ``name`` set to ``value`` inside, restored
    after."""
    old = os.environ.get(name)
    os.environ[name] = str(value)
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def dma_depth(depth):
    """``TEMPO_TPU_DMA_BUFFERS`` set to ``depth`` inside, restored after."""
    return env_set("TEMPO_TPU_DMA_BUFFERS", depth)


def native_off():
    """``TEMPO_TPU_NATIVE=0`` inside (packing's numpy path), restored
    after."""
    return env_set("TEMPO_TPU_NATIVE", 0)


def check_same(got, want, what: str) -> None:
    """Raise unless two kernel outputs (tensors, or dicts / tuples of
    them) are bitwise equal, floats compared as their bits."""
    if isinstance(got, dict):
        for k in want:
            check_same(got[k], want[k], f"{what} {k}")
    elif isinstance(got, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            check_same(g, w, f"{what} [{i}]")
    else:
        check_bitwise(got, want, what)


def ring_rows(user, run, row_out, want, check, row, kernel_src, smem_args):
    """The staged form of ``user`` (``run()``, its wrapper forced to the
    staged form) at each of ``RING_DEPTHS``: bitwise equal to the row
    form's output ``row_out`` and to itself across depths, within
    ``check`` of the plain version's ``want``; timed at each depth; the
    kernel's own shared-memory total (``tempo_*_ring_smem`` at
    ``smem_args(plan)``) equal to the planner's.  Returns its rows of the
    result line, beside the row form's ``row`` (same work, so the same
    bound and plain time)."""
    from tempo_tpu_torch.ops import cuda_lib, stream

    smem = getattr(cuda_lib.lib(), {"bucket_stats": "tempo_bucket_ring_smem",
                                    "range_stats": "tempo_range_ring_smem",
                                    "resample_ema": "tempo_resample_ring_smem"
                                    }[user])
    rows, first, notes = {}, None, []
    for depth in RING_DEPTHS:
        with dma_depth(depth):
            got = run()
            torch.cuda.synchronize()
            plan = dict(stream.last_plan[user])
            if plan["form"] != "ring":
                raise AssertionError(f"{user}: no staged plan at depth "
                                     f"{depth}")
            check_same(got, row_out, f"{user} staged (depth {depth}) against "
                                     f"its row form")
            if first is not None:
                check_same(got, first, f"{user} staged depth {depth} against "
                                       f"depth {RING_DEPTHS[0]}")
            first = got
            if smem(*smem_args(plan)) != plan["smem"]:
                raise AssertionError(f"{user}: the kernel's shared memory "
                                     f"differs from the planner's {plan}")
            err = check(got, want, f"{user} staged depth {depth}")
            ms = time_ms(run)
        name = f"{user}_ring_d{depth}"
        rows[name] = dict(
            name=name, counter=f"{user}_ring", route="cuda",
            source="tempo_tpu_torch/csrc/ring.cuh",
            replaces="tempo_tpu/ops/pallas_stream.py:170",
            max_abs_err=err, ms=ms, plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, kernel=kernel_src, depth_asked=depth,
            depth=plan["depth"], tile=plan["tile"], smem=plan["smem"],
            blocks=plan.get("blocks"), items=plan.get("items"),
            long_rows=plan.get("long_rows"), row_form_ms=row["ms"],
            shape=row["shape"])
        if user in RING_PERF_MD_MS:
            rows[name]["perf_md_ms"] = RING_PERF_MD_MS[user][depth]
        notes.append(f"depth {depth}: T={plan['tile']} x {plan['depth']} "
                     f"slots, {plan['smem']} B"
                     + (f", {plan['blocks']} blocks of at most "
                        f"{plan['items']} items" if "blocks" in plan else "")
                     + f", {ms:.4f} ms"
                     + (f" (PERF.md {RING_PERF_MD_MS[user][depth]})"
                        if user in RING_PERF_MD_MS else "")
                     + (f", {plan['long_rows']} long-bucket rows"
                        if "long_rows" in plan else ""))
    log(f"B ring {user}: staged form bitwise equal to the row form and "
        f"across depths {RING_DEPTHS}, within the stated tolerance of the "
        f"plain version; " + "; ".join(notes) + f"; row form "
        f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms; the kernel's "
        f"shared-memory total agrees with the planner's")
    return rows


def stage_ms(fn, reps: int = 5) -> dict:
    """Device milliseconds a call of ``fn()`` spends in each of its CUDA
    kernels, by name (``torch.profiler`` over ``reps`` calls after a
    warm-up; a second session where the first records no device time,
    as a session now and then does); empty where neither records any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            if e.device_time_total > 0:
                out[name] = e.device_time_total / reps / 1000.0
        if out:
            break
    return out


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_frames(pd, n_rows: int, n_series: int, seed: int = 0):
    """HHAR-shaped frames (a copy of bench_frame.make_frames): n_series
    (user) keys, 1-2 s accelerometer ticks, phone (left) joined against
    watch (right) with 5% null readings."""
    rng = np.random.default_rng(seed)
    per = n_rows // n_series
    n = per * n_series
    keys = np.repeat(np.arange(n_series), per)
    gaps = rng.integers(1, 3, size=n).astype(np.int64)
    secs = np.cumsum(gaps.reshape(n_series, per), axis=1).reshape(-1)
    ts = pd.to_datetime(secs * np.int64(NS))
    left = pd.DataFrame({"user": keys, "event_ts": ts,
                         "x": rng.standard_normal(n).astype(np.float64)})
    right = pd.DataFrame({
        "user": keys,
        "event_ts": pd.to_datetime(
            (secs - rng.integers(0, 3, size=n)) * np.int64(NS)),
        "wx": np.where(rng.random(n) > 0.05, rng.standard_normal(n), np.nan),
    })
    return left, right, n


def check_range_stats(got, want, what: str, sum_atol: float = 1e-5) -> float:
    """Raise unless kernel stats ``got`` match the plain ``want``:
    ``count`` and ``clipped`` bitwise, the rest within 1e-5 (abs + rel;
    the centre's block reduction sums in another order; ``sum`` within
    ``sum_atol`` + 1e-5 rel, for windows long enough that the centre's
    rounding shows in a float32 sum of thousands of centred values).  ``stddev`` is
    compared as its square: both sides take ``s2 - s1*s1/n`` in float32,
    whose cancellation error (~1e-6 at these inputs, the same on both
    sides against float64) the square root blows up to ~1e-3 where the
    variance is near zero.  ``zscore`` is compared times each side's own
    ``stddev``, i.e. as ``x - mean``, where neither stddev is 0.
    Returns the largest absolute difference."""
    err = 0.0
    for k in ("count", "clipped"):
        if k not in want:
            continue
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: range-stats kernel {k} differs "
                                 f"from its plain version")
    for k in ("mean", "min", "max", "sum", "stddev", "zscore"):
        g, wv = got[k], want[k]
        if k == "stddev":
            g, wv = g * g, wv * wv
        elif k == "zscore":
            # where either side's stddev rounded to exactly 0 the zscore
            # is +-inf or NaN on that side alone: left out here, the
            # stddev comparison above covers those rows
            flat = (got["stddev"] == 0) | (want["stddev"] == 0)
            nan = torch.full_like(g, float("nan"))
            g = torch.where(flat, nan, g * got["stddev"])
            wv = torch.where(flat, nan, wv * want["stddev"])
        if not torch.equal(torch.isnan(g), torch.isnan(wv)):
            raise AssertionError(f"{what}: range-stats kernel {k}: NaN "
                                 f"pattern differs from its plain version")
        diff = (g - wv).abs().nan_to_num(0.0)
        tol = (sum_atol if k == "sum" else 1e-5) + 1e-5 * wv.abs().nan_to_num(0.0)
        if bool((diff > tol).any()):
            raise AssertionError(f"{what}: range-stats kernel {k} off its "
                                 f"plain version by {float(diff.max())}")
        err = max(err, float(diff.max()))
    return err


def check_ema(got, want, what: str) -> float:
    """Raise unless the kernel's EMA is bitwise the plain version's."""
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{what}: EMA kernel differs from its plain "
                             f"version by {float((got - want).abs().max())}")
    return 0.0


def packed_join_inputs(pd, packing, left, right, dev):
    """The packed tensors the frame join hands the merge kernel: int64
    ns [K, Ll]/[K, Lr] and the right columns' validity [C, K, Lr]."""
    l_codes, r_codes, key_frame = packing.encode_keys_joint(left, right,
                                                            ["user"])
    K = len(key_frame)
    ll = packing.build_layout_from_codes(
        l_codes, packing.series_to_ns(left["event_ts"]), None, K)
    rl = packing.build_layout_from_codes(
        r_codes, packing.series_to_ns(right["event_ts"]), None, K)
    Ll = packing.pad_length(int(ll.lengths.max()))
    Lr = packing.pad_length(int(rl.lengths.max()))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    l_ts = up(packing.pack_column(ll.ts_ns, ll, Ll, fill=packing.TS_PAD))
    r_ts = up(packing.pack_column(rl.ts_ns, rl, Lr, fill=packing.TS_PAD))
    valids = [packing.pack_column((~pd.isna(right[c])).to_numpy()[rl.order],
                                  rl, Lr, fill=False)
              for c in ("event_ts", "wx")]
    return l_ts, r_ts, up(np.stack(valids))


def phase_b(pd, left, right, left3, dev, d_args):
    """Each kernel against its plain version; returns the kernels' rows
    of the result line (``launches`` filled in by phase C; ``left3`` is
    phase F's left frame)."""
    from tempo_tpu_torch import TSDF, packing
    from tempo_tpu_torch import rolling as rolling_frame
    from tempo_tpu_torch.ops import cuda_lib, merge, scan, stream, window

    rows = {}

    # -- merge join, index form (the frame path) at the HHAR shape ----
    l_ts, r_ts, r_valids = packed_join_inputs(pd, packing, left, right, dev)
    K, Ll = l_ts.shape
    C, _, Lr = r_valids.shape
    got = merge.asof_merge_cuda(l_ts, r_ts, r_valids)
    merge_err = 0.0
    for want, form in ((merge.asof_merge_plain(l_ts, r_ts, r_valids), "plain"),
                       (merge.asof_merge_walk_plain(l_ts, r_ts, r_valids),
                        "walk plain")):
        for g, w, what in zip(got[:2], want[:2],
                              ("last_row_idx", "per_col_idx")):
            merge_err = max(merge_err, float((g - w).abs().max()))
            check_bitwise(g, w, f"merge {what} vs {form}")
    lib_last = torch.searchsorted(r_ts, l_ts, right=True) - 1
    if not torch.equal(lib_last.to(torch.int32), got[0]):
        raise AssertionError("merge kernel last_row_idx differs from "
                             "torch.searchsorted")
    # the one-program step's value form at phase D's shape
    dl_ts, _, _, _, dr_ts, dr_valids, dr_values = d_args
    vg = merge.asof_merge_values(dl_ts, dr_ts, dr_valids, dr_values)
    for vw, form in ((merge.asof_merge_plain(dl_ts, dr_ts, dr_valids,
                                             dr_values), "plain"),
                     (merge.asof_merge_walk_plain(dl_ts, dr_ts, dr_valids,
                                                  dr_values), "walk plain")):
        check_bitwise(vg[0], vw[2], f"merge values (phase D) vs {form}")
        check_bitwise(vg[2], vw[0], f"merge last_row_idx (phase D) vs {form}")
    # bin-packed rows (sid fence: eight series of 512 rows a side, so
    # series edges fall on the walk's 1024-position steps), a sequence
    # tie-break, and both together, through the row walk and the tiles,
    # skipNulls both ways
    rng = np.random.default_rng(8)
    gen = torch.Generator(device=dev).manual_seed(8)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lt_, ls_ = packed_rows(rng, 64, 4096, 8, 400, packing)
    rt_, rs_ = packed_rows(rng, 64, 4096, 8, 400, packing)
    bv = up(rng.random((2, 64, 4096)) > 0.2) & up(rt_ < packing.TS_PAD)
    bvals = torch.where(bv, torch.randn(bv.shape, generator=gen, device=dev),
                        float("nan"))
    sl = np.sort(rng.integers(0, 300, (16, 4096)), -1) * NS
    sr = np.sort(rng.integers(0, 300, (16, 4096)), -1) * NS
    seq = rng.integers(-3, 4, sr.shape).astype(np.float64)
    seq[rng.random(sr.shape) < 0.25] = -np.inf      # NULLS FIRST
    for k in range(seq.shape[0]):
        seq[k] = seq[k][np.lexsort((seq[k], sr[k]))]
    l_key, r_key = merge.seq_keys(None, up(seq), sl.shape, sr.shape)
    sv = up(rng.random((1,) + sr.shape) > 0.2)
    svals = torch.where(sv, torch.randn(sv.shape, generator=gen, device=dev),
                        float("nan"))
    # the same bin-packed right rows with a sequence: ties in ts within a
    # series ordered by it
    bseq = rng.integers(-3, 4, rt_.shape).astype(np.float64)
    bseq[rng.random(rt_.shape) < 0.25] = -np.inf
    for k in range(bseq.shape[0]):
        bseq[k] = bseq[k][np.lexsort((bseq[k], rt_[k], rs_[k]))]
    bl_key, br_key = merge.seq_keys(None, up(bseq), lt_.shape, rt_.shape)
    small = [("bin-packed [64, 4096]", (up(lt_), up(rt_), bv, bvals, up(ls_),
                                        up(rs_))),
             ("seq tie-break [16, 4096]", (up(sl), up(sr), sv, svals, None,
                                           None, l_key, r_key)),
             ("bin-packed seq [64, 4096]", (up(lt_), up(rt_), bv, bvals,
                                            up(ls_), up(rs_), bl_key,
                                            br_key))]
    for what, args in small:
        for skip in (True, False):
            want = merge.asof_merge_plain(*args, skip_nulls=skip)
            walk = merge.asof_merge_walk_plain(
                *args, skip_nulls=skip, step=cuda_lib.asof_walk_step())
            for form in ("walk", "tiles"):
                g = merge.asof_merge_cuda(*args, skip_nulls=skip, _form=form)
                for i, out in enumerate(("last_row_idx", "per_col_idx",
                                         "vals")):
                    check_bitwise(g[i], want[i], f"merge {out} ({what}, "
                                  f"{form}, skipNulls {skip}) vs plain")
                    check_bitwise(g[i], walk[i], f"merge {out} ({what}, "
                                  f"{form}, skipNulls {skip}) vs walk plain")
    # few long rows: [8, 25000] takes the tiles by the shape pick
    few_l = up(np.sort(rng.integers(0, 50_000, (8, 25_000)), -1) * NS)
    few_r = up(np.sort(rng.integers(0, 50_000, (8, 25_000)), -1) * NS)
    few_v = up(rng.random((2, 8, 25_000)) > 0.05)
    few = merge.asof_merge_cuda(few_l, few_r, few_v)
    for want, form in ((merge.asof_merge_plain(few_l, few_r, few_v), "plain"),
                       (merge.asof_merge_walk_plain(few_l, few_r, few_v),
                        "walk plain")):
        for i in range(2):
            check_bitwise(few[i], want[i], f"merge [8, 25000] [{i}] vs {form}")
    nbytes = K * Ll * 8 + K * Lr * 8 + C * K * Lr + K * Ll * 4 * (1 + C)
    nops = (K * Ll + K * Lr) * 3
    b, by = bound_ms(nbytes, nops)
    walk_ms = lambda *a, **kw: time_ms(lambda: merge.asof_merge_cuda(*a, **kw))
    rows["asof_merge"] = dict(
        name="asof_merge", route="cuda",
        source="tempo_tpu_torch/csrc/asof_merge.cu",
        replaces="tempo_tpu/ops/pallas_merge.py:251",
        max_abs_err=merge_err,
        ms=walk_ms(l_ts, r_ts, r_valids),
        plain_ms=time_ms(lambda: merge.asof_merge_plain(l_ts, r_ts, r_valids),
                         reps=3),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.searchsorted(r_ts, l_ts, right=True)),
        ms_tiles_form=walk_ms(l_ts, r_ts, r_valids, _form="tiles"),
        ms_value_form_phase_d=walk_ms(dl_ts, dr_ts, dr_valids, dr_values),
        ms_few_rows=walk_ms(few_l, few_r, few_v),
        ms_few_rows_walk=walk_ms(few_l, few_r, few_v, _form="walk"),
        library_ms_few_rows=time_ms(lambda: torch.searchsorted(
            few_r, few_l, right=True)),
        stages_ms_few_rows=stage_ms(lambda: merge.asof_merge_cuda(
            few_l, few_r, few_v)),
        shape=f"[{K}, {Ll}] x [{K}, {Lr}], C={C} (row walk); phase D "
              f"{list(dl_ts.shape)} value form; few rows [8, 25000] "
              f"(tiles)")
    row = rows["asof_merge"]
    log(f"B merge: bitwise equal to plain and to the walk plain version at "
        f"[{K}, {Ll}]x[{K}, {Lr}] C={C}, at phase D's shape (value form), "
        f"on {', '.join(w for w, _ in small)} (walk and tiles, skipNulls "
        f"both ways) and at [8, 25000] (tiles); kernel {row['ms']:.4f} ms "
        f"(tiles {row['ms_tiles_form']:.4f}), plain {row['plain_ms']:.4f} "
        f"ms, torch.searchsorted {row['library_ms']:.4f} ms, bound "
        f"{b:.4f} ms; phase D value form {row['ms_value_form_phase_d']:.4f} "
        f"ms; [8, 25000] {row['ms_few_rows']:.4f} ms (walk "
        f"{row['ms_few_rows_walk']:.4f}, torch.searchsorted "
        f"{row['library_ms_few_rows']:.4f}; launches by kernel (ms a call) "
        f"{row['stages_ms_few_rows']})")
    del l_ts, r_ts, r_valids, got, lib_last, few_l, few_r, few_v, few

    # -- range stats at the HHAR shape (the left metric x) -----------
    # Both forms bitwise in all seven stats and `clipped` against the
    # plain version run at the kernel's own centres (``_center_out``),
    # min and max included with the sign of zero (the card's torch
    # min/max and the kernel's agree there); count and clipped also
    # bitwise, the rest within 1e-5, against the plain version's centre.
    def held(got, what, *a, **kw):
        centre = torch.empty(got["count"].shape[:2], device=dev)
        again = window.range_stats_cuda(*a, _center_out=centre, **kw)
        check_same(again, got, f"range stats ({what}) run twice")
        kw.pop("_form", None)
        check_same(got, window.range_stats_plain(*a, _centers=centre, **kw),
                   f"range stats ({what}) against the plain version at the "
                   f"kernel's centres")

    lt = TSDF(left, "event_ts", ["user"], device=dev, dtype=torch.float32)
    x, valid = lt.packed_numeric("x")
    engine, rb, ts_long, w = rolling_frame.plan_range_engine(lt, 10)
    secs = torch.from_numpy(ts_long).to(dev)
    mb, ma = int(rb[0]), int(rb[1])
    hh_args = (secs, x[None], valid[None], w, mb, ma)
    hh_row = window.range_stats_cuda(*hh_args, _form="row")
    held(hh_row, "HHAR shape, row form", *hh_args, _form="row")
    held(window.range_stats_cuda(*hh_args, _form="ring"),
         "HHAR shape, staged form", *hh_args, _form="ring")
    hh_want = window.range_stats_plain(*hh_args)
    err = check_range_stats(hh_row, hh_want, "HHAR shape")
    # look-ahead rows (a forward window) and truncation both ways, so the
    # kernel's ahead walk and both halves of its clipped audit are held
    # against the plain version too, in both forms
    dsecs = d_args[1].to(torch.int32)
    dx, dv = d_args[2][None], d_args[3][None]
    want = window.range_stats_plain(dsecs, dx, dv, 10, 4, 2, window_ahead=6)
    n_clipped = int(want["clipped"].sum())
    if n_clipped == 0:
        raise AssertionError("truncating range-stats case clipped nothing")
    for form in ("row", "ring"):
        got = window.range_stats_cuda(dsecs, dx, dv, 10, 4, 2,
                                      window_ahead=6, _form=form)
        held(got, f"truncating case, {form} form", dsecs, dx, dv, 10, 4, 2,
             window_ahead=6, _form=form)
        err = max(err, check_range_stats(got, want,
                                         f"truncating case, {form} form"))
    # config 13's width, [8, 512], clipping both ways: the staged form's
    # rows split over blocks (a block an item, two items a row), bitwise
    # the row form, its clipped the exact count
    s8 = secs[:8, :512].contiguous()
    x8, v8 = x[None, :8, :512].contiguous(), valid[None, :8, :512].contiguous()
    a8 = (s8, x8, v8, 10, 4, 2)
    row8 = window.range_stats_cuda(*a8, window_ahead=6, _form="row")
    got8 = window.range_stats_cuda(*a8, window_ahead=6, _form="ring")
    plan8 = dict(stream.last_plan["range_stats"])
    check_same(got8, row8, "range stats [1, 8, 512] staged against the row form")
    held(got8, "[1, 8, 512], staged form", *a8, window_ahead=6, _form="ring")
    exact8 = window.range_stats_plain(s8, x8.double(), v8, 10, 4, 2,
                                      window_ahead=6)["clipped"]
    if not torch.equal(got8["clipped"].double().cpu(), exact8.cpu()) or \
            int(exact8.sum()) == 0:
        raise AssertionError(f"range stats [1, 8, 512]: clipped "
                             f"{got8['clipped'].flatten().tolist()}, exact "
                             f"{exact8.flatten().tolist()}")
    n_tiles8 = -(-512 // plan8["tile"])
    if plan8["blocks"] * plan8["items"] < 8 * n_tiles8 or \
            plan8["items"] >= n_tiles8:
        raise AssertionError(f"range stats [1, 8, 512]: rows not split over "
                             f"blocks ({plan8})")
    split8 = (f"[1, 8, 512] bounds (4, 2): staged form ({plan8}) bitwise the "
              f"row form, rows split over blocks, clipped "
              f"{int(exact8.sum())} lanes exact")
    del row8, got8, exact8
    # bounds (60, 40) over two columns of [128, 12760]: a halo past the
    # occupancy budgets, so the staged form runs at each depth asked (the
    # HHAR case settles on depth 2 at all three), windows of ~100 rows
    # behind and ~60 ahead clipped both ways; bitwise the row form and
    # across depths, clipped the exact count
    wg = torch.Generator(device=dev).manual_seed(19)
    Kh, Lh = 128, 12760           # the HHAR width, whatever --rows asks
    sh = torch.randint(0, 2, (Kh, Lh), generator=wg, device=dev).cumsum(1)
    xh = torch.randn((2, Kh, Lh), generator=wg, device=dev)
    vh = torch.rand((2, Kh, Lh), generator=wg, device=dev) > 0.1
    ah = (sh.to(torch.int32), xh, vh, 50, 60, 40)
    rowh = window.range_stats_cuda(*ah, window_ahead=30, _form="row")
    exacth = window.range_stats_plain(ah[0], xh.double(), vh, 50, 60, 40,
                                      window_ahead=30)["clipped"]
    if int(exacth.sum()) == 0:
        raise AssertionError("range stats bounds (60, 40): nothing clipped")
    wide, firsth = {}, None
    for depth in RING_DEPTHS:
        with dma_depth(depth):
            goth = window.range_stats_cuda(*ah, window_ahead=30, _form="ring")
            planh = dict(stream.last_plan["range_stats"])
            if planh["depth"] != depth:
                raise AssertionError(f"range stats bounds (60, 40): depth "
                                     f"{depth} asked, plan {planh}")
            what = f"range stats bounds (60, 40), staged depth {depth}"
            check_same(goth, rowh, f"{what} against the row form")
            if firsth is not None:
                check_same(goth, firsth, f"{what} against depth "
                                         f"{RING_DEPTHS[0]}")
            firsth = goth
            held(goth, what, *ah, window_ahead=30, _form="ring")
            if not torch.equal(goth["clipped"].double(), exacth):
                raise AssertionError(f"{what}: clipped differs from the "
                                     f"exact count")
            planh["ms"] = time_ms(lambda: window.range_stats_cuda(
                *ah, window_ahead=30, _form="ring"), reps=5)
        wide[depth] = planh
    wide_row_ms = time_ms(lambda: window.range_stats_cuda(
        *ah, window_ahead=30, _form="row"), reps=5)
    split_wide = (f"[2, {Kh}, {Lh}] bounds (60, 40): staged form at depths "
                  f"{list(RING_DEPTHS)} as asked (" + "; ".join(
                      f"T={p['tile']} x {p['depth']}, {p['smem']} B, "
                      f"{p['blocks']} blocks of at most {p['items']} items, "
                      f"{p['ms']:.4f} ms" for p in wide.values())
                  + f"; row form {wide_row_ms:.4f} ms) bitwise the row form "
                  f"and across depths, clipped {int(exacth.sum())} lanes "
                  f"exact")
    del rowh, goth, firsth, exacth, sh, xh, vh, ah
    # phase F's long rows at the six-hour bounds (a halo of ~14,600 lanes
    # against windows of 2048: the row form walks several windows)
    lt6 = TSDF(left3, "event_ts", ["user"], device=dev, dtype=torch.float32)
    x6, valid6 = lt6.packed_numeric("x")
    engine6, rb6, ts6, w6 = rolling_frame.plan_range_engine(lt6, 6 * 3600)
    secs6 = torch.from_numpy(ts6).to(dev)
    mb6, ma6 = int(rb6[0]), int(rb6[1])
    six_args = (secs6, x6[None], valid6[None], w6, mb6, ma6)
    if stream.range_plan(mb6, ma6, x6.shape[1]) is not None:
        raise AssertionError("six-hour range stats fit a staged plan")
    eight = (secs6[:8], x6[None, :8], valid6[None, :8], w6, mb6, ma6)
    six8 = window.range_stats_cuda(*eight)
    held(six8, "8 of phase F's rows at six-hour bounds", *eight)
    # against the plain version's own centre: windows of ~14,400 rows sum
    # that many centred float32 values, so `sum` takes phase F's 2e-3
    six_err = check_range_stats(six8, window.range_stats_plain(*eight),
                                "8 of phase F's rows, six hours",
                                sum_atol=2e-3)
    Kw, L = x.shape
    nbytes = Kw * L * (4 + 4 + 1) + 7 * Kw * L * 4 + Kw * 4
    nops = Kw * L * ((mb + ma) * 10 + 20)
    b, by = bound_ms(nbytes, nops)
    K6, L6 = x6.shape
    b6, by6 = bound_ms(K6 * L6 * (4 + 4 + 1) + 7 * K6 * L6 * 4 + K6 * 4,
                       K6 * L6 * ((mb6 + ma6) * 10 + 20))
    rows["range_stats"] = dict(
        name="range_stats", route="cuda",
        source="tempo_tpu_torch/csrc/range_stats.cu",
        replaces="tempo_tpu/ops/pallas_window.py:312",
        max_abs_err=err, max_abs_err_six_hour=six_err,
        ms=time_ms(lambda: window.range_stats_cuda(*hh_args, _form="row")),
        plain_ms=time_ms(lambda: window.range_stats_plain(*hh_args), reps=3),
        bound_ms=b, bound_by=by, library_ms=None,
        stages_ms=stage_ms(lambda: window.range_stats_cuda(*hh_args,
                                                           _form="row")),
        ms_six_hour=time_ms(lambda: window.range_stats_cuda(*six_args),
                            reps=3),
        bound_ms_six_hour=b6, bound_by_six_hour=by6,
        stages_ms_six_hour=stage_ms(
            lambda: window.range_stats_cuda(*six_args), reps=2),
        ms_wide_halo_staged={d: p["ms"] for d, p in wide.items()},
        plan_wide_halo_staged=wide, ms_wide_halo_row=wide_row_ms,
        shape_wide_halo=f"[2, {Kh}, {Lh}], rangeBetween(-50, +30), rows 60 "
                        f"behind/40 ahead",
        shape=f"[1, {Kw}, {L}], window {w}s, rows {mb} behind/{ma} ahead, "
              f"engine {engine}",
        shape_six_hour=f"[1, {K6}, {L6}], window {w6}s, rows {mb6} behind/"
                       f"{ma6} ahead, engine {engine6}")
    row = rows["range_stats"]
    log(f"B range_stats: both forms bitwise equal to the plain version at "
        f"the kernel's centres (all seven stats and clipped) at [1, {Kw}, "
        f"{L}] bounds ({mb}, {ma}), at {list(dx.shape)} rangeBetween(-10, "
        f"+6) bounds (4, 2) with {n_clipped} rows clipped, {split8}, "
        f"{split_wide}, and (row form) on "
        f"8 of phase F's rows at bounds ({mb6}, {ma6}); count/clipped "
        f"bitwise, rest within 1e-5 of the plain version's own centre (max "
        f"abs err {err:.3g}; six-hour rows {six_err:.3g}, sum within 2e-3); "
        f"kernel {row['ms']:.4f} ms (stages "
        f"{row['stages_ms']}), plain {row['plain_ms']:.4f} ms, bound "
        f"{b:.4f} ms; six hours [1, {K6}, {L6}]: {row['ms_six_hour']:.4f} ms "
        f"(stages {row['stages_ms_six_hour']}), bound {b6:.4f} ms ({by6})")
    if cuda_lib.range_row_window() != window.ROW_WINDOW:
        raise AssertionError("the row form's window differs from "
                             "window.ROW_WINDOW")
    rows.update(ring_rows(
        "range_stats",
        lambda: window.range_stats_cuda(*hh_args, _form="ring"),
        hh_row, hh_want, check_range_stats, rows["range_stats"],
        "tempo_tpu_torch/csrc/range_stats.cu",
        lambda p: (mb, ma, L, p["tile"], p["depth"])))
    # the staged form at each depth and at the ring depth this process
    # resolves (the checked-in tuned profile's, where it sets one): phase
    # R puts them against a measured stream rate (window_roofline)
    hh_ms = {f"depth {d}": rows[f"range_stats_ring_d{d}"]["ms"]
             for d in RING_DEPTHS}
    hh_ms[f"resolved depth {stream.dma_buffers()}"] = time_ms(
        lambda: window.range_stats_cuda(*hh_args, _form="ring"))
    rows["range_stats"]["_hh"] = dict(lanes=Kw * L, ms=hh_ms)
    del got, want, hh_row, hh_want, six8, lt6, x6, valid6, secs6

    # -- exact EMA ladder at the HHAR shape and phase D's -------------
    cases = [(f"HHAR {list(x.shape)}", x, valid),
             (f"phase D {list(d_args[2].shape)}", d_args[2], d_args[3])]
    # the one-launch form's longest rows ([K / 2, 16384]) and rows of
    # T * 2^j + 1 lanes with -0.0, NaN and +-inf (two-stage past 16,384)
    lx = d_args[2].reshape(-1, 2 * d_args[2].shape[1])
    cases.append((f"one-launch limit {list(lx.shape)}", lx,
                  d_args[3].reshape(lx.shape)))
    egen = torch.Generator(device=dev).manual_seed(3)
    for L_odd in (1025, 8193, 16385, 65537):
        odd = torch.randn((4, L_odd), generator=egen, device=dev) * 100
        odd_v = torch.rand(odd.shape, generator=egen, device=dev) > 0.2
        odd[:, 0] = -0.0
        odd[:, 1::7] = -0.0
        odd[:, 3::101] = float("nan")
        odd[:, 5::211] = float("inf")
        odd[:, 9::307] = -float("inf")
        odd_v[:, 0] = True
        odd_v[-1] = False
        cases.append((f"-0.0/NaN/inf {list(odd.shape)}", odd, odd_v))
    for what, a, v in cases:
        for alpha in (0.2, 1.0):
            got = scan.ema_cuda(a, v, alpha)
            check_ema(got, scan.ema_plain(a, v, alpha), f"{what}, alpha {alpha}")
            check_ema(got, scan.ema_tiled_plain(a, v, alpha),
                      f"{what}, alpha {alpha} (tiled plain)")
    levels = math.ceil(math.log2(max(L, 2)))
    b, by = bound_ms(Kw * L * (4 + 1 + 4), Kw * L * 3 * levels)
    rows["ema_ladder"] = dict(
        name="ema_ladder", route="cuda",
        source="tempo_tpu_torch/csrc/ema_ladder.cu",
        replaces="tempo_tpu/ops/pallas_kernels.py:105",
        max_abs_err=0.0,
        ms=time_ms(lambda: scan.ema_cuda(x, valid, 0.2)),
        plain_ms=time_ms(lambda: scan.ema_plain(x, valid, 0.2), reps=3),
        bound_ms=b, bound_by=by, library_ms=None,
        ms_phase_d=time_ms(lambda: scan.ema_cuda(d_args[2], d_args[3], 0.2)),
        shape=f"[{Kw}, {L}] (one launch); phase D {list(d_args[2].shape)}")
    log(f"B ema_ladder: bitwise (int32 bit views) equal to plain and to the "
        f"tiled plain version, alpha 0.2 and 1, on "
        + ", ".join(w for w, _, _ in cases)
        + f"; kernel {rows['ema_ladder']['ms']:.4f} ms at [{Kw}, {L}] "
        f"(bound {b:.4f}), {rows['ema_ladder']['ms_phase_d']:.4f} ms at "
        f"phase D's shape; plain {rows['ema_ladder']['plain_ms']:.4f} ms")
    log(f"B launches while comparing (not counted): {dict(cuda_lib.launches)}")
    return rows


def check_bitwise(got, want, what: str) -> None:
    """Raise unless two tensors (floats as their bits) are equal."""
    g, w = got, want
    if g.is_floating_point():
        bits = {4: torch.int32, 8: torch.int64}[g.element_size()]
        g, w = g.view(bits), w.view(bits)
    if g.dtype != w.dtype or not torch.equal(g, w):
        raise AssertionError(f"{what}: kernel differs from its plain version")


def phase_b_slice2(right, left3, dev):
    """The second slice's kernels against their plain versions; returns
    their rows of the result line (``launches`` filled in by phase E;
    the resample EMA also on phase F's long rows, ``left3``)."""
    from tempo_tpu_torch import TSDF, interpol, packing
    from tempo_tpu_torch import resample as rs
    from tempo_tpu_torch.ops import bucket, cuda_lib, scan, stream

    rows = {}
    rt = TSDF(right, "event_ts", ["user"], device=dev)

    # -- valid-index scans on the 1 s interpolation grid's masks -------
    sampled = rt._with_df(rs.aggregate(rt, "1 second", "mean"))
    real, _, _, _, valid, _ = interpol.dense_grid(sampled, 1, ["wx"])
    grid = torch.from_numpy(real).to(dev)
    col = torch.from_numpy(valid.reshape(-1, valid.shape[-1])).to(dev)
    K, G = grid.shape
    # the grid's rows of 19,304 bytes start every other one 8 bytes into a
    # 16-byte word; the last case starts its rows at 8 mod 16 and odd
    # bytes with L = 1003, not a multiple of 16
    n_odd = (K * G - 8) // 1003
    odd = grid.reshape(-1)[8:8 + n_odd * 1003].view(n_odd, 1003)
    for mask, what in ((grid, "grid mask"), (col, "wx mask"),
                       (odd, "grid mask as rows of 1003 from byte 8")):
        check_bitwise(scan.last_valid_index_scan_cuda(mask),
                      scan.last_valid_index_scan_plain(mask),
                      f"last_valid_index on the {what}")
        check_bitwise(scan.first_valid_index_scan_cuda(mask),
                      scan.first_valid_index_scan_plain(mask),
                      f"first_valid_index on the {what}")
    lanes = torch.arange(G, dtype=torch.int32, device=dev).expand(K, G)
    cand = torch.where(grid, lanes, -1)
    check_bitwise(torch.cummax(cand, dim=1).values,
                  scan.last_valid_index_scan_cuda(grid), "torch.cummax")
    b, by = bound_ms(K * G * 5, K * G * 2)
    for name, fn, plain, lib_fn in (
            ("last_valid_index", scan.last_valid_index_scan_cuda,
             scan.last_valid_index_scan_plain,
             lambda: torch.cummax(cand, dim=1)),
            ("first_valid_index", scan.first_valid_index_scan_cuda,
             scan.first_valid_index_scan_plain, None)):
        rows[name] = dict(
            name=name, route="cuda",
            source="tempo_tpu_torch/csrc/index_scan.cu",
            replaces="tempo_tpu/ops/pallas_kernels.py:"
                     + ("143" if name.startswith("last") else "152"),
            max_abs_err=0.0,
            ms=time_ms(lambda: fn(grid)),
            plain_ms=time_ms(lambda: plain(grid), reps=3),
            bound_ms=b, bound_by=by,
            library_ms=None if lib_fn is None else time_ms(lib_fn),
            shape=f"[{K}, {G}] bool")
    log(f"B index scans: bitwise equal to plain on the grid mask [{K}, {G}] "
        f"({int(real.sum())} real slots), the wx mask {list(col.shape)} and "
        f"the grid mask as {list(odd.shape)} from byte 8; "
        f"last {rows['last_valid_index']['ms']:.4f} ms, first "
        f"{rows['first_valid_index']['ms']:.4f} ms, torch.cummax "
        f"{rows['last_valid_index']['library_ms']:.4f} ms")
    del grid, col, cand, lanes, sampled, odd

    # -- forward fill on the packed wx column --------------------------
    x, v = rt.packed_numeric("wx")
    Kx, L = x.shape
    got, want = scan.last_valid_scan_cuda(x, v), scan.last_valid_scan_plain(x, v)
    check_bitwise(got[0], want[0], "last_valid_scan values")
    check_bitwise(got[1], want[1], "last_valid_scan has-valid")
    # rows of 1003 lanes starting at byte 8 of the mask and lane 2 of x
    n_odd = (Kx * L - 8) // 1003
    ox = x.reshape(-1)[2:2 + n_odd * 1003].view(n_odd, 1003)
    ov = v.reshape(-1)[8:8 + n_odd * 1003].view(n_odd, 1003)
    got, want = scan.last_valid_scan_cuda(ox, ov), \
        scan.last_valid_scan_plain(ox, ov)
    check_bitwise(got[0], want[0], "last_valid_scan values (rows of 1003)")
    check_bitwise(got[1], want[1], "last_valid_scan has-valid (rows of 1003)")
    b, by = bound_ms(Kx * L * 10, Kx * L * 2)
    rows["last_valid_scan"] = dict(
        name="last_valid_scan", route="cuda",
        source="tempo_tpu_torch/csrc/index_scan.cu",
        replaces="tempo_tpu/ops/pallas_kernels.py:121", max_abs_err=0.0,
        ms=time_ms(lambda: scan.last_valid_scan_cuda(x, v)),
        plain_ms=time_ms(lambda: scan.last_valid_scan_plain(x, v), reps=3),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"[{Kx}, {L}]")
    log(f"B last_valid_scan: bitwise equal to plain at [{Kx}, {L}] and on "
        f"rows of 1003 from byte 8 of the mask and lane 2 of x; kernel "
        f"{rows['last_valid_scan']['ms']:.4f} ms")

    # -- fused resample + EMA ----------------------------------------
    real = rt.packed_mask()
    secs64 = rt.packed_ts() // packing.NS_PER_S
    secs = torch.from_numpy(secs64.astype(np.int32)).to(dev)
    # seconds before 1970 (floor division matters), pads left at 0
    neg = torch.from_numpy(
        np.where(real, secs64 - 1_500_000_007, 0).astype(np.int32)).to(dev)
    # phase F's long rows, as resampleEMA packs them
    lt3 = TSDF(left3, "event_ts", ["user"], device=dev, dtype=torch.float32)
    fx, fv = lt3.packed_numeric("x")
    fsecs = torch.from_numpy((lt3.packed_ts() // packing.NS_PER_S)
                             .astype(np.int32)).to(dev)
    KF, LF = fx.shape
    # rows at the one-launch limit and one lane past it: HHAR rows joined
    # two at a time, cut to length
    row_max = cuda_lib.ema_row_max()
    if stream.EMA_ROW_MAX != row_max:
        raise AssertionError(f"the planner's one-launch limit "
                             f"{stream.EMA_ROW_MAX} is not the kernel's "
                             f"{row_max}")
    k2 = Kx // 2 * 2

    def joined(t, n):
        return t[:k2].reshape(k2 // 2, 2 * L)[:, :n].contiguous()

    cases = [(secs, x, v, 60, None, "HHAR shape"),
             (neg, x, v, 60, 1.5, "negative seconds, scale 1.5"),
             (fsecs, fx, fv, 60, None, f"phase F's rows [{KF}, {LF}]"),
             (fsecs, fx, fv, 7, 1.5, "phase F's rows, step 7, scale 1.5"),
             (joined(secs, row_max), joined(x, row_max), joined(v, row_max),
              7, None, f"[{k2 // 2}, {row_max}] (the one-launch limit)"),
             (joined(neg, row_max + 1), joined(x, row_max + 1),
              joined(v, row_max + 1), 7, None,
              f"[{k2 // 2}, {row_max + 1}] (two launches), negative "
              f"seconds, step 7")]
    # rows whose starts sit 1 to 3 words off 16 bytes, which the staged
    # form copies in part by plain loads and whose words spill into the
    # next row: rows of L + 1 lanes (starts at every offset), and views
    # of 256 rows of L lanes 1, 2 and 3 words (bytes, for valid) into
    # the buffers
    cases.append((joined(secs, L + 1), joined(x, L + 1), joined(v, L + 1),
                  60, None, f"[{k2 // 2}, {L + 1}] (rows at every word "
                            f"offset)"))
    n_off = min(256, (x.numel() - 3) // L)   # 256 but at small --rows
    for off in (1, 2, 3):
        view = lambda t: t.reshape(-1)[off:off + n_off * L].view(n_off, L)
        cases.append((view(neg), view(x), view(v), 7, 1.5,
                      f"[{n_off}, {L}] from word {off}, negative seconds, "
                      f"step 7, scale 1.5"))
    if stream.resample_plan(L + 1) is None:
        raise AssertionError(f"resample EMA: rows of {L + 1} lanes take no "
                             f"staged plan")
    for s_, x_, v_, step, scale, what in cases:
        want = bucket.resample_ema_plain(s_, x_, v_, step, 0.2, scale)
        mirror = bucket.resample_ema_tiled_plain(s_, x_, v_, step, 0.2, scale)
        # the staged form takes the rows its planner stages (at most
        # 13,824 lanes: the ladder's planes within two blocks an SM)
        forms = (("row", "ring") if stream.resample_plan(s_.shape[1])
                 is not None else ("row",))
        for form in forms:
            got = bucket.resample_ema_cuda(s_, x_, v_, step, 0.2, scale,
                                           _form=form)
            for i, out in enumerate(("res", "ema")):
                check_bitwise(got[i], want[i],
                              f"resample_ema {out} ({what}, {form})")
                check_bitwise(got[i], mirror[i],
                              f"resample_ema {out} ({what}, {form}) against "
                              f"its tiled mirror")
    del want, mirror, got

    def resample_bound(K_, L_):
        levels = math.ceil(math.log2(max(L_, 2)))
        return bound_ms(K_ * L_ * 17, K_ * L_ * (3 * levels + 6))

    b, by = resample_bound(Kx, L)
    bf, _ = resample_bound(KF, LF)
    m_s, m_x, m_v = (joined(t, row_max) for t in (secs, x, v))
    p_s, p_x, p_v = (joined(t, row_max + 1) for t in (secs, x, v))
    rows["resample_ema"] = dict(
        name="resample_ema", route="cuda",
        source="tempo_tpu_torch/csrc/resample_ema.cu",
        replaces="tempo_tpu/ops/pallas_bucket.py:378", max_abs_err=0.0,
        ms=time_ms(lambda: bucket.resample_ema_cuda(secs, x, v, 60, 0.2,
                                                    _form="row")),
        plain_ms=time_ms(lambda: bucket.resample_ema_plain(secs, x, v, 60,
                                                           0.2), reps=3),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"[{Kx}, {L}]",
        ms_phase_f=time_ms(lambda: bucket.resample_ema_cuda(
            fsecs, fx, fv, 60, 0.2)),
        plain_ms_phase_f=time_ms(lambda: bucket.resample_ema_plain(
            fsecs, fx, fv, 60, 0.2), reps=3),
        bound_ms_phase_f=bf, shape_phase_f=f"[{KF}, {LF}]",
        stages_ms_phase_f=stage_ms(lambda: bucket.resample_ema_cuda(
            fsecs, fx, fv, 60, 0.2)),
        ms_row_max=time_ms(lambda: bucket.resample_ema_cuda(
            m_s, m_x, m_v, 60, 0.2, _form="row")),
        ms_row_max_plus_1=time_ms(lambda: bucket.resample_ema_cuda(
            p_s, p_x, p_v, 60, 0.2)),
        shape_row_max=f"[{k2 // 2}, {row_max}] and [{k2 // 2}, "
                      f"{row_max + 1}]")
    row = rows["resample_ema"]
    log(f"B resample_ema: res and ema bitwise equal to plain and to the "
        f"tiled mirror, both forms, at {'; '.join(c[-1] for c in cases)}; "
        f"kernel {row['ms']:.4f} ms (bound {b:.4f}), phase F's rows "
        f"{row['ms_phase_f']:.4f} ms (bound {bf:.4f}; stages "
        f"{row['stages_ms_phase_f']}), {row_max} lanes "
        f"{row['ms_row_max']:.4f} ms, {row_max + 1} lanes "
        f"{row['ms_row_max_plus_1']:.4f} ms; plain {row['plain_ms']:.4f} ms, "
        f"phase F's rows {row['plain_ms_phase_f']:.4f} ms")
    del fx, fv, fsecs, lt3, m_s, m_x, m_v, p_s, p_x, p_v
    rows.update(ring_rows(
        "resample_ema",
        lambda: bucket.resample_ema_cuda(secs, x, v, 60, 0.2, _form="ring"),
        bucket.resample_ema_cuda(secs, x, v, 60, 0.2, _form="row"),
        bucket.resample_ema_plain(secs, x, v, 60, 0.2),
        lambda g, w, what: (check_same(g, w, what), 0.0)[1],
        rows["resample_ema"], "tempo_tpu_torch/csrc/resample_ema.cu",
        lambda p: (L, p["tile"], p["depth"])))
    log(f"B launches while comparing (not counted): {dict(cuda_lib.launches)}")
    return rows


def phase_b_slice4(left, dev, d_args):
    """The legacy stats kernel against its plain version; returns its
    row of the result line (``launches`` filled in by phase G)."""
    from tempo_tpu_torch import TSDF
    from tempo_tpu_torch import rolling as rolling_frame
    from tempo_tpu_torch.ops import cuda_lib, stats

    gen = torch.Generator(device=dev).manual_seed(4)
    lt = TSDF(left, "event_ts", ["user"], device=dev, dtype=torch.float32)
    x, valid = lt.packed_numeric("x")
    cases = []
    for window_secs in (10, 60):
        _, rb, ts_long, w = rolling_frame.plan_range_engine(lt, window_secs)
        secs = torch.from_numpy(ts_long).to(dev)
        cases.append((f"HHAR x, {window_secs} s", secs, x[None], valid[None],
                      w, int(rb[0]), int(rb[1])))
    # a two-column stack: x and a second column with its own nulls
    second = torch.randn(x.shape, generator=gen, device=dev)
    second_valid = valid & (torch.rand(x.shape, generator=gen, device=dev)
                            > 0.2)
    cases.append(("[2, K, L] stack", cases[1][1], torch.stack([x, second]),
                  torch.stack([valid, second_valid]), *cases[1][4:]))
    # tie-heavy keys (about four rows a second) with bounds too small
    # both ways, so both halves of the clipped audit count rows
    dsecs = d_args[1].to(torch.int32)
    dv = d_args[3] & (torch.rand(dsecs.shape, generator=gen, device=dev)
                      > 0.1)
    behind = (dsecs[:, 5:] - 10 <= dsecs[:, :-5]).sum()
    ahead = (dsecs[:, 2:] == dsecs[:, :-2]).sum()
    if int(behind) == 0 or int(ahead) == 0:
        raise AssertionError("truncating legacy case does not clip both ways")
    cases.append(("truncating, bounds (4, 1)", dsecs, d_args[2][None],
                  dv[None], 10, 4, 1))
    # a halo past one window (1536 lanes) on 64 of the series
    secs10 = cases[0][1]
    cases.append(("64 series, bounds (600, 40)", secs10[:64].contiguous(),
                  x[None, :64].contiguous(), valid[None, :64].contiguous(),
                  600, 600, 40))
    # a valid NaN in four rows: their centres are NaN, while windows away
    # from it keep finite min and max
    xn = x.clone()
    vn = valid.clone()
    xn[:4, 100] = float("nan")
    vn[:4, 100] = True
    cases.append(("NaN centres", secs10, xn[None], vn[None], 10, 10, 0))
    err = 0.0
    n_clipped = 0
    for what, secs, xs, vs, w, mb, ma in cases:
        centre = torch.empty(xs.shape[:2], device=dev)
        got = stats.legacy_stats_cuda(secs, xs, vs, w, mb, ma,
                                      _center_out=centre)
        at_centre = stats.legacy_stats_plain(secs, xs, vs, w, mb, ma,
                                             _centers=centre)
        for k in at_centre:
            check_bitwise(got[k], at_centre[k],
                          f"legacy stats {k} ({what}, the kernel's centres)")
        want = stats.legacy_stats_plain(secs, xs, vs, w, mb, ma)
        for k in ("min", "max"):
            check_bitwise(got[k], want[k], f"legacy stats {k} ({what})")
        # windows of 641 rows: the centre's rounding shows in a float32
        # sum of hundreds of centred values (as at range stats' six hours)
        err = max(err, check_range_stats(
            got, want, f"legacy stats ({what})",
            sum_atol=1e-3 if mb + ma > 100 else 1e-5))
        if what.startswith("truncating"):
            n_clipped = int(want["clipped"].sum())
        if what == "NaN centres":
            far = (secs[:4] > secs[:4, 100:101] + w) & vn[:4] \
                & (secs[:4] < 2**31 - 1)
            mn = got["min"][0, :4]
            if not (bool(torch.isnan(centre[0, :4]).all())
                    and bool(torch.isfinite(mn[far]).all())
                    and bool(torch.isnan(mn[:, 100]).all())):
                raise AssertionError("legacy stats: a NaN centre reached "
                                     "min beyond the NaN's windows")
    if n_clipped == 0:
        raise AssertionError("truncating legacy case clipped nothing")

    def legacy_bound(secs, xs, vs, w, mb, ma):
        """Keys once, a column's values and validity once, seven f32
        planes and a clip count written; ~12 operations a lane, column
        and shift."""
        C_, K_, L_ = xs.shape
        return bound_ms(K_ * L_ * 4 + C_ * K_ * L_ * (4 + 1 + 7 * 4) + C_ * K_ * 4,
                        C_ * K_ * L_ * ((min(mb, L_ - 1) + min(ma, L_ - 1) + 1)
                                        * 12 + 20))

    _, secs, xs, vs, w, mb, ma = cases[0]
    _, Kw, L = xs.shape
    b, by = legacy_bound(*cases[0][1:])
    row = dict(
        name="legacy_stats", route="cuda",
        source="tempo_tpu_torch/csrc/legacy_stats.cu",
        replaces="tempo_tpu/ops/pallas_stats.py:52", max_abs_err=err,
        ms=time_ms(lambda: stats.legacy_stats_cuda(secs, xs, vs, w, mb, ma)),
        plain_ms=time_ms(lambda: stats.legacy_stats_plain(secs, xs, vs, w, mb,
                                                          ma), reps=3),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"[1, {Kw}, {L}], window {w}s, rows {mb} behind/{ma} ahead; "
              f"60 s: rows {cases[1][5]}/{cases[1][6]}")
    for key, c in (("60s", cases[1]), ("two_columns", cases[2]),
                   ("600_40", cases[4])):
        row[f"ms_{key}"] = time_ms(lambda: stats.legacy_stats_cuda(*c[1:]))
        row[f"bound_ms_{key}"], row[f"bound_by_{key}"] = legacy_bound(*c[1:])
    log(f"B legacy_stats: count/min/max/clipped bitwise, rest within 1e-5 "
        f"(max abs err {err:.3g}) of the plain version, every stat bitwise "
        f"at the kernel's centres, on {'; '.join(c[0] for c in cases)} "
        f"({n_clipped} rows clipped); kernel {row['ms']:.4f} ms (bound "
        f"{b:.4f}), 60 s {row['ms_60s']:.4f} (bound "
        f"{row['bound_ms_60s']:.4f}), two columns "
        f"{row['ms_two_columns']:.4f} (bound "
        f"{row['bound_ms_two_columns']:.4f}), (600, 40) on [1, 64, {L}] "
        f"{row['ms_600_40']:.4f} (bound {row['bound_ms_600_40']:.4f}, "
        f"{row['bound_by_600_40']}); plain {row['plain_ms']:.4f} ms")
    log(f"B launches while comparing (not counted): {dict(cuda_lib.launches)}")
    return {"legacy_stats": row}


def chain(TSDF, left, right, steps=None, max_lookback=0, window_secs=10,
          **kw):
    """The main path; ``steps`` (a dict) collects each step's wall
    seconds, the card synchronised at every step's end."""
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        if steps is not None:
            torch.cuda.synchronize()
            steps[name] = time.perf_counter() - t0
            t0 = time.perf_counter()

    with span("pack"):
        lt = TSDF(left, "event_ts", ["user"], **kw)
        rt = TSDF(right, "event_ts", ["user"], **kw)
    with span("join"):
        joined = lt.asofJoin(rt, maxLookback=max_lookback)
    mark("asofJoin")
    with span("stats"):
        stats = joined.withRangeStats(colsToSummarize=["x"],
                                      rangeBackWindowSecs=window_secs)
    mark("withRangeStats")
    with span("EMA"):
        out = stats.EMA("x", exact=True)
    mark("EMA")
    with span("collect"):
        return out.df


def phase_c(pd, TSDF, left, right, n, n_series, keep):
    """The main path at full scale; its output frame and step times go
    into ``keep["C"]`` for phase J."""
    from tempo_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    steps = {}
    t0 = time.perf_counter()
    df = chain(TSDF, left, right, steps=steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    missing = [k for k in SLICE1_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if len(df) != n:
        raise AssertionError(f"main path returned {len(df)} rows, not {n}")
    for c in ("right_wx", "mean_x", "count_x", "stddev_x", "EMA_x"):
        if c not in df.columns:
            raise AssertionError(f"main path output lacks {c}")
    if not np.isfinite(df["EMA_x"].to_numpy()).all():
        raise AssertionError("EMA_x has non-finite values")
    if not (df["count_x"].to_numpy() >= 1).all():
        raise AssertionError("count_x below 1 on a valid row")
    if not np.isfinite(df["mean_x"].to_numpy()).all():
        raise AssertionError("mean_x has non-finite values")
    log(f"C main path: {n} rows a side, {n_series} series, "
        f"{seconds:.3f} s pandas->TSDF->asofJoin->withRangeStats->EMA->"
        f"pandas ({n / seconds:.0f} rows/s); clipped audit zero (asserted "
        f"by withRangeStats); launches {launches}")
    log("C steps (wall s, card synchronised after each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))
    keep["C"] = dict(df=df, steps=steps, seconds=seconds)
    traced("C chain", lambda: len(chain(TSDF, left, right)))

    # the same chain on a small slice: kernels (float32) vs the plain
    # versions on the CPU (float64)
    users = np.arange(min(8, n_series))
    sl = left[left["user"].isin(users)]
    sr = right[right["user"].isin(users)]
    small = chain(TSDF, sl, sr)
    ref = chain(TSDF, sl, sr, device="cpu")
    for c in ("event_ts", "x", "right_event_ts", "right_wx"):
        if not small[c].equals(ref[c]):
            raise AssertionError(f"small-slice {c} differs from the plain "
                                 f"versions")
    np.testing.assert_array_equal(small["count_x"].to_numpy(),
                                  ref["count_x"].to_numpy())
    for c in ("mean_x", "min_x", "max_x", "sum_x", "stddev_x", "EMA_x"):
        np.testing.assert_allclose(small[c].to_numpy(np.float64),
                                   ref[c].to_numpy(np.float64), rtol=1e-4,
                                   atol=1e-4, equal_nan=True, err_msg=c)
    log(f"C small slice ({len(small)} rows): card float32 agrees with the "
        f"CPU float64 plain versions (joins equal, count equal, stats and "
        f"EMA within 1e-4)")
    return launches, seconds


def phase_d(d_args):
    from tempo_tpu_torch import entry
    from tempo_tpu_torch.ops import cuda_lib, scan, window

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    out = entry.forward_step(*d_args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    if any(launches[k] == 0 for k in SLICE1_KERNELS):
        raise AssertionError(f"forward_step skipped a kernel: {launches}")
    K, Ll = d_args[0].shape
    for k, v in out.items():
        want = (K, 1) if k == "stats_clipped" else (
            (d_args[5].shape[0], K, Ll) if k == "joined" else (K, Ll))
        if tuple(v.shape) != want:
            raise AssertionError(f"forward_step {k} shape {tuple(v.shape)}")
    if float(out["stats_clipped"].sum()) != 0.0:
        raise AssertionError("forward_step clipped audit is not zero")
    if not bool(torch.isfinite(out["ema"]).all()):
        raise AssertionError("forward_step EMA not finite")
    # the step's stats and EMA against the plain versions on the same
    # card tensors, at the step's own bounds (rows behind and ahead)
    _, l_secs, x, valid, _, _, _ = d_args
    want = window.range_stats_plain(
        l_secs.to(torch.int32), x[None], valid[None], int(entry.WINDOW_SECS),
        entry.MAX_WINDOW_ROWS, entry.MAX_TIE_ROWS)
    err = check_range_stats({k: out[f"stats_{k}"][None] for k in want},
                            want, "forward_step")
    check_ema(out["ema"], scan.ema_plain(x, valid, entry.EMA_ALPHA),
              "forward_step")
    log(f"D entry.forward_step at [{K}, {Ll}]: {seconds * 1e3:.3f} ms "
        f"(first call), clipped zero, launches {launches}; stats match the "
        f"plain version at bounds ({entry.MAX_WINDOW_ROWS}, "
        f"{entry.MAX_TIE_ROWS}) (count/clipped bitwise, rest max abs err "
        f"{err:.3g}), EMA bitwise")


def phase_e(TSDF, right, n, n_series):
    """Resample -> interpolate, resampleEMA and the public forward fill
    at full scale; returns the launch counts."""
    from tempo_tpu_torch import ops
    from tempo_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    steps = {}
    t0 = t_all = time.perf_counter()

    def mark(name):
        nonlocal t0
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    rt = TSDF(right, "event_ts", ["user"])
    resampled = rt.resample("1 second", "mean")
    mark("resample")
    filled = resampled.interpolate(method="linear").df
    mark("interpolate")
    bars = rt.resampleEMA("1 minute", "wx").df
    mark("resampleEMA")
    x, valid = rt.packed_numeric("wx")
    val, has = ops.last_valid_scan(x, valid)
    mark("last_valid_scan")
    seconds = time.perf_counter() - t_all
    launches = dict(cuda_lib.launches)
    missing = [k for k in SLICE2_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"resample/interpolate path never launched "
                             f"{missing}")

    n_res = len(resampled.df)
    if list(filled.columns) != ["user", "event_ts", "wx"]:
        raise AssertionError(f"interpolate columns {list(filled.columns)}")
    step = filled["event_ts"].diff().dt.total_seconds().to_numpy()
    same = (filled["user"].to_numpy()[1:] == filled["user"].to_numpy()[:-1])
    if not (step[1:][same] == 1.0).all():
        raise AssertionError("interpolated grid is not 1 s within a series")
    if len(filled) <= n_res:
        raise AssertionError("interpolate generated no slots")
    # linear leaves a slot null where the next real row's value is
    # null (the reference's rule), so about the null share of wx
    w = filled["wx"].to_numpy()
    null_share = float(np.isnan(w).mean())
    if not np.isfinite(w[~np.isnan(w)]).all() or null_share > 0.2:
        raise AssertionError(f"interpolated wx not finite or mostly null "
                             f"({null_share:.3f} null)")
    if not np.isfinite(bars["EMA_wx"].to_numpy()).all():
        raise AssertionError("resampleEMA EMA_wx has non-finite values")
    if bars["wx"].isna().mean() > 0.2:
        raise AssertionError("resampleEMA heads mostly null")
    if not bool(torch.isfinite(val[has]).all()):
        raise AssertionError("last_valid_scan filled a non-finite value")
    log(f"E resample/interpolate path: {n} rows, {n_series} series, "
        f"{seconds:.3f} s ({n / seconds:.0f} rows/s); resample -> {n_res} "
        f"rows, interpolate -> {len(filled)} rows "
        f"({1 - n_res / len(filled):.3f} of the slots generated, "
        f"{null_share:.3f} of wx null), "
        f"resampleEMA -> {len(bars)} rows; launches {launches}")
    log("E steps (wall s, card synchronised after each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))

    # all five fills and resampleEMA on 8 users: card (float32) against
    # the plain versions on the CPU (float64)
    sr = right[right["user"].isin(np.arange(min(8, n_series)))]
    runs = {m: lambda t, m=m: t.resample("1 second", "mean").interpolate(
        method=m, show_interpolated=True)
        for m in ("zero", "null", "ffill", "bfill", "linear")}
    runs["TSDF.interpolate linear"] = lambda t: t.interpolate(
        freq="1 second", func="mean", method="linear",
        show_interpolated=True)
    runs["resampleEMA"] = lambda t: t.resampleEMA("1 minute", "wx")
    for what, run in runs.items():
        card = run(TSDF(sr, "event_ts", ["user"])).df
        cpu = run(TSDF(sr, "event_ts", ["user"], device="cpu")).df
        if list(card.columns) != list(cpu.columns) or len(card) != len(cpu):
            raise AssertionError(f"8-user {what}: frames differ in shape")
        for c in card.columns:
            if c in ("wx", "EMA_wx"):
                np.testing.assert_allclose(
                    card[c].to_numpy(np.float64), cpu[c].to_numpy(np.float64),
                    rtol=1e-4, atol=1e-4, equal_nan=True,
                    err_msg=f"8-user {what} {c}")
            elif not card[c].equals(cpu[c]):
                raise AssertionError(f"8-user {what}: {c} differs")
    log(f"E 8-user slice ({len(sr)} rows): {', '.join(runs)} on the card "
        f"(float32) agree with the CPU plain versions (float64): keys, "
        f"timestamps and flags equal, values within 1e-4")
    return launches


def packed_rows(rng, K, L, n_seg, span, packing):
    """[K, L] int64 ns timestamps and int32 sids of bin-packed rows:
    ``n_seg`` series back to back in ascending sid, each sorted, and a
    pad tail (TS_PAD, SID_PAD) on every row."""
    seg = L // n_seg
    sid = np.repeat(np.arange(K * n_seg, dtype=np.int32).reshape(K, n_seg),
                    seg, axis=1)
    ts = (np.sort(rng.integers(0, span, (K, n_seg, seg)), axis=-1)
          .reshape(K, L) * NS)
    tail = L - L // 16
    ts[:, tail:] = packing.TS_PAD
    sid[:, tail:] = packing.SID_PAD
    return ts, sid


def check_lookback(merge, what, l_ts, r_ts, r_valids, *rest, ml,
                   _tile=None, **kw):
    """The lookback kernel (at tiles of ``_tile`` merged positions, the
    kernel's own by default) against its plain version, every output
    bitwise; ``rest`` are the optional operands after ``max_lookback``
    (values, sids, sequence keys).  Returns the kernel's outputs."""
    args = (l_ts, r_ts, r_valids, ml) + rest
    tile = {} if _tile is None else {"_tile": _tile}
    got = merge.asof_merge_lookback_cuda(*args, **kw, **tile)
    want = merge.asof_merge_lookback_plain(*args, **kw)
    for g, w, out in zip(got, want, ("last_row_idx", "per_col_idx", "vals")):
        if g is not None or w is not None:
            check_bitwise(g, w, f"lookback {out} ({what}, max_lookback {ml})")
    return got


def phase_b_slice3(pd, left, right, dev, d_args):
    """The third slice's kernels against their plain versions at phase
    F's shapes; returns their rows of the result line (``launches``
    filled in by phase F)."""
    from tempo_tpu_torch import TSDF, packing
    from tempo_tpu_torch import rolling as rolling_frame
    from tempo_tpu_torch.ops import cuda_lib, merge, scan

    rows = {}
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(3)

    # -- lookback merge, index form (the frame path) -------------------
    l_ts, r_ts, r_valids = packed_join_inputs(pd, packing, left, right, dev)
    K, Ll = l_ts.shape
    C, _, Lr = r_valids.shape
    for ml in (0, 1, 4, LOOKBACK):
        for skip in (True, False):
            got = check_lookback(merge, f"[{K}, {Ll}] skipNulls {skip}",
                                 l_ts, r_ts, r_valids, ml=ml,
                                 skip_nulls=skip)
            if ml == 0:
                base = merge.asof_merge_cuda(l_ts, r_ts, r_valids,
                                             skip_nulls=skip)
                check_bitwise(got[0], base[0], "lookback 0 vs merge last")
                check_bitwise(got[1], base[1], "lookback 0 vs merge per-col")
    # the value form on the wx column, NaN where null
    vals = torch.randn((1, K, Lr), generator=gen, device=dev)
    vals = torch.where(r_valids[1:], vals, float("nan"))
    for skip in (True, False):
        check_lookback(merge, f"value form, skipNulls {skip}", l_ts, r_ts,
                       r_valids[1:], vals, ml=LOOKBACK, skip_nulls=skip)
    # tie-heavy: timestamps floored to 8 s (the pads stay above them)
    coarse = lambda t: t // (8 * NS) * (8 * NS)
    for skip in (True, False):
        check_lookback(merge, f"8 s ties, skipNulls {skip}", coarse(l_ts),
                       coarse(r_ts), r_valids, ml=4, skip_nulls=skip)
    # a run of equal keys longer than a tile: timestamps floored to
    # 2048 s put about 2,700 merged rows in a run, past the kernel's
    # 1024-position tiles
    run = lambda t: torch.where(t < int(packing.TS_PAD),
                                t // (2048 * NS) * (2048 * NS), t)
    for skip in (True, False):
        check_lookback(merge, f"2048 s ties, skipNulls {skip}", run(l_ts),
                       run(r_ts), r_valids, ml=LOOKBACK, skip_nulls=skip)
    # bin-packed rows (sid fence) and a sequence tie-break, smaller shape
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lt_, ls_ = packed_rows(rng, 64, 4096, 8, 400, packing)
    rt_, rs_ = packed_rows(rng, 64, 4096, 8, 400, packing)
    bv = up(rng.random((2, 64, 4096)) > 0.2) & up(rt_ < packing.TS_PAD)
    bvals = torch.where(bv, torch.randn(bv.shape, generator=gen, device=dev),
                        float("nan"))
    for skip in (True, False):
        check_lookback(merge, f"bin-packed, skipNulls {skip}", up(lt_),
                       up(rt_), bv, bvals, up(ls_), up(rs_), ml=5,
                       skip_nulls=skip)
    # bin-packed series of 512 rows a side: every series boundary falls
    # on an edge of a 1024-position tile, and at tiles of 16 on many
    lt_, ls_ = packed_rows(rng, 16, 8192, 16, 600, packing)
    rt_, rs_ = packed_rows(rng, 16, 8192, 16, 600, packing)
    ev = up(rng.random((2, 16, 8192)) > 0.2) & up(rt_ < packing.TS_PAD)
    evals = torch.where(ev, torch.randn(ev.shape, generator=gen, device=dev),
                        float("nan"))
    for tile in (merge.LOOKBACK_TILE, 16):
        for ml in (0, 3):
            for skip in (True, False):
                check_lookback(merge, f"series edges on tile edges, tile "
                               f"{tile}, skipNulls {skip}", up(lt_), up(rt_),
                               ev, evals, up(ls_), up(rs_), ml=ml,
                               skip_nulls=skip, _tile=tile)
    sl = np.sort(rng.integers(0, 300, (16, 4096)), -1) * NS
    sr = np.sort(rng.integers(0, 300, (16, 4096)), -1) * NS
    seq = rng.integers(-3, 4, sr.shape).astype(np.float64)
    seq[rng.random(sr.shape) < 0.25] = -np.inf      # NULLS FIRST
    for k in range(seq.shape[0]):
        seq[k] = seq[k][np.lexsort((seq[k], sr[k]))]
    l_key, r_key = merge.seq_keys(None, up(seq), sl.shape, sr.shape)
    sv = up(rng.random((1,) + sr.shape) > 0.2)
    svals = torch.where(sv, torch.randn(sv.shape, generator=gen, device=dev),
                        float("nan"))
    for tile in (merge.LOOKBACK_TILE, 4):
        for skip in (True, False):
            check_lookback(merge, f"seq tie-break, tile {tile}, skipNulls "
                           f"{skip}", up(sl), up(sr), sv, svals, None, None,
                           l_key, r_key, ml=6, skip_nulls=skip, _tile=tile)
    # one series of 1,000,000 rows a side (bench.py config 9's shape)
    one_l = up(np.sort(rng.integers(0, 2_000_000, (1, 1_000_000)), -1) * NS)
    one_r = up(np.sort(rng.integers(0, 2_000_000, (1, 1_000_000)), -1) * NS)
    one_v = up(rng.random((1, 1, 1_000_000)) > 0.05)
    check_lookback(merge, "[1, 1000000]", one_l, one_r, one_v, ml=LOOKBACK)
    ms_one = time_ms(lambda: merge.asof_merge_lookback_cuda(
        one_l, one_r, one_v, LOOKBACK))
    nbytes = K * Ll * 8 + K * Lr * 8 + C * K * Lr + K * Ll * 4 * (1 + C)
    nops = (K * Ll * math.ceil(math.log2(Lr + 1))
            + K * Lr * math.ceil(math.log2(Ll + 1)))
    b, by = bound_ms(nbytes, nops)
    rows["asof_merge_lookback"] = dict(
        name="asof_merge_lookback", route="cuda",
        source="tempo_tpu_torch/csrc/asof_merge.cu",
        replaces="tempo_tpu/ops/pallas_merge.py:976", max_abs_err=0.0,
        ms=time_ms(lambda: merge.asof_merge_lookback_cuda(
            l_ts, r_ts, r_valids, LOOKBACK)),
        plain_ms=time_ms(lambda: merge.asof_merge_lookback_plain(
            l_ts, r_ts, r_valids, LOOKBACK), reps=3),
        bound_ms=b, bound_by=by, library_ms=None,
        ms_one_series_1m=ms_one,
        stages_ms=stage_ms(lambda: merge.asof_merge_lookback_cuda(
            l_ts, r_ts, r_valids, LOOKBACK)),
        shape=f"[{K}, {Ll}] x [{K}, {Lr}], C={C}, max_lookback {LOOKBACK}")
    log(f"B asof_merge_lookback: bitwise equal to plain at [{K}, {Ll}]x[{K}, "
        f"{Lr}] C={C}, max_lookback 0/1/4/{LOOKBACK} x skipNulls both ways "
        f"(at 0 also equal to the merge kernel), the value form, 8 s ties, "
        f"2048 s ties (runs longer than a tile), bin-packed [64, 4096] "
        f"rows, [16, 8192] rows with series edges on tile edges (tiles "
        f"{merge.LOOKBACK_TILE} and 16), seq [16, 4096] rows (tiles "
        f"{merge.LOOKBACK_TILE} and 4), and [1, 1000000]; "
        f"kernel {rows['asof_merge_lookback']['ms']:.4f} ms, plain "
        f"{rows['asof_merge_lookback']['plain_ms']:.4f} ms, bound {b:.4f} ms; "
        f"[1, 1000000] {ms_one:.4f} ms; launches by kernel (ms a call): "
        f"{rows['asof_merge_lookback']['stages_ms']}")
    del l_ts, r_ts, r_valids, vals, one_l, one_r, one_v

    # -- rank on the windowed engine's seconds and on nanoseconds ------
    lt = TSDF(left, "event_ts", ["user"], device=dev, dtype=torch.float32)
    engine, rb, ts_long, w = rolling_frame.plan_range_engine(lt, DAY)
    secs = torch.from_numpy(ts_long).to(dev)
    ns = torch.from_numpy(lt.packed_ts()).to(dev)
    if engine != "windowed" or secs.dtype != torch.int32:
        raise AssertionError(f"one-day window picked {engine} over "
                             f"{secs.dtype} seconds, not windowed/int32")
    for keys, shift in ((secs, DAY), (ns, DAY * NS)):
        for side, q in (("left", keys - shift), ("right", keys)):
            got = merge.merge_rank_cuda(keys, q, side)
            check_bitwise(got, merge.merge_rank_plain(keys, q, side),
                          f"rank {keys.dtype} side {side}")
            check_bitwise(got, torch.searchsorted(keys, q, side=side),
                          f"rank {keys.dtype} side {side} vs searchsorted")
    # runs of one key longer than a tile (2048 merged positions), skew
    # both ways, one series of 2^24 + 1 keys
    ties = torch.repeat_interleave(
        torch.arange(40, device=dev, dtype=torch.int32), 5000).expand(4, -1)
    tie_q = torch.sort(torch.randint(-1, 41, (4, 30000), generator=gen,
                                     device=dev, dtype=torch.int32)).values
    many = torch.sort(torch.randint(0, 10**7, (4, 1_000_000), generator=gen,
                                    device=dev, dtype=torch.int32)).values
    few = torch.sort(torch.randint(0, 10**7, (4, 1000), generator=gen,
                                   device=dev, dtype=torch.int32)).values
    one = torch.cumsum(torch.randint(0, 3, (1, 2**24 + 1), generator=gen,
                                     device=dev, dtype=torch.int32), 1,
                       dtype=torch.int32)
    extra = (("ties", ties, tie_q), ("ties_reverse", tie_q, ties),
             ("skew_keys", many, few), ("skew_queries", few, many),
             ("one_series", one, one - DAY))
    for what, keys, q in extra:
        for side in ("left", "right"):
            got = merge.merge_rank_cuda(keys, q, side)
            check_bitwise(got, merge.merge_rank_plain(keys, q, side),
                          f"rank {what} side {side}")
            check_bitwise(got, torch.searchsorted(keys, q, side=side),
                          f"rank {what} side {side} vs searchsorted")

    def rank_bound(keys, q):
        """One read of keys and queries, one int64 write a query; one
        comparison a merged position."""
        K_, Lk_ = keys.shape
        Lq_ = q.shape[-1]
        return bound_ms(K_ * (Lk_ + Lq_) * keys.element_size() + K_ * Lq_ * 8,
                        K_ * (Lk_ + Lq_))

    Kr, Lk = secs.shape
    start_q = secs - DAY
    ns_q = ns - DAY * NS
    b, by = rank_bound(secs, start_q)
    row = dict(
        name="merge_rank", route="cuda",
        source="tempo_tpu_torch/csrc/merge_rank.cu",
        replaces="tempo_tpu/ops/pallas_merge.py:703", max_abs_err=0.0,
        ms=time_ms(lambda: merge.merge_rank_cuda(secs, start_q, "left")),
        plain_ms=time_ms(lambda: merge.merge_rank_plain(secs, start_q,
                                                        "left"), reps=3),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.searchsorted(secs, start_q)),
        shape=f"[{Kr}, {Lk}] int32 keys and queries (window starts)",
        ms_int64=time_ms(lambda: merge.merge_rank_cuda(ns, ns_q, "left")),
        bound_ms_int64=rank_bound(ns, ns_q)[0],
        library_ms_int64=time_ms(lambda: torch.searchsorted(ns, ns_q)))
    for what, keys, q in extra:
        row[f"ms_{what}"] = time_ms(
            lambda: merge.merge_rank_cuda(keys, q, "left"))
        row[f"bound_ms_{what}"] = rank_bound(keys, q)[0]
        row[f"library_ms_{what}"] = time_ms(
            lambda: torch.searchsorted(keys, q))
    rows["merge_rank"] = row
    log(f"B merge_rank: bitwise equal to plain and to torch.searchsorted on "
        f"[{Kr}, {Lk}] int32 seconds and int64 ns, both sides, pads "
        f"clamped, and on runs of 5000 equal keys, [4, 1,000,000] keys x "
        f"[4, 1000] queries and the reverse, and one series of 2^24 + 1 "
        f"keys; kernel {row['ms']:.4f} ms (bound {b:.4f}), plain "
        f"{row['plain_ms']:.4f} ms, torch.searchsorted "
        f"{row['library_ms']:.4f} ms; int64 {row['ms_int64']:.4f} (bound "
        f"{row['bound_ms_int64']:.4f}, torch.searchsorted "
        f"{row['library_ms_int64']:.4f}); "
        + "; ".join(f"{w} {row['ms_' + w]:.4f} (bound "
                    f"{row['bound_ms_' + w]:.4f}, torch.searchsorted "
                    f"{row['library_ms_' + w]:.4f})" for w, _, _ in extra))
    del ns, ns_q, start_q, ties, tie_q, many, few, one, extra

    # -- cumsum3: edge rows, [K, 8192] and phase F's row ---------------
    x, valid = lt.packed_numeric("x")
    sx, sv = d_args[2], d_args[3]
    odd = torch.randn((4, 1024 * 8 + 1), generator=gen, device=dev) * 100
    odd_v = torch.rand(odd.shape, generator=gen, device=dev) > 0.2
    special = odd.clone()
    special[:, 0] = -0.0
    special[:, 1::7] = -0.0
    special[:, 3::101] = float("nan")
    special[:, 5::211] = float("inf")
    special[:, 9::307] = -float("inf")
    special_v = odd_v.clone()
    special_v[:, 0] = True
    cases = [("one tile [4, 1000]", odd[:, :1000].contiguous(),
              odd_v[:, :1000].contiguous()),
             (f"T*2^3+1 {list(odd.shape)}", odd, odd_v),
             (f"-0.0/NaN/inf {list(odd.shape)}", special, special_v),
             (f"{list(sx.shape)}", sx, sv),
             (f"phase F {list(x.shape)}", x, valid)]
    sums_ms = {}
    for what, a, v in cases:
        got = scan.cumsum3_cuda(a, v)
        for want, form in ((scan.cumsum3_plain(a, v), "plain"),
                           (scan.cumsum3_tiled_plain(a, v), "tiled plain")):
            for g, w_, out in zip(got, want, ("x", "x^2", "count")):
                check_bitwise(g, w_, f"cumsum3 {out} ({what}) vs {form}")
        az = torch.where(v, a, 0.0)
        stacked = torch.stack([az, az * az, v.float()])
        sums_ms[what] = (time_ms(lambda: scan.cumsum3_cuda(a, v)),
                         time_ms(lambda: torch.cumsum(stacked, dim=-1)))
    Kx, L = x.shape
    xz = torch.where(valid, x, 0.0)
    planes = torch.stack([xz, xz * xz, valid.float()])
    levels = math.ceil(math.log2(max(L, 2)))
    b, by = bound_ms(Kx * L * (4 + 1 + 12), Kx * L * (1 + 3 * levels))
    rows["cumsum3"] = dict(
        name="cumsum3", route="cuda", source="tempo_tpu_torch/csrc/cumsum3.cu",
        replaces="tempo_tpu/ops/pallas_kernels.py:161", max_abs_err=0.0,
        ms=time_ms(lambda: scan.cumsum3_cuda(x, valid)),
        plain_ms=time_ms(lambda: scan.cumsum3_plain(x, valid), reps=3),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.cumsum(planes, dim=-1)),
        ms_8192_row=sums_ms[f"{list(sx.shape)}"][0],
        library_ms_8192_row=sums_ms[f"{list(sx.shape)}"][1],
        stages_ms=stage_ms(lambda: scan.cumsum3_cuda(x, valid)),
        stages_ms_8192_row=stage_ms(lambda: scan.cumsum3_cuda(sx, sv)),
        shape=f"[{Kx}, {L}]")
    log(f"B cumsum3: bitwise (int32 bit views) equal to plain and to the "
        f"tiled plain version on " + ", ".join(w for w, _, _ in cases)
        + f"; kernel {rows['cumsum3']['ms']:.4f} ms at [{Kx}, {L}], plain "
        f"{rows['cumsum3']['plain_ms']:.4f} ms, torch.cumsum "
        f"{rows['cumsum3']['library_ms']:.4f} ms, bound {b:.4f} ms; "
        + "; ".join(f"{w}: {k_:.4f} ms (torch.cumsum {c_:.4f})"
                    for w, (k_, c_) in sums_ms.items())
        + f"; stages (ms a call) {rows['cumsum3']['stages_ms']} at "
        f"[{Kx}, {L}], {rows['cumsum3']['stages_ms_8192_row']} at "
        f"{list(sx.shape)}")

    # -- the EMA ladder's two-stage form on phase F's rows -------------
    for alpha in (0.2, 1.0):
        got = scan.ema_cuda(x, valid, alpha)
        check_ema(got, scan.ema_plain(x, valid, alpha),
                  f"phase F {list(x.shape)}, alpha {alpha}")
        check_ema(got, scan.ema_tiled_plain(x, valid, alpha),
                  f"phase F {list(x.shape)}, alpha {alpha} (tiled plain)")
    b, by = bound_ms(Kx * L * (4 + 1 + 4), Kx * L * 3 * levels)
    ema_f = dict(shape_phase_f=f"[{Kx}, {L}] (two stages)",
                 ms_phase_f=time_ms(lambda: scan.ema_cuda(x, valid, 0.2)),
                 plain_ms_phase_f=time_ms(lambda: scan.ema_plain(x, valid, 0.2),
                                          reps=3),
                 bound_ms_phase_f=b,
                 stages_ms_phase_f=stage_ms(lambda: scan.ema_cuda(x, valid,
                                                                  0.2)))
    rows["_ema_phase_f"] = ema_f
    log(f"B ema_ladder: bitwise equal to plain and to the tiled plain "
        f"version at phase F's [{Kx}, {L}] (two stages), alpha 0.2 and 1; "
        f"kernel {ema_f['ms_phase_f']:.4f} ms, plain "
        f"{ema_f['plain_ms_phase_f']:.4f} ms, bound {b:.4f} ms; stages (ms "
        f"a call) {ema_f['stages_ms_phase_f']}")
    log(f"B launches while comparing (not counted): {dict(cuda_lib.launches)}")
    return rows


def phase_f(pd, TSDF, left, right, n, n_series):
    """The third slice's chain at full width; returns the launch
    counts."""
    from tempo_tpu_torch import packing, profiling
    from tempo_tpu_torch.ops import cuda_lib

    est = 2 * packing.pad_length(n // n_series)
    if est <= profiling.max_merged_lanes():
        raise AssertionError(f"{est} merged lanes fit one program: the "
                             f"chunked engine would not be picked")
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    steps = {}
    t0 = time.perf_counter()
    df = chain(TSDF, left, right, steps=steps, max_lookback=LOOKBACK,
               window_secs=DAY)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    missing = [k for k in SLICE3_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"slice-3 path never launched {missing}")
    if launches["asof_merge"] or launches["range_stats"] \
            or launches["range_stats_ring"]:
        raise AssertionError(f"slice-3 path took the single-program join or "
                             f"the row-bounded stats: {launches}")
    if len(df) != n:
        raise AssertionError(f"slice-3 path returned {len(df)} rows, not {n}")
    if not np.isfinite(df["EMA_x"].to_numpy()).all():
        raise AssertionError("EMA_x has non-finite values")
    if not (df["count_x"].to_numpy() >= 1).all():
        raise AssertionError("count_x below 1 on a valid row")
    if not np.isfinite(df["mean_x"].to_numpy()).all():
        raise AssertionError("mean_x has non-finite values")
    null_share = float(df["right_wx"].isna().mean())
    if null_share > 0.2:
        raise AssertionError(f"right_wx mostly null ({null_share:.3f})")
    log(f"F slice-3 path: {n} rows a side, {n_series} series, {est} merged "
        f"lanes (limit {profiling.max_merged_lanes()}), {seconds:.3f} s "
        f"pandas->TSDF->asofJoin(maxLookback={LOOKBACK})->withRangeStats("
        f"{DAY} s)->EMA->pandas ({n / seconds:.0f} rows/s); right_wx "
        f"{null_share:.4f} null; launches {launches}")
    log("F steps (wall s, card synchronised after each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))

    # 8 series: kernels (float32) vs the plain versions (CPU, float64)
    users = np.arange(min(8, n_series))
    sl = left[left["user"].isin(users)]
    sr = right[right["user"].isin(users)]
    kw = dict(max_lookback=LOOKBACK, window_secs=DAY)
    small = chain(TSDF, sl, sr, **kw)
    ref = chain(TSDF, sl, sr, device="cpu", **kw)
    for c in ("event_ts", "x", "right_event_ts", "right_wx"):
        if not small[c].equals(ref[c]):
            raise AssertionError(f"8-series {c} differs from the plain "
                                 f"versions")
    np.testing.assert_array_equal(small["count_x"].to_numpy(),
                                  ref["count_x"].to_numpy())
    errs = {}
    for c in ("mean_x", "min_x", "max_x", "sum_x", "stddev_x", "EMA_x"):
        g = small[c].to_numpy(np.float64)
        w = ref[c].to_numpy(np.float64)
        errs[c] = float(np.nanmax(np.abs(g - w)))
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=2e-3 if c == "sum_x" else 1e-4,
                                   equal_nan=True, err_msg=c)
    log(f"F 8 series ({len(small)} rows): card float32 agrees with the CPU "
        f"float64 plain versions (joins equal, count equal, stats and EMA "
        f"within 1e-4, sum within 2e-3); max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return launches, long_row_forms(TSDF, left, n)


def long_row_forms(TSDF, left, n):
    """Two ops on phase F's long rows whose staged forms do not fit: a
    six-hour ``withRangeStats`` (about 14,400 rows of extent: no slot
    holds the halo) and ``resampleEMA`` (rows past the ladder's one-launch
    limit, which the staged form does not take).  Both must take the row
    forms; returns the launch counts."""
    from tempo_tpu_torch.ops import cuda_lib, stream

    lt = TSDF(left, "event_ts", ["user"])
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    stats = lt.withRangeStats(colsToSummarize=["x"],
                              rangeBackWindowSecs=6 * 3600).df
    bars = lt.resampleEMA("1 minute", "x").df
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    if launches["range_stats"] == 0 or launches["resample_ema"] == 0 \
            or launches["range_stats_ring"] or launches["resample_ema_ring"]:
        raise AssertionError(f"long rows did not take the row forms: "
                             f"{launches}")
    if len(stats) != n or not (stats["count_x"].to_numpy() >= 1).all() \
            or not np.isfinite(stats["mean_x"].to_numpy()).all():
        raise AssertionError("six-hour withRangeStats rows or counts wrong")
    if not np.isfinite(bars["EMA_x"].to_numpy()).all():
        raise AssertionError("long-row resampleEMA EMA_x not finite")
    log(f"F long rows: withRangeStats(6 h, up to "
        f"{int(stats['count_x'].max())} rows a frame) and resampleEMA('1 "
        f"minute') take the row forms ({stream.last_plan['range_stats']}, "
        f"{stream.last_plan['resample_ema']}): {seconds:.3f} s; launches "
        f"{launches}")
    return launches


def trades_frame(pd, left, seed: int = 4):
    """A trades-shaped copy of the left frame for vwap (TSDF.scala:
    378-401): ``symbol`` and ``event_ts``, ``price = 100 + |x|`` and
    seeded integer volumes 1-999."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"symbol": left["user"].to_numpy(),
                         "event_ts": left["event_ts"].to_numpy(),
                         "price": 100.0 + np.abs(left["x"].to_numpy()),
                         "volume": rng.integers(1, 1000, len(left))})


SLICE4_STEPS = ("withRangeStats legacy", "withGroupedStats", "vwap",
                "describe", "autocorr", "fourier_transform", "lookbackTensor",
                "filter + selectExpr")


def slice4_steps(TSDF, left, trades, **kw):
    """The fourth slice's steps on one device: the left frame's TSDF and
    name -> a call returning what the step gives back.
    ``withRangeStats`` runs under ``TEMPO_TPU_WINDOW_ENGINE=legacy`` (set
    and restored around it)."""
    import os

    lt = TSDF(left, "event_ts", ["user"], **kw)

    def legacy():
        old = os.environ.get("TEMPO_TPU_WINDOW_ENGINE")
        os.environ["TEMPO_TPU_WINDOW_ENGINE"] = "legacy"
        try:
            return lt.withRangeStats(colsToSummarize=["x"],
                                     rangeBackWindowSecs=10).df
        finally:
            if old is None:
                del os.environ["TEMPO_TPU_WINDOW_ENGINE"]
            else:
                os.environ["TEMPO_TPU_WINDOW_ENGINE"] = old

    return lt, {
        "withRangeStats legacy": legacy,
        "withGroupedStats": lambda: lt.withGroupedStats(freq="1 minute").df,
        "vwap": lambda: TSDF(trades, "event_ts", ["symbol"], **kw).vwap(
            "m").df,
        "describe": lt.describe,
        "autocorr": lambda: lt.autocorr("x", lag=1),
        "fourier_transform": lambda: lt.fourier_transform(1, "x").df,
        "lookbackTensor": lambda: lt.lookbackTensor(["x"], 10),
        "filter + selectExpr": lambda: lt.filter("x > 0").selectExpr(
            "user", "event_ts", "x * 2 AS x2", "abs(x) AS ax").df,
    }


def fft_tolerance(x: np.ndarray) -> float:
    """Largest difference allowed between a float32 cuFFT transform of
    one series and the float64 one: 1e-5 * ||x||_2.  An FFT's error is
    about eps * log2(n) * ||x||_2 (eps 6e-8 in float32, log2(12,756) =
    13.6, so 8e-7 * ||x||_2) times a small constant; n = 12,756 = 4 * 3 *
    1063 has a large prime factor, which cuFFT takes by Bluestein's
    method (three transforms of a padded length), so the constant is
    taken as about 10, and the float32 rounding of the input adds about
    eps * ||x||_2."""
    return 1e-5 * float(np.linalg.norm(x))


def phase_g(pd, TSDF, left, n, n_series):
    """The fourth slice at HHAR scale, each step timed with the card
    synchronised and the counters zeroed before and read after; then 8
    users on the card (float32) against the CPU (float64).  Returns the
    launch counts of the legacy step."""
    from tempo_tpu_torch.ops import cuda_lib

    trades = trades_frame(pd, left)
    lt, steps = slice4_steps(TSDF, left, trades)
    seconds, launches, out = {}, {}, {}
    for name in SLICE4_STEPS:
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        out[name] = steps[name]()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = dict(cuda_lib.launches)
    legacy = launches["withRangeStats legacy"]
    if legacy["legacy_stats"] == 0 or legacy["range_stats"] != 0 \
            or legacy["range_stats_ring"] != 0:
        raise AssertionError(f"legacy withRangeStats did not take the legacy "
                             f"kernel alone: {legacy}")

    # the legacy step against the same call on the row-bounded kernel
    # (auto): the same frames, summed in another order
    stats = out["withRangeStats legacy"]
    auto = TSDF(left, "event_ts", ["user"]).withRangeStats(
        colsToSummarize=["x"], rangeBackWindowSecs=10).df
    np.testing.assert_array_equal(stats["count_x"].to_numpy(),
                                  auto["count_x"].to_numpy())
    legacy_err = {}
    for c in ("mean_x", "min_x", "max_x", "sum_x", "stddev_x"):
        g, w = stats[c].to_numpy(), auto[c].to_numpy()
        legacy_err[c] = float(np.nanmax(np.abs(g - w)))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, equal_nan=True,
                                   err_msg=f"legacy vs auto {c}")
    if len(stats) != n or not (stats["count_x"].to_numpy() >= 1).all():
        raise AssertionError("legacy withRangeStats rows or counts wrong")

    grouped, bars = out["withGroupedStats"], out["vwap"]
    if grouped["count_x"].sum() != n or bars["volume"].sum() != \
            trades["volume"].sum():
        raise AssertionError("grouped stats or vwap lost rows")
    # grouped reductions repeat bitwise on the card (segment sums in a
    # fixed order, no atomics)
    pd.testing.assert_frame_equal(steps["withGroupedStats"](), grouped,
                                  check_exact=True)
    pd.testing.assert_frame_equal(steps["vwap"](), bars, check_exact=True)
    pd.testing.assert_frame_equal(lt.resample("1 minute", "mean").df,
                                  lt.resample("1 minute", "mean").df,
                                  check_exact=True)
    log("G repeat: withGroupedStats('1 minute'), vwap('m') and "
        "resample('1 minute', 'mean') called twice on the card: bitwise "
        "equal")
    if not np.isfinite(bars["vwap"].to_numpy()).all():
        raise AssertionError("vwap has non-finite values")
    table = out["describe"]
    if list(table["summary"]) != ["global", "count", "mean", "stddev", "min",
                                  "max", "missing_vals_pct"] \
            or table["x"][1] != str(n):
        raise AssertionError("describe table malformed")
    ac = out["autocorr"]["autocorr_lag_1"].to_numpy()
    if len(ac) != n_series or not (np.abs(ac) < 0.1).all():
        raise AssertionError("autocorr of white noise not near 0")
    ft = out["fourier_transform"]
    if len(ft) != n or not np.isfinite(ft["ft_real"].to_numpy()).all():
        raise AssertionError("fourier_transform rows or values wrong")
    tensor, mask = out["lookbackTensor"]
    # a row at position p of its series has min(p, 10) earlier rows
    lengths = lt.layout.lengths
    head = np.minimum(lengths, 10)
    expect = int((head * (head - 1) // 2).sum()
                 + 10 * (lengths - head).sum())
    real = (torch.arange(tensor.shape[1], device=mask.device)[None, :]
            < torch.from_numpy(lengths).to(mask.device)[:, None])
    if tensor.shape[2:] != (10, 1) or int(mask[real].sum()) != expect:
        raise AssertionError(f"lookbackTensor shape {tuple(tensor.shape)} "
                             f"or mask count {int(mask[real].sum())} != "
                             f"{expect}")
    sel = out["filter + selectExpr"]
    if list(sel.columns) != ["user", "event_ts", "x2", "ax"] \
            or not (sel["x2"] > 0).all():
        raise AssertionError("filter + selectExpr wrong")
    total = sum(seconds.values())
    log(f"G slice-4 steps at HHAR scale ({n} rows, {n_series} series): "
        f"{total:.3f} s; legacy step launches {legacy}; legacy vs auto "
        f"row-bounded kernel: count equal, max abs diff "
        + ", ".join(f"{k} {v:.3g}" for k, v in legacy_err.items()))
    log("G steps (wall s, card synchronised after each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    other = {k: {n_: c for n_, c in v.items() if c}
             for k, v in launches.items() if k != "withRangeStats legacy"}
    log(f"G launches of the other steps (torch ops, no kernel of the "
        f"port): {other}")

    # 8 users: every step on the card (float32) against the CPU (float64)
    users = np.arange(min(8, n_series))
    sl = left[left["user"].isin(users)]
    st = trades[trades["symbol"].isin(users)]
    _, card = slice4_steps(TSDF, sl, st)
    _, cpu = slice4_steps(TSDF, sl, st, device="cpu")
    errs = {}
    for name in SLICE4_STEPS:
        g, w = card[name](), cpu[name]()
        if name == "lookbackTensor":
            if not torch.equal(g[1].cpu(), w[1]):
                raise AssertionError("8-user lookbackTensor mask differs")
            np.testing.assert_allclose(g[0].cpu().double().numpy(),
                                       w[0].numpy(), rtol=1e-4, atol=1e-4)
            continue
        if name == "describe" or name == "filter + selectExpr":
            pd.testing.assert_frame_equal(g, w)
            continue
        if list(g.columns) != list(w.columns) or len(g) != len(w):
            raise AssertionError(f"8-user {name}: frames differ in shape")
        for c in g.columns:
            if name == "fourier_transform" and c in ("ft_real", "ft_imag"):
                diff = np.abs(g[c].to_numpy() - w[c].to_numpy())
                for u in users:
                    rows = (g["user"] == u).to_numpy()
                    tol = fft_tolerance(w["x"].to_numpy()[rows])
                    if not diff[rows].max() <= tol:
                        raise AssertionError(
                            f"8-user FFT {c} of user {u} off by "
                            f"{diff[rows].max()} (tolerance {tol})")
                    errs[f"fft {c} / ||x||"] = max(
                        errs.get(f"fft {c} / ||x||", 0.0),
                        float(diff[rows].max()) / (tol / 1e-5))
            elif c.startswith("count") or not pd.api.types.is_float_dtype(
                    w[c].dtype):
                pd.testing.assert_series_equal(g[c], w[c], check_dtype=False)
            elif c == "zscore_x":
                # as x - mean: where the window's stddev is near 0 the
                # float32 quotient is ill-conditioned (stddev is held
                # on its own)
                np.testing.assert_allclose(
                    (g[c] * g["stddev_x"]).to_numpy(np.float64),
                    (w[c] * w["stddev_x"]).to_numpy(np.float64),
                    rtol=1e-4, atol=1e-4, equal_nan=True,
                    err_msg=f"8-user {name} {c}")
            else:
                np.testing.assert_allclose(
                    g[c].to_numpy(np.float64), w[c].to_numpy(np.float64),
                    rtol=1e-4, atol=1e-4, equal_nan=True,
                    err_msg=f"8-user {name} {c}")
    feats = {"card": TSDF(sl, "event_ts", ["user"]),
             "cpu": TSDF(sl, "event_ts", ["user"], device="cpu")}
    feats = {k: t.withLookbackFeatures(["x"], 10) for k, t in feats.items()}
    if len(feats["card"]) != len(feats["cpu"]):
        raise AssertionError("8-user withLookbackFeatures rows differ")
    np.testing.assert_allclose(np.asarray(feats["card"]["features"].tolist()),
                               np.asarray(feats["cpu"]["features"].tolist()),
                               rtol=1e-4, atol=1e-4)
    log(f"G 8-user slice ({len(sl)} rows): every step and "
        f"withLookbackFeatures (8 users only: it builds a Python list per "
        f"row) on the card (float32) agree with the CPU (float64): keys, "
        f"timestamps, counts and the host steps equal, values within 1e-4 "
        f"(relative or absolute), the FFT within 1e-5 * ||x||_2 a series; "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return legacy, seconds


def mesh_chain(TSDF, left, right, mesh, steps=None, grouped=True,
               time_axis=None, **kw):
    """Phase H's chain on ``mesh`` (phase K's with ``time_axis``): both
    frames packed once, joined, range stats, exact EMA, then
    (``grouped``) 1-minute grouped stats of x, the joined wx and the EMA,
    collected once.  Returns the EMA frame (still on the mesh) and the
    collected grouped stats; ``steps`` (a dict) collects each step's wall
    seconds, the card synchronised at every step's end."""
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        if steps is not None:
            torch.cuda.synchronize()
            steps[name] = time.perf_counter() - t0
            t0 = time.perf_counter()

    with span("pack/on_mesh"):
        dl = TSDF(left, "event_ts", ["user"], **kw).on_mesh(
            mesh, time_axis=time_axis)
        dr = TSDF(right, "event_ts", ["user"], **kw).on_mesh(
            mesh, time_axis=time_axis)
    mark("on_mesh x2")
    with span("join"):
        joined = dl.asofJoin(dr)
    mark("asofJoin")
    with span("stats"):
        stats = joined.withRangeStats(colsToSummarize=["x"],
                                      rangeBackWindowSecs=10)
    mark("withRangeStats")
    with span("EMA"):
        ema = stats.EMA("x", exact=True)
    mark("EMA")
    if not grouped:
        return ema, None
    with span("grouped stats"):
        grouped = ema.withGroupedStats(metricCols=["x", "right_wx", "EMA_x"],
                                       freq="1 minute")
    mark("withGroupedStats")
    with span("collect"):
        out = grouped.collect().df
    mark("collect")
    return ema, out


def mesh_tail(TSDF, ema, trades, mesh, time_axis=None, **kw):
    """Phase H's second and third chains: resample -> interpolate of the
    EMA frame still on the mesh, and vwap of the trades frame."""
    filled = ema.resample("1 minute", "mean").interpolate(
        method="linear").collect().df
    bars = TSDF(trades, "event_ts", ["symbol"], **kw).on_mesh(
        mesh, time_axis=time_axis).vwap("m").collect().df
    return filled, bars


def check_bucket_stats(got, want, what: str) -> float:
    """Raise unless kernel bucket stats match the plain version: count,
    min and max bitwise, the rest as range stats are held (within 1e-5,
    stddev as the variance, zscore as ``x - mean``)."""
    for k in ("min", "max"):
        check_bitwise(got[k], want[k], f"bucket stats {k} ({what})")
    return check_range_stats(got, want, f"bucket stats ({what})")


def check_centre(centre, x, v, what: str) -> None:
    """Raise unless the kernel's row centres ([C, K]) are within the
    bound of two float32 sums of the same n terms in different orders of
    the plain version's: |difference| <= 2 (n - 1) 2^-24 sum|x| / n, plus
    an ulp of each quotient."""
    from tempo_tpu_torch.ops import bucket

    want = bucket._bucket_center(x, v)[..., 0]
    n = v.sum(-1).clamp(min=1).to(torch.float64)
    mass = torch.where(v, x, 0.0).abs().sum(-1, dtype=torch.float64)
    ulp = torch.finfo(torch.float32).eps * want.abs().to(torch.float64)
    bound = 2 * (n - 1) * 2.0 ** -24 * mass / n + 2 * ulp
    diff = (centre.to(torch.float64) - want.to(torch.float64)).abs()
    if not bool((diff <= bound).all()):
        raise AssertionError(f"bucket stats ({what}): the kernel's centres "
                             f"differ from the plain version's by "
                             f"{float(diff.max()):.3g}, past a float32 sum's "
                             f"bound")


def phase_b_bucket(pd, TSDF, left, right, left3, dev):
    """The bucket-stats kernel against its plain version on the card;
    returns its row of the result line (``launches`` filled in by phase
    H)."""
    from tempo_tpu_torch import dist, make_mesh
    from tempo_tpu_torch.ops import bucket, cuda_lib, stream

    gen = torch.Generator(device=dev).manual_seed(5)
    mesh = make_mesh()
    # phase H's inputs: the HHAR left frame's 1-minute bucket ids over x,
    # the joined right_wx and EMA_x
    ema, _ = mesh_chain(TSDF, left, right, mesh, grouped=False)
    ts, mask = ema.ts[0], ema.mask[0]
    _, _, bid = dist._bucket_heads(ts, mask, 60 * NS)
    xs, vs = ema._stack(["x", "right_wx", "EMA_x"])
    xs, vs = xs[0], vs[0]
    cases = [("HHAR [3, K, L]: x, right_wx, EMA_x", bid, xs, vs),
             ("HHAR x alone", bid, xs[:1], vs[:1])]
    sparse = vs[:1] & (torch.rand(vs[:1].shape, generator=gen, device=dev)
                       > 0.3)
    cases.append(("HHAR x, 30% more nulls", bid, xs[:1], sparse))
    # pad lanes, an all-null row and an all-pad row
    Ks, Ls = 64, 4096
    sb = torch.sort(torch.randint(0, 200, (Ks, Ls), generator=gen,
                                  device=dev), dim=-1).values.to(torch.int32)
    sx = torch.randn((1, Ks, Ls), generator=gen, device=dev)
    sv = torch.rand((1, Ks, Ls), generator=gen, device=dev) > 0.2
    sb[0, 3000:] = 2**31 - 1
    sv[0, 0, 3000:] = False
    sx[0, 0, 3000:] = float("nan")
    sv[0, 1] = False
    sb[2] = 2**31 - 1
    sv[0, 2] = False
    sx[0, 2] = float("nan")
    cases.append((f"[{Ks}, {Ls}] pads, all-null and all-pad rows",
                  sb, sx, sv))
    # phase F's long rows in 1-minute buckets; then long buckets: HHAR's
    # x in hourly buckets (about 2,400 lanes, past the staged form's 1024), and
    # phase F's long rows in one bucket a row
    lt3 = TSDF(left3, "event_ts", ["user"], device=dev, dtype=torch.float32)
    lts = torch.from_numpy(lt3.packed_ts()).to(dev)
    lmask = torch.from_numpy(lt3.packed_mask()).to(dev)
    lx, lv = lt3.packed_numeric("x")
    _, _, lbid = dist._bucket_heads(lts, lmask, 60 * NS)
    _, _, hbid = dist._bucket_heads(ts, mask, 3600 * NS)
    _, _, obid = dist._bucket_heads(lts, lmask, 365 * DAY * NS)
    cases.append((f"long rows {list(lx.shape)}", lbid, lx[None], lv[None]))
    cases.append(("HHAR x, hourly buckets", hbid, xs[:1], vs[:1]))
    cases.append((f"long rows {list(lx.shape)}, one bucket a row", obid,
                  lx[None], lv[None]))
    # In buckets of thousands of lanes, sum = s1 + count * centre carries
    # count times the centre's rounding difference (the plain version sums
    # the row in another order), past 1e-5: the last two cases hold mean,
    # sum, stddev and zscore only through the bitwise checks below.
    short = len(cases) - 2
    err, err_long, long_rows = 0.0, 0.0, {}
    for n_case, (what, b, x, v) in enumerate(cases):
        want = bucket.bucket_stats_plain(b, x, v)
        row_out = bucket.bucket_stats_cuda(b, x, v, _form="row")
        for k in ("count", "min", "max"):
            check_bitwise(row_out[k], want[k], f"bucket stats {k} ({what})")
        if n_case < short:
            err = max(err, check_bucket_stats(row_out, want, what))
        else:
            err_long = max(err_long, max(
                float((row_out[k] - want[k]).abs().nan_to_num(0).max())
                for k in ("mean", "sum")))
        # every output bitwise equal to the row form's CPU mirror, run on
        # the card around the kernel's own centres, whose difference from
        # the plain version's centres is a float32 summation's
        out = torch.empty((len(bucket.BUCKET_STATS),) + tuple(x.shape),
                          device=dev)
        centre = bucket._bucket_row_form(b.contiguous(), x.contiguous(),
                                         v.contiguous(), out)
        check_same({k: out[i] for i, k in enumerate(bucket.BUCKET_STATS)},
                   row_out, f"bucket stats row form ({what}) run twice")
        check_same(row_out, bucket.bucket_stats_tiled_plain(
            b, x, v, 10, center=centre),
            f"bucket stats row form ({what}) against its tiled mirror")
        check_centre(centre, x, v, what)
        ring_out = bucket.bucket_stats_cuda(b, x, v, _form="ring")
        check_same(ring_out, row_out, f"bucket stats staged form ({what})")
        long_rows[what] = stream.last_plan["bucket_stats"]["long_rows"]
    del want, row_out, ring_out, out

    def bucket_bound(C_, K_, L_):
        steps = math.ceil(math.log2(max(L_, 2)))
        nbytes = K_ * L_ * 4 + C_ * K_ * L_ * (4 + 1) + 7 * C_ * K_ * L_ * 4
        return bound_ms(nbytes, C_ * K_ * L_ * (steps * 13 + 25))

    C, K, L = xs.shape
    b_ms, by = bucket_bound(C, K, L)
    KL, LL = lx.shape
    row = dict(
        name="bucket_stats", route="cuda",
        source="tempo_tpu_torch/csrc/bucket_stats.cu",
        replaces="tempo_tpu/ops/pallas_bucket.py:173", max_abs_err=err,
        max_abs_err_long_buckets=err_long,
        ms=time_ms(lambda: bucket.bucket_stats_cuda(bid, xs, vs,
                                                    _form="row")),
        plain_ms=time_ms(lambda: bucket.bucket_stats_plain(bid, xs, vs),
                         reps=3),
        bound_ms=b_ms, bound_by=by, library_ms=None,
        ms_one_column=time_ms(lambda: bucket.bucket_stats_cuda(
            bid, xs[:1], vs[:1], _form="row")),
        ms_hourly_one_column=time_ms(lambda: bucket.bucket_stats_cuda(
            hbid, xs[:1], vs[:1], _form="row")),
        plain_ms_hourly_one_column=time_ms(lambda: bucket.bucket_stats_plain(
            hbid, xs[:1], vs[:1]), reps=3),
        bound_ms_one_column=bucket_bound(1, K, L)[0],
        stages_ms_hourly_one_column=stage_ms(lambda: bucket.bucket_stats_cuda(
            hbid, xs[:1], vs[:1], _form="row")),
        ms_small_rows=time_ms(lambda: bucket.bucket_stats_cuda(
            sb, sx, sv, _form="row")),
        ms_long_rows=time_ms(lambda: bucket.bucket_stats_cuda(
            lbid, lx[None], lv[None], _form="row")),
        ms_one_bucket_rows=time_ms(lambda: bucket.bucket_stats_cuda(
            obid, lx[None], lv[None], _form="row")),
        plain_ms_one_bucket_rows=time_ms(lambda: bucket.bucket_stats_plain(
            obid, lx[None], lv[None]), reps=3),
        bound_ms_long_rows=bucket_bound(1, KL, LL)[0],
        stages_ms_one_bucket_rows=stage_ms(lambda: bucket.bucket_stats_cuda(
            obid, lx[None], lv[None], _form="row")),
        ring_ms_one_column=time_ms(lambda: bucket.bucket_stats_cuda(
            bid, xs[:1], vs[:1], _form="ring")),
        ring_ms_long_rows=time_ms(lambda: bucket.bucket_stats_cuda(
            lbid, lx[None], lv[None], _form="ring")),
        ring_ms_hourly_one_column=time_ms(lambda: bucket.bucket_stats_cuda(
            hbid, xs[:1], vs[:1], _form="ring")),
        shape=f"[{C}, {K}, {L}] (1-minute buckets); one column (1-minute "
              f"and hourly buckets); [1, {Ks}, {Ls}]; long rows [1, {KL}, "
              f"{LL}] (1-minute buckets, one bucket a row)")
    log(f"B bucket_stats: count/min/max bitwise on "
        f"{'; '.join(c[0] for c in cases)}; the rest within 1e-5 on the "
        f"first {short} (max abs err {err:.3g}; {err_long:.3g} on the long "
        f"buckets); every output of the row form bitwise equal to its "
        f"tiled mirror with the kernel's centres (each within a float32 "
        f"summation's bound of the plain centre), and the staged form's at "
        f"the default depth "
        f"(long-bucket rows left to the row form: {long_rows}); row form "
        f"{row['ms']:.4f} ms (one column {row['ms_one_column']:.4f}, hourly "
        f"{row['ms_hourly_one_column']:.4f}, stages "
        f"{row['stages_ms_hourly_one_column']}; [1, {Ks}, {Ls}] "
        f"{row['ms_small_rows']:.4f}; long rows {row['ms_long_rows']:.4f}, "
        f"one bucket a row {row['ms_one_bucket_rows']:.4f}, stages "
        f"{row['stages_ms_one_bucket_rows']}), plain {row['plain_ms']:.4f} "
        f"ms (hourly one column {row['plain_ms_hourly_one_column']:.4f}, one "
        f"bucket a row {row['plain_ms_one_bucket_rows']:.4f}), bound "
        f"{b_ms:.4f} ms ({by}); staged one column "
        f"{row['ring_ms_one_column']:.4f} ms, long rows "
        f"{row['ring_ms_long_rows']:.4f} ms, hourly one column (its rows "
        f"left to the row form) {row['ring_ms_hourly_one_column']:.4f} ms")
    rows = {"bucket_stats": row}
    rows.update(ring_rows(
        "bucket_stats", lambda: bucket.bucket_stats_cuda(bid, xs, vs,
                                                         _form="ring"),
        bucket.bucket_stats_cuda(bid, xs, vs, _form="row"),
        bucket.bucket_stats_plain(bid, xs, vs), check_bucket_stats, row,
        "tempo_tpu_torch/csrc/bucket_stats.cu",
        lambda p: (C, p["tile"], p["depth"])))
    log(f"B launches while comparing (not counted): {dict(cuda_lib.launches)}")
    del ema
    return rows


# rows just past the limits the kernels had before their class stages
# could run windowed (EMA and resample EMA 14,876,672 lanes, cumsum3
# 9,917,440, bucket stats' row form 4,958,208) and before range stats
# counted clipped lanes in integers (2^24)
EMA_OLD_MAX, CUMSUM3_OLD_MAX, BUCKET_OLD_MAX = 14_876_672, 9_917_440, 4_958_208
CLIP_OLD_MAX = 1 << 24


def phase_b_past_limits(dev):
    """Each kernel on one row just past its old limit, held against its
    plain version on the card as phase B holds it (the EMA, resample EMA
    and cumsum3 bitwise, also against their tiled mirrors; bucket stats'
    row form count/min/max bitwise against the plain version and every
    output bitwise against its tiled mirror at the kernel's centres; range
    stats' both forms bitwise against the plain version at the kernel's
    centres and ``clipped`` equal to the exact count rounded once to
    float32), each timed beside its bound.  Returns the extra keys of each
    kernel's row of the result line."""
    from tempo_tpu_torch.ops import bucket, cuda_lib, scan, stream, window

    gen = torch.Generator(device=dev).manual_seed(11)
    extra = {}
    L = EMA_OLD_MAX + 1
    x = torch.randn((1, L), generator=gen, device=dev)
    v = torch.rand((1, L), generator=gen, device=dev) > 0.1
    x[0, ::11] = -0.0
    x[0, 5::9973] = float("nan")
    # alpha 0.001 keeps every level's d far from 0, so the class stages
    # show in the bits; alpha 1 turns them into copies of -0.0 and +0.0
    for alpha in (0.2, 0.001, 1.0):
        got = scan.ema_cuda(x, v, alpha)
        check_bitwise(got, scan.ema_plain(x, v, alpha),
                      f"ema [1, {L}], alpha {alpha}")
        check_bitwise(got, scan.ema_tiled_plain(x, v, alpha),
                      f"ema [1, {L}], alpha {alpha} (tiled mirror)")
    levels = math.ceil(math.log2(L))
    b, by = bound_ms(L * 9, L * 3 * levels)
    extra["ema_ladder"] = dict(
        shape_past_limit=f"[1, {L}] (three stages)",
        ms_past_limit=time_ms(lambda: scan.ema_cuda(x, v, 0.001), reps=5),
        plain_ms_past_limit=time_ms(lambda: scan.ema_plain(x, v, 0.001),
                                    reps=2),
        bound_ms_past_limit=b,
        stages_ms_past_limit=stage_ms(lambda: scan.ema_cuda(x, v, 0.001), 3))
    secs = torch.cumsum(torch.randint(1, 3, (1, L), generator=gen,
                                      device=dev), -1).to(torch.int32)
    for step, scale in ((60, None), (7, 1.5)):
        got = bucket.resample_ema_cuda(secs, x, v, step, 0.05, scale)
        check_same(got, bucket.resample_ema_plain(secs, x, v, step, 0.05, scale),
                   f"resample_ema [1, {L}], step {step}")
        check_same(got, bucket.resample_ema_tiled_plain(secs, x, v, step, 0.05,
                                                        scale),
                   f"resample_ema [1, {L}], step {step} (tiled mirror)")
    b, by = bound_ms(L * 17, L * 3 * levels)
    extra["resample_ema"] = dict(
        shape_past_limit=f"[1, {L}] (three stages)",
        ms_past_limit=time_ms(lambda: bucket.resample_ema_cuda(
            secs, x, v, 60, 0.05), reps=5),
        plain_ms_past_limit=time_ms(lambda: bucket.resample_ema_plain(
            secs, x, v, 60, 0.05), reps=2),
        bound_ms_past_limit=b)
    del secs
    L3 = CUMSUM3_OLD_MAX + 1
    xc, vc = x[:, :L3].contiguous(), v[:, :L3].contiguous()
    got = scan.cumsum3_cuda(xc, vc)
    check_same(got, scan.cumsum3_plain(xc, vc), f"cumsum3 [1, {L3}]")
    check_same(got, scan.cumsum3_tiled_plain(xc, vc),
               f"cumsum3 [1, {L3}] (tiled mirror)")
    xz = torch.where(vc, xc, 0.0)
    planes = torch.stack([xz, xz * xz, vc.float()])
    b, by = bound_ms(L3 * 17, L3 * 3 * math.ceil(math.log2(L3)))
    extra["cumsum3"] = dict(
        shape_past_limit=f"[1, {L3}] (three stages)",
        ms_past_limit=time_ms(lambda: scan.cumsum3_cuda(xc, vc), reps=5),
        plain_ms_past_limit=time_ms(lambda: scan.cumsum3_plain(xc, vc), reps=2),
        library_ms_past_limit=time_ms(lambda: torch.cumsum(planes, dim=-1),
                                      reps=5),
        bound_ms_past_limit=b)
    del xc, vc, xz, planes

    # bucket stats' row form: 1-minute buckets (no row needs a class
    # stage), one bucket a row and buckets of 300,000 lanes (three stages
    # on a live row, the windowed stage's flags read by the third)
    Lb = BUCKET_OLD_MAX + 1
    xb, vb = x[:, :Lb][None].contiguous(), v[:, :Lb][None].contiguous()
    xb[0, 0, 5::9973] = 2.5
    minute = (torch.cumsum(torch.randint(1, 3, (1, Lb), generator=gen,
                                         device=dev), -1) // 60).to(torch.int32)
    cases = [("1-minute buckets", minute),
             ("one bucket", torch.zeros((1, Lb), dtype=torch.int32, device=dev)),
             ("buckets of 300,000 lanes",
              (torch.arange(Lb, device=dev)[None] // 300_000).to(torch.int32))]
    times = {}
    for what, bid in cases:
        out = torch.empty((len(bucket.BUCKET_STATS), 1, 1, Lb), device=dev)
        centre = bucket._bucket_row_form(bid, xb, vb, out)
        got = {k: out[i] for i, k in enumerate(bucket.BUCKET_STATS)}
        want = bucket.bucket_stats_plain(bid, xb, vb)
        for k in ("count", "min", "max"):
            check_bitwise(got[k], want[k], f"bucket stats {k} [1, {Lb}] ({what})")
        check_same(got, bucket.bucket_stats_tiled_plain(bid, xb, vb, 10,
                                                        center=centre),
                   f"bucket stats row form [1, {Lb}] ({what}) against its "
                   f"tiled mirror")
        check_centre(centre, xb, vb, f"[1, {Lb}] ({what})")
        times[what] = time_ms(lambda: bucket._bucket_row_form(bid, xb, vb, out),
                              reps=3)
    steps = math.ceil(math.log2(Lb))
    b, by = bound_ms(Lb * 4 + Lb * 5 + 7 * Lb * 4, Lb * (steps * 13 + 25))
    extra["bucket_stats"] = dict(
        shape_past_limit=f"[1, {Lb}] ({', '.join(times)})",
        ms_past_limit=times["1-minute buckets"],
        ms_past_limit_one_bucket=times["one bucket"],
        ms_past_limit_300k=times["buckets of 300,000 lanes"],
        bound_ms_past_limit=b,
        stages_ms_past_limit_one_bucket=stage_ms(
            lambda: bucket._bucket_row_form(cases[1][1], xb, vb, out), 2))
    del x, v, xb, vb, minute, cases, out

    # range stats past 2^24 lanes, both forms: two rows a second, a 10 s
    # window both ways and bounds (4, 4), so every lane clips: 2^24 + 1
    # lanes (the count rounds to 2^24 in float32) and 2^24 + 5 (it rounds
    # to 2^24 + 4, past where a float tally stops)
    res = {}
    for Lr, mb, ma in ((CLIP_OLD_MAX + 1, 4, 4), (CLIP_OLD_MAX + 5, 4, 4)):
        rs = (torch.arange(Lr, device=dev, dtype=torch.int32) // 2)[None]
        rx = torch.randn((1, 1, Lr), generator=gen, device=dev)
        rv = torch.ones((1, 1, Lr), dtype=torch.bool, device=dev)
        args = (rs, rx, rv, 10, mb, ma)
        exact = window.range_stats_plain(rs, rx.double(), rv, 10, mb, ma,
                                         window_ahead=10 if ma else 0)
        exact = int(exact["clipped"].flatten()[0])
        if exact <= CLIP_OLD_MAX:
            raise AssertionError(f"range stats [1, {Lr}]: the case clips "
                                 f"{exact} lanes, not past 2^24")
        for form in ("row", "ring"):
            centre = torch.empty((1, 1), device=dev)
            got = window.range_stats_cuda(*args, window_ahead=10 if ma else 0,
                                          _form=form, _center_out=centre)
            want = window.range_stats_plain(*args, window_ahead=10 if ma else 0,
                                            _centers=centre)
            check_same({k: got[k] for k in window.STATS},
                       {k: want[k] for k in window.STATS},
                       f"range stats [1, {Lr}] ({form} form) against the plain "
                       f"version at the kernel's centres")
            clipped = got["clipped"].flatten()[0]
            if clipped.item() != float(np.float32(exact)):
                raise AssertionError(f"range stats [1, {Lr}] ({form} form): "
                                     f"clipped {clipped.item()}, exact count "
                                     f"{exact} rounds to {np.float32(exact)}")
            res[(Lr, form)] = (time_ms(lambda: window.range_stats_cuda(
                *args, window_ahead=10 if ma else 0, _form=form), reps=2),
                exact)
            if form == "ring" and Lr == CLIP_OLD_MAX + 1:
                plan_long = dict(stream.last_plan["range_stats"])
                stages_long = stage_ms(lambda: window.range_stats_cuda(
                    *args, window_ahead=10 if ma else 0, _form=form), 3)
                # the centre pass alone (CUDA events; not a counted launch)
                c1, cl1 = torch.empty((1, 1), device=dev), torch.empty(
                    (1, 1, 1), device=dev)
                t1 = torch.empty((1, 1), dtype=torch.int32, device=dev)

                def centres_alone():
                    code = cuda_lib.lib().tempo_range_centres(
                        rx.data_ptr(), rv.data_ptr(), None, c1.data_ptr(),
                        cl1.data_ptr(), t1.data_ptr(), 1, 1, Lr,
                        cuda_lib.stream_handle(dev))
                    if code:
                        raise AssertionError(f"range_centres alone: CUDA "
                                             f"error {code}")
                centres_long = time_ms(centres_alone, reps=3)
    Lr = CLIP_OLD_MAX + 1
    b, by = bound_ms(Lr * (4 + 5 + 28), Lr * 9 * 10)
    extra["range_stats"] = dict(
        shape_past_limit=f"[1, {Lr}] and [1, {Lr + 4}] at bounds (4, 4), "
                         f"10 s both ways",
        ms_past_limit=res[(Lr, "row")][0],
        ms_past_limit_staged=res[(Lr, "ring")][0],
        stages_ms_past_limit_staged=stages_long,
        ms_past_limit_centres=centres_long,
        plan_past_limit_staged=plan_long,
        clipped_exact_past_limit=[res[(Lr, "row")][1], res[(Lr + 4, "row")][1]],
        bound_ms_past_limit=b)
    log("B past the old limits: "
        + "; ".join(f"{k} {e['shape_past_limit']}: {e['ms_past_limit']:.4f} ms "
                    f"(bound {e['bound_ms_past_limit']:.4f})"
                    for k, e in extra.items())
        + f"; EMA, resample EMA and cumsum3 bitwise against plain and tiled "
        f"mirror; bucket stats' row form count/min/max bitwise against plain, "
        f"every output against its tiled mirror ({', '.join(times)}); range "
        f"stats both forms bitwise at the kernel's centres, clipped "
        f"{extra['range_stats']['clipped_exact_past_limit']} exact (float32 "
        f"rounded once); staged range stats [1, {Lr}]: "
        f"{extra['range_stats']['ms_past_limit_staged']:.4f} ms, of which "
        f"the centre pass alone {centres_long:.4f} ms (CUDA events), stages "
        f"{stages_long} (profiler), plan {plan_long}")
    log(f"B launches while comparing (not counted): {dict(cuda_lib.launches)}")
    torch.cuda.empty_cache()
    return extra


def phase_i(pd, TSDF):
    """One series of 2^24 + 1 rows, one a second with 5% null x, through
    ``withRangeStats`` (10 s) -> exact ``EMA`` on the card, the counters
    zeroed before and read after: each row's count equals the valid rows
    of its 11 seconds, and the EMA agrees with the plain ladder on the same
    card tensors.  Returns the launch counts."""
    from tempo_tpu_torch.ops import cuda_lib, scan

    n = CLIP_OLD_MAX + 1
    rng = np.random.default_rng(12)
    xs = rng.standard_normal(n)
    xs[rng.random(n) < 0.05] = np.nan
    df = pd.DataFrame({"sensor": np.zeros(n, np.int64),
                       "event_ts": pd.to_datetime(np.arange(n, dtype=np.int64)
                                                  * NS),
                       "x": xs})
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    out = (TSDF(df, "event_ts", ["sensor"], device="cuda", dtype=torch.float32)
           .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10)
           .EMA("x", exact=True))
    res = out.df
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    if launches["ema_ladder"] == 0 or \
            launches["range_stats"] + launches["range_stats_ring"] == 0:
        raise AssertionError(f"long series: launches {launches}")
    if len(res) != n:
        raise AssertionError(f"long series: {len(res)} rows, not {n}")
    ok = ~np.isnan(xs)
    c = np.concatenate([[0], np.cumsum(ok)])
    want = c[1:] - c[np.maximum(np.arange(n) - 10, 0)]
    if not np.array_equal(res["count_x"].to_numpy(np.int64), want):
        raise AssertionError("long series: count_x differs from the valid "
                             "rows of each 11 s")
    x = torch.from_numpy(xs.astype(np.float32))[None].cuda()
    ema = scan.ema_plain(torch.nan_to_num(x), torch.from_numpy(ok)[None].cuda(),
                         0.2)
    if not np.array_equal(res["EMA_x"].to_numpy(np.float32).view(np.int32),
                          ema[0].cpu().numpy().view(np.int32)):
        raise AssertionError("long series: EMA_x differs from the plain ladder")
    log(f"I one series of {n} rows: withRangeStats(10 s) -> EMA on the card "
        f"in {seconds:.3f} s; count_x equal to each row's valid rows in 11 s, "
        f"EMA_x bitwise equal to the plain ladder; launches {launches}")
    return launches


def compare_card_cpu(card, cpu, what: str) -> float:
    """Raise unless a frame from the card (float32) agrees with the CPU's
    (float64): keys, timestamps and integer columns (counts) equal, values within
    1e-4 (relative or absolute), stddev as the variance (near-constant
    buckets: float32 cancellation in s2 - s1*s1/n, which the square root
    blows up).  Returns the largest absolute difference."""
    if list(card.columns) != list(cpu.columns) or len(card) != len(cpu):
        raise AssertionError(f"{what}: frames differ in shape")
    err = 0.0
    for c in cpu.columns:
        g, w = card[c], cpu[c]
        if not np.issubdtype(w.dtype, np.floating):
            if not np.array_equal(g.to_numpy(), w.to_numpy()):
                raise AssertionError(f"{what}: {c} differs")
            continue
        g, w = g.to_numpy(np.float64), w.to_numpy(np.float64)
        if c.startswith("stddev"):
            g, w = g * g, w * w
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   equal_nan=True, err_msg=f"{what} {c}")
        err = max(err, float(np.nanmax(np.abs(g - w), initial=0.0)))
    return err


def phase_h(pd, TSDF, left, right, n, n_series, c_seconds, keep):
    """The fifth slice: the distributed frame on one shard of the card at
    HHAR scale, its launch counters and pack/fetch events read around
    each chain; then 64 users on two shards of the card (bitwise equal
    to one shard) and on the CPU (float64).  The first chain's output and
    step times go into ``keep["H"]`` for phase J.  Returns the chains'
    launch counts."""
    from tempo_tpu_torch import dist, make_mesh
    from tempo_tpu_torch.ops import cuda_lib, stream

    mesh = make_mesh()
    if mesh.shape != {"series": torch.cuda.device_count()}:
        raise AssertionError(f"default mesh {mesh.shape}")
    if TSDF(left.head(1000), "event_ts", ["user"]).on_mesh().mesh != mesh:
        raise AssertionError("on_mesh() without a mesh did not take "
                             "make_mesh() over every visible card")

    def counted(fn):
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        p0, f0 = dist._PACK_EVENTS, dist._FETCH_EVENTS
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, dict(cuda_lib.launches),
                (dist._PACK_EVENTS - p0, dist._FETCH_EVENTS - f0))

    steps = {}
    (ema, grouped), seconds, launches, events = counted(
        lambda: mesh_chain(TSDF, left, right, mesh, steps=steps))
    missing = [k for k in ("asof_merge", "range_stats_ring", "ema_ladder",
                           "bucket_stats_ring") if launches[k] == 0]
    if missing:
        raise AssertionError(f"mesh chain never launched {missing}")
    plans = {k: dict(stream.last_plan[k])
             for k in ("range_stats", "bucket_stats")}
    if events != (2, 1):
        raise AssertionError(f"mesh chain packed/fetched {events}, not (2, 1)")
    if int(grouped["count_x"].sum()) != n:
        raise AssertionError("grouped stats lost rows")
    if not np.isfinite(grouped["mean_EMA_x"].to_numpy()).all():
        raise AssertionError("mean_EMA_x has non-finite values")
    log(f"H mesh chain on {mesh.shape} ({n} rows a side, {n_series} "
        f"series): {seconds:.3f} s on_mesh->asofJoin->withRangeStats->EMA->"
        f"withGroupedStats->collect, {len(grouped)} bucket rows "
        f"({n / seconds:.0f} rows/s); phase C's host chain in this run "
        f"{c_seconds:.3f} s; pack/fetch events {events}; launches {launches}")
    log("H steps (wall s, card synchronised after each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))
    keep["H"] = dict(df=grouped, steps=steps, seconds=seconds,
                     planes=global_planes(ema))
    traced("H chain", lambda: len(mesh_chain(TSDF, left, right, mesh)[1]))
    log(f"H staged forms at the default depth "
        f"(TEMPO_TPU_DMA_BUFFERS={stream.dma_buffers()}): {plans}")

    trades = trades_frame(pd, left)
    (filled, bars), tail_s, tail_launches, tail_events = counted(
        lambda: mesh_tail(TSDF, ema, trades, mesh))
    if tail_events != (1, 2):
        raise AssertionError(f"resample/vwap chains packed/fetched "
                             f"{tail_events}, not (1, 2)")
    if tail_launches["bucket_stats"] + tail_launches["bucket_stats_ring"] \
            < 2 or tail_launches["asof_merge"] < 2:
        raise AssertionError(f"resample/interpolate/vwap launches "
                             f"{tail_launches}")
    if int(bars["volume"].sum()) != int(trades["volume"].sum()) \
            or not np.isfinite(bars["vwap"].to_numpy()).all():
        raise AssertionError("mesh vwap lost volume or is not finite")
    if filled["x"].isna().any():
        raise AssertionError("linear interpolation left holes in x")
    keep["H"]["tail"] = (filled, bars)
    keep["H"]["trades"] = trades
    log(f"H resample('1 minute', 'mean').interpolate('linear') of the EMA "
        f"frame ({len(filled)} grid rows) and vwap('m') of the trades copy "
        f"({len(bars)} bars): {tail_s:.3f} s; pack/fetch events "
        f"{tail_events}; launches {tail_launches}")
    del ema
    torch.cuda.empty_cache()

    # the same chain at ring depth 4: bitwise the default run; then
    # hourly buckets (about 2,400 lanes, past the staged form's 1024):
    # those rows take the row form
    with dma_depth(4):
        (ema4, grouped4), deep_s, deep_launches, _ = counted(
            lambda: mesh_chain(TSDF, left, right, mesh))
        deep_plans = {k: dict(stream.last_plan[k])
                      for k in ("range_stats", "bucket_stats")}
    if deep_launches["bucket_stats_ring"] == 0 \
            or deep_launches["range_stats_ring"] == 0:
        raise AssertionError(f"depth-4 chain skipped a staged form: "
                             f"{deep_launches}")
    pd.testing.assert_frame_equal(grouped4, grouped, check_exact=True)
    log(f"H mesh chain at TEMPO_TPU_DMA_BUFFERS=4 (set in-process, "
        f"restored): bitwise equal to the default run, {deep_s:.3f} s; "
        f"{deep_plans}; launches {deep_launches}")
    hourly, hour_s, hour_launches, _ = counted(
        lambda: ema4.withGroupedStats(metricCols=["x"],
                                      freq="1 hour").collect().df)
    n_long = stream.last_plan["bucket_stats"].get("long_rows", 0)
    if hour_launches["bucket_stats"] == 0 or n_long == 0 \
            or int(hourly["count_x"].sum()) != n:
        raise AssertionError(f"hourly grouped stats: launches "
                             f"{hour_launches}, long rows {n_long}")
    log(f"H withGroupedStats('1 hour') of x: {len(hourly)} bucket rows in "
        f"{hour_s:.3f} s; {n_long} series rows hold a bucket longer than "
        f"the staged form's 1024 lanes ({stream.last_plan['bucket_stats']}) and took "
        f"the row form; launches {hour_launches}")
    del ema4
    torch.cuda.empty_cache()

    # 64 users: one shard, two shards of the same card, and the CPU
    users = np.arange(min(64, n_series))
    sl = left[left["user"].isin(users)]
    sr = right[right["user"].isin(users)]
    st = trades[trades["symbol"].isin(users)]
    runs = {}
    for name, m, kw in (
            ("one shard", make_mesh({"series": 1}, devices=["cuda:0"]), {}),
            ("two shards", make_mesh({"series": 2},
                                     devices=["cuda:0", "cuda:0"]), {}),
            ("cpu", make_mesh({"series": 1}, devices=["cpu"]),
             {"device": "cpu"})):
        e, g = mesh_chain(TSDF, sl, sr, m, **kw)
        runs[name] = (g,) + mesh_tail(TSDF, e, st, m, **kw)
    for one, two in zip(runs["one shard"], runs["two shards"]):
        pd.testing.assert_frame_equal(one, two, check_exact=True)
    err = max(compare_card_cpu(g, w, f"64-user {what}") for g, w, what in zip(
        runs["one shard"], runs["cpu"],
        ("grouped stats", "resample/interpolate", "vwap")))
    log(f"H 64 users ({len(sl)} rows a side): two shards on cuda:0 bitwise "
        f"equal to one shard (grouped stats, resample/interpolate, vwap); "
        f"card float32 agrees with the CPU float64 (keys, timestamps, "
        f"counts equal, values within 1e-4, stddev as the variance; max "
        f"abs err {err:.3g})")
    return add_counts(launches, tail_launches, deep_launches, hour_launches)


def pack_steps(pd, df, value_col: str, what: str) -> dict:
    """J.b: one frame's layout sort, gather, pack and unpack (host), the
    native packer against the numpy path in turns, bitwise.  Returns the
    seconds of each step both ways."""
    from tempo_tpu_torch import packing

    key_ids, key_frame = packing.encode_keys(df, ["user"])
    ts_ns = packing.series_to_ns(df["event_ts"])
    vals = df[value_col].to_numpy(np.float64)
    times, outs = {}, {}
    for path in ("native", "numpy", "native again"):
        ctx = native_off() if path == "numpy" else contextlib.nullcontext()
        t, o = {}, {}
        with ctx:
            t0 = time.perf_counter()
            o["order"], o["starts"] = packing._sort_layout(
                key_ids, ts_ns, None, len(key_frame))
            t["_sort_layout"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            o["take"] = packing.take(vals, o["order"])
            t["take"] = time.perf_counter() - t0
            lay = packing.FlatLayout(
                key_ids=packing.take(key_ids, o["order"]),
                ts_ns=packing.take(ts_ns, o["order"]), order=o["order"],
                starts=o["starts"], key_frame=key_frame)
            L = packing.pad_length(int(lay.lengths.max(initial=0)))
            t0 = time.perf_counter()
            o["pack_column"] = packing.pack_column(o["take"], lay, L,
                                                   fill=np.nan)
            t["pack_column"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            o["unpack_column"] = packing.unpack_column(o["pack_column"], lay)
            t["unpack_column"] = time.perf_counter() - t0
        times[path], outs[path] = t, o
    for k, a in outs["native"].items():
        b = outs["numpy"][k]
        if a.dtype != b.dtype or a.shape != b.shape \
                or a.tobytes() != b.tobytes():
            raise AssertionError(f"J {what}: native {k} differs from numpy")
    log(f"J.b {what} ({len(df)} rows, {len(key_frame)} series, [K, L] = "
        f"[{len(key_frame)}, {outs['native']['pack_column'].shape[1]}]), "
        f"wall s native / numpy / native again, bitwise equal: "
        + ", ".join(f"{k} {times['native'][k]:.4f} / {times['numpy'][k]:.4f}"
                    f" / {times['native again'][k]:.4f}"
                    for k in times["native"]))
    return times


def slab_sweep(pd, TSDF, left, n_series: int, ring: int):
    """J.d: phase H's left frame in 8 slabs of series through
    ``io.ingest.sweep_slabs``: load packs a slab on the host, compute
    uploads it (one copy) and runs ``withRangeStats`` (10 s) then exact
    ``EMA`` on the card, drain fetches it.  Returns (frame, seconds,
    launches)."""
    from tempo_tpu_torch import dist, make_mesh, packing
    from tempo_tpu_torch.io import ingest
    from tempo_tpu_torch.ops import cuda_lib

    mesh = make_mesh({"series": 1}, devices=["cuda:0"])
    dev = mesh.axis_devices("series")[0]
    users = left["user"].to_numpy()
    cuts = np.searchsorted(users, np.linspace(0, n_series, 9).astype(int))

    def load(i):
        t = TSDF(left.iloc[cuts[i]:cuts[i + 1]], "event_ts", ["user"])
        lay, L = t.layout, t.packed_len()
        x, ok = t.numeric_flat("x")
        return t, [packing.pack_column(lay.ts_ns, lay, L,
                                       fill=packing.TS_PAD),
                   packing.row_mask(lay, L),
                   packing.pack_column(x.astype(np.float32), lay, L,
                                       fill=np.nan),
                   packing.pack_column(ok, lay, L, fill=False)]

    def compute(i, loaded):
        t, planes = loaded
        ts, mask, x, ok = dist._upload_planes(planes, dev)
        d = dist.DistributedTSDF(
            mesh, "series", None, [ts], [mask],
            {"x": dist.DistCol([x], [ok])}, t.layout, "event_ts", ["user"],
            t.ts_dtype(), t.df, {}, torch.float32)
        return d.withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=10).EMA("x", exact=True)

    def drain(i, d):
        return d.collect().df

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    parts = ingest.sweep_slabs(8, load, compute, drain, ring=ring)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (pd.concat(parts, ignore_index=True), seconds,
            dict(cuda_lib.launches))


def phase_j(pd, TSDF, frames, keep, n_series):
    """The sixth slice: the native packer, resilience, checkpoints, the
    store and Parquet ingest (see the module docstring, phase J)."""
    import importlib.util

    from tempo_tpu_torch import checkpoint, dist, make_mesh, native
    from tempo_tpu_torch.testing import faults

    card = card_line()
    j0 = time.perf_counter()
    t0 = time.perf_counter()
    native.lib()
    cxx = subprocess.run([native.CXX, "--version"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(f"J.a native packer: {cxx.stdout.splitlines()[0]}; "
        f"TEMPO_TPU_NATIVE_THREADS={native.threads()} (os.cpu_count() "
        f"{os.cpu_count()}); built or loaded in "
        f"{time.perf_counter() - t0:.2f} s; card {card}")

    left, right = frames["C"]
    pack_steps(pd, left, "x", "phase C left")
    pack_steps(pd, right, "wx", "phase C right")
    pack_steps(pd, frames["F"][0], "x", "phase F left")
    pack_steps(pd, frames["F"][1], "wx", "phase F right")

    # J.c: phases C and H ran on the native packer; again on numpy
    steps = {}
    with native_off():
        t0 = time.perf_counter()
        df = chain(TSDF, left, right, steps=steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    pd.testing.assert_frame_equal(df, keep["C"]["df"], check_exact=True)
    del df
    log(f"J.c phase C chain, native / numpy packer, bitwise equal: "
        f"{keep['C']['seconds']:.3f} / {seconds:.3f} s; steps "
        + ", ".join(f"{k} {keep['C']['steps'][k]:.3f} / {v:.3f}"
                    for k, v in steps.items()) + f"; card {card}")
    mesh = make_mesh()
    steps = {}
    with native_off():
        t0 = time.perf_counter()
        ema, grouped = mesh_chain(TSDF, left, right, mesh, steps=steps)
        seconds = time.perf_counter() - t0
    del ema
    pd.testing.assert_frame_equal(grouped, keep["H"]["df"], check_exact=True)
    log(f"J.c phase H chain, native / numpy packer, bitwise equal: "
        f"{keep['H']['seconds']:.3f} / {seconds:.3f} s; steps "
        + ", ".join(f"{k} {keep['H']['steps'][k]:.3f} / {v:.3f}"
                    for k, v in steps.items()) + f"; card {card}")
    torch.cuda.empty_cache()

    # J.d: the slab sweep at ring depths 1, 2 and 3
    first = None
    for ring in (1, 2, 3):
        out, seconds, launches = slab_sweep(pd, TSDF, left, n_series, ring)
        if launches["ema_ladder"] == 0 or \
                launches["range_stats"] + launches["range_stats_ring"] == 0:
            raise AssertionError(f"J sweep ring {ring}: launches {launches}")
        if len(out) != len(left):
            raise AssertionError(f"J sweep ring {ring}: {len(out)} rows")
        if first is None:
            first = out
        else:
            pd.testing.assert_frame_equal(out, first, check_exact=True)
        log(f"J.d sweep_slabs of phase H's left frame in 8 slabs at ring "
            f"{ring}: {seconds:.3f} s, bitwise equal to ring 1; launches "
            f"{ {k: v for k, v in launches.items() if v} }; card {card}")
    del first, out
    torch.cuda.empty_cache()

    # J.e: state snapshots of phase H's mesh frame planes
    import tempfile

    dl = TSDF(left, "event_ts", ["user"]).on_mesh(mesh)
    planes = {"ts": dl.ts[0], "mask": dl.mask[0], "x": dl.cols["x"].values[0],
              "x_valid": dl.cols["x"].valid[0]}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checkpoint.save_state(planes, os.path.join(tmp, "bad"))
        save_s = time.perf_counter() - t0
        name = faults.corrupt_npz_array(os.path.join(tmp, "bad", "state.npz"),
                                        "x")
        try:
            checkpoint.load_state(os.path.join(tmp, "bad"))
        except checkpoint.CheckpointError as e:
            if repr(name) not in str(e):
                raise AssertionError(f"J flipped byte: {e} does not name "
                                     f"{name!r}") from e
        else:
            raise AssertionError("J flipped byte: load_state raised nothing")
        checkpoint.save_state(planes, os.path.join(tmp, "good"))
        t0 = time.perf_counter()
        arrays, _ = checkpoint.load_state(os.path.join(tmp, "good"))
        names = list(planes)
        back = dist._upload_planes([arrays[k] for k in names], dl.devices[0])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        for k, t in zip(names, back):
            if not torch.equal(t.view(torch.uint8), planes[k].contiguous()
                               .view(torch.uint8)):
                raise AssertionError(f"J save_state: plane {k} differs")
        log(f"J.e save_state of the mesh frame's 4 planes "
            f"({sum(a.nbytes for a in arrays.values())} bytes) in "
            f"{save_s:.3f} s; a flipped byte in {name!r} raised "
            f"CheckpointError naming it; load_state + one upload in "
            f"{load_s:.3f} s, bitwise equal to the frame's planes; card "
            f"{card}")

        # J.f: the Parquet parts, where pyarrow is present
        if importlib.util.find_spec("pyarrow") is None:
            log("J.f not run: pyarrow is not installed on this machine "
                "(checkpoint.save/load of a mesh frame and TSDF.write -> "
                "from_parquet need it; they raise ImportError by name)")
        else:
            parquet_parts(pd, TSDF, left, right, mesh, dl, tmp, card)
    log(f"J total: {time.perf_counter() - j0:.3f} s; card {card}")


def parquet_parts(pd, TSDF, left, right, mesh, dl, tmp, card):
    """J.f: a mesh checkpoint continued bitwise, and a table written then
    ingested onto ``make_mesh()``."""
    from tempo_tpu_torch import checkpoint, make_mesh
    from tempo_tpu_torch.io import ingest

    joined = dl.asofJoin(TSDF(right, "event_ts", ["user"]).on_mesh(mesh))
    t0 = time.perf_counter()
    checkpoint.save(joined, os.path.join(tmp, "mesh"))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = checkpoint.load(os.path.join(tmp, "mesh"), mesh=make_mesh())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def rest(d):
        return d.withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=10).EMA(
            "x", exact=True).withGroupedStats(
            metricCols=["x", "right_wx", "EMA_x"],
            freq="1 minute").collect().df

    pd.testing.assert_frame_equal(rest(loaded), rest(joined),
                                  check_exact=True)
    del joined, loaded
    torch.cuda.empty_cache()
    log(f"J.f checkpoint.save of phase H's joined mesh frame in "
        f"{save_s:.3f} s, load onto make_mesh() in {load_s:.3f} s; the "
        f"chain continued (withRangeStats -> EMA -> withGroupedStats -> "
        f"collect) bitwise equal to the uninterrupted one; card {card}")

    part = left[left["user"] < 64]
    t0 = time.perf_counter()
    path = TSDF(part, "event_ts", ["user"]).write(
        "j", base_dir=os.path.join(tmp, "wh"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ingested = ingest.from_parquet(path, "event_ts", ["user"],
                                   mesh=make_mesh())
    got = ingested.collect().df
    ingest_s = time.perf_counter() - t0
    # ingest orders keys by their text ("10" before "2")
    got = got.sort_values(["user", "event_ts"], kind="stable") \
        .reset_index(drop=True)
    compute = np.float32 if ingested.dtype == torch.float32 \
        else np.float64
    want = part.reset_index(drop=True).assign(
        x=part["x"].to_numpy().astype(compute).astype(np.float64))
    pd.testing.assert_frame_equal(
        got[list(want.columns)], want, check_exact=True,
        check_dtype=False)
    log(f"J.f TSDF.write of 64 users ({len(part)} rows) in "
        f"{write_s:.3f} s -> from_parquet onto make_mesh() -> collect in "
        f"{ingest_s:.3f} s: equal to the source (x as "
        f"{np.dtype(compute).name}); card {card}")


# ----------------------------------------------------------------------
# Phase K: the mesh's time axis and two processes
# ----------------------------------------------------------------------

TIME_MESHES = ({"series": 2, "time": 2}, {"series": 1, "time": 4})
# float32 EMA over time blocks: the ladder plus a torch.cumprod carry
# against the ladder over whole rows (they associate the decay products
# differently); the same bound holds grouped stats of EMA_x
EMA_CARRY_TOL = 1e-5
HALO_SUM_ATOL = 1e-4
HALO_VAR_ATOL = 2e-3
WORKER_USERS = 64


def global_planes(frame) -> dict:
    """Each column of a mesh frame as global [K, L] (values, validity)
    tensors on the card."""
    from tempo_tpu_torch.parallel.reshard import assemble

    return {c: (assemble(col.values, frame.mesh, frame.spec),
                assemble(col.valid, frame.mesh, frame.spec))
            for c, col in frame.cols.items()}


def counted(fn):
    """``fn()`` with the launch counters zeroed before and read after:
    (result, wall seconds, launches, (pack, fetch) events)."""
    from tempo_tpu_torch import dist
    from tempo_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    p0, f0 = dist._PACK_EVENTS, dist._FETCH_EVENTS
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, dict(cuda_lib.launches),
            (dist._PACK_EVENTS - p0, dist._FETCH_EVENTS - f0))


def check_close(got, want, what: str, tol: float) -> float:
    """Raise unless two float tensors share their NaN pattern and agree
    within ``tol`` (absolute + relative).  Returns the largest absolute
    difference."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{what}: NaN pattern differs")
    diff = (got - want).abs().nan_to_num(0.0)
    bound = tol + tol * want.abs().nan_to_num(0.0)
    if bool((diff > bound).any()):
        raise AssertionError(f"{what}: off by {float(diff.max())} "
                             f"(tolerance {tol})")
    return float(diff.max()) if diff.numel() else 0.0


def check_planes(got: dict, mask, want: dict, what: str) -> float:
    """Phase K's planes against phase H's: the join's columns and the
    range stats bitwise on phase H's lanes (phase K's longer rows hold
    only padding past them: ``mask``, the frame's row mask, is False
    there), EMA_x within ``EMA_CARRY_TOL`` where valid."""
    err = 0.0
    L = next(iter(want.values()))[0].shape[1]
    if mask.shape[0] != next(iter(want.values()))[0].shape[0] \
            or bool(mask[:, L:].any()):
        raise AssertionError(f"{what}: other rows, or real rows past "
                             f"phase H's {L} lanes")
    for c, (wv, wok) in want.items():
        gv, gok = got[c]
        gv, gok = gv[:, :L], gok[:, :L]
        if not torch.equal(gok, wok):
            raise AssertionError(f"{what}: {c} validity differs")
        if c.startswith("EMA"):
            nan = torch.full_like(wv, float("nan"))
            err = max(err, check_close(torch.where(wok, gv, nan),
                                       torch.where(wok, wv, nan),
                                       f"{what} {c}", EMA_CARRY_TOL))
        elif not torch.equal(gv.view(torch.int32), wv.view(torch.int32)):
            raise AssertionError(f"{what}: {c} not bitwise phase H's")
    return err


def check_frames(got, want, what: str) -> float:
    """Collected frames: columns of EMA_x within ``EMA_CARRY_TOL``, every
    other column equal."""
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        raise AssertionError(f"{what}: frames differ in shape")
    err = 0.0
    for c in want.columns:
        if "EMA" in c:
            err = max(err, check_close(
                torch.tensor(got[c].to_numpy(np.float64)),
                torch.tensor(want[c].to_numpy(np.float64)),
                f"{what} {c}", EMA_CARRY_TOL))
        else:
            pd_eq = got[c].equals(want[c])
            if not pd_eq:
                raise AssertionError(f"{what}: {c} differs")
    return err


def check_halo_stats(got: dict, ref: dict, rows, what: str) -> float:
    """The halo strategy's stats (the windowed engine over extended
    blocks) against the exact strategy's (the row-bounded kernel) on
    ``rows``: count bitwise; mean, min, max, and zscore as x - mean,
    within 1e-5; sum within ``HALO_SUM_ATOL`` and stddev, as the
    variance, within ``HALO_VAR_ATOL``.  The windowed engine takes a
    window's sums as differences of float32 prefix sums over the
    extended block: the centred values' prefix sums reach ~sqrt(n) = 80
    and the squares' ~n = 10^4 over its ~9,600 lanes at HHAR, float32
    spacings of ~8e-6 and ~1e-3.  Returns the largest difference."""
    nan = torch.full_like(ref["mean"], float("nan"))
    pick = lambda t: torch.where(rows, t, nan)
    if not torch.equal(pick(got["count"]).nan_to_num(-1.0),
                       pick(ref["count"]).nan_to_num(-1.0)):
        raise AssertionError(f"{what}: count differs")
    flat = (got["stddev"] == 0) | (ref["stddev"] == 0)
    pairs = {
        "mean": (got["mean"], ref["mean"], 1e-5),
        "min": (got["min"], ref["min"], 1e-5),
        "max": (got["max"], ref["max"], 1e-5),
        "sum": (got["sum"], ref["sum"], HALO_SUM_ATOL),
        "stddev": (got["stddev"] ** 2, ref["stddev"] ** 2, HALO_VAR_ATOL),
        "zscore": (torch.where(flat, nan, got["zscore"] * got["stddev"]),
                   torch.where(flat, nan, ref["zscore"] * ref["stddev"]),
                   1e-5),
    }
    err = 0.0
    for k, (g, w, atol) in pairs.items():
        g, w = pick(g), pick(w)
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{what}: {k} NaN pattern differs")
        diff = (g - w).abs().nan_to_num(0.0)
        if bool((diff > atol + 1e-5 * w.abs().nan_to_num(0.0)).any()):
            raise AssertionError(f"{what}: {k} off by {float(diff.max())}")
        err = max(err, float(diff.max()))
    return err


def stats_of(frame, col: str) -> dict:
    """A frame's range stats of ``col`` as global tensors."""
    from tempo_tpu_torch.parallel.reshard import assemble

    return {k: assemble(frame.cols[f"{k}_{col}"].values, frame.mesh,
                        frame.spec)
            for k in ("mean", "count", "min", "max", "sum", "stddev",
                      "zscore")}


def rank_worker(rank: int, port: int, out_dir: str, rows: int,
                series: int) -> int:
    """Phase K.d's rank: join the gloo group, route and place this rank's
    series, run phase H's chain on a ``series: 2`` mesh spread over the
    two ranks (shards on cuda:0) and write what it collects."""
    import pandas as pd

    sys.path.insert(0, str(HERE))
    from tempo_tpu_torch import TSDF, packing
    from tempo_tpu_torch.parallel import multihost as mh

    mh.distributed_init(f"localhost:{port}", 2, rank, timeout_s=120,
                        backend="gloo")
    mesh = mh.process_mesh({"series": 2}, devices=["cuda:0"])
    left, right, _ = make_frames(pd, rows, series)
    lt = TSDF(left, "event_ts", ["user"])
    lay = lt.layout
    K_dev, L = 2 * -(-lay.n_series // 2), packing.pad_length(
        int(lay.lengths.max()))
    x, ok = lt.numeric_flat("x")
    plane = packing.pack_column(x.astype(np.float32), lay, L, fill=np.nan)
    plane = np.concatenate([plane, np.full((K_dev - lay.n_series, L),
                                           np.nan, np.float32)])
    lo, hi = mh.process_series_range(K_dev, mesh)
    shards = mh.shard_series_global(plane[lo:hi], mesh, K_dev)
    dl = lt.on_mesh(mesh)
    mine = [i for i, r in enumerate(mesh.axis_ranks("series")) if r == rank]
    for i in mine:
        if not torch.equal(shards[i].view(torch.int32),
                           dl.cols["x"].values[i].view(torch.int32)):
            raise AssertionError(f"rank {rank}: shard_series_global's "
                                 f"shard {i} differs from on_mesh's")
    _, grouped = mesh_chain(TSDF, left, right, mesh)
    grouped.to_pickle(os.path.join(out_dir, f"rank{rank}.pkl"))
    print(f"rank {rank}/2: series [{lo}, {hi}) of {K_dev}, shards {mine}, "
          f"{len(grouped)} bucket rows", flush=True)
    # K.e: a sharded checkpoint both ranks write and load, and a
    # run_resumable pipeline killed while both save step 2, resumed
    from tempo_tpu_torch import checkpoint, resilience
    from tempo_tpu_torch.testing import faults

    t0 = time.perf_counter()
    ck = os.path.join(out_dir, "ck")
    checkpoint.save(dl, ck, sharded=True)
    back = checkpoint.load(ck, mesh=mesh)
    if back.ts[1 - rank].device.type != "meta":
        raise AssertionError(f"rank {rank}: loaded the other rank's shard")
    back.collect().df.to_pickle(os.path.join(out_dir, f"back{rank}.pkl"))
    rd = os.path.join(out_dir, "resume")
    with faults.FaultInjector() as fi:
        # rank 0 writes its shard file and host_arrays.npz a step
        fi.kill_on_call(np, "savez", call_no=3 if rank == 0 else 2)
        try:
            resilience.run_resumable(dl, RESUME_STEPS, rd, sharded=True)
        except faults.SimulatedKill:
            pass
        else:
            raise AssertionError("K.e: the injected kill did not fire")
    resumed = resilience.run_resumable(dl, RESUME_STEPS, rd, sharded=True)
    resumed.collect().df.to_pickle(os.path.join(out_dir,
                                                f"resumed{rank}.pkl"))
    print(f"rank {rank}/2: K.e sharded save + load, run_resumable killed "
          f"at step 2 and resumed in {time.perf_counter() - t0:.3f} s",
          flush=True)
    torch.distributed.destroy_process_group()
    return 0


#: K.e's ``run_resumable`` pipeline
RESUME_STEPS = [("withRangeStats", {"colsToSummarize": ["x"],
                                    "rangeBackWindowSecs": 10}),
                ("EMA", {"colName": "x", "exact": True}),
                ("resample", {"freq": "1 minute", "func": "mean"})]


def two_ranks(pd, TSDF, rows: int, series: int):
    """K.d: two gloo ranks as subprocesses of this script (each with its
    own timeout), their collected frames bitwise equal to one process's
    run of the same chain on a ``series: 2`` mesh of cuda:0."""
    import shutil
    import socket
    import tempfile

    from tempo_tpu_torch import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_dir = tempfile.mkdtemp()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank-worker",
         str(r), str(port), out_dir, "--rows", str(rows), "--series",
         str(series)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} failed ({p.returncode}):\n"
                                 f"{out[-3000:]}")
    left, right, _ = make_frames(pd, rows, series)
    one = make_mesh({"series": 2}, devices=["cuda:0"] * 2)
    _, want = mesh_chain(TSDF, left, right, one)
    for r in range(2):
        got = pd.read_pickle(os.path.join(out_dir, f"rank{r}.pkl"))
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    # K.e against one process: the frame saved, and the pipeline run
    # through without a kill
    from tempo_tpu_torch import resilience

    dl = TSDF(left, "event_ts", ["user"]).on_mesh(one)
    whole = resilience.run_resumable(dl, RESUME_STEPS,
                                     os.path.join(out_dir, "one"),
                                     sharded=True).collect().df
    for r in range(2):
        pd.testing.assert_frame_equal(
            pd.read_pickle(os.path.join(out_dir, f"back{r}.pkl")),
            dl.collect().df, check_exact=True)
        pd.testing.assert_frame_equal(
            pd.read_pickle(os.path.join(out_dir, f"resumed{r}.pkl")),
            whole, check_exact=True)
    with open(os.path.join(out_dir, "ck", "manifest.json")) as f:
        n_proc = json.load(f)["n_processes"]
    if n_proc != 2:
        raise AssertionError(f"K.e manifest n_processes {n_proc}")
    shutil.rmtree(out_dir, ignore_errors=True)
    lines = [ln for out in outs for ln in out.splitlines()
             if ln.startswith("rank ")]
    log(f"K.d two gloo ranks (subprocesses, shards on cuda:0, {len(left)} "
        f"rows a side over {series} users) in {seconds:.3f} s: "
        f"distributed_init -> process_series_range -> shard_series_global "
        f"(equal to on_mesh's shards) -> phase H's chain on a series: 2 "
        f"mesh over both ranks -> collect on each rank bitwise equal to "
        f"one process's run; K.e: checkpoint.save(sharded=True) by both "
        f"ranks (n_processes 2) -> load, and run_resumable(sharded=True) "
        f"killed while both save step 2 and resumed, each rank's collect "
        f"bitwise the one-process frame and run; {'; '.join(lines)}")


def phase_k(pd, TSDF, left, right, n, keep, rows, series):
    """The time axis at HHAR scale on one card (four mesh entries on
    cuda:0), and two processes.  Returns the main path's launch
    counts."""
    from tempo_tpu_torch import dist, make_mesh
    from tempo_tpu_torch.parallel.reshard import assemble

    want = keep["H"]["planes"]
    counts = []
    frames = {}
    for axes in TIME_MESHES:
        mesh = make_mesh(axes, devices=["cuda:0"] * 4)
        steps = {}
        (ema, grouped), seconds, launches, events = counted(
            lambda: mesh_chain(TSDF, left, right, mesh, steps=steps,
                               time_axis="time"))
        counts.append(launches)
        missing = [k for k in ("asof_merge", "ema_ladder")
                   if launches[k] == 0]
        if launches["range_stats"] + launches["range_stats_ring"] == 0:
            missing.append("range_stats")
        if launches["bucket_stats"] + launches["bucket_stats_ring"] == 0:
            missing.append("bucket_stats")
        if missing or events != (2, 1):
            raise AssertionError(f"K chain on {axes}: launches {launches}, "
                                 f"events {events}")
        err = check_planes(global_planes(ema),
                           assemble(ema.mask, ema.mesh, ema.spec), want,
                           f"K {axes}")
        err = max(err, check_frames(grouped, keep["H"]["df"],
                                    f"K {axes} grouped stats"))
        # withRangeStats(exact) switches the joined frame (x, right_wx
        # and the three chunks of right_event_ts) to the series-local
        # layout and the stats frame (those and seven stats) back
        n_sh = mesh.axis_size(("series", "time"))
        moved = {c: dist.relayout_comm_bytes(ema.K_dev, ema.L, c, n_sh)
                 for c in (5, 12)}
        log(f"K chain on {axes} (four entries of cuda:0, {n} rows a side, "
            f"[{ema.K_dev}, {ema.L}] in [{ema.K_dev // axes['series']}, "
            f"{ema.L // axes['time']}] blocks): {seconds:.3f} s; join "
            f"columns and range stats bitwise phase H's, EMA_x and its "
            f"grouped stats within {EMA_CARRY_TOL} (max abs err "
            f"{err:.3g}); pack/fetch events {events}; launches {launches}")
        log(f"K steps on {axes} (wall s, card synchronised after each): "
            + ", ".join(f"{k} {v:.3f} (H {keep['H']['steps'][k]:.3f})"
                        for k, v in steps.items()))
        log(f"K relayout_comm_bytes on {axes} (a shard; {n_sh} shards): "
            f"the joined frame to series-local {moved[5]} bytes, the stats "
            f"frame back {moved[12]} bytes; together "
            f"{n_sh * (moved[5] + moved[12])} bytes, "
            f"{n_sh * (moved[5] + moved[12]) / HBM_BYTES_PER_S * 1e3:.3f} "
            f"ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
        frames[tuple(axes.values())] = (mesh, ema)
        del grouped
    # b. the halo strategy on the time: 4 mesh
    mesh4 = frames[(1, 4)][0]
    dl = TSDF(left, "event_ts", ["user"]).on_mesh(mesh4, time_axis="time",
                                                    halo_fraction=0.5)
    halo, halo_s, halo_launches, _ = counted(
        lambda: dl.withRangeStats(colsToSummarize=["x"],
                                  rangeBackWindowSecs=10, strategy="halo"))
    counts.append(halo_launches)
    if halo_launches["merge_rank"] == 0 or halo_launches["cumsum3"] == 0:
        raise AssertionError(f"K halo strategy: launches {halo_launches}")
    clipped = halo.audit_counts()[-1][1]
    exact = dl.withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10)
    got, ref = stats_of(halo, "x"), stats_of(exact, "x")
    uncut = got["count"] == ref["count"]
    n_cut = int((~uncut & ~torch.isnan(ref["count"])).sum())
    if n_cut > clipped:
        raise AssertionError(f"K halo: {n_cut} rows differ in count, the "
                             f"audit counted {clipped}")
    herr = check_halo_stats(got, ref, uncut, "K halo vs exact")
    log(f"K withRangeStats(10 s, strategy='halo') at halo_fraction 0.5 on "
        f"{{'series': 1, 'time': 4}} (halo {dl._halo(dl.L)} lanes): "
        f"{halo_s:.3f} s; audit count {clipped}; counts equal to the exact "
        f"strategy's on every uncut row ({n_cut} cut), mean, min, max and "
        f"zscore within 1e-5, sum within {HALO_SUM_ATOL}, "
        f"the variance within {HALO_VAR_ATOL} (max abs err {herr:.3g}); "
        f"launches {halo_launches}")
    del halo, exact, dl
    # c. a reshard round trip, then phase H's tail on series: 2, time: 2
    mesh22, ema22 = frames[(2, 2)]
    local = dist.reshard_frame(ema22, dist.RESHARD_SERIES_LOCAL)
    back = dist.reshard_frame(local, dist.RESHARD_TIME_SHARDED)
    for c in ema22.cols:
        for a, b in zip(ema22.cols[c].values + ema22.cols[c].valid,
                        back.cols[c].values + back.cols[c].valid):
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError(f"K reshard round trip changed {c}")
    del local, back
    (filled, bars), tail_s, tail_launches, tail_events = counted(
        lambda: mesh_tail(TSDF, ema22, keep["H"]["trades"], mesh22,
                          time_axis="time"))
    counts.append(tail_launches)
    terr = max(check_frames(filled, keep["H"]["tail"][0],
                            "K resample/interpolate"),
               check_frames(bars, keep["H"]["tail"][1], "K vwap"))
    log(f"K reshard_frame round trip on {{'series': 2, 'time': 2}}: every "
        f"plane bitwise; resample('1 minute', 'mean').interpolate('linear') "
        f"and vwap('m') there in {tail_s:.3f} s equal phase H's tail (EMA_x "
        f"within {EMA_CARRY_TOL}, max abs err {terr:.3g}); pack/fetch "
        f"events {tail_events}; launches {tail_launches}")
    del frames, ema22
    torch.cuda.empty_cache()
    # d. two gloo ranks
    two_ranks(pd, TSDF, rows, series)
    return add_counts(*counts)


def measure_cost_priors(pd, left, right, dev) -> dict:
    """The planner's cost priors (``plan/cost.py`` ``PRIORS``) that a run
    can measure, on this card at HHAR shapes; printed for PERF.md and
    the cost module's defaults (``cost.FIXED`` names the others)."""
    from tempo_tpu_torch import TSDF, packing
    from tempo_tpu_torch import rolling as rolling_frame
    from tempo_tpu_torch.ops import merge, scan, window
    from tempo_tpu_torch.ops import rolling as rk
    from tempo_tpu_torch.parallel.reshard import all_to_all_series_to_time

    out = {}
    lt = TSDF(left, "event_ts", ["user"], device=dev, dtype=torch.float32)
    x, valid = lt.packed_numeric("x")
    _, rb, ts_long, _ = rolling_frame.plan_range_engine(lt, 10)
    secs = torch.from_numpy(ts_long).to(dev)
    K, L = x.shape
    # range stats (row 2) at 10 s and at 1000 s: the stream rate, and the
    # window walk's re-read rate a window row
    t1 = time_ms(lambda: window.range_stats(secs, x[None], valid[None], 10,
                                            int(rb[0]), int(rb[1])))
    rb2 = packing.layout_rowbounds(lt.layout, 1000)
    t2 = time_ms(lambda: window.range_stats(secs, x[None], valid[None],
                                            1000, int(rb2[0]), int(rb2[1])))
    n = K * L
    # plan/cost.py's STATS_ROW_BYTES a lane: its estimate is this time
    out["hbm_stream_rate"] = n * 41 / (t1 / 1e3)
    dw = (int(rb2[0]) + int(rb2[1])) - (int(rb[0]) + int(rb[1]))
    extra = max(t2 - t1, 1e-6) / 1e3
    out["vmem_pass_rate_multiple"] = max(
        1.0, n * 4.0 * dw / (out["hbm_stream_rate"] * extra))
    # the windowed form against the row-bounded kernel on the same planes
    def windowed():
        start, end = rk.range_window_bounds(secs.long(), 10)
        return rk.windowed_stats(x, valid, start, end, max_window=32)
    out["windowed_gather_penalty"] = time_ms(windowed, reps=3) / t1
    # the merge join's row walk and the lookback kernel's tiles on the
    # packed HHAR join, 17 bytes a merged lane
    l_ts = torch.from_numpy(lt.packed_ts()).to(dev)
    r_ts = l_ts - NS
    r_val = torch.stack([x, x])
    r_ok = torch.stack([valid, valid])
    lanes = K * (l_ts.shape[1] + r_ts.shape[1])
    tw = time_ms(lambda: merge.asof_merge_cuda(l_ts, r_ts, r_ok, r_val,
                                               _form="walk"))
    tt = time_ms(lambda: merge.asof_merge_cuda(l_ts, r_ts, r_ok, r_val,
                                               _form="tiles"))
    out["join_single_rate"] = lanes * 17 / (tw / 1e3)
    out["join_chunked_rate"] = lanes * 17 / (tt / 1e3)
    # one wrapper call on a [1, 8] row: launch and synchronise
    tiny_x = torch.zeros(1, 8, device=dev)
    tiny_v = torch.ones(1, 8, dtype=torch.bool, device=dev)

    def one():
        scan.ema_cuda(tiny_x, tiny_v, 0.2)
        torch.cuda.synchronize()
    one()
    t0 = time.perf_counter()
    for _ in range(200):
        one()
    out["dispatch_overhead_s"] = (time.perf_counter() - t0) / 200
    # the frame join forced onto host time brackets over 64 series, its
    # merged lanes counted as the device rates count theirs (a series'
    # padded left and right lengths), 17 bytes a lane over the wall time
    lc, rc = left[left["user"] < 64], right[right["user"] < 64]
    b_lanes = 64 * (packing.pad_length(int(lc.groupby("user").size().max()))
                    + packing.pad_length(int(rc.groupby("user").size().max())))

    def bracketed():
        j = TSDF(lc, "event_ts", ["user"], device=dev).asofJoin(
            TSDF(rc, "event_ts", ["user"], device=dev))
        torch.cuda.synchronize()
        return j
    with env_set("TEMPO_TPU_JOIN_ENGINE", "bracket"):
        bracketed()
        t0 = time.perf_counter()
        for _ in range(2):
            bracketed()
        tb = (time.perf_counter() - t0) / 2
    out["host_bracket_rate"] = b_lanes * 17 / tb
    # a layout switch's copy rate on one card: the all-to-all of one
    # float32 plane cut over series 2 x time 2 entries of this card
    from tempo_tpu_torch import make_mesh

    mesh = make_mesh({"series": 2, "time": 2}, devices=[str(dev)] * 4)
    blocks = [x[i * (K // 2):(i + 1) * (K // 2),
                j * (L // 2):(j + 1) * (L // 2)].contiguous()
              for i in range(2) for j in range(2)]
    ta = time_ms(lambda: all_to_all_series_to_time(blocks, mesh, "series",
                                                   "time"))
    out["ici_rate"] = n * 4 / (ta / 1e3)
    return out


def phase_l(pd, TSDF, left, right, n, keep):
    """The planner on the card (``TEMPO_TPU_PLAN=1``): the fused mesh
    chain captured once and replayed, the resampleEMA fusion, a stitched
    mesh run, a checkpointed plan killed and resumed, SQL lowering; then
    the cost priors."""
    import tempfile

    from tempo_tpu_torch import checkpoint, make_mesh, profiling
    from tempo_tpu_torch.ops import cuda_lib
    from tempo_tpu_torch.plan import cache as plan_cache
    from tempo_tpu_torch.plan import checkpoints as plan_ckpt
    from tempo_tpu_torch.plan import executor, fused, optimizer
    from tempo_tpu_torch.testing import faults

    stats = lambda: profiling.plan_cache_stats()
    plan_cache.CACHE.clear()
    mesh = make_mesh()
    want = keep["H"]["planes"]
    h_steps = keep["H"]["steps"]
    h_s = sum(h_steps[k] for k in ("on_mesh x2", "asofJoin",
                                   "withRangeStats", "EMA"))

    def lazy_chain():
        return (TSDF(left, "event_ts", ["user"]).on_mesh(mesh)
                .asofJoin(TSDF(right, "event_ts", ["user"]).on_mesh(mesh))
                .withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=10)
                .EMA("x", exact=True))

    with env_set("TEMPO_TPU_PLAN", "1"):
        text = lazy_chain().explain()
        if "fused_asof_stats_ema" not in text:
            raise AssertionError("L.a: explain shows no fused node")
        runs = []
        for call in range(2):
            before, b0 = stats(), cuda_lib.builds
            lz = lazy_chain()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = executor.execute(lz.plan)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after = stats()
            got = global_planes(out)
            for c, (wv, wok) in want.items():
                gv, gok = got[c]
                if not (torch.equal(gok, wok) and torch.equal(
                        gv.view(torch.int32), wv.view(torch.int32))):
                    raise AssertionError(f"L.a call {call}: {c} is not "
                                         f"bitwise phase H's")
            d = {k: after[k] - before[k] for k in
                 ("hits", "misses", "graph_captures", "graph_replays")}
            want_d = ({"hits": 0, "misses": 1, "graph_captures": 1,
                       "graph_replays": 1} if call == 0 else
                      {"hits": 1, "misses": 0, "graph_captures": 0,
                       "graph_replays": 1})
            if d != want_d or cuda_lib.builds != b0:
                raise AssertionError(f"L.a call {call}: cache {d}, kernel "
                                     f"builds {cuda_lib.builds - b0}")
            runs.append(secs)
            collected = out.collect().df
            del out, got
        hit0 = stats()
        lz = lazy_chain()

        def cache_hit():
            executor.execute(lz.plan)

        traced("L.a cache hit", cache_hit)
        hit1 = stats()
        if (hit1["hits"] - hit0["hits"], hit1["graph_captures"]
                - hit0["graph_captures"]) != (1, 0):
            raise AssertionError(f"L.a traced call: {hit1} after {hit0}")
        (exe,) = plan_cache.CACHE._entries.values()
        (fnode,) = [m for m in exe.plan.walk()
                    if m.op == "fused_asof_stats_ema"]
        pool = fused.pool_bytes(fnode)
        if pool is None:
            raise AssertionError("L.a: the fused node was not captured")
        held = sum(exe.graph_bytes().values())
        for dkey, ent in fnode.objs["_graphs"].items():
            graph_walk(f"L.a fused node on {dkey}", ent,
                       FUSED_GRAPH_KERNELS)
    if len(collected) != n or not np.isfinite(
            collected["EMA_x"].to_numpy()).all():
        raise AssertionError("L.a: collected frame lost rows")
    log(f"L.a planned on_mesh -> asofJoin -> withRangeStats(10 s) -> EMA on "
        f"{mesh.shape} ({n} rows a side), one fused_asof_stats_ema node "
        f"captured as a CUDA graph: first call {runs[0]:.3f} s (optimize, "
        f"pack, warm-up, capture, replay), second {runs[1]:.3f} s (cache "
        f"hit, one replay, 0 captures, 0 kernel builds), phase H's eager "
        f"steps to the EMA {h_s:.3f} s; every plane bitwise phase H's both "
        f"times; graph pool {pool} bytes, {held} with its static inputs; "
        f"collected {len(collected)} rows")
    del collected
    plan_cache.CACHE.clear()
    torch.cuda.empty_cache()
    with env_set("TEMPO_TPU_PLAN", "1"):
        text = lazy_chain().explain(cost=True)
    card_name = torch.cuda.get_device_name(0)
    costed = [ln for ln in text.splitlines()
              if ln.startswith("fused_asof_stats_ema: ")]
    if f"== Captured cost ({card_name}) ==" not in text or not costed \
            or "temp_bytes=" not in costed[0]:
        raise AssertionError(f"L.a: explain(cost=True) gave {text[-800:]}")
    log(f"L.a explain(cost=True): {costed[0]}")
    torch.cuda.empty_cache()

    # b. floor resample -> exact EMA fuses onto resampleEMA
    rt = TSDF(right, "event_ts", ["user"])
    with env_set("TEMPO_TPU_PLAN", "1"):
        lz = rt.resample("1 minute", "floor", metricCols=["wx"]).EMA(
            "wx", exact=True)
        ops = [m.op for m in optimizer.optimize(lz.plan).walk()
               if not m.is_source()]
        if ops != ["resample_ema"]:
            raise AssertionError(f"L.b: optimized ops {ops}")
        planned, b_s, b_launches, _ = counted(lambda: lz.df)
    eager = rt.resampleEMA("1 minute", "wx").df
    pd.testing.assert_frame_equal(planned, eager, check_exact=True)
    if b_launches["resample_ema"] + b_launches["resample_ema_ring"] == 0:
        raise AssertionError(f"L.b launches {b_launches}")
    log(f"L.b planned resample('1 minute', 'floor') -> EMA(exact) on the "
        f"right frame: fused onto resample_ema, {b_s:.3f} s, bitwise "
        f"TSDF.resampleEMA; launches {b_launches}")
    del planned, eager
    plan_cache.CACHE.clear()

    # c. a stitched mesh run, captured and replayed
    def stitched_chain(d):
        return (d.resample("10 seconds", "floor")
                .interpolate(method="linear").EMA("x", exact=True)
                .withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=60))

    def planes(frame):
        from tempo_tpu_torch.parallel.reshard import assemble

        out = global_planes(frame)
        out["(ts, mask)"] = (assemble(frame.ts, frame.mesh, frame.spec),
                             assemble(frame.mask, frame.mesh, frame.spec))
        return out

    lt = TSDF(left, "event_ts", ["user"])
    eager, e_s, _, _ = counted(
        lambda: planes(stitched_chain(lt.on_mesh(mesh))))
    traced("L.c op by op",
           lambda: len(planes(stitched_chain(lt.on_mesh(mesh)))))
    c_runs = []
    with env_set("TEMPO_TPU_PLAN", "1"):
        for call in range(2):
            before = stats()
            lz = stitched_chain(lt.on_mesh(mesh))
            out, secs, _, _ = counted(lambda: executor.execute(lz.plan))
            after = stats()
            if [m.op for m in optimizer.optimize(lz.plan).walk()
                    if not m.is_source()] != ["on_mesh", "stitched"]:
                raise AssertionError("L.c: the chain did not stitch")
            got = planes(out)
            for c, (wv, wok) in eager.items():
                gv, gok = got[c]
                if not (torch.equal(gok, wok) and torch.equal(
                        gv.view(torch.uint8), wv.view(torch.uint8))):
                    raise AssertionError(f"L.c call {call}: {c} is not "
                                         f"bitwise the op-by-op chain's")
            caps = after["graph_captures"] - before["graph_captures"]
            reps = after["graph_replays"] - before["graph_replays"]
            if (caps, reps) != ((1, 1) if call == 0 else (0, 1)):
                raise AssertionError(f"L.c call {call}: {caps} captures, "
                                     f"{reps} replays")
            c_runs.append(secs)
            del out, got
        (s_exe,) = plan_cache.CACHE._entries.values()
        (snode,) = [m for m in s_exe.plan.walk() if m.op == "stitched"]
        s_pool = fused.pool_bytes(snode)
        # two threads replay the cached graph at once: the node's lock
        # makes them take turns, and each result is its own
        results = [None, None]

        def replay_in_thread(i):
            with torch.cuda.stream(torch.cuda.Stream()):
                results[i] = planes(executor.execute(
                    stitched_chain(lt.on_mesh(mesh)).plan))
                torch.cuda.synchronize()
        before = stats()
        pair = [threading.Thread(target=replay_in_thread, args=(i,))
                for i in range(2)]
        for t in pair:
            t.start()
        for t in pair:
            t.join()
        after = stats()
        for i, got in enumerate(results):
            if got is None:
                raise AssertionError(f"L.c thread {i} raised")
            for c, (wv, wok) in eager.items():
                gv, gok = got[c]
                if not (torch.equal(gok, wok) and torch.equal(
                        gv.view(torch.uint8), wv.view(torch.uint8))):
                    raise AssertionError(f"L.c thread {i}: {c} is not "
                                         f"bitwise the op-by-op chain's")
        if (after["graph_replays"] - before["graph_replays"],
                after["graph_captures"] - before["graph_captures"]) != (2, 0):
            raise AssertionError(f"L.c threads: {after} after {before}")
        del results
        # the byte bound: under a budget below one graph, running another
        # plan evicts this one and frees its graph
        share = plan_cache.GRAPH_MEMORY_SHARE
        plan_cache.GRAPH_MEMORY_SHARE = 1e-9
        plan_cache.graph_budget.cache_clear()
        try:
            ev0 = stats()["evictions"]
            executor.execute(stitched_chain(lt.on_mesh(mesh)).EMA(
                "x", exact=True).plan)
            evicted = stats()["evictions"] - ev0
        finally:
            plan_cache.GRAPH_MEMORY_SHARE = share
            plan_cache.graph_budget.cache_clear()
        if evicted != 1 or s_exe.graph_bytes():
            raise AssertionError(f"L.c byte bound: {evicted} evictions, "
                                 f"{s_exe.graph_bytes()} still held")
    log(f"L.c planned resample('10 seconds', 'floor') -> interpolate("
        f"'linear') -> EMA(exact) -> withRangeStats(60 s) on {mesh.shape}: "
        f"one stitched node, captured ({c_runs[0]:.3f} s) then replayed "
        f"({c_runs[1]:.3f} s), op by op {e_s:.3f} s; every plane bitwise "
        f"the op-by-op chain's, and so in two threads replaying it at "
        f"once; graph pool {s_pool} bytes; under a budget below one graph "
        f"a second plan evicted it and its graph was freed")
    del eager
    plan_cache.CACHE.clear()
    torch.cuda.empty_cache()

    # d. a checkpointed plan killed after its first barrier, resumed
    users = WORKER_USERS
    per = n // left["user"].nunique()
    sl, sr = left.iloc[:users * per], right.iloc[:users * per]

    def ck_chain():
        return (TSDF(sl, "event_ts", ["user"]).on_mesh(mesh)
                .asofJoin(TSDF(sr, "event_ts", ["user"]).on_mesh(mesh),
                          skipNulls=False)
                .withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=10)
                .EMA("x", exact=True))

    whole = ck_chain().collect().df
    d = tempfile.mkdtemp()
    t0 = time.perf_counter()
    with env_set("TEMPO_TPU_PLAN", "1"):
        with faults.FaultInjector() as fi:
            fi.kill_on_call(np, "savez", call_no=2)
            try:
                with plan_ckpt.checkpointed(d):
                    ck_chain().collect()
            except faults.SimulatedKill:
                pass
            else:
                raise AssertionError("L.d: the injected kill did not fire")
        if not checkpoint.latest(d).endswith("step_00001"):
            raise AssertionError(f"L.d: newest barrier {checkpoint.latest(d)}")
        with plan_ckpt.checkpointed(d):
            resumed = ck_chain().collect().df
    pd.testing.assert_frame_equal(resumed, whole, check_exact=True)
    import shutil

    shutil.rmtree(d, ignore_errors=True)
    log(f"L.d checkpointed plan (asofJoin(skipNulls=False) -> withRangeStats "
        f"-> EMA, three barriers) on {users} users: killed while saving "
        f"barrier 2, resumed from barrier 1, bitwise the uninterrupted run "
        f"({time.perf_counter() - t0:.3f} s)")

    # e. selectExpr / filter lowered through sql_compile
    with env_set("TEMPO_TPU_PLAN", "1"):
        lz = lt.filter("x > 0").selectExpr("user", "event_ts",
                                           "x * 2 AS x2")
        text = lz.explain()
        if "eval[sql]=jit-plane" not in text or "sql_project" not in text:
            raise AssertionError("L.e: explain shows no lowered SQL")
        planned, e_s, _, _ = counted(lambda: lz.df)
    eager = lt.filter("x > 0").selectExpr("user", "event_ts", "x * 2 AS x2")
    pd.testing.assert_frame_equal(planned, eager.df, check_exact=True)
    log(f"L.e planned filter('x > 0') -> selectExpr on the left frame: "
        f"sql_filter (plane backend) -> sql_project, {e_s:.3f} s, "
        f"{len(planned)} rows, equal to the eager frame")
    plan_cache.CACHE.clear()
    torch.cuda.empty_cache()

    from tempo_tpu_torch.plan import cost

    t0 = time.perf_counter()
    priors = measure_cost_priors(pd, left, right, torch.device("cuda"))
    log(f"L cost priors ({time.perf_counter() - t0:.1f} s, {card_line()}): "
        f"measured {json.dumps(priors)}; fixed, not measured "
        + json.dumps({k: cost.PRIORS[k] for k in cost.FIXED}))
    if set(priors) | set(cost.FIXED) != set(cost.PRIORS):
        raise AssertionError(f"L: priors measured {sorted(priors)}, fixed "
                             f"{cost.FIXED}, declared {sorted(cost.PRIORS)}")
    return priors


# ----------------------------------------------------------------------
# Whole-chain traces (profiling.trace / annotate)
# ----------------------------------------------------------------------

def span(name: str):
    """A named span of the port's trace (``profiling.annotate``)."""
    from tempo_tpu_torch import profiling

    return profiling.annotate(name)


#: Chrome-trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _top(events, n: int = 10):
    """[name, total ms, count] of the ``n`` names with the most time."""
    tot, cnt = {}, {}
    for e in events:
        tot[e["name"]] = tot.get(e["name"], 0.0) + float(e["dur"])
        cnt[e["name"]] = cnt.get(e["name"], 0) + 1
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:90], round(us / 1e3, 4), cnt[name]] for name, us in ranked]


def trace_summary(events, window: str, kernels=()) -> dict:
    """What a Chrome trace of ``profiling.trace`` says about the span
    named ``window``: its wall seconds, the seconds some kernel, copy or
    memset ran on the card inside it (the union of their intervals) and
    that busy share of the window, the host<->device copies (count,
    bytes, ms), the top 10 device kernels and copies, the top 10 host
    spans (annotations and torch ops) by total time, and how many device
    kernels' names hold each string of ``kernels``."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise AssertionError(f"trace holds {len(win)} spans {window!r}")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    busy, cur = 0.0, None
    for s, t in sorted((max(float(e["ts"]), w0),
                        min(float(e["ts"]) + float(e["dur"]), w1))
                       for e in dev):
        if t <= s:
            continue
        if cur is None or s > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    copies = {}
    for e in dev:
        if e.get("cat") != "gpu_memcpy":
            continue
        kind = next((k for k in ("HtoD", "DtoH", "DtoD") if k in e["name"]),
                    "other")
        c = copies.setdefault(kind, {"count": 0, "bytes": 0, "ms": 0.0})
        c["count"] += 1
        c["bytes"] += int((e.get("args") or {}).get("bytes", 0))
        c["ms"] = round(c["ms"] + float(e["dur"]) / 1e3, 4)
    host = [e for e in xs if e.get("cat") in ("user_annotation", "cpu_op")
            and e is not win[0]]
    inside = [e for e in dev if e.get("cat") == "kernel"
              and w0 <= float(e["ts"]) <= w1]
    return {"window_s": round((w1 - w0) / 1e6, 6),
            "device_busy_s": round(busy / 1e6, 6),
            "busy_share": (round(busy / (w1 - w0), 4) if dev else None),
            "device_events": len(dev), "copies": copies,
            "top_device": _top(dev), "top_host": _top(host),
            "kernel_counts": {k: sum(k in e["name"] for e in inside)
                              for k in kernels}}


def traced(label: str, fn, kernels=()):
    """One extra run of ``fn()`` under ``profiling.trace`` (a temporary
    directory, removed after), the whole run in one span; prints its
    ``trace_summary`` (counting the device kernels named by ``kernels``)
    with the card's name and power limit and returns ``(fn(),
    summary)``.  The timed runs stay untraced."""
    import glob
    import shutil
    import tempfile

    from tempo_tpu_torch import profiling

    tmp = tempfile.mkdtemp(prefix="tempo-trace-")
    window = f"traced {label}"
    try:
        torch.cuda.synchronize()
        with profiling.trace(tmp):
            with profiling.annotate(window):
                out = fn()
                torch.cuda.synchronize()
        files = glob.glob(os.path.join(tmp, "*.json"))
        if len(files) != 1:
            raise AssertionError(f"{label}: trace wrote {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = trace_summary(events, window, kernels)
    if summary["device_events"] == 0:
        log(f"{label} trace: the profiler recorded no device activity; the "
            f"card's busy share is not measured")
    log(f"{label} trace ({card_line()}): {json.dumps(summary)}")
    return out, summary


# ----------------------------------------------------------------------
# The sequential-EMA kernel (csrc/ema_scan.cu) against its plain version
# ----------------------------------------------------------------------

EMA_SCAN_LONG = 1 << 20
#: the cohort step's EMA at config 14: S * C * K rows of block_lanes()
COHORT_SCAN = (10240, 8)
#: M.b's push step: the 1024-series stream's two columns at Lb 64
PUSH_SCAN = (2, 1024, 64)
#: float32 shapes past the callers': an odd L whose last tile is partial
#: and an L of 5, each over R not a multiple of the block's rows
EMA_SCAN_ODD = ((2100, 333), (4100, 5))
#: the float64 shape (R = 2100, not a multiple of the block's rows)
EMA_SCAN_F64 = (3, 700, 1366)
#: the kernel's earlier form, timed in turns with the kernel
EMA_SCAN_YARDSTICK = ("tempo_tpu_torch", "csrc", "yardstick",
                      "ema_scan_warp.cu")
#: kernel launches a timing graph holds, and its replays
GRAPH_LAUNCHES, GRAPH_REPLAYS = 16, 20


def build_yardstick(tmp: str):
    """The yardstick form (``csrc/yardstick/ema_scan_warp.cu``) built with
    the library's nvcc flags into ``tmp`` and loaded (ctypes)."""
    import ctypes

    from tempo_tpu_torch.ops import cuda_lib

    src = HERE.joinpath(*EMA_SCAN_YARDSTICK)
    so = Path(tmp) / "libema_scan_warp.so"
    out = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC),
         "-shared", str(src), "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tempo_ema_scan_warp.argtypes = [P, P, ctypes.c_double] + [P] * 3 + \
        [I] * 3 + [P]
    lib.tempo_ema_scan_warp.restype = I
    return lib


def yardstick_scan(lib, x, v, alpha, y0):
    """``(ys, y_end)`` of the yardstick form (no launch count: it is no
    kernel of the port)."""
    L = x.shape[-1]
    ys = torch.empty_like(x)
    y_end = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
    code = lib.tempo_ema_scan_warp(
        x.data_ptr(), v.data_ptr(), float(alpha),
        None if y0 is None else y0.data_ptr(), ys.data_ptr(),
        y_end.data_ptr(), x.numel() // L, L, int(x.dtype == torch.float64),
        torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"yardstick ema_scan launch failed: CUDA error "
                           f"{code}")
    return ys, y_end


def scan_bare(x, v, alpha, y0, plan):
    """``(ys, y_end)`` of the kernel launched straight through ctypes at
    ``plan`` (``(rows, tile, depth)``), as :func:`yardstick_scan` launches
    the yardstick: the eager figure the two share (no wrapper checks, no
    launch count)."""
    from tempo_tpu_torch.ops import cuda_lib

    L = x.shape[-1]
    ys = torch.empty_like(x)
    y_end = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
    code = cuda_lib.lib().tempo_ema_scan(
        x.data_ptr(), v.data_ptr(), float(alpha),
        None if y0 is None else y0.data_ptr(), ys.data_ptr(),
        y_end.data_ptr(), x.numel() // L, L, *plan,
        int(x.dtype == torch.float64),
        torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"ema_scan launch failed: CUDA error {code}")
    return ys, y_end


def graph_ms(fn, launches: int = GRAPH_LAUNCHES,
             replays: int = GRAPH_REPLAYS) -> float:
    """Milliseconds a launch of ``fn()`` as CUDA-graph replays: a graph of
    ``launches`` calls, replayed ``replays`` times between CUDA events
    (after a warm-up replay), over the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del g
    return ms


def chain_probe(dev, dtype) -> dict:
    """The chain bound's step: one thread runs 2^20 dependent
    ``mul_rn``/``add_rn`` steps (``tempo_ema_chain_probe``), timed by CUDA
    events over 5 launches, with ``clocks.sm`` read by ``nvidia-smi``
    while 100 more launches run."""
    from tempo_tpu_torch.ops import cuda_lib

    steps = 1 << 20
    di = torch.tensor([0.8, 0.25, 1.5], dtype=dtype, device=dev)
    out = torch.empty(1, dtype=dtype, device=dev)
    is_double = int(dtype == torch.float64)

    def run():
        code = cuda_lib.lib().tempo_ema_chain_probe(
            di.data_ptr(), out.data_ptr(), steps, is_double,
            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"chain probe launch failed: {code}")

    ms = time_ms(run, reps=5)
    for _ in range(100):
        run()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return dict(step_ns=ms * 1e6 / steps, clocks_sm=clock,
                cycles_a_step=(ms * 1e6 / steps
                               * float(clock.split()[0]) / 1e3
                               if clock.split() and clock.split()[0]
                               .replace(".", "").isdigit() else None))


def phase_b_ema_scan(dev):
    """``ema_scan`` bitwise against its plain version at [2, 1024, 4096],
    M.b's push shape [2, 1024, 64], [1, 16, 64], [10240, 8] (phase N's
    cohort step), [2100, 333] and [4100, 5] (R not a multiple of the
    block's rows), float64 [3, 700, 1366] and one row of 2^20 lanes
    (whose plain run is on the CPU: two torch ops a lane take seconds
    either way), alpha 0.2 and 1, with and without a carry, -0.0 in x and
    NaN in null lanes (and, but for the long row, whose plain run writes
    the CPU's NaN bits, +-inf and NaN in valid lanes); split invariance
    on the card (A, then B from A's ``y_end``, bitwise one run over A +
    B; A's L is L // 3 + 1, 1366 at 4096); the kernel's shared memory
    equal to its plan's.  Then each shape timed eagerly (host-inclusive:
    through the wrapper, and bare: a ctypes launch a call, as the
    yardstick's) and as CUDA-graph replays, in turns with the yardstick
    form (the kernel's earlier form, bitwise the same), the plan against
    four others at [2, 1024, 4096], and the chain bound from a one-thread
    probe beside ``clocks.sm``.
    Returns its row of the result line (launches filled in by phase M)."""
    from tempo_tpu_torch.ops import cuda_lib, scan

    gen = torch.Generator(device=dev).manual_seed(16)

    def case(shape, dtype=torch.float32):
        x = (torch.randn(shape, generator=gen, device=dev) * 50).to(dtype)
        v = torch.rand(shape, generator=gen, device=dev) > 0.2
        x[..., 0] = -0.0
        x[..., 1::7] = -0.0
        lanes = torch.arange(shape[-1], device=dev)
        # NaN in null lanes (ignored: their input is 0), as the serving
        # steps pass them
        x = torch.where(~v & (lanes % 3 == 0), float("nan"), x)
        if shape[-1] < EMA_SCAN_LONG and shape[-1] >= 4:
            # +-inf and NaN in valid lanes near the end of three rows,
            # carried to the end (the plain run is on the card, so the
            # NaN bits are the card's)
            rows2 = x.view(-1, shape[-1])
            vrows = v.view(-1, shape[-1])
            for r, val in enumerate((float("inf"), -float("inf"),
                                     float("nan"))):
                rows2[r % rows2.shape[0], -4 + r] = val
                vrows[r % rows2.shape[0], -4 + r] = True
        y0 = torch.randn(shape[:-1], generator=gen, device=dev).to(dtype)
        return x, v, y0

    main = (2, 1024, 4096)
    shapes = {"main": (main, torch.float32),
              "push_shape": (PUSH_SCAN, torch.float32),
              "serving_shape": ((1, 16, 64), torch.float32),
              "cohort_shape": (COHORT_SCAN, torch.float32),
              "odd_lanes": (EMA_SCAN_ODD[0], torch.float32),
              "five_lanes": (EMA_SCAN_ODD[1], torch.float32),
              "f64": (EMA_SCAN_F64, torch.float64),
              "long_row": ((1, EMA_SCAN_LONG), torch.float32)}
    smem = cuda_lib.lib().tempo_ema_scan_smem
    inputs, plans = {}, {}
    with tempfile.TemporaryDirectory(prefix="tempo_yard_") as tmp:
        t0 = time.perf_counter()
        yard = build_yardstick(tmp)
        yard_s = time.perf_counter() - t0
        for key, (shape, dtype) in shapes.items():
            x, v, y0 = inputs[key] = case(shape, dtype)
            L = shape[-1]
            R = x.numel() // L
            plan = plans[key] = scan.ema_scan_plan(
                R, L, x.element_size(), cuda_lib.sm_count(dev))
            if smem(plan["rows"], plan["tile"], plan["depth"], L,
                    int(dtype == torch.float64)) != plan["smem"]:
                raise AssertionError(f"ema_scan {list(shape)}: the kernel's "
                                     f"shared memory differs from {plan}")
            long = L == EMA_SCAN_LONG
            checks = ([(0.2, y0)] if long
                      else [(a, c) for a in (0.2, 1.0) for c in (None, y0)])
            for alpha, carry in checks:
                got, got_end = scan.ema_scan_cuda(x, v, alpha, carry)
                on = "cpu" if long else dev
                want, want_end = scan.ema_scan_plain(
                    x.to(on), v.to(on), alpha, None if carry is None
                    else carry.to(on))
                what = f"ema_scan {list(shape)} {dtype} alpha {alpha} " \
                       f"{'y0' if carry is not None else 'zero carry'}"
                check_bitwise(got, want.to(dev), what)
                check_bitwise(got_end, want_end.to(dev), what + " (y_end)")
                old, old_end = yardstick_scan(yard, x, v, alpha, carry)
                check_bitwise(old, got, what + " (yardstick form)")
                check_bitwise(old_end, got_end, what + " (yardstick y_end)")
            cut = L // 3 + 1
            if cut < L:
                a, a_end = scan.ema_scan_cuda(x[..., :cut], v[..., :cut],
                                              0.2, y0)
                b, b_end = scan.ema_scan_cuda(x[..., cut:], v[..., cut:],
                                              0.2, a_end)
                whole, whole_end = scan.ema_scan_cuda(x, v, 0.2, y0)
                check_bitwise(torch.cat([a, b], -1), whole,
                              f"ema_scan {list(shape)} split at {cut}")
                check_bitwise(b_end, whole_end,
                              f"ema_scan {list(shape)} split y_end")

        # timed in turns: yardstick, kernel, kernel, yardstick; eagerly
        # through the wrapper, straight through ctypes (as the yardstick),
        # and as graph replays
        times = {}
        for key, (shape, dtype) in shapes.items():
            x, v, y0 = inputs[key]
            p = plans[key]
            plan = (p["rows"], p["tile"], p["depth"])
            long = key == "long_row"
            reps = 3 if long else 10
            new = lambda: scan.ema_scan_cuda(x, v, 0.2, y0)
            bare = lambda: scan_bare(x, v, 0.2, y0, plan)
            old = lambda: yardstick_scan(yard, x, v, 0.2, y0)
            t = {"ms": [], "bare_ms": [], "parent_ms": [], "replay_ms": [],
                 "parent_replay_ms": []}
            for fn, tag in ((old, "parent_"), (new, ""), (new, ""),
                            (old, "parent_")):
                t[tag + "ms"].append(time_ms(fn, reps=reps))
                if tag == "":
                    t["bare_ms"].append(time_ms(bare, reps=reps))
                t[tag + "replay_ms"].append(
                    graph_ms(fn, launches=2 if long else GRAPH_LAUNCHES,
                             replays=2 if long else GRAPH_REPLAYS))
            times[key] = t
        # the plan against others at the main shape (replays, bare
        # launches): four, two and one blocks an SM, and half the tile
        x, v, y0 = inputs["main"]
        sweep = {}
        for alt in ((4, 512, 2), (8, 256, 4), (16, 128, 4), (4, 256, 2),
                    (2, 1024, 2)):
            sweep["x".join(map(str, alt))] = graph_ms(
                lambda: scan_bare(x, v, 0.2, y0, alt))
    chain32 = chain_probe(dev, torch.float32)
    chain64 = chain_probe(dev, torch.float64)

    def nbytes(shape, item=4):
        R, L = int(np.prod(shape[:-1])), shape[-1]
        return R * L * (item + 1 + item) + R * 2 * item   # x, valid, ys; y0, y_end

    x, v, y0 = inputs["main"]
    b, by = bound_ms(nbytes(main), 2 * x.numel())
    row = dict(
        name="ema_scan", route="cuda",
        source="tempo_tpu_torch/csrc/ema_scan.cu",
        replaces="tempo_tpu/ops/rolling.py:485 (ema_scan, a lax.scan; no "
                 "Pallas kernel)",
        max_abs_err=0.0,
        plain_ms=time_ms(lambda: scan.ema_scan_plain(x, v, 0.2, y0), reps=2),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"{list(main)}", yardstick_build_s=yard_s,
        chain_step_ns=chain32["step_ns"],
        chain_step_ns_f64=chain64["step_ns"],
        chain_cycles_a_step=chain32["cycles_a_step"],
        chain_cycles_a_step_f64=chain64["cycles_a_step"],
        clocks_sm=chain32["clocks_sm"], clocks_sm_f64=chain64["clocks_sm"],
        plan_sweep_replay_ms=sweep)
    notes = []
    for key, (shape, dtype) in shapes.items():
        item = 8 if dtype == torch.float64 else 4
        L = shape[-1]
        sfx = "" if key == "main" else f"_{key}"
        t = times[key]
        mean = lambda a: sum(a) / len(a)
        row[f"ms{sfx}"] = mean(t["ms"])
        row[f"ms_spread{sfx}"] = [min(t["ms"]), max(t["ms"])]
        row[f"bare_ms{sfx}"] = mean(t["bare_ms"])
        row[f"replay_ms{sfx}"] = mean(t["replay_ms"])
        row[f"replay_ms_spread{sfx}"] = [min(t["replay_ms"]),
                                         max(t["replay_ms"])]
        row[f"parent_ms{sfx}"] = mean(t["parent_ms"])
        row[f"parent_replay_ms{sfx}"] = mean(t["parent_replay_ms"])
        row[f"parent_replay_ms_spread{sfx}"] = [min(t["parent_replay_ms"]),
                                                max(t["parent_replay_ms"])]
        if key != "main":
            row[f"bound_ms{sfx}"] = bound_ms(
                nbytes(shape, item), 2 * int(np.prod(shape)))[0]
        step = chain64 if item == 8 else chain32
        row[f"chain_bound_ms{sfx}"] = L * step["step_ns"] / 1e6
        row[f"plan{sfx}"] = plans[key]
        p = plans[key]
        notes.append(
            f"{list(shape)}{' f64' if item == 8 else ''}: "
            f"{p['form']} {p['rows']}x{p['tile']} d{p['depth']} "
            f"{p['blocks']} blocks; eager {row[f'ms{sfx}']:.5f}, bare "
            f"{row[f'bare_ms{sfx}']:.5f} (yardstick "
            f"{row[f'parent_ms{sfx}']:.5f}), replay "
            f"{row[f'replay_ms{sfx}']:.5f} (yardstick "
            f"{row[f'parent_replay_ms{sfx}']:.5f}); bounds bytes "
            f"{row[f'bound_ms{sfx}']:.5f}, chain "
            f"{row[f'chain_bound_ms{sfx}']:.5f}")
    log(f"B ema_scan: bitwise (bit views) equal to the plain version and to "
        f"the yardstick form at [2, 1024, 4096], {list(PUSH_SCAN)}, [1, 16, "
        f"64], {list(COHORT_SCAN)}, {list(EMA_SCAN_ODD[0])}, "
        f"{list(EMA_SCAN_ODD[1])} and float64 {list(EMA_SCAN_F64)} (alpha "
        f"0.2 and 1, with and without a carry; -0.0, NaN in null lanes, "
        f"+-inf and NaN in valid lanes) and [1, {EMA_SCAN_LONG}] (plain on "
        f"the CPU; -0.0 and NaN in null lanes); split runs bitwise one run "
        f"at every shape; shared memory as planned. Times in ms, eager "
        f"(host-inclusive: through the wrapper, and bare: a ctypes launch "
        f"as the yardstick's) and as CUDA-graph replays ({GRAPH_LAUNCHES} "
        f"launches a graph), each the mean of two turns beside the "
        f"yardstick's (yardstick, kernel, kernel, yardstick): "
        + "; ".join(notes)
        + f"; plans at [2, 1024, 4096] (rows x tile x depth: replay ms) "
        f"{json.dumps({k: round(t, 5) for k, t in sweep.items()})}"
        + f"; plain {row['plain_ms']:.2f} ms at [2, 1024, 4096]; chain "
        f"step {chain32['step_ns']:.4f} ns float32 at clocks.sm "
        f"{chain32['clocks_sm']} ({chain32['cycles_a_step']} cycles), "
        f"{chain64['step_ns']:.4f} ns float64 at {chain64['clocks_sm']} "
        f"({chain64['cycles_a_step']} cycles); yardstick built in "
        f"{yard_s:.2f} s ({card_line()})")
    return {"ema_scan": row}


# ----------------------------------------------------------------------
# Phase M: serving one stream
# ----------------------------------------------------------------------

#: what the streams themselves must launch, and their batch operators
SLICE16_KERNELS = ("ema_scan",)
ORACLE_KERNELS = ("ema_scan", "asof_merge_lookback", "asof_merge")
SERVE_COLS = ("bid", "ask")


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def take_counts(dev) -> dict:
    """The launch counters since they were last zeroed (once the card's
    queued work is done), then zeroed for the next run."""
    from tempo_tpu_torch.ops import cuda_lib

    sync(dev)
    out = dict(cuda_lib.launches)
    cuda_lib.reset_launches()
    return out


def side_positions(k, n_series: int):
    """Each event's index among the earlier events of its series (the
    events in order)."""
    order = np.argsort(k, kind="stable")
    ks = k[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(k)), 0))
    pos = np.empty(len(k), np.int64)
    pos[order] = np.arange(len(k)) - start
    return pos


def serve_history(k, ts, is_left, vals, K: int):
    """The concatenated history as the batch operators take it: packed
    left keys, right keys and values (pads TS_PAD and NaN), and each
    event's position within its side of its series."""
    from tempo_tpu_torch.packing import TS_PAD

    pos = np.empty(len(k), np.int64)
    out = {}
    for side, sel in (("l", is_left), ("r", ~is_left)):
        idx = np.flatnonzero(sel)
        p = side_positions(k[idx], K)
        pos[idx] = p
        L = int(p.max()) + 1 if len(p) else 1
        t = np.full((K, L), TS_PAD, np.int64)
        t[k[idx], p] = ts[idx]
        out[f"{side}_ts"] = t
        if side == "r":
            C = vals.shape[1]
            v = np.full((C, K, L), np.nan, np.float32)
            for c in range(C):
                v[c, k[idx], p] = vals[idx, c]
            out["r_vals"] = v
    return out, pos


def serve_oracle(hist, dev, *, skip_nulls, ml, w_ns=None, rows_bound=None,
                 alpha=None):
    """The batch operators over the history on ``dev``: the join
    (``sortmerge.asof_merge_values``), the window stats and the EMA, as
    numpy planes."""
    from tempo_tpu_torch.ops import scan, sortmerge
    from tempo_tpu_torch.serve import state as sst

    t = lambda a: torch.from_numpy(a).to(dev)
    r_vals = t(hist["r_vals"])
    r_valids = ~torch.isnan(r_vals)
    vals, found, idx = sortmerge.asof_merge_values(
        t(hist["l_ts"]), t(hist["r_ts"]), r_valids, r_vals,
        skip_nulls=skip_nulls, max_lookback=ml)
    out = {"join": (vals.cpu().numpy(), found.cpu().numpy(),
                    idx.cpu().numpy())}
    if w_ns is not None:
        st, clip = sst.window_stats_batch(t(hist["r_ts"]), r_vals, r_valids,
                                          w_ns, rows_bound)
        out["stats"] = {key: v.cpu().numpy() for key, v in st.items()}
        out["clipped"] = int(clip.sum().item())
    if alpha is not None:
        out["ema"] = scan.ema_scan(r_vals, r_valids,
                                   float(np.float32(alpha)))[0].cpu().numpy()
    sync(dev)
    return out


def check_served(what, k, pos, is_left, got, oracle, cols):
    """Raise unless every emission (``got``: key -> per-event array over
    all events, NaN/False where the event's side does not emit it) is the
    oracle's bits at the event's (series, position)."""
    def same(a, b, key):
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            bad = (np.flatnonzero((a.view(np.uint8).reshape(len(a), -1)
                                   != b.view(np.uint8).reshape(len(b), -1)
                                   ).any(1)) if a.dtype == b.dtype else [])
            raise AssertionError(f"{what}: {key} differs from the batch "
                                 f"operators ({a.dtype} vs {b.dtype}; first "
                                 f"events {list(bad[:5])})")

    li, ri = np.flatnonzero(is_left), np.flatnonzero(~is_left)
    wv, wf, wi = oracle["join"]
    kl, pl = k[li], pos[li]
    for c, col in enumerate(cols):
        same(got[col][li], wv[c, kl, pl], col)
        same(got[f"{col}_found"][li], wf[c, kl, pl], f"{col}_found")
    same(got["right_row_idx"][li].astype(np.int64),
         wi[kl, pl].astype(np.int64), "right_row_idx")
    kr, pr = k[ri], pos[ri]
    planes = dict(oracle.get("stats") or {})
    if "ema" in oracle:
        planes["ema"] = oracle["ema"]
    for key, plane in planes.items():
        for c, col in enumerate(cols):
            same(got[f"{col}_{key}"][ri], plane[c, kr, pr], f"{col}_{key}")
    return len(li) + len(ri)


def serve_steps(k, is_left, cap: int):
    """The push a ``step`` each event goes in when every series' events
    are pushed straight in merged order, side-homogeneous batches of at
    most ``cap`` rows a series: runs of one side (cut at ``cap``) of a
    series take steps of their side's parity, each after the last."""
    n = len(k)
    order = np.argsort(k, kind="stable")
    ks, side = k[order], is_left[order].astype(np.int64)
    first = np.r_[True, ks[1:] != ks[:-1]]
    new_run = first | np.r_[True, side[1:] != side[:-1]]
    run_start = np.maximum.accumulate(np.where(new_run, np.arange(n), 0))
    new_run |= (np.arange(n) - run_start) % cap == 0
    r = np.flatnonzero(new_run)                    # the runs' first events
    rs, rk = side[r], ks[r]
    rfirst = np.r_[True, rk[1:] != rk[:-1]]
    # step_0 = side_0; step_j = step_{j-1} + 1 + (side_j == side_{j-1}),
    # a cumulative sum restarted at each series' first run
    inc = np.where(rfirst, rs, 1 + (rs == np.r_[-1, rs[:-1]]))
    grp = np.maximum.accumulate(np.where(rfirst, np.arange(len(r)), 0))
    csum = np.cumsum(inc)
    step_r = csum - csum[grp] + inc[grp]
    step = np.empty(n, np.int64)
    step[order] = step_r[np.cumsum(new_run) - 1]
    return step


def drive_stream(stream, k, ts, is_left, vals, step, cols, names=None,
                 limit=None):
    """Push every event straight to ``stream`` (one push or push_left a
    step, the steps in order; ``limit`` steps at most): per-event
    emissions over all events (NaN / False / -1 where the event's side
    does not emit a key), the pushes, and the host seconds spent in
    admission (``serve.stream.admit_batch``)."""
    from tempo_tpu_torch.serve import stream as stream_mod

    names = np.arange(stream.cfg.n_series) if names is None else names
    n = len(k)
    got = {}
    order = np.argsort(step, kind="stable")
    bounds = np.flatnonzero(np.r_[True, np.diff(step[order]) != 0, True])
    admit_s = [0.0]
    real_admit = stream_mod.admit_batch

    def timed_admit(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_admit(*a, **kw)
        finally:
            admit_s[0] += time.perf_counter() - t0

    stream_mod.admit_batch = timed_admit
    pushes = 0
    try:
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            if limit is not None and pushes >= limit:
                break
            idx = order[b0:b1]
            ids = names[k[idx]].tolist()
            if is_left[idx[0]]:
                out = stream.push_left(ids, ts[idx])
            else:
                out = stream.push(ids, ts[idx],
                                  {c: vals[idx, j] for j, c in enumerate(cols)})
            pushes += 1
            for key, a in out.items():
                if key not in got:
                    fill = (False if a.dtype == bool else -1
                            if a.dtype.kind == "i" else np.nan)
                    got[key] = np.full(n, fill, a.dtype)
                got[key][idx] = a
    finally:
        stream_mod.admit_batch = real_admit
    return got, pushes, admit_s[0]


def m_hhar_events(pd, left, right, n_right: int):
    """Phase C's frames as a serving feed: the first ``n_right`` right
    (watch) rows in time order and the left (phone) rows up to the last
    of them, each series' events in merged order (time, right before left
    on a tie).  Returns (series, ts ns, is_left, values [n, 1])."""
    r_ts = right["event_ts"].to_numpy().astype("datetime64[ns]").view(np.int64)
    r_order = np.argsort(r_ts, kind="stable")[:n_right]
    cut = r_ts[r_order].max()
    l_ts = left["event_ts"].to_numpy().astype("datetime64[ns]").view(np.int64)
    l_idx = np.flatnonzero(l_ts <= cut)
    k = np.r_[right["user"].to_numpy()[r_order], left["user"].to_numpy()[l_idx]]
    ts = np.r_[r_ts[r_order], l_ts[l_idx]]
    is_left = np.r_[np.zeros(len(r_order), bool), np.ones(len(l_idx), bool)]
    vals = np.r_[right["wx"].to_numpy()[r_order],
                 np.full(len(l_idx), np.nan)].astype(np.float32)[:, None]
    order = np.lexsort((is_left, ts, k))
    return (k[order].astype(np.int64), ts[order], is_left[order],
            vals[order])


def trace_apart(events: dict, cfg: dict) -> dict:
    """M.b's 200 traced steady-state pushes in a process of their own
    (``--trace-worker DIR``, a fresh ``StreamingTSDF`` over ``events``
    warmed up to 64 rows): each profiling run of a long process loses
    a few more device records (measured on an H100: 45,000 records in a
    fresh process's first two runs of these pushes, 44,997 by its
    eighth, one ``ema_scan_kernel`` among them), and this trace is the
    script's fifth.  Relays the worker's lines and returns its
    ``trace_summary`` with ``captures``, the graphs captured while
    traced."""
    import shutil

    tmp = tempfile.mkdtemp(prefix="tempo_mb_trace_")
    try:
        np.savez(os.path.join(tmp, "events.npz"), **events)
        with open(os.path.join(tmp, "cfg.json"), "w") as f:
            json.dump(cfg, f)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--trace-worker", tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=300)
        for line in proc.stdout.splitlines():
            if not line.startswith("["):
                print(line, flush=True)
        if proc.returncode:
            raise AssertionError(f"M.b trace worker failed "
                                 f"({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}")
        with open(os.path.join(tmp, "summary.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def trace_worker(in_dir: str) -> int:
    """The child of :func:`trace_apart`: warm a stream up, trace 200
    pushes, write the summary."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.serve import StreamingTSDF

    a = np.load(os.path.join(in_dir, "events.npz"))
    with open(os.path.join(in_dir, "cfg.json")) as f:
        cfg = json.load(f)
    names = a["names"]
    again = StreamingTSDF(names.tolist(), ["wx"], device=torch.device(
        "cuda", 0), **cfg)
    again.warmup(64)
    c0 = profiling.plan_cache_stats()["graph_captures"]
    _, summary = traced(
        "M.b steady state (200 pushes)",
        lambda: drive_stream(again, a["k"], a["ts"], a["is_left"],
                             a["vals"], a["step"], ["wx"], names,
                             limit=200)[1],
        kernels=("ema_scan_kernel",))
    summary["captures"] = profiling.plan_cache_stats()["graph_captures"] - c0
    with open(os.path.join(in_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    return 0


def phase_m(pd, left, right, n_series: int, dev):
    """Serving one stream (``tempo_tpu_torch.serve``) on the card.  a. The
    reference benchmark's config 11 through ``MicroBatchExecutor``;
    b. phase C's frames at HHAR scale pushed straight to a stream; c.
    the first quarter of b. with no lookback, ``skip_nulls`` both ways.
    Each streamed emission is bitwise the batch operators' on the card
    over the same history (the lookback join, row 4's kernel, for a. and
    b.; the merge join, row 1's, for c.), with zero builds and captures
    after warm-up.  Returns the streams' launch counts (each stream's, from
    just before its warm-up to just after its last push; the batch
    operators' are counted apart)."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.plan import cache as plan_cache
    from tempo_tpu_torch.serve import MicroBatchExecutor, StreamingTSDF
    from tempo_tpu_torch.serve import state as sst

    stats = profiling.plan_cache_stats
    plan_cache.CACHE.clear()
    served, oracles = [], []
    t_phase = time.perf_counter()

    # -- a. config 11 verbatim (bench.py bench_serving) -----------------
    rng = np.random.default_rng(11)
    Ks, C, ml = 16, 2, 64
    cols = SERVE_COLS
    n_warm, n_meas = 600, 4000
    stream = StreamingTSDF([f"sym{i}" for i in range(Ks)], cols,
                           window_secs=10.0, window_rows_bound=32,
                           ema_alpha=0.2, max_lookback=ml, device=dev)
    ex = MicroBatchExecutor(stream, batch_rows=16)
    take_counts(dev)
    t0 = time.perf_counter()
    stream.warmup(16)
    warm_s = time.perf_counter() - t0
    n = n_warm + n_meas
    gaps = rng.exponential(scale=4e7, size=n).astype(np.int64) + 1
    ts = np.cumsum(gaps) + np.int64(10**9)
    series = rng.integers(0, Ks, n)
    is_left = rng.random(n) < 0.25
    vals = rng.standard_normal((n, C)).astype(np.float32)
    vals[rng.random(n) < 0.05, 0] = np.nan

    def feed(i0, i1):
        out = []
        for i in range(i0, i1):
            sym = f"sym{series[i]}"
            if is_left[i]:
                out.append(ex.submit("left", sym, ts[i], timeout=120))
            else:
                out.append(ex.submit(
                    "right", sym, ts[i],
                    {c: vals[i, j] for j, c in enumerate(cols)}, timeout=120))
        return out

    warm = [tk.result(timeout=120) for tk in feed(0, n_warm)]
    s0 = stats()
    t0 = time.perf_counter()
    tickets = feed(n_warm, n)
    measured = [tk.result(timeout=300) for tk in tickets]
    wall = time.perf_counter() - t0
    ex.close(timeout=120)
    served.append(take_counts(dev))
    s1 = stats()
    moved = {key: s1[key] - s0[key]
             for key in ("builds", "graph_captures", "graph_replays")}
    if moved["builds"] or moved["graph_captures"]:
        raise AssertionError(f"M.a steady state built or captured: {moved}")
    if stream.clipped:
        raise AssertionError(f"M.a clipped {stream.clipped} rows")
    hist, pos = serve_history(series, ts, is_left, vals, Ks)
    oracle = serve_oracle(hist, dev, skip_nulls=True, ml=ml,
                          w_ns=sst.window_ns(10.0), rows_bound=32, alpha=0.2)
    oracles.append(take_counts(dev))
    got = {}
    for i, res in enumerate(warm + measured):
        for key, v in res.items():
            if key not in got:
                a = np.asarray(v)
                fill = (False if a.dtype == bool else -1
                        if a.dtype.kind == "i" else np.nan)
                got[key] = np.full(n, fill, a.dtype)
            got[key][i] = v
    checked = check_served("M.a", series, pos, is_left, got, oracle, cols)
    lat = ex.latency_stats()
    log(f"M.a config 11 (16 series, bid/ask, 10 s window of <= 32 rows, EMA "
        f"0.2, maxLookback 64, MicroBatchExecutor(batch_rows=16), "
        f"warmup(16) {warm_s:.3f} s, {n_warm} warm + {n_meas} measured "
        f"Poisson ticks, 25% left, 5% NaN, seed 11): "
        f"{n_meas / wall:.1f} ticks/s; p50/p99 ms right "
        f"{lat['right']['p50_ms']}/{lat['right']['p99_ms']}, left "
        f"{lat['left']['p50_ms']}/{lat['left']['p99_ms']}, all "
        f"{lat['all']['p50_ms']}/{lat['all']['p99_ms']}; {ex.batches} "
        f"batches {dict(sorted(ex.bucket_hist.items()))}; measured part "
        f"{moved}; clipped 0; {checked} emissions bitwise the batch "
        f"operators on the card (lookback join, window_stats_batch, "
        f"ema_scan) ({card_line()})")
    del stream, ex, warm, measured, tickets

    # -- b. HHAR scale, pushed straight to a stream ----------------------
    n_right = 1 << 20
    t0 = time.perf_counter()
    k, ts, is_left, vals = m_hhar_events(pd, left, right, n_right)
    step = serve_steps(k, is_left, 64)
    prep_s = time.perf_counter() - t0
    cfg_b = dict(window_secs=10.0, window_rows_bound=64, ema_alpha=0.2,
                 max_lookback=LOOKBACK)
    names = np.arange(n_series)
    stream = StreamingTSDF(names.tolist(), ["wx"], device=dev, **cfg_b)
    take_counts(dev)
    t0 = time.perf_counter()
    stream.warmup(64)
    warm_s = time.perf_counter() - t0
    s0 = stats()
    sync(dev)
    t0 = time.perf_counter()
    got, pushes, admit_s = drive_stream(stream, k, ts, is_left, vals, step,
                                        ["wx"], names)
    sync(dev)
    wall = time.perf_counter() - t0
    served.append(take_counts(dev))
    s1 = stats()
    moved = {key: s1[key] - s0[key]
             for key in ("builds", "graph_captures", "graph_replays")}
    if moved["builds"] or moved["graph_captures"]:
        raise AssertionError(f"M.b steady state built or captured: {moved}")
    hist, pos = serve_history(k, ts, is_left, vals, n_series)
    oracle = serve_oracle(hist, dev, skip_nulls=True, ml=LOOKBACK,
                          w_ns=sst.window_ns(10.0), rows_bound=64, alpha=0.2)
    oracles.append(take_counts(dev))
    if stream.clipped != oracle["clipped"]:
        raise AssertionError(f"M.b clipped {stream.clipped}, batch "
                             f"{oracle['clipped']}")
    checked = check_served("M.b", k, pos, is_left, got, oracle, ["wx"])
    pool = stream.graph_pool_bytes()
    lb, step_exe = [(lb, e) for (kind, lb), e in
                    sorted(stream._exes.items()) if kind == "push"][-1]
    graph_walk(f"M.b push step (Lb {lb})", step_exe.graph,
               STEP_GRAPH_KERNELS)
    log(f"M.b HHAR stream ({n_series} series, wx right, phone left, 10 s "
        f"window of <= 64 rows, EMA 0.2, maxLookback {LOOKBACK}): "
        f"{len(k)} events ({int((~is_left).sum())} right, "
        f"{int(is_left.sum())} left) in {pushes} pushes of <= 64 rows a "
        f"series, {len(k) / wall:.0f} events/s ({wall:.3f} s; admission "
        f"{admit_s:.3f} s, {admit_s / wall:.4f} of it; feed prepared in "
        f"{prep_s:.3f} s, warmup(64) {warm_s:.3f} s); steady state "
        f"{moved}; graph pools {pool} bytes; clipped {stream.clipped}; "
        f"{checked} emissions bitwise the batch operators on the card "
        f"({card_line()})")
    del oracle, got

    # the steady state traced: a replay launches ema_scan through no
    # wrapper, so the trace shows it ran, once a right push (a right
    # push takes an even step: serve_steps gives a run its side's parity)
    right_pushes = int((np.unique(step)[:200] % 2 == 0).sum())
    summary = trace_apart(dict(k=k, ts=ts, is_left=is_left, vals=vals,
                               step=step, names=names), cfg_b)
    if summary["captures"]:
        raise AssertionError("M.b traced run captured a graph")
    ran = summary["kernel_counts"]["ema_scan_kernel"]
    if not summary["device_events"]:
        ran = "not measured (the profiler traced no device activity)"
    elif ran < right_pushes:
        raise AssertionError(f"M.b traced pushes ran ema_scan_kernel {ran} "
                             f"times for {right_pushes} right pushes")
    log(f"M.b traced steady state: {right_pushes} right pushes of 200, "
        f"ema_scan_kernel runs on the card in their graph replays: {ran}")
    del stream

    # -- c. no lookback, skip_nulls both ways ---------------------------
    r_idx = np.flatnonzero(~is_left)
    first_r = r_idx[np.argsort(ts[r_idx], kind="stable")[:min(
        1 << 18, len(r_idx))]]
    sel = is_left & (ts <= ts[first_r].max())
    sel[first_r] = True
    kc, tc, lc, vc = k[sel], ts[sel], is_left[sel], vals[sel]
    stepc = serve_steps(kc, lc, 64)
    histc, posc = serve_history(kc, tc, lc, vc, n_series)
    for skip in (True, False):
        s = StreamingTSDF(names.tolist(), ["wx"], device=dev,
                          skip_nulls=skip)
        take_counts(dev)
        s.warmup(64)
        t0 = time.perf_counter()
        got, pushes, _ = drive_stream(s, kc, tc, lc, vc, stepc, ["wx"], names)
        wall = time.perf_counter() - t0
        served.append(take_counts(dev))
        oracle = serve_oracle(histc, dev, skip_nulls=skip, ml=0)
        oracles.append(take_counts(dev))
        checked = check_served(f"M.c skip_nulls={skip}", kc, posc, lc, got,
                               oracle, ["wx"])
        log(f"M.c maxLookback 0, skip_nulls={skip}: {len(kc)} events "
            f"({int((~lc).sum())} right) in {pushes} pushes, "
            f"{len(kc) / wall:.0f} events/s; {checked} answers bitwise "
            f"sortmerge.asof_merge_values on the card (the merge kernel)")
    launches, by_oracle = add_counts(*served), add_counts(*oracles)
    missing = [name for name in SLICE16_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"phase M's streams never launched {missing}")
    missing = [name for name in ORACLE_KERNELS if by_oracle[name] == 0]
    if missing:
        raise AssertionError(f"phase M's batch operators never launched "
                             f"{missing}")
    log(f"M took {time.perf_counter() - t_phase:.1f} s; the streams' "
        f"launches {launches}; the batch operators' (counted apart) "
        f"{by_oracle}")
    plan_cache.CACHE.clear()
    return launches


# ----------------------------------------------------------------------
# Phase N: serving cohorts
# ----------------------------------------------------------------------

#: config 14 (bench.py bench_fleet_serving)
FLEET = dict(window_secs=10.0, window_rows_bound=8, ema_alpha=0.2,
             max_lookback=32)
FLEET_COLS = ("px",)


def fleet_feed(S: int, n: int, seed: int = 14):
    """Config 14's tick mix: Poisson gaps of 4e7 ns on one clock (so
    every stream's ticks are in merged order), the first S ticks dealt
    one a stream (data pushes), the rest on random streams, 25% left
    ticks, 5% NaN values.  Returns (stream of each tick, ts, is_left,
    values [n])."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=4e7, size=n).astype(np.int64) + 1
    ts = np.cumsum(gaps) + np.int64(10**9)
    stream_of = np.concatenate([rng.permutation(S),
                                rng.integers(0, S, max(0, n - S))])[:n]
    is_left = rng.random(n) < 0.25
    is_left[:S] = False
    vals = rng.standard_normal(n).astype(np.float32)
    vals[rng.random(n) < 0.05] = np.nan
    return stream_of, ts, is_left, vals


def fleet_cohort(S: int, dev, **kw):
    from tempo_tpu_torch.serve import StreamCohort

    kw.setdefault("slots", S)
    cohort = StreamCohort(FLEET_COLS, device=dev, **FLEET, **kw)
    return cohort, [cohort.add_stream(f"u{i}", ["ticks"]) for i in range(S)]


def tick_runs(stream_of, is_left, i0: int, i1: int, chunk: int):
    """Ticks ``i0 .. i1`` cut into chunks, each chunk into side-homogeneous
    runs where a tick joins the earliest run of its side at or after its
    stream's last run (only each stream's own order is a contract; the
    executor's rule): ``[(is_left, [tick index])]``."""
    out = []
    for c0 in range(i0, i1, chunk):
        runs, last = [], {}
        for i in range(c0, min(i1, c0 + chunk)):
            s, want = int(stream_of[i]), bool(is_left[i])
            placed = next((b for b in range(last.get(s, 0), len(runs))
                           if runs[b][0] == want), -1)
            if placed < 0:
                runs.append((want, []))
                placed = len(runs) - 1
            runs[placed][1].append(i)
            last[s] = placed
        out.extend(runs)
    return out


def drive_runs(cohort, members, runs, stream_of, ts, vals, results):
    """One ``dispatch`` a run; each tick's result into ``results``."""
    for left, idx in runs:
        items = [(members[stream_of[i]], "ticks", int(ts[i]), None,
                  None if left else {"px": vals[i]}) for i in idx]
        res = cohort.dispatch("left" if left else "right", items)
        for i, r in zip(idx, res):
            if isinstance(r, Exception):
                raise AssertionError(f"tick {i} refused: {r}")
            results[i] = r


def same_results(what, got, want, idx):
    """Raise unless the per-tick results ``got[i]`` and ``want[i]`` hold
    the same keys and bits for every ``i`` of ``idx`` (one array a key)."""
    keys = {}
    for i in idx:
        keys.setdefault(tuple(want[i]), []).append(i)
    n = 0
    for names, ids in keys.items():
        for key in names:
            a = np.array([got[i][key] for i in ids])
            b = np.array([want[i][key] for i in ids])
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"{what}: {key} differs")
        n += len(ids)
    return n


def block_results(bts, n0: int, n: int):
    """Per-tick dicts of the ``submit_block`` results of ticks ``n0 ..``
    (the blocks in order)."""
    out = [None] * n
    pos = n0
    for bt in bts:
        cols = bt.result(timeout=600)
        if bt.errors:
            raise AssertionError(f"N.b block refused ticks: "
                                 f"{list(bt.errors.items())[:3]}")
        ln = len(bt.members)
        for j in range(ln):
            out[pos + j] = {key: col[j] for key, col in cols.items()}
        pos += ln
    return out


def moved_since(s0) -> dict:
    from tempo_tpu_torch import profiling

    s1 = profiling.plan_cache_stats()
    return {key: s1[key] - s0[key]
            for key in ("builds", "graph_captures", "graph_replays")}


def n_fleet(dev, S, n_warm, n_meas, served, oracles):
    """N.a (config 14 through ``CohortExecutor``), its per-instance
    baseline, and N.b (the same mix as blocks).  Returns the feed and the
    per-tick results for the trace."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.serve import CohortExecutor, StreamingTSDF
    from tempo_tpu_torch.serve import state as sst

    stats = profiling.plan_cache_stats
    n = n_warm + n_meas
    stream_of, ts, is_left, vals = fleet_feed(S, n)
    chunk = 2048
    cohort, members = fleet_cohort(S, dev)
    ex = CohortExecutor(cohort, batch_rows=32, queue_depth=64,
                        coalesce_s=0.004)
    take_counts(dev)
    t0 = time.perf_counter()
    cohort.warmup(32)
    warm_s = time.perf_counter() - t0

    def feed(i0, i1):
        tickets = []
        for c0 in range(i0, i1, chunk):
            tickets.extend(ex.submit_many([
                ("left", members[stream_of[q]], "ticks", int(ts[q]), None,
                 None) if is_left[q] else
                ("right", members[stream_of[q]], "ticks", int(ts[q]),
                 {"px": vals[q]}, None)
                for q in range(c0, min(i1, c0 + chunk))], timeout=600))
        return tickets

    warm = [t.result(timeout=600) for t in feed(0, n_warm)]
    s0 = stats()
    t0 = time.perf_counter()
    tickets = feed(n_warm, n)
    measured = [t.result(timeout=600) for t in tickets]
    wall = time.perf_counter() - t0
    ex.close(timeout=120)
    served.append(take_counts(dev))
    moved = moved_since(s0)
    if moved["builds"] or moved["graph_captures"]:
        raise AssertionError(f"N.a steady state built or captured: {moved}")
    if cohort.clipped:
        raise AssertionError(f"N.a clipped {cohort.clipped} rows")
    driven = len(set(stream_of.tolist()))
    if driven < S:
        raise AssertionError(f"N.a drove {driven} of {S} streams")
    results = warm + measured
    rate = n_meas / wall
    lat = ex.latency_stats()
    pool = cohort.graph_pool_bytes()
    held = sum(b for g in cohort._groups.values() for e in g._exes.values()
               for b in e.graph_bytes().values())

    # >= 64 sampled streams against the batch operators on the card
    rng = np.random.default_rng(140)
    sample = np.sort(rng.choice(S, size=min(64, S), replace=False))
    row_of = np.full(S, -1, np.int64)
    row_of[sample] = np.arange(len(sample))
    sel = np.flatnonzero(row_of[stream_of] >= 0)
    k = row_of[stream_of[sel]]
    hist, pos = serve_history(k, ts[sel], is_left[sel], vals[sel][:, None],
                              len(sample))
    oracle = serve_oracle(hist, dev, skip_nulls=True,
                          ml=FLEET["max_lookback"],
                          w_ns=sst.window_ns(FLEET["window_secs"]),
                          rows_bound=FLEET["window_rows_bound"],
                          alpha=FLEET["ema_alpha"])
    oracles.append(take_counts(dev))
    got = {}
    for j, i in enumerate(sel):
        for key, v in results[i].items():
            if key not in got:
                a = np.asarray(v)
                fill = (False if a.dtype == bool else -1
                        if a.dtype.kind == "i" else np.nan)
                got[key] = np.full(len(sel), fill, a.dtype)
            got[key][j] = v
    checked = check_served("N.a", k, pos, is_left[sel], got, oracle,
                           list(FLEET_COLS))
    log(f"N.a config 14 ({S} single-series streams, px, 10 s window of <= 8 "
        f"rows, EMA 0.2, maxLookback 32, slots {S}, CohortExecutor("
        f"batch_rows=32, queue_depth=64, coalesce_s=0.004), warmup(32) "
        f"{warm_s:.3f} s, {n_warm} warm + {n_meas} measured Poisson ticks in "
        f"submit_many chunks of {chunk}, 25% left, 5% NaN, seed 14): "
        f"{rate:.1f} ticks/s ({wall:.3f} s); per-ticket p50/p99 ms right "
        f"{lat['right']['p50_ms']}/{lat['right']['p99_ms']}, left "
        f"{lat['left']['p50_ms']}/{lat['left']['p99_ms']}, all "
        f"{lat['all']['p50_ms']}/{lat['all']['p99_ms']} (the last "
        f"{lat['all']['count']} tickets); {ex.batches} dispatches "
        f"{dict(sorted(ex.bucket_hist.items()))}; measured part {moved}; "
        f"clipped 0; {driven} streams driven; graph pools {pool} bytes, "
        f"graphs hold {held} bytes with static inputs ({len(cohort._groups)} "
        f"group, {sum(len(g._exes) for g in cohort._groups.values())} "
        f"graphs); {checked} emissions of {len(sample)} sampled streams "
        f"bitwise the batch operators on the card ({card_line()})")

    # the per-instance baseline: the same fleet as StreamingTSDFs
    base = [StreamingTSDF(["ticks"], FLEET_COLS, device=dev, **FLEET)
            for _ in range(S)]
    base[0].warmup(1)
    rates, bi = [], 0
    for _ in range(3):
        tb0 = time.perf_counter()
        for _ in range(500):
            s = base[stream_of[bi % n]]
            t_i = np.int64(10**9) * (bi + 1)
            if bi % 4 == 3:
                s.push_left(["ticks"], [t_i + 1])
            else:
                s.push(["ticks"], [t_i], {"px": np.float32([vals[bi % n]])})
            bi += 1
        sync(dev)
        rates.append(500 / (time.perf_counter() - tb0))
    base_rate = sorted(rates)[1]
    log(f"N.a baseline: the same mix through {S} StreamingTSDFs, one push "
        f"or push_left a tick: {base_rate:.1f} ticks/s (median of three "
        f"windows of 500 pushes: {[round(r, 1) for r in rates]}); the "
        f"cohort's aggregate is {rate / base_rate:.2f}x it (the reference's "
        f"target, >= 20x, is a prediction here, not a gate) ({card_line()})")
    del base
    served.append(take_counts(dev))

    # -- b. the same mix as blocks ---------------------------------------
    cohort_b, members_b = fleet_cohort(S, dev)
    ex_b = CohortExecutor(cohort_b, batch_rows=32, queue_depth=64,
                          coalesce_s=0.004)
    t0 = time.perf_counter()
    cohort_b.warmup(32, max_block=chunk)
    warm_b = time.perf_counter() - t0

    def feed_blocks(i0, i1):
        return [ex_b.submit_block(
            is_left[c0:min(i1, c0 + chunk)],
            [members_b[s] for s in stream_of[c0:min(i1, c0 + chunk)]],
            "ticks", ts[c0:min(i1, c0 + chunk)],
            values={"px": vals[c0:min(i1, c0 + chunk)]}, timeout=600)
            for c0 in range(i0, i1, chunk)]

    block_results(feed_blocks(0, n_warm), 0, n_warm)
    s0 = stats()
    r0 = dict(cohort_b.routes)
    t0 = time.perf_counter()
    bts = feed_blocks(n_warm, n)
    for bt in bts:
        bt.result(timeout=600)
    block_wall = time.perf_counter() - t0
    ex_b.close(timeout=120)
    served.append(take_counts(dev))
    moved_b = moved_since(s0)
    if moved_b["builds"] or moved_b["graph_captures"]:
        raise AssertionError(f"N.b steady state built or captured: {moved_b}")
    routes = {key: cohort_b.routes[key] - r0[key] for key in r0}
    if routes["block"] <= 0:
        raise AssertionError(f"N.b never ran a block program: {routes}")
    got_b = block_results(bts, n_warm, n)
    same = same_results("N.b", got_b, results, range(n_warm, n))
    if cohort_b.clipped:
        raise AssertionError(f"N.b clipped {cohort_b.clipped} rows")
    log(f"N.b the same mix through submit_block (chunks of {chunk}, "
        f"warmup(32, max_block={chunk}) {warm_b:.3f} s): "
        f"{n_meas / block_wall:.1f} ticks/s ({block_wall:.3f} s, "
        f"{n_meas / block_wall / rate:.2f}x N.a); routes in the measured "
        f"part {routes} (block programs, per-tick steps, ticks of "
        f"duplicate members sent per tick); measured part {moved_b}; "
        f"graph pools {cohort_b.graph_pool_bytes()} bytes ("
        f"{sum(len(g._exes) for g in cohort_b._groups.values())} graphs); "
        f"{same} ticks bitwise N.a's results ({card_line()})")
    return cohort, members


def n_trace(dev, cohort, members, S):
    """200 dispatches of N.a's cohort traced: the busy share, the top
    spans, and ``ema_scan_kernel`` once a right dispatch (a replay goes
    through no wrapper, so only the trace shows the kernel ran)."""
    from tempo_tpu_torch import profiling

    stream_of, ts, is_left, vals = fleet_feed(S, 200 * 256, seed=141)
    ts = ts + np.int64(10**15)               # after every tick so far
    runs = tick_runs(stream_of, is_left, 0, len(ts), 256)[:200]
    right = sum(not left for left, _ in runs)
    c0 = profiling.plan_cache_stats()["graph_captures"]
    results = [None] * len(ts)
    _, summary = traced(
        f"N.a cohort ({len(runs)} dispatches)",
        lambda: drive_runs(cohort, members, runs, stream_of, ts, vals,
                           results), kernels=("ema_scan_kernel",))
    if profiling.plan_cache_stats()["graph_captures"] != c0:
        raise AssertionError("N traced run captured a graph")
    ran = summary["kernel_counts"]["ema_scan_kernel"]
    if not summary["device_events"]:
        ran = "not measured (the profiler traced no device activity)"
    elif ran != right:
        raise AssertionError(f"N traced dispatches ran ema_scan_kernel {ran} "
                             f"times for {right} right dispatches")
    log(f"N traced: {right} right dispatches of {len(runs)}, ema_scan_kernel "
        f"runs on the card in their graph replays: {ran}; busy share "
        f"{summary['busy_share']}")


def n_mesh(dev, S_mesh, served):
    """N.c: a cohort whose stream axis lies over a ``["cuda:0"] * 2``
    stream mesh against a meshless one, fed the same ticks."""
    from tempo_tpu_torch import dist
    from tempo_tpu_torch.parallel import mesh as mesh_mod

    n = S_mesh + 3 * S_mesh
    stream_of, ts, is_left, vals = fleet_feed(S_mesh, n, seed=142)
    mesh = dist.stream_mesh(devices=[str(dev)] * 2)
    plain, p_members = fleet_cohort(S_mesh, dev)
    take_counts(dev)
    meshed, m_members = fleet_cohort(S_mesh, dev, mesh=mesh,
                                     slots=S_mesh - 1)
    cap = meshed._groups[1].capacity
    if cap % 2 or cap < S_mesh:
        raise AssertionError(f"N.c capacity {cap} not rounded to the axis")
    plain.warmup(32)
    meshed.warmup(32)
    runs = tick_runs(stream_of, is_left, 0, n, 512)
    want, got = [None] * n, [None] * n
    calls = []
    real = mesh_mod.transfer

    def no_transfer(*a, **k):
        calls.append(1)
        return real(*a, **k)

    mesh_mod.transfer = no_transfer
    try:
        drive_runs(plain, p_members, runs, stream_of, ts, vals, want)
        cut = len(runs) - min(24, len(runs) // 2)
        drive_runs(meshed, m_members, runs[:cut], stream_of, ts, vals, got)
        # the last dispatches traced: no copy between entries
        _, summary = traced(
            f"N.c meshed cohort ({len(runs) - cut} dispatches)",
            lambda: drive_runs(meshed, m_members, runs[cut:], stream_of, ts,
                               vals, got))
    finally:
        mesh_mod.transfer = real
    served.append(take_counts(dev))
    if calls:
        raise AssertionError(f"N.c pushes called parallel.mesh.transfer "
                             f"{len(calls)} times")
    same = same_results("N.c", got, want, range(n))
    n_state = len(meshed._groups[1].cfg.state_names())
    # each shard's replay copies its inputs in and clones its outputs out
    # on its own device, the only device-to-device copies a dispatch
    # makes: a push's state, batch (4) and emissions (1), a query's eight
    # carries and counts in and four answers out.  The trace may miss a
    # few of them (the profiler drops events), never add one, so a copy
    # between entries shows as more DtoD copies than the replays make,
    # or as a peer copy
    per = {False: (n_state + 4) + (n_state + 1), True: (8 + 1) + 4}
    expect = 2 * sum(per[left] for left, _ in runs[cut:])
    copies = summary["copies"]
    dtod = copies.get("DtoD", {}).get("count", 0)
    other = copies.get("other", {}).get("count", 0)
    if summary["device_events"]:
        if other or dtod > expect:
            raise AssertionError(
                f"N.c traced pushes copied between devices: {copies} "
                f"(the replays' own copies: {expect} DtoD)")
        copy_note = (f"{dtod} DtoD copies recorded of the {expect} the "
                     f"shards' own replays make (inputs in, outputs out), "
                     f"none more, no peer copy")
    else:
        copy_note = "copies not measured (no device activity traced)"
    log(f"N.c stream mesh ['{dev}'] * 2, {S_mesh} streams (slots "
        f"{S_mesh - 1} rounded to {cap}, {cap // 2} a shard): {same} ticks "
        f"in {len(runs)} dispatches bitwise the meshless cohort; "
        f"parallel.mesh.transfer never called; traced {len(runs) - cut} "
        f"dispatches: "
        f"{copy_note} ({card_line()})")


def n_spill(dev, S_spill, served):
    """N.d: a resident budget of 1/8 of the streams against an unspilled
    cohort, fed ticks that touch every member."""
    import shutil
    import tempfile

    n = 2 * S_spill
    stream_of, ts, is_left, vals = fleet_feed(S_spill, n, seed=143)
    runs = tick_runs(stream_of, is_left, 0, n, S_spill // 8)
    tmp = tempfile.mkdtemp(prefix="tempo-spill-")
    try:
        plain, p_members = fleet_cohort(S_spill, dev)
        take_counts(dev)
        tiered, t_members = fleet_cohort(S_spill, dev, spill_dir=tmp,
                                         resident_budget=S_spill // 8)
        want, got = [None] * n, [None] * n
        drive_runs(plain, p_members, runs, stream_of, ts, vals, want)
        t0 = time.perf_counter()
        drive_runs(tiered, t_members, runs, stream_of, ts, vals, got)
        wall = time.perf_counter() - t0
        served.append(take_counts(dev))
        same = same_results("N.d", got, want, range(n))
        st = tiered.spill_stats
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not (st["spills"] and st["restores"]):
        raise AssertionError(f"N.d spilled nothing: {st}")
    log(f"N.d spill tier: {S_spill} streams, resident_budget "
        f"{S_spill // 8}, {n} ticks in {len(runs)} dispatches ({wall:.3f} "
        f"s): {same} ticks bitwise an unspilled cohort; {st['spills']} "
        f"spills in {st['spill_s']:.3f} s, {st['restores']} restores in "
        f"{st['restore_s']:.3f} s ({card_line()})")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def n_durability(dev, S_dur, served):
    """N.e: differential snapshots every few thousand acked ticks, a kill
    inside a dispatch of the executor's worker, ``CohortExecutor.resume``
    and the unacknowledged tails replayed: byte for byte the run that
    never died.  Streams of two buckets, so a differential link can leave
    one out."""
    import shutil
    import tempfile

    from tempo_tpu_torch import checkpoint, resilience
    from tempo_tpu_torch.serve import CohortExecutor, StreamCohort
    from tempo_tpu_torch.testing import faults

    n_pair = 64
    n = 3 * S_dur
    rng = np.random.default_rng(144)
    stream_of, ts, is_left, vals = fleet_feed(S_dur + n_pair, n, seed=144)
    series = np.where(stream_of >= S_dur,
                      np.where(rng.random(n) < 0.5, "a", "b"), "ticks")

    def make(**kw):
        # 64 initial slots a bucket: bucket 1 doubles up to its streams at
        # admission, bucket 2 (the pair streams) stays small
        cohort = StreamCohort(FLEET_COLS, device=dev, slots=64, **FLEET,
                              **kw)
        members = ([cohort.add_stream(f"u{i}", ["ticks"])
                    for i in range(S_dur)]
                   + [cohort.add_stream(f"p{i}", ["a", "b"])
                      for i in range(n_pair)])
        return cohort, members

    def ticks(members, idx):
        return [("left" if is_left[q] else "right", members[stream_of[q]],
                 series[q], int(ts[q]), None if is_left[q]
                 else {"px": vals[q]}, None) for q in idx]

    golden = [None] * n
    g_cohort, g_members = make()
    with CohortExecutor(g_cohort, coalesce_s=0.0) as gex:
        for c0 in range(0, n, 1024):
            idx = range(c0, min(n, c0 + 1024))
            for q, t in zip(idx, gex.submit_many(ticks(g_members, idx))):
                golden[q] = t.result(timeout=600)
    tmp = tempfile.mkdtemp(prefix="tempo-ckpt-")
    try:
        parent = os.path.join(tmp, "ck")
        cohort, members = make(checkpoint_dir=parent, ckpt_every=S_dur // 4,
                               diff_snapshots=True)
        ex = CohortExecutor(cohort, coalesce_s=0.0)
        killed = False
        kill_at = max(2, n // 256)    # about half way: two sides a chunk
        with faults.FaultInjector() as fi:
            fi.kill_on_call(StreamCohort, "dispatch", call_no=kill_at)
            for c0 in range(0, n, 256):
                try:
                    for t in ex.submit_many(ticks(members, range(
                            c0, min(n, c0 + 256)))):
                        t.result(timeout=600)
                except resilience.ShutdownError:
                    killed = True
                    break
        ex.close(timeout=60)
        if not (killed and isinstance(ex.fatal, faults.SimulatedKill)):
            raise AssertionError("N.e the executor's plane was not killed")
        modes = [StreamCohort._snapshot_mode(p)["mode"]
                 for _, p in checkpoint.list_steps(parent)]
        rex = CohortExecutor.resume(parent, coalesce_s=0.0, device=dev)
        acked = rex.cohort.acked
        names = [m.name for m in members]
        r_members = [rex.cohort.stream(nm) for nm in names]
        seen = {}
        tail = []
        for q in range(n):
            s = names[stream_of[q]]
            j = seen.get(s, 0)
            seen[s] = j + 1
            if j >= acked[s]:
                tail.append(q)
        live = [None] * n
        with rex:
            for c0 in range(0, len(tail), 1024):
                idx = tail[c0:c0 + 1024]
                for q, t in zip(idx, rex.submit_many(ticks(r_members, idx))):
                    live[q] = t.result(timeout=600)
        served.append(take_counts(dev))
        same = same_results("N.e", live, golden, tail)
        if any(m.acked != seen.get(m.name, 0) for m in r_members):
            raise AssertionError("N.e cursors did not reach the feed's end")
        full = rex.cohort.snapshot()
        # one pair stream ticks: the differential link holds its bucket only
        m = r_members[S_dur]
        m.push(["a"], [int(ts[-1]) + 10**9], {"px": np.float32([1.0])})
        diff = rex.cohort.snapshot(differential=True)
        b_full, b_diff = dir_bytes(full), dir_bytes(diff)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"N.e durability: {S_dur} + {n_pair} streams (buckets 1 and 2), "
        f"{n} ticks, differential snapshots every {S_dur // 4} acked "
        f"(modes written {sorted(set(modes))}), a kill inside dispatch "
        f"{kill_at} "
        f"of the executor's worker, CohortExecutor.resume at "
        f"{sum(acked.values())} acked, {len(tail)} unacknowledged ticks "
        f"replayed: {same} ticks byte for byte the run that never died; a "
        f"full snapshot {b_full} bytes, a differential one (one pair stream "
        f"ticked) {b_diff} bytes ({card_line()})")


def phase_n(dev, S: int = 10240, n_warm: int = 4000, n_meas: int = 40000,
            S_mesh: int = 2048, S_spill: int = 1024, S_dur: int = 2048):
    """Serving cohorts (``tempo_tpu_torch.serve.StreamCohort``) on the card.
    a. Config 14 verbatim through ``CohortExecutor``, and its
    per-instance baseline; b. the same mix as blocks; c. the stream axis
    over a two-entry mesh of one card; d. the spill tier; e. differential
    snapshots, a kill and a resume; then 200 of a.'s dispatches traced.
    Returns the streams' launch counts (from before each cohort's warm-up
    to after its last dispatch; the batch operators' are counted apart
    and must launch ``ORACLE_KERNELS``)."""
    from tempo_tpu_torch.plan import cache as plan_cache

    plan_cache.CACHE.clear()
    t_phase = time.perf_counter()
    served, oracles = [], []
    cohort, members = n_fleet(dev, S, n_warm, n_meas, served, oracles)
    n_trace(dev, cohort, members, S)
    del cohort, members
    plan_cache.CACHE.clear()
    n_mesh(dev, S_mesh, served)
    n_spill(dev, S_spill, served)
    n_durability(dev, S_dur, served)
    launches, by_oracle = add_counts(*served), add_counts(*oracles)
    missing = [name for name in SLICE16_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"phase N's cohorts never launched {missing}")
    missing = [name for name in ("ema_scan", "asof_merge_lookback")
               if by_oracle.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"phase N's batch operators never launched "
                             f"{missing}")
    log(f"N took {time.perf_counter() - t_phase:.1f} s; the cohorts' "
        f"launches {launches}; the batch operators' (counted apart) "
        f"{by_oracle}")
    plan_cache.CACHE.clear()
    return launches


# ----------------------------------------------------------------------
# The query service (tempo_tpu_torch.service) and the standing-query
# plane (tempo_tpu_torch.query)
# ----------------------------------------------------------------------

#: the service's config-13 and config-19 frames ([K, L] per side)
SERVICE_SHAPE = (8, 512)
SQL_SHAPE = (8, 2048)
SQL_STATEMENTS = {
    "filter": "SELECT * FROM trades WHERE price > 0.5 AND size < 1.5",
    "project": "SELECT price * 2 AS p2, price + size AS ps "
               "FROM trades WHERE size > -0.5",
    "join": "SELECT * FROM trades ASOF JOIN quotes PREFIX 'q' "
            "WHERE q_bid > 0",
}


def service_frame(pd, TSDF, rng, cols, K, L, dev):
    """The reference benchmark's service frames (``bench.py``'s ``mk``):
    K series of L rows at 1-2 s steps, standard-normal columns."""
    secs = np.cumsum(rng.integers(1, 3, size=(K, L)), axis=-1)
    data = {"sym": np.repeat(np.arange(K), L),
            "event_ts": secs.ravel().astype(np.int64)}
    for c in cols:
        data[c] = rng.standard_normal(K * L)
    return TSDF(pd.DataFrame(data), "event_ts", ["sym"], device=dev)


def service_shapes(left, right, lazy_frame):
    """Config 13's three query shapes over shared frames."""
    return {
        "join": lambda: lazy_frame(left).asofJoin(right),
        "join_stats": lambda: (
            lazy_frame(left).asofJoin(right)
            .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10)),
        "stats_ema": lambda: (
            lazy_frame(left)
            .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10)
            .EMA("x", exact=True)),
    }


def eager_shape(name, left, right):
    if name == "join":
        return left.asofJoin(right).df
    if name == "join_stats":
        return left.asofJoin(right).withRangeStats(
            colsToSummarize=["x"], rangeBackWindowSecs=10).df
    return left.withRangeStats(colsToSummarize=["x"],
                               rangeBackWindowSecs=10).EMA(
        "x", exact=True).df


def same_frame(pd, got, want, what: str) -> None:
    try:
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    except AssertionError as e:
        raise AssertionError(f"{what}: not bitwise ({e})") from None


def cold_race(pd, TSDF, left, right, mesh, dev):
    """Decision (b)'s gate: two tenants submit two new mesh signatures
    at once (a fused join -> stats -> EMA node and a stitched resample ->
    interpolate -> EMA -> stats node, each captured as a CUDA graph on
    its first run) on two service workers, while two more tenants keep
    host queries launching; both must succeed, bitwise their eager
    twins."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.service import QueryService, lazy_frame

    def fused_q():
        return (lazy_frame(left).on_mesh(mesh)
                .asofJoin(lazy_frame(right).on_mesh(mesh))
                .withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=10)
                .EMA("x", exact=True))

    def stitched_q():
        return (lazy_frame(left).on_mesh(mesh)
                .resample("10 seconds", "floor")
                .interpolate(method="linear").EMA("x", exact=True)
                .withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=60))

    want = {
        "fused": left.on_mesh(mesh).asofJoin(right.on_mesh(mesh))
        .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10)
        .EMA("x", exact=True).collect().df,
        "stitched": left.on_mesh(mesh).resample("10 seconds", "floor")
        .interpolate(method="linear").EMA("x", exact=True)
        .withRangeStats(colsToSummarize=["x"],
                        rangeBackWindowSecs=60).collect().df,
    }
    shapes = service_shapes(left, right, lazy_frame)
    before = profiling.plan_cache_stats()
    tickets, errs = {}, []
    gate = threading.Barrier(4)
    stop = threading.Event()

    with QueryService(workers=4) as svc:
        def racer(name, q):
            try:
                gate.wait(60)
                tickets[name] = svc.submit(f"race_{name}", q())
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append((name, repr(e)))

        def background(i):
            try:
                gate.wait(60)
                while not stop.is_set():
                    svc.submit(f"bg{i}", shapes["join_stats"]()).result(
                        timeout=300)
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append((f"bg{i}", repr(e)))

        threads = [threading.Thread(target=racer, args=("fused", fused_q)),
                   threading.Thread(target=racer,
                                    args=("stitched", stitched_q)),
                   threading.Thread(target=background, args=(0,)),
                   threading.Thread(target=background, args=(1,))]
        t0 = time.perf_counter()
        for t in threads[:2] + threads[2:]:
            t.start()
        for t in threads[:2]:
            t.join(120)
        got = {}
        for name in ("fused", "stitched"):
            if name not in tickets:
                break
            got[name] = tickets[name].result(timeout=600)
        race_s = time.perf_counter() - t0
        stop.set()
        for t in threads[2:]:
            t.join(300)
        if errs or len(got) != 2:
            raise AssertionError(f"O.a cold race: {errs}, {sorted(got)}")
        st = svc.stats()
    after = profiling.plan_cache_stats()
    caps = after["graph_captures"] - before["graph_captures"]
    for name in ("fused", "stitched"):
        same_frame(pd, got[name].df, want[name], f"O.a cold race {name}")
    if dev.type == "cuda" and caps != 2:
        raise AssertionError(f"O.a cold race: {caps} captures, not 2")
    bg = sum(c["completed"] for t, c in st["tenants"].items()
             if t.startswith("bg"))
    log(f"O.a cold race ({card_line()}): two new mesh signatures (fused "
        f"join -> stats -> EMA, stitched resample -> interpolate -> EMA -> "
        f"stats) submitted at once on two workers, each captured as a CUDA "
        f"graph ({caps} captures, thread_local capture mode under the "
        f"capture lock) while {bg} host queries of two more tenants ran; "
        f"both succeeded in {race_s:.3f} s, bitwise their eager twins")


def o_config13(pd, TSDF, dev, mesh):
    """O.a: config 13 (``bench.py`` ``bench_query_service``) on the card."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.plan import cache as plan_cache
    from tempo_tpu_torch.service import QueryService, lazy_frame

    rng = np.random.default_rng(13)
    n_tenants, n_queries = 8, 24
    Ks, Ls = SERVICE_SHAPE
    left = service_frame(pd, TSDF, rng, ["x"], Ks, Ls, dev)
    right = service_frame(pd, TSDF, rng, ["bid", "ask"], Ks, Ls, dev)
    shapes = service_shapes(left, right, lazy_frame)
    names = list(shapes)
    eager = {name: eager_shape(name, left, right) for name in names}

    plan_cache.CACHE.clear()
    cold_race(pd, TSDF, left, right, mesh, dev)
    plan_cache.CACHE.clear()

    svc = QueryService(workers=4)
    warm = {name: svc.submit("warmup", shapes[name]()).result(timeout=600)
            for name in names}
    for name in names:
        same_frame(pd, warm[name].df, eager[name],
                   f"O.a warm-up {name} vs the eager chain")

    def measured(seed0):
        errs, done = [], []

        def run_tenant(t_name, t_seed):
            trng = np.random.default_rng(t_seed)
            gaps = trng.exponential(scale=2e-3, size=n_queries)
            tickets = []
            try:
                for i in range(n_queries):
                    time.sleep(float(gaps[i]))
                    name = names[int(trng.integers(len(names)))]
                    tickets.append((name, svc.submit(t_name,
                                                     shapes[name]())))
                for name, tk in tickets:
                    done.append((name, tk.result(timeout=600)))
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append((t_name, repr(e)))

        threads = [threading.Thread(target=run_tenant,
                                    args=(f"tenant{i}", seed0 + i))
                   for i in range(n_tenants)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        if errs or len(done) != n_tenants * n_queries:
            raise AssertionError(f"O.a tenants failed: {errs}")
        return wall, done

    s0 = profiling.plan_cache_stats()
    take_counts(dev)
    wall, done = measured(14)
    launches = take_counts(dev)
    s1 = profiling.plan_cache_stats()
    st = svc.stats()
    for name, res in done:
        same_frame(pd, res.df, warm[name].df,
                   f"O.a steady-state {name} vs its warm-up twin")
    builds = s1["builds"] - s0["builds"]
    caps = s1["graph_captures"] - s0["graph_captures"]
    if builds or caps:
        raise AssertionError(f"O.a measured phase: {builds} builds, "
                             f"{caps} captures")
    tenants = {t: c for t, c in st["tenants"].items()
               if t.startswith("tenant")}
    completed = [c["completed"] for c in tenants.values()]
    if len(tenants) != n_tenants or any(c != n_queries for c in completed):
        raise AssertionError(f"O.a: tenants completed {completed}")
    ratio = max(completed) / min(completed)
    if ratio > 1.5:
        raise AssertionError(f"O.a starvation ratio {ratio}")
    pc = st["plan_cache"]
    hits = s1["hits"] - s0["hits"]
    misses = s1["misses"] - s0["misses"]
    log(f"O.a config 13 ({card_line()}): {n_tenants} tenants x "
        f"{n_queries} queries (join, join_stats, stats_ema over shared "
        f"[{Ks}, {Ls}] frames, exponential gaps at a 2 ms mean) through "
        f"QueryService(workers=4): {n_tenants * n_queries / wall:.1f} qps "
        f"({wall:.3f} s); measured cache hits {hits}, misses {misses} "
        f"(hit rate {hits / max(1, hits + misses):.4f}; all-time "
        f"{pc['hits']}/{pc['hits'] + pc['misses']}), builds {builds}, "
        f"captures {caps}; starvation ratio {ratio:.3f}; per tenant "
        + json.dumps({t: [c["p50_ms"], c["p99_ms"]]
                      for t, c in sorted(tenants.items())})
        + f" (p50/p99 ms); every answer bitwise its warm-up twin, every "
        f"warm-up bitwise the eager chain on the card; launches {launches}")
    before = profiling.plan_cache_stats()
    traced("O.a measured", lambda: measured(100)[0])
    after = profiling.plan_cache_stats()
    if after["builds"] != before["builds"]:
        raise AssertionError("O.a traced run built an executable")
    svc.close(timeout=60)
    plan_cache.CACHE.clear()
    return launches, (left, right)


def o_hhar(pd, TSDF, left, right, keep, mesh):
    """O.b: phase L.a's planned chain at HHAR scale through ``submit``."""
    from tempo_tpu_torch.ops import cuda_lib
    from tempo_tpu_torch.plan import cache as plan_cache
    from tempo_tpu_torch.service import (AdmissionController,
                                         AdmissionError, QueryService,
                                         admission, lazy_frame,
                                         project_footprint)

    want = keep["H"]["planes"]
    plan_cache.CACHE.clear()
    torch.cuda.empty_cache()
    query = (lazy_frame(TSDF(left, "event_ts", ["user"])).on_mesh(mesh)
             .asofJoin(lazy_frame(TSDF(right, "event_ts", ["user"]))
                       .on_mesh(mesh))
             .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10)
             .EMA("x", exact=True))
    root = query.plan
    t0 = time.perf_counter()
    fp = project_footprint(root)
    proj_s = time.perf_counter() - t0
    g_cold = admission.graph_bytes(root)
    try:
        AdmissionController().check(fp)
        default = "admitted"
    except AdmissionError as e:
        default = f"rejected ({str(e)[:120]}...)"
    free, total = torch.cuda.mem_get_info()

    def submit(svc):
        """One run through ``submit``: (result, seconds, peak bytes above
        what was allocated before, that base)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = svc.submit("hhar", root).result(timeout=900)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        got = global_planes(out)
        for c, (wv, wok) in want.items():
            gv, gok = got[c]
            if not (torch.equal(gok, wok) and torch.equal(
                    gv.view(torch.int32), wv.view(torch.int32))):
                raise AssertionError(f"O.b: {c} is not bitwise phase "
                                     f"L.a's")
        del out, got
        return secs, peak, base

    take_counts(torch.device("cuda"))
    with QueryService(workers=1, hbm_budget=int(free)) as svc:
        secs, peak, base = submit(svc)
        launches = take_counts(torch.device("cuda"))
        # after the cold run the cache holds the captured graph: the
        # projection now reads its bytes instead of the estimate
        fp_hit = project_footprint(root)
        g_hit = admission.graph_bytes(root)
        secs_hit, peak_hit, _ = submit(svc)
    log(f"O.b ({card_line()}): phase L.a's chain (on_mesh -> asofJoin -> "
        f"withRangeStats(10 s) -> EMA) over {len(left)} rows a side "
        f"through QueryService.submit with hbm_budget = the card's free "
        f"{free} of {total} bytes: {secs:.3f} s cold, {secs_hit:.3f} s "
        f"on a cache hit, every plane bitwise phase L.a's (phase H's) "
        f"both times; projected Footprint(hbm_bytes={fp.hbm_bytes}, "
        f"vmem_bytes={fp.vmem_bytes}) in {proj_s:.3f} s with the cache "
        f"cold (the reference's model {fp.hbm_bytes - g_cold} + the "
        f"fused graph's estimate {g_cold}), measured peak {peak} bytes "
        f"above the {base} already allocated "
        f"(torch.cuda.max_memory_allocated): projection / peak "
        f"{fp.hbm_bytes / peak:.4f}; after the hit the projection is "
        f"{fp_hit.hbm_bytes} (the captured graph's {g_hit} bytes), the "
        f"hit's peak {peak_hit}: projection / peak "
        f"{fp_hit.hbm_bytes / max(peak_hit, 1):.4f} (against the cold "
        f"peak {fp_hit.hbm_bytes / peak:.4f}); under the default 2 GiB "
        f"budget the projection is {default}; launches {launches} (the "
        f"fused node's warm-up and capture; a replay counts none); "
        f"kernel builds {cuda_lib.builds}")
    if peak > fp.hbm_bytes or peak_hit > fp_hit.hbm_bytes:
        raise AssertionError(
            f"O.b: admission projected {fp.hbm_bytes} bytes cold and "
            f"{fp_hit.hbm_bytes} after a hit, the runs peaked at {peak} "
            f"and {peak_hit}")
    plan_cache.CACHE.clear()
    torch.cuda.empty_cache()
    return launches


def o_sql(pd, TSDF, dev):
    """O.c: config 19 (``bench.py`` ``bench_sql``) on the card."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.plan import cache as plan_cache
    from tempo_tpu_torch.plan import render, sql_compile
    from tempo_tpu_torch.service import QueryService, lazy_frame

    rng = np.random.default_rng(19)
    Ks, Ls = SQL_SHAPE
    n_rounds = 40
    trades = service_frame(pd, TSDF, rng, ["price", "size"], Ks, Ls, dev)
    quotes = service_frame(pd, TSDF, rng, ["bid"], Ks, Ls // 2, dev)
    tables = {"trades": trades, "quotes": quotes}
    twins = {
        "filter": lambda: lazy_frame(trades).filter(
            "price > 0.5 AND size < 1.5"),
        "project": lambda: lazy_frame(trades).filter("size > -0.5")
        .selectExpr("event_ts", "sym", "price * 2 as p2",
                    "price + size as ps"),
        "join": lambda: lazy_frame(trades).asofJoin(quotes, right_prefix="q")
        .filter("q_bid > 0"),
    }
    eager = {
        "filter": trades.filter("price > 0.5 AND size < 1.5").df,
        "project": trades.filter("size > -0.5").selectExpr(
            "event_ts", "sym", "price * 2 as p2", "price + size as ps").df,
        "join": trades.asofJoin(quotes, right_prefix="q")
        .filter("q_bid > 0").df,
    }
    plan_cache.CACHE.clear()
    svc = QueryService(workers=2)
    warm = {name: svc.submit_sql("warmup", text, tables).result(timeout=600)
            for name, text in SQL_STATEMENTS.items()}
    for name in SQL_STATEMENTS:
        twin = svc.submit("audit", twins[name]()).result(timeout=600)
        sql_df = warm[name].df
        same_frame(pd, sql_df[twin.df.columns].reset_index(drop=True),
                   twin.df.reset_index(drop=True),
                   f"O.c {name} vs its planned twin")
        same_frame(pd, sql_df[eager[name].columns].reset_index(drop=True),
                   eager[name].reset_index(drop=True),
                   f"O.c {name} vs the eager frame")
    s0 = profiling.plan_cache_stats()
    take_counts(dev)
    t0 = time.perf_counter()
    tickets = [(n, svc.submit_sql(f"tenant{i % 4}", SQL_STATEMENTS[n],
                                  tables))
               for i in range(n_rounds) for n in SQL_STATEMENTS]
    results = [(n, tk.result(timeout=600)) for n, tk in tickets]
    wall = time.perf_counter() - t0
    launches = take_counts(dev)
    s1 = profiling.plan_cache_stats()
    for n, res in results:
        same_frame(pd, res.df, warm[n].df, f"O.c steady-state {n}")
    if s1["builds"] != s0["builds"]:
        raise AssertionError(f"O.c: {s1['builds'] - s0['builds']} builds "
                             f"in the measured phase")
    svc.close(timeout=60)
    seam = render.explain_text(
        sql_compile.compile_statement(SQL_STATEMENTS["project"], tables))
    if "sql_project" not in seam or "sql_filter" not in seam \
            or "eval[sql]=" not in seam:
        raise AssertionError(f"O.c explain: {seam}")
    backend = seam.split("eval[sql]=")[1].split()[0]
    e0 = time.perf_counter()
    for _ in range(n_rounds // 4):
        trades.filter("price > 0.5 AND size < 1.5")
        trades.filter("size > -0.5").selectExpr(
            "event_ts", "sym", "price * 2 as p2", "price + size as ps")
        trades.asofJoin(quotes, right_prefix="q").filter("q_bid > 0")
    eager_qps = 3 * (n_rounds // 4) / (time.perf_counter() - e0)
    log(f"O.c config 19 ({card_line()}): {len(SQL_STATEMENTS)} statements "
        f"x {n_rounds} rounds through submit_sql over [{Ks}, {Ls}] trades "
        f"and [{Ks}, {Ls // 2}] quotes: {3 * n_rounds / wall:.1f} qps "
        f"({wall:.3f} s), eager {eager_qps:.1f} qps; 0 builds measured; "
        f"every answer bitwise its planned twin and the eager frame; "
        f"explain shows sql_filter -> sql_project, eval[sql]={backend}; "
        f"launches {launches}")
    plan_cache.CACHE.clear()
    return launches


def o_faults(pd, TSDF, left, right, dev):
    """O.d: the service's fault domain on the card, each case counted in
    ``stats()``."""
    from tempo_tpu_torch import config
    from tempo_tpu_torch.plan import executor as plan_executor
    from tempo_tpu_torch.resilience import (DeadlineExceeded,
                                            QuarantinedError)
    from tempo_tpu_torch.service import (AdmissionError, QueryService,
                                         lazy_frame, project_footprint)
    from tempo_tpu_torch.testing import faults

    def q():
        return (lazy_frame(left).asofJoin(right)
                .withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=10))

    fp = project_footprint(q().plan)
    out = {}
    # a. over the shared-memory budget: rejected by name, at once
    with QueryService(workers=1, vmem_budget=fp.vmem_bytes - 1) as svc:
        try:
            svc.submit("smem", q())
        except AdmissionError as e:
            if "VMEM" not in str(e):
                raise
        else:
            raise AssertionError("O.d: an over-budget query was admitted")
        out["rejected"] = svc.stats()["tenants"]["smem"]["rejected"]

    # b. over the free device memory: queued, then run once released
    gate = threading.Event()
    real = plan_executor.execute

    def gated(root):
        gate.wait(120)
        return real(root)

    plan_executor.execute = gated
    try:
        with QueryService(workers=2,
                          hbm_budget=int(fp.hbm_bytes * 1.5)) as svc:
            t1 = svc.submit("hbm", q())
            t2 = svc.submit("hbm", q())
            deadline = time.perf_counter() + 30
            while t1.t_start is None:
                if time.perf_counter() > deadline:
                    raise AssertionError("O.d: the first query never ran")
                time.sleep(0.005)
            time.sleep(0.3)
            queued = t2.t_start is None and \
                svc.stats()["hbm_in_use"] == fp.hbm_bytes
            gate.set()
            r1, r2 = t1.result(timeout=300), t2.result(timeout=300)
            same_frame(pd, r1.df, r2.df, "O.d queued query")
            if not queued or t2.t_start < t1.t_done:
                raise AssertionError("O.d: the second query did not queue "
                                     "behind the budget")
            out["queued_then_completed"] = \
                svc.stats()["tenants"]["hbm"]["completed"]
    finally:
        gate.set()
        plan_executor.execute = real

    # c. a poisoned signature is quarantined after the threshold
    threshold = config.get_int("TEMPO_TPU_BREAKER_THRESHOLD", 3)
    with QueryService(workers=1) as svc:
        with faults.FaultInjector() as fi:
            fi.flaky(plan_executor, "execute", failures=threshold)
            for _ in range(threshold):
                try:
                    svc.submit("poison", q()).result(timeout=300)
                except faults.InjectedFault:
                    pass
                else:
                    raise AssertionError("O.d: the fault did not fire")
            try:
                svc.submit("poison", q())
            except QuarantinedError:
                pass
            else:
                raise AssertionError("O.d: the signature was not "
                                     "quarantined")
        c = svc.stats()["tenants"]["poison"]
        out["poison_failed"], out["quarantined"] = c["failed"], \
            c["quarantined"]

    # d. a deadline named by its stage: the budget admits one query at a
    # time, so the second waits in the admission queue past its 50 ms
    gate = threading.Event()
    plan_executor.execute = gated
    try:
        with QueryService(workers=2,
                          hbm_budget=int(fp.hbm_bytes * 1.5)) as svc:
            hold = svc.submit("dl", q())
            late = svc.submit("dl", q(), deadline_s=0.05)
            try:
                late.result(timeout=60)
            except DeadlineExceeded as e:
                stage = e.stage
            else:
                raise AssertionError("O.d: the deadline did not fire")
            gate.set()
            hold.result(timeout=300)
            out["deadline_stage"] = stage
            out["deadline_failed"] = svc.stats()["tenants"]["dl"]["failed"]
    finally:
        gate.set()
        plan_executor.execute = real

    # e. close(timeout) drains what is queued
    svc = QueryService(workers=2)
    tickets = [svc.submit(f"drain{i % 2}", q()) for i in range(8)]
    t0 = time.perf_counter()
    svc.close(timeout=120)
    drain_s = time.perf_counter() - t0
    if not all(t.done() for t in tickets):
        raise AssertionError("O.d: close(timeout) left tickets pending")
    for t in tickets:
        t.result(timeout=1)
    st = svc.stats()["tenants"]
    out["drained"] = st["drain0"]["completed"] + st["drain1"]["completed"]
    want = {"rejected": 1, "queued_then_completed": 2,
            "poison_failed": threshold, "quarantined": 1,
            "deadline_stage": "admission queue", "deadline_failed": 1,
            "drained": 8}
    if out != want:
        raise AssertionError(f"O.d counts {out}, want {want}")
    log(f"O.d fault domain ({card_line()}): over the shared-memory budget "
        f"({fp.vmem_bytes - 1} B < {fp.vmem_bytes} B) rejected by name; "
        f"a query over the free device memory queued, then ran once the "
        f"first released its {fp.hbm_bytes} bytes; a poisoned signature "
        f"quarantined after {threshold} failures; a 50 ms deadline named "
        f"by its stage; close(timeout) drained 8 queued queries in "
        f"{drain_s:.3f} s; counts {json.dumps(out)}")


def o_smem_layouts() -> None:
    """Admission's shared-memory figures against the compiler's: each
    kernel's static shared memory (``cudaFuncGetAttributes``) and its
    dynamic bytes, as the launchers export them."""
    from tempo_tpu_torch.ops import cuda_lib
    from tempo_tpu_torch.service import admission

    pairs = {"range_stats row form": (admission.RANGE_ROW_SMEM,
                                      cuda_lib.range_row_smem()),
             "asof_merge walk": (admission.ASOF_WALK_SMEM,
                                 cuda_lib.asof_walk_smem()),
             "asof_merge_lookback tile join": (admission.ASOF_TILE_SMEM,
                                               cuda_lib.asof_tile_smem())}
    wrong = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if wrong:
        raise AssertionError(f"O admission's shared memory a block "
                             f"(figure, kernel's) differs: {wrong}")
    log(f"O admission's shared memory a block equals the kernels' "
        f"(static + dynamic): {dict((k, v[0]) for k, v in pairs.items())}")


def phase_o(pd, TSDF, left, right, keep, dev):
    """The query service (``tempo_tpu_torch.service``) on the card.
    a. config 13 (a cold race of two new mesh signatures first), b. phase
    L.a's chain at HHAR scale through ``submit``, c. config 19's SQL, d.
    the fault domain.  Returns the launch counts of a., b. and c.'s
    measured runs."""
    from tempo_tpu_torch import make_mesh

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        o_smem_layouts()
    mesh = make_mesh() if dev.type == "cuda" else make_mesh(
        {"series": 2}, devices=["cpu"] * 2)
    la, (sl, sr) = o_config13(pd, TSDF, dev, mesh)
    lb = o_hhar(pd, TSDF, left, right, keep, mesh) if keep else {}
    lc = o_sql(pd, TSDF, dev)
    o_faults(pd, TSDF, sl, sr, dev)
    log(f"O took {time.perf_counter() - t_phase:.1f} s")
    return add_counts(la, lb, lc)


def same_standing(pd, res, twin, what: str) -> None:
    """A standing ``result()`` frame against its batch twin: the same
    columns and rows, float columns byte for byte."""
    if list(res.columns) != list(twin.columns) or len(res) != len(twin):
        raise AssertionError(f"{what}: columns or rows differ from the "
                             f"batch twin")
    for c in res.columns:
        a, b = res[c], twin[c]
        if a.dtype.kind == "f":
            if a.to_numpy().tobytes() != b.to_numpy().tobytes():
                raise AssertionError(f"{what}: {c} is not bitwise the "
                                     f"batch twin's")
        elif not a.equals(b):
            raise AssertionError(f"{what}: {c} differs from the batch "
                                 f"twin's")


def p_join(pd, dev, StandingQueryEngine, StreamTable, _run_batch, served,
           oracles):
    """One join-delta subscription over two ``StreamTable``s, fed in
    merged order, bitwise its batch twin.  Appends the subscription's
    launch counts to ``served`` and its twin's to ``oracles``."""
    rng = np.random.default_rng(201)
    n = 4096
    ts = np.sort(rng.integers(0, 10**7, n))
    df = pd.DataFrame({
        "event_ts": pd.to_datetime(ts, unit="s"),
        "sym": rng.choice(["AAA", "BBB", "CCC", "DDD"], n),
        "bid": rng.normal(99, 2, n), "ask": rng.normal(101, 2, n),
        # runs of 1 to 64 rows a side: a push a run
        "side": np.repeat(np.arange(n) % 2 == 1,
                          rng.integers(1, 65, n))[:n]})
    df.loc[rng.random(n) < 0.05, "bid"] = np.nan
    df = df.sort_values(["event_ts", "side"], kind="stable").reset_index(
        drop=True)
    hist, live = df.iloc[:512], df.iloc[512:]
    L = StreamTable("orders", "event_ts", ["sym"], [], device=dev)
    R = StreamTable("quotes", "event_ts", ["sym"], ["bid", "ask"],
                    device=dev)
    L.append(hist[hist["side"]][["event_ts", "sym"]])
    R.append(hist[~hist["side"]][["event_ts", "sym", "bid", "ask"]])
    side = live["side"].to_numpy()
    cuts = [0] + [i for i in range(1, len(live)) if side[i] != side[i - 1]]
    cuts.append(len(live))
    with StandingQueryEngine() as eng:
        frame = L.frame().asofJoin(R.frame(), right_prefix="right",
                                   maxLookback=4)
        sub = eng.register(frame)
        if sub.mode != "delta":
            raise AssertionError(f"P join: {sub.mode} ({sub.reason})")
        t0 = time.perf_counter()
        for a, b in zip(cuts[:-1], cuts[1:]):
            run = live.iloc[a:b]
            if side[a]:
                eng.push(L, run[["event_ts", "sym"]])
            else:
                eng.push(R, run[["event_ts", "sym", "bid", "ask"]])
        res = sub.result(timeout=600).df
        secs = time.perf_counter() - t0
        served.append(take_counts(dev))
        twin = _run_batch(sub.plan.root, {L.name: L.snapshot_df(),
                                          R.name: R.snapshot_df()}).df
        oracles.append(take_counts(dev))
    same_standing(pd, res, twin, "P join delta")
    return (f"one join-delta subscription (maxLookback 4) over two "
            f"StreamTables, {len(cuts) - 1} pushes in merged order "
            f"({secs:.3f} s), bitwise its batch twin ({len(res)} rows)")


def p_resume(pd, dev, StandingQueryEngine, StreamTable,
             snapshot_subscription, resume_subscription):
    """A standing EMA snapshotted at boundary 3, resumed on a fresh
    engine: the tail byte-identical to the uninterrupted run's."""
    import shutil
    import tempfile

    batches = []
    for k in range(8):
        rng = np.random.default_rng(300 + k)
        n = 128
        b = pd.DataFrame({
            "event_ts": pd.to_datetime(
                3000 * k + np.sort(rng.integers(0, 1000, n)), unit="s"),
            "sym": rng.choice(["AAA", "BBB"], n),
            "px": rng.normal(100.0, 5.0, n)})
        b.loc[rng.random(n) < 0.05, "px"] = np.nan
        batches.append(b.sort_values("event_ts", kind="stable")
                       .reset_index(drop=True))

    def query(t):
        return t.frame().EMA("px", exp_factor=0.3, exact=True)

    t = StreamTable("s", "event_ts", ["sym"], ["px"], device=dev)
    t.append(batches[0])
    with StandingQueryEngine() as eng:
        sub = eng.register(query(t))
        for b in batches[1:]:
            eng.push(t, b)
        full = sub.result(timeout=600).df
    d = tempfile.mkdtemp(prefix="tempo-standing-")
    try:
        path = os.path.join(d, "ck")
        t2 = StreamTable("s", "event_ts", ["sym"], ["px"], device=dev)
        t2.append(batches[0])
        with StandingQueryEngine() as eng2:
            sub2 = eng2.register(query(t2))
            for b in batches[1:4]:
                eng2.push(t2, b)
            if not eng2.flush(timeout=600):
                raise AssertionError("P resume: flush timed out")
            snapshot_subscription(sub2, path)
        t3 = StreamTable("s", "event_ts", ["sym"], ["px"], device=dev)
        for b in batches[:4]:
            t3.append(b)
        with StandingQueryEngine() as eng3:
            sub3 = resume_subscription(eng3, query(t3), path)
            for b in batches[4:]:
                eng3.push(t3, b)
            resumed = sub3.result(timeout=600).df
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same_standing(pd, resumed, full, "P resume")
    return (f"snapshot_subscription at boundary 3 of 7, "
            f"resume_subscription on a fresh engine: the {len(full)}-row "
            f"result byte-identical to the uninterrupted run's")


def p_store(pd, dev, StreamTable):
    """``sync_to_store`` round trip against its pandas twin (C5)."""
    import shutil
    import tempfile

    from tempo_tpu_torch.store.engine import Store

    rng = np.random.default_rng(401)
    batches = []
    for k in range(4):
        n = 256
        batches.append(pd.DataFrame({
            "event_ts": pd.to_datetime(
                3000 * k + np.sort(rng.integers(0, 1000, n)), unit="s"),
            "sym": rng.choice(["AAA", "BBB"], n),
            "px": rng.normal(100.0, 5.0, n)}))
    d = tempfile.mkdtemp(prefix="tempo-store-")
    try:
        t = StreamTable("ticks", "event_ts", ["sym"], ["px"],
                        store=Store(d), device=dev)
        for b in batches[:2]:
            t.append(b)
        t.sync_to_store()
        for b in batches[2:]:
            t.append(b)
        snap = t.snapshot_df()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    twin = pd.concat(batches, ignore_index=True)
    pd.testing.assert_frame_equal(snap, twin, check_exact=True)
    return (f"sync_to_store of 512 rows, then 512 more in the tail: the "
            f"unified snapshot equals pd.concat of the pushed frames "
            f"(arrival order, source dtypes)")


def phase_p(pd, dev, n_delta=1536, n_stateless=384, n_remainder=128,
            warm_pushes=6, meas_pushes=24, traced_pushes=1,
            rows_per_push=128):
    """Standing queries (``tempo_tpu_torch.query``) on the card: config 20
    (``bench.py`` ``bench_standing``) at its published counts, then a
    join-delta subscription, a snapshot / resume round trip and a store
    round trip.  Returns the standing engine's own launch counts: the
    planes' warm-ups, captures and pushes, and the join, resume and store
    runs'.  The batch twins' (``_run_batch``, the checks' oracle) are
    counted apart and must launch ``ema_scan`` and
    ``asof_merge_lookback``."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.plan import cache as plan_cache
    from tempo_tpu_torch.query import (StandingQueryEngine, StreamTable,
                                       resume_subscription,
                                       snapshot_subscription)
    from tempo_tpu_torch.query.standing import _run_batch

    t_phase = time.perf_counter()
    stats = profiling.plan_cache_stats
    syms = np.asarray(["AAA", "BBB"], object)

    def rows(rng, n, t0):
        # config 20's "strictly increasing ns timeline": exponential gaps
        # at a 2 ms mean from 1 s after the epoch, as nanoseconds (the
        # benchmark passes the raw integers, which a frame reads as
        # seconds: 2e6 s a row, past the 2^62 ns pad key by row ~880)
        ns = t0 + np.cumsum(rng.exponential(scale=2e6, size=n)
                            .astype(np.int64) + 1)
        return pd.DataFrame({
            "event_ts": pd.to_datetime(ns, unit="ns"),
            "sym": syms[rng.integers(0, len(syms), n)],
            "px": np.where(rng.random(n) < 0.05, np.nan,
                           rng.normal(100.0, 5.0, n)),
        })

    n_rows = (1 + warm_pushes + meas_pushes) * rows_per_push
    timeline = rows(np.random.default_rng(20), n_rows, np.int64(10 ** 9))
    # the traced pushes continue the timeline from their own seed
    last = int(timeline["event_ts"].iloc[-1].value)
    timeline = pd.concat([timeline, rows(
        np.random.default_rng(21), traced_pushes * rows_per_push, last)],
        ignore_index=True)

    def batch(i):
        lo = i * rows_per_push
        return timeline.iloc[lo:lo + rows_per_push]

    plan_cache.CACHE.clear()
    take_counts(dev)
    t = StreamTable("ticks", "event_ts", ["sym"], ["px"], device=dev)
    t.append(batch(0))
    eng = StandingQueryEngine(remainder_every=10 ** 6)
    alphas = (0.2, 0.35)
    queries = []
    for i in range(n_delta):
        queries.append(("delta", t.frame().EMA(
            "px", exp_factor=alphas[i % 2], exact=True)))
    for _ in range(n_stateless):
        queries.append(("stateless",
                        t.frame().select("event_ts", "sym", "px")))
    for _ in range(n_remainder):
        queries.append(("remainder", t.frame().withRangeStats(
            colsToSummarize=["px"], rangeBackWindowSecs=600)))
    audit, subs = {}, []
    r0 = time.perf_counter()
    for want, q in queries:
        sub = eng.register(q)
        if sub.mode != want:
            raise AssertionError(f"P: registered {sub.mode}, not {want} "
                                 f"({sub.reason})")
        subs.append(sub)
        audit.setdefault(want if want != "delta"
                         else f"delta_a{sub.plan.emas[0].alpha}", sub)
    register_s = time.perf_counter() - r0
    for i in range(warm_pushes):
        eng.push(t, batch(1 + i))
        if not eng.flush(timeout=600):
            raise AssertionError("P warm-up push: flush timed out")
    s0 = stats()
    lat = []
    t0 = time.perf_counter()
    for i in range(meas_pushes):
        p0 = time.perf_counter()
        eng.push(t, batch(1 + warm_pushes + i))
        if not eng.flush(timeout=600):
            raise AssertionError("P measured push: flush timed out")
        lat.append(time.perf_counter() - p0)
    wall = time.perf_counter() - t0
    s1 = stats()
    builds = s1["builds"] - s0["builds"]
    caps = s1["graph_captures"] - s0["graph_captures"]
    if builds or caps:
        raise AssertionError(f"P measured pushes: {builds} builds, {caps} "
                             f"captures")

    def traced_run():
        for i in range(traced_pushes):
            eng.push(t, batch(1 + warm_pushes + meas_pushes + i))
            if not eng.flush(timeout=600):
                raise AssertionError("P traced push: flush timed out")

    traced("P measured pushes", traced_run)
    s2 = stats()
    if s2["builds"] != s1["builds"] or \
            s2["graph_captures"] != s1["graph_captures"]:
        raise AssertionError("P traced pushes built or captured")
    served, oracles = [take_counts(dev)], []
    # the audits: sampled results against the batch re-run of the
    # canonical plan over the unified snapshot (ema_stream evaluates
    # through ops.scan.ema_scan, the csrc/ema_scan.cu kernel on a card)
    snap = {t.name: t.snapshot_df()}
    for label, sub in audit.items():
        res = sub.result(timeout=600).df
        twin = _run_batch(sub.plan.root, dict(snap)).df
        same_standing(pd, res, twin, f"P {label}")
    oracles.append(take_counts(dev))
    standing = served[0]
    if dev.type == "cuda" and standing.get("ema_scan", 0) == 0:
        raise AssertionError(f"P: the planes launched no ema_scan "
                             f"({standing})")
    dropped = sum(s.dropped for s in subs)
    pool = eng.graph_pool_bytes()
    n_planes = len(eng._planes)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved() if dev.type == "cuda" else 0
    eng.close()
    pool_closed = eng.graph_pool_bytes()
    if pool_closed:
        raise AssertionError(f"P: closed planes still pin {pool_closed} "
                             f"bytes of graph pools")
    plan_cache.CACHE.clear()
    import gc

    del subs, audit, sub, queries
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reserved1 = torch.cuda.memory_reserved() if dev.type == "cuda" else 0
    lat_ms = np.sort(np.asarray(lat) * 1e3)
    n_subs = n_delta + n_stateless + n_remainder
    log(f"P config 20 ({card_line()}): {n_subs} subscriptions ({n_delta} "
        f"delta at alpha {alphas}, {n_stateless} stateless, {n_remainder} "
        f"remainder) over one StreamTable, registered at "
        f"{n_subs / register_s:.1f}/s ({register_s:.3f} s); {meas_pushes} "
        f"measured pushes of {rows_per_push} rows after {warm_pushes} "
        f"warm-up: {meas_pushes / wall:.3f} pushes/s, "
        f"{meas_pushes * rows_per_push / wall:.1f} rows/s, "
        f"{n_subs * meas_pushes / wall:.1f} notifications/s, p50 "
        f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.3f} ms a push; 0 builds and 0 "
        f"captures measured; dropped {dropped}; {n_planes} planes' graph "
        f"pools {pool} bytes, 0 pinned after close; the allocator's "
        f"reserved bytes {reserved0} before close, {reserved1} after "
        f"close, CACHE.clear() and empty_cache(); "
        f"sampled results (delta at both alphas, stateless, remainder) "
        f"bitwise the batch re-run; the standing path's launches "
        f"{standing}")
    log("P " + p_join(pd, dev, StandingQueryEngine, StreamTable,
                      _run_batch, served, oracles))
    log("P " + p_resume(pd, dev, StandingQueryEngine, StreamTable,
                        snapshot_subscription, resume_subscription))
    log("P " + p_store(pd, dev, StreamTable))
    served.append(take_counts(dev))
    plan_cache.CACHE.clear()
    launches, by_oracle = add_counts(*served), add_counts(*oracles)
    missing = [name for name in ("ema_scan", "asof_merge_lookback")
               if by_oracle.get(name, 0) == 0]
    if dev.type == "cuda" and missing:
        raise AssertionError(f"P's batch twins never launched {missing}")
    log(f"P took {time.perf_counter() - t_phase:.1f} s; the standing "
        f"engine's launches {launches}; the batch twins' (counted apart) "
        f"{by_oracle}")
    return launches


# ----------------------------------------------------------------------
# Phase Q: the chaos campaigns on the card; phase R: the tuner on the card
# ----------------------------------------------------------------------

#: phase Q's sizes: the reference bench's config 15 and 17 at full size,
#: config 16's slab with the slab sweep cut (reference values beside)
Q_SERVING = dict(n_streams=48, events_per_stream=80, seed=15)
Q_STORE = dict(rows=200_000, segment_rows=20_000, n_streams=64,
               resident_budget=12, events_per_stream=24, seed=17)
#: with at most 8 slabs the sweep can compile every window before its
#: kill (the campaign's zero-builds-on-resume assertion) only for fewer
#: than 7 windows, so n_windows is cut too
Q_PIPELINE = dict(physical_rows=4_000_000, n_keys=32, n_windows=6,
                  rows_total=32_000_000, ckpt_every=3, seed=16)
Q_PIPELINE_REFERENCE = dict(rows_total=1_000_000_000, ckpt_every=10,
                            n_windows=8)
#: the kernels each campaign must have launched on the card: one of each
#: group (range stats by whichever engine the shape picks: the row or
#: staged form, or the windowed engine's rank and prefix sums)
Q_KERNELS = {"serving": (("ema_scan",),), "service": (("ema_ladder",),),
             "pipeline": (("asof_merge",),
                          ("range_stats", "range_stats_ring", "merge_rank",
                           "legacy_stats"),
                          ("ema_ladder",))}


def phase_q(dev, tmp: str) -> dict:
    """Phase Q: each campaign between a reset and a read of the launch
    counters; returns the launches a campaign (printed apart)."""
    from tempo_tpu_torch.testing import chaos

    take_counts(dev)
    out = {}

    def run(name, fn):
        t0 = time.perf_counter()
        rep = fn()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in take_counts(dev).items() if v}
        idle = [group for group in Q_KERNELS.get(name, ())
                if not any(counts.get(k, 0) for k in group)]
        if idle:
            raise AssertionError(f"Q {name} campaign launched no {idle} on "
                                 f"the card: {counts}")
        out[name] = counts
        return rep, seconds

    serving, s_serv = run("serving", lambda: chaos.run_serving_campaign(
        os.path.join(tmp, "serving"), n_streams=Q_SERVING["n_streams"],
        events_per_stream=Q_SERVING["events_per_stream"],
        seed=Q_SERVING["seed"], recovery_bound_s=60.0, device=dev))
    log(f"Q serving campaign (config 15: {Q_SERVING['n_streams']} streams x "
        f"{Q_SERVING['events_per_stream']} events): {s_serv:.1f} s, "
        f"{serving['ticks_per_sec']} ticks/s, recovery "
        f"{serving['recovery_s']} s, {serving['replayed_ticks']} replayed, "
        f"outcomes {serving['outcomes']}, injected {serving['injected']}, "
        f"restarts {serving['restarts']}, snapshot bytes diff/full "
        f"{serving['snapshot_bytes']['diff_vs_full']}; "
        f"{serving['tail_audit']}; launches {out['serving']}")
    service, s_svc = run("service", lambda: chaos.run_service_campaign(
        seed=Q_SERVING["seed"] + 1, device=dev))
    log(f"Q service campaign: {s_svc:.1f} s, outcomes {service['outcomes']}, "
        f"restarts {service['restarts']}, breaker {service['breaker']}; "
        f"launches {out['service']}")
    store, s_store = run("store", lambda: chaos.run_store_campaign(
        os.path.join(tmp, "store"), device=dev, **Q_STORE))
    log(f"Q store campaign (config 17: {Q_STORE['rows']} rows, "
        f"{Q_STORE['n_streams']} streams over {Q_STORE['resident_budget']} "
        f"resident): {s_store:.1f} s, write resume {store['write_resume']}, "
        f"refusals {store['refusals_by_name']}, compaction "
        f"{store['compaction']['segments_before']} -> "
        f"{store['compaction']['segments_after']} segments, cohort spill "
        f"{ {k: v for k, v in store['cohort_spill'].items() if k != 'value_audit'} }; "
        f"launches {out['store']}")
    log("Q pipeline campaign cuts (config 16): " + ", ".join(
        f"{k} {Q_PIPELINE[k]} (reference {v})"
        for k, v in Q_PIPELINE_REFERENCE.items()))
    pipe, s_pipe = run("pipeline", lambda: chaos.run_pipeline_campaign(
        os.path.join(tmp, "pipeline"), device=dev,
        devices=[dev] * 4,
        recovery_bound_s=120.0, **Q_PIPELINE))
    if pipe["n_slabs"] > 8:
        raise AssertionError(f"Q pipeline sweep ran {pipe['n_slabs']} slabs")
    log(f"Q pipeline campaign: {s_pipe:.1f} s, {pipe['n_slabs']} slabs of "
        f"{pipe['slab_rows']} rows ({pipe['rows_total']} rows driven, "
        f"{pipe['rows_per_sec']} rows/s), ingest resume "
        f"{ {k: v for k, v in pipe['ingest_resume'].items() if k != 'value_audit'} }, "
        f"quarantine rows kept {pipe['quarantine']['rows_kept']} of "
        f"{pipe['quarantine']['rows_clean']}, deadline stage "
        f"{pipe['ingest_deadline_stage']!r}, plan barriers recovery "
        f"{pipe['plan_barriers']['recovery_s']} s, sweep {pipe['sweep']}, "
        f"foreign refused {pipe['foreign_signature_refused']}; "
        f"launches {out['pipeline']}")
    print(json.dumps({"phase_q": {
        "recovery_s": {"serving": serving["recovery_s"],
                       "plan_barriers": pipe["plan_barriers"]["recovery_s"],
                       "sweep": pipe["sweep"]["recovery_s"]},
        "seconds": {"serving": round(s_serv, 3), "service": round(s_svc, 3),
                    "store": round(s_store, 3),
                    "pipeline": round(s_pipe, 3)},
        "launches": out}}), flush=True)
    return out


def start_phase_r(tmp: str, dev):
    """Phase R's smoke sweep as a child process (its own probe children
    below it), writing its profile under ``tmp``."""
    out = os.path.join(tmp, "smoke_profile.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(HERE), env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tempo_tpu_torch.tune", "--smoke", "--out",
         out, "--device", str(dev)], cwd=str(HERE), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return proc, out, time.perf_counter()


def stop_group(proc) -> None:
    """End ``proc`` and its probe children if it is still running."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, 9)
        except ProcessLookupError:
            pass
        proc.wait()


def phase_r(sweep, dev, hh: dict) -> None:
    """Phase R: wait for the smoke sweep, check its audits and load its
    profile strictly, then the checked-in profile; then the window
    roofline of phase B's staged range stats against a saxpy rate."""
    from tempo_tpu_torch import profiling, tune
    from tempo_tpu_torch.ops import stream
    from tempo_tpu_torch.serve import MicroBatchExecutor, StreamingTSDF
    from tempo_tpu_torch.tune import probe

    proc, path, t0 = sweep
    stdout, stderr = proc.communicate(timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"R smoke sweep exited {proc.returncode}: "
                             f"{stderr.strip().splitlines()[-5:]}")
    payload = json.loads(stdout.strip().splitlines()[-1])
    if payload.get("audit_failures"):
        raise AssertionError(f"R smoke sweep audit failures: "
                             f"{payload['audit_failures']}")
    log(f"R smoke sweep: {seconds:.1f} s (beside phase Q), zero audit "
        f"failures; " + "; ".join(
            f"{n}: knobs {r.get('knobs')}, speedup {r.get('speedup')}, "
            f"{r.get('probes')} probes, {len(r.get('rejected', []))} "
            f"rejected" for n, r in payload["classes"].items()))

    with env_set("TEMPO_TPU_TUNE_PROFILE", path):
        tune.reload()
        prof = tune.load(strict=True)
        if prof is None or prof["crc"] != tp_crc(path):
            raise AssertionError("R smoke profile did not load")
        want_depth = prof["knobs"].get("TEMPO_TPU_DMA_BUFFERS", 2)
        if stream.dma_buffers() != want_depth:
            raise AssertionError(f"R dma_buffers() {stream.dma_buffers()} "
                                 f"!= the profile's {want_depth}")
        s = StreamingTSDF(["a"], ["x"], window_secs=10, window_rows_bound=8,
                          device=dev)
        with MicroBatchExecutor(s) as ex:
            rows = ex.batch_rows
        want_rows = tune.knob_value("TEMPO_TPU_SERVE_BATCH_ROWS",
                                    "serve_batch") or 64
        if rows != want_rows:
            raise AssertionError(f"R batch_rows {rows} != the profile's "
                                 f"{want_rows}")
        log(f"R strict load of the smoke profile: knobs {prof['knobs']}, "
            f"dma_buffers() {stream.dma_buffers()}, MicroBatchExecutor "
            f"batch_rows {rows}")
    tune.reload()
    checked_in = tune.load(strict=True)
    if checked_in is None:
        raise AssertionError(f"R no checked-in profile for "
                             f"{tune.runtime_fingerprint()} at "
                             f"{tune.default_path()}")
    log(f"R strict load of the checked-in profile "
        f"{os.path.relpath(tune.active_path(), HERE)} (crc "
        f"{checked_in['crc']}, {checked_in['fingerprint']}): knobs "
        f"{checked_in['knobs']}, measured {checked_in['measured']}; "
        f"dma_buffers() {stream.dma_buffers()}")

    # the stream classes' probe at every ring depth, in this process:
    # the rate and the plan each depth asked for runs (the sweep prunes
    # its ladders, so its profile holds no rate a depth)
    for name in ("stream_dense", "stream_medium"):
        ladder, digests = [], set()
        for depth in range(2, 9):
            with dma_depth(depth):
                rec = {"knobs": {"TEMPO_TPU_DMA_BUFFERS": depth}}
                probe.probe_stream(name, dev, rec)
                plan = stream.last_plan["range_stats"]
            digests.add(rec["digest"])
            ladder.append(f"d{depth}: {rec['rows_per_sec']:.6g} rows/s "
                          f"({rec['t_iter'] * 1e3:.5f} ms; plan "
                          f"{plan['form']} T={plan.get('tile')} depth "
                          f"{plan.get('depth')})")
        if len(digests) != 1:
            raise AssertionError(f"R {name} changed bits across ring "
                                 f"depths: {digests}")
        log(f"R {name} ladder at [256, 4096], bitwise across depths: "
            + "; ".join(ladder))

    gbps = probe.stream_saxpy_gbps(dev, 256, 262144)
    log(f"R saxpy stream rate over a 256 MiB plane: {gbps:.1f} GB/s")
    for label, ms in hh["ms"].items():
        roof = profiling.window_roofline(
            hh["lanes"], read_bytes_per_row=4 + 1, write_bytes_per_row=7 * 4,
            t_iter=ms / 1e3, stream_bytes_per_sec=gbps * 1e9,
            key_bytes_per_row=4)
        log(f"B window roofline, row 2 staged at the HHAR shape ({label}, "
            f"{ms:.4f} ms): {roof}")


# ----------------------------------------------------------------------
# Phase S: the compiled contracts on the card
# ----------------------------------------------------------------------

#: the kernels a captured graph must name: one of each group (a part of
#: a mangled name); the fused node runs asof_merge (its row walk, or the
#: lookback tiles for few rows), range stats (the centres, then the row
#: or staged form) and the EMA ladder's ema_block
FUSED_GRAPH_KERNELS = (("asof_walk_kernel", "lookback_join_kernel"),
                       ("range_centres",),
                       ("range_rows", "range_ring_kernel"),
                       ("ema_block",))
STEP_GRAPH_KERNELS = (("ema_scan_kernel",),)


def graph_walk(label: str, captured, need=()) -> dict:
    """Print the walk of a captured graph (``profiling.graph_nodes``:
    node counts by type, kernel names, memcpy bytes by direction) and
    require one kernel of each group of ``need`` among its nodes."""
    from tempo_tpu_torch import profiling

    nodes = (captured if isinstance(captured, list)
             else profiling.graph_nodes(captured))
    summ = profiling.graph_summary(nodes)
    names = summ["kernels"]
    missing = [grp for grp in need
               if not any(g in n for g in grp for n in names)]
    by_name = {}
    for n in nodes:
        if n["type"] == "kernel":
            k = profiling.short_kernel_name(n["name"])
            by_name[k] = by_name.get(k, 0) + 1
    log(f"{label} graph walk ({card_line()}): nodes {summ['nodes']}, "
        f"memcpy bytes {summ['memcpy_bytes']}, kernel nodes by name "
        f"{by_name}")
    if missing:
        raise AssertionError(f"{label}: the graph names no kernel of "
                             f"{missing}")
    return summ


def phase_s(dev) -> None:
    """Phase S: ``plan/contracts.build_all`` on the card (each program at
    its contract shape on a mesh of eight entries of ``dev``, the
    replayed ones captured) and every rule: zero findings beyond the
    declared barriers.  The fused and service programs' graphs must name
    the fused node's kernels, the serving and standing steps'
    ``ema_scan_kernel``.  Then two planted programs through the same
    rules, each of which must be flagged: a capture that copies a pinned
    host tensor with ``non_blocking=True`` (``no-host-transfer``, from
    the graph walk) and a float64 [K, L] op (``no-f64-leak``)."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.plan import cache as plan_cache
    from tempo_tpu_torch.plan import contract_rules as rules
    from tempo_tpu_torch.plan import contracts, fused

    t0 = time.perf_counter()
    with env_set("TEMPO_TPU_COMPUTE_DTYPE", "float32"):
        programs, chains, errors = contracts.build_all(device=dev)
    build_s = time.perf_counter() - t0
    findings, code = rules.run_compiled(rules.COMPILED_RULES, programs,
                                        chains, errors)
    need = {"fused.asof_stats_ema": FUSED_GRAPH_KERNELS,
            "service.dispatch_ema": FUSED_GRAPH_KERNELS,
            "serve.step": STEP_GRAPH_KERNELS,
            "standing.step": STEP_GRAPH_KERNELS,
            "serve.cohort_push": STEP_GRAPH_KERNELS}
    for p in programs:
        moved = profiling.comm_bytes_from_record(p.record)
        model = dict(p.contract.collectives, **p.contract.incidental)
        if p.graph is None:
            log(f"S {p.name}: eager, {len(p.record.ops)} aten ops, moved "
                f"{moved} B against the model {model} B, host reads "
                f"{len(p.record.host_reads)}")
            continue
        graph_walk(f"S {p.name} ({len(p.graphs())} graph(s); moved "
                   f"{moved} B against the model {model} B)",
                   p.graph_nodes(), need.get(p.name, ()))
    missing = [n for n in need if n not in {p.name for p in programs}]
    if errors or missing or findings or code:
        raise AssertionError(
            f"S: exit code {code}, build errors {errors}, programs "
            f"missing {missing}, findings "
            f"{[f.render() for f in findings]}")

    # planted programs: each must be flagged
    pinned = torch.arange(CONTRACT_PLANT[1],
                          dtype=torch.float32).pin_memory()
    x = torch.randn(CONTRACT_PLANT, device=dev)

    def plant(x):
        buf = torch.empty(pinned.shape, device=x.device)
        buf.copy_(pinned, non_blocking=True)
        return [x + buf]

    host_p = contracts.CompiledProgram(
        "planted.pinned_copy", contracts._record(plant, x)[0],
        contracts.Contract(), fused.capture(None, dev, plant, [x]))
    f64_p = contracts.CompiledProgram(
        "planted.f64", contracts._record(lambda t: t.double() * 3, x)[0],
        contracts.Contract())
    got = {}
    for rule, p in ((rules.NoHostTransferRule(), host_p),
                    (rules.NoF64LeakRule(), f64_p)):
        found, c = rules.run_compiled([rule], [p], [], {}, registry=False)
        got[p.name] = [f.render() for f in found]
        if c != rule.code:
            raise AssertionError(f"S: {p.name} was not flagged by "
                                 f"{rule.name}: {got[p.name]}")
    graph_walk("S planted.pinned_copy", host_p.graph_nodes())
    n_graphs = sum(len(p.graphs()) for p in programs)
    del programs, chains, host_p
    plan_cache.CACHE.clear()
    torch.cuda.empty_cache()
    log(f"S compiled contracts ({card_line()}): {len(need)} graph "
        f"programs named their kernels; {n_graphs} graphs walked; zero "
        f"findings over the registry (build {build_s:.2f} s, rules and "
        f"plants {time.perf_counter() - t0 - build_s:.2f} s); planted "
        f"programs flagged: {got}")


def tp_crc(path: str) -> int:
    with open(path) as f:
        return int(json.load(f)["crc"])


def add_counts(*counts):
    """Launch counters of several runs, summed by kernel."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=13_062_475)
    ap.add_argument("--series", type=int, default=1024)
    ap.add_argument("--long-series", type=int, default=128,
                    help="series of phase F's frames (the same --rows)")
    ap.add_argument("--rank-worker", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help="run one rank of phase K's two-process part")
    ap.add_argument("--trace-worker", metavar="DIR",
                    help="trace phase M.b's steady state in this process")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import tempo_tpu_torch
        from tempo_tpu_torch import TSDF, entry, interop
        from tempo_tpu_torch.ops import cuda_lib
    except ImportError as e:
        print(f"chip_smoke.py: the tempo_tpu_torch package is not beside "
              f"it ({e})", file=sys.stderr)
        return 2
    if Path(tempo_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke.py: tempo_tpu_torch was not found beside it",
              file=sys.stderr)
        return 2
    try:
        import pandas as pd
    except ImportError:
        print("chip_smoke.py: pandas is missing; the frame path needs it",
              file=sys.stderr)
        return 2

    if args.trace_worker:
        return trace_worker(args.trace_worker)
    if args.rank_worker:
        rank, port, out_dir = args.rank_worker
        return rank_worker(int(rank), int(port), out_dir, args.rows,
                           args.series)
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"A build: {time.perf_counter() - t0:.2f} s "
        f"({'compiled' if cuda_lib.build_log else 'loaded existing'} "
        f"{', '.join(cuda_lib.SOURCES)})")
    for text in cuda_lib.build_log:
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"A ptxas: {line.strip()}")

    t0 = time.perf_counter()
    left, right, n = make_frames(pd, args.rows, args.series)
    log(f"C data: {n} rows a side in {time.perf_counter() - t0:.2f} s")
    d_args = interop.from_reference_arrays(
        *entry.example_args(K=args.series, Ll=8192, Lr=8192), device=dev)

    t0 = time.perf_counter()
    left3, right3, n3 = make_frames(pd, args.rows, args.long_series)
    log(f"F data: {n3} rows a side over {args.long_series} series in "
        f"{time.perf_counter() - t0:.2f} s")

    rows = phase_b(pd, left, right, left3, dev, d_args)
    rows2 = phase_b_slice2(right, left3, dev)
    rows3 = phase_b_slice3(pd, left3, right3, dev, d_args)
    rows4 = phase_b_slice4(left, dev, d_args)
    rows5 = phase_b_bucket(pd, TSDF, left, right, left3, dev)
    rows6 = phase_b_ema_scan(dev)
    torch.cuda.empty_cache()
    past = phase_b_past_limits(dev)
    keep = {}
    launches, c_seconds = phase_c(pd, TSDF, left, right, n, args.series,
                                  keep)
    phase_d(d_args)
    launches2 = phase_e(TSDF, right, n, args.series)
    launches3, long_launches = phase_f(pd, TSDF, left3, right3, n3,
                                       args.long_series)
    torch.cuda.empty_cache()
    launches4, _ = phase_g(pd, TSDF, left, n, args.series)
    torch.cuda.empty_cache()
    launches5 = phase_h(pd, TSDF, left, right, n, args.series, c_seconds,
                        keep)
    torch.cuda.empty_cache()
    launches6 = phase_i(pd, TSDF)
    phase_j(pd, TSDF, dict(C=(left, right), F=(left3, right3)), keep,
            args.series)
    del left3, right3
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches7 = phase_k(pd, TSDF, left, right, n, keep,
                        WORKER_USERS * (args.rows // args.series),
                        WORKER_USERS)
    log(f"K took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_l(pd, TSDF, left, right, n, keep)
    log(f"L took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    launches8 = phase_m(pd, left, right, args.series, dev)
    torch.cuda.empty_cache()
    launches10 = phase_o(pd, TSDF, left, right, keep, dev)
    del keep, left, right
    torch.cuda.empty_cache()
    launches9 = phase_n(torch.device("cuda", torch.cuda.current_device()))
    torch.cuda.empty_cache()
    launches11 = phase_p(pd, torch.device("cuda",
                                          torch.cuda.current_device()))
    torch.cuda.empty_cache()
    qr_dev = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory(prefix="tempo_qr_") as tmp:
        t0 = time.perf_counter()
        sweep = start_phase_r(tmp, qr_dev)
        try:
            phase_q(qr_dev, tmp)
            log(f"Q took {time.perf_counter() - t0:.1f} s")
            phase_r(sweep, qr_dev, rows["range_stats"].pop("_hh"))
        finally:
            stop_group(sweep[0])
        log(f"Q and R took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_s(qr_dev)
    log(f"S took {time.perf_counter() - t0:.1f} s")

    # launches: summed over the main-path runs (phases C, E, F, G's legacy
    # step, H, I, K, M, N, O and P), each counted between a reset and a
    # read
    found = add_counts(launches, launches2, launches3, long_launches,
                       launches4, launches5, launches6, launches7, launches8,
                       launches9, launches10, launches11)
    rows6["ema_scan"]["launches_phase_p"] = launches11["ema_scan"]
    rows["ema_ladder"].update(rows3.pop("_ema_phase_f"))
    kernels = []
    for table in (rows, rows2, rows3, rows4, rows5, rows6):
        for name, row in table.items():
            row = dict(row)
            row.update(past.get(name, {}))
            row["launches"] = found[row.get("counter", name)]
            kernels.append(row)
    idle = [row["name"] for row in kernels if row["launches"] == 0]
    if idle:
        raise AssertionError(f"no main path launched {idle}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
