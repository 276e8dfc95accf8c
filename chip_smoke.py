#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card,
``nvcc`` and PyTorch built for CUDA. It imports ``repro_torch`` from ``src/``
(never JAX, never ``repro``), builds the CUDA kernels from
``src/repro_torch/csrc`` into ``build/repro_torch/`` (one ``nvcc`` per
source, all started together), and runs, in order:

1. environment: the card (and its power limit), torch/CUDA/nvcc versions
   and the kernels' build time;
2. the main path (intersection lane): ``TriangleCounter(rmat_graph(18, 16,
   seed=1))`` with default options (auto → intersection, buckets on the
   card), checked against the forward-DAG scipy oracle and 82,629,122, with
   the launch counters read around it (K1 and K2's CSR form launch, the
   padded K2 does not); per-vertex counts must sum to 3 × count;
3. each strategy forced in turn on every non-tiny Table-1 analogue of
   ``graphs/datasets.py``, counts against ``triangle_count_scipy`` and
   per-vertex counts against the filtered auto run; the bitmap kernel's
   counter is read around this phase, its main path;
3b. the matrix lane: ``TriangleCounter(load_dataset("orkut-like"),
   algorithm="matrix")`` (90,025 tile triples of B = 128: the unique bf16
   tiles and the triple indices resident on the card, the lane's own peak
   under 2 GiB) against the oracle and 13,038,569, with both masked-SpGEMM
   counters read around it (six tensor-core launches, no float32 one);
   ``complete_graph(512)`` through auto (→ matrix, 22,238,720, past 2²⁴);
   matrix forced on coauthors-like and road-like (B = 32, whichever route
   ``WGMMA_BLOCKS`` gives it, its counter read) against scipy;
3c. the subgraph lane: ``TriangleCounter(grid_graph(3000, diagonals=True,
   spur_fraction=0.35, seed=3))`` with default options (auto → subgraph; a
   road_central-sized mesh, n = 12,150,000) against the oracle and
   17,988,002 = 2·2999², the peel against a numpy 2-core fixed point,
   per-vertex counts summing to 3 × count, with the broadcast kernel's
   counter read around it; subgraph forced on every non-tiny analogue
   against scipy and the intersection lane's per-vertex counts; labeled
   triangle queries (``subgraph_match_triangle``) on R-MAT scale 12, whose
   buckets go to K2 with u ids dropped in place, against the CPU's plain
   path and 6 × scipy, with K2's counter read around them;
4. each kernel against its plain torch version on the card, exactly, at
   the shapes its path gave it (K2's CSR form at the main path's probe
   buckets, read from the forward CSR; the padded K2 at phase 3g's tiled
   chunks, its main path now) and on ragged shapes (K2 also at W = 2048
   and 8192, the bfs lane's widths, and on the row families of
   ``tests/probe_rows.py``; K1 and K3 on those of ``tests/intersect_rows.py``:
   unsorted rows, duplicates, ids outside the bitmap, W from 1 to 63, K3's
   wide rows, E past one sweep of their persistent grids, K3 at the
   family's capacity and at the 65536-bit cap; each also as a view that
   starts mid-allocation; with K1's and K3's registers and spills, none of
   which may spill, and K1's time on the grid's (33554432, 8) bucket beside
   its bound);
   the kernel's time (CUDA events, L2
   flushed before each launch), the plain version's time, the bound (K2:
   the bytes it must read, with the rows its range test skips, beside the
   all-bytes bound and the ``torch.searchsorted`` yardstick; K2's CSR
   form: each row a live edge needs read once, its row offsets and ends,
   the endpoints and counts, ``csr_read_bound``) and,
   for the masked SpGEMM, the library call on the same tiles (K4 in both
   launch orders, and beside it the float32 yardstick on gathered stacks
   and the float32 CUDA-core kernel on the same triples, and a diagnostic
   with every index 0; ragged bf16 gathered cases with all-ones and
   corner tiles; the build's registers, spills and HGMMA count). Then
   every plan of phases 2–3c is released, so the new lanes below run on an
   empty card and print their own peaks;
3d. the hash lane: ``TriangleCounter(rmat_graph(17, 16, seed=1),
   algorithm="hash")`` (a compact table of 67,108,865 chain offsets and
   1,864,319 ids, 0.28 GB, for the reference's (131072, 512, 64) dense
   table of 16 GiB) against the forward-DAG scipy oracle and 36,128,651,
   with the hash-probe kernel's counter read around it (4 launches per
   ``count()``), no stage argument past 2-d and the lane's own peak below
   the dense lane's 23.44 GiB; per-vertex counts (through the filtered
   sidecar) summing to 3 × count; then ``rmat_graph(18, 16, seed=1)``
   through the hash lane against 82,629,122 (its dense table would be
   64 GiB); hash forced on every non-tiny analogue against scipy, two of
   them with ``prep_backend="host"``;
4b. the hash-probe kernel against its plain version, exactly, at the four
   shapes of each path (scales 17 and 18), on the case families of
   ``tests/hash_rows.py`` (each also as views that start mid-allocation;
   both of the kernel's routes) and through the dense entry point on 64
   ragged shapes; its time, the plain version's time, the bytes it must
   read (``hash_read_bound``) beside PR 13's all-bytes bound, the rows
   whose row end is 0, and the build's registers and spills (none may
   spill);
3k. the edge lane: ``TriangleCounter(rmat_graph(18, 16, seed=1),
   algorithm="edge")`` (wide int64 keys, mk = 4,194,304): ``edge_support()``
   against ``edge_support_forward_scipy`` (timed), Σ support = 3 ×
   82,629,122 and each vertex's incident supports = 2·t(v) from phase 2;
   prep seconds, the warm ``edge_support()`` and ``count()`` (medians of
   3) and the lane's own peak; ``k_truss(K_TRUSS)`` against a scipy peel on
   the same oracle (non-empty, ≥ 2 rounds, as many rounds); each strategy
   forced on every non-tiny analogue (int32 keys) against the oracle;
   ``truss_decomposition()`` on coauthors-like and road-like against
   ``truss_decomposition_forward_scipy``; one ``edge_support()`` under
   ``torch.profiler`` (device busy time, idle share, kernels by time);
3l. dynamic sessions: ``DynamicTriangleCounter(rmat_graph(18, 16,
   seed=1))`` (wide keys, capacity 4,194,304) takes 64 batches of 256
   updates from ``np.random.default_rng(0)`` (half deletes of live edges,
   half inserts of random pairs, two repeats and two self-loops each);
   the median batch of 2–64 and updates/s, every growth of the capacity
   or width class, no new cache entry in steady state, the own peak; 8
   more batches under ``torch.profiler``; then
   ``recount()`` with K1–K3's counters read around it, against the kept
   count and ``triangle_count_forward_scipy(snapshot())``, and each of the
   recount's stages held against its plain version (``recount_path`` in
   the kernels line; its probe buckets through K2's CSR form); shorter
   streams on coauthors-like and road-like (int32 keys); a
   ``{"lanes": ...}`` line with the two lanes' numbers;
3g. tiled counting: the pinned host-to-device rate (1 GiB, median of 5),
   then ``TriangleCounter(rmat_graph(18, 16, seed=1),
   max_device_bytes=1 << 30)``: its (2097152, 128) bucket streams in 4
   chunks of 524,288 rows and its (4194304, 512) bucket in 32 of 131,072,
   19.33 GB of u and v a count, from pinned host memory, against 82,629,122
   and phase 2's per-vertex counts, with no cache miss over three warm
   replays and the launch counters read around it; its warm ``count()``
   beside the streamed bytes over the measured rate, and the session's own
   peak; the phase-3c grid through the subgraph lane under the same budget
   (K1 on its chunks) against 17,988,002 and phase 3c's per-vertex counts;
   each chunk shape (its first and last chunk) held against the plain
   version, exactly, and timed;
3h. beyond the card: ``rmat_graph(20, 16, seed=1)`` under 8 GiB when the
   host has 128 GiB or more (its buckets pin 80.14 GiB), else
   ``rmat_graph(19, 16, seed=1)`` under 4 GiB (32.06 GiB pinned), against
   the forward scipy oracle (timed; at scale 19 its value from earlier
   runs, 187,666,186), with the session's own peak and the warm
   ``count()`` beside its bound;
3i. the tiled matrix lane: orkut-like with ``max_device_bytes=1 << 30``:
   22 chunks of 4,096 triples, each with its own bf16 tiles, against
   13,038,569, 22 tensor-core launches a count, the bytes it streams, and
   its first and last chunk held against the plain version;
3j. batching: ``count_many`` over R-MAT scales 10–14 (seeds 0–63, edge
   factor 16) and the non-tiny analogues at ``batch_size=16``, each count
   against ``triangle_count_scipy`` and a per-graph ``TriangleCounter``,
   one intersection launch per width per batch, no cache miss on a second
   pass, its wall time beside the per-graph loop's; a forced-bitmap batch
   for K3; the first batch's stacked shapes held against the plain
   versions;
3e. the bfs lane: the phase-3c grid again with ``algorithm="bfs"`` (about
   3,000 BFS rounds) against 17,988,002 and phase 3c's per-vertex counts,
   with the intersection kernels' counters read around it and each of its
   stages held against its plain version, exactly, and timed as in phase 4;
   bfs forced on every non-tiny analogue, one at a time, against scipy and
   the intersection lane's per-vertex counts (orkut-like and soclj-like
   give K2 a (262144, 8192) bucket of 17 GiB, held against its plain
   version and timed there beside both bounds, the plain version and the
   yardstick);
3m. the measured ``algorithm="auto"`` chooser: the six Table-1 analogues,
   ``complete_graph(512)`` and ``rmat_graph(14, 16, seed=1)``, each kept
   only if its widest bfs bucket (reckoned from its levels on the card,
   nothing gathered) takes at most half the free memory; every lane
   timed on each (``calibrate``, iters 3, warmup 1) and priced
   (``analytic_seed``, the H100 bound of ``launch.roofline``); a line per
   graph with its bin, the heuristic and measured picks, each lane's ms
   and the analytic ranking; the measured pick timed again within
   2·t_best + 200 µs; the table through a ``CALIB_*.json`` sidecar under
   ``build/`` and back with the same choices; ``CountOptions(chooser=
   "measured")`` on each graph against its oracle on the table's lane;
3n. ``TriangleService`` on the card: phase 3j's pool warmed up, 512 count
   requests from 4 tenants in bursts of 1, 3, 8 and 64 against phase 3j's
   scipy truths, no cache miss after ``warmup()``, no errored request;
   requests/s, p50/p90/p99 latency, the coalesce factor and dispatches
   beside the per-request ``TriangleCounter(g).count()`` loop and
   ``count_many``; one 64-request burst under ``torch.profiler``; the
   largest stacked batch of another held against the plain versions
   (``serve_path``);
   R-MAT scale 18 through a subgraph-lane service (count twice, the
   second a session-cache hit; vertex; edge_support; ``k_truss(128)``)
   against phases 2 and 3k; 8 update batches of phase 3l's stream, each
   against a ``recount()``; load shedding at depth 4 with a 1 ms deadline;
3o. the sharded lanes: (a) on a world-1 NCCL group (``make_mesh((1,),
   ("data",))``), ``TriangleCounter(rmat_graph(18, 16, seed=1),
   algorithm="intersection_distributed", mesh=mesh)`` against 82,629,122
   and the single-card lane (warm ``count()`` medians printed side by
   side, the single-card lane timed before and after), ``TriangleCounter(g,
   algorithm="edge", mesh=mesh)``'s ``edge_support()`` and
   ``k_truss(128)`` against phase 3k's scipy oracles, coauthors-like with ``strategy="bitmap"`` against scipy and
   ``algorithm="matrix_distributed"`` on orkut-like against 13,038,569 and
   the single-card matrix lane; every sharded stage held against its plain
   version (``sharded_path``); (b) P = 4 gloo ranks spawned on ``cuda:0``
   (scale 17 when four prep peaks, reckoned from (a)'s, fit in free
   memory, else scale 16): on every rank the sharded count and edge
   support against the scipy oracles, coauthors-like forced to bitmap and
   orkut-like through ``matrix_distributed``, with the rank's
   ``shard_work``, resident bucket bytes (beside the single-card plan's
   / P), peak memory and K1–K4 counters; a rank that fails fails the
   script;
3f. serving: gemma2-2b at its published width and depth (26 layers, bf16
   weights drawn from seed 0), batch 2, a 6144-token prompt (past the
   4096 window of the local layers) and 16 greedy tokens through
   ``greedy_generate``, with the flash kernel's counter read around it
   (26 launches, one a layer); prefill seconds, decode ms per token and
   tokens per second (medians of 3 after a warm-up) and the own peak; the
   same prefill and decode rerun with the chunked plain attention,
   teacher-forced on the kernel path's tokens: the last-position logits of
   the prefill and of every decode step held within a stated tolerance,
   and the greedy tokens equal wherever the plain path's top-2 margin
   exceeds 10× the largest logit difference; beside it the plain path
   against itself with 512-key chunks (the bf16 model's rounding floor);
   ``torch.profiler`` over one prefill and one decode step (device time by
   kernel, idle share); and the prefill again with fp32 weights, the
   kernel's logits and KV caches held against the plain path's to 1e-3;
4c. the flash kernel against its plain version at the serving path's two
   layer shapes (2, 6144, 8/4, 256) bf16 with cap 50 (window 4096 and
   global; the tensor-core kernel) and at the qwen1.5-4b and minicpm-2b
   head shapes, ragged (1, 1000, 20/20, 128) and (1, 777, 36/36, 64) fp32
   (the CUDA-core kernel), each within ``flash_within_tolerance`` and the
   bf16 ones also row by row within ``ROW_RMS_BOUND`` (``flash_row_rms``),
   with two planted controls at the global layer's inputs (the plain
   arithmetic with its weights rounded to 8 significant bits must pass
   the row check, to 4 bits fail it in the late rows), timed
   beside its bound (achieved TFLOP/s and the bound's share printed) and
   the plain version's time, per prefill beside the time before the
   tensor-core redesign; the build's registers and spills of the twelve
   16-bit instances (six with the prefix mask; none may spill) and the
   HGMMA instructions in the library's SASS (there must be some);
   the library call at the two layer shapes, ``torch.compile`` of
   ``flex_attention`` with the softcap as its ``score_mod``, the causal and
   window mask as its ``block_mask`` and ``enable_gqa=True`` (the same
   function; the port never calls it), held against the plain version and
   timed; both held again where the softcap binds (queries scaled by 8);
   and, as a labelled yardstick, the kernel without a softcap beside
   ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``;
   then K6 with the VLM's bidirectional prefix: paligemma-3b's layer
   shape (2, 512, 8/1, 256) bf16 with P = 256 (timed beside its bound and
   ``flex_attention`` with the prefix in its ``mask_mod``, which must
   differ from the attention without it), ragged fp32 and fp16 cases with
   P off the tiles, P = S and P > S (every key visible) and a window
   beside the prefix, each within ``flash_within_tolerance`` and, 16-bit,
   ``flash_row_rms``; and every layer shape of 3p, 3q, 3s and 3u in bf16,
   each held and timed as above beside a library call: qwen1.5-32b
   (2, 512, 40/40, 128), arctic-480b (2, 256, 56/8, 128), dbrx-132b
   (2, 256, 48/8, 128), whisper-medium's encoder (4, 1500, 16/16, 64, not
   causal), causal self-attention (4, 64), cross-attention (4, 64 against
   1500 keys, not causal) and decode cross-attention (4, 1 against 1500),
   these seven beside ``scaled_dot_product_attention`` (no window or
   softcap: the same function), and recurrentgemma-9b's local attention
   (2, 4096, 16/1, 256, window 2048) beside ``flex_attention``; each
   16-bit call's launch plan (rows a block, keys a tile, parts), and at
   whisper's self and decode cross-attention and its decode step at batch
   1 (keys split, merged by the second kernel) K6's kernel time from
   ``torch.profiler`` beside its event time and the wrapper's host time;
3p. the int8 KV cache: qwen1.5-32b at its published width, 8 of its 64
   layers (``INT8_LAYERS``, for the script's time; MHA 40/40, bf16
   weights from seed 0, its config's ``kv_cache_dtype="int8"``),
   batch 2, a 512-token prompt and 16 greedy tokens with K6's counter read
   around them (8 launches); the peak
   reckoned before the run and measured after it (under 79 GiB); prefill
   seconds, decode ms per token, ``torch.profiler`` over one of each;
   ``quantize_kv`` of layer 0's k and v on the card against the CPU's and
   the prefill's cache, bit for bit; teacher-forced against the chunked
   plain attention (and the plain path against itself with 128-key
   chunks), every quantisation of those runs within one step of its bf16
   value;
3q. MoE: arctic-480b (2 of 35 layers; 128 experts, top-2, dense residual)
   and dbrx-132b (8 of 40 layers; 16 experts, top-4) at their published
   widths, batch 2, a 256-token prompt (capacity 5 and 80) and 8 greedy
   tokens with K6's counter read (2 and 8 launches), the weights drawn in
   place a few experts at a time; one full-width ``moe`` layer against the
   reference's formula written out in fp32 einsums on the same weights
   (the same experts and kept slots, each row within 2⁻⁵ relative RMS, the
   aux loss), both timed;
3r. the VLM: paligemma-3b at its published width and depth (18 layers,
   MQA 8/1 at head_dim 256), batch 2, 256 patch tokens of width 1152 from
   seed 2 as a bidirectional prefix, a 256-token prompt and 16 greedy
   tokens: 18 K6 launches a prefill, each with ``prefix_len = 256``;
   teacher-forced against the chunked plain attention; the prefill again
   with fp32 weights, kernel and plain logits and caches within 1e-3;
3s. encdec: whisper-medium at its published width (``WhisperModel``; 4 +
   4 of its 24 + 24 layers, ``SERVE_CUTS``, for the script's time; d 1024,
   16 heads of 64, 1500 frames), batch 4, frames (4, 1500, 1024) from seed
   2, a 64-token prompt and 32 greedy tokens: 12 K6 launches a prefill (4
   encoder, 4 causal self, 4 cross-attention, the last two S = 64 against
   T = 64 and 1500) and 4 a decode step (the one-query cross-attention);
3t. ssm: mamba2-780m (``MambaLM``; 8 of its 48 layers, d 1536, 48 SSM
   heads of 64, state 128, chunk 256), batch 2, a 4096-token prompt (16
   chunks) and 32 greedy tokens: no kernel (the reference has none for the
   family);
3u. hybrid: recurrentgemma-9b (``GriffinLM``; 8 of its 38 layers: 6
   RG-LRU and 2 local attention, d 4096, MQA 16/1 at head dim 256, window
   2048, vocab 256,000), batch 2, a 4096-token prompt (the window cuts in
   prefill, the ring wraps in decode) and 16 greedy tokens: 2 K6 launches
   a prefill;
   each of 3s–3u with bf16 weights from seed 0, its peak reckoned before
   the run and held to the reckoning after it, prefill seconds, decode ms
   a token and ``torch.profiler`` over one of each; 3s and 3u
   teacher-forced against the chunked plain attention (every K6 call of
   the kernel run within K6's contract on its own inputs; the logits
   within twice the larger of the plain path's 128-key-chunk floor and its
   floor with K6's rounding of the softmax weights); each then with fp32
   weights, ``decode_step`` after ``prefill(S - 1)`` against
   ``prefill(S)``'s last logits within 1e-3;
4d. K6's gradient: at each K6 shape of the training paths, bf16 —
   gemma2-2b's local and global microbatch (1, 2048, 8/4, 256) with cap
   50 (window 4096), paligemma-3b's layer (1, 512, 8/1, 256) with prefix
   256, whisper-medium's encoder (1, 1500, 16/16, 64, not causal), causal
   self (1, 64) and cross (1, 64 against 1500), recurrentgemma-9b's local
   layer (1, 4096, 16/1, 256, window 2048) — ``attention(backend=
   "kernel")`` on inputs that require grad runs K6 once through
   ``FlashAttention`` (its output within K6's contract), and dq, dk, dv
   equal autograd through the chunked scan within 1e-5 of their largest
   value; a planted fault (the softcap's derivative left out) must read
   above that; the backward and forward + backward timed beside their
   bounds, the chunked path, ``torch.compile(flex_attention)`` forward +
   backward with the softcap (gemma2-2b's global layer, static shapes) and
   SDPA forward + backward elsewhere (the mask as ``attn_mask``), and the
   backward's own peak beside 4·B·S·T·Hq·4 bytes;
3v. training: gemma2-2b at its published width, 6 of its 26 layers
   (bf16 weights from seed 0, bf16 moments, fp32 accumulators, remat),
   batch 8 × 2048 from ``SyntheticDataset`` in 8 microbatches, 4 steps
   through ``ElasticTrainer`` with a checkpoint after step 2: every loss
   finite, every leaf's gradient finite with a norm above 0, 96 K6
   launches a step, step seconds (median of steps 1–3), tokens/s, the
   model-FLOP rate against 989 TFLOP/s, the own peak within 1.1× its
   reckoning; then a fresh model resumes from the checkpoint (params and
   moments bit-equal to the saved ones, its step-3 loss within 1e-3 of
   the uninterrupted one), that step run under ``torch.profiler`` (idle
   share);
3w. one training step each, K6 against the chunked attention (and the
   chunked attention in 128-key chunks, the floor), bf16, published
   widths with cut depths: whisper-medium 2 + 2 layers (batch 2, 1500
   frames, 64 tokens), paligemma-3b 2 layers (batch 2, 256 patches, 256
   tokens), recurrentgemma-9b one block group (1 × 4096): the loss and the
   global grad norm within twice the floor, K6's launches counted;
3x. sharded training over a ``DeviceMesh``: (a) gemma2-2b as 3v trains
   it, one step on a (1, 1) mesh of a world-1 NCCL group
   (``make_local_mesh``, ``shard_model_``, ``activation_mesh``), its loss
   and grad norm within 1e-3 of 3v's step 0, 96 K6 launches; (b) 4 gloo
   ranks spawned on ``cuda:0``, one step of gemma2-2b (2 layers) on (2, 2)
   and (1, 4) meshes and of qwen1.5-32b (2 layers, FSDP) on (2, 2), at
   published widths in bf16, held to rank 0's one-process step on the
   card (loss, grad norm, every leaf's first moment, which is its
   gradient, and every parameter), each rank's resident weights and
   moments equal to the reckoning from the specs, its peak within 1.1×
   its reckoning, K6 on its own heads (2 launches a layer, each call
   within K6's contract on its own inputs); ``ef_psum`` over
   the 4 ranks at one gemma2-2b layer's gradient sizes against the true
   sum and ``compress_decompress`` of the summed inputs; (c) each model
   rank's local-head K6 call of gemma2-2b's layer against the unsharded
   call's heads, within K6's contract;
3y. sharded serving and the dry run held to the card: (a) gemma2-2b as
   3v cuts it, served on a (1, 1) mesh of a world-1 NCCL group (prefill
   and 16 greedy tokens, batch 2 × 1024), logits and tokens bit-equal to
   one-card serving, K6 launches equal; (b) 4 gloo ranks spawned on
   ``cuda:0``, 2 layers at published widths in bf16: gemma2-2b on (2, 2)
   (kv heads split), paligemma-3b on (1, 4) (its cache split by
   sequence, the decode's partial softmaxes merged), qwen1.5-32b on (1, 4)
   (int8 cache, heads split), each a prefill of 1024 positions and 2
   teacher-forced decode steps; each rank's teacher-forced last-position
   logits within 3f's, 3r's and 3p's limits of rank 0's one-process
   serve, its resident weights and cache equal to the reckoning from the
   specs, each K6 call within K6's contract on its own inputs, its K6
   launches counted; (c) the dry run (``launch.dryrun.trace_step`` on a
   fake 4-rank group, one subprocess a rank, run beside (b)) against (b):
   each rank's measured prefill peak within 1.1× the predicted + 256 MiB
   and the predicted within 1.1× the measured, its predicted K6 calls =
   its launches, its roofline bound <= its measured prefill seconds; then
   ``lower_tc`` on a fake 256-rank group and one rank's share (32 tiles of
   128) launched through K4 on the card, its time beside the priced bound;
4e. K2's form on the forward CSR at the probe buckets of the graph500-s19
   benchmark cell's graph (``tcbench``'s generator, seed 2300000306):
   exactly equal to its plain version and to the padded K2 on the same
   buckets, each timed (CUDA events, L2 flushed) beside two bounds, the
   needed rows read once and the graph read once; ``python3 chip_smoke.py
   k2csr`` runs this phase alone (about a minute of command time);
5. a ``{"lm_without_kernels": [...]}`` line (3t's run), a
   ``{"kernels": [...]}`` line, the card's name and power limit from
   nvidia-smi, and a last line ``{"ok": true, "device": {...}}``.

The phases run in the order 1, 2, 3, 3b, 3c, 4, 3d, 4b, 3k, 3l, 3g–3j,
3e, 3m, 3n, 3o, 3f, 4c, 3p, 3q, 3r, 3s, 3t, 3u, 4d, 3v, 3w, 3x, 3y, 4e, 5
(each of 3p–3y frees its model before the next): phase 4 needs the
earlier lanes' plans (about 40 GiB), so
the new lanes wait until it has released them (phase 4b holds the hash
paths' stages and releases them before the edge and dynamic lanes, and the
tiled phases free their pinned host memory before the next), and the
serving slice runs once every graph plan is gone. The kernels line's K1–K4
entries carry the tiled, batch, recount and served shapes under
``tiled_path``, ``batch_path``, ``recount_path``, ``serve_path`` and
``sharded_path`` (with each gloo rank's launches), K1–K5 the
chooser's launches under ``chooser_path``, and K6 its launches on the
int8, MoE, VLM, encdec and hybrid serving paths under ``serve_paths``
(their runs under ``lm_serving``), its prefix shapes under
``prefix_shapes``, whisper's and the hybrid's layer shapes under
``encdec_shapes`` and ``hybrid_shapes``, and its launches a training step
of 3v and 3w under ``train_paths`` (4d's gradient checks and timings and
both phases' runs under ``training``), and its launches a rank a step on
3x's meshes under ``sharded_train_paths`` (3x's runs under
``sharded_training``), its launches a rank's prefill on 3y's meshes under
``sharded_serve_paths`` (3y's dry-run rows under ``sharded_serving``),
and K4's launch of the paper core's dry-run share under ``dryrun_tc``.

Any failed check raises, so the script exits non-zero and prints no last
line. Without a CUDA device, or outside a checkout, it exits 2 at once.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

EXPECTED_SCALE18 = 82_629_122
EXPECTED_SCALE17 = 36_128_651
# the forward scipy oracle of rmat_graph(19, 16, seed=1) (31 s of host time
# a run, which phase 3h spends on scale 20 only)
EXPECTED_SCALE19 = 187_666_186
EXPECTED_ORKUT = 13_038_569
EXPECTED_K512 = math.comb(512, 3)  # 22,238,720
GRID_SIDE = 3000
# the device budget of phases 3g and 3i, and of phase 3h by scale
TILE_BUDGET = 1 << 30
BEYOND_BUDGET = {20: 8 << 30, 19: 4 << 30}
HASH_HOST_PREP = ("coauthors-like", "citpatents-like")  # also host-prepped
# the hash lane's own peak at scale 17 with the dense (131072, 512, 64)
# table (NVIDIA H100 80GB HBM3, 700.00 W, PR 13): the compact lane must stay
# below it
PR13_HASH_PEAK_GIB = 23.44
# phase 3k's k-truss of R-MAT scale 18: non-empty, peeled in more than one
# round, and small enough after its first round that the scipy peel which
# checks it takes seconds (a smaller k peels more rounds over a larger
# graph, each a scipy support of it)
K_TRUSS = 128
EXPECTED_GRID = 2 * (GRID_SIDE - 1) ** 2  # two triangles per unit square
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
ALU_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate, NVIDIA data sheet
# H100 SXM dense bf16 tensor-core rate, NVIDIA data sheet: 0/1 tiles are
# exact in bf16, so the masked SpGEMM's least time counts its operations there
TENSOR_OPS_PER_S = 989e12
ALU_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores, data sheet
SERVE_ARCH = "gemma2-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 2, 6144, 16
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_STEPS + 1  # as examples/serve_lm.py
# the kernel path's last-position logits against the plain path's: both
# run the same bf16 model and differ only where an attention output rounds
# to the neighbouring bf16 value. The plain path against itself with
# 512-key chunks differs by 0.083 (H100 80GB HBM3, 700 W), so 0.17 is about
# twice that floor, and under a fifth of the plain path's smallest top-2
# margin (0.90): it rules out gross faults only; the tight in-model check
# is the fp32 prefill below
SERVE_LOGIT_TOL = 0.17
# the same prefill with fp32 weights: 26 layers of fp32 sums in another
# order, logits and caches of order 1
SERVE_FP32_TOL = 1e-3
# K6 a gemma2-2b prefill before its tensor-core redesign, when the CUDA-core
# kernel took every input type (an earlier run, NVIDIA H100 80GB HBM3 at
# 700.00 W); printed beside the new time, and in no record of this run
K6_EARLIER_MS = 328.678
MARGIN_FACTOR = 10.0
# phases 3p–3r: the rest of TransformerLM at published widths on one card
INT8_ARCH = "qwen1.5-32b"  # 64 layers, its config's int8 KV cache
# cut to 8 of its 64 layers (16 until a whole run took 1232.5 s of its 1200
# s on a slower host, NVIDIA H100 80GB HBM3 at 700.00 W): the script's time
INT8_LAYERS = 8
INT8_BATCH, INT8_PROMPT, INT8_STEPS = 2, 512, 16
# arctic-480b and dbrx-132b at their published widths, cut in depth to fit
# one 80 GB card: (arch, layers kept); 25.35 GiB a layer of arctic's and
# 6.07 GiB of dbrx's in bf16
MOE_RUNS = (("arctic-480b", 2), ("dbrx-132b", 8))
MOE_BATCH, MOE_PROMPT, MOE_STEPS = 2, 256, 8
VLM_ARCH = "paligemma-3b"  # 18 layers, MQA 8/1 at head_dim 256
VLM_BATCH, VLM_PATCHES, VLM_PROMPT, VLM_STEPS = 2, 256, 256, 16
DEVICE_PEAK_LIMIT = 79 * 2**30  # a serving run's reckoned and measured peak
# a full-width moe layer in bf16 against the plain formula in fp32 on the
# same weights and input: the port rounds the expert products, the gated
# activation, the expert outputs, the gates and the sums to bf16 (2^-9
# relative each); a wrong expert or slot errs by the row's own size
MOE_ROW_RMS_TOL = 2.0 ** -5
# the kernel path's last-position logits against the plain path's,
# teacher-forced (as SERVE_LOGIT_TOL in 3f): about twice the plain path's
# own difference with 128-key chunks, which phases 3p and 3r print (0.151
# for qwen1.5-32b, where int8 quantisation flips carry it through 64
# layers, and 0.094 for paligemma-3b; NVIDIA H100 80GB HBM3, 700 W)
INT8_LOGIT_TOL = 0.35
VLM_LOGIT_TOL = 0.2
# arctic-480b and dbrx-132b (3q), whisper-medium (3s) and
# recurrentgemma-9b (3u), teacher-forced as above: the limit is this
# factor times the larger of two floors measured in the same run, the
# plain path against itself with 128-key chunks and the plain path with
# K6's bf16 rounding of the softmax weights against the plain path (in two
# layers the second dominates: arctic-480b's kernel path differed by 2.09x
# the first alone; NVIDIA H100 80GB HBM3, 700 W)
FLOOR_FACTOR = 2.0
# phases 3s–3u: the encdec, ssm and hybrid families at their published
# widths and depths, each with its own model class
ENCDEC_ARCH = "whisper-medium"  # 24 + 24 layers, d 1024, 16 heads of 64
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_STEPS = 4, 64, 32
SSM_ARCH = "mamba2-780m"  # 48 layers, d 1536, 48 SSM heads of 64, state 128
SSM_BATCH, SSM_PROMPT, SSM_STEPS = 2, 4096, 32  # 16 chunks of 256
HYBRID_ARCH = "recurrentgemma-9b"  # 38 layers, 12 local attention, MQA 16/1
# 3s-3u cut in depth for the script's time (a full run took 1119.6 s of its
# 1200 s on one card with 8 + 8, 16 and 14 layers, and 1232.5 s on a slower
# host): whisper-medium 4 + 4 of 24 + 24 layers, mamba2-780m 8 of 48,
# recurrentgemma-9b 8 of 38 (2 block groups and the 2 recurrent blocks of
# its remainder, 2 local-attention blocks)
SERVE_CUTS = {"whisper-medium": dict(encoder_layers=4, num_layers=4),
              "mamba2-780m": dict(num_layers=8),
              "recurrentgemma-9b": dict(num_layers=8)}
# twice the 2048 window: the window cuts in prefill and the ring wraps in
# decode
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_STEPS = 2, 4096, 16
# a run's measured own peak against the peak reckoned before it: the
# reckoning leaves out the allocator's rounding and short-lived temporaries
PEAK_RECKON_SLACK = 1.10
KERNELS = {
    "broadcast": dict(
        name="intersect_broadcast", plain="intersect_counts_broadcast",
        replaces="src/repro/kernels/intersect/intersect.py:41"),
    "probe": dict(
        name="intersect_probe", plain="intersect_counts_probe",
        replaces="src/repro/kernels/intersect/probe.py:61"),
    # K2's second form: the same function read from the forward CSR
    "probe_csr": dict(
        name="intersect_probe_csr", plain="intersect_counts_probe_csr",
        replaces="src/repro/kernels/intersect/probe.py:61"),
    "bitmap": dict(
        name="intersect_bitmap", plain="intersect_counts_bitmap",
        replaces="src/repro/kernels/intersect/bitmap.py:126"),
}


T_START = time.perf_counter()


def phase(title: str) -> None:
    print(f"== [{time.perf_counter() - T_START:7.1f} s, "
          f"{time.strftime('%H:%M:%S')}] {title}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}", flush=True)


def load_test_module(name: str):
    """A case module of ``tests/`` (``probe_rows``: K2's row families;
    ``hash_rows``: K5's cases), loaded by file path so that ``tests/``
    never shadows a module on ``sys.path``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(e: int, w: int) -> tuple:
    """Least time for one (E, W) bucket: read u and v once, write the
    counts; the compare work of a merge (2·W steps a row) against the
    card's 32-bit ALU rate. Returns (ms, "bytes" | "operations")."""
    t_bytes = (2 * e * w * 4 + 4 * e) / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * e * w) / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_read_bound(torch, u, v) -> dict:
    """K2's least time on these rows: it must read both rows whole where
    their id ranges overlap, and only the four row ends (a 32-byte sector
    each, or both rows if that is less) where ``u[0] > v[W-1]`` or
    ``u[W-1] < v[0]``, and write the counts; against a merge's 2·W compares
    a live row at the card's 32-bit rate. Returns the bound and the rows
    the range test skips."""
    e, w = u.shape
    dead = (u[:, 0] > v[:, -1]) | (u[:, -1] < v[:, 0])
    skipped = int(dead.sum())
    live = e - skipped
    read = live * 2 * w * 4 + skipped * min(2 * w * 4, 4 * 32) + 4 * e
    t_bytes = read / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * live * w / ALU_OPS_PER_S * 1e3
    ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return dict(must_read_ms=ms, must_read_by=by, must_read_bytes=read,
                live_rows=live, skipped_rows=skipped)


def spgemm_bound_ms(t: int, b: int, read_bytes=None) -> tuple:
    """Least time for T masked B×B tile products: read the inputs once and
    write the (T,) float32 partials, against 2·T·B³ operations at the bf16
    tensor-core rate (0/1 values are exact there). The inputs are
    ``read_bytes`` (the gathered form, ``spgemm_read_bytes``) or else the
    three (T, B, B) float32 stacks. Returns (ms, "bytes" | "operations")."""
    if read_bytes is None:
        read_bytes = 3 * t * b * b * 4
    t_bytes = (read_bytes + 4 * t) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * t * b ** 3 / TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spgemm_read_bytes(torch, args) -> int:
    """What K4's gathered form must read: each distinct tile that the
    triples name, once, in the type held (U and A counted together when
    they are one array), the three (T,) int32 indices and the launch
    order."""
    l, u, a, li, ui, ai = args[:6]
    tile = l.shape[1] * l.shape[2] * l.element_size()
    if a is u:
        named = torch.unique(li).numel() + torch.unique(torch.cat([ui, ai])).numel()
    else:
        named = sum(torch.unique(i).numel() for i in (li, ui, ai))
    return named * tile + sum(x.numel() * x.element_size() for x in args[3:])


def hash_read_bound(torch, w_lists, src, row_end, compact, depth: int
                    ) -> dict:
    """K5's least time on one bucket, and PR 13's all-bytes figure beside it.

    Must read: each row's candidates up to its row end, in the 32-byte
    sectors they span; each row's anchor and row end (8 B) and count
    written (4 B); and, once each, the sectors of the offsets and of the
    ids of the chains that this launch's valid probes name; against the
    compares a probe needs (up to its first match, else its chain's
    length) at the card's 32-bit rate.

    All bytes (the bound of the dense kernel, PR 13): the whole (E, W)
    candidate array, anchors and counts, D slots of each distinct chain
    that a missing valid probe names and one of each chain that only hits
    name; against D compares a valid probe."""
    ptr, vals, b = compact
    n = compact.n
    e, w = (int(x) for x in w_lists.shape)
    dev = w_lists.device
    ends = row_end.long().clamp(0, w)
    first = w_lists.data_ptr() % 32 + torch.arange(e, device=dev) * (4 * w)
    cand_sectors = int(torch.where(
        ends > 0, (first + 4 * ends + 31) // 32 - first // 32, 0).sum())
    named, missed = [], []
    probes = compares = 0
    pos = torch.arange(w, device=dev)
    step = max(1, (1 << 24) // max(1, w))
    for s in range(0, e if w and n else 0, step):
        cand = w_lists[s:s + step]
        valid = (cand >= 0) & (cand < n) & (pos < ends[s:s + step, None])
        chain = (src[s:s + step].long().clamp(0, n - 1)[:, None] * b
                 + (cand & (b - 1)).long())[valid]
        x = cand[valid]
        lo = ptr[chain].long()
        length = ptr[chain + 1].long() - lo
        need = length.clone()  # compares: to the first match, else all
        hit = torch.zeros_like(x, dtype=torch.bool)
        for k in range(int(length.max()) if chain.numel() else 0):
            at = (k < length) & ~hit \
                & (vals[torch.where(k < length, lo + k, 0)] == x)
            need = torch.where(at, k + 1, need)
            hit |= at
        probes += int(chain.numel())
        compares += int(need.sum())
        named.append(torch.unique(chain))
        missed.append(torch.unique(chain[~hit]))
    named = torch.unique(torch.cat(named)) if named \
        else src.new_zeros(0).long()
    missed = int(torch.unique(torch.cat(missed)).numel()) if missed else 0
    p0 = ptr.data_ptr() % 32
    off_sectors = int(torch.unique(torch.cat(
        [(p0 + 4 * named) // 32, (p0 + 4 * named + 4) // 32])).numel())
    lo, hi = ptr[named].long(), ptr[named + 1].long()
    v0 = vals.data_ptr() % 32
    s_lo = (v0 + 4 * lo) // 32
    span = torch.where(hi > lo, (v0 + 4 * hi - 1) // 32 - s_lo + 1, 0)
    starts = torch.repeat_interleave(s_lo, span)
    within = torch.arange(starts.numel(), device=dev) \
        - torch.repeat_interleave(torch.cumsum(span, 0) - span, span)
    id_sectors = int(torch.unique(starts + within).numel())
    read = 32 * (cand_sectors + off_sectors + id_sectors) + 12 * e
    t_bytes = read / HBM_BYTES_PER_S * 1e3
    t_ops = compares / ALU_OPS_PER_S * 1e3
    probed = int(named.numel())
    all_bytes = (e * w * 4 + 8 * e + missed * depth * 4
                 + (probed - missed) * 4) / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                must_read_bytes=read, candidate_sectors=cand_sectors,
                offset_sectors=off_sectors, id_sectors=id_sectors,
                compares=compares, valid_probes=probes, chains=probed,
                missed_chains=missed,
                all_bytes_bound_ms=max(all_bytes, probes * depth
                                       / ALU_OPS_PER_S * 1e3),
                rows_skipped=int((ends == 0).sum()))


def hash_ragged(np, rng, e: int, w: int, n: int):
    """A hash-probe case: (n, w) sorted unique neighbour rows below n with
    in-row padding n (for ``build_hash_table``), (E,) anchors in [0, n),
    and (E, W) candidate rows drawn from the same rows (so many probes
    hit) with sentinel n + 1 and a tenth of the rows whole padding (-2)."""
    nbrs = np.full((n, w), n, dtype=np.int32)
    deg = rng.integers(0, w + 1, size=n)
    keys = rng.random((n, n)).argsort(axis=1)[:, :w]
    for r in range(n):
        nbrs[r, :deg[r]] = np.sort(keys[r, :deg[r]])
    src = rng.integers(0, n, size=e).astype(np.int32)
    cand = nbrs[rng.integers(0, n, size=e)].copy()
    cand[cand == n] = n + 1
    cand[e - e // 10:] = -2
    return nbrs, src, cand


def flash_pairs(np, s: int, t: int, causal: bool, window,
                prefix: int = 0) -> int:
    """Unmasked (query, key) pairs of one (batch, q head): query i keeps
    keys j with (not causal or j <= i) and i - j < window, and every key
    j < prefix (the bidirectional prefix); the count the dry run prices
    K6 by (``kernels.flash_attention.flash_pairs``)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_pairs as kept_pairs

    return kept_pairs(s, t, causal=causal, window=window, prefix_len=prefix)


def flash_bound_ms(np, q, k, causal: bool, window, prefix: int = 0) -> dict:
    """Least time for one attention call: read q, k, v once and write the
    output, against 4·hd flops per unmasked pair per q head at the input
    type's peak (bf16 / fp16: the dense tensor-core rate; fp32: the CUDA
    cores' rate). Also the fp32 CUDA-core figure, which this kernel's
    arithmetic runs at."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    pairs = flash_pairs(np, s, t, causal, window, prefix)
    flops = 4 * hd * pairs * b * hq
    rate = ALU_FLOPS_PER_S if q.dtype.itemsize == 4 else TENSOR_OPS_PER_S
    t_ops = flops / rate * 1e3
    t_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                fp32_alu_ms=flops / ALU_FLOPS_PER_S * 1e3, pairs=pairs,
                flops=flops)


def kernel_build_facts(lib: Path, entry_re: str, label) -> list:
    """The registers at launch and spills of each kernel instance whose
    mangled name matches ``entry_re`` (``-Xptxas=-v``, kept beside the
    library), labelled by ``label(match)``."""
    import re

    instances, cur = [], None
    for line in lib.with_suffix(".log").read_text().splitlines():
        hit = re.search(entry_re, line)
        if "Compiling entry" in line:
            cur = None
            if hit:
                cur = dict(instance=label(hit))
                instances.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            cur.update({f"spill_{kind}": int(n) for n, kind in nums})
        elif cur is not None and "Used" in line:
            cur["registers_at_launch"] = int(
                re.search(r"Used (\d+) registers", line)[1])
    return instances


def wgmma_build_facts(lib: Path, entry_re: str, label) -> dict:
    """What the build says about a tensor-core kernel: its instances'
    registers and spills (``kernel_build_facts``) and the HGMMA (wgmma)
    instructions in the library's SASS (``cuobjdump --dump-sass``)."""
    from repro_torch.kernels import _build

    instances = kernel_build_facts(lib, entry_re, label)
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return dict(instances=instances,
                hgmma=sum("HGMMA" in line for line in sass.splitlines()))


def flash_build_facts(lib: Path) -> dict:
    """K6's tensor-core instances, one per 16-bit type, head dim and prefix
    mask (without, with), and the split launch's merge kernel, one per
    16-bit type and head dim; and whether ptxas serialised any wgmma
    (its "Potential Performance Loss" warning)."""
    facts = wgmma_build_facts(
        lib, r"flash_(fwd_wgmma|merge)_kernelI(13__nv_bfloat16|6__half)Li(\d+)E"
             r"(Lb([01])E)?",
        lambda h: f"flash_{h[1]}_kernel<"
                  f"{'bf16' if 'bfloat' in h[2] else 'fp16'}, {h[3]}"
                  + (f", prefix {'true' if h[5] == '1' else 'false'}>"
                     if h[4] else ">"))
    facts["serialized_wgmma_warnings"] = sum(
        "Potential Performance Loss" in line
        for line in lib.with_suffix(".log").read_text().splitlines())
    return facts


def spgemm_build_facts(lib: Path) -> dict:
    """K4's tensor-core instances, one per tile edge in WGMMA_BLOCKS."""
    return wgmma_build_facts(
        lib, r"masked_spgemm_wgmma_kernelILi(\d+)E",
        lambda h: f"masked_spgemm_wgmma_kernel<{h[1]}>")


def row_rms_facts(rows, s: int) -> dict:
    """Median and largest ``flash_row_rms`` over all rows and over the late
    rows (query positions >= S/2, where many keys share each row's weight
    and the elementwise slack is loosest)."""
    late = rows[:, s // 2:]
    return dict(median=float(rows.median()), max=float(rows.max()),
                late_median=float(late.median()), late_max=float(late.max()))


def rounded_weight_attention(torch, q, k, v, window, cap, bits: int,
                             causal: bool = True, prefix: int = 0,
                             straight_through: bool = False):
    """A planted control for phase 4c: the plain version's arithmetic
    (causal, keys below ``prefix`` visible to every query, or with every
    key of a non-causal call without a window) in fp32 with the
    unnormalised softmax weights rounded to ``bits`` significant bits
    before ·v (8: what bf16 rounding does; 4: a fault, 2⁻⁴ relative) and
    the sum of the unrounded ones as divisor. With ``straight_through`` the
    rounding passes the gradient through unchanged (phase 3w's floor: K6's
    forward rounding, the exact gradient)."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd).float()
    x = torch.einsum("bshgd,bthd->bshgt", qg, k.float()) / math.sqrt(hd)
    if cap is not None:
        x = torch.tanh(x / cap) * cap
    d = (torch.arange(s, device=q.device)[:, None]
         - torch.arange(t, device=q.device)[None, :])
    valid = (d >= 0) & (d < (s + t if window is None else window))
    if not causal:
        if window is not None:
            raise ValueError("a non-causal window has no K6 path (R10)")
        valid = torch.ones_like(valid)
    if prefix:
        valid = valid | (torch.arange(t, device=q.device)[None, :] < prefix)
    x = torch.where(valid[None, :, None, None], x, -1e30)
    p = torch.exp(x - x.amax(-1, keepdim=True))
    del x
    mant, ex = torch.frexp(p.detach())
    rounded = torch.ldexp(torch.round(mant * 2 ** bits) / 2 ** bits, ex)
    del mant, ex
    if straight_through:
        rounded = p + (rounded - p).detach()
    out = torch.einsum("bshgt,bthd->bshgd", rounded, v.float()) \
        / p.sum(-1)[..., None]
    return out.reshape(b, s, hq, hd).to(q.dtype)


def flex_library(torch, flex, create_block_mask, q, k, v, window, cap,
                 prefix_len: int = 0, causal: bool = True):
    """The library call for K6: one compiled ``flex_attention`` on the
    (B, H, S, hd) views, the softcap as its ``score_mod`` (flex scales the
    logits by 1/sqrt(hd) before it, as the kernel does), the causal and
    window mask, with the bidirectional prefix, as its ``block_mask`` and
    ``enable_gqa=True`` (q head h reads kv head h // G, as the kernel
    does); a non-causal call without a window or a prefix has no mask. The
    port never calls it. Returns (call, seconds to build the block mask),
    the mask built once as a model would build it once a prefill."""
    def mask(b, h, qi, ki):
        ok = qi >= ki
        ok = ok if window is None else ok & (qi - ki < window)
        return (ok | (ki < prefix_len)) if prefix_len else ok

    def softcap(score, b, h, qi, ki):
        return torch.tanh(score / cap) * cap

    score_mod = None if cap is None else softcap

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block_mask = None
    if causal or window is not None or prefix_len:
        if not causal:
            raise ValueError("a non-causal mask has no K6 path (R10)")
        block_mask = create_block_mask(mask, None, None, q.shape[1],
                                       k.shape[1], device=q.device)
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def call():
        return flex(qt, kt, vt, score_mod=score_mod, block_mask=block_mask,
                    enable_gqa=True).transpose(1, 2)
    return call, mask_s


def spgemm_library(torch, l, u, a):
    """A yardstick on (T, B, B) float32 stacks: one PyTorch expression
    computing the same function (fp32 ``bmm``, TF32 off). The port never
    calls it."""
    return (torch.bmm(l, u) * a).sum((1, 2))


def spgemm_library_gathered(torch, l, u, a, li, ui, ai):
    """The library call on K4's own tiles: gather, ``bmm`` in the tiles'
    type and mask, summed in float32 (a bf16 ``.sum()`` would round every
    partial above 256). The port never calls it."""
    return (torch.bmm(l[li], u[ui]) * a[ai]).sum((1, 2), dtype=torch.float32)


def random_tiles(np, rng, t: int, b: int):
    """Three (T, B, B) float32 0/1 stacks, each tile at a density drawn
    from 0.02–0.5."""
    out = []
    for _ in range(3):
        dens = rng.uniform(0.02, 0.5, size=(t, 1, 1)).astype(np.float32)
        out.append((rng.random((t, b, b), dtype=np.float32) < dens)
                   .astype(np.float32))
    return out


def gathered_tiles(torch, np, rng, t: int, b: int, dev):
    """A ragged case of K4's gathered form: a pool of 16 bf16 0/1 (B, B)
    tiles (density 0.02–0.5; tile 0 all ones, tiles 1–4 a single 1 at
    each corner) passed as L, U and A, random (T,) int32 indices into it
    with repeats, the first five triples (ones, ones, tile k) whose
    partials are B³ and then B at each corner, and the launch order."""
    from repro_torch.kernels.masked_spgemm import launch_order

    pool = (rng.random((16, b, b), dtype=np.float32)
            < rng.uniform(0.02, 0.5, size=(16, 1, 1))).astype(np.float32)
    pool[0] = 1.0
    for k, (i, j) in enumerate(((0, 0), (0, b - 1), (b - 1, 0), (b - 1, b - 1))):
        pool[1 + k] = 0.0
        pool[1 + k, i, j] = 1.0
    idx = [rng.integers(0, 16, size=t).astype(np.int32) for _ in range(3)]
    for k in range(min(t, 5)):
        idx[0][k], idx[1][k], idx[2][k] = 0, 0, k
    blocks = torch.from_numpy(pool).to(dev).bfloat16()
    li, ui, ai = (torch.from_numpy(x).to(dev) for x in idx)
    return (blocks, blocks, blocks, li, ui, ai, launch_order(li, ai))


def two_core_numpy(np, g):
    """The 2-core of ``g`` as a numpy fixed point, independent of the
    port's peel: drop vertices with fewer than two live neighbours until
    nothing changes. Returns (alive, rounds)."""
    src = np.repeat(np.arange(g.n), np.diff(g.row_ptr))
    dst = g.col_idx
    alive = np.ones(g.n, dtype=bool)
    rounds = 0
    while True:
        rounds += 1
        live = alive[src] & alive[dst]
        deg = np.bincount(src[live], minlength=g.n)
        new = alive & (deg >= 2)
        if (new == alive).all():
            return alive, rounds
        alive = new


def peak_memory(torch, held: int) -> str:
    """The peak since the last reset, and the part of it that the earlier
    phases' plans held before this one started."""
    peak = torch.cuda.max_memory_allocated()
    return (f"max_memory_allocated {peak / 2**30:.2f} GiB, of which "
            f"{held / 2**30:.2f} GiB held by earlier phases: this lane's "
            f"peak {(peak - held) / 2**30:.2f} GiB")


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median device time of ``fn`` from CUDA events, after two warm-up
    calls; the L2 cache is flushed (a 64 MiB write) before each call."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def csr_read_bound(torch, row_ptr, col, src, dst, w: int) -> dict:
    """K2's CSR form's least time on the rows (src, dst) of a forward CSR,
    each row cut to its first ``w`` ids: it must read every row that some
    live edge needs once (live: both rows non-empty and their id ranges
    overlap), every endpoint's two row offsets once, the first and last
    id of each other non-empty row once, the endpoints and the counts;
    against one operation an id of a live edge's two rows at the card's
    32-bit rate. The per-row reckoning, each edge's two real rows with no
    reuse between edges, is returned beside it as ``per_row_bytes``: what
    a design that shares no row would read, not a bound."""
    s, d = src.long(), dst.long()
    ls = (row_ptr[s + 1] - row_ptr[s]).clamp(max=w).long()
    ld = (row_ptr[d + 1] - row_ptr[d]).clamp(max=w).long()
    both = (ls > 0) & (ld > 0)
    top = max(int(col.numel()) - 1, 0)

    def ends(x, lens):
        lo = row_ptr[x].long()
        return (col[lo.clamp(max=top)].long(),
                col[(lo + lens - 1).clamp(min=0, max=top)].long())

    first_s, last_s = ends(s, ls)
    first_d, last_d = ends(d, ld)
    live = both & (first_s <= last_d) & (first_d <= last_s)
    needed = torch.unique(torch.cat([s[live], d[live]]))
    seen = torch.unique(torch.cat([s, d]))
    seen_len = (row_ptr[seen + 1] - row_ptr[seen]).clamp(max=w).long()
    needed_ids = int((row_ptr[needed + 1] - row_ptr[needed])
                     .clamp(max=w).sum())
    ends_only = int((seen_len > 0).sum()) - int(needed.numel())
    e = int(src.numel())
    read = (4 * needed_ids + 8 * ends_only
            + 2 * row_ptr.element_size() * int(seen.numel())
            + (src.element_size() + dst.element_size() + 4) * e)
    ops = int(((ls + ld) * live).sum())
    t_bytes = read / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    per_row = int(((ls + ld) * both).sum()) * 4 + 12 * e
    return dict(bound_ms=ms, bound_by=by, needed_bytes=read,
                needed_rows=int(needed.numel()), live_rows=int(live.sum()),
                per_row_bytes=per_row,
                per_row_ms=per_row / HBM_BYTES_PER_S * 1e3,
                src_runs=int((src[1:] != src[:-1]).sum()) + 1 if e else 0,
                distinct_dst=int(torch.unique(dst).numel()))


def csr_case(torch, st, flush) -> dict:
    """Hold one CSR-form probe stage (``CsrProbeLaunch`` on ``(row_ptr,
    col, src, dst)``) against its plain version, exactly, and time both
    (CUDA events, L2 flushed); its bound is ``csr_read_bound``'s. Returns
    the shape's record."""
    from repro_torch.kernels.intersect import (
        intersect_counts_probe_csr, intersect_counts_probe_csr_kernel)

    row_ptr, col, src, dst = st.args
    w, e = int(st.shape_key[1]), int(src.numel())
    k_out = intersect_counts_probe_csr_kernel(row_ptr, col, src, dst, w)
    p_out = intersect_counts_probe_csr(row_ptr, col, src, dst, w)
    torch.cuda.synchronize()
    err = int((k_out.long() - p_out.long()).abs().max()) if e else 0
    check(err == 0, f"probe_csr kernel == plain on {e} rows of "
                    f"{tuple(st.shape_key)}")
    del k_out, p_out
    k_ms = time_ms(torch, lambda: intersect_counts_probe_csr_kernel(
        row_ptr, col, src, dst, w), 7, flush)
    p_ms = time_ms(torch, lambda: intersect_counts_probe_csr(
        row_ptr, col, src, dst, w), 3, flush)
    shape = dict(shape=[e, w], of=list(st.shape_key), ms=k_ms, plain_ms=p_ms,
                 max_abs_err=err,
                 **csr_read_bound(torch, row_ptr, col, src, dst, w))
    print(f"  probe_csr ({e}, {w}) of {tuple(st.shape_key)} "
          f"({shape['src_runs']} src runs, {shape['distinct_dst']} distinct "
          f"dst): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; needed rows "
          f"once {shape['bound_ms']:.4f} ms ({shape['bound_by']}, "
          f"{shape['needed_bytes']} B; kernel at "
          f"{100 * shape['bound_ms'] / k_ms:.2f} % of it); each edge's two "
          f"rows, no reuse, would read {shape['per_row_bytes']} B "
          f"({shape['per_row_ms']:.4f} ms)", flush=True)
    return shape


def csr_stages(stages) -> list:
    """The stages that launch K2's CSR form (``CsrProbeLaunch``)."""
    from repro_torch.core.engine import CsrProbeLaunch

    return [st for st in stages if isinstance(st.executable, CsrProbeLaunch)]


# phase 4e's cell and seed: graph500-s19, as the benchmark makes it
K2CSR_CONFIG = "graph500-s19"
K2CSR_SEED = 2300000306


def probe_csr_phase(torch, np, dev, flush) -> dict:
    """Phase 4e: K2's CSR form at the probe buckets of the graph500-s19
    cell's graph (``tcbench``'s generator and configuration, seed
    ``K2CSR_SEED``), each held against its plain version and timed by
    ``csr_case`` (bound: the needed rows read once); the padded K2 timed
    beside it on the same buckets' padded rows (which that plan keeps for
    ``triangles_per_vertex`` and no longer launches on) and held equal;
    and the graph read once (``tcbench.roofline``) against the buckets'
    total. Returns the phase's numbers."""
    sys.path.insert(0, str(ROOT))
    from tcbench import spec
    from tcbench.roofline import count_bound_bytes

    from repro_torch.core import TriangleCounter
    from repro_torch.graphs import graph_from_arrays
    from repro_torch.kernels.intersect import (
        LAUNCHES, intersect_counts_probe_csr_kernel,
        intersect_counts_probe_kernel, reset_launch_counts)

    phase(f"phase 4e: K2 on the forward CSR at the {K2CSR_CONFIG} cell's "
          f"probe buckets (seed {K2CSR_SEED})")
    cfg = spec.load_config(K2CSR_CONFIG)
    gen = spec.load_named("generators", cfg["generator"])
    n, row_ptr, col_idx = gen.make(cfg["params"], K2CSR_SEED, dev)
    g = graph_from_arrays(n, row_ptr.cpu().numpy(), col_idx.cpu().numpy(),
                          name=K2CSR_CONFIG)
    del row_ptr, col_idx
    tc = TriangleCounter(g)
    want = tc.count().count
    stages = csr_stages(tc.plan.stages)
    reset_launch_counts()
    got = tc.count().count
    launches = dict(LAUNCHES)
    print(f"graph: n={n} m={g.m_undirected}; buckets "
          f"{tc.plan.shape_keys}; launches a count {launches}")
    check(got == want, f"count() = {got} twice")
    check(launches["probe_csr"] == len(stages) >= 1
          and launches["probe"] == 0,
          f"{len(stages)} CSR-form probe launches a count, no padded one")
    graph_ms = count_bound_bytes(n, g.m_undirected) / HBM_BYTES_PER_S * 1e3
    count_ms = time_ms(torch, lambda: tc.count(), 7, flush)
    rows = []
    for st in stages:
        row = csr_case(torch, st, flush)
        row_ptr, col, src, dst = st.args
        u, v = st.rows
        e, w = row["shape"]
        csr = intersect_counts_probe_csr_kernel(row_ptr, col, src, dst, w)
        pad = intersect_counts_probe_kernel(u, v)
        torch.cuda.synchronize()
        check(torch.equal(pad[:e], csr) and not bool(pad[e:].any()),
              f"w{w}: the padded K2 on the bucket's padded rows == the CSR "
              f"form on its {e} real rows")
        del csr, pad
        must = probe_read_bound(torch, u, v)
        pad_ms = time_ms(torch, lambda: intersect_counts_probe_kernel(u, v),
                         7, flush)
        row.update(padded_shape=list(u.shape), padded_ms=pad_ms,
                   padded_must_read_ms=must["must_read_ms"])
        print(f"  w{w}: padded K2 on {tuple(u.shape)} {pad_ms:.4f} ms "
              f"(its must-read {must['must_read_ms']:.4f} ms)", flush=True)
        rows.append(row)
    total = sum(r["ms"] for r in rows)
    padded = sum(r["padded_ms"] for r in rows)
    print(f"  probe buckets: CSR form {total:.4f} ms against padded K2 "
          f"{padded:.4f} ms (x{padded / total:.2f}); needed rows once "
          f"{sum(r['bound_ms'] for r in rows):.4f} ms; the graph read once "
          f"{graph_ms:.4f} ms (CSR form at {100 * graph_ms / total:.3f} % "
          f"of it); count() {count_ms:.4f} ms (events, L2 flushed)",
          flush=True)
    return dict(config=K2CSR_CONFIG, seed=K2CSR_SEED, n=n,
                m_undirected=g.m_undirected, launches=launches,
                graph_bound_ms=graph_ms, count_ms=count_ms, buckets=rows,
                ms=total, padded_ms=padded,
                bound_ms=sum(r["bound_ms"] for r in rows))


def ragged_lists(np, rng, e: int, w: int, id_hi: int, pad_rows: int):
    """(E, W) int32 u/v pairs of sorted unique ids below ``id_hi`` with
    in-row sentinels n = id_hi (u) / n + 1 (v), random row lengths, and
    ``pad_rows`` whole padding rows (-1 / -2) at the end."""
    def side(fill):
        keys = rng.random((e, id_hi)).argsort(axis=1)[:, :w]
        rows = np.sort(keys, axis=1).astype(np.int32)
        deg = rng.integers(0, w + 1, size=e)
        rows[np.arange(w)[None, :] >= deg[:, None]] = fill
        return rows
    u, v = side(id_hi), side(id_hi + 1)
    if pad_rows:
        u[-pad_rows:] = -1
        v[-pad_rows:] = -2
    return u, v


def hash_phase(torch, np, dev, flush, analogues, truths) -> dict:
    """Phases 3d and 4b: the hash lane at scales 17 and 18 (and on the
    analogues), then K5 against its plain version at both paths' shapes,
    on the families of ``tests/hash_rows.py`` and through the dense entry
    point. Returns K5's entry of the ``kernels`` line."""
    from repro_torch.core import TriangleCounter, triangle_count_forward_scipy
    from repro_torch.graphs import load_dataset, rmat_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.hash_tc import LAUNCHES as HASH_LAUNCHES
    from repro_torch.kernels.hash_tc import (CompactHashTable,
                                             build_hash_table,
                                             hash_probe_compact_chunked,
                                             hash_probe_compact_kernel,
                                             hash_probe_counts_chunked,
                                             hash_probe_kernel)
    from repro_torch.kernels.hash_tc import \
        reset_launch_counts as reset_hash_launch_counts

    # -- phase 3d: the hash lane ----------------------------------------------
    def hash_lane(g, expected: int, label: str) -> dict:
        """Count ``g`` through the hash lane six times with K5's counter
        zeroed just before; check the count, the compact table and the
        lane's shapes; return what phase 4b holds and times."""
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_hash_launch_counts()
        tc = TriangleCounter(g, algorithm="hash")
        first = tc.count()
        warm = [tc.count() for _ in range(5)]
        launches = HASH_LAUNCHES["hash_probe"]
        m = first.meta
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        ptr, vals = tc.plan.stages[0].args[3:5]
        dense = g.n * m["hash_num_buckets"] * m["hash_depth"] * 4
        print(f"{label}: compact table chain_ptr {tuple(ptr.shape)}, "
              f"chain_vals {tuple(vals.shape)}, table_bytes "
              f"{m['table_bytes']} ({m['table_bytes'] / 2**30:.4f} GiB; the "
              f"dense (n, B, D) would be {dense / 2**30:.2f} GiB), "
              f"table_width={m['table_width']} hash_num_buckets="
              f"{m['hash_num_buckets']} hash_depth={m['hash_depth']} "
              f"buckets={m['bucket_shapes']} edges/bucket={m['bucket_edges']}")
        warm_s = [r.exec_seconds for r in warm]
        print(f"prep_seconds={first.prep_seconds:.4f} (device prep, compact "
              f"build with its one sync, row ends) first count() "
              f"{first.exec_seconds:.4f} s; warm count() seconds "
              f"{[round(x, 6) for x in warm_s]} (median "
              f"{statistics.median(warm_s):.6f}); {peak_memory(torch, held)}")
        print(f"hash_probe launches over {1 + len(warm)} count(): {launches}")
        check(all(r.count == expected for r in [first] + warm),
              f"count() = {first.count} every time, = {expected}")
        check(all(a.dim() <= 2 for st in tc.plan.stages for a in st.args),
              "the lane holds no dense (n, B, D) table: every stage argument "
              "is 1-d or 2-d")
        check(tuple(ptr.shape) == (g.n * m["hash_num_buckets"] + 1,)
              and m["table_bytes"] == 4 * (ptr.numel() + vals.numel())
              and int(ptr[-1]) == vals.numel(),
              f"chain_ptr (n·B + 1,) = {tuple(ptr.shape)}, table_bytes = "
              f"4 × (offsets + ids)")
        check(launches == 4 * (1 + len(warm)),
              "4 hash_probe launches per count()")
        check(peak < PR13_HASH_PEAK_GIB,
              f"the lane's own peak {peak:.2f} GiB < {PR13_HASH_PEAK_GIB} GiB "
              f"(the dense table's lane at scale 17)")
        return dict(tc=tc, first=first, launches=launches, peak_gib=peak,
                    warm_ms=statistics.median(warm_s) * 1e3,
                    prep_s=first.prep_seconds, meta=m)

    phase("phase 3d: hash lane, TriangleCounter(rmat_graph(17, 16, seed=1), "
          "algorithm='hash')")
    t0 = time.perf_counter()
    g = rmat_graph(17, 16, seed=1)
    oracle = triangle_count_forward_scipy(g)
    print(f"graph: n={g.n} m={g.m_undirected} max_degree={g.max_degree}; "
          f"host generation + forward scipy oracle {time.perf_counter() - t0:.2f} s")
    check(oracle == EXPECTED_SCALE17, f"forward scipy oracle = {oracle}")
    hash17 = hash_lane(g, EXPECTED_SCALE17, "scale 17")
    m = hash17["meta"]
    check(m["hash_depth"] == 64 and m["hash_num_buckets"] == 512
          and m["table_bytes"] == 4 * (131072 * 512 + 1 + 1_864_319),
          f"B = 512, D = 64 (the reference's (131072, 512, 64) table), "
          f"67,108,865 offsets and 1,864,319 ids: {m['table_bytes']} bytes")
    check([sk[:2] for sk in m["bucket_shapes"]]
          == [(16384, 8), (131072, 32), (1048576, 128), (2097152, 512)],
          f"bucket shapes {[sk[:2] for sk in m['bucket_shapes']]}")
    tc = hash17["tc"]
    t0 = time.perf_counter()
    tpv = tc.triangles_per_vertex()
    check(int(tpv.sum()) == 3 * hash17["first"].count and tpv.shape == (g.n,),
          f"triangles_per_vertex().sum() = {int(tpv.sum())} = 3 × count "
          f"(filtered sidecar, {time.perf_counter() - t0:.3f} s)")
    hash_launches = hash17["launches"]
    hash_paths = [("scale-17 path", tc.plan.stages, m)]
    del tc, tpv, hash17["tc"], hash17["first"]

    phase("phase 3d: hash lane at scale 18, TriangleCounter(rmat_graph(18, "
          "16, seed=1), algorithm='hash')")
    g = rmat_graph(18, 16, seed=1)  # phase 2 checked its oracle
    hash18 = hash_lane(g, EXPECTED_SCALE18, "scale 18")
    hash_paths.append(("scale-18 path", hash18["tc"].plan.stages,
                       hash18["meta"]))
    del hash18["tc"], hash18["first"], g
    for name in analogues:
        for prep_backend in ("device", "host") if name in HASH_HOST_PREP \
                else ("device",):
            s = TriangleCounter(load_dataset(name), algorithm="hash",
                                prep_backend=prep_backend)
            c = s.count()
            check(c.count == truths[name],
                  f"{name} hash ({prep_backend} prep) count {c.count} = scipy "
                  f"(table ({c.meta.get('table_width')} → B "
                  f"{c.meta.get('hash_num_buckets')}, D "
                  f"{c.meta.get('hash_depth')}, "
                  f"{c.meta.get('table_bytes')} bytes), warm count "
                  f"{s.count().exec_seconds * 1e3:.3f} ms)")
    del s, c

    # -- phase 4b: the hash-probe kernel against its plain version ------------
    phase("phase 4b: hash-probe kernel against its plain torch version")
    build = kernel_build_facts(_build.build("hash_probe"),
                               r"hash_probe_compact_kernel",
                               lambda h: "hash_probe_compact_kernel")
    for inst in build:
        print(f"  build: {inst}")
    check(len(build) == 1 and build[0].get("spill_stores", 0) == 0
          and build[0].get("spill_loads", 0) == 0,
          "hash_probe_compact_kernel built, no spills")

    def hash_case(label, w_lists, src, row_end, ptr, vals, b, depth):
        """Hold K5 against its plain version, exactly, and time both beside
        the must-read and all-bytes bounds; returns the shape's record."""
        compact = CompactHashTable(ptr, vals, b)
        args = (w_lists, src, row_end, compact)
        k_out = hash_probe_compact_kernel(*args)
        p_out = hash_probe_compact_chunked(*args)
        torch.cuda.synchronize()
        err = int((k_out.long() - p_out.long()).abs().max()) \
            if w_lists.shape[0] else 0
        check(err == 0, f"hash_probe kernel == plain at "
                        f"{tuple(w_lists.shape)} {label}")
        del k_out, p_out
        k_ms = time_ms(torch, lambda: hash_probe_compact_kernel(*args), 7,
                       flush)
        p_ms = time_ms(torch, lambda: hash_probe_compact_chunked(*args), 1,
                       flush)
        bound = hash_read_bound(torch, w_lists, src, row_end, compact, depth)
        print(f"  hash_probe {tuple(w_lists.shape)} {label}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, must-read bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
              f"{bound['must_read_bytes']} bytes: {bound['candidate_sectors']} "
              f"candidate, {bound['offset_sectors']} offset and "
              f"{bound['id_sectors']} id sectors; {bound['compares']} "
              f"compares), all-bytes bound {bound['all_bytes_bound_ms']:.4f} "
              f"ms; {bound['valid_probes']} valid probes in "
              f"{bound['chains']} distinct chains, {bound['missed_chains']} "
              f"with a miss; rows skipped (row end 0) "
              f"{bound['rows_skipped']}", flush=True)
        return dict(shape=list(w_lists.shape), label=label, ms=k_ms,
                    plain_ms=p_ms, max_abs_err=err, **bound)

    entry = dict(name="hash_probe", route="cuda",
                 kernel="hash_probe_compact_kernel",
                 source="src/repro_torch/csrc/hash_probe.cu",
                 replaces="src/repro/kernels/hash_tc/probe.py:91",
                 plain="hash_probe_compact_chunked",
                 path="scale-17 R-MAT hash count()",
                 launches=hash_launches, tolerance=0, max_abs_err=0,
                 ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=None,
                 all_bytes_bound_ms=0.0, library_ms=None, build=build,
                 lane=dict(scale17={k: hash17[k] for k in (
                     "launches", "peak_gib", "warm_ms", "prep_s")},
                     scale18={k: hash18[k] for k in (
                         "launches", "peak_gib", "warm_ms", "prep_s")}),
                 shapes=[], scale18=dict(shapes=[]), ragged=[],
                 dense_entry=[])
    for label, stages, meta in hash_paths:
        recs = entry["shapes"] if label.startswith("scale-17") \
            else entry["scale18"]["shapes"]
        for st in stages:
            recs.append(hash_case(label, *st.args, meta["hash_num_buckets"],
                                  meta["hash_depth"]))
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       recs[-1]["max_abs_err"])
    for k in ("ms", "plain_ms", "bound_ms", "all_bytes_bound_ms"):
        entry[k] = sum(x[k] for x in entry["shapes"])
        entry["scale18"][k] = sum(x[k] for x in entry["scale18"]["shapes"])
    entry["bound_by"] = max(entry["shapes"],
                            key=lambda x: x["bound_ms"])["bound_by"]
    print(f"  K5 over the scale-17 path: {entry['ms']:.4f} ms against its "
          f"must-read bound {entry['bound_ms']:.4f} ms (all bytes "
          f"{entry['all_bytes_bound_ms']:.4f}); scale 18: "
          f"{entry['scale18']['ms']:.4f} ms against "
          f"{entry['scale18']['bound_ms']:.4f} (all bytes "
          f"{entry['scale18']['all_bytes_bound_ms']:.4f})")
    del hash_paths, stages, st
    gc.collect()
    torch.cuda.empty_cache()
    hash_rows = load_test_module("hash_rows")
    for family, e, w, b in hash_rows.CARD_CASES:
        c = hash_rows.case(family, e, w, b, seed=e + w + b)
        for offset in (False, True):
            args = hash_rows.tensors(c, dev, offset=offset)
            reset_hash_launch_counts()
            k_out = hash_probe_compact_kernel(*args)
            p_out = hash_probe_compact_chunked(*args)
            torch.cuda.synchronize()
            err = int((k_out.long() - p_out.long()).abs().max())
            check(err == 0 and HASH_LAUNCHES["hash_probe"] == 1,
                  f"hash_probe family {family} ({e}, {w}) B "
                  f"{args[3].num_buckets}"
                  f"{' offset view' if offset else ''}: kernel == plain")
            entry["ragged"].append(dict(family=family, shape=[e, w],
                                        num_buckets=args[3].num_buckets,
                                        offset=offset, max_abs_err=err))
    rng = np.random.default_rng(13)
    for e in (1, 7, 1000, 4097):
        for w in (1, 8, 33, 512):
            n = max(2 * w, 64)
            nbrs, src_np, cand = hash_ragged(np, rng, e, w, n)
            nbrs_t = torch.from_numpy(nbrs).to(dev)
            w_t = torch.from_numpy(cand).to(dev)
            s_t = torch.from_numpy(src_np).to(dev)
            for nb, d in ((8, 1), (8, 2), (32, 8), (512, 64)):
                table = build_hash_table(nbrs_t, num_buckets=nb, depth=d)
                k_out = hash_probe_kernel(w_t, s_t, table)
                p_out = hash_probe_counts_chunked(w_t, s_t, table)
                torch.cuda.synchronize()
                err = int((k_out.long() - p_out.long()).abs().max())
                check(err == 0, f"dense entry point ({e}, {w}) table "
                                f"({n}, {nb}, {d}): kernel == dense plain")
                entry["dense_entry"].append(dict(shape=[e, w],
                                                 table=[n, nb, d],
                                                 max_abs_err=err))
    entry["max_abs_err"] = max(
        [entry["max_abs_err"]] + [x["max_abs_err"] for x in
                                  entry["ragged"] + entry["dense_entry"]])
    del nbrs_t, w_t, s_t, table, k_out, p_out, args
    gc.collect()
    torch.cuda.empty_cache()
    return entry



def host_memory_gib() -> float:
    """MemTotal of /proc/meminfo, in GiB (0 where the file is missing)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024 / 2**30
    except OSError:
        pass
    return 0.0


def h2d_rate(torch, dev) -> float:
    """Pinned host-to-device copy rate in bytes/s: 1 GiB, CUDA events,
    median of 5 after a warm-up."""
    src = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    dst.copy_(src, non_blocking=True)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    del src, dst
    return (1 << 30) / statistics.median(times)


def release_host_memory(torch) -> None:
    """Free dropped plans and hand PyTorch's cached pinned host blocks back
    to the system (the next phase pins its own)."""
    gc.collect()
    torch.cuda.empty_cache()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def tiled_batch_phase(torch, np, dev, ctx) -> None:
    """Phases 3g-3j: tiled counting over a device budget (scale 18, the
    grid through the subgraph lane, R-MAT scale 20 or 19 beyond the card,
    the matrix lane) and batched ``count_many``; each new chunk and batch
    shape of K1-K4 held against its plain version. Adds ``tiled_path`` /
    ``batch_path`` records to the kernels' entries in ``ctx``."""
    import types

    from repro_torch.core import (GraphBatch, TriangleCounter,
                                  executable_cache_info,
                                  triangle_count_forward_scipy,
                                  triangle_count_scipy)
    from repro_torch.core.engine import _TiledStage
    from repro_torch.graphs import load_dataset, rmat_graph
    from repro_torch.kernels.intersect import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.masked_spgemm import LAUNCHES as MS_LAUNCHES
    from repro_torch.kernels.masked_spgemm import (
        masked_spgemm_gathered, masked_spgemm_gathered_chunked)
    from repro_torch.kernels.masked_spgemm import \
        reset_launch_counts as reset_ms_launch_counts

    entries, intersect_case = ctx["entries"], ctx["intersect_case"]
    flush = ctx["flush"]

    def tiled_stages(tc):
        return [st for st in tc.plan.stages if isinstance(st, _TiledStage)]

    def hold_chunks(st, label):
        """The stage's first and last chunk on the card, each held against
        the plain version exactly (the last carries the tail's padding
        rows, padded at launch as ``run()`` pads them); the first is timed
        as ``intersect_case`` times a path shape. Returns its record."""
        rec = None
        for chunk in (st.chunks[0], st.chunks[-1]):
            u, v = (x.to(dev) for x in chunk)
            short = st.chunk_rows - u.shape[0]
            if short:
                u = torch.cat([u, u.new_full((short, u.shape[1]), -1)])
                v = torch.cat([v, v.new_full((short, v.shape[1]), -2)])
            if rec is None:
                rec = intersect_case(st.strategy, types.SimpleNamespace(
                    args=(u, v), bitmap_bits=st.bitmap_bits))
                rec.update(label=label, of=list(st.shape_key),
                           num_chunks=st.num_chunks)
                continue
            kern, plain = ctx["wrappers"][st.strategy]
            kw = dict(num_bits=st.bitmap_bits) \
                if st.strategy == "bitmap" else {}
            err = int((kern(u, v, **kw).long()
                       - plain(u, v, **kw).long()).abs().max())
            torch.cuda.synchronize()
            check(err == 0, f"{st.strategy} kernel == plain on the last chunk "
                            f"of {label} {st.shape_key}")
        return rec

    def add_path(entry, key, path, launches, shapes, **extra):
        rec = entry.setdefault(key, dict(path=[], launches=0, shapes=[]))
        rec["path"].append(path)
        rec["launches"] += launches
        rec["shapes"] += shapes
        rec.update(extra)
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [x["max_abs_err"] for x in shapes])

    def hold_tiled(tc, label, launches, **extra):
        """Every tiled stage's chunks held and timed, recorded per kernel."""
        by_strategy = {}
        for st in tiled_stages(tc):
            by_strategy.setdefault(st.strategy, []).append(
                hold_chunks(st, label))
        for strategy, shapes in by_strategy.items():
            add_path(entries[strategy], "tiled_path", label,
                     launches[strategy], shapes, **extra)

    # -- phase 3g: the tiled main path ----------------------------------------
    phase("phase 3g: tiled main path, TriangleCounter(rmat_graph(18, 16, "
          "seed=1), max_device_bytes=1 << 30)")
    rate = h2d_rate(torch, dev)
    print(f"pinned host-to-device rate: {rate / 1e9:.2f} GB/s (1 GiB, CUDA "
          f"events, median of 5)")
    g = rmat_graph(18, 16, seed=1)  # phase 2 checked its oracle
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tc = TriangleCounter(g, max_device_bytes=TILE_BUDGET)
    first = tc.count()
    misses = executable_cache_info()["misses"]
    warm = [tc.count() for _ in range(3)]
    replay_misses = executable_cache_info()["misses"] - misses
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    tpv = tc.triangles_per_vertex()
    tpv_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    m = first.meta
    streamed = m["streamed_bytes"]
    bound_s = streamed / rate
    warm_s = statistics.median(r.exec_seconds for r in warm)
    print(f"buckets={m['bucket_shapes']} strategies={first.bucket_strategies} "
          f"tiled_buckets={m['tiled_buckets']} num_chunks={m['num_chunks']}")
    print(f"prep_seconds={first.prep_seconds:.4f} (device prep; the tiled "
          f"buckets gathered chunk by chunk into pinned host memory) first "
          f"count() {first.exec_seconds:.4f} s; warm count() seconds "
          f"{[round(r.exec_seconds, 6) for r in warm]} (median {warm_s:.6f}; "
          f"resident in phase 2 {ctx['main_warm_s']:.6f}); streamed "
          f"{streamed} bytes a count ({streamed / 1e9:.2f} GB): bound "
          f"{bound_s:.6f} s at {rate / 1e9:.2f} GB/s, the warm count at "
          f"{100 * bound_s / warm_s:.1f} % of it; triangles_per_vertex "
          f"{tpv_s:.3f} s; {peak_memory(torch, held)}")
    print(f"launches over {1 + len(warm)} count(): {launches}; cache misses "
          f"over the three warm replays: {replay_misses}")
    check(all(r.count == EXPECTED_SCALE18 == ctx["main_count"]
              for r in [first] + warm),
          f"tiled count() = {first.count} every time, = phase 2's count")
    check(m["tiled_buckets"] == [
        dict(shape=(2097152, 128), chunk_rows=524288, num_chunks=4),
        dict(shape=(4194304, 512), chunk_rows=131072, num_chunks=32)]
        and m["num_chunks"] == 36,
        "(2097152, 128) streams in 4 chunks of 524,288 rows, (4194304, 512) "
        "in 32 of 131,072: 36 chunks")
    check(streamed == (2097152 * 128 + 4194304 * 512) * 8,
          f"{streamed} bytes streamed a count: the tiled buckets' u and v")
    check(bool((tpv == ctx["main_tpv"]).all()),
          "triangles_per_vertex() = phase 2's, bit for bit")
    check(replay_misses == 0, "no cache miss over three warm replays")
    check(launches["probe"] == 36 * (1 + len(warm))
          and launches["broadcast"] == 2 * (1 + len(warm)),
          "36 probe launches (one a chunk) and 2 broadcast launches (the "
          "resident W = 8 and 32 buckets) a count()")
    hold_tiled(tc, "scale-18 tiled count(), max_device_bytes 1 GiB",
               launches, scale18=dict(
                   warm_count_s=warm_s,
                   resident_warm_count_s=ctx["main_warm_s"],
                   streamed_bytes=streamed, h2d_bytes_per_s=rate,
                   bound_s=bound_s, peak_gib=peak,
                   prep_s=first.prep_seconds, tpv_s=tpv_s))
    # the padded K2's main path: a resident device-prepped count launches
    # K2's CSR form, a tiled one the padded K2 on every chunk
    probe = entries["probe"]
    shapes = list(probe["tiled_path"]["shapes"])
    check(bool(shapes), "the padded K2 has shapes on its path (the tiled "
                        "chunks)")
    probe.update(launches=launches["probe"], shapes=shapes,
                 bound_by=max(shapes, key=lambda x: x["bound_ms"])["bound_by"],
                 **{k: sum(x[k] for x in shapes) for k in (
                     "ms", "plain_ms", "bound_ms", "yardstick_ms",
                     "all_bytes_bound_ms")})
    del tc, first, warm, tpv, g
    release_host_memory(torch)

    # the grid through the subgraph lane under the same budget: K1 tiled
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tc = TriangleCounter(ctx["grid"], max_device_bytes=TILE_BUDGET)
    first = tc.count()
    warm = [tc.count() for _ in range(3)]
    launches = dict(LAUNCHES)
    tpv = tc.triangles_per_vertex()
    m = first.meta
    warm_s = statistics.median(r.exec_seconds for r in warm)
    print(f"grid, subgraph lane tiled: tiled_buckets={m['tiled_buckets']} "
          f"buckets={m['bucket_shapes']} prep_seconds="
          f"{first.prep_seconds:.4f}; warm count() median {warm_s:.6f} s, "
          f"streamed {m['streamed_bytes']} bytes (bound "
          f"{m['streamed_bytes'] / rate:.6f} s); launches {launches}; "
          f"{peak_memory(torch, held)}")
    check(first.algorithm == "subgraph"
          and all(r.count == EXPECTED_GRID for r in [first] + warm)
          and bool((tpv == ctx["grid_tpv"]).all()),
          "the grid's tiled subgraph count = 2·2999², per-vertex = phase "
          "3c's")
    check(m["num_chunks"] >= 2 and launches["broadcast"] > 0,
          f"the grid streams {m['num_chunks']} chunks through K1")
    hold_tiled(tc, f"grid_graph({GRID_SIDE}) tiled subgraph count(), "
                   f"max_device_bytes 1 GiB", launches,
               grid=dict(warm_count_s=warm_s,
                         streamed_bytes=m["streamed_bytes"],
                         bound_s=m["streamed_bytes"] / rate))
    del tc, first, warm, tpv
    release_host_memory(torch)

    # -- phase 3h: a graph whose buckets the card cannot hold ---------------
    mem = host_memory_gib()
    # scale 20 pins 80.14 GiB of buckets (84.24 GiB with the resident ones),
    # scale 19 32.06 GiB; the oracle and the graph need a few GiB more
    scale = 20 if mem >= 128 else 19
    budget = BEYOND_BUDGET[scale]
    phase(f"phase 3h: R-MAT scale {scale} tiled, TriangleCounter("
          f"rmat_graph({scale}, 16, seed=1), max_device_bytes={budget >> 30} "
          f"<< 30)")
    print(f"host memory: MemTotal {mem:.1f} GiB; scale 20 would pin 80.14 "
          f"GiB of buckets, so it runs where MemTotal >= 128 GiB: "
          f"{'scale 20' if scale == 20 else 'scale 19 here'}")
    t0 = time.perf_counter()
    g = rmat_graph(scale, 16, seed=1)
    t_gen = time.perf_counter() - t0
    oracle = EXPECTED_SCALE19 if scale == 19 else \
        triangle_count_forward_scipy(g)
    t_oracle = time.perf_counter() - t0 - t_gen
    print(f"graph: n={g.n} m={g.m_undirected} max_degree={g.max_degree}; "
          f"host generation {t_gen:.2f} s, forward scipy oracle "
          f"{t_oracle:.2f} s")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tc = TriangleCounter(g, max_device_bytes=budget)
    first = tc.count()
    warm = [tc.count() for _ in range(2)]
    launches = dict(LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    m = first.meta
    whole = sum((e * (8 * w + 8)) for e, w in m["bucket_shapes"])
    warm_s = statistics.median(r.exec_seconds for r in warm)
    streamed = m["streamed_bytes"]
    print(f"buckets={m['bucket_shapes']} strategies={first.bucket_strategies} "
          f"tiled_buckets={m['tiled_buckets']}; all buckets resident would "
          f"take {whole / 2**30:.2f} GiB")
    print(f"prep_seconds={first.prep_seconds:.4f} first count() "
          f"{first.exec_seconds:.4f} s; warm count() seconds "
          f"{[round(r.exec_seconds, 6) for r in warm]} (median {warm_s:.6f}); "
          f"streamed {streamed} bytes a count ({streamed / 1e9:.2f} GB): "
          f"bound {streamed / rate:.6f} s; launches {launches}; "
          f"{peak_memory(torch, held)}")
    check(all(r.count == oracle for r in [first] + warm),
          f"scale-{scale} tiled count() = {first.count} = the forward scipy "
          f"oracle")
    check(peak * 2**30 < whole / 2,
          f"the session's own peak {peak:.2f} GiB is under half of the "
          f"{whole / 2**30:.2f} GiB the buckets take whole")
    hold_tiled(tc, f"scale-{scale} tiled count(), max_device_bytes "
                   f"{budget >> 30} GiB", launches,
               **{f"scale{scale}": dict(
                   warm_count_s=warm_s, streamed_bytes=streamed,
                   bound_s=streamed / rate, peak_gib=peak,
                   host_memtotal_gib=mem, oracle_s=t_oracle,
                   count=first.count, resident_bytes_needed=whole)})
    del tc, first, warm, g
    release_host_memory(torch)

    # -- phase 3i: the tiled matrix lane ---------------------------------------
    phase("phase 3i: tiled matrix lane, TriangleCounter(orkut-like, "
          "algorithm='matrix', max_device_bytes=1 << 30)")
    g = load_dataset("orkut-like")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_ms_launch_counts()
    tc = TriangleCounter(g, algorithm="matrix",
                           max_device_bytes=TILE_BUDGET)
    first = tc.count()
    warm = [tc.count() for _ in range(3)]
    ms_launches = dict(MS_LAUNCHES)
    m = first.meta
    (st,) = tc.plan.stages
    warm_s = statistics.median(r.exec_seconds for r in warm)
    print(f"tiled_buckets={m['tiled_buckets']} streamed "
          f"{m['streamed_bytes']} bytes a count "
          f"({m['streamed_bytes'] / 2**30:.3f} GiB); prep_seconds="
          f"{first.prep_seconds:.3f} (host schedule "
          f"{m['schedule_seconds']:.3f} s); warm count() seconds "
          f"{[round(r.exec_seconds, 6) for r in warm]} (median {warm_s:.6f}; "
          f"bound {m['streamed_bytes'] / rate:.6f} s); launches "
          f"{ms_launches}; {peak_memory(torch, held)}")
    check(all(r.count == EXPECTED_ORKUT for r in [first] + warm),
          f"tiled matrix count() = {first.count} every time")
    check(m["tiled_buckets"] == [dict(shape=(90025, 128, 128),
                                      chunk_rows=4096, num_chunks=22)],
          "90,025 triples stream in 22 chunks of 4,096")
    check(ms_launches == {"masked_spgemm_wgmma": 22 * (1 + len(warm)),
                          "masked_spgemm": 0},
          "one tensor-core launch a chunk, no float32 launch")
    shapes = []
    for chunk in (st.chunks[0], st.chunks[-1]):
        l, u, li, ui, ai, order = (x.to(dev) for x in chunk)
        k_out = masked_spgemm_gathered(l, u, u, li, ui, ai, order=order)
        p_out = masked_spgemm_gathered_chunked(l, u, u, li, ui, ai)
        torch.cuda.synchronize()
        err = float((k_out - p_out).abs().max())
        t = int(li.shape[0])
        check(err == 0, f"masked_spgemm_wgmma == plain on a ({t}, 128, 128) "
                        f"chunk of {l.shape[0]} + {u.shape[0]} tiles")
        k_ms = time_ms(torch, lambda: masked_spgemm_gathered(
            l, u, u, li, ui, ai, order=order), 7, flush)
        p_ms = time_ms(torch, lambda: masked_spgemm_gathered_chunked(
            l, u, u, li, ui, ai), 3, flush)
        read = spgemm_read_bytes(torch, (l, u, u, li, ui, ai, order))
        b_ms, b_by = spgemm_bound_ms(t, 128, read)
        print(f"  masked_spgemm_wgmma chunk ({t}, 128, 128): kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        shapes.append(dict(shape=[t, 128, 128], ms=k_ms, plain_ms=p_ms,
                           bound_ms=b_ms, bound_by=b_by, read_bytes=read,
                           max_abs_err=err, tiles=[int(l.shape[0]),
                                                   int(u.shape[0])]))
    add_path(ctx["k4"], "tiled_path", "orkut-like tiled matrix count(), "
             "max_device_bytes 1 GiB", ms_launches["masked_spgemm_wgmma"],
             shapes, orkut=dict(warm_count_s=warm_s,
                                streamed_bytes=m["streamed_bytes"],
                                bound_s=m["streamed_bytes"] / rate))
    del tc, first, warm, st, g
    release_host_memory(torch)

    # -- phase 3j: batched count_many --------------------------------------------
    phase("phase 3j: count_many over R-MAT scales 10-14 (seeds 0-63) and the "
          "Table-1 analogues, batch_size=16")
    graphs = [rmat_graph(10 + s % 5, 16, seed=s) for s in range(64)] \
        + [load_dataset(name) for name in ctx["analogues"]]
    truths = [triangle_count_scipy(x) for x in graphs]
    session = TriangleCounter(rmat_graph(9, 16, seed=1000),
                              algorithm="intersection")
    reset_launch_counts()
    t0 = time.perf_counter()
    res = session.count_many(graphs, batch_size=16)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    # only counts are kept from here on: a result holds its batch's stacks
    plans = list({id(r.plan): r.plan for r in res}.values())
    batched = [int(r) for r in res]
    sizes = [p.batch_size for p in plans]
    batchable = all(isinstance(p, GraphBatch) for p in plans)
    want_launches = sum(len(p.specs) if isinstance(p, GraphBatch)
                        else p.num_stages for p in plans)
    first_batch = plans[0]
    del res, plans
    gc.collect()
    misses = executable_cache_info()["misses"]
    t0 = time.perf_counter()
    again = [int(r) for r in session.count_many(graphs, batch_size=16)]
    again_s = time.perf_counter() - t0
    again_misses = executable_cache_info()["misses"] - misses
    t0 = time.perf_counter()
    loop = [TriangleCounter(x, algorithm="intersection").count().count
            for x in graphs]  # each session and its plan dropped at once
    loop_s = time.perf_counter() - t0
    print(f"{len(graphs)} graphs in {len(sizes)} batches ({sizes}); "
          f"count_many {batch_s:.3f} s, again {again_s:.3f} s; the "
          f"per-graph loop {loop_s:.3f} s; launches {launches} (one a width "
          f"a batch: {want_launches}); cache misses on the second pass "
          f"{again_misses}")
    check(batched == again == loop == truths,
          "every batched count = triangle_count_scipy = a per-graph "
          "TriangleCounter(g).count()")
    check(batchable and sum(launches.values()) == want_launches,
          "one intersection launch per width per batch")
    check(again_misses == 0, "the second pass builds no new cache entry")
    # K3 through a batch: bitmap forced on the first 16 R-MAT graphs
    bitmap_batch = GraphBatch.from_graphs(graphs[:16], algorithm="intersection",
                                          strategy="bitmap")
    reset_launch_counts()
    check([int(c) for c in bitmap_batch.counts()] == truths[:16],
          f"forced bitmap batch = scipy ({bitmap_batch.specs})")
    bitmap_launches = dict(LAUNCHES)
    batch_info = dict(graphs=len(graphs), batches=len(sizes),
                      batch_size=16, count_many_s=batch_s,
                      second_pass_s=again_s, loop_s=loop_s)
    for batch, key_launches in ((first_batch, launches),
                                (bitmap_batch, bitmap_launches)):
        by_strategy = {}
        for i, (strat, bits, (e, w)) in enumerate(batch.specs):
            u, v = (a.view(batch.batch_size * e, w)
                    for a in batch.arrays[2 * i:2 * i + 2])
            rec = intersect_case(strat, types.SimpleNamespace(
                args=(u, v), bitmap_bits=bits))
            rec.update(batch_size=batch.batch_size, stack=[
                batch.batch_size, e, w])
            by_strategy.setdefault(strat, []).append(rec)
        for strat, shapes in by_strategy.items():
            label = ("forced bitmap GraphBatch of 16 R-MAT graphs"
                     if batch is bitmap_batch else
                     f"count_many, first batch of 16 of {len(graphs)} graphs")
            add_path(entries[strat], "batch_path", label,
                     key_launches[strat], shapes, batch=batch_info)
    ctx.update(pool=graphs[:64], pool_truths=truths[:64])  # phase 3n's pool
    del first_batch, bitmap_batch, graphs, session
    release_host_memory(torch)


def profile_line(prof: dict, top: int = 6) -> str:
    """A ``device_profile`` result as one line: wall, device busy, idle
    share and the ``top`` kernels by summed time."""
    names = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:top]
    return (f"wall {prof['wall_s']:.4f} s, device busy {prof['busy_s']:.4f} "
            f"s over {prof['kernels']} kernels and copies, idle share "
            f"{prof['idle_share']:.3f}; top: "
            + "; ".join(f"{k[:60]} {v * 1e3:.2f} ms" for k, v in names))


def update_batches(np, graph, rng):
    """Endless batches of 256 edge updates of ``graph`` (phase 3l's
    stream): half deletes of live edges, half inserts of random pairs, two
    repeats and two self-loops each."""
    n1 = graph.n + 1
    lo, hi = graph.edge_list_unique()
    pool = lo.astype(np.int64) * n1 + hi
    alive = np.ones(pool.shape[0], dtype=bool)
    while True:
        pick = rng.choice(np.flatnonzero(alive), 126, replace=False)
        alive[pick] = False
        ins = rng.integers(0, graph.n, size=(126, 2))
        ups = [(int(k // n1), int(k % n1), False) for k in pool[pick]]
        ups += [(int(a), int(c)) for a, c in ins]
        ups += [ups[3], ups[200]]  # repeats
        ups += [(int(v), int(v)) for v in rng.integers(0, graph.n, 2)]
        new = np.minimum(ins[:, 0], ins[:, 1]).astype(np.int64) * n1 \
            + np.maximum(ins[:, 0], ins[:, 1])
        pool = np.concatenate([pool, new[ins[:, 0] != ins[:, 1]]])
        alive = np.concatenate(
            [alive, np.ones(int((ins[:, 0] != ins[:, 1]).sum()), bool)])
        yield ups


def edge_dynamic_phase(torch, np, dev, ctx) -> None:
    """Phases 3k and 3l: the edge lane (edge support, k-truss, forced
    strategies, truss decomposition) and dynamic sessions (a 64-batch
    stream at scale 18, shorter int32-key streams), each against scipy. The
    K1-K3 entries of ``ctx`` gain the full recount's shapes
    (``recount_path``)."""
    import types

    from repro_torch.core import (DynamicTriangleCounter, TriangleCounter,
                                  edge_support_forward_scipy,
                                  executable_cache_info,
                                  k_truss_forward_scipy,
                                  triangle_count_forward_scipy,
                                  truss_decomposition_forward_scipy)
    from repro_torch.graphs import edges_to_csr, load_dataset, rmat_graph
    from repro_torch.kernels.intersect import LAUNCHES, reset_launch_counts

    entries, intersect_case = ctx["entries"], ctx["intersect_case"]

    def same_support(got, want) -> bool:
        return all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got, want))

    # -- phase 3k: the edge lane ----------------------------------------------
    phase("phase 3k: edge lane, TriangleCounter(rmat_graph(18, 16, seed=1), "
          "algorithm='edge')")
    g = rmat_graph(18, 16, seed=1)  # phase 2 checked its count
    t0 = time.perf_counter()
    oracle = edge_support_forward_scipy(g)
    oracle_s = time.perf_counter() - t0
    print(f"edge_support_forward_scipy {oracle_s:.2f} s; max support "
          f"{int(oracle[2].max())}, median {float(np.median(oracle[2]))}")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tc = TriangleCounter(g, algorithm="edge")
    first = tc.count()
    plan = tc.plan
    support_s, count_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        got = tc.edge_support()
        support_s.append(time.perf_counter() - t0)
        count_s.append(tc.count().exec_seconds)
    m = first.meta
    print(f"key_mode={m['key_mode']} mk={int(plan.edge_keys.shape[0])} "
          f"buckets={m['bucket_shapes']} strategies={m['bucket_strategies']} "
          f"edges/bucket={m['bucket_edges']}")
    print(f"prep_seconds={first.prep_seconds:.4f}; first count() "
          f"{first.exec_seconds:.4f} s; warm edge_support() seconds "
          f"{[round(x, 6) for x in support_s]} (median "
          f"{statistics.median(support_s):.6f}); warm count() seconds "
          f"{[round(x, 6) for x in count_s]} (median "
          f"{statistics.median(count_s):.6f}); {peak_memory(torch, held)}")
    check(m["key_mode"] == "wide" and plan.edge_keys.dtype == torch.int64
          and plan.edge_keys.shape[0] == 4_194_304,
          "wide (int64) keys, mk = 4,194,304")
    check(first.count == EXPECTED_SCALE18 and all(
        tc.count().count == EXPECTED_SCALE18 for _ in range(2)),
        f"count() = Σ support / 3 = {first.count}")
    check(same_support(got, oracle),
          "edge_support() = edge_support_forward_scipy, array for array")
    check(int(got[2].sum()) == 3 * EXPECTED_SCALE18,
          f"Σ support = {int(got[2].sum())} = 3 × 82,629,122")
    incident = (np.bincount(got[0], weights=got[2], minlength=g.n)
                + np.bincount(got[1], weights=got[2], minlength=g.n))
    check(bool((incident.astype(np.int64) == 2 * ctx["main_tpv"]).all()),
          "each vertex's incident supports sum to 2·t(v), t from phase 2")
    support_prof = device_profile(torch, tc.edge_support)
    print(f"edge_support() under torch.profiler: {profile_line(support_prof)}")
    edge_info = dict(prep_s=first.prep_seconds,
                     support_s=statistics.median(support_s),
                     count_s=statistics.median(count_s),
                     oracle_s=oracle_s,
                     peak_gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
                     buckets=m["bucket_shapes"],
                     strategies=m["bucket_strategies"],
                     profile={k: v for k, v in support_prof.items()
                              if k != "by_name"})
    del got, incident

    t0 = time.perf_counter()
    truss = tc.k_truss(K_TRUSS)
    truss_s = time.perf_counter() - t0
    rounds = plan.meta["peel_rounds"]
    # the scipy peel's first round is the oracle above
    t0 = time.perf_counter()
    keep = oracle[2] >= K_TRUSS - 2
    if keep.all():
        want, want_rounds = g, 1
    else:
        want, later = k_truss_forward_scipy(
            edges_to_csr(oracle[0][keep], oracle[1][keep], n=g.n), K_TRUSS)
        want_rounds = 1 + later
    scipy_truss_s = time.perf_counter() - t0
    # phase 3n serves the same graph and holds its answers to these
    ctx.update(scale18=g, scale18_support=oracle, scale18_truss=want)
    del oracle, keep
    print(f"k_truss({K_TRUSS}): {truss.m_undirected} edges of "
          f"{g.m_undirected}, {rounds} rounds, converged "
          f"{plan.meta['peel_converged']}, {truss_s:.3f} s; the scipy peel "
          f"{want_rounds} rounds, {scipy_truss_s:.2f} s")
    check(truss.m_undirected > 0 and rounds >= 2,
          f"the {K_TRUSS}-truss is non-empty and the peel ran ≥ 2 rounds")
    check(np.array_equal(truss.row_ptr, want.row_ptr)
          and np.array_equal(truss.col_idx, want.col_idx)
          and rounds == want_rounds,
          f"k_truss({K_TRUSS}) = the scipy peel, in as many rounds")
    edge_info.update(k=K_TRUSS, k_truss_s=truss_s, peel_rounds=rounds,
                     truss_edges=truss.m_undirected)
    del tc, plan, first, truss, want
    gc.collect()
    torch.cuda.empty_cache()

    forced = []
    for name in ctx["analogues"]:
        d = load_dataset(name)
        want = edge_support_forward_scipy(d)
        line = [f"{name}: m={d.m_undirected}"]
        for strategy in ("auto", "broadcast", "probe", "bitmap"):
            s = TriangleCounter(d, algorithm="edge", strategy=strategy)
            got = s.edge_support()
            check(s.plan.key_mode == "int32"
                  and s.plan.edge_keys.dtype == torch.int32
                  and same_support(got, want),
                  f"{name} strategy={strategy}: int32 keys, edge_support() "
                  f"= scipy ({s.plan.meta['bucket_strategies']})")
            t0 = time.perf_counter()
            s.edge_support()
            dt = time.perf_counter() - t0
            line.append(f"{strategy} {dt * 1e3:.2f} ms")
            forced.append(dict(graph=name, strategy=strategy, seconds=dt))
        print("  " + "; ".join(line), flush=True)
    for name in ("coauthors-like", "road-like"):
        d = load_dataset(name)
        t0 = time.perf_counter()
        got = TriangleCounter(d, algorithm="edge").truss_decomposition()
        dec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = truss_decomposition_forward_scipy(d)
        check(same_support(got, want),
              f"{name} truss_decomposition() = scipy (max trussness "
              f"{int(got[2].max())}, {dec_s:.3f} s; scipy "
              f"{time.perf_counter() - t0:.2f} s)")
    edge_info["forced"] = forced

    # -- phase 3l: dynamic sessions -------------------------------------------
    phase("phase 3l: dynamic session, DynamicTriangleCounter(rmat_graph(18, "
          "16, seed=1)), 64 batches of 256 updates")

    def stream(dc, graph, batches, rng, label):
        """``batches`` batches of ``update_batches``. Returns the per-batch
        seconds and the growths seen."""
        seconds, growths = [], []
        batch_of = update_batches(np, graph, rng)
        for b in range(batches):
            ups = next(batch_of)
            before = (dc.plan.cap, dc.plan.bounds)
            t0 = time.perf_counter()
            dc.apply_updates(ups)
            seconds.append(time.perf_counter() - t0)
            after = (dc.plan.cap, dc.plan.bounds)
            if after != before:
                growths.append(dict(batch=b + 1, capacity=after[0],
                                    bounds=list(after[1])))
                print(f"  {label} batch {b + 1}: capacity {before[0]} -> "
                      f"{after[0]}, bounds {before[1]} -> {after[1]}")
        return seconds, growths

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # no periodic recount inside the timed stream: it runs after it
    dc = DynamicTriangleCounter(g, recount_interval=0)
    p = dc.plan
    print(f"key_mode={p.key_mode} capacity={p.cap} bounds={p.bounds} "
          f"update_rows={p.ub} strategies={p.meta['bucket_strategies']} "
          f"prep_seconds={p.prep_seconds:.4f}")
    check(p.key_mode == "wide" and p._keys.dtype == torch.int64
          and p.cap == 4_194_304, "wide (int64) keys, capacity 4,194,304")
    check(dc.count().count == EXPECTED_SCALE18, "the seed's count = 82,629,122")
    rng = np.random.default_rng(0)
    first_s, first_growths = stream(dc, g, 1, rng, "scale 18")
    cache_before = executable_cache_info()["size"]
    seconds, growths = stream(dc, g, 63, rng, "scale 18")
    cache_after = executable_cache_info()["size"]
    growths = first_growths + growths
    batch_ms = statistics.median(seconds) * 1e3
    print(f"batch 1 {first_s[0] * 1e3:.3f} ms; batches 2-64 ms: median "
          f"{batch_ms:.3f}, min {min(seconds) * 1e3:.3f}, max "
          f"{max(seconds) * 1e3:.3f}; {256 / (batch_ms / 1e3):.0f} updates/s "
          f"(256 a batch); inserted {p.inserted}, deleted {p.deleted}, "
          f"recounts {p.recounts}; cache entries {cache_before} -> "
          f"{cache_after}; {peak_memory(torch, held)}")
    stream_prof = device_profile(torch, lambda: stream(
        dc, g, 8, np.random.default_rng(2), "profiled"))
    print(f"8 more batches under torch.profiler: {profile_line(stream_prof)}")
    later = [x for x in growths if x["batch"] > 1]
    check(cache_after == cache_before if not later
          else cache_after - cache_before <= 3 * len(later),
          f"no new cache entry in steady state ({len(later)} class growths "
          f"after batch 1)")
    reset_launch_counts()
    t0 = time.perf_counter()
    full = dc.recount()
    recount_s = time.perf_counter() - t0
    recount_launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    snap = dc.snapshot()
    snap_truth = triangle_count_forward_scipy(snap)
    snap_s = time.perf_counter() - t0
    print(f"recount() {recount_s:.3f} s, launches {recount_launches}; "
          f"snapshot + forward scipy {snap_s:.2f} s; m = {snap.m_undirected}")
    check(full == dc.count().count == snap_truth,
          f"the kept count {full} = recount() = scipy on snapshot()")
    check(sum(recount_launches.values()) > 0,
          "the recount ran the intersection kernels (K1-K3)")
    recount_stages = p.recount_stages()
    reset_launch_counts()
    for st in recount_stages:
        st.run()
    # the recount's resident probe buckets launch K2's CSR form
    on_csr = csr_stages(recount_stages)
    by_kernel = {}
    for st in recount_stages:
        if any(st is x for x in on_csr):
            by_kernel.setdefault("probe_csr", []).append(
                csr_case(torch, st, ctx["flush"]))
            continue
        by_kernel.setdefault(st.strategy, []).append(intersect_case(
            st.strategy, types.SimpleNamespace(args=st.args,
                                               bitmap_bits=st.bitmap_bits)))
    check(len(on_csr) >= 1 and recount_launches["probe_csr"] >= len(on_csr)
          and recount_launches["probe"] == 0,
          "the recount's probe buckets launched K2's CSR form, not the "
          "padded K2")
    for kernel, shapes in by_kernel.items():
        entry = entries[kernel]
        entry["recount_path"] = dict(
            path="DynamicTriangleCounter(rmat_graph(18)) recount() after 64 "
                 "batches", launches=recount_launches[kernel],
            shapes=shapes)
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [x["max_abs_err"] for x in shapes])
    dyn_info = dict(prep_s=p.prep_seconds, batch_ms=batch_ms,
                    profile={k: v for k, v in stream_prof.items()
                             if k != "by_name"},
                    updates_per_s=256 / (batch_ms / 1e3),
                    first_batch_ms=first_s[0] * 1e3, growths=growths,
                    recount_s=recount_s,
                    peak_gib=(torch.cuda.max_memory_allocated() - held) / 2**30)
    del dc, p, recount_stages, on_csr, snap
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("coauthors-like", "road-like"):
        d = load_dataset(name)
        dc = DynamicTriangleCounter(d, recount_interval=0)
        seconds, growths = stream(dc, d, 16, np.random.default_rng(1), name)
        check(dc.plan.key_mode == "int32" and dc.plan._keys.dtype == torch.int32
              and dc.count().count == dc.recount()
              == triangle_count_forward_scipy(dc.snapshot()),
              f"{name}: int32 keys; after 16 batches the kept count "
              f"{dc.count().count} = recount() = scipy (median batch "
              f"{statistics.median(seconds) * 1e3:.3f} ms)")
        dyn_info.setdefault("int32", {})[name] = statistics.median(seconds) * 1e3
        del dc
    print(json.dumps({"lanes": {"edge": edge_info, "dynamic": dyn_info}}))


def bfs_widest_bucket(torch, g, dev) -> tuple:
    """(width, rows, bytes) of the bfs lane's widest bucket of ``g``, with no
    bucket gathered: the BFS levels and the (level, id) orientation on the
    card, the prep's own bucket sort and shape policy, and the prep's byte
    rule (u and v rows, src and dst)."""
    from repro_torch.core.options import DEFAULT_WIDTHS
    from repro_torch.core.prep import _bucket_nbytes
    from repro_torch.graphs.device import (DEFAULT_SHAPE_POLICY, DeviceGraph,
                                           _bfs_levels_dev, _bucket_sort_dev,
                                           next_pow2)

    if g.m_undirected == 0:
        return 0, 0, 0
    dg = DeviceGraph.from_graph(g, DEFAULT_SHAPE_POLICY, device=dev)
    lvl, _ = _bfs_levels_dev(dg.edge_sources(), dg.csr.col_idx,
                             dg.edge_valid(), n=dg.n)
    fwd = dg.level_oriented(lvl)
    bounds = [int(w) for w in DEFAULT_WIDTHS]
    dmax = int(fwd.degrees.max())
    if dmax > bounds[-1]:
        bounds.append(next_pow2(dmax))
    _, _, counts, _ = _bucket_sort_dev(
        fwd.src, fwd.dst, fwd.kvalid, fwd.degrees,
        torch.tensor(bounds, dtype=torch.int32, device=dev), n=dg.n,
        num_bounds=len(bounds))
    w, c = max((w, c) for w, c in zip(bounds, counts.tolist()) if c)
    rows = dg.policy.round_edges(c)
    return w, rows, _bucket_nbytes(rows, w)


def chooser_phase(torch, np, dev, ctx) -> dict:
    """Phase 3m: the measured ``algorithm="auto"`` chooser on the card. Each
    sweep graph's widest bfs bucket is reckoned first (a graph whose
    bucket would take more than half the free device memory is left out
    and named); every lane is timed on every graph (``calibrate``, iters
    3, warmup 1) and priced (``analytic_seed``); the measured pick, timed
    again, must be within 2·t_best + 200 µs of its bin's best lane; the
    table survives a sidecar round trip; ``CountOptions(chooser=
    "measured")`` counts each graph exactly on the table's lane. Returns
    the phase's numbers."""
    import importlib
    import tempfile

    from repro_torch.core import (CountOptions, TriangleCounter,
                                  analytic_seed, calibrate, choose_algorithm,
                                  choose_measured, load_table, save_table,
                                  set_default_table, triangle_count_scipy)
    from repro_torch.graphs import complete_graph, load_dataset, rmat_graph
    from repro_torch.kernels.hash_tc import LAUNCHES as HASH_LAUNCHES
    from repro_torch.kernels.hash_tc import \
        reset_launch_counts as reset_hash_launch_counts
    from repro_torch.kernels.intersect import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.masked_spgemm import LAUNCHES as MS_LAUNCHES
    from repro_torch.kernels.masked_spgemm import \
        reset_launch_counts as reset_ms_launch_counts

    cal = importlib.import_module("repro_torch.core.calibrate")
    phase("phase 3m: measured chooser, calibrate() over the Table-1 "
          "analogues, complete_graph(512) and rmat_graph(14, 16, seed=1), "
          "all five lanes")
    free = torch.cuda.mem_get_info()[0]
    candidates = [(name, lambda name=name: load_dataset(name),
                   ctx["truths"][name]) for name in ctx["analogues"]]
    candidates += [("complete_graph(512)", lambda: complete_graph(512),
                    512 * 511 * 510 // 6),
                   ("rmat_graph(14, 16, seed=1)",
                    lambda: rmat_graph(14, 16, seed=1), None)]
    sweep, left_out = [], []
    for label, make, truth in candidates:
        g = make()
        w, rows, nbytes = bfs_widest_bucket(torch, g, dev)
        fits = nbytes <= free // 2
        print(f"  {label}: widest bfs bucket ({rows}, {w}), "
              f"{nbytes / 2**30:.2f} GiB of {free / 2**30:.2f} GiB free: "
              f"{'in the sweep' if fits else 'left out'}")
        if not fits:
            left_out.append(label)
            continue
        sweep.append((label, g, triangle_count_scipy(g) if truth is None
                      else truth))
    print(f"sweep: {len(sweep)} graphs; left out: {left_out or 'none'}")
    check(len(sweep) >= 2, "at least two sweep graphs fit the card")

    reset_launch_counts()
    reset_ms_launch_counts()
    reset_hash_launch_counts()
    table = cal.CalibrationTable(device=cal.device_label(dev))
    rows = []
    t0 = time.perf_counter()
    for label, g, _ in sweep:
        # calibrate() graph by graph, merged by record() as calibrate()
        # merges a sweep, so each graph's own lane times stay visible
        one = calibrate([g], iters=3, warmup=1)
        key = cal.feature_key(cal.graph_features(g))
        table.record(key, one.entries[key], "measured")
        rows.append(dict(graph=label, bin=list(key),
                         lane_ms={k: v * 1e3 for k, v in
                                  one.entries[key].items()}))
    calibrate_s = time.perf_counter() - t0
    launches = dict(LAUNCHES, **MS_LAUNCHES, **HASH_LAUNCHES)
    print(f"calibrate: {calibrate_s:.2f} s over {len(sweep)} graphs x 5 "
          f"lanes (prep, 1 warm-up and 3 timed counts each); launches "
          f"{launches}; table device {table.device!r}")
    check(table.device != "cpu" and launches["broadcast"] > 0
          and launches["probe"] + launches["probe_csr"] > 0
          and launches["hash_probe"] > 0
          and launches["masked_spgemm"] + launches["masked_spgemm_wgmma"] > 0,
          "calibrate ran the lanes' kernels on the card (K1, K2, K4, K5)")

    t0 = time.perf_counter()
    agree = 0
    for row, (label, g, truth) in zip(rows, sweep):
        seed = analytic_seed(g)
        ranking = sorted(seed, key=lambda lane: (seed[lane], lane))
        pick = choose_measured(g, table)
        t_best = min(table.lookup(g).values())
        fresh = cal.measure_lanes(g, [pick], iters=3, warmup=1)[pick]
        agree += ranking[0] == pick
        row.update(heuristic=choose_algorithm(g), measured=pick,
                   analytic_ranking=ranking,
                   analytic_us={k: v * 1e6 for k, v in seed.items()},
                   pick_again_ms=fresh * 1e3, bin_best_ms=t_best * 1e3)
        print(f"  {label}: bin {tuple(row['bin'])}; heuristic "
              f"{row['heuristic']}, measured {pick}; lane ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                  row["lane_ms"].items(), key=lambda kv: kv[1]))
              + f"; analytic ranking {ranking} ("
              + ", ".join(f"{k} {seed[k] * 1e6:.2f} us" for k in ranking)
              + ")", flush=True)
        check(fresh <= 2.0 * t_best + 200e-6,
              f"{label}: the measured pick {pick}, timed again, "
              f"{fresh * 1e3:.4f} ms <= 2 x {t_best * 1e3:.4f} ms + 0.2 ms "
              f"(its bin's best)")
    recheck_s = time.perf_counter() - t0
    differ = sum(r["heuristic"] != r["measured"] for r in rows)
    print(f"measured pick differs from the heuristic's on {differ} of "
          f"{len(rows)} graphs; the analytic seed's top pick equals the "
          f"measured pick on {agree} of {len(rows)} (a finding, not a "
          f"check); pricing and re-timing {recheck_s:.2f} s")

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        path = save_table(table, cal.calib_path(d, table.device))
        back = load_table(path)
    check(back.entries == table.entries and back.sources == table.sources
          and all(back.choose(g) == table.choose(g) for _, g, _ in sweep),
          f"the sidecar {Path(path).name} loads back with the same choices")

    prev = set_default_table(back)
    try:
        for row, (label, g, truth) in zip(rows, sweep):
            tc = TriangleCounter(g, CountOptions(chooser="measured"))
            res = tc.count()
            check(tc.algorithm == res.algorithm == row["measured"]
                  and res.count == truth,
                  f"{label}: CountOptions(chooser='measured') -> "
                  f"{res.algorithm}, count {res.count} = the oracle")
            del tc, res
    finally:
        set_default_table(prev)
    info = dict(graphs=rows, left_out=left_out, calibrate_s=calibrate_s,
                recheck_s=recheck_s, differ_from_heuristic=differ,
                analytic_agrees=agree, launches=launches,
                device=table.device)
    print(json.dumps({"chooser": info}))
    return info


def triangle_service_phase(torch, np, dev, ctx) -> dict:
    """Phase 3n: ``TriangleService`` on the card. Phase 3j's pool is warmed
    up, then 512 count requests from 4 tenants in bursts of 1, 3, 8 and
    64, each against phase 3j's scipy truth, with no new cache entry after
    ``warmup()`` and no errored request; beside them the per-request
    ``TriangleCounter(g).count()`` loop and ``count_many`` on the same
    requests; one 64-request burst under ``torch.profiler``; the stacked
    shapes of another burst's largest batch held against the plain
    versions; R-MAT scale
    18 served singly through one subgraph-lane session (count twice,
    vertex, edge_support, k_truss) against phases 2 and 3k; 8 update
    batches through a dynamic session, each against a ``recount()``; and
    load shedding. Returns the phase's numbers."""
    import types

    import repro_torch.serve.coalescer as coalescer_module
    from repro_torch.core import (CountOptions, DynamicTriangleCounter,
                                  TriangleCounter, executable_cache_info,
                                  graph_fingerprint)
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels.intersect import LAUNCHES, reset_launch_counts
    from repro_torch.serve import (SHED_DEADLINE, SHED_QUEUE_FULL,
                                   RequestShed, ServeConfig, TriangleService)

    entries, intersect_case = ctx["entries"], ctx["intersect_case"]
    pool, truths = ctx["pool"], ctx["pool_truths"]
    phase("phase 3n: TriangleService(algorithm='intersection', ServeConfig("
          "batch_window_ms=2.0, max_batch=8)): 512 count requests over "
          "phase 3j's pool from 4 tenants")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opts = CountOptions(algorithm="intersection")
    svc = TriangleService(opts, config=ServeConfig(batch_window_ms=2.0,
                                                   max_batch=8)).start()
    check(svc.device.type == "cuda", f"the service runs on {svc.device}")
    warm = svc.warmup(pool)
    misses0 = executable_cache_info()["misses"]
    print(f"warmup over {len(pool)} graphs: {warm}")
    picks = np.random.default_rng(0).integers(0, len(pool), size=512)
    want = [truths[p] for p in picks]
    bursts, total, i = [], 0, 0
    while total < len(picks):
        k = min((1, 3, 8, 64)[i % 4], len(picks) - total)
        bursts.append(k)
        total += k
        i += 1

    def serve_burst(start: int, k: int) -> list:
        """Submit requests start..start+k at once, then wait for each."""
        futs = [svc.submit("count", pool[picks[j]], tenant=f"tenant{j % 4}")
                for j in range(start, start + k)]
        return [f.result(timeout=120) for f in futs]

    reset_launch_counts()
    served, pos = [], 0
    t0 = time.perf_counter()
    for k in bursts:
        served += serve_burst(pos, k)
        pos += k
    serve_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    snap = svc.snapshot()
    check([r.count for r in served] == want,
          f"all {len(served)} served counts = phase 3j's scipy truths")
    new_misses = executable_cache_info()["misses"] - misses0
    counters, lat = snap["counters"], snap["latency"]["total"]
    rps = len(served) / serve_s
    print(f"{len(served)} requests in {len(bursts)} bursts ({bursts[:8]}...) "
          f"in {serve_s:.3f} s: {rps:.1f} requests/s; total latency p50 "
          f"{lat['p50_ms']:.3f} ms, p90 {lat['p90_ms']:.3f} ms, p99 "
          f"{lat['p99_ms']:.3f} ms; coalesce factor "
          f"{snap['coalesce_factor']:.3f}, {counters['dispatches']} "
          f"dispatches; launches {launches}; cache misses after warmup "
          f"{new_misses}; plan cache {snap['plan_cache']}")
    check(new_misses == 0, "no launch configuration built after warmup()")
    check(counters.get("errors", 0) == 0
          and counters["completed"] == len(served),
          "no errored request; every future resolved")
    check(launches["broadcast"] > 0 and launches["probe"] > 0,
          "the served batches ran the broadcast and probe kernels")

    t0 = time.perf_counter()
    loop = [TriangleCounter(pool[p], algorithm="intersection").count().count
            for p in picks]  # each session and its plan dropped at once
    loop_s = time.perf_counter() - t0
    session = TriangleCounter(rmat_graph(9, 16, seed=1000),
                              algorithm="intersection")
    t0 = time.perf_counter()
    # count_many's list would hold every batch's stacks; its generator twin
    # keeps one batch at a time
    many = [int(r) for r in session.iter_counts([pool[p] for p in picks],
                                                batch_size=8)]
    many_s = time.perf_counter() - t0
    del session
    print(f"the same {len(picks)} requests: per-request TriangleCounter(g)"
          f".count() loop {loop_s:.3f} s ({len(picks) / loop_s:.1f}/s); "
          f"iter_counts(batch_size=8), count_many's generator twin, "
          f"{many_s:.3f} s "
          f"({len(picks) / many_s:.1f}/s); the service {serve_s:.3f} s "
          f"(x{loop_s / serve_s:.2f} faster than the loop, "
          f"x{many_s / serve_s:.2f} than count_many)")
    check(loop == many == want, "the loop and count_many = the truths")
    t0 = time.perf_counter()
    for p in picks:  # what submit() hashes on the caller's thread
        graph_fingerprint(pool[p])
    fingerprint_s = time.perf_counter() - t0
    print(f"graph_fingerprint of the {len(picks)} requests' graphs on the "
          f"host: {fingerprint_s:.3f} s ({fingerprint_s / serve_s * 100:.1f} "
          f"% of the service's wall time)")

    misses1 = executable_cache_info()["misses"]  # the loop's own entries
    prof = device_profile(torch, lambda: serve_burst(0, 64))
    print(f"one 64-request burst under torch.profiler: {profile_line(prof)}")

    # the stacked shapes of the largest batch of one more 64-request burst,
    # as the coalescer launches them
    real = coalescer_module.get_batch_executable
    seen = {}

    def recording(specs, backend, batch):
        fn = real(specs, backend, batch)

        def call(*arrays):
            if batch > max(seen, default=1):
                seen.clear()
                seen[batch] = (specs, arrays)
            return fn(*arrays)
        return call

    coalescer_module.get_batch_executable = recording
    try:
        again = serve_burst(0, 64)
    finally:
        coalescer_module.get_batch_executable = real
    check([r.count for r in again] == want[:64] and bool(seen),
          f"a burst of 64 served through stacked batches (largest "
          f"{max(seen, default=0)})")
    size, (specs, arrays) = seen.popitem()
    by_strategy = {}
    for i, (strat, bits, (e, w)) in enumerate(specs):
        u, v = (a.view(size * e, w) for a in arrays[2 * i:2 * i + 2])
        rec = intersect_case(strat, types.SimpleNamespace(args=(u, v),
                                                          bitmap_bits=bits))
        rec.update(batch_size=size, stack=[size, e, w])
        by_strategy.setdefault(strat, []).append(rec)
    del arrays, u, v
    for strat, shapes in by_strategy.items():
        entry = entries[strat]
        entry["serve_path"] = dict(
            path=f"TriangleService, {len(served)} count requests over phase "
                 f"3j's pool (stacked batches of up to 8; held at {size})",
            launches=launches[strat], shapes=shapes)
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [x["max_abs_err"] for x in shapes])
    check(all(launches[s] > 0 for s in by_strategy),
          "every kernel of the stacked layout launched on the served path")
    check(svc.snapshot()["counters"].get("errors", 0) == 0
          and executable_cache_info()["misses"] == misses1,
          "still no errored request, and the profiled and recorded bursts "
          "built no cache entry")
    pool_peak = (torch.cuda.max_memory_allocated() - held) / 2**30

    # -- R-MAT scale 18, served singly ---------------------------------------
    g = ctx["scale18"]
    print("rmat_graph(18, 16, seed=1) singly, through a service of the "
          "subgraph lane (one session answers count, vertex, edge support "
          "and k-truss):")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    single = TriangleService(CountOptions(algorithm="subgraph"),
                             config=ServeConfig(batch_window_ms=0.0)).start()
    first = single.submit("count", g).result(timeout=600)
    again = single.submit("count", g).result(timeout=600)
    hits = single.snapshot()["session_cache"]["hits"]
    vertex = single.submit("vertex", g).result(timeout=600)
    support = single.submit("edge_support", g).result(timeout=600)
    truss = single.submit("k_truss", g, k=K_TRUSS).result(timeout=600)
    sessions = single.snapshot()["session_cache"]
    single_peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    print(f"  count {first.count} in {first.exec_s:.3f} s (prep included), "
          f"again {again.exec_s * 1e3:.3f} ms (session-cache hits {hits}); "
          f"vertex {vertex.exec_s:.3f} s; edge_support {support.exec_s:.3f} "
          f"s; k_truss({K_TRUSS}) {truss.exec_s:.3f} s, "
          f"{truss.value.m_undirected} edges; session cache {sessions}; "
          f"own peak {single_peak:.2f} GiB")
    check(first.count == again.count == ctx["main_count"] and hits >= 1,
          "count twice = phase 2's count, the second a session-cache hit")
    check(bool((vertex.value == ctx["main_tpv"]).all()),
          "vertex = phase 2's per-vertex counts")
    check(all(a.dtype == b.dtype and np.array_equal(a, b)
              for a, b in zip(support.value, ctx["scale18_support"])),
          "edge_support = phase 3k's scipy supports, array for array")
    want_truss = ctx["scale18_truss"]
    check(np.array_equal(truss.value.row_ptr, want_truss.row_ptr)
          and np.array_equal(truss.value.col_idx, want_truss.col_idx),
          f"k_truss({K_TRUSS}) = phase 3k's scipy peel")
    single_info = dict(count_s=first.exec_s, again_ms=again.exec_s * 1e3,
                       vertex_s=vertex.exec_s, support_s=support.exec_s,
                       k_truss_s=truss.exec_s, peak_gib=single_peak)
    single.stop()
    del single, first, again, vertex, support, truss
    gc.collect()
    torch.cuda.empty_cache()

    # -- dynamic updates through the service ---------------------------------
    handle = svc.open_dynamic_session(g, tenant="stream")
    check_dc = DynamicTriangleCounter(g, recount_interval=0)
    batch_of = update_batches(np, g, np.random.default_rng(0))
    update_ms = []
    for b in range(8):
        ups = next(batch_of)
        res = svc.submit("update", handle=handle, updates=ups).result(
            timeout=600)
        check_dc.apply_updates(ups)
        full = check_dc.recount()
        check(res.count == full and res.algorithm == "dynamic",
              f"update batch {b + 1}: served count {res.count} = recount()")
        update_ms.append(res.exec_s * 1e3)
    svc.close_dynamic_session(handle)
    print(f"8 update batches of 256 through open_dynamic_session: exec ms "
          f"{[round(x, 3) for x in update_ms]}")
    del check_dc

    # -- load shedding ---------------------------------------------------------
    shed_svc = TriangleService(opts, config=ServeConfig(
        max_queue_depth=4, batch_window_ms=0.0, default_deadline_ms=1.0))
    small = [x for x in pool if x.n <= 1024][:8]  # quick to fingerprint
    futs = [shed_svc.submit("count", x) for x in small]
    time.sleep(0.005)  # the 4 admitted requests' 1 ms deadlines pass
    shed_svc.start()
    shed_svc.stop(drain=True, timeout=60)
    reasons = []
    for f in futs:
        try:
            f.result(timeout=60)
            reasons.append("served")
        except RequestShed as e:
            reasons.append(e.reason)
    shed = shed_svc.snapshot()["counters"]
    print(f"shedding at depth 4, 1 ms deadline: {reasons}; counters {shed}")
    check(len(reasons) == 8 and set(reasons) <= {SHED_DEADLINE,
                                                 SHED_QUEUE_FULL}
          and reasons.count(SHED_QUEUE_FULL) <= 4 and shed["shed"] == 8,
          "each of the 8 requests raised a typed RequestShed (past its "
          "deadline or over the depth); none was served, none hung")

    final = svc.snapshot()
    svc.stop()
    check(final["counters"].get("errors", 0) == 0,
          "the service ended with no errored request")
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    info = dict(requests=len(served), bursts=len(bursts), serve_s=serve_s,
                requests_per_s=rps, p50_ms=lat["p50_ms"],
                p90_ms=lat["p90_ms"], p99_ms=lat["p99_ms"],
                coalesce_factor=snap["coalesce_factor"],
                dispatches=counters["dispatches"], launches=launches,
                loop_s=loop_s, count_many_s=many_s,
                fingerprint_s=fingerprint_s,
                warmup_s=warm["seconds"], pool_peak_gib=pool_peak,
                profile={k: v for k, v in prof.items() if k != "by_name"},
                single=single_info, update_ms=update_ms, shed=reasons)
    print(json.dumps({"service": info}))
    return info


SHARDED_RANKS = 4


def sharded_rank(rank: int, world: int, store: str, spec: dict) -> None:
    """Phase 3o (b): one of ``world`` gloo ranks on ``cuda:0``, spawned by
    ``sharded_phase``. Runs the sharded lanes on ``spec``'s graphs and
    writes ``rank<rank>.json`` to ``spec["out"]``; raises on any fault,
    which fails the phase."""
    import hashlib

    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import TriangleCounter
    from repro_torch.kernels.intersect import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.masked_spgemm import LAUNCHES as MS_LAUNCHES
    from repro_torch.kernels.masked_spgemm import \
        reset_launch_counts as reset_ms_launch_counts
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((world,), ("data",))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        reset_ms_launch_counts()
        tc = TriangleCounter(spec["graph"], algorithm="intersection_distributed",
                             mesh=mesh)
        first = tc.count()
        warm = [tc.count() for _ in range(3)]
        del tc
        torch.cuda.empty_cache()  # the four ranks share one card
        su, sv, supp = TriangleCounter(spec["graph"], algorithm="edge",
                                       mesh=mesh).edge_support()
        support = hashlib.sha1(np.ascontiguousarray(
            np.stack([su, sv, supp]), dtype=np.int64).tobytes()).hexdigest()
        peak = torch.cuda.max_memory_allocated()
        bitmap = TriangleCounter(spec["bitmap_graph"],
                                 algorithm="intersection_distributed",
                                 strategy="bitmap", mesh=mesh).count()
        mat = TriangleCounter(spec["matrix_graph"],
                              algorithm="matrix_distributed", mesh=mesh)
        mfirst = mat.count()
        mwarm = [mat.count() for _ in range(3)]
        torch.cuda.synchronize()
        out = dict(
            rank=rank, shard=first.meta["shard"],
            counts=[r.count for r in [first] + warm],
            warm_s=[r.exec_seconds for r in warm],
            prep_s=first.prep_seconds, support=support,
            bitmap_count=bitmap.count,
            matrix_counts=[r.count for r in [mfirst] + mwarm],
            matrix_warm_s=[r.exec_seconds for r in mwarm],
            launches=dict(LAUNCHES, **MS_LAUNCHES),
            shard_work=list(first.meta["shard_work"]),
            shard_valid=[list(v) for v in first.meta["shard_valid"]],
            shard_bytes=first.meta["shard_bytes"],
            tile_bytes=mfirst.meta["tile_bytes"],
            tiles_per_shard=mfirst.meta["tiles_per_shard"],
            peak_bytes=peak, device=str(torch.cuda.current_device()))
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def sharded_phase(torch, np, dev, ctx) -> None:
    """Phase 3o: the sharded lanes, (a) on a world-1 NCCL group in this
    process and (b) on ``SHARDED_RANKS`` gloo ranks spawned on ``cuda:0``,
    each against the scipy oracles and the single-card lanes. The K1–K4
    entries gain ``sharded_path``."""
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.core import (TriangleCounter, edge_support_forward_scipy,
                                  triangle_count_scipy)
    from repro_torch.graphs import load_dataset, rmat_graph
    from repro_torch.kernels.intersect import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.masked_spgemm import LAUNCHES as MS_LAUNCHES
    from repro_torch.kernels.masked_spgemm import (
        masked_spgemm_gathered, masked_spgemm_gathered_chunked)
    from repro_torch.kernels.masked_spgemm import \
        reset_launch_counts as reset_ms_launch_counts
    from repro_torch.launch.mesh import make_mesh

    entries, k4 = ctx["entries"], ctx["k4"]
    intersect_case = ctx["intersect_case"]
    work = ROOT / "build" / "sharded"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    def medians(xs):
        return statistics.median(xs) * 1e3

    # -- (a): one rank on a world-1 NCCL group ----------------------------
    phase("phase 3o: sharded lanes on a world-1 NCCL group, TriangleCounter("
          "rmat_graph(18, 16, seed=1), algorithm='intersection_distributed', "
          "mesh=make_mesh((1,), ('data',)))")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(work / "nccl-store"), 1), rank=0, world_size=1)
    print(f"process group: backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}")
    g = ctx["scale18"]
    orkut = load_dataset("orkut-like")
    coauthors = load_dataset("coauthors-like")
    coauthors_truth = triangle_count_scipy(coauthors)

    single = TriangleCounter(g)
    single_mat = TriangleCounter(orkut, algorithm="matrix")
    check(single.count().count == EXPECTED_SCALE18
          and single_mat.count().count == EXPECTED_ORKUT,
          "the single-card intersection and matrix lanes again = "
          "82,629,122 and 13,038,569")
    mesh = make_mesh((1,), ("data",))
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    reset_ms_launch_counts()
    tc = TriangleCounter(g, algorithm="intersection_distributed", mesh=mesh)
    first = tc.count()
    warm = [tc.count() for _ in range(5)]
    count_peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    bitmap = TriangleCounter(coauthors, algorithm="intersection_distributed",
                             strategy="bitmap", mesh=mesh)
    bfirst = bitmap.count()
    mat = TriangleCounter(orkut, algorithm="matrix_distributed", mesh=mesh)
    mfirst = mat.count()
    mwarm = [mat.count() for _ in range(5)]
    launches = dict(LAUNCHES, **MS_LAUNCHES)
    check(all(r.count == EXPECTED_SCALE18 for r in [first] + warm),
          f"intersection_distributed count() = {first.count} every time, "
          f"= the oracle and the single-card lane")
    check(bfirst.count == coauthors_truth,
          f"coauthors-like intersection_distributed strategy=bitmap = "
          f"{bfirst.count} = scipy")
    check(all(r.count == EXPECTED_ORKUT for r in [mfirst] + mwarm),
          f"orkut-like matrix_distributed count() = {mfirst.count} every "
          f"time, = the oracle and the single-card matrix lane")
    # warm count() in turns (single, sharded), after the counted run; then
    # the scalar all-reduce alone and the host read alone
    turns = {k: [] for k in ("single", "sharded", "single_mat", "mat")}
    for _ in range(15):
        for key, s in (("single", single), ("sharded", tc),
                       ("single_mat", single_mat), ("mat", mat)):
            turns[key].append(s.count().exec_seconds)
    x = torch.zeros((), dtype=torch.int64, device=dev)
    reduce_s, read_s = [], []
    for _ in range(50):
        t0 = time.perf_counter()
        dist.all_reduce(x)
        int(x)
        reduce_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        int(x)
        read_s.append(time.perf_counter() - t0)
    world1 = dict(
        count_ms=medians(turns["sharded"]), single_ms=medians(turns["single"]),
        matrix_ms=medians(turns["mat"]),
        single_matrix_ms=medians(turns["single_mat"]),
        all_reduce_and_read_ms=medians(reduce_s), read_ms=medians(read_s),
        count_peak_gib=count_peak)
    m = first.meta
    print(f"algorithm={first.algorithm} mesh={m['mesh']} "
          f"buckets={m['bucket_shapes']} strategies={first.bucket_strategies} "
          f"shard_valid={m['shard_valid']} shard_work={m['shard_work']} "
          f"resident buckets {m['shard_bytes'] / 2**30:.2f} GiB (shared "
          f"with the prep's, not copied, on one shard); prep_seconds="
          f"{first.prep_seconds:.4f}; own peak {count_peak:.2f} GiB")
    mm = mfirst.meta
    print(f"orkut-like matrix_distributed: {mm['tiles_per_shard']} triples "
          f"of B = {mm['block']}, prep {mfirst.prep_seconds:.4f} s")
    print(f"warm count() in 15 turns, medians: scale 18 sharded "
          f"{world1['count_ms']:.4f} ms against single-card "
          f"{world1['single_ms']:.4f} ms; orkut-like matrix_distributed "
          f"{world1['matrix_ms']:.4f} ms against {world1['single_matrix_ms']:.4f}"
          f" ms; an int64 scalar all_reduce + int() {world1['all_reduce_and_read_ms']:.4f}"
          f" ms, int() alone {world1['read_ms']:.4f} ms (medians of 50)")
    shapes = {}
    for plan in (tc.plan, bitmap.plan):
        for st in plan.stages:
            shapes.setdefault(st.strategy, []).append(
                intersect_case(st.strategy, st))
    (st,) = mat.plan.stages
    l_b, u_b, a_b, li, ui, ai, order = st.args
    k_out = masked_spgemm_gathered(l_b, u_b, a_b, li, ui, ai, order=order)
    p_out = masked_spgemm_gathered_chunked(l_b, u_b, a_b, li, ui, ai)
    torch.cuda.synchronize()
    err = float((k_out - p_out).abs().max())
    check(err == 0, f"K4 == plain on the sharded stage {st.shape_key}")
    flush = ctx["flush"]
    k_ms = time_ms(torch, lambda: masked_spgemm_gathered(
        l_b, u_b, a_b, li, ui, ai, order=order), 5, flush)
    p_ms = time_ms(torch, lambda: masked_spgemm_gathered_chunked(
        l_b, u_b, a_b, li, ui, ai), 2, flush)
    b_ms, b_by = spgemm_bound_ms(int(li.shape[0]), int(l_b.shape[1]),
                                 spgemm_read_bytes(torch, st.args))
    k4_shape = dict(shape=[int(li.shape[0]), int(l_b.shape[1]),
                           int(l_b.shape[2])], ms=k_ms, plain_ms=p_ms,
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    print(f"  K4 sharded stage {k4_shape['shape']}: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # a CountResult holds its plan: drop the results with the plans
    del (single, single_mat, tc, first, warm, bitmap, bfirst, mat, mfirst,
         mwarm, st, l_b, u_b, a_b, li, ui, ai, order, k_out, p_out, x)
    gc.collect()
    torch.cuda.empty_cache()

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    reset_ms_launch_counts()
    edge = TriangleCounter(g, algorithm="edge", mesh=mesh)
    t0 = time.perf_counter()
    got = edge.edge_support()
    support_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    truss = edge.k_truss(K_TRUSS)
    truss_s = time.perf_counter() - t0
    rounds = edge.plan.meta["peel_rounds"]
    edge_peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    for k, v in dict(LAUNCHES, **MS_LAUNCHES).items():
        launches[k] += v
    world1.update(edge_support_s=support_s, k_truss_s=truss_s,
                  edge_peak_gib=edge_peak)
    print(f"edge_support() (sharded edge lane, one (mk,) all-reduce) "
          f"{support_s:.4f} s; k_truss({K_TRUSS}) {truss.m_undirected} edges, "
          f"{rounds} rounds, {truss_s:.3f} s; own peak {edge_peak:.2f} GiB")
    print(f"launches over the world-1 sharded path: {launches}")
    want = ctx["scale18_support"]
    check(all(a.dtype == b.dtype and np.array_equal(a, b)
              for a, b in zip(got, want)),
          "the sharded edge_support() = edge_support_forward_scipy, array "
          "for array")
    want_truss = ctx["scale18_truss"]
    check(np.array_equal(truss.row_ptr, want_truss.row_ptr)
          and np.array_equal(truss.col_idx, want_truss.col_idx),
          f"the sharded k_truss({K_TRUSS}) = phase 3k's scipy peel")
    check(all(launches[k] > 0 for k in ("broadcast", "probe", "bitmap"))
          and launches["masked_spgemm_wgmma"] > 0,
          "K1, K2, K3 and K4 launched on the sharded path")
    del edge, got, truss
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b): SHARDED_RANKS gloo ranks spawned on cuda:0 ------------------
    # a rank preps the whole graph: its peak is about the world-1 peak at
    # half the scale, beside its CUDA context
    free = torch.cuda.mem_get_info()[0]
    per_rank = max(count_peak, edge_peak) * 2**30 / 2 + (1 << 30)
    scale = 17 if SHARDED_RANKS * per_rank < free - (4 << 30) else 16
    phase(f"phase 3o: {SHARDED_RANKS} gloo ranks on cuda:0, R-MAT scale "
          f"{scale} (four prep peaks reckoned at {per_rank / 2**30:.2f} GiB "
          f"each from (a)'s {max(count_peak, edge_peak):.2f} GiB at scale "
          f"18, {free / 2**30:.2f} GiB free)")
    g = rmat_graph(scale, 16, seed=1)
    t0 = time.perf_counter()
    oracle = edge_support_forward_scipy(g)
    truth = int(oracle[2].sum()) // 3
    digest = __import__("hashlib").sha1(np.ascontiguousarray(
        np.stack(oracle), dtype=np.int64).tobytes()).hexdigest()
    print(f"edge_support_forward_scipy {time.perf_counter() - t0:.2f} s: "
          f"{truth} triangles")
    check(scale != 17 or truth == EXPECTED_SCALE17,
          f"the scipy supports sum to 3 × {truth}")
    whole = TriangleCounter(g)
    # a resident probe bucket's arguments are the CSR; its padded rows
    # are kept beside them
    whole_bytes = sum((st.rows or st.args)[0].numel() * 8
                      for st in whole.plan.stages)
    check(whole.count().count == truth, "the single-card lane = scipy")
    # the ranks were reckoned against the card's free memory before it
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    spec = dict(graph=g, bitmap_graph=coauthors, matrix_graph=orkut,
                out=str(work))
    t0 = time.perf_counter()
    procs = mp.start_processes(
        sharded_rank, args=(SHARDED_RANKS, str(work / "gloo-store"), spec),
        nprocs=SHARDED_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    while not procs.join(timeout=5):  # a failed rank raises here
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            raise RuntimeError("the gloo ranks did not finish in 600 s")
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(SHARDED_RANKS):
        with open(work / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    print(f"{SHARDED_RANKS} ranks spawned, run and joined in {ranks_s:.2f} s")
    for r in ranks:
        print(f"  rank {r['rank']} (shard {r['shard']}, cuda:{r['device']}): "
              f"counts {r['counts']}, warm count() "
              f"{[round(x * 1e3, 3) for x in r['warm_s']]} ms, prep "
              f"{r['prep_s']:.3f} s, shard_work {r['shard_work']}, "
              f"resident buckets {r['shard_bytes'] / 2**20:.2f} MiB (single-"
              f"card plan {whole_bytes / 2**20:.2f} MiB / {SHARDED_RANKS} = "
              f"{whole_bytes / SHARDED_RANKS / 2**20:.2f} MiB), peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; orkut-like "
              f"{r['tiles_per_shard']} triples a shard, tiles "
              f"{r['tile_bytes'] / 2**20:.2f} MiB, warm count() "
              f"{[round(x * 1e3, 3) for x in r['matrix_warm_s']]} ms; "
              f"launches {r['launches']}")
    check(sorted(r["shard"] for r in ranks) == list(range(SHARDED_RANKS)),
          "each rank holds its own shard")
    check(all(r["counts"] == [truth] * 4 and r["support"] == digest
              and r["bitmap_count"] == coauthors_truth
              and r["matrix_counts"] == [EXPECTED_ORKUT] * 4 for r in ranks),
          f"on every rank: count() = {truth} every time, edge_support() = "
          f"scipy, coauthors-like bitmap = scipy, orkut-like matrix = "
          f"13,038,569")
    check(all(0 < r["shard_bytes"] <= whole_bytes / SHARDED_RANKS * 1.25
              for r in ranks),
          "each rank's resident buckets are about 1/P of the single-card "
          "plan's")
    check(all(all(r["launches"][k] > 0 for k in
                  ("broadcast", "probe", "bitmap", "masked_spgemm_wgmma"))
              for r in ranks),
          "K1, K2, K3 and K4 launched in every rank process")
    for strat in ("broadcast", "probe", "bitmap"):
        entry = entries[strat]
        entry["sharded_path"] = dict(
            path="phase 3o: intersection_distributed on a world-1 NCCL group "
                 "(R-MAT scale 18; coauthors-like forced to bitmap), and on "
                 f"{SHARDED_RANKS} gloo ranks on cuda:0 (R-MAT scale {scale})",
            launches=launches[strat],
            rank_launches=[r["launches"][strat] for r in ranks],
            shapes=shapes.get(strat, []))
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [x["max_abs_err"] for x in
                                      shapes.get(strat, [])])
    k4["sharded_path"] = dict(
        path="phase 3o: matrix_distributed on orkut-like, world-1 NCCL and "
             f"{SHARDED_RANKS} gloo ranks",
        launches=launches["masked_spgemm"] + launches["masked_spgemm_wgmma"],
        rank_launches=[r["launches"]["masked_spgemm"]
                       + r["launches"]["masked_spgemm_wgmma"] for r in ranks],
        shapes=[k4_shape], world1=world1)
    k4["max_abs_err"] = max(k4["max_abs_err"], err)
    shutil.rmtree(work, ignore_errors=True)


def serve_phase(torch, np, dev, get_config, get_model, greedy_generate, fa):
    """Phase 3f: gemma2-2b served at full width through K6; returns what
    phase 4c reports beside the kernel's times."""
    phase(f"phase 3f: serving {SERVE_ARCH} at full width, batch "
          f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_STEPS} greedy tokens")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 off for fp32 matmuls (the fp32 unembedding)")
    cfg = get_config(SERVE_ARCH)
    model, held, weights = new_lm_model(torch, dev, get_model, cfg,
                                        torch.bfloat16)
    reckoned = lm_peak_reckoning(cfg, weights, SERVE_BATCH, SERVE_PROMPT,
                                 SERVE_MAX_LEN)
    print(f"reckoned peak before the run: {reckon_line(reckoned)}")
    t0 = time.perf_counter()
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    local_layers = sum(w == cfg.sliding_window for w in model.windows)
    extra = 2 * cfg.d_model * cfg.num_layers if cfg.post_norms else 0
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.kv_heads} x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, windows "
          f"{sorted(set(model.windows))}; weights drawn in "
          f"{time.perf_counter() - t0:.2f} s; {n_params:,} parameters "
          f"against ModelConfig.param_count() {cfg.param_count():,} "
          f"(+{extra:,} for the post-norm scales, which it leaves out)")
    check(n_params == cfg.param_count() + extra
          + (cfg.padded_vocab - cfg.vocab) * cfg.d_model,
          "parameter count = param_count() + post-norm scales")
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                                     generator=gen, device=dev)}
    run = lm_serve_run(torch, model, cfg, batch, SERVE_STEPS, SERVE_MAX_LEN,
                       fa, greedy_generate, held, reckoned)
    forced = forced_against_plain(torch, model, batch, run.pop("toks"),
                                  SERVE_MAX_LEN, fa, SERVE_LOGIT_TOL, cfg.name,
                                  floor_chunk=512)
    del model
    drop_model(torch)
    fp32 = fp32_against_plain(torch, dev, get_model, cfg, batch, SERVE_MAX_LEN,
                              fa, [-1])
    return dict(run, **forced, fp32_max_abs_diff=fp32,
                windows={cfg.sliding_window: local_layers,
                         None: cfg.num_layers - local_layers})


def device_profile(torch, fn, host_ops: bool = True) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and read the device's
    activity: kernels and copies, their summed time, by name, and the idle
    share of the host-clock wall time (the profiler's own host overhead
    included, so the share is an upper bound). ``host_ops=False`` records
    the device's activity alone (a training step's 10⁵ host ops take the
    profiler a minute to read back)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    return dict(wall_s=wall, busy_s=busy, kernels=n, by_name=by_name,
                idle_share=(1.0 - busy / wall) if n else None)


def k6_device_time(torch, call, flush, reps: int = 10) -> dict:
    """K6's own device time a call, apart from the wrapper's host work, each
    call after an L2 flush as ``time_ms`` makes it: (a) ``torch.profiler``'s
    mean duration of each K6 kernel it captured (the tensor-core kernel, and
    the merge kernel of a split call), with the number captured (late in
    this long process it has captured a quarter of them, or none); (b) CUDA
    events around the call while a spin kernel (``torch.cuda._sleep``)
    holds the device, so the host enqueues the events and K6 before the
    device reaches them; and the wrapper's host time a call on the host
    clock over calls that do not wait for the device."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and (
                "flash_fwd" in e.name or "flash_merge" in e.name):
            key = "merge" if "flash_merge" in e.name else "attention"
            seen.setdefault(key, []).append(e.time_range.elapsed_us() / 1e3)
    hidden = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # ~1 ms: longer than the host's work
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        hidden.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host_s = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return dict(
        profiler_ms=(sum(statistics.mean(v) for v in seen.values())
                     if seen else None),
        profiler_captured={k: len(v) for k, v in seen.items()},
        device_ms=statistics.median(hidden), host_ms=host_s * 1e3)


def flash_phase(torch, np, dev, fa, flush, serve, lm_layers: dict) -> dict:
    """Phase 4c: K6 against its plain version, timed beside its bound, at
    the layer shapes of every serving path (``lm_layers``: K6's launches a
    prefill of each model that phases 3p–3r, 3s and 3u serve, whisper's by
    call: ``encoder``, ``self``, ``cross``, and ``decode cross`` a decode
    step; and ``encoder_seq``), with and without the VLM's bidirectional
    prefix, each also beside ``flex_attention`` (and SDPA where it computes
    the same function)."""
    phase("phase 4c: flash-attention kernel against its plain torch version")
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    flex = torch.compile(flex_attention)

    def case(label, b, s, hq, hkv, hd, dtype, window, cap, per_prefill,
             library=False, prefix=0, t=None, causal=True, sdpa=False,
             device_time=False):
        t = s if t is None else t
        gen = torch.Generator(device=dev).manual_seed(s + t + hq + hd + prefix)
        q = torch.randn(b, s, hq, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, t, hkv, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, t, hkv, hd, generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, cap=cap)
        if prefix:
            kw["prefix_len"] = prefix
        k_out = fa.flash_attention_kernel(q, k, v, **kw)
        p_out = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        ok, err = fa.flash_within_tolerance(k_out, p_out, q, k, v, **kw)
        check(ok, f"flash_attention kernel == plain within tolerance at "
                  f"{label} (max |Δ| {err})")
        rows = None
        if dtype != torch.float32:
            rows = row_rms_facts(fa.flash_row_rms(k_out, q, k, v, **kw), s)
            print(f"  row RMS against the fp32 plain version at {label}: "
                  f"median {rows['median']:.4e}, max {rows['max']:.4e}; late "
                  f"rows median {rows['late_median']:.4e}, max "
                  f"{rows['late_max']:.4e}; bound "
                  f"{fa.ROW_RMS_BOUND[dtype]:.4e}", flush=True)
            check(rows["max"] <= fa.ROW_RMS_BOUND[dtype],
                  f"flash_attention kernel rows within "
                  f"{fa.ROW_RMS_BOUND[dtype]} relative RMS at {label}")
        del k_out, p_out
        k_ms = time_ms(torch, lambda: fa.flash_attention_kernel(q, k, v, **kw),
                       5, flush)
        p_ms = time_ms(torch, lambda: fa.flash_attention_ref(q, k, v, **kw),
                       3, flush)
        bound = flash_bound_ms(np, q, k, causal, window, prefix)
        tflops = bound["flops"] / (k_ms * 1e-3) / 1e12
        print(f"  flash_attention {label}: kernel {k_ms:.4f} ms "
              f"({tflops:.1f} TFLOP/s, {bound['bound_ms'] / k_ms * 100:.1f} % "
              f"of the bound), plain {p_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
              f"{bound['flops'] / 1e12:.4f} TFLOP over {bound['pairs']:,} "
              f"pairs a head; fp32 CUDA-core figure "
              f"{bound['fp32_alu_ms']:.4f} ms)", flush=True)
        rec = dict(label=label, shape=[b, s, hq, hkv, hd], keys=t,
                   causal=causal,
                   dtype=str(dtype).replace("torch.", ""), window=window,
                   cap=cap, prefix_len=prefix, ms=k_ms, plain_ms=p_ms, max_abs_err=err,
                   row_rms=rows,
                   tflops=tflops, bound_share=bound["bound_ms"] / k_ms,
                   launches_per_prefill=per_prefill, **bound)
        if dtype != torch.float32:  # the 16-bit kernel's launch plan
            plan = fa.flash_plan(b, s, t, hq, hkv, hd, causal=causal,
                                 window=window, prefix_len=min(prefix, t),
                                 sm_count=torch.cuda.get_device_properties(
                                     dev).multi_processor_count)
            rec["plan"] = plan._asdict()
            print(f"  plan at {label}: {plan.rows} rows a block, "
                  f"{plan.keys}-key tiles, {plan.parts} part"
                  f"{'s (split keys, then the merge kernel)' if plan.parts > 1 else ''}",
                  flush=True)
        if device_time:  # the kernels' own time, apart from the host's
            rec.update(k6_device_time(torch, lambda: fa.flash_attention_kernel(
                q, k, v, **kw), flush))
            prof_ms = rec["profiler_ms"]
            print(f"  K6's device time at {label}: torch.profiler "
                  + ("captured no K6 kernel (not measured)" if prof_ms is None
                     else f"{prof_ms:.4f} ms a call (kernels captured "
                          f"{rec['profiler_captured']} of 10 calls)")
                  + f"; CUDA events with the host's work hidden behind a "
                  f"spin kernel {rec['device_ms']:.4f} ms; against "
                  f"{k_ms:.4f} ms between CUDA events with it exposed; the "
                  f"wrapper's host work {rec['host_ms']:.4f} ms a call (host "
                  f"clock, no sync)", flush=True)
        if library:
            lib, mask_s = flex_library(torch, flex, create_block_mask, q, k,
                                       v, window, cap, prefix, causal)
            t0 = time.perf_counter()
            l_out = lib()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            ok, l_err = fa.flash_within_tolerance(
                l_out, fa.flash_attention_ref(q, k, v, **kw), q, k, v, **kw)
            if prefix:  # the library's mask must hold the prefix too
                check(not fa.flash_within_tolerance(l_out, fa.flash_attention_ref(
                    q, k, v, causal=True, window=window, cap=cap), q, k, v,
                    causal=True, window=window, cap=cap)[0],
                    f"library flex_attention at {label} differs from the "
                    f"attention without the prefix")
            check(ok, f"library flex_attention == plain within one rounding "
                      f"step and its bf16 weights' slack at {label} (max |Δ| "
                      f"{l_err})")
            del l_out
            l_ms = time_ms(torch, lib, 5, flush)
            print(f"  library flex_attention (torch.compile; first call "
                  f"{first_s:.2f} s with its compile, block mask built in "
                  f"{mask_s:.3f} s): {l_ms:.4f} ms against the kernel's "
                  f"{k_ms:.4f} ms (x{k_ms / l_ms:.2f})", flush=True)
            rec.update(library_ms=l_ms, library_max_abs_err=l_err,
                       library_block_mask_s=mask_s)
        if sdpa:  # no window, softcap or prefix: the same function
            def sdpa_call():
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, enable_gqa=True).transpose(1, 2)
            ok, s_err = fa.flash_within_tolerance(
                sdpa_call(), fa.flash_attention_ref(q, k, v, **kw), q, k, v,
                **kw)
            check(ok, f"library scaled_dot_product_attention == plain within "
                      f"one rounding step and its bf16 weights' slack at "
                      f"{label} (max |Δ| {s_err})")
            s_ms = time_ms(torch, sdpa_call, 5, flush)
            print(f"  library scaled_dot_product_attention(is_causal="
                  f"{causal}, enable_gqa=True): {s_ms:.4f} ms against the "
                  f"kernel's {k_ms:.4f} ms (x{k_ms / s_ms:.2f})", flush=True)
            rec.update(sdpa_ms=s_ms, sdpa_max_abs_err=s_err)
        return rec, (q, k, v)

    b, s = SERVE_BATCH, SERVE_PROMPT
    windows = serve["windows"]
    local, _ = case(f"gemma2-2b local layer ({b}, {s}, 8/4, 256) bf16, "
                    f"window 4096, cap 50", b, s, 8, 4, 256, torch.bfloat16,
                    4096, 50.0, windows.get(4096, 0), library=True)
    glob, (q, k, v) = case(f"gemma2-2b global layer ({b}, {s}, 8/4, 256) "
                           f"bf16, cap 50", b, s, 8, 4, 256, torch.bfloat16,
                           None, 50.0, windows.get(None, 0), library=True)
    path = [local, glob]
    check(local["launches_per_prefill"] + glob["launches_per_prefill"]
          == serve["launches"],
          f"the two layer shapes cover the path's {serve['launches']} launches")
    ragged = [case("qwen1.5-4b heads (1, 1000, 20/20, 128) fp32", 1, 1000, 20,
                   20, 128, torch.float32, None, None, 0)[0],
              case("minicpm-2b heads (1, 777, 36/36, 64) fp32", 1, 777, 36, 36,
                   64, torch.float32, None, None, 0)[0]]

    # the layer shapes of phases 3p and 3q, at the group widths they give the
    # tensor-core kernel: qwen1.5-32b G = 1, dbrx-132b G = 6, arctic-480b
    # G = 7 (head_dim 128, no window, no softcap, so SDPA computes the same
    # function and is their library call; flex_attention is not compiled
    # for them)
    gqa_cases = [
        case(f"{arch} layer ({b_}, {s_}, {hq}/{hkv}, 128) bf16", b_, s_, hq,
             hkv, 128, torch.bfloat16, None, None, lm_layers[arch],
             sdpa=True)[0]
        for arch, b_, s_, hq, hkv in (
            (INT8_ARCH, INT8_BATCH, INT8_PROMPT, 40, 40),
            ("arctic-480b", MOE_BATCH, MOE_PROMPT, 56, 8),
            ("dbrx-132b", MOE_BATCH, MOE_PROMPT, 48, 8))]

    # the layer shapes of phases 3s and 3u: whisper-medium's encoder (not
    # causal over its 1500 frames), the decoder's causal self-attention,
    # its cross-attention (S = prompt, T = 1500) and a decode step's
    # one-query cross-attention (16/16 heads of 64, no softcap, so SDPA
    # computes the same function and is their library call; flex_attention
    # is not compiled for them); recurrentgemma-9b's local attention
    # (MQA 16/1 at head dim 256, causal, window 2048)
    eb, es, et = ENCDEC_BATCH, ENCDEC_PROMPT, lm_layers["encoder_seq"]
    encdec_cases = [
        case(f"{ENCDEC_ARCH} {what} ({eb}, {s_} vs {t_}, 16/16, 64) bf16"
             f"{'' if causal else ', not causal'}", eb, s_, 16, 16, 64,
             torch.bfloat16, None, None, lm_layers[what], t=t_,
             causal=causal, sdpa=True,
             device_time=what in ("self", "decode cross"))[0]
        for what, s_, t_, causal in (("encoder", et, et, False),
                                     ("self", es, es, True),
                                     ("cross", es, et, False),
                                     ("decode cross", 1, et, False))]
    # a single stream's whisper-medium decode step (batch 1): 16 blocks walk
    # the 1500 encoder frames, so K6 splits the keys and runs its merge
    split_cases = [case(f"{ENCDEC_ARCH} decode cross (1, 1 vs {et}, 16/16, "
                        f"64) bf16, not causal, batch 1", 1, 1, 16, 16, 64,
                        torch.bfloat16, None, None, 0, t=et, causal=False,
                        sdpa=True, device_time=True)[0]]
    check(split_cases[0]["plan"]["parts"] > 1,
          "K6 splits the keys of whisper-medium's batch-1 decode step")
    for r in encdec_cases + split_cases:
        print(f"  {r['label']}: K6 {r['ms']:.4f} ms ({r['bound_share'] * 100:.1f} "
              f"% of the {r['bound_ms']:.4f} ms bound, {r['bound_by']}), SDPA "
              f"{r['sdpa_ms']:.4f} ms: K6 x{r['ms'] / r['sdpa_ms']:.2f} "
              f"({'no slower' if r['ms'] <= r['sdpa_ms'] else 'SLOWER'}); "
              f"plan {r['plan']}", flush=True)
    prefill = [r for r in encdec_cases if "decode" not in r["label"]]
    enc_layers, dec_layers = lm_layers["whisper_depth"]
    for depth, calls in (("served cut", {r["label"]: r["launches_per_prefill"]
                                         for r in prefill}),
                         ("published depth", {r["label"]: enc_layers
                                              if "encoder" in r["label"]
                                              else dec_layers
                                              for r in prefill})):
        k6_w = sum(r["ms"] * calls[r["label"]] for r in prefill)
        sdpa_w = sum(r["sdpa_ms"] * calls[r["label"]] for r in prefill)
        print(f"K6 per {ENCDEC_ARCH} prefill ({depth}, "
              f"{sum(calls.values())} calls): {k6_w:.3f} ms against SDPA's "
              f"{sdpa_w:.3f} ms (K6 x{k6_w / sdpa_w:.2f})", flush=True)
    hb, hs = HYBRID_BATCH, HYBRID_PROMPT
    hybrid_case = case(
        f"{HYBRID_ARCH} local layer ({hb}, {hs}, 16/1, 256) bf16, window "
        f"2048", hb, hs, 16, 1, 256, torch.bfloat16, 2048, None,
        lm_layers[HYBRID_ARCH], library=True)[0]
    for r in gqa_cases + encdec_cases + [hybrid_case]:
        n = r["launches_per_prefill"]
        print(f"K6 per prefill (per decode step for the decode cross-"
              f"attention) of {r['label']}: {r['ms'] * n:.3f} ms over {n} "
              f"launches; bound {r['bound_ms'] * n:.3f} ms; plain "
              f"{r['plain_ms'] * n:.3f} ms"
              + (f"; library flex_attention {r['library_ms'] * n:.3f} ms"
                 if "library_ms" in r else "")
              + (f"; scaled_dot_product_attention {r['sdpa_ms'] * n:.3f} ms"
                 if "sdpa_ms" in r else ""), flush=True)

    # the VLM's bidirectional prefix: paligemma-3b's layer shape (multi-query,
    # G = 8, timed beside its bound and flex_attention with the prefix in its
    # mask), then P off the tiles, P >= S (every key visible) and a window
    # beside the prefix (two intervals of valid keys a row)
    vb, vp, vs = VLM_BATCH, VLM_PATCHES, VLM_PATCHES + VLM_PROMPT
    prefix_cases = [
        case(f"paligemma-3b layer ({vb}, {vs}, 8/1, 256) bf16, prefix {vp}",
             vb, vs, 8, 1, 256, torch.bfloat16, None, None, lm_layers[VLM_ARCH],
             library=True, prefix=vp)[0],
        case("(1, 333, 4/2, 64) fp32, prefix 100", 1, 333, 4, 2, 64,
             torch.float32, None, None, 0, prefix=100)[0],
        case("(1, 200, 8/1, 128) fp32, window 16, cap 50, prefix 47", 1, 200,
             8, 1, 128, torch.float32, 16, 50.0, 0, prefix=47)[0],
        case("(1, 257, 10/2, 128) fp16, cap 30, prefix 65", 1, 257, 10, 2,
             128, torch.float16, None, 30.0, 0, prefix=65)[0],
        case("(1, 100, 4/2, 64) bf16, prefix 100 = S", 1, 100, 4, 2, 64,
             torch.bfloat16, None, None, 0, prefix=100)[0],
        case("(1, 100, 4/2, 64) fp32, window 8, prefix 300 > S", 1, 100, 4, 2,
             64, torch.float32, 8, None, 0, prefix=300)[0],
        case("(1, 700, 8/1, 256) bf16, window 64, cap 50, prefix 130", 1, 700,
             8, 1, 256, torch.bfloat16, 64, 50.0, 0, prefix=130)[0],
    ]
    vlm_shape, vlm_layers = prefix_cases[0], lm_layers[VLM_ARCH]
    print(f"K6 per paligemma-3b prefill: {vlm_shape['ms'] * vlm_layers:.3f} ms "
          f"over {vlm_layers} launches; bound "
          f"{vlm_shape['bound_ms'] * vlm_layers:.3f} ms; plain "
          f"{vlm_shape['plain_ms'] * vlm_layers:.3f} ms; library flex_attention "
          f"{vlm_shape['library_ms'] * vlm_layers:.3f} ms", flush=True)

    # planted controls at the global layer's inputs: the plain arithmetic
    # with the weights rounded to bf16's 8 significant bits must pass the
    # row check, and with 4 bits (a fault, 2⁻⁴ relative) fail it in the
    # late rows, where the elementwise slack is loosest
    controls = {}
    for bits in (8, 4):
        out = rounded_weight_attention(torch, q, k, v, None, 50.0, bits)
        rows = row_rms_facts(fa.flash_row_rms(out, q, k, v, cap=50.0), s)
        elem_ok, elem_err = fa.flash_within_tolerance(
            out, fa.flash_attention_ref(q, k, v, cap=50.0), q, k, v, cap=50.0)
        del out
        controls[bits] = dict(rows, elementwise_ok=elem_ok,
                              elementwise_max_abs_err=elem_err)
        print(f"  control, plain arithmetic with weights rounded to {bits} "
              f"significant bits at the global layer: row RMS median "
              f"{rows['median']:.4e}, max {rows['max']:.4e}; late rows "
              f"median {rows['late_median']:.4e}, max {rows['late_max']:.4e}; "
              f"elementwise contract {'passes' if elem_ok else 'fails'} "
              f"(max |Δ| {elem_err})", flush=True)
    bound16 = fa.ROW_RMS_BOUND[torch.bfloat16]
    check(controls[8]["max"] <= bound16 < controls[4]["late_median"],
          "the row check admits bf16 weights and rejects 4-bit weights in "
          "the late rows")

    # where the softcap binds: with random inputs at the path's shapes the
    # logits stay near 1, where tanh(x / 50) * 50 is x to within 2 %, so
    # queries scaled by 8 hold the kernel and the library to the cap itself
    gen = torch.Generator(device=dev).manual_seed(8)
    qc = (8 * torch.randn(1, 512, 8, 256, generator=gen,
                          device=dev)).bfloat16()
    kc, vc = (torch.randn(1, 512, 4, 256, generator=gen,
                          device=dev).bfloat16() for _ in range(2))
    want = fa.flash_attention_ref(qc, kc, vc, cap=50.0)
    uncapped = float((fa.flash_attention_ref(qc, kc, vc).float()
                      - want.float()).abs().max())
    ok_k, err_k = fa.flash_within_tolerance(fa.flash_attention_kernel(
        qc, kc, vc, cap=50.0), want, qc, kc, vc, cap=50.0)
    ok_l, err_l = fa.flash_within_tolerance(flex_library(
        torch, flex, create_block_mask, qc, kc, vc, None, 50.0)[0](), want,
        qc, kc, vc, cap=50.0)
    print(f"  softcap binding, (1, 512, 8/4, 256) bf16, queries x 8: the "
          f"plain version without the cap differs by {uncapped:.4f}; kernel "
          f"max |Δ| {err_k}, library max |Δ| {err_l}")
    check(uncapped > 0.1 and ok_k and ok_l,
          "kernel and library equal the plain version where the softcap binds")
    del qc, kc, vc, want

    # the yardstick: no PyTorch call computes the softcapped function, so
    # K6 without a softcap is timed beside SDPA on the global layer's inputs
    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    nocap = fa.flash_attention_kernel(q, k, v)
    lib = sdpa()
    torch.cuda.synchronize()
    y_diff = float((nocap.float() - lib.float()).abs().max())
    del nocap, lib
    y_k = time_ms(torch, lambda: fa.flash_attention_kernel(q, k, v), 5, flush)
    y_l = time_ms(torch, sdpa, 5, flush)
    print(f"  yardstick (not the same function: no softcap): kernel with "
          f"cap=None {y_k:.4f} ms, torch scaled_dot_product_attention("
          f"is_causal=True, enable_gqa=True) {y_l:.4f} ms, max |Δ| {y_diff}")
    del q, k, v

    def per_prefill(key):
        return sum(r[key] * r["launches_per_prefill"] for r in path)

    k6_prefill_ms = per_prefill("ms")
    lib_prefill_ms = per_prefill("library_ms")
    print(f"K6 per prefill: {k6_prefill_ms:.3f} ms over "
          f"{serve['launches']} launches, {k6_prefill_ms / 1e3 / serve['prefill_s'] * 100:.1f} % "
          f"of the {serve['prefill_s']:.4f} s prefill; bound "
          f"{per_prefill('bound_ms'):.3f} ms (fp32 CUDA-core figure "
          f"{per_prefill('fp32_alu_ms'):.3f} ms); plain version "
          f"{per_prefill('plain_ms'):.3f} ms; library flex_attention "
          f"{lib_prefill_ms:.3f} ms (the kernel x{k6_prefill_ms / lib_prefill_ms:.2f})")
    if serve["prefill_device_busy_s"]:
        print(f"K6 in the profiled prefill: {serve['prefill_k6_device_s'] * 1e3:.3f} "
              f"ms of {serve['prefill_device_busy_s'] * 1e3:.3f} ms device time "
              f"({serve['prefill_k6_device_s'] / serve['prefill_device_busy_s'] * 100:.1f} %)")
    print(f"K6 per prefill against the CUDA-core kernel for every type: "
          f"{k6_prefill_ms:.3f} ms against {K6_EARLIER_MS} ms (an earlier "
          f"run, not measured here) "
          f"(x{K6_EARLIER_MS / k6_prefill_ms:.2f}); "
          f"{per_prefill('flops') / (k6_prefill_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"{per_prefill('bound_ms') / k6_prefill_ms * 100:.1f} % of the bound")
    build = flash_build_facts(_build.build("flash_attention"))
    for inst in build["instances"]:
        print(f"  build: {inst}")
    print(f"  build: {build['hgmma']} HGMMA instructions in the library's SASS")
    check(len(build["instances"]) == 18 and all(
        i.get("spill_stores") == 0 and i.get("spill_loads") == 0
        for i in build["instances"]),
        "ptxas: the twelve 16-bit K6 instances (six with the prefix mask) "
        "and the six merge kernels compile without spills")
    check(build["serialized_wgmma_warnings"] == 0,
          f"ptxas serialised no wgmma of K6 "
          f"({build['serialized_wgmma_warnings']} warnings)")
    check(build["hgmma"] > 0, f"the library holds {build['hgmma']} HGMMA "
                              f"(wgmma) instructions: the tensor cores run K6")
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:29",
        plain="flash_attention_ref",
        path=f"{SERVE_ARCH} greedy_generate: batch {SERVE_BATCH}, prompt "
             f"{SERVE_PROMPT}, {SERVE_STEPS} tokens (one prefill)",
        launches=serve["launches"],
        tolerance="flash_within_tolerance: fp32 1e-4; bf16 (fp16) 2^-7 "
                  "(2^-10) x |value| + 2^-8 (2^-11) x the p-weighted mean of "
                  "|v| (P rounded to the input type before P·V) + 1e-4; "
                  "and each bf16 (fp16) row's relative RMS error against "
                  "the fp32 plain version (flash_row_rms) <= 2^-7 (2^-10)",
        max_abs_err=max(r["max_abs_err"]
                        for r in path + ragged + gqa_cases + prefix_cases
                        + encdec_cases + split_cases + [hybrid_case]),
        ms=k6_prefill_ms, plain_ms=per_prefill("plain_ms"),
        design="bf16 / fp16: flash_fwd_wgmma_kernel, a TMA producer "
               "warpgroup and consumer warpgroups of 64 (query, head) rows "
               "of one kv head, K/V tiles by TMA (128-byte swizzle) and "
               "mbarriers, S = Q K^T by wgmma from shared memory, fp32 "
               "softmax in registers, P in registers as wgmma's A for O += "
               "P V (m64n<hd>k16, V MN-major); a plan a head dim: hd 256 "
               "(PR 16) 2 consumers, 64-key tiles, 2 stages, each tile in "
               "turn, setmaxnreg 240 / 24; hd 128 2 consumers, 128-key "
               "tiles, 3 stages; hd 64 3 consumers, 64-key tiles, 4 stages, "
               "setmaxnreg 160 / 24; hd 64 and 128 issue tile i + 1's Q K^T "
               "with tile i's P V and run the softmax under them, take 64 "
               "rows a block where S G <= 64 and split the keys into parts "
               "merged by flash_merge_kernel where few blocks walk a long "
               "range (flash_plan); fp32: flash_fwd_kernel on the CUDA "
               "cores",
        build=build, tflops=per_prefill("flops") / (k6_prefill_ms * 1e-3) / 1e12,
        bound_share=per_prefill("bound_ms") / k6_prefill_ms,
        bound_ms=per_prefill("bound_ms"),
        bound_by=max(path, key=lambda r: r["bound_ms"])["bound_by"],
        fp32_alu_ms=per_prefill("fp32_alu_ms"), library_ms=lib_prefill_ms,
        library="torch.compile(flex_attention) with a tanh score_mod, a "
                "causal / window block_mask and enable_gqa=True (the same "
                "function), per prefill over the same launches",
        library_max_abs_err=max(r["library_max_abs_err"] for r in path),
        library_tolerance="flash_within_tolerance, as the kernel: bf16 "
                          "2^-7 x |value| + 2^-8 x the p-weighted mean of "
                          "|v| (its bf16 softmax weights) + 1e-4",
        yardstick="torch.nn.functional.scaled_dot_product_attention("
                  "is_causal=True, enable_gqa=True) on the global layer's "
                  "inputs against the kernel with cap=None (no softcap: not "
                  "the same function)",
        yardstick_ms=y_l, yardstick_kernel_ms=y_k,
        yardstick_max_abs_diff=y_diff,
        prefill_share=k6_prefill_ms / 1e3 / serve["prefill_s"],
        serving=serve, shapes=path, ragged=ragged,
        row_rms_controls=controls, serve_shapes=gqa_cases,
        prefix_shapes=prefix_cases, encdec_shapes=encdec_cases,
        split_shapes=split_cases,
        hybrid_shapes=[hybrid_case])


def lm_peak_reckoning(cfg, weight_bytes: int, b: int, positions: int,
                      max_len: int) -> dict:
    """A serving run's device peak, reckoned before it runs: the weights,
    the fp32 copy of the embedding that the unembedding makes, the
    prefill's fp32 logits (every position), the cache twice (``lm_serve_run``
    holds one while a timed prefill makes another) and a layer's widest
    fp32 temporaries. The cache: k and v (int8 with bf16 scales, or the
    weights' type, 2 bytes); whisper's also the cross K/V of encoder_seq
    frames; mamba2's the fp32 SSM states and the conv tails; the hybrid's
    rings of min(window, max_len) slots, RG-LRU states and conv tails. The
    temporaries: three (B, positions, ff) for an MLP (whisper: over the
    encoder's frames), three (E, B·C, ff) for the experts, three (B, chunks,
    heads, Q, Q) and eight (B, positions, d_inner) for mamba2's SSD, eight
    (B, positions, lru_width) for the RG-LRU scan if wider."""
    vp, d = cfg.padded_vocab, cfg.d_model
    kv = 2 * cfg.num_layers * b * max_len * cfg.kv_heads * cfg.head_dim
    cache = kv + kv // cfg.head_dim * 2 if cfg.kv_cache_dtype == "int8" \
        else kv * 2
    act = 3 * 4 * b * positions * cfg.d_ff
    if cfg.family == "encdec":
        cache += 2 * 2 * cfg.num_layers * b * cfg.encoder_seq * cfg.kv_heads \
            * cfg.head_dim
        act = 3 * 4 * b * max(positions, cfg.encoder_seq) * cfg.d_ff
    elif cfg.family == "ssm":
        d_in = cfg.expand * d
        h, n = cfg.ssm_heads, cfg.ssm_state
        q = min(cfg.ssm_chunk, positions)
        chunks = -(-positions // q)
        cache = cfg.num_layers * b * (d_in * n * 4 + (cfg.conv_width - 1)
                                      * (d_in + 2 * n) * 2)
        act = 3 * 4 * b * chunks * h * q * q + 8 * 4 * b * positions * d_in
    elif cfg.family == "hybrid":
        from repro_torch.models.rglru import block_kinds

        kinds = block_kinds(cfg)
        w = cfg.lru_width or d
        ring = min(cfg.sliding_window or max_len, max_len)
        cache = kinds.count("attn") * 2 * b * ring * cfg.kv_heads \
            * cfg.head_dim * 2 + kinds.count("rec") * b * w \
            * (4 + (cfg.conv_width - 1) * 2)
        act = max(act, 8 * 4 * b * positions * w)
    if cfg.family == "moe":
        cap = max(1, int(positions * cfg.top_k / cfg.num_experts
                         * cfg.moe_capacity_factor))
        act = 3 * 4 * max(cfg.num_experts * b * cap * cfg.d_ff,
                          b * positions * cfg.dense_residual_ff)
    parts = dict(weights=weight_bytes, embed_fp32=vp * d * 4,
                 logits_fp32=b * positions * vp * 4, kv_cache=cache,
                 kv_cache_held=cache, activations=act)
    parts["total"] = sum(parts.values())
    return parts


def reckon_line(parts: dict) -> str:
    return ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in parts.items())


def teacher_forced(torch, model, batch, toks, max_len: int, backend: str):
    """Last-position logits of the prefill and of every decode step, fed
    ``toks`` (the kernel path's greedy tokens), with ``backend`` for the
    prefill's attention: (B, steps + 1, V)."""
    model.attn_backend = backend
    try:
        logits, cache = model.prefill(batch, max_len)
        rows = [logits[:, -1].clone()]
        del logits
        for i in range(toks.shape[1]):
            lg, cache = model.decode_step(cache, toks[:, i:i + 1])
            rows.append(lg[:, -1])
    finally:
        model.attn_backend = "kernel"
    return torch.stack(rows, dim=1)


def lm_serve_run(torch, model, cfg, batch, steps: int, max_len: int, fa,
                 greedy_generate, held: int, reckoned: dict,
                 launches: int = None, hold_reckoning: bool = False) -> dict:
    """One model's main path: ``greedy_generate`` with K6's counter set to
    0 just before it and read just after (``launches`` of them; default
    one a layer of the prefill), then
    prefill seconds, decode ms per token and the whole generation (medians
    of 3 after a warm-up), ``torch.profiler`` over one prefill and one
    decode step, and the run's own peak against the reckoned one (with
    ``hold_reckoning``, within ``PEAK_RECKON_SLACK`` of it)."""
    b = batch["tokens"].shape[0]
    positions = batch["tokens"].shape[1] + (
        batch["patches"].shape[1] if "patches" in batch else 0)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    toks = greedy_generate(model, cfg, batch, steps=steps, max_len=max_len)
    toks_host = toks.cpu()
    first_s = time.perf_counter() - t0
    want = cfg.num_layers if launches is None else launches
    launches = fa.LAUNCHES["flash_attention"]
    print(f"first greedy_generate {first_s:.3f} s; flash_attention launches "
          f"{launches}; tokens (first sequence) {toks_host[0].tolist()}")
    check(launches == want,
          f"{launches} flash_attention launches = {want} in one "
          f"greedy_generate")
    check(tuple(toks.shape) == (b, steps) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"tokens {tuple(toks.shape)} in "
                                           f"[0, vocab)")

    def timed(fn, reps=3):
        fn()  # warm-up
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    def prefill_only():
        logits, _ = model.prefill(batch, max_len)
        del logits

    logits, cache = model.prefill(batch, max_len)
    check(tuple(logits.shape) == (b, positions, cfg.padded_vocab)
          and cache["pos"] == positions,
          f"prefill logits {tuple(logits.shape)} over all {positions} "
          f"positions, cache pos {cache['pos']}")
    del logits
    tok0 = toks[:, :1]

    def decode_only():
        cache["pos"] = positions
        tok = tok0
        for _ in range(steps):
            lg, _ = model.decode_step(cache, tok)
            tok = torch.argmax(lg[:, -1:], dim=-1)

    def one_decode_step():
        cache["pos"] = positions
        model.decode_step(cache, tok0)

    prefill_s = timed(prefill_only)
    decode_s = timed(decode_only)
    generate_s = timed(lambda: greedy_generate(model, cfg, batch, steps=steps,
                                               max_len=max_len))
    pre, dec, gen_s = (statistics.median(x) for x in
                       (prefill_s, decode_s, generate_s))
    ms_per_token = dec / steps * 1e3
    print(f"prefill seconds {[round(x, 4) for x in prefill_s]} (median "
          f"{pre:.4f}; {b * positions / pre:.0f} prefill positions/s)")
    print(f"decode ms per token {[round(x / steps * 1e3, 3) for x in decode_s]}"
          f" (median {ms_per_token:.3f}; {b / (dec / steps):.1f} generated "
          f"tokens/s over the batch while decoding)")
    print(f"greedy_generate seconds {[round(x, 4) for x in generate_s]} "
          f"(median {gen_s:.4f}; {b * steps / gen_s:.2f} generated tokens/s "
          f"end to end, prefill included)")
    prof = {"prefill": device_profile(torch, prefill_only),
            "decode step": device_profile(torch, one_decode_step)}
    for what, rec in prof.items():
        if rec["kernels"] == 0:
            print(f"profile of one {what}: the profiler recorded no device "
                  f"time (idle share not measured)")
            continue
        top = sorted(rec["by_name"].items(), key=lambda kv: -kv[1])[:6]
        print(f"profile of one {what} (torch.profiler): wall "
              f"{rec['wall_s'] * 1e3:.3f} ms, device busy "
              f"{rec['busy_s'] * 1e3:.3f} ms over {rec['kernels']} kernels and "
              f"copies, idle share {rec['idle_share']:.3f}; top: "
              + "; ".join(f"{n[:60]} {t * 1e3:.3f} ms" for n, t in top))
    del cache
    peak = torch.cuda.max_memory_allocated() - held
    print(f"own peak {peak / 2**30:.2f} GiB against the reckoned "
          f"{reckoned['total'] / 2**30:.2f} GiB; {peak_memory(torch, held)}")
    check(peak < DEVICE_PEAK_LIMIT,
          f"own peak {peak / 2**30:.2f} GiB < {DEVICE_PEAK_LIMIT / 2**30:.0f} GiB")
    if hold_reckoning:
        check(peak <= PEAK_RECKON_SLACK * reckoned["total"],
              f"own peak {peak / 2**30:.2f} GiB within {PEAK_RECKON_SLACK} x "
              f"the reckoned {reckoned['total'] / 2**30:.2f} GiB")
    k6 = sum(t for n, t in prof["prefill"]["by_name"].items()
             if "flash_fwd" in n)
    return dict(launches=launches, toks=toks, prefill_s=pre,
                decode_ms_per_token=ms_per_token, generate_s=gen_s,
                own_peak_gib=peak / 2**30,
                reckoned_peak_gib=reckoned["total"] / 2**30,
                prefill_device_busy_s=prof["prefill"]["busy_s"],
                prefill_k6_device_s=k6,
                prefill_idle_share=prof["prefill"]["idle_share"],
                decode_step_device_busy_s=prof["decode step"]["busy_s"],
                decode_step_device_ops=prof["decode step"]["kernels"],
                decode_step_idle_share=prof["decode step"]["idle_share"],
                prefill_top=sorted(prof["prefill"]["by_name"].items(),
                                   key=lambda kv: -kv[1])[:6])


def contract_held_calls(torch, fa, kernel_call, calls: list):
    """``kernel_call`` (the model's K6 entry) with each call's output held
    to K6's contract against the plain version on the call's own inputs:
    ``flash_within_tolerance`` and, for 16-bit inputs, ``flash_row_rms``
    within ``ROW_RMS_BOUND``; appends (within, max |Δ|, max row RMS, its
    bound) to ``calls``."""
    def held(q, k, v, **kw):
        out = kernel_call(q, k, v, **kw)
        kw.pop("backend", None)
        ok, err = fa.flash_within_tolerance(
            out, fa.flash_attention_ref(q, k, v, **kw), q, k, v, **kw)
        rms, bound = 0.0, 0.0
        if q.dtype != torch.float32:
            rms = float(fa.flash_row_rms(out, q, k, v, **kw).max())
            bound = fa.ROW_RMS_BOUND[q.dtype]
        calls.append((ok and rms <= bound, err, rms, bound))
        return out
    return held


def p_rounded_attention(torch, q, k, v, *, window=None, cap=None,
                        prefix_len=0, causal=True, backend="chunked",
                        straight_through=False):
    """The model's prefill attention (``layers.attention`` with positions
    ``arange``) as the plain arithmetic with K6's one extra rounding, the
    softmax weights rounded to bf16's 8 significant bits before ·v
    (``rounded_weight_attention``)."""
    from repro_torch.models.layers import NO_WINDOW

    window = None if window is None or window >= NO_WINDOW else window
    return rounded_weight_attention(torch, q, k, v, window, cap, 8, causal,
                                    prefix_len, straight_through)


def forced_against_plain(torch, model, batch, toks, max_len: int, fa,
                         tol, label: str, floor_chunk: int = 128,
                         floor_factor=None, launches: int = None) -> dict:
    """The kernel path teacher-forced on its greedy tokens against the
    chunked plain attention (last-position logits of the prefill and of
    every decode step): every K6 call of the kernel run within K6's
    contract on its own inputs (``contract_held_calls``); max |Δ| within
    ``tol``; and the greedy tokens equal wherever the plain path's top-2
    margin exceeds ``MARGIN_FACTOR`` × that |Δ|. Beside it the plain path
    against itself with ``floor_chunk``-key chunks in place of 1024 (the
    bf16 model's rounding floor). With ``floor_factor``, the limit is that
    factor times the larger of this floor and a second one: the plain path
    with K6's rounding of the softmax weights against the plain path. The
    kernel run launches K6 ``launches`` times (default: one a layer of the
    prefill)."""
    from repro_torch.models import layers as L

    steps = toks.shape[1]
    fa.reset_launch_counts()
    kernel_call, calls = L.flash_attention, []
    L.flash_attention = contract_held_calls(torch, fa, kernel_call, calls)
    try:
        k_rows = teacher_forced(torch, model, batch, toks, max_len, "kernel")
    finally:
        L.flash_attention = kernel_call
    launches = model.cfg.num_layers if launches is None else launches
    check(fa.LAUNCHES["flash_attention"] == launches,
          f"{label}: teacher-forced kernel run, {launches} launches")
    print(f"{label}, each K6 call of the teacher-forced run against the "
          f"plain version on its own inputs: max |Δ| "
          f"{max(c[1] for c in calls):.6f}, row RMS max "
          f"{max(c[2] for c in calls):.4e} (bound {calls[0][3]:.4e})")
    check(len(calls) == launches and all(c[0] for c in calls),
          f"{label}: all {len(calls)} K6 calls of the run within "
          f"flash_within_tolerance and flash_row_rms on the model's inputs")
    check(torch.equal(torch.argmax(k_rows[:, :steps], dim=-1), toks),
          f"{label}: the kernel path's teacher-forced argmaxes are its greedy "
          f"tokens")
    fa.reset_launch_counts()
    p_rows = teacher_forced(torch, model, batch, toks, max_len, "chunked")
    check(fa.LAUNCHES["flash_attention"] == 0,
          f"{label}: the plain run launches no flash_attention")
    chunk_1024 = L.attention
    L.attention = functools.partial(chunk_1024, chunk=floor_chunk)
    try:
        floor = float((teacher_forced(torch, model, batch, toks, max_len,
                                      "chunked") - p_rows).abs().max())
    finally:
        L.attention = chunk_1024
    check(bool(torch.isfinite(k_rows).all() and torch.isfinite(p_rows).all()),
          f"{label}: logits finite on both paths")
    round_floor = None
    if floor_factor is not None:
        L.attention = functools.partial(p_rounded_attention, torch)
        try:
            round_floor = float((teacher_forced(
                torch, model, batch, toks, max_len, "chunked")
                - p_rows).abs().max())
        finally:
            L.attention = chunk_1024
        print(f"{label}: the plain path with the softmax weights rounded to "
              f"bf16 before ·v (K6's one extra rounding) against the plain "
              f"path: {round_floor:.6f}")
        tol = floor_factor * max(floor, round_floor)
    diff = (k_rows - p_rows).abs()
    max_diff = float(diff.max())
    top2 = torch.topk(p_rows[:, :steps], 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    covered = margin > MARGIN_FACTOR * max_diff
    agree = torch.argmax(p_rows[:, :steps], dim=-1) == toks
    print(f"{label}, kernel vs plain attention, last-position logits over "
          f"{steps + 1} positions x {toks.shape[0]}: max |Δ| {max_diff:.6f} "
          f"(per position {[round(float(x), 5) for x in diff.amax(dim=(0, 2))]});"
          f" the plain path against itself with {floor_chunk}-key chunks "
          f"{floor:.6f}; "
          f"logit range [{float(p_rows.min()):.3f}, {float(p_rows.max()):.3f}]")
    print(f"{label}, top-2 margins of the plain path: min "
          f"{float(margin.min()):.5f}, median {float(margin.median()):.5f}; "
          f"{int(covered.sum())} of {covered.numel()} positions covered; "
          f"tokens equal at {int(agree.sum())} of {agree.numel()}")
    check(max_diff <= tol, f"{label}: kernel and plain logits within {tol} "
                           f"(max |Δ| {max_diff:.6f})")
    check(bool(agree[covered].all()),
          f"{label}: greedy tokens equal at all {int(covered.sum())} covered "
          f"positions")
    return dict(logits_max_abs_diff=max_diff, bf16_floor_max_abs_diff=floor,
                p_rounding_floor_max_abs_diff=round_floor,
                k6_calls_max_abs_err=max(c[1] for c in calls),
                k6_calls_row_rms_max=max(c[2] for c in calls),
                covered=int(covered.sum()), positions=covered.numel(),
                tolerance=tol)


def fp32_against_plain(torch, dev, get_model, cfg, batch, max_len: int, fa,
                       positions) -> float:
    """The prefill again with fp32 weights (from seed 0): kernel and plain
    attention compute the same function, so only the order of fp32 sums
    separates them. Returns the max |Δ| over the logits at ``positions``
    and the k and v caches, checked against ``SERVE_FP32_TOL``, with one
    launch a layer."""
    model = get_model(cfg, device=dev, dtype=torch.float32)
    model.init(torch.Generator(device=dev).manual_seed(0))
    batch = {k: x.float() if x.is_floating_point() else x
             for k, x in batch.items()}
    fa.reset_launch_counts()
    runs = []
    for backend in ("kernel", "chunked"):
        model.attn_backend = backend
        logits, cache = model.prefill(batch, max_len)
        runs.append([logits[:, p].clone() for p in positions]
                    + [cache["k"], cache["v"]])
        del logits, cache
    diff = max(float((a - b).abs().max()) for a, b in zip(*runs))
    print(f"fp32 weights, kernel vs plain attention: max |Δ| {diff:.3e} over "
          f"the logits at positions {positions} and the "
          f"{tuple(runs[0][-1].shape)} k and v caches")
    check(fa.LAUNCHES["flash_attention"] == cfg.num_layers,
          "fp32 prefill: one flash_attention launch a layer")
    check(diff <= SERVE_FP32_TOL,
          f"fp32 kernel and plain prefill within {SERVE_FP32_TOL}")
    del model, runs
    drop_model(torch)
    return diff


def new_lm_model(torch, dev, get_model, cfg, dtype):
    """Allocate ``cfg``'s model on the card, uninitialised, after a reset of
    the peak: returns (model, the bytes earlier phases hold, the weights'
    bytes), so the run's peak can be reckoned before the weights are
    drawn."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device=dev, dtype=dtype)
    return model, held, torch.cuda.memory_allocated() - held


def drop_model(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def int8_phase(torch, np, dev, get_config, get_model, greedy_generate,
               fa) -> dict:
    """Phase 3p: qwen1.5-32b with its int8 KV cache, at its published width,
    ``INT8_LAYERS`` of its layers, through K6."""
    from repro_torch.models import layers as L

    full = get_config(INT8_ARCH)
    cfg = full.replace(num_layers=INT8_LAYERS)
    b, s, steps = INT8_BATCH, INT8_PROMPT, INT8_STEPS
    max_len = s + steps + 1
    phase(f"phase 3p: int8 KV cache, serving {INT8_ARCH} ({cfg.num_layers} "
          f"of {full.num_layers} layers, heads {cfg.num_heads}/"
          f"{cfg.kv_heads}), batch {b}, prompt {s}, {steps} greedy tokens")
    check(cfg.kv_cache_dtype == "int8", f"{cfg.name} asks for the int8 cache")
    model, held, weights = new_lm_model(torch, dev, get_model, cfg,
                                        torch.bfloat16)
    reckoned = lm_peak_reckoning(cfg, weights, b, s, max_len)
    print(f"reckoned peak before the run: {reckon_line(reckoned)}")
    check(reckoned["total"] < DEVICE_PEAK_LIMIT,
          f"reckoned peak {reckoned['total'] / 2**30:.2f} GiB < "
          f"{DEVICE_PEAK_LIMIT / 2**30:.0f} GiB")
    t0 = time.perf_counter()
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params:,} parameters ({weights / 2**30:.2f} GiB "
          f"bf16), drawn in {time.perf_counter() - t0:.2f} s")
    check(n_params == cfg.param_count() + 2 * cfg.kv_heads * cfg.head_dim
          * cfg.num_layers + cfg.num_heads * cfg.head_dim * cfg.num_layers
          + (cfg.padded_vocab - cfg.vocab) * cfg.d_model,
          "parameter count = param_count() + the QKV biases and padded vocab")
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev)}
    run = lm_serve_run(torch, model, cfg, batch, steps, max_len, fa,
                       greedy_generate, held, reckoned)

    # the quantizer on the card equals the CPU's, bit for bit, on layer 0's
    # k and v, and the prefill caches exactly those
    _, cache = model.prefill(batch, max_len)
    x = model._embed_tokens(batch["tokens"])
    p0 = model.blocks[0]
    h = L.rmsnorm(p0["ln1"], x, cfg.norm_eps)
    pos = torch.arange(s, device=dev)[None, :]
    k = L.rope(L.dense(p0["attn"]["wk"], h).reshape(
        b, s, cfg.kv_heads, cfg.head_dim), pos, cfg.rope_theta)
    v = L.dense(p0["attn"]["wv"], h).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    for name, t in (("k", k), ("v", v)):
        qc, sc = L.quantize_kv(t)
        qh, sh = L.quantize_kv(t.cpu())
        check(torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh),
              f"quantize_kv of layer 0's {name} {tuple(t.shape)} on the card = "
              f"on the CPU, int8 values and bf16 scales bit for bit")
        check(torch.equal(cache[name][0, :, :s], qc)
              and torch.equal(cache[name + "_scale"][0, :, :s], sc),
              f"the prefill's layer-0 {name} cache holds exactly those")
    del cache, x, h, k, v

    # every cached element within one quantisation step of the bf16 value
    # it stores: each quantize_kv call of a teacher-forced kernel run (every
    # layer of the prefill and of each decode step) is checked as it runs
    quantize = L.quantize_kv
    worst = []

    def checked(t):
        q, scale = quantize(t)
        back = L.dequantize_kv(q, scale, torch.float32)
        worst.append((back - t.float()).abs().div(
            scale.float()[..., None]).amax())
        return q, scale

    L.quantize_kv = checked
    try:
        forced = forced_against_plain(torch, model, batch, run["toks"],
                                      max_len, fa, INT8_LOGIT_TOL, cfg.name)
    finally:
        L.quantize_kv = quantize
    steps_off = float(torch.stack(worst).max())
    want_calls = 3 * 2 * cfg.num_layers * (1 + steps)
    print(f"quantize_kv calls in the three teacher-forced runs {len(worst)} "
          f"(2 a layer of the prefill and of each decode step); the largest "
          f"|q·scale − x| over all of them {steps_off:.4f} quantisation steps")
    check(len(worst) == want_calls and steps_off <= 1.0,
          f"every cached element of all {want_calls} quantisations within "
          f"one step of its bf16 value")
    del model, batch, worst
    drop_model(torch)
    run.pop("toks")
    return dict(run, **forced, arch=cfg.name, quant_steps_off=steps_off,
                layers=cfg.num_layers, full_layers=full.num_layers,
                path=f"{cfg.name} ({cfg.num_layers} of {full.num_layers} "
                     f"layers) greedy_generate, int8 KV cache: batch {b}, "
                     f"prompt {s}, {steps} tokens (one prefill)")


def moe_plain(torch, p, x, cfg, expert_chunk: int):
    """The reference's MoE formula (``repro.models.layers.moe``) written out
    with ``torch.einsum`` in fp32 on the same (bf16) weights and input,
    independent of the port's ``moe``: routing, the one-hot dispatch and
    combine, the expert products ``expert_chunk`` experts at a time (fp32
    copies of that many only), arctic's dense residual. Returns (out fp32,
    aux, idx, keep)."""
    F = torch.nn.functional
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = max(1, int(s * k / e * cfg.moe_capacity_factor))
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gate_vals, idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(idx, e)
    flat = onehot.reshape(b, s * k, e)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = (pos * flat).sum(-1).reshape(b, s, k)
    keep = pos < cap
    oh_e = onehot.float()
    oh_c = F.one_hot(torch.where(keep, pos, cap), cap + 1).float()[..., :cap]
    disp = torch.einsum("bske,bskc->bsec", oh_e, oh_c)
    comb = torch.einsum("bske,bskc,bsk->bsec", oh_e, oh_c, gate_vals)
    ex_in = torch.einsum("bsec,bsd->becd", disp, x.float())
    out = torch.zeros(b, s, d, dtype=torch.float32, device=x.device)
    for e0 in range(0, e, expert_chunk):
        sl = slice(e0, e0 + expert_chunk)
        wi, wg, wo = (p[n][sl].float() for n in ("wi", "wg", "wo"))
        h = torch.einsum("becd,edf->becf", ex_in[:, sl], wi)
        g = torch.einsum("becd,edf->becf", ex_in[:, sl], wg)
        ex_out = torch.einsum("becf,efd->becd", F.silu(g) * h, wo)
        out += torch.einsum("bsec,becd->bsd", comb[:, :, sl], ex_out)
        del wi, wg, wo, h, g, ex_out
    if "dense" in p:
        dm = p["dense"]
        hd = x.float() @ dm["wi"]["w"].float()
        gd = x.float() @ dm["wg"]["w"].float()
        out += (F.silu(gd) * hd) @ dm["wo"]["w"].float()
    density = flat.float().mean(dim=(0, 1))
    aux = e * torch.sum(density * probs.mean(dim=(0, 1)))
    return out, aux, idx, keep


def moe_phase(torch, np, dev, get_config, get_model, greedy_generate, fa,
              flush) -> list:
    """Phase 3q: arctic-480b and dbrx-132b at their published widths, cut in
    depth to fit one card, through K6; one full-width ``moe`` layer held
    against the plain one-hot formula."""
    from repro_torch.models import layers as L

    out = []
    for arch, layers in MOE_RUNS:
        full = get_config(arch)
        cfg = full.replace(num_layers=layers)
        b, s, steps = MOE_BATCH, MOE_PROMPT, MOE_STEPS
        max_len = s + steps + 1
        cap = max(1, int(s * cfg.top_k / cfg.num_experts
                         * cfg.moe_capacity_factor))
        phase(f"phase 3q: MoE, serving {arch} at its published widths with "
              f"{layers} of {full.num_layers} layers ({cfg.num_experts} "
              f"experts, top-{cfg.top_k}, dense residual "
              f"{cfg.dense_residual}), batch {b}, prompt {s} (capacity {cap}), "
              f"{steps} greedy tokens")
        model, held, weights = new_lm_model(torch, dev, get_model, cfg,
                                            torch.bfloat16)
        reckoned = lm_peak_reckoning(cfg, weights, b, s, max_len)
        print(f"reckoned peak before the run: {reckon_line(reckoned)}")
        check(reckoned["total"] < DEVICE_PEAK_LIMIT,
              f"reckoned peak {reckoned['total'] / 2**30:.2f} GiB < "
              f"{DEVICE_PEAK_LIMIT / 2**30:.0f} GiB")
        t0 = time.perf_counter()
        model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{cfg.name}: {n_params:,} parameters ({weights / 2**30:.2f} GiB "
              f"bf16, the router fp32), drawn in "
              f"{time.perf_counter() - t0:.2f} s (expert stacks "
              f"{L.DRAW_ELEMS // (cfg.d_model * cfg.d_ff)} experts a draw)")
        check(n_params == cfg.param_count()
              + (cfg.padded_vocab - cfg.vocab) * cfg.d_model,
              "parameter count = param_count() + the padded vocab")
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                         device=dev)}
        run = lm_serve_run(torch, model, cfg, batch, steps, max_len, fa,
                           greedy_generate, held, reckoned)
        forced = forced_against_plain(torch, model, batch, run.pop("toks"),
                                      max_len, fa, None, cfg.name,
                                      floor_factor=FLOOR_FACTOR)
        del batch

        # one full-width layer against the plain one-hot formula
        p = model.blocks[0]["moe"]
        x = torch.randn(b, s, cfg.d_model, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3)
                        ).bfloat16()
        r = L.moe_route(p, x, cfg)
        got, aux = L.moe(p, x, cfg)
        want, want_aux, idx, keep = moe_plain(torch, p, x, cfg, 8)
        torch.cuda.synchronize()
        check(r["cap"] == cap and torch.equal(r["idx"], idx)
              and torch.equal(r["keep"], keep),
              f"{arch} moe: the same experts and kept slots as the plain "
              f"formula (capacity {cap}, {int((~keep).sum())} of "
              f"{keep.numel()} slots dropped)")
        err = (got.float() - want)
        rows = err.pow(2).mean(-1).sqrt() / want.pow(2).mean(-1).sqrt()
        print(f"{arch} moe layer ({b}, {s}, {cfg.d_model}) bf16 against the "
              f"plain fp32 formula: row relative RMS error median "
              f"{float(rows.median()):.4e}, max {float(rows.max()):.4e} "
              f"(bound {MOE_ROW_RMS_TOL:.4e}); max |Δ| "
              f"{float(err.abs().max()):.4e} of values up to "
              f"{float(want.abs().max()):.4e}; aux {float(aux):.6f} against "
              f"{float(want_aux):.6f}")
        check(float(rows.max()) <= MOE_ROW_RMS_TOL,
              f"{arch} moe rows within {MOE_ROW_RMS_TOL} relative RMS of the "
              f"plain formula")
        check(abs(float(aux) - float(want_aux)) <= 1e-6 * max(
            1.0, abs(float(want_aux))), f"{arch} moe aux = the plain formula's")
        moe_ms = time_ms(torch, lambda: L.moe(p, x, cfg), 5, flush)
        plain_ms = time_ms(torch, lambda: moe_plain(torch, p, x, cfg, 8), 2,
                           flush)
        bytes_ = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * 2
        print(f"{arch} moe layer: {moe_ms:.4f} ms (reads {bytes_ / 1e9:.2f} GB "
              f"of expert weights: {bytes_ / HBM_BYTES_PER_S * 1e3:.4f} ms at "
              f"the HBM rate); plain fp32 formula {plain_ms:.4f} ms")
        del model, p, x, got, want, r, err, rows
        drop_model(torch)
        out.append(dict(run, **forced, arch=arch, layers=layers,
                        full_layers=full.num_layers, capacity=cap,
                        moe_layer_ms=moe_ms, moe_plain_ms=plain_ms,
                        moe_weight_read_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
                        path=f"{arch} ({layers} of {full.num_layers} layers) "
                             f"greedy_generate: batch {b}, prompt {s}, "
                             f"{steps} tokens (one prefill)"))
    return out


def vlm_phase(torch, np, dev, get_config, get_model, greedy_generate,
              fa) -> dict:
    """Phase 3r: paligemma-3b at its published width and depth, its image
    prefix attended bidirectionally through K6."""
    from repro_torch.models import layers as L

    cfg = get_config(VLM_ARCH)
    b, s, steps, pl = VLM_BATCH, VLM_PROMPT, VLM_STEPS, VLM_PATCHES
    max_len = pl + s + steps + 1
    phase(f"phase 3r: VLM, serving {VLM_ARCH} ({cfg.num_layers} layers, heads "
          f"{cfg.num_heads}/{cfg.kv_heads} x {cfg.head_dim}), batch {b}, "
          f"{pl} patch tokens of width {cfg.vision_dim}, prompt {s}, {steps} "
          f"greedy tokens")
    check(cfg.vision_tokens == pl, f"{pl} patch tokens, as the config's")
    model, held, weights = new_lm_model(torch, dev, get_model, cfg,
                                        torch.bfloat16)
    reckoned = lm_peak_reckoning(cfg, weights, b, pl + s, max_len)
    print(f"reckoned peak before the run: {reckon_line(reckoned)}")
    check(reckoned["total"] < DEVICE_PEAK_LIMIT,
          f"reckoned peak {reckoned['total'] / 2**30:.2f} GiB < "
          f"{DEVICE_PEAK_LIMIT / 2**30:.0f} GiB")
    model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params:,} parameters ({weights / 2**30:.2f} GiB)")
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev),
             "patches": torch.randn(
                 b, pl, cfg.vision_dim, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(2)
             ).bfloat16()}
    kernel_call = L.flash_attention
    prefixes = []

    def spy(*args, **kw):  # what prefix each K6 call of the prefill gets
        prefixes.append(kw.get("prefix_len", 0))
        return kernel_call(*args, **kw)

    L.flash_attention = spy
    try:
        fa.reset_launch_counts()
        model.prefill(batch, max_len)
        torch.cuda.synchronize()
        spied = fa.LAUNCHES["flash_attention"]
    finally:
        L.flash_attention = kernel_call
    check(spied == cfg.num_layers and prefixes == [pl] * cfg.num_layers,
          f"one prefill: {spied} flash_attention launches, each with "
          f"prefix_len {sorted(set(prefixes))}")
    run = lm_serve_run(torch, model, cfg, batch, steps, max_len, fa,
                       greedy_generate, held, reckoned)
    forced = forced_against_plain(torch, model, batch, run.pop("toks"),
                                  max_len, fa, VLM_LOGIT_TOL, cfg.name)
    del model
    drop_model(torch)
    fp32_diff = fp32_against_plain(torch, dev, get_model, cfg, batch, max_len,
                                   fa, [pl - 1, -1])
    return dict(run, **forced, arch=cfg.name, fp32_max_abs_diff=fp32_diff,
                prefix_len=pl,
                path=f"{cfg.name} greedy_generate: batch {b}, {pl} patch "
                     f"tokens (prefix_len {pl}), prompt {s}, {steps} tokens "
                     f"(one prefill)")


def fp32_decode_against_prefill(torch, dev, get_model, cfg, batch) -> float:
    """The model again with fp32 weights (from seed 0): ``decode_step``
    after ``prefill`` of all but the last prompt token against the last
    logits of ``prefill`` of the whole prompt, which holds the state the
    cache carries on the card (whisper's self and cross K/V, mamba2's SSD
    states and conv tails, the hybrid's RG-LRU states, conv tails and
    ring). Returns the max |Δ|, checked against ``SERVE_FP32_TOL``."""
    model = get_model(cfg, device=dev, dtype=torch.float32)
    model.init(torch.Generator(device=dev).manual_seed(0))
    batch = {k: x.float() if x.is_floating_point() else x
             for k, x in batch.items()}
    tokens = batch["tokens"]
    s = tokens.shape[1]
    logits, _ = model.prefill(batch, s + 1)
    want = logits[:, -1].clone()
    del logits
    _, cache = model.prefill(dict(batch, tokens=tokens[:, :-1]), s + 1)
    got, cache = model.decode_step(cache, tokens[:, -1:])
    diff = float((got[:, 0] - want).abs().max())
    print(f"fp32 weights: decode_step after prefill({s - 1}) against "
          f"prefill({s})'s last logits: max |Δ| {diff:.3e} (logits in "
          f"[{float(want.min()):.3f}, {float(want.max()):.3f}])")
    check(bool(torch.isfinite(got).all()) and diff <= SERVE_FP32_TOL,
          f"{cfg.name} fp32: decode after prefill(S-1) = prefill(S) within "
          f"{SERVE_FP32_TOL}")
    del model, cache, got, want
    drop_model(torch)
    return diff


def own_model_phase(torch, np, dev, get_config, get_model, greedy_generate,
                    fa, tag: str, arch: str, b: int, s: int,
                    steps: int) -> dict:
    """Phases 3s–3u: a family with a model of its own (whisper-medium's
    ``WhisperModel``, mamba2-780m's ``MambaLM``, recurrentgemma-9b's
    ``GriffinLM``) at its published width, its depth cut as ``SERVE_CUTS``
    says, bf16 weights from seed 0: ``greedy_generate`` (``lm_serve_run``, its peak within the
    reckoning), K6's launches (whisper: each encoder layer, and a decoder
    layer's self- and cross-attention in the prefill, its cross-attention
    in each decode step; the hybrid: each local-attention block of the
    prefill; mamba2: none), teacher-forced against the chunked plain
    attention where K6 runs, and the fp32 decode-against-prefill check."""
    full = get_config(arch)
    cfg = full.replace(**SERVE_CUTS[arch])
    max_len = s + steps + 1
    model, held, weights = new_lm_model(torch, dev, get_model, cfg,
                                        torch.bfloat16)
    if cfg.family == "encdec":
        shape = (f"{cfg.encoder_layers} + {cfg.num_layers} layers, d "
                 f"{cfg.d_model}, heads {cfg.num_heads} x {cfg.head_dim}, "
                 f"{cfg.encoder_seq} frames")
        per_prefill = cfg.encoder_layers + 2 * cfg.num_layers
        per_step = cfg.num_layers
    elif cfg.family == "ssm":
        shape = (f"{cfg.num_layers} layers, d {cfg.d_model}, {model.h} SSM "
                 f"heads of {model.p}, state {model.n}, chunk {cfg.ssm_chunk}")
        per_prefill = per_step = 0
    else:
        shape = (f"{cfg.num_layers} layers ({model.kinds.count('rec')} "
                 f"recurrent, {model.kinds.count('attn')} local attention), "
                 f"d {cfg.d_model}, MQA {cfg.num_heads}/{cfg.kv_heads} x "
                 f"{cfg.head_dim}, window {cfg.sliding_window}")
        per_prefill, per_step = model.kinds.count("attn"), 0
    phase(f"phase {tag}: serving {arch} ({shape}; cut from "
          f"{full.num_layers} layers), batch {b}, prompt {s}, {steps} greedy "
          f"tokens")
    reckoned = lm_peak_reckoning(cfg, weights, b, s, max_len)
    print(f"reckoned peak before the run: {reckon_line(reckoned)}")
    check(reckoned["total"] < DEVICE_PEAK_LIMIT,
          f"reckoned peak {reckoned['total'] / 2**30:.2f} GiB < "
          f"{DEVICE_PEAK_LIMIT / 2**30:.0f} GiB")
    t0 = time.perf_counter()
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name} ({type(model).__name__}): {n_params:,} parameters "
          f"({weights / 2**30:.2f} GiB), drawn in "
          f"{time.perf_counter() - t0:.2f} s; ModelConfig.param_count() "
          f"{cfg.param_count():,}")
    # what param_count() leaves out: the padded vocab rows; whisper's
    # position table, its decoder's cross-attention norms and the encoder's
    # final norm; mamba2's dt_bias and the d_model more of its gate norm
    # (d_inner = 2·d_model wide, counted as d_model)
    from repro_torch.models.encdec import MAX_DECODE_POS
    d, n_l = cfg.d_model, cfg.num_layers
    extra = {"encdec": MAX_DECODE_POS * d + n_l * d + d,
             "ssm": n_l * (cfg.ssm_heads + d)}.get(cfg.family)
    if extra is not None:
        check(n_params == cfg.param_count() + extra
              + (cfg.padded_vocab - cfg.vocab) * d,
              f"parameter count = param_count() + {extra:,} left out + the "
              f"padded vocab")
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            b, cfg.encoder_seq, cfg.d_model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(2)).bfloat16()
    launches = per_prefill + steps * per_step
    run = lm_serve_run(torch, model, cfg, batch, steps, max_len, fa,
                       greedy_generate, held, reckoned, launches=launches,
                       hold_reckoning=True)
    toks = run.pop("toks")
    forced = {}
    if per_prefill:
        forced = forced_against_plain(torch, model, batch, toks, max_len, fa,
                                      None, cfg.name, floor_factor=FLOOR_FACTOR,
                                      launches=launches)
    del model
    drop_model(torch)
    fp32 = fp32_decode_against_prefill(torch, dev, get_model, cfg, batch)
    return dict(run, **forced, arch=cfg.name, family=cfg.family,
                n_params=n_params, fp32_decode_max_abs_diff=fp32,
                launches_per_prefill=per_prefill,
                launches_per_decode_step=per_step,
                path=f"{cfg.name} greedy_generate: batch {b}, prompt {s}, "
                     f"{steps} tokens (one prefill"
                     + (f", {steps} decode steps" if per_step else "") + ")")


# -- phases 4d, 3v and 3w: training -------------------------------------------

# phase 3v: gemma2-2b trains at its published width: batch 8 x 2048 tokens
# in its config's 8 microbatches (1 x 2048 each), 4 steps through
# ElasticTrainer, a checkpoint after step 2. Its depth is cut to 6 of 26
# layers (3 local and 3 global) for the script's time (the whole run took
# 1030.3 s of its 1200 s at 26 layers, 3v 121 s of it, and 1232.5 s at 12
# layers on a slower host, 3v 73 s of it; NVIDIA H100 80GB HBM3, 700.00 W);
# 3x(a) and 3y(a) follow the same cut
TRAIN_ARCH = "gemma2-2b"
TRAIN_CUT = dict(num_layers=6)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_SAVE_EVERY = 8, 2048, 4, 2
# phase 4d: dq, dk and dv through FlashAttention against autograd through
# the chunked scan on the same inputs. The backward IS that scan's
# gradient, so only fp32 summation order may separate them
GRAD_RTOL = 1e-5
# phase 3v: the first step after a restore against the uninterrupted run's:
# the embedding's backward adds its rows with atomics, so bits may differ
RESUME_LOSS_RTOL = 1e-3
# phase 3w: one training step each at published widths, depths cut:
# (arch, config fields replaced, batch, tokens a sequence)
TRAIN_CUT_RUNS = (
    ("whisper-medium", dict(encoder_layers=2, num_layers=2), 2, 64),
    ("paligemma-3b", dict(num_layers=2), 2, 256),
    ("recurrentgemma-9b", dict(num_layers=3), 1, 4096))
# the kernel step's loss and gradient against the chunked plain step's
# (1024-key chunks): this factor times the largest distance of five plain
# variants from the plain step (64-, 128-, 256- and 512-key chunks, and
# K6's rounding of the softmax weights to bf16). A single floor is one
# sample of a rounding noise: whisper-medium's loss floors ranged from
# 2.37e-4 to 7.88e-4 over these variants and its grad-norm floors from
# 1.15e-4 to 9.37e-4, against the kernel's 6.08e-4 and 2.12e-3, while the
# gradient vectors' distances (5.42e-3 to 5.82e-3, the kernel's 5.81e-3)
# barely move; so the grad norm is held through the gradient vector
# (NVIDIA H100 80GB HBM3, 700.00 W)
TRAIN_FLOOR_FACTOR = 2.0
TRAIN_FLOOR_CHUNKS = (64, 128, 256, 512)


def grad_rel_err(torch, got, want) -> float:
    """max over the tensors of max |got - want| / max |want|, in fp32."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def flash_grad_bound_ms(np, q, k, causal: bool, window, prefix: int = 0,
                        backward_only: bool = False) -> dict:
    """Least time for attention's forward and backward (FA2's count: the
    forward's two products, 4·hd flops a pair a head, and the backward's
    five, 10·hd) at the bf16 tensor-core rate, or reading q, k, v, the
    output and its gradient and writing dq, dk, dv (and the output) once;
    with ``backward_only`` the backward alone."""
    b, s, hq, hd = q.shape
    t = k.shape[1]
    pairs = flash_pairs(np, s, t, causal, window, prefix)
    flops = (10 if backward_only else 14) * hd * pairs * b * hq
    t_ops = flops / TENSOR_OPS_PER_S * 1e3
    t_bytes = (3 * q.numel() + 2 * k.numel() * 2) * q.element_size() \
        / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, pairs=pairs,
                fp32_alu_ms=flops / ALU_FLOPS_PER_S * 1e3)


def sdpa_mask(torch, s: int, t: int, causal: bool, window, prefix: int, dev):
    """The (S, T) boolean mask of K6's rule, for SDPA (None: every key)."""
    if not causal and window is None and not prefix:
        return None
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(t, device=dev)[None, :]
    ok = (j <= i) if causal else torch.ones(s, t, dtype=torch.bool,
                                             device=dev)
    if window is not None:
        ok = ok & (i - j < window)
    return ok | (j < prefix) if prefix else ok


def flash_grad_phase(torch, np, dev, fa, flush, get_config) -> dict:
    """Phase 4d: K6's gradient on the card. At each K6 shape of the
    training paths (3v's gemma2-2b microbatch, 3w's paligemma-3b,
    whisper-medium and recurrentgemma-9b ones), bf16: ``attention(
    backend="kernel")`` on inputs that require grad runs K6 once (through
    ``FlashAttention``; its output within K6's contract), and its dq, dk
    and dv equal autograd through ``backend="chunked"`` within
    ``GRAD_RTOL``; at the softcapped shapes a planted fault (the softcap's
    derivative left out of the chunked scan) must read above that limit.
    The backward and the forward + backward are timed (CUDA events, L2
    flushed) beside their bounds, the chunked path's forward + backward,
    ``torch.compile(flex_attention)`` forward + backward with the same
    ``score_mod`` and mask where there is a softcap (gemma2-2b's global
    layer; static shapes; the local layer's window passes its 2048 keys, so
    it is the same function), and SDPA forward + backward (with the mask as
    ``attn_mask`` where there is one) where there is none: neither library
    call is on the path. The backward's own peak memory is read
    beside 4·B·S·T·Hq·4 bytes."""
    phase("phase 4d: K6's gradient (FlashAttention) against the chunked "
          "scan's, at the training paths' shapes")
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    from repro_torch.models.transformer import _layer_windows

    # a fresh compile cache and static shapes: after phase 4c's dozen
    # compiles of flex_attention, these calls ran 20-30x slower than when 4d
    # ran alone (42.12 against 1.28 ms forward + backward at gemma2-2b's
    # local layer; NVIDIA H100 80GB HBM3, 700.00 W)
    torch._dynamo.reset()
    flex = torch.compile(flex_attention, dynamic=False)
    train_cfg = get_config(TRAIN_ARCH).replace(**TRAIN_CUT)
    windows = _layer_windows(train_cfg)

    def grads(out, ins, dout, retain=False):
        return torch.autograd.grad(out, ins, dout, retain_graph=retain)

    def case(label, b, s, t, hq, hkv, hd, causal, window, cap, prefix,
             per_step, library=True):
        gen = torch.Generator(device=dev).manual_seed(s + t + hq + hd + prefix)
        bf = torch.bfloat16
        q0 = torch.randn(b, s, hq, hd, generator=gen, device=dev).to(bf)
        k0, v0 = (torch.randn(b, t, hkv, hd, generator=gen,
                              device=dev).to(bf) for _ in range(2))
        dout = torch.randn(b, s, hq, hd, generator=gen, device=dev).to(bf)
        kw = dict(causal=causal, window=L.NO_WINDOW if window is None
                  else window, cap=cap, prefix_len=prefix)
        fkw = dict(causal=causal, window=window, cap=cap, prefix_len=prefix)
        ins = [x.clone().requires_grad_() for x in (q0, k0, v0)]
        pins = [x.clone().requires_grad_() for x in (q0, k0, v0)]
        fa.reset_launch_counts()
        out = L.attention(*ins, backend="kernel", **kw)
        check(fa.LAUNCHES["flash_attention"] == 1 and out.requires_grad,
              f"{label}: one K6 launch through FlashAttention, the output "
              f"carries a graph")
        ok, f_err = fa.flash_within_tolerance(
            out.detach(), fa.flash_attention_ref(q0, k0, v0, **fkw), q0, k0,
            v0, **fkw)
        rms = float(fa.flash_row_rms(out.detach(), q0, k0, v0, **fkw).max())
        check(ok and rms <= fa.ROW_RMS_BOUND[bf],
              f"{label}: K6's forward within flash_within_tolerance (max |Δ| "
              f"{f_err}) and flash_row_rms ({rms:.3e})")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        g_k = grads(out, ins, dout)
        torch.cuda.synchronize()
        bwd_peak = torch.cuda.max_memory_allocated() - base
        check(fa.LAUNCHES["flash_attention"] == 1,
              f"{label}: the backward launches no K6")
        g_c = grads(L.attention(*pins, backend="chunked", **kw), pins, dout)
        err = grad_rel_err(torch, g_k, g_c)
        print(f"  {label}: dq, dk, dv against autograd through the chunked "
              f"scan: max |Δ| / max |g| {err:.3e} (limit {GRAD_RTOL})",
              flush=True)
        check(err <= GRAD_RTOL and all(bool(torch.isfinite(g).all())
                                       for g in g_k),
              f"{label}: FlashAttention's gradients equal the chunked "
              f"path's within {GRAD_RTOL}")
        fault = None
        if cap is not None:
            softcap = L.softcap
            L.softcap = lambda x, c: x + (softcap(x, c) - x).detach()
            try:
                g_f = grads(L.attention(*pins, backend="chunked", **kw), pins,
                            dout)
            finally:
                L.softcap = softcap
            fault = grad_rel_err(torch, g_f, g_c)
            del g_f
            print(f"  {label}: planted fault, the softcap's derivative left "
                  f"out: {fault:.3e}", flush=True)
            check(fault > GRAD_RTOL, f"{label}: the planted fault reads "
                                     f"above {GRAD_RTOL}")
        del g_k, g_c, out

        def fwd_bwd():
            return grads(L.attention(*ins, backend="kernel", **kw), ins, dout)

        held_out = L.attention(*ins, backend="kernel", **kw)
        bwd_ms = time_ms(torch, lambda: grads(held_out, ins, dout, True), 5,
                         flush)
        del held_out
        fwd_ms = time_ms(torch, lambda: L.attention(*ins, backend="kernel",
                                                    **kw), 5, flush)
        fb_ms = time_ms(torch, fwd_bwd, 5, flush)
        plain_ms = time_ms(torch, lambda: grads(L.attention(
            *pins, backend="chunked", **kw), pins, dout), 3, flush)
        bound = flash_grad_bound_ms(np, q0, k0, causal, window, prefix)
        bwd_bound = flash_grad_bound_ms(np, q0, k0, causal, window, prefix,
                                        backward_only=True)
        chunks = -(-t // 1024)
        reckoned = 4 * b * s * min(t, 1024) * chunks * hq * 4
        rec = dict(label=label, shape=[b, s, hq, hkv, hd], keys=t,
                   causal=causal, window=window, cap=cap, prefix_len=prefix,
                   launches_per_step=per_step, forward_max_abs_err=f_err,
                   forward_row_rms_max=rms, grad_rel_err=err,
                   planted_fault_rel_err=fault, forward_ms=fwd_ms,
                   backward_ms=bwd_ms, fwd_bwd_ms=fb_ms,
                   plain_fwd_bwd_ms=plain_ms, fwd_bwd_bound_ms=bound[
                       "bound_ms"], fwd_bwd_bound_by=bound["bound_by"],
                   backward_bound_ms=bwd_bound["bound_ms"],
                   backward_fp32_alu_ms=bwd_bound["fp32_alu_ms"],
                   backward_peak_gib=bwd_peak / 2**30,
                   backward_reckoned_gib=reckoned / 2**30)
        line = (f"  {label}: backward {bwd_ms:.4f} ms (bound "
                f"{bwd_bound['bound_ms']:.4f} ms at the bf16 tensor rate, "
                f"{bwd_bound['fp32_alu_ms']:.4f} ms at the fp32 CUDA-core "
                f"rate the chunked scan runs at), forward {fwd_ms:.4f} ms, "
                f"forward + backward {fb_ms:.4f} ms (bound "
                f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}); chunked "
                f"forward + backward {plain_ms:.4f} ms; backward peak "
                f"{bwd_peak / 2**30:.3f} GiB against 4·B·S·T·Hq·4 = "
                f"{reckoned / 2**30:.3f} GiB")
        if library:
            lib, _ = flex_library(torch, flex, create_block_mask, ins[0],
                                  ins[1], ins[2], window, cap, prefix,
                                  causal)
            t0 = time.perf_counter()
            l_g = grads(lib(), ins, dout)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            l_err = grad_rel_err(torch, l_g, grads(L.attention(
                *pins, backend="chunked", **kw), pins, dout))
            del l_g
            l_ms = time_ms(torch, lambda: grads(lib(), ins, dout), 5, flush)
            rec.update(flex_fwd_bwd_ms=l_ms, flex_first_call_s=first_s,
                       flex_grad_rel_err=l_err)
            line += (f"; flex_attention forward + backward {l_ms:.4f} ms "
                     f"(first call {first_s:.1f} s with its compile; its "
                     f"gradients {l_err:.3e} from the chunked path's)")
        if cap is None:
            mask = sdpa_mask(torch, s, t, causal, window, prefix, dev)

            def sdpa():
                o = F.scaled_dot_product_attention(
                    ins[0].transpose(1, 2), ins[1].transpose(1, 2),
                    ins[2].transpose(1, 2), attn_mask=mask,
                    enable_gqa=True).transpose(1, 2)
                return grads(o, ins, dout)

            s_err = grad_rel_err(torch, sdpa(), grads(L.attention(
                *pins, backend="chunked", **kw), pins, dout))
            s_ms = time_ms(torch, sdpa, 5, flush)
            rec.update(sdpa_fwd_bwd_ms=s_ms, sdpa_grad_rel_err=s_err)
            line += (f"; scaled_dot_product_attention forward + backward "
                     f"{s_ms:.4f} ms (gradients {s_err:.3e} from the "
                     f"chunked path's)")
        print(line, flush=True)
        return rec

    n_local = sum(w == train_cfg.sliding_window for w in windows)
    # the forward and the remat's recompute, each microbatch
    per = 2 * train_cfg.microbatches
    cases = [
        case(f"{TRAIN_ARCH} local layer (1, {TRAIN_SEQ}, 8/4, 256), window "
             f"4096, cap 50", 1, TRAIN_SEQ, TRAIN_SEQ, 8, 4, 256, True, 4096,
             50.0, 0, n_local * per, library=False),
        case(f"{TRAIN_ARCH} global layer (1, {TRAIN_SEQ}, 8/4, 256), cap 50",
             1, TRAIN_SEQ, TRAIN_SEQ, 8, 4, 256, True, None, 50.0, 0,
             (len(windows) - n_local) * per)]
    for arch, cut, b, s in TRAIN_CUT_RUNS:
        cfg = get_config(arch)
        per_cut = 2 * min(cfg.microbatches, b)
        if cfg.family == "encdec":
            t = cfg.encoder_seq
            cases += [
                # no mask and no softcap: SDPA computes the same function,
                # so flex_attention's compiles are spared here
                case(f"{arch} encoder (1, {t}, 16/16, 64), not causal", 1, t,
                     t, 16, 16, 64, False, None, None, 0,
                     cut["encoder_layers"] * per_cut, library=False),
                case(f"{arch} self (1, {s}, 16/16, 64)", 1, s, s, 16, 16, 64,
                     True, None, None, 0, cut["num_layers"] * per_cut,
                     library=False),
                case(f"{arch} cross (1, {s} vs {t}, 16/16, 64), not causal",
                     1, s, t, 16, 16, 64, False, None, None, 0,
                     cut["num_layers"] * per_cut, library=False)]
        elif cfg.family == "vlm":
            p = cfg.vision_tokens
            cases.append(case(
                f"{arch} layer (1, {p + s}, 8/1, 256), prefix {p}", 1, p + s,
                p + s, 8, 1, 256, True, None, None, p,
                cut["num_layers"] * per_cut, library=False))
        else:
            cases.append(case(
                f"{arch} local layer (1, {s}, 16/1, 256), window 2048", 1, s,
                s, 16, 1, 256, True, 2048, None, 0, per_cut, library=False))
    return dict(shapes=cases,
                max_grad_rel_err=max(c["grad_rel_err"] for c in cases),
                tolerance=f"dq, dk, dv: max |Δ| / max |g| <= {GRAD_RTOL} "
                          f"against autograd through the chunked scan")


def train_peak_reckoning(cfg, n_params: int, weight_bytes: int,
                         moment_bytes: int, micro_b: int, seq: int,
                         micro: int) -> dict:
    """A training step's device peak, reckoned before it runs: the
    weights, the two AdamW moments, the fp32 gradient accumulators (with
    more than one microbatch), one microbatch's gradients in the weights'
    type, the unembedding's fp32 copy of the embedding and its fp32
    gradient, four fp32 (B, S, padded vocab) planes (the logits, their
    softcap, its tanh and their gradient), each block's bf16 input kept by
    remat, and one block's recompute temporaries (three (B, S, ff) fp32
    and the chunked attention backward's 4·B·S·T·Hq·4 bytes)."""
    vp, d = cfg.padded_vocab, cfg.d_model
    tokens = micro_b * seq
    parts = dict(
        weights=weight_bytes, moments=2 * n_params * moment_bytes,
        accumulators=4 * n_params if micro > 1 else 0,
        grads=weight_bytes, embed_fp32=vp * d * 4, embed_grad_fp32=vp * d * 4,
        logits_fp32=4 * tokens * vp * 4,
        remat_inputs=cfg.num_layers * tokens * d * 2,
        block_temporaries=3 * tokens * cfg.d_ff * 4
        + 4 * tokens * seq * cfg.num_heads * 4)
    parts["total"] = sum(parts.values())
    return parts


def train_phase(torch, np, dev, get_config, get_model, fa) -> dict:
    """Phase 3v: gemma2-2b trains at its published width (its depth cut
    by ``TRAIN_CUT``) through
    the port's entry points: ``init_train_state`` (bf16 weights from seed
    0, the config's moment dtype), ``make_train_step`` (the config's 8
    microbatches, fp32 accumulators, remat on), ``SyntheticDataset`` batches
    of 8 x 2048 tokens, 4 steps through ``ElasticTrainer`` with a
    checkpoint after step 2. Checks: every loss finite; every trainable
    leaf's gradient finite with a norm above 0 (read at each step's
    ``adamw_update``); 96 K6 launches a step (6 layers x 8 microbatches x
    the forward and the remat's recompute); the run's own peak within
    ``PEAK_RECKON_SLACK`` of the reckoning. Measures the step's seconds
    (median of steps 1-3), tokens/s, the model-FLOP rate against 989
    TFLOP/s. Then a fresh model resumes from the checkpoint: its params
    and moments bit-equal to the saved ones, its step-3 loss within
    ``RESUME_LOSS_RTOL`` of the uninterrupted step 3's, that step under
    ``torch.profiler`` for the device's idle share."""
    import shutil

    from repro_torch.models.transformer import _layer_windows
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import flatten_state
    from repro_torch.train.data import SyntheticDataConfig, SyntheticDataset
    from repro_torch.train.elastic import ElasticTrainer
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config(TRAIN_ARCH).replace(**TRAIN_CUT)
    micro = cfg.microbatches
    phase(f"phase 3v: training {TRAIN_ARCH} at full width "
          f"({cfg.num_layers} of {get_config(TRAIN_ARCH).num_layers} layers, "
          f"d {cfg.d_model}, vocab {cfg.vocab}), "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ} in {micro} microbatches, "
          f"{TRAIN_STEPS} steps, a checkpoint after step {TRAIN_SAVE_EVERY}")
    check(cfg.remat and cfg.grad_accum_dtype == "float32",
          "remat on, fp32 gradient accumulators")
    moment_dtype = (torch.bfloat16 if cfg.adam_dtype == "bfloat16"
                    else torch.float32)
    opt_cfg = AdamWConfig(peak_lr=3e-4, warmup_steps=1,
                          stable_steps=TRAIN_STEPS, decay_steps=1,
                          moment_dtype=moment_dtype)
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t_phase = time.perf_counter()
    model, held, weights = new_lm_model(torch, dev, get_model, cfg,
                                        torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    reckoned = train_peak_reckoning(
        cfg, n_params, weights, torch.empty((), dtype=moment_dtype)
        .element_size(), TRAIN_BATCH // micro, TRAIN_SEQ, micro)
    print(f"reckoned peak before the run: {reckon_line(reckoned)}")
    check(reckoned["total"] < DEVICE_PEAK_LIMIT,
          f"reckoned peak {reckoned['total'] / 2**30:.2f} GiB < "
          f"{DEVICE_PEAK_LIMIT / 2**30:.0f} GiB")
    per_step = 2 * micro * len(_layer_windows(cfg))
    leaf_stats = []
    update = ts.adamw_update

    def reading_update(grads, state, params, cfg_):
        # each leaf's gradient norm and finiteness, read at the update
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             for g in grads.values()])
        leaf_stats.append((list(grads), norms))
        return update(grads, state, params, cfg_)

    def batches(start):
        ds = SyntheticDataset(cfg, SyntheticDataConfig(TRAIN_BATCH,
                                                       TRAIN_SEQ + 1), start)
        while True:
            yield {k: torch.from_numpy(v).to(dev) for k, v in next(ds).items()}

    def run(model, trainer, start, stop, on_step=None, on_resume=None,
            profile=None):
        def fresh():
            opt = ts.init_train_state(
                model, cfg, opt_cfg, torch.Generator(device=dev).manual_seed(0))
            return {"params": model.state_dict(), "opt": opt}

        state, first = trainer.resume_or_init(fresh)
        check(first == start, f"the trainer starts at step {start} "
                              f"({time.perf_counter() - t_phase:.2f} s into "
                              f"the phase)")
        if on_resume is not None:
            on_resume(state)
        step_fn = ts.make_train_step(model, cfg, opt_cfg)
        out = []
        feed = batches(start)
        for step in range(start, stop):
            batch = next(feed)
            fa.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if profile is None:
                opt, m = step_fn(state["opt"], batch)
            else:  # this step under torch.profiler, once
                res = []
                profile.update(device_profile(torch, lambda: res.append(
                    step_fn(state["opt"], batch)), host_ops=False))
                (opt, m), profile = res[0], None
            loss = float(m["loss"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            state = {"params": model.state_dict(), "opt": opt}
            out.append(dict(step=step, loss=loss, seconds=secs,
                            grad_norm=float(m["grad_norm"]),
                            lr=float(m["lr"]),
                            launches=fa.LAUNCHES["flash_attention"]))
            print(f"  step {step}: loss {loss:.5f}, grad norm "
                  f"{out[-1]['grad_norm']:.4f}, lr {out[-1]['lr']:.3e}, "
                  f"{secs:.3f} s, {out[-1]['launches']} K6 launches",
                  flush=True)
            if on_step is not None:
                on_step(step, state)
            t0 = time.perf_counter()
            trainer.maybe_save(step, state)
            if step > 0 and step % TRAIN_SAVE_EVERY == 0:
                print(f"  checkpoint of step {step} saved in "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
        return out, state, step_fn

    saved = {}

    def bits(t):
        return t.detach().cpu().reshape(-1).view(torch.uint8)

    def keep_saved(step, state):
        if step == TRAIN_SAVE_EVERY:  # the host copy the restore is held to
            saved.update({k: bits(t.detach().to("cpu", copy=True))
                          for k, t in flatten_state(state).items()})

    ts.adamw_update = reading_update
    try:
        trainer = ElasticTrainer(str(ckpt_dir), save_every=TRAIN_SAVE_EVERY,
                                 keep=1)
        steps, state, _ = run(model, trainer, 0, TRAIN_STEPS, keep_saved)
    finally:
        ts.adamw_update = update
    peak = torch.cuda.max_memory_allocated() - held
    names = dict(model.named_parameters())
    check(all(np.isfinite(s["loss"]) for s in steps),
          f"all {TRAIN_STEPS} losses finite")
    check(all(s["launches"] == per_step for s in steps),
          f"{per_step} K6 launches a step ({cfg.num_layers} layers x {micro} "
          f"microbatches x 2)")
    for keys, norms in leaf_stats:
        norms = norms.cpu()
        check(keys == list(names) and bool(torch.isfinite(norms).all())
              and bool((norms > 0).all()),
              f"every one of the {len(keys)} trainable leaves has a finite "
              f"gradient with a norm above 0 (smallest "
              f"{float(norms.min()):.3e})")
    med = statistics.median(s["seconds"] for s in steps[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    embed = cfg.padded_vocab * cfg.d_model
    pairs = sum(flash_pairs(np, TRAIN_SEQ, TRAIN_SEQ, True,
                            None if w >= 1 << 30 else w)
                for w in _layer_windows(cfg))
    # 6·N·tokens, the remat's second forward of the blocks (2·N_blocks), and
    # attention's products (forward, backward, recompute: 16·hd a pair a head)
    flops = (6 * n_params + 2 * (n_params - embed)) * tokens \
        + 16 * cfg.head_dim * cfg.num_heads * pairs * TRAIN_BATCH
    rate = flops / med / 1e12
    print(f"{TRAIN_ARCH} training: first step {steps[0]['seconds']:.3f} s, "
          f"median of steps 1-{TRAIN_STEPS - 1} {med:.3f} s; "
          f"{tokens / med:,.0f} tokens/s; {flops / 1e15:.4f} PFLOP a step "
          f"(6·N·T + the remat's 2·N_blocks·T + attention), {rate:.1f} "
          f"TFLOP/s = {rate / (TENSOR_OPS_PER_S / 1e12) * 100:.1f} % of "
          f"{TENSOR_OPS_PER_S / 1e12:.0f}; own peak {peak / 2**30:.2f} GiB "
          f"against the reckoned {reckoned['total'] / 2**30:.2f} GiB")
    check(peak <= PEAK_RECKON_SLACK * reckoned["total"],
          f"own peak {peak / 2**30:.2f} GiB within {PEAK_RECKON_SLACK}x the "
          f"reckoned {reckoned['total'] / 2**30:.2f} GiB")
    step3 = steps[TRAIN_SAVE_EVERY + 1]["loss"]
    del model, state, names, leaf_stats
    drop_model(torch)

    # a fresh model resumes from the checkpoint of step TRAIN_SAVE_EVERY
    model = get_model(cfg, device=dev, dtype=torch.bfloat16)
    trainer = ElasticTrainer(str(ckpt_dir), save_every=TRAIN_SAVE_EVERY,
                             keep=1)
    def check_bits(state):
        flat = flatten_state(state)
        check(list(flat) == list(saved) and all(
            torch.equal(bits(t), saved[k]) for k, t in flat.items()),
            f"the restored params and moments ({len(flat)} leaves, step "
            f"{int(state['opt'].step)}) are bit-equal to the saved ones")

    restore_s = []

    def check_restored(state):
        restore_s.append(time.perf_counter() - t0)
        check_bits(state)

    t0 = time.perf_counter()
    first = TRAIN_SAVE_EVERY + 1
    prof = {}
    resumed, state, step_fn = run(model, trainer, first, first + 1,
                                  on_resume=check_restored, profile=prof)
    saved.clear()
    rel = abs(resumed[0]["loss"] - step3) / abs(step3)
    print(f"a fresh model resumed from {ckpt_dir.relative_to(ROOT)} in "
          f"{restore_s[0]:.2f} s (its weights drawn, then overwritten): step "
          f"{first} loss {resumed[0]['loss']:.6f} against the uninterrupted "
          f"{step3:.6f} (relative {rel:.2e})")
    check(rel <= RESUME_LOSS_RTOL,
          f"the resumed step {first} loss within {RESUME_LOSS_RTOL} of the "
          f"uninterrupted run's")
    print(f"the resumed step under torch.profiler: {profile_line(prof)}; "
          f"its device busy time over the unprofiled median step: idle "
          f"share {1 - prof['busy_s'] / med:.3f}")

    # yardsticks of later work: the fp32 unembedding with the loss, forward
    # and backward, at one microbatch; one step without remat
    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(5)
    mb = TRAIN_BATCH // micro
    x = torch.randn(mb, TRAIN_SEQ, cfg.d_model, generator=gen, device=dev
                    ).bfloat16().requires_grad_()
    labels = torch.randint(0, cfg.vocab, (mb, TRAIN_SEQ), generator=gen,
                           device=dev)

    def unembed_loss():
        logits = L.unembed(x, model.embed, cfg.vocab, cfg.final_softcap)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0] \
            - torch.logsumexp(logits, dim=-1)
        return torch.autograd.grad(-ll.mean(), (x, model.embed))

    unembed_ms = time_ms(torch, unembed_loss, 3, torch.empty(
        64 << 20, dtype=torch.uint8, device=dev))
    del x, labels
    model.cfg = cfg.replace(remat=False)
    batch = next(batches(first + 1))
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = step_fn(state["opt"], batch)
    check(np.isfinite(float(m["loss"])), "the step without remat: loss finite")
    no_remat_s = time.perf_counter() - t0
    no_remat_peak = torch.cuda.max_memory_allocated() - held
    model.cfg = cfg
    check(fa.LAUNCHES["flash_attention"] == per_step // 2,
          f"without remat, {per_step // 2} K6 launches a step")
    print(f"yardsticks: the fp32 unembedding and the loss, forward and "
          f"backward, {unembed_ms:.2f} ms a microbatch ({unembed_ms * micro:.1f}"
          f" ms a step); a step without remat {no_remat_s:.3f} s against "
          f"{med:.3f} s with it (the run's peak since the phase began "
          f"{no_remat_peak / 2**30:.2f} GiB)")
    del model, state, step_fn
    drop_model(torch)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(
        arch=TRAIN_ARCH, path=f"{TRAIN_ARCH} ({cfg.num_layers} layers) "
        f"make_train_step: batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {micro} microbatches, remat",
        n_params=n_params, steps=steps, step_s=med, tokens_per_s=tokens / med,
        flops_per_step=flops, tflops=rate,
        flop_share=rate * 1e12 / TENSOR_OPS_PER_S, own_peak_gib=peak / 2**30,
        reckoned=reckoned, launches_per_step=per_step,
        resumed_loss=resumed[0]["loss"], uninterrupted_loss=step3,
        resume_rel_diff=rel, restore_s=restore_s[0],
        unembed_loss_ms_per_microbatch=unembed_ms,
        no_remat_step_s=no_remat_s, profile=dict(
            wall_s=prof["wall_s"], busy_s=prof["busy_s"],
            kernels=prof["kernels"], idle_share=prof["idle_share"],
            idle_share_of_median_step=1 - prof["busy_s"] / med))


def train_cut_phase(torch, np, dev, get_config, get_model, fa) -> list:
    """Phase 3w: one training step each of whisper-medium (2 + 2 layers),
    paligemma-3b (2 layers, its 256-patch prefix) and recurrentgemma-9b
    (one block group: rec, rec, local attention) at their published
    widths, bf16, through ``init_train_state`` and ``make_train_step``
    (the config's microbatches, at most the batch), each step from the same
    seed-0 weights: with ``attn_backend="kernel"`` (K6 through
    ``FlashAttention``; its launches counted, every call held to K6's
    contract on its own inputs), with the chunked plain attention, and
    with five variants of the plain step that are as good a bf16 model
    (``TRAIN_FLOOR_VARIANTS``: other key chunks, and the softmax weights
    rounded to bf16 before ·v, K6's one extra rounding, the gradient passed
    straight through). Each variant's distance from the plain step is a
    floor; the kernel step's loss must lie within ``TRAIN_FLOOR_FACTOR`` x
    the largest loss floor of the plain step's, its gradient vector within
    that factor x the largest gradient floor (‖g - g_plain‖ over
    ‖g_plain‖), and so its global grad norm (|‖g‖ - ‖g_plain‖| <= ‖g -
    g_plain‖); every gradient leaf finite, its norm above 0."""
    import importlib

    from repro_torch.models import layers as L

    from repro_torch.train import train_step as ts
    from repro_torch.train.data import SyntheticDataConfig, make_batch
    from repro_torch.train.optimizer import AdamWConfig

    # the module that FlashAttention.forward launches K6 from (the package
    # exports a function of the same name)
    fmod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    variants = {f"{c}-key chunks": functools.partial(L.attention, chunk=c)
                for c in TRAIN_FLOOR_CHUNKS}
    variants["softmax weights rounded to bf16"] = functools.partial(
        p_rounded_attention, torch, straight_through=True)
    out, pending = [], []  # the limits are checked once every model ran
    for arch, cut, b, s in TRAIN_CUT_RUNS:
        cfg = get_config(arch).replace(**cut)
        micro = min(cfg.microbatches, b)
        model, held, weights = new_lm_model(torch, dev, get_model, cfg,
                                            torch.bfloat16)
        if cfg.family == "encdec":
            layers, attn = (f"{cfg.encoder_layers} + {cfg.num_layers} layers",
                            cfg.encoder_layers + 2 * cfg.num_layers)
        elif cfg.family == "hybrid":
            layers, attn = (f"one group: {model.kinds}",
                            model.kinds.count("attn"))
        else:
            layers, attn = f"{cfg.num_layers} layers", cfg.num_layers
        want = 2 * micro * attn
        phase(f"phase 3w: one training step of {arch} ({layers}, d "
              f"{cfg.d_model}), batch {b} x {s} in {micro} microbatches, "
              f"kernel against chunked attention")
        opt_cfg = AdamWConfig(moment_dtype=torch.bfloat16)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, SyntheticDataConfig(b, s + 1), 0).items()}
        plain = {}
        update = ts.adamw_update

        def step(backend, attention_fn=None, hold_calls=None):
            seen = {}

            def reading_update(grads, state, params, cfg_):
                seen["norms"] = torch.stack([torch.linalg.vector_norm(
                    g, dtype=torch.float32) for g in grads.values()]).cpu()
                flat = torch.cat([g.float().reshape(-1)
                                  for g in grads.values()])
                if "g" in plain:
                    seen["dist"] = float((flat - plain["g"]).norm()
                                         / plain["g"].norm())
                else:
                    plain["g"] = flat
                del flat
                return update(grads, state, params, cfg_)

            model.attn_backend = backend
            opt = ts.init_train_state(
                model, cfg, opt_cfg, torch.Generator(device=dev).manual_seed(0))
            attention, kernel = L.attention, fmod.flash_attention_kernel
            if attention_fn is not None:
                L.attention = attention_fn
            if hold_calls is not None:
                fmod.flash_attention_kernel = contract_held_calls(
                    torch, fa, kernel, hold_calls)
            ts.adamw_update = reading_update
            try:
                fa.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, m = ts.make_train_step(model, cfg, opt_cfg,
                                          microbatches=micro)(opt, batch)
                r = dict(loss=float(m["loss"]), grad_norm=float(
                    m["grad_norm"]), launches=fa.LAUNCHES["flash_attention"])
                torch.cuda.synchronize()
                r["seconds"] = time.perf_counter() - t0
            finally:
                L.attention, fmod.flash_attention_kernel = attention, kernel
                ts.adamw_update = update
            norms = seen.pop("norms")
            r["leaves_ok"] = bool(torch.isfinite(norms).all()
                                  and (norms > 0).all())
            r["leaves"] = norms.numel()
            return dict(r, **seen)

        p = step("chunked")
        calls = []
        k = step("kernel", hold_calls=calls)
        floors = {name: step("chunked", fn) for name, fn in variants.items()}
        plain.clear()
        peak = torch.cuda.max_memory_allocated() - held
        check(k["launches"] == want and p["launches"] == 0
              and all(f["launches"] == 0 for f in floors.values()),
              f"{arch}: {want} K6 launches in the kernel step ({micro} "
              f"microbatches x {attn} attention calls x 2 with the "
              f"recompute), none in the plain steps")
        print(f"  {arch}, each K6 call of the kernel step against the plain "
              f"version on its own inputs: max |Δ| "
              f"{max(c[1] for c in calls):.6f}, row RMS max "
              f"{max(c[2] for c in calls):.4e} (bound {calls[0][3]:.4e})",
              flush=True)
        check(len(calls) == want and all(c[0] for c in calls),
              f"{arch}: all {len(calls)} K6 calls of the kernel step within "
              f"flash_within_tolerance and flash_row_rms on their inputs")
        check(all(r["leaves_ok"] for r in [p, k, *floors.values()]),
              f"{arch}: every one of the {k['leaves']} leaves has a finite "
              f"gradient with a norm above 0 on every path")
        for name, f in floors.items():
            print(f"  {arch} plain step with {name}: loss {f['loss']:.6f}, "
                  f"grad norm {f['grad_norm']:.6f}, gradient "
                  f"{f['dist']:.4e} from the plain step's", flush=True)
        loss_floor = max(abs(f["loss"] - p["loss"]) for f in floors.values())
        grad_floor = max(f["dist"] for f in floors.values())
        limits = dict(loss=TRAIN_FLOOR_FACTOR * loss_floor,
                      dist=TRAIN_FLOOR_FACTOR * grad_floor,
                      grad_norm=TRAIN_FLOOR_FACTOR * grad_floor
                      * p["grad_norm"])
        diffs = dict(loss=abs(k["loss"] - p["loss"]), dist=k["dist"],
                     grad_norm=abs(k["grad_norm"] - p["grad_norm"]))
        print(f"  {arch}: kernel loss {k['loss']:.6f} against plain "
              f"{p['loss']:.6f} (|Δ| {diffs['loss']:.3e}, limit "
              f"{limits['loss']:.3e}); grad norm {k['grad_norm']:.6f} against "
              f"{p['grad_norm']:.6f} (|Δ| {diffs['grad_norm']:.3e}, limit "
              f"{limits['grad_norm']:.3e}); gradient {diffs['dist']:.4e} from "
              f"the plain step's (limit {limits['dist']:.4e}); step seconds "
              f"kernel {k['seconds']:.3f}, plain {p['seconds']:.3f}; own peak "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for key, what in (("loss", "loss"), ("dist", "gradient vector"),
                          ("grad_norm", "global grad norm")):
            pending.append((np.isfinite(k[key if key != "dist" else "loss"])
                            and diffs[key] <= limits[key],
                            f"{arch}: the kernel step's {what} within "
                            f"{TRAIN_FLOOR_FACTOR} x the plain path's largest "
                            f"floor of the plain step's"))
        out.append(dict(arch=arch, cut=cut, batch=b, seq=s,
                        microbatches=micro, launches=k["launches"],
                        own_peak_gib=peak / 2**30, kernel=k, chunked=p,
                        floors=floors, diffs=diffs, limits=limits,
                        k6_calls_max_abs_err=max(c[1] for c in calls),
                        k6_calls_row_rms_max=max(c[2] for c in calls)))
        del model, batch
        drop_model(torch)
    for ok, what in pending:
        check(ok, what)
    return out

# -- phase 3x: sharded training ------------------------------------------------

# (a): a world-1 NCCL group, gemma2-2b as phase 3v trains it, one step on a
# (1, 1) mesh. Limit, stated before the first run: the step's loss and
# grad norm within this of 3v's step 0 (the same weights, batch and
# kernels; the embedding's backward adds its rows with atomics, as 3v's
# resume check says)
SHARDED_WORLD1_RTOL = 1e-3
# (b): SHARDED_TRAIN_RANKS gloo ranks on cuda:0, one step of each run on
# each of its meshes (data, model) in turn: (arch, config fields replaced,
# weights' dtype, batch, tokens a sequence, microbatches, meshes). Both at
# published widths, cut to 2 layers. qwen1.5-32b runs on (2, 2) only, where
# its fsdp splits the weights over "data" (on (1, 4) its step is the tensor
# parallelism gemma2-2b shows there; the CPU test holds both meshes), for
# the script's time
SHARDED_TRAIN_RANKS = 4
SHARDED_TRAIN_MESHES = ((2, 2), (1, 4))
# bf16 weights and one microbatch: gloo stages every collective through
# pinned host memory, and the first try (gemma2-2b in fp32, 2
# microbatches) took a one-H100 host past its 96 GiB of host memory; the
# microbatched path is held on the CPU
SHARDED_TRAIN_RUNS = (
    ("gemma2-2b", dict(num_layers=2), "bfloat16", 2, 512, 1,
     SHARDED_TRAIN_MESHES),
    ("qwen1.5-32b", dict(num_layers=2), "bfloat16", 2, 256, 1, ((2, 2),)))
# Limits, stated before the first run, of a sharded step against rank 0's
# one-process step on the card. fp32 weights: the reference's own
# sharded-step tolerances (loss and grad norm rtol 1e-4, parameters rtol
# 5e-4 / atol 5e-5). bf16 weights: each rank's bf16 gradient is rounded
# before the sum over the data ranks, so the loss within 1e-3, the grad
# norm within 2⁻⁶ (two bf16 steps). A parameter: Adam's first step moves
# each element by at most lr·(1 + wd·|p|), and where a near-zero gradient
# has other signs in the two steps they move apart, each then rounded to
# bf16: so within 2·lr·(1 + wd·m) + 2⁻⁷·m (one bf16 step), m the larger
# of the two values' magnitudes. A first limit of lr + 2⁻⁸·|p|, half a
# bf16 step at the bottom of a binade and one move, was too tight: CPU runs
# of the reduced gemma2-2b found elements two bf16 steps apart, moved one
# each way, and one moved from 3.2e-4 to 2.4e-5 and to 6.3e-4 (so m, not
# the one-process value). That limit holds whatever the gradients are, so
# the parameters show only that the update ran. The gradient itself is
# held leaf by leaf through the first moment, mu = (1 - b1)·clip·g after
# the first step: each gathered leaf within ‖mu - mu₁‖ <= SHARDED_MU_TOL
# ‖mu₁‖ of rank 0's one-process mu₁, stated before the first run on the
# card. bf16 gradients summed in another order (partial sums rounded on
# each rank before the sum over the model or data ranks) moved the reduced
# configs' leaves by up to 8.1e-3 of their norm on 4 gloo CPU ranks (the
# embedding on (1, 4); 1.3e-2 of a leaf's largest |mu| element-wise, so an
# element-wise limit of 2⁻⁶ would sit at the noise), while a gradient
# kept on the wrong model block, planted in _GatherParam.backward, moved
# every split leaf by 1.39 to 1.51 of its norm. The first run on the card
# read at most 1.013e-2 (qwen1.5-32b on (2, 2); NVIDIA H100 80GB HBM3,
# 700.00 W)
SHARDED_FP32_RTOL, SHARDED_PARAM_RTOL, SHARDED_PARAM_ATOL = 1e-4, 5e-4, 5e-5
SHARDED_BF16_LOSS_RTOL, SHARDED_BF16_GNORM_RTOL = 1e-3, 2.0 ** -6
SHARDED_MU_TOL = 2.0 ** -5
SHARDED_LR = 3e-4
# ef_psum at one gemma2-2b layer's gradient leaves, rank r's inputs N(0,
# 1e-6) drawn from seed 100 + r
EF_ARCH, EF_STD = "gemma2-2b", 1e-3


def sharded_train_reckoning(cfg, sizes: dict, w_bytes: int, m_bytes: int,
                            rows: int, seq: int, micro: int) -> dict:
    """One rank's device peak in phase 3x(b), reckoned before the weights
    are drawn, from the sanitised specs of ``cfg``'s model on the meta
    device on a mesh of ``sizes``: at the start, the full weights drawn on
    the rank beside its shards; in the step, the shards of the weights and
    the two moments, this rank's gradients (and, with more than one
    microbatch, accumulators in ``cfg.grad_accum_dtype``), the gathered
    weights outside the blocks and their gradient, the unembedding's fp32
    copy of the embedding and its fp32 gradient (bf16 weights), four fp32
    planes of a microbatch's logits, one block's gathered weights and
    their gradient, each block's input kept by remat, and one block's
    recompute temporaries (three (B, S, ff) fp32, and the chunked attention
    backward's 4·B·S·T·Hq·4 bytes on this rank's heads)."""
    import torch
    from torch import nn

    from repro_torch.models.registry import get_model
    from repro_torch.train import sharding

    model = get_model(cfg, device="meta", dtype=torch.float32)
    specs = sharding.param_specs(model, fsdp=cfg.fsdp)
    local = full = top = 0
    block = {}
    for name, p in model.named_parameters():
        n = p.numel()
        full += n
        for entry in sharding.sanitize_spec(specs[name], p.shape, sizes):
            for a in (() if entry is None else entry
                      if isinstance(entry, tuple) else (entry,)):
                n //= sizes.get(a, 1)
        local += n
        owner = name.split(".")
        if owner[0] in ("blocks", "layers", "enc_layers", "dec_layers"):
            key = ".".join(owner[:2])
            block[key] = block.get(key, 0) + p.numel()
        else:
            top += p.numel()
    del model
    acc = 2 if cfg.grad_accum_dtype == "bfloat16" else 4
    tokens = rows // micro * seq
    vd = cfg.padded_vocab * cfg.d_model
    hl = cfg.num_heads // sizes.get("model", 1) \
        if cfg.num_heads % sizes.get("model", 1) == 0 else cfg.num_heads
    parts = dict(
        init_full=full * w_bytes,
        weights=local * w_bytes, moments=2 * local * m_bytes,
        grads=local * w_bytes, accumulators=local * acc if micro > 1 else 0,
        top_gathered=2 * top * w_bytes,
        embed_fp32=0 if w_bytes == 4 else 2 * vd * 4,
        logits_fp32=4 * tokens * cfg.padded_vocab * 4,
        block_gathered=2 * max(block.values()) * w_bytes,
        remat_inputs=cfg.num_layers * tokens * cfg.d_model * w_bytes,
        block_temporaries=3 * tokens * cfg.d_ff * 4
        + 4 * (rows // micro) * seq * seq * hl * 4)
    step = sum(v for k, v in parts.items() if k != "init_full")
    parts["total"] = max(step, parts["init_full"] + parts["weights"])
    return parts


def param_limit_check(torch, got, want, fp32: bool, wd: float,
                      chunk: int = 1 << 26) -> tuple:
    """(the largest |got - want|, the count of elements past 3x(b)'s limit)
    of one parameter, in chunks of ``chunk`` elements, so the fp32
    temporaries stay small beside four ranks' steps on one card."""
    worst, bad = 0.0, 0
    g_all, w_all = got.reshape(-1), want.reshape(-1)
    for i in range(0, w_all.numel(), chunk):
        w, g = w_all[i:i + chunk].float(), g_all[i:i + chunk].float()
        d = (g - w).abs()
        if fp32:
            lim = SHARDED_PARAM_ATOL + SHARDED_PARAM_RTOL * w.abs()
        else:  # m: the larger of the two magnitudes
            mag = torch.maximum(w.abs(), g.abs())
            lim = 2 * SHARDED_LR * (1 + wd * mag) + 2.0 ** -7 * mag
        worst = max(worst, float(d.max()))
        bad += int((d > lim).sum())
    return worst, bad


def leaf_distance(got, want, chunk: int = 1 << 26) -> tuple:
    """(‖got - want‖ / ‖want‖, max |got - want| / max |want|) of one tensor
    in fp32, in chunks of ``chunk`` elements (small temporaries, as
    ``param_limit_check``)."""
    err, scale, d2, w2 = 0.0, 0.0, 0.0, 0.0
    g_all, w_all = got.reshape(-1), want.reshape(-1)
    for i in range(0, w_all.numel(), chunk):
        w, g = w_all[i:i + chunk].float(), g_all[i:i + chunk].float()
        d = g - w
        err = max(err, float(d.abs().max()))
        scale = max(scale, float(w.abs().max()))
        d2 += float(d.double().square().sum())
        w2 += float(w.double().square().sum())
    return ((d2 / w2) ** 0.5 if w2 > 0 else math.inf,
            err / scale if scale > 0 else math.inf)


def sharded_train_rank(rank: int, world: int, store: str, spec: dict) -> None:
    """Phase 3x (b): one of ``world`` gloo ranks on ``cuda:0``, spawned by
    ``sharded_train_phase``. For each run of ``SHARDED_TRAIN_RUNS``,
    every rank, on each of the run's meshes, draws the same weights, shards
    them (``shard_model_``), runs the sharded step under
    ``activation_mesh`` with each of its K6 calls held to K6's contract on
    the call's own inputs (``contract_held_calls``), and keeps its shards
    of the parameters and first moments; then rank 0 runs the one-process
    step on the card, and every rank gathers each kept parameter and first
    moment, which rank 0 holds to its one-process values. Then ``ef_psum``
    over the world at one gemma2-2b layer's gradient sizes. Writes
    ``rank<rank>.json`` to ``spec["out"]``; raises on any fault, which
    fails the phase."""
    import importlib

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.meshctx import activation_mesh, full_value
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train import sharding
    from repro_torch.train.compression import (compress_decompress, ef_init,
                                               ef_psum)
    from repro_torch.train.data import SyntheticDataConfig, make_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import init_train_state, make_train_step

    # the module that FlashAttention.forward launches K6 from
    fmod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = dict(rank=rank, runs=[])
    try:
        for arch, cut, dname, b, s, micro, meshes in spec["runs"]:
            cfg = get_config(arch).replace(**cut)
            dtype = getattr(torch, dname)
            opt_cfg = AdamWConfig(
                peak_lr=SHARDED_LR, warmup_steps=1, stable_steps=1,
                decay_steps=1, moment_dtype=torch.bfloat16
                if cfg.adam_dtype == "bfloat16" else torch.float32)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
                cfg, SyntheticDataConfig(b, s + 1), 0).items()}
            # the sharded steps first, each mesh's parameters and first
            # moments kept as this rank's shards
            kept = []
            for shape in meshes:
                times = {}
                t_part = time.perf_counter()
                mesh = make_local_mesh(shape[1], device_type="cuda")
                gc.collect()
                torch.cuda.empty_cache()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                model = get_model(cfg, device=dev, dtype=dtype)
                model.init(torch.Generator(device=dev).manual_seed(0))
                L.trainable_(model)
                sharding.shard_model_(model, mesh, fsdp=cfg.fsdp)
                params = dict(model.named_parameters())
                opt = adamw_init(params, opt_cfg)
                resident = sharding.resident_bytes(
                    list(params.values()) + list(opt.mu.values())
                    + list(opt.nu.values()))
                step = make_train_step(model, cfg, opt_cfg,
                                       microbatches=micro)
                fa.reset_launch_counts()
                calls = []  # each K6 call held to its contract, as 3w
                kernel = fmod.flash_attention_kernel
                fmod.flash_attention_kernel = contract_held_calls(
                    torch, fa, kernel, calls)
                dist.barrier()
                torch.cuda.synchronize()
                times["build"] = time.perf_counter() - t_part
                t0 = time.perf_counter()
                try:
                    with activation_mesh(mesh):
                        opt, m = step(opt, batch)
                    torch.cuda.synchronize()
                finally:
                    fmod.flash_attention_kernel = kernel
                secs = time.perf_counter() - t0
                launches = fa.LAUNCHES["flash_attention"]
                peak = torch.cuda.max_memory_allocated() - held
                kept.append((params, dict(opt.mu), times, dict(
                    arch=arch, mesh=list(shape), dtype=dname, batch=b,
                    seq=s, microbatches=micro, loss=float(m["loss"]),
                    grad_norm=float(m["grad_norm"]), seconds=secs,
                    k6_launches=launches, peak=peak, resident=resident,
                    k6_calls=len(calls),
                    k6_calls_ok=all(c[0] for c in calls),
                    k6_max_abs_err=max((c[1] for c in calls), default=0.0),
                    k6_row_rms=max((c[2] for c in calls), default=0.0),
                    k6_row_rms_bound=calls[0][3] if calls else 0.0)))
                del model, opt, step, m
                gc.collect()
                torch.cuda.empty_cache()
                dist.barrier()
            # then rank 0's one-process step, while the others hold only
            # their shards
            one, want, want_mu = None, None, None
            if rank == 0:
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                model = get_model(cfg, device=dev, dtype=dtype)
                opt = init_train_state(model, cfg, opt_cfg, torch.Generator(
                    device=dev).manual_seed(0))
                step = make_train_step(model, cfg, opt_cfg,
                                       microbatches=micro)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                opt, m = step(opt, batch)
                torch.cuda.synchronize()
                one = dict(loss=float(m["loss"]),
                           grad_norm=float(m["grad_norm"]),
                           seconds=time.perf_counter() - t0,
                           peak=torch.cuda.max_memory_allocated() - held)
                want = {n: p.detach() for n, p in model.named_parameters()}
                want_mu = dict(opt.mu)
                del model, opt, step, m
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
            # each mesh's parameters and first moments gathered, held by
            # rank 0 to the one-process step's
            for params, mu, times, rec in kept:
                t_part = time.perf_counter()
                worst, bad, equal, total = 0.0, 0, 0, 0
                mu_worst, mu_leaf, mu_max_rel, mu_past = 0.0, None, 0.0, []
                for name, p in params.items():
                    got = full_value(p.detach())
                    got_mu = full_value(mu[name])
                    if rank == 0:
                        w_, b_ = param_limit_check(
                            torch, got, want[name], dtype == torch.float32,
                            opt_cfg.weight_decay)
                        worst, bad = max(worst, w_), bad + b_
                        equal += int(torch.equal(got, want[name]))
                        total += 1
                        dist_, rel = leaf_distance(got_mu, want_mu[name])
                        mu_max_rel = max(mu_max_rel, rel)
                        if dist_ > mu_worst or mu_leaf is None:
                            mu_worst, mu_leaf = dist_, name
                        if not dist_ <= SHARDED_MU_TOL:
                            mu_past.append(dict(leaf=name, distance=dist_))
                    del got, got_mu
                times["check"] = time.perf_counter() - t_part
                release_host_memory(torch)
                out["runs"].append(dict(
                    rec, one_process=one, param_max_abs_err=worst,
                    params_out_of_limit=bad, leaves_bit_equal=equal,
                    leaves=total, mu_worst_distance=mu_worst,
                    mu_worst_leaf=mu_leaf, mu_max_abs_rel=mu_max_rel,
                    mu_past=mu_past, times=times))
                dist.barrier()
            del kept, want, want_mu
            gc.collect()
            torch.cuda.empty_cache()
        # ef_psum over the world at one gemma2-2b layer's gradient sizes
        meta = get_model(get_config(EF_ARCH).replace(num_layers=1),
                         device="meta", dtype=torch.float32)
        shapes = {n: p.shape for n, p in meta.named_parameters()
                  if n.startswith("blocks.0.")}
        del meta

        def draw(r):
            gen = torch.Generator(device=dev).manual_seed(100 + r)
            return {n: torch.randn(sh, generator=gen, device=dev) * EF_STD
                    for n, sh in shapes.items()}

        mine = draw(rank)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deq, res = ef_psum(mine, ef_init(mine))
        torch.cuda.synchronize()
        ef_s = time.perf_counter() - t0
        total = {n: torch.zeros(sh, device=dev) for n, sh in shapes.items()}
        smax = {n: 0.0 for n in shapes}
        for r in range(world):
            g = draw(r)
            for n in shapes:
                total[n] += g[n]
                smax[n] = max(smax[n], float(g[n].abs().max()) / 127)
        cd, _ = compress_decompress(total, ef_init(total))
        worst = dict(psum=0.0, cd=0.0, between=0.0, res=0.0)
        past = []
        for n in shapes:
            s_sum = float(total[n].abs().max()) / 127
            errs = (float((deq[n] - total[n]).abs().max()),
                    float((cd[n] - total[n]).abs().max()),
                    float((deq[n] - cd[n]).abs().max()),
                    float(res[n].abs().max()))
            # the fp32 rounding of q·s and of the sums: a few ulp of the
            # largest value
            ulp = 2.0 ** -21 * world * smax[n] * 127
            bounds = (world * smax[n] / 2, s_sum / 2,
                      world * smax[n] / 2 + s_sum / 2, smax[n] / 2)
            for k, e, lim in zip(worst, errs, bounds):
                worst[k] = max(worst[k], e)
                if e > lim + ulp:
                    past.append(dict(leaf=n, what=k, err=e, bound=lim))
        ok = not past
        digest = [float(deq[n].double().sum()) for n in sorted(shapes)]
        out["ef"] = dict(seconds=ef_s, within_bounds=bool(ok), worst=worst,
                         past=past,
                         digest=digest,
                         elements=sum(math.prod(sh) for sh in
                                      shapes.values()),
                         leaves=len(shapes))
        del mine, deq, res, total, cd
    finally:
        dist.destroy_process_group()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def local_head_k6_case(torch, fa, dev, n: int, window, cap) -> dict:
    """Phase 3x (c): each model rank's local-head K6 call of gemma2-2b's
    layer (1, 2048, 8/4, 256, bf16) for a model axis of ``n`` against the
    same heads of the unsharded call, in this process."""
    from repro_torch.models.meshctx import head_split

    gen = torch.Generator(device=dev).manual_seed(n)
    b, s, hq, hkv, hd = 1, TRAIN_SEQ, 8, 4, 256
    q = torch.randn(b, s, hq, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, s, hkv, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, hkv, hd, generator=gen, device=dev).bfloat16()
    kw = dict(causal=True, window=window, cap=cap)
    whole = fa.flash_attention_kernel(q, k, v, **kw)
    out = dict(n=n, window=window, ranks=[])
    for r in range(n):
        qs, kv = head_split(hq, hkv, n, r)
        idx = torch.tensor(kv, device=dev)
        ql = q[:, :, qs.start:qs.stop].contiguous()
        kl, vl = k.index_select(2, idx), v.index_select(2, idx)
        fa.reset_launch_counts()
        got = fa.flash_attention_kernel(ql, kl, vl, **kw)
        torch.cuda.synchronize()
        want = whole[:, :, qs.start:qs.stop]
        ok, err = fa.flash_within_tolerance(got, want, ql, kl, vl, **kw)
        rows = float(fa.flash_row_rms(got, ql, kl, vl, **kw).max())
        out["ranks"].append(dict(
            rank=r, q_heads=[qs.start, qs.stop], kv_heads=kv, ok=ok,
            max_abs_err=err, row_rms=rows,
            launches=fa.LAUNCHES["flash_attention"],
            bit_equal=bool(torch.equal(got, want))))
    return out


def sharded_train_phase(torch, np, dev, get_config, get_model, fa,
                        train: dict, smi: str) -> dict:
    """Phase 3x: sharded training. (a) gemma2-2b as phase 3v trains it, one
    step on a (1, 1) mesh of a world-1 NCCL group in this process, against
    3v's step 0 (``sharded_world1``); (b) ``SHARDED_TRAIN_RANKS`` gloo
    ranks spawned on cuda:0 (``sharded_gloo_ranks``, ``sharded_train_rank``);
    (c) each rank's local-head K6 call against the unsharded call's heads,
    in this process (``local_head_k6_case``). Returns K6's sharded paths
    and the runs."""
    import shutil

    work = ROOT / "build" / "sharded_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    world1 = sharded_world1(torch, dev, get_config, get_model, fa, train, smi,
                            work)
    gloo = sharded_gloo_ranks(torch, get_config, smi, work)
    local = sharded_local_heads(torch, dev, get_config, fa)
    shutil.rmtree(work, ignore_errors=True)
    return dict(paths=[world1] + gloo["paths"], local_heads=local,
                ranks_s=gloo["ranks_s"], ef=gloo["ef"])


def sharded_world1(torch, dev, get_config, get_model, fa, train: dict,
                   smi: str, work) -> dict:
    """Phase 3x (a): gemma2-2b as phase 3v trains it, one step on a (1, 1)
    mesh of a world-1 NCCL group in this process, against 3v's step 0."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.meshctx import activation_mesh
    from repro_torch.train import sharding
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import SyntheticDataConfig, SyntheticDataset
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    # -- (a): a world-1 NCCL group --------------------------------------------
    cfg = get_config(TRAIN_ARCH).replace(**TRAIN_CUT)
    micro = cfg.microbatches
    phase(f"phase 3x: sharded training, {TRAIN_ARCH} as phase 3v trains it, "
          f"one step on a (1, 1) mesh of a world-1 NCCL group ({smi})")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(work / "nccl-store"), 1), rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1)
        model, held, _ = new_lm_model(torch, dev, get_model, cfg,
                                      torch.bfloat16)
        opt_cfg = AdamWConfig(peak_lr=3e-4, warmup_steps=1,
                              stable_steps=TRAIN_STEPS, decay_steps=1,
                              moment_dtype=torch.bfloat16
                              if cfg.adam_dtype == "bfloat16"
                              else torch.float32)
        model.init(torch.Generator(device=dev).manual_seed(0))
        L.trainable_(model)
        sharding.shard_model_(model, mesh, fsdp=cfg.fsdp)
        opt = adamw_init(dict(model.named_parameters()), opt_cfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
            SyntheticDataset(cfg, SyntheticDataConfig(
                TRAIN_BATCH, TRAIN_SEQ + 1), 0)).items()}
        step = ts.make_train_step(model, cfg, opt_cfg)
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with activation_mesh(mesh):
            opt, m = step(opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = fa.LAUNCHES["flash_attention"]
        peak = torch.cuda.max_memory_allocated() - held
        del model, opt, step, m, batch
    finally:
        dist.destroy_process_group()
    drop_model(torch)
    ref = train["steps"][0]
    rl = abs(loss - ref["loss"]) / abs(ref["loss"])
    rg = abs(gnorm - ref["grad_norm"]) / abs(ref["grad_norm"])
    print(f"(1, 1) mesh: loss {loss:.6f}, grad norm {gnorm:.5f} against 3v's "
          f"step 0 {ref['loss']:.6f}, {ref['grad_norm']:.5f} (relative "
          f"{rl:.2e}, {rg:.2e}); {secs:.3f} s (3v's step 0 "
          f"{ref['seconds']:.3f} s), {launches} K6 launches, own peak "
          f"{peak / 2**30:.2f} GiB (3v's {train['own_peak_gib']:.2f} GiB); "
          f"{smi}")
    check(rl <= SHARDED_WORLD1_RTOL and rg <= SHARDED_WORLD1_RTOL,
          f"the (1, 1) step's loss and grad norm within "
          f"{SHARDED_WORLD1_RTOL} of 3v's step 0")
    check(launches == train["launches_per_step"],
          f"{launches} K6 launches, as 3v's step")
    return dict(path=f"3x(a): {TRAIN_ARCH} ({cfg.num_layers} layers) "
                     f"make_train_step on a (1, 1) "
                     f"mesh, world-1 NCCL, batch {TRAIN_BATCH} x "
                     f"{TRAIN_SEQ} in {micro} microbatches",
                launches=launches, step_s=secs, own_peak_gib=peak / 2**30,
                loss=loss, grad_norm=gnorm, loss_rel=rl, gnorm_rel=rg)


def sharded_gloo_ranks(torch, get_config, smi: str, work) -> dict:
    """Phase 3x (b): ``SHARDED_TRAIN_RANKS`` gloo ranks spawned on cuda:0,
    each run of ``SHARDED_TRAIN_RUNS`` on each of its meshes, held to rank
    0's one-process step, then ``ef_psum``."""
    import torch.multiprocessing as mp

    paths = []
    # -- (b): gloo ranks on cuda:0 --------------------------------------------
    free = torch.cuda.mem_get_info()[0]
    reck = {}
    fits = []  # the card's reckoned peaks, all ranks together
    for arch, cut, dname, b, s, mb, meshes in SHARDED_TRAIN_RUNS:
        rcfg = get_config(arch).replace(**cut)
        wb = torch.empty((), dtype=getattr(torch, dname)).element_size()
        mbytes = 2 if rcfg.adam_dtype == "bfloat16" else 4
        kept = 0  # each rank keeps its shards of weights and mu per mesh
        for shape in meshes:
            sizes = dict(data=shape[0], model=shape[1])
            reck[arch, shape] = sharded_train_reckoning(
                rcfg, sizes, wb, mbytes, b // shape[0], s, mb)
            print(f"  {arch} {shape}: reckoned rank peak "
                  f"{reckon_line(reck[arch, shape])}")
            fits.append(SHARDED_TRAIN_RANKS * (reck[arch, shape]["total"]
                                               + kept))
            kept += reck[arch, shape]["weights"] \
                + reck[arch, shape]["moments"] // 2
        # then rank 0's one-process step beside every rank's kept shards
        full = reck[arch, meshes[0]]["init_full"] // wb
        one = train_peak_reckoning(rcfg, full, full * wb, mbytes, b // mb, s,
                                   mb)
        print(f"  {arch}: reckoned one-process peak {reckon_line(one)}")
        fits.append(one["total"] + SHARDED_TRAIN_RANKS * kept)
    worst_total = max(fits, default=0)
    runs = [(a, c, d, b, s, m, list(ms))
            for a, c, d, b, s, m, ms in SHARDED_TRAIN_RUNS]
    phase(f"phase 3x: {SHARDED_TRAIN_RANKS} gloo ranks on cuda:0, runs "
          f"{runs} "
          f"(the ranks' reckoned peaks {worst_total / 2**30:.2f} GiB together"
          f", {free / 2**30:.2f} GiB free)")
    check(worst_total < min(DEVICE_PEAK_LIMIT, free - (4 << 30)),
          "the ranks' reckoned peaks fit the card")
    spec = dict(out=str(work), runs=SHARDED_TRAIN_RUNS)
    t0 = time.perf_counter()
    procs = mp.start_processes(
        sharded_train_rank, args=(SHARDED_TRAIN_RANKS,
                                  str(work / "gloo-store"), spec),
        nprocs=SHARDED_TRAIN_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    while not procs.join(timeout=2):  # a failed rank raises here
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            raise RuntimeError("the gloo ranks did not finish in 600 s")
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(SHARDED_TRAIN_RANKS)]
    print(f"{SHARDED_TRAIN_RANKS} ranks spawned, run and joined in "
          f"{ranks_s:.2f} s; {smi}")
    for i, run in enumerate(ranks[0]["runs"]):
        arch, shape = run["arch"], tuple(run["mesh"])
        rcfg = get_config(arch).replace(
            **{r[0]: r[1] for r in SHARDED_TRAIN_RUNS}[arch])
        one = run["one_process"]
        per_rank = [r["runs"][i] for r in ranks]
        fp32 = run["dtype"] == "float32"
        rl = abs(run["loss"] - one["loss"]) / abs(one["loss"])
        rg = abs(run["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
        layers = rcfg.num_layers
        k6_want = layers * run["microbatches"] * 2
        resident_want = reck[arch, shape]["weights"] \
            + reck[arch, shape]["moments"]
        print(f"  {arch} ({layers} layers, {run['dtype']}, fsdp "
              f"{rcfg.fsdp}) on {shape}: batch {run['batch']} x "
              f"{run['seq']} in {run['microbatches']} microbatches; loss "
              f"{run['loss']:.6f} against one process {one['loss']:.6f} "
              f"(relative {rl:.2e}), grad norm {run['grad_norm']:.5f} against "
              f"{one['grad_norm']:.5f} ({rg:.2e}); parameters: max |diff| "
              f"{run['param_max_abs_err']:.3e}, {run['leaves_bit_equal']} of "
              f"{run['leaves']} leaves bit-equal, "
              f"{run['params_out_of_limit']} elements past the limit; mu: "
              f"largest leaf distance ‖Δ‖/‖mu‖ "
              f"{run['mu_worst_distance']:.3e}"
              f" ({run['mu_worst_leaf']}; limit {SHARDED_MU_TOL:.3e}), past "
              f"it {run['mu_past']}, largest max |Δ| / max |mu| "
              f"{run['mu_max_abs_rel']:.3e}; K6 calls "
              f"on local heads: max |Δ| "
              f"{max(r['k6_max_abs_err'] for r in per_rank):.3e}, row RMS "
              f"max {max(r['k6_row_rms'] for r in per_rank):.3e} (bound "
              f"{run['k6_row_rms_bound']:.3e}); build "
              f"{[round(r['times']['build'], 2) for r in per_rank]} s, "
              f"gather and check "
              f"{[round(r['times']['check'], 2) for r in per_rank]} s; step "
              f"{[round(r['seconds'], 3) for r in per_rank]} s a rank (one "
              f"process {one['seconds']:.3f} s); K6 launches "
              f"{[r['k6_launches'] for r in per_rank]}; peak "
              f"{[round(r['peak'] / 2**30, 2) for r in per_rank]} GiB against "
              f"the reckoned {reck[arch, shape]['total'] / 2**30:.2f}; "
              f"resident {[round(r['resident'] / 2**30, 3) for r in per_rank]}"
              f" GiB (reckoned {resident_want / 2**30:.3f}); {smi}")
        lim_l = SHARDED_FP32_RTOL if fp32 else SHARDED_BF16_LOSS_RTOL
        lim_g = SHARDED_FP32_RTOL if fp32 else SHARDED_BF16_GNORM_RTOL
        check(rl <= lim_l and rg <= lim_g and all(
            r["loss"] == run["loss"] for r in per_rank),
              f"{arch} on {shape}: loss within {lim_l}, grad norm within "
              f"{lim_g} of the one-process step, the same on every rank")
        check(run["params_out_of_limit"] == 0,
              f"{arch} on {shape}: every parameter within its limit")
        check(not run["mu_past"] and run["leaves"] > 0,
              f"{arch} on {shape}: every leaf's gradient (its first moment "
              f"mu) within ‖Δ‖ <= {SHARDED_MU_TOL} ‖mu‖ of the one-process "
              f"step's")
        check(all(r["k6_calls"] == k6_want and r["k6_calls_ok"]
                  for r in per_rank),
              f"{arch} on {shape}: every rank's {k6_want} K6 calls within "
              f"flash_within_tolerance and flash_row_rms on their inputs")
        check(all(r["k6_launches"] == k6_want for r in per_rank),
              f"{arch} on {shape}: {k6_want} K6 launches a rank ({layers} "
              f"layers x {run['microbatches']} microbatches x 2), on its "
              f"local heads")
        check(all(r["peak"] <= PEAK_RECKON_SLACK * reck[arch, shape]["total"]
                  for r in per_rank),
              f"{arch} on {shape}: every rank's peak within "
              f"{PEAK_RECKON_SLACK}x the reckoning")
        check(all(r["resident"] == resident_want for r in per_rank),
              f"{arch} on {shape}: every rank's resident weights and moments "
              f"= the reckoning from the specs")
        paths.append(dict(
            path=f"3x(b): {arch} ({layers} layers, {run['dtype']}) on a "
                 f"{shape} mesh of {SHARDED_TRAIN_RANKS} gloo ranks on cuda:0",
            launches_per_rank=[r["k6_launches"] for r in per_rank],
            step_s=[r["seconds"] for r in per_rank],
            peak_gib=[r["peak"] / 2**30 for r in per_rank],
            resident_gib=[r["resident"] / 2**30 for r in per_rank],
            reckoned_gib=reck[arch, shape]["total"] / 2**30,
            loss_rel=rl, gnorm_rel=rg,
            param_max_abs_err=run["param_max_abs_err"],
            mu_worst_distance=run["mu_worst_distance"],
            mu_worst_leaf=run["mu_worst_leaf"],
            mu_max_abs_rel=run["mu_max_abs_rel"],
            k6_calls_max_abs_err=max(r["k6_max_abs_err"] for r in per_rank),
            k6_calls_row_rms_max=max(r["k6_row_rms"] for r in per_rank),
            one_process_s=one["seconds"]))
    ef = [r["ef"] for r in ranks]
    print(f"  ef_psum over {SHARDED_TRAIN_RANKS} ranks at one {EF_ARCH} "
          f"layer's {ef[0]['leaves']} gradient leaves ({ef[0]['elements']:,} "
          f"elements): {[round(e['seconds'], 3) for e in ef]} s a rank; "
          f"worst |ef_psum - sum| {ef[0]['worst']['psum']:.3e}, "
          f"|compress_decompress(sum) - sum| {ef[0]['worst']['cd']:.3e}, "
          f"between them {ef[0]['worst']['between']:.3e}; past a bound: "
          f"{[e['past'] for e in ef]}; digests equal "
          f"{all(e['digest'] == ef[0]['digest'] for e in ef)}")
    check(all(e["within_bounds"] for e in ef)
          and all(e["digest"] == ef[0]["digest"] for e in ef),
          "ef_psum: the same sum on every rank, within W·s/2 of the true sum "
          "and within W·s/2 + s_sum/2 of compress_decompress of the summed "
          "inputs, each residual within s/2 (each bound plus the fp32 "
          "rounding, 2⁻²¹ of the largest sum)")

    return dict(paths=paths, ranks_s=ranks_s, ef=ef[0])


def sharded_local_heads(torch, dev, get_config, fa) -> list:
    """Phase 3x (c): each model rank's local-head K6 call of gemma2-2b's
    layer against the unsharded call's heads, in this process."""
    cfg = get_config(TRAIN_ARCH)
    # -- (c): local-head K6 calls in this process -------------------------------
    phase("phase 3x: each model rank's local-head K6 call of gemma2-2b's "
          "layer against the unsharded call's heads")
    local = []
    for n in sorted({m for _, m in SHARDED_TRAIN_MESHES}):
        for window in (cfg.sliding_window, None):
            case = local_head_k6_case(torch, fa, dev, n, window,
                                      cfg.logit_softcap)
            local.append(case)
            for r in case["ranks"]:
                print(f"  model axis {n}, window {window}, rank {r['rank']}: "
                      f"q heads {r['q_heads']}, kv heads {r['kv_heads']}, "
                      f"max |diff| {r['max_abs_err']:.3e}, row rms "
                      f"{r['row_rms']:.3e}, bit-equal {r['bit_equal']}")
    check(all(r["ok"] and r["row_rms"] <= fa.ROW_RMS_BOUND[torch.bfloat16]
              and r["launches"] == 1 for c in local for r in c["ranks"]),
          "every local-head K6 call within K6's contract of the unsharded "
          "call's heads, one launch each")
    return local


# -- phase 3y: sharded serving, and the dry run held to the card --------------

# (a): gemma2-2b at published width and 3v's depth, served on a (1, 1) mesh
# of a world-1 NCCL group: a prefill and 16 greedy tokens, bit-equal to
# one-card greedy_generate (at one rank no gather runs)
MESH1_BATCH, MESH1_PROMPT, MESH1_STEPS = 2, 1024, 16
# (b): SHARDED_SERVE_RANKS gloo ranks on cuda:0, each model at published
# widths cut to SHARDED_SERVE_LAYERS layers in bf16: (arch, mesh (data,
# model), batch, prompt tokens, teacher-forced steps). gemma2-2b's 4 kv
# heads split over 2 model ranks, paligemma-3b's 1 over none (its cache
# splits by sequence: 256 patches + 766 tokens + 2 steps = 1024 slots over
# 4 ranks, and each decode step merges 4 partial softmaxes), qwen1.5-32b's
# 40 over 4 with the int8 cache. Two decode steps: every step gathers all
# the weights through gloo's host staging (3-4 s a step with 4 ranks on
# one NVIDIA H100 80GB HBM3 at 700 W, where 8 steps took 3y to 128 s)
SHARDED_SERVE_RANKS = 4
SHARDED_SERVE_LAYERS = 2
SHARDED_SERVE_RUNS = (("gemma2-2b", (2, 2), 4, 1022, 2),
                      ("paligemma-3b", (1, 4), 2, 766, 2),
                      ("qwen1.5-32b", (1, 4), 2, 1022, 2))
# a rank's teacher-forced last-position logits against rank 0's one-process
# serve on the card: the limits phases 3f, 3r and 3p use for the family
# (stated before the first run)
SHARDED_SERVE_TOL = {"gemma2-2b": SERVE_LOGIT_TOL,
                     "paligemma-3b": VLM_LOGIT_TOL,
                     "qwen1.5-32b": INT8_LOGIT_TOL}
# (c): each rank's measured prefill peak against the dry run's prediction
# on a fake 4-rank group: measured <= 1.1 x predicted + 256 MiB (the CUDA
# context's allocations, cuBLAS workspaces, the whole batch each rank is
# given) and predicted <= 1.1 x measured
DRYRUN_PEAK_SLACK, DRYRUN_PEAK_FLOOR = 1.1, 256 << 20
# the paper core's dry-run cell: lower_tc's 8192 tiles of 128 over 256
# ranks, one rank's 32 triples launched through K4 on the card
DRYRUN_TC_TILES, DRYRUN_TC_BLOCK, DRYRUN_TC_CHIPS = 8192, 128, 256

# one rank's prefill of each (b) run traced on meta on a fake 4-rank group
# (argv: the rank, the runs as JSON), or lower_tc on a fake 256-rank group
# (argv: "tc"): one process each, as a fake group holds one world
_DRYRUN_PREDICT = r"""
import json, sys
import torch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_config

if sys.argv[1] == "tc":
    dryrun.fake_world(int(sys.argv[3]))
    mesh = dryrun.production_mesh(False)
    print(json.dumps(dryrun.lower_tc(mesh, tiles=int(sys.argv[2]),
                                     block=int(sys.argv[4]))))
    sys.exit(0)
rank, runs = int(sys.argv[1]), json.loads(sys.argv[2])
layers = int(sys.argv[3])
dryrun.fake_world(4, rank)
out = {}
for arch, shape, b, prompt, steps in runs:
    cfg = get_config(arch).replace(num_layers=layers)
    mesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
    batch = {"tokens": torch.empty((b, prompt), dtype=torch.int64,
                                   device="meta")}
    extra = 0
    if cfg.family == "vlm":
        batch["patches"] = torch.empty((b, cfg.vision_tokens, cfg.vision_dim),
                                       dtype=torch.float32, device="meta")
        extra = cfg.vision_tokens
    out[arch] = dryrun.trace_step(cfg, "prefill", batch, mesh,
                                  max_len=prompt + extra + steps)
print(json.dumps(out))
"""


def serve_inputs(torch, np, cfg, b: int, prompt: int, steps: int, dev):
    """Phase 3y's prompt batch of ``cfg`` (tokens, and patches for the VLM)
    and its teacher-forced tokens, drawn from numpy seed 29."""
    rng = np.random.default_rng(29)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, prompt))).to(dev)}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)).to(dev)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab, (b, steps))).to(dev)
    return batch, feed


def serve_reckoning(cfg, sizes: dict, b: int, max_len: int) -> dict:
    """One rank's resident weights and cache in phase 3y(b), reckoned from
    the sanitised specs (``param_specs``, ``cache_leaf_spec``) of ``cfg``'s
    model in bf16 on the meta device on a mesh of ``sizes``."""
    import torch

    from repro_torch.models.registry import get_model
    from repro_torch.train import sharding

    def local(n, spec):
        for entry in spec:
            for a in (() if entry is None else entry
                      if isinstance(entry, tuple) else (entry,)):
                n //= sizes.get(a, 1)
        return n

    model = get_model(cfg, device="meta", dtype=torch.bfloat16)
    specs = sharding.param_specs(model, fsdp=cfg.fsdp)
    weights = sum(local(p.numel(), sharding.sanitize_spec(
        specs[n], p.shape, sizes)) * p.element_size()
        for n, p in model.named_parameters())
    cache = sum(local(x.numel(), sharding.cache_leaf_spec(
        tuple(x.shape), sizes, b)) * x.element_size()
        for x in model.init_cache(b, max_len).values()
        if isinstance(x, torch.Tensor))
    return dict(weights=weights, cache=cache)


def teacher_forced_rows(torch, model, last, cache, feed):
    """The last-position logits ``last`` of a prefill, then of each decode
    step against its ``cache`` fed ``feed`` (this rank's rows under a
    mesh): (rows, steps + 1, V) fp32 on the host."""
    rows = [last.float().cpu()]
    for i in range(feed.shape[1]):
        lg, cache = model.decode_step(cache, feed[:, i:i + 1])
        rows.append(lg[:, -1].float().cpu())
    return torch.stack(rows, dim=1)


def sharded_serve_rank(rank: int, world: int, store: str, spec: dict) -> None:
    """Phase 3y (b): one of ``world`` gloo ranks on ``cuda:0``, spawned by
    ``sharded_serve_phase``. For each run of ``SHARDED_SERVE_RUNS`` every
    rank draws the same weights, shards them (``shard_model_``) and, under
    ``activation_mesh``, prefills its rows with the peak reset just before
    (its peak, seconds and K6 launches: phase (c)'s measured side), then
    decodes teacher-forced from its cache; a second prefill holds each K6
    call to K6's contract on the call's own inputs
    (``contract_held_calls``). Then rank 0 serves each run in one
    process. Writes each rank's last-position logits (``.npy``) and
    ``serve_rank<rank>.json`` to ``spec["out"]``; raises on any fault,
    which fails the phase."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.meshctx import activation_mesh
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train import sharding

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = dict(rank=rank, runs=[])
    try:
        for arch, shape, b, prompt, steps in spec["runs"]:
            cfg = get_config(arch).replace(num_layers=spec["layers"])
            extra = cfg.vision_tokens if cfg.family == "vlm" else 0
            max_len = prompt + extra + steps
            mesh = make_local_mesh(shape[1], device_type="cuda")
            model = get_model(cfg, device=dev, dtype=torch.bfloat16)
            model.init(torch.Generator(device=dev).manual_seed(0))
            sharding.shard_model_(model, mesh, fsdp=cfg.fsdp)
            batch, feed = serve_inputs(torch, np, cfg, b, prompt, steps, dev)
            rows = sharding.serve_rows({"feed": feed}, mesh)["feed"]
            resident_w = sharding.resident_bytes(list(model.parameters()))
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            with activation_mesh(mesh):
                logits, cache = model.prefill(batch, max_len)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                launches = fa.LAUNCHES["flash_attention"]
                resident_c = sharding.resident_bytes(
                    [x for x in cache.values()
                     if isinstance(x, torch.Tensor)])
                last = logits[:, -1].clone()
                del logits
                forced = teacher_forced_rows(torch, model, last, cache, rows)
                del cache
                calls = []  # the serving path's K6 entry, as 3p-3r hold it
                kernel = L.flash_attention
                L.flash_attention = contract_held_calls(torch, fa, kernel,
                                                        calls)
                try:
                    logits, _ = model.prefill(batch, max_len)
                finally:
                    L.flash_attention = kernel
                del logits
            np.save(os.path.join(spec["out"], f"{arch}_r{rank}.npy"),
                    forced.numpy())
            out["runs"].append(dict(
                arch=arch, mesh=list(shape), prefill_s=secs, peak=peak,
                k6_launches=launches, resident_weights=resident_w,
                resident_cache=resident_c, k6_calls=len(calls),
                k6_calls_ok=all(c[0] for c in calls),
                k6_max_abs_err=max((c[1] for c in calls), default=0.0),
                k6_row_rms=max((c[2] for c in calls), default=0.0)))
            del model
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        if rank == 0:  # the one-process serves, the others idle
            for arch, shape, b, prompt, steps in spec["runs"]:
                cfg = get_config(arch).replace(num_layers=spec["layers"])
                extra = cfg.vision_tokens if cfg.family == "vlm" else 0
                model = get_model(cfg, device=dev, dtype=torch.bfloat16)
                model.init(torch.Generator(device=dev).manual_seed(0))
                batch, feed = serve_inputs(torch, np, cfg, b, prompt, steps,
                                           dev)
                logits, cache = model.prefill(batch, prompt + extra + steps)
                last = logits[:, -1].clone()
                del logits
                forced = teacher_forced_rows(torch, model, last, cache, feed)
                del cache
                np.save(os.path.join(spec["out"], f"{arch}_one.npy"),
                        forced.numpy())
                del model
                gc.collect()
                torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
        release_host_memory(torch)
    with open(os.path.join(spec["out"], f"serve_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def sharded_serve_phase(torch, np, dev, get_config, get_model,
                        greedy_generate, fa, flush, smi: str) -> dict:
    """Phase 3y: sharded serving. (a) gemma2-2b on a (1, 1) mesh of a
    world-1 NCCL group against one-card serving (``serve_world1``); (b)
    ``SHARDED_SERVE_RANKS`` gloo ranks spawned on cuda:0
    (``sharded_serve_rank``); (c) the dry run's predictions for (b)'s
    ranks, traced on fake groups in subprocesses started with (b), held to
    (b)'s measurements, and the paper core's cell with one rank's share
    launched through K4. Returns K6's and K4's paths and the runs."""
    import shutil

    t_phase = time.perf_counter()
    work = ROOT / "build" / "sharded_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    world1 = serve_world1(torch, dev, get_config, get_model, greedy_generate,
                          fa, smi, work)
    # (c)'s predictions run on the host's cores beside (b)'s ranks
    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = json.dumps([list(r) for r in SHARDED_SERVE_RUNS])
    preds = [subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_PREDICT, str(r), runs,
         str(SHARDED_SERVE_LAYERS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for r in range(SHARDED_SERVE_RANKS)]
    preds.append(subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_PREDICT, "tc", str(DRYRUN_TC_TILES),
         str(DRYRUN_TC_CHIPS), str(DRYRUN_TC_BLOCK)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        ranks = sharded_serve_ranks(torch, np, get_config, smi, work)
    finally:
        outs = []
        for p in preds:
            try:
                so, se = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
            outs.append((p.returncode, so, se))
    for rc, _, se in outs:
        check(rc == 0, f"a dry-run prediction process exited {rc}: "
                       f"{se[-2000:]}")
    predicted = [json.loads(so.splitlines()[-1]) for _, so, _ in outs]
    paths = dryrun_against_card(torch, np, dev, fa, flush, smi, ranks,
                                predicted[:-1], predicted[-1])
    shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    print(f"phase 3y took {secs:.1f} s")
    return dict(paths=[world1] + ranks["paths"], dryrun=paths["dryrun"],
                tc=paths["tc"], seconds=secs)


def serve_world1(torch, dev, get_config, get_model, greedy_generate, fa,
                 smi: str, work) -> dict:
    """Phase 3y (a): gemma2-2b at published width and 3v's depth, served on
    a (1, 1) mesh of a world-1 NCCL group in this process, against
    one-card serving of the same weights and prompt."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.meshctx import activation_mesh
    from repro_torch.train import sharding

    cfg = get_config(TRAIN_ARCH).replace(**TRAIN_CUT)
    b, prompt, steps = MESH1_BATCH, MESH1_PROMPT, MESH1_STEPS
    max_len = prompt + steps
    phase(f"phase 3y: sharded serving, {TRAIN_ARCH} ({cfg.num_layers} "
          f"layers) on a (1, 1) mesh of a world-1 NCCL group against "
          f"one-card serving, batch {b} x {prompt}, {steps} tokens ({smi})")
    model, _, _ = new_lm_model(torch, dev, get_model, cfg, torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, prompt), device=dev,
                                     generator=gen)}
    fa.reset_launch_counts()
    want_logits, _ = model.prefill(batch, max_len)
    want = greedy_generate(model, cfg, batch, steps=steps, max_len=max_len)
    torch.cuda.synchronize()
    want_launches = fa.LAUNCHES["flash_attention"]
    dist.init_process_group("nccl", store=dist.FileStore(
        str(work / "nccl-store"), 1), rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1)
        sharding.shard_model_(model, mesh, fsdp=cfg.fsdp)
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with activation_mesh(mesh):
            logits, _ = model.prefill(batch, max_len)
            toks = greedy_generate(model, cfg, batch, steps=steps,
                                   max_len=max_len)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = fa.LAUNCHES["flash_attention"]
        same_logits = bool(torch.equal(logits, want_logits))
        same_toks = bool(torch.equal(toks, want))
        del logits, want_logits, model
    finally:
        dist.destroy_process_group()
    drop_model(torch)
    print(f"(1, 1) mesh: prefill logits bit-equal {same_logits}, tokens "
          f"bit-equal {same_toks} (first sequence {toks[0].tolist()}); "
          f"{launches} K6 launches (one card {want_launches}); prefill and "
          f"greedy_generate {secs:.3f} s; {smi}")
    check(same_logits and same_toks,
          "the (1, 1) mesh's prefill logits and greedy tokens bit-equal to "
          "one-card serving")
    check(launches == want_launches == 2 * cfg.num_layers,
          f"{launches} K6 launches, as one-card serving (a layer a prefill, "
          f"twice)")
    return dict(path=f"3y(a): {TRAIN_ARCH} ({cfg.num_layers} layers) prefill "
                     f"and greedy_generate on a (1, 1) mesh, world-1 NCCL, "
                     f"batch {b} x {prompt}, {steps} tokens",
                launches=launches, seconds=secs)


def sharded_serve_ranks(torch, np, get_config, smi: str, work) -> dict:
    """Phase 3y (b): ``SHARDED_SERVE_RANKS`` gloo ranks spawned on cuda:0,
    each run of ``SHARDED_SERVE_RUNS`` held to rank 0's one-process serve,
    each rank's resident weights and cache to the reckoning from the
    specs, its K6 calls to K6's contract and its launches counted."""
    import torch.multiprocessing as mp

    phase(f"phase 3y: {SHARDED_SERVE_RANKS} gloo ranks on cuda:0, "
          f"{SHARDED_SERVE_LAYERS} layers at published widths in bf16, runs "
          f"{[list(r) for r in SHARDED_SERVE_RUNS]}")
    spec = dict(out=str(work), runs=SHARDED_SERVE_RUNS,
                layers=SHARDED_SERVE_LAYERS)
    t0 = time.perf_counter()
    procs = mp.start_processes(
        sharded_serve_rank, args=(SHARDED_SERVE_RANKS,
                                  str(work / "gloo-store"), spec),
        nprocs=SHARDED_SERVE_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    while not procs.join(timeout=2):  # a failed rank raises here
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            raise RuntimeError("the gloo ranks did not finish in 600 s")
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"serve_rank{r}.json").read_text())
             for r in range(SHARDED_SERVE_RANKS)]
    print(f"{SHARDED_SERVE_RANKS} ranks spawned, run and joined in "
          f"{ranks_s:.2f} s; {smi}")
    paths = []
    for i, (arch, shape, b, prompt, steps) in enumerate(SHARDED_SERVE_RUNS):
        cfg = get_config(arch).replace(num_layers=SHARDED_SERVE_LAYERS)
        extra = cfg.vision_tokens if cfg.family == "vlm" else 0
        sizes = dict(data=shape[0], model=shape[1])
        reck = serve_reckoning(cfg, sizes, b, prompt + extra + steps)
        one = np.load(work / f"{arch}_one.npy")
        per_rank = [r["runs"][i] for r in ranks]
        n = b // shape[0]
        errs = []
        for r in range(SHARDED_SERVE_RANKS):
            got = np.load(work / f"{arch}_r{r}.npy")
            lo = (r // shape[1]) * n
            errs.append(float(np.abs(got - one[lo:lo + n]).max()))
        tol = SHARDED_SERVE_TOL[arch]
        print(f"  {arch} on {shape}: batch {b} x {prompt}"
              f"{f' + {extra} patches' if extra else ''}, {steps} "
              f"teacher-forced steps; last-position logits max |Δ| against "
              f"rank 0's one-process serve {[round(e, 4) for e in errs]} "
              f"(limit {tol}); prefill "
              f"{[round(x['prefill_s'], 3) for x in per_rank]} s a rank; K6 "
              f"launches {[x['k6_launches'] for x in per_rank]}; K6 calls "
              f"max |Δ| {max(x['k6_max_abs_err'] for x in per_rank):.3e}, "
              f"row RMS {max(x['k6_row_rms'] for x in per_rank):.3e}; "
              f"resident weights "
              f"{[x['resident_weights'] for x in per_rank]} B (reckoned "
              f"{reck['weights']}), cache "
              f"{[x['resident_cache'] for x in per_rank]} B (reckoned "
              f"{reck['cache']}); prefill peak "
              f"{[round(x['peak'] / 2**30, 3) for x in per_rank]} GiB; {smi}")
        check(all(e <= tol for e in errs),
              f"{arch} on {shape}: every rank's teacher-forced last-position "
              f"logits within {tol} of the one-process serve's")
        check(all(x["resident_weights"] == reck["weights"]
                  and x["resident_cache"] == reck["cache"]
                  for x in per_rank),
              f"{arch} on {shape}: every rank's resident weights and cache "
              f"= the reckoning from the specs")
        check(all(x["k6_calls"] == SHARDED_SERVE_LAYERS and x["k6_calls_ok"]
                  for x in per_rank),
              f"{arch} on {shape}: every rank's {SHARDED_SERVE_LAYERS} K6 "
              f"calls within flash_within_tolerance and flash_row_rms on "
              f"their inputs")
        check(all(x["k6_launches"] == SHARDED_SERVE_LAYERS
                  for x in per_rank),
              f"{arch} on {shape}: {SHARDED_SERVE_LAYERS} K6 launches a "
              f"rank's prefill, on its own heads")
        paths.append(dict(
            path=f"3y(b): {arch} ({SHARDED_SERVE_LAYERS} layers, bf16) "
                 f"prefill on a {shape} mesh of {SHARDED_SERVE_RANKS} gloo "
                 f"ranks on cuda:0, batch {b} x {prompt + extra}",
            launches_per_rank=[x["k6_launches"] for x in per_rank],
            prefill_s=[x["prefill_s"] for x in per_rank],
            peak_bytes=[x["peak"] for x in per_rank],
            logits_max_abs_err=max(errs),
            k6_calls_max_abs_err=max(x["k6_max_abs_err"] for x in per_rank),
            k6_calls_row_rms_max=max(x["k6_row_rms"] for x in per_rank),
            resident_weights=[x["resident_weights"] for x in per_rank],
            resident_cache=[x["resident_cache"] for x in per_rank]))
    return dict(paths=paths, ranks=ranks, ranks_s=ranks_s)


def dryrun_against_card(torch, np, dev, fa, flush, smi: str, ranks: dict,
                        predicted: list, tc: dict) -> dict:
    """Phase 3y (c): each rank's predicted prefill peak, K6 calls and bound
    (the dry run on a fake 4-rank group) against (b)'s measurements; then
    the paper core's dry-run cell (``lower_tc``, a fake 256-rank group)
    and one rank's share launched through K4 on the card, its time beside
    the priced bound."""
    from repro_torch.core.engine import MatrixLaunch
    from repro_torch.kernels.masked_spgemm import LAUNCHES as MS_LAUNCHES
    from repro_torch.kernels.masked_spgemm import (
        launch_order, masked_spgemm_gathered_chunked)
    from repro_torch.kernels.masked_spgemm import \
        reset_launch_counts as reset_ms_launch_counts

    phase("phase 3y: the dry run's predictions for each rank (a fake "
          "4-rank group, meta tensors) against the card")
    rows = []
    for i, (arch, shape, *_rest) in enumerate(SHARDED_SERVE_RUNS):
        for r in range(SHARDED_SERVE_RANKS):
            pred = predicted[r][arch]
            got = ranks["ranks"][r]["runs"][i]
            peak = pred["memory"]["peak_bytes"]
            rows.append(dict(
                arch=arch, mesh=list(shape), rank=r, predicted_peak=peak,
                measured_peak=got["peak"],
                predicted_k6=pred["kernels"].get("flash_attention", 0),
                launched_k6=got["k6_launches"],
                bound_s=pred["roofline"]["bound"],
                dominant=pred["roofline"]["dominant"],
                prefill_s=got["prefill_s"]))
            print(f"  {arch} {shape} rank {r}: peak predicted "
                  f"{peak / 2**30:.3f} GiB, measured "
                  f"{got['peak'] / 2**30:.3f} GiB; K6 calls predicted "
                  f"{rows[-1]['predicted_k6']}, launched {got['k6_launches']};"
                  f" bound {pred['roofline']['bound'] * 1e3:.3f} ms "
                  f"({pred['roofline']['dominant']}) against the measured "
                  f"prefill {got['prefill_s'] * 1e3:.3f} ms; {smi}")
    check(all(x["measured_peak"] <= DRYRUN_PEAK_SLACK * x["predicted_peak"]
              + DRYRUN_PEAK_FLOOR
              and x["predicted_peak"] <= DRYRUN_PEAK_SLACK * x["measured_peak"]
              for x in rows),
          f"every rank's measured prefill peak <= {DRYRUN_PEAK_SLACK} x the "
          f"predicted + {DRYRUN_PEAK_FLOOR >> 20} MiB, and the predicted <= "
          f"{DRYRUN_PEAK_SLACK} x the measured")
    check(all(x["predicted_k6"] == x["launched_k6"] for x in rows),
          "every rank's predicted K6 calls = its K6 launches")
    check(all(x["bound_s"] <= x["prefill_s"] for x in rows),
          "every rank's roofline bound <= its measured prefill seconds")
    # the paper core: one rank's share of lower_tc's cell through K4
    t, blk = tc["tiles_per_shard"], tc["block"]
    rng = np.random.default_rng(31)
    tiles = [torch.from_numpy((rng.random((t, blk, blk)) < 0.1).astype(
        np.float32)).to(dev).bfloat16() for _ in range(2)]
    idx = torch.arange(t, dtype=torch.int32, device=dev)
    args = (tiles[0], tiles[1], tiles[1], idx, idx, idx,
            launch_order(idx, idx))
    fn = MatrixLaunch("kernel")
    reset_ms_launch_counts()
    total = fn(*args)
    torch.cuda.synchronize()
    launches = MS_LAUNCHES["masked_spgemm_wgmma"]
    want = masked_spgemm_gathered_chunked(*args[:6]).to(torch.int64).sum()
    ms = time_ms(torch, lambda: fn(*args), 50, flush)
    plain_ms = time_ms(torch, lambda: masked_spgemm_gathered_chunked(
        *args[:6]), 20, flush)
    library_ms = time_ms(torch, lambda: spgemm_library_gathered(
        torch, *args[:6]), 20, flush)
    bound_ms = tc["roofline"]["bound"] * 1e3
    k4_ms, k4_by = spgemm_bound_ms(t, blk, spgemm_read_bytes(torch, args))
    print(f"lower_tc on a fake {tc['chips']}-rank group: {t} triples of "
          f"{blk} a rank, predicted peak "
          f"{tc['memory']['peak_bytes'] / 2**20:.2f} MiB, bound "
          f"{bound_ms:.6f} ms ({tc['roofline']['dominant']}; K4's own "
          f"{k4_ms:.6f} ms, {k4_by}), launches "
          f"{tc['kernels']}; on the card one rank's share through K4: "
          f"{ms:.6f} ms (the plain version {plain_ms:.6f} ms, the library "
          f"call {library_ms:.6f} ms), total {int(total)} (plain "
          f"{int(want)}), {launches} launch; {smi}")
    check(int(total) == int(want), "K4's share of the dry-run cell = its "
                                   "plain version")
    check(launches == 1 and tc["kernels"] == {"masked_spgemm_wgmma": 1},
          "one K4 launch, as the dry run traced")
    check(bound_ms <= ms and k4_ms <= ms,
          "the priced bound (and K4's own) <= the measured time")
    return dict(dryrun=rows, tc=dict(
        path=f"3y(c): lower_tc's share of one of {tc['chips']} ranks, "
             f"{t} triples of {blk} (bf16), through MatrixLaunch",
        launches=launches, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=k4_ms, bound_by=k4_by, dryrun_bound_ms=bound_ms,
        dryrun_dominant=tc["roofline"]["dominant"],
        predicted_peak_bytes=tc["memory"]["peak_bytes"]))


def main() -> int:
    # torch.compile (the flex_attention yardstick of phase 4c) caches its
    # kernels inside the checkout's git-ignored build directory
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc" / "intersect.cu").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import (TriangleCounter, subgraph_match_triangle,
                                  triangle_count_forward_scipy,
                                  triangle_count_scipy)
    from repro_torch.graphs import (available_datasets, complete_graph,
                                    grid_graph, load_dataset, rmat_graph)
    from repro_torch.kernels import _build
    from repro_torch.kernels.intersect import (
        LAUNCHES, intersect_counts_bitmap, intersect_counts_bitmap_kernel,
        intersect_counts_broadcast, intersect_counts_kernel,
        intersect_counts_probe, intersect_counts_probe_kernel,
        reset_launch_counts)
    from repro_torch.kernels.masked_spgemm import LAUNCHES as MS_LAUNCHES
    from repro_torch.kernels.masked_spgemm import (
        WGMMA_BLOCKS, masked_spgemm_chunked, masked_spgemm_gathered,
        masked_spgemm_gathered_chunked, masked_spgemm_kernel)
    from repro_torch.kernels.masked_spgemm import \
        reset_launch_counts as reset_ms_launch_counts
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.rglru import block_kinds
    from repro_torch.train.serve_step import greedy_generate

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    # -- phase 1: environment and build -----------------------------------
    phase("phase 1: environment")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {kind}; count {torch.cuda.device_count()}")
    print(f"nvidia-smi name, power.limit: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"nvcc: {nvcc.splitlines()[-1]}")
    t0 = time.perf_counter()
    sources = ("intersect", "masked_spgemm", "hash_probe", "flash_attention")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        libs = list(pool.map(_build.build, sources))
    print(f"build: {[str(lib.relative_to(ROOT)) for lib in libs]} in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    # -- phase 2: the main path -------------------------------------------
    phase("phase 2: main path, TriangleCounter(rmat_graph(18, 16, seed=1))")
    t0 = time.perf_counter()
    g = rmat_graph(18, 16, seed=1)
    oracle = triangle_count_forward_scipy(g)
    print(f"graph: n={g.n} m={g.m_undirected} max_degree={g.max_degree}; "
          f"host generation + forward scipy oracle {time.perf_counter() - t0:.2f} s")
    check(oracle == EXPECTED_SCALE18, f"forward scipy oracle = {oracle}")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tc = TriangleCounter(g)
    first = tc.count()
    warm = [tc.count() for _ in range(5)]
    t0 = time.perf_counter()
    tpv = tc.triangles_per_vertex()
    tpv_s = time.perf_counter() - t0
    main_launches = dict(LAUNCHES)
    counts_run = 1 + len(warm)
    print(f"algorithm={first.algorithm} device={tc.device} "
          f"buckets={first.meta['bucket_shapes']} "
          f"strategies={first.bucket_strategies} "
          f"edges/bucket={first.meta['bucket_edges']}")
    print(f"prep_seconds={first.prep_seconds:.4f} first count() "
          f"{first.exec_seconds:.4f} s; warm count() seconds "
          f"{[round(r.exec_seconds, 6) for r in warm]} (median "
          f"{statistics.median(r.exec_seconds for r in warm):.6f}); "
          f"triangles_per_vertex {tpv_s:.3f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches over {counts_run} count() + triangles_per_vertex(): "
          f"{main_launches}")
    check(first.algorithm == "intersection", "auto resolved to intersection")
    check(all(r.count == EXPECTED_SCALE18 for r in [first] + warm),
          f"count() = {first.count} every time, = oracle")
    check(main_launches["broadcast"] > 0 and main_launches["probe_csr"] > 0
          and main_launches["probe"] == 0,
          "broadcast and K2's CSR form launched by count(), the padded K2 "
          "not")
    check(int(tpv.sum()) == 3 * first.count,
          f"triangles_per_vertex().sum() = {int(tpv.sum())} = 3 × count")
    check(tpv.shape == (g.n,) and int(tpv.min()) >= 0,
          "per-vertex counts are (n,) and non-negative")
    main_stages = tc.plan.stages
    # phase 3g holds the tiled plan to these
    main_count, main_tpv = first.count, tpv
    main_warm_s = statistics.median(r.exec_seconds for r in warm)

    # -- phase 3: each strategy forced on the Table-1 analogues -------------
    phase("phase 3: strategies forced on the Table-1 analogues")
    reset_launch_counts()
    bitmap_stages = []
    analogues = [x for x in available_datasets() if not x.startswith("tiny-")]
    truths, inter_tpv = {}, {}
    for name in analogues:
        d = load_dataset(name)
        truth = truths[name] = triangle_count_scipy(d)
        base = TriangleCounter(d, algorithm="intersection")
        base_tpv = inter_tpv[name] = base.triangles_per_vertex()
        line = [f"{name}: n={d.n} m={d.m_undirected} scipy={truth} "
                f"auto={base.count().bucket_strategies}"]
        for strategy in ("broadcast", "probe", "bitmap"):
            s = TriangleCounter(d, algorithm="intersection", strategy=strategy)
            c = s.count()
            check(c.count == truth, f"{name} strategy={strategy} count "
                                    f"{c.count} = scipy")
            check(bool((s.triangles_per_vertex() == base_tpv).all()),
                  f"{name} strategy={strategy} per-vertex = auto run")
            line.append(f"{strategy} {c.exec_seconds * 1e3:.3f} ms")
            if strategy == "bitmap":
                bitmap_stages += s.plan.stages
        print("  " + "; ".join(line), flush=True)
    forced_launches = dict(LAUNCHES)
    print(f"launches in phase 3: {forced_launches}")
    # a forced probe on a device-prepped filtered plan reads the CSR
    check(all(forced_launches[k] > 0
              for k in ("broadcast", "bitmap", "probe_csr"))
          and forced_launches["probe"] == 0,
          "K1, K3 and K2's CSR form launched by the forced runs, the padded "
          "K2 not")

    # -- phase 3b: the matrix lane ------------------------------------------
    phase("phase 3b: matrix lane, TriangleCounter(orkut-like, algorithm='matrix')")
    t0 = time.perf_counter()
    g = load_dataset("orkut-like")
    oracle = triangle_count_forward_scipy(g)
    print(f"graph: n={g.n} m={g.m_undirected} max_degree={g.max_degree}; "
          f"host generation + forward scipy oracle {time.perf_counter() - t0:.2f} s")
    check(oracle == EXPECTED_ORKUT, f"forward scipy oracle = {oracle}")
    held = torch.cuda.memory_allocated()  # earlier phases' plans
    torch.cuda.reset_peak_memory_stats()
    reset_ms_launch_counts()
    tc = TriangleCounter(g, algorithm="matrix")
    first = tc.count()
    warm = [tc.count() for _ in range(5)]
    matrix_launches = dict(MS_LAUNCHES)
    lane_peak = torch.cuda.max_memory_allocated() - held
    m = first.meta
    stack_gib = 3 * m["num_triples"] * m["block"] ** 2 * 4 / 2**30
    print(f"block={m['block']} num_triples={m['num_triples']} tiles "
          f"L/U/A={m['l_tiles']}/{m['u_tiles']}/{m['a_tiles']} grid={m['grid']} "
          f"resident unique tiles, indices and launch order "
          f"{m['tile_bytes'] / 2**30:.4f} GiB ({m['tile_bytes']} bytes; the "
          f"gathered float32 stacks would be {stack_gib:.2f} GiB)")
    print(f"host schedule {m['schedule_seconds']:.3f} s; host-to-device copy "
          f"of the unique tiles + bf16 conversion + launch order "
          f"{m['upload_seconds']:.3f} s; prep_seconds={first.prep_seconds:.3f}; "
          f"first count() {first.exec_seconds:.4f} s; warm count() seconds "
          f"{[round(r.exec_seconds, 6) for r in warm]} (median "
          f"{statistics.median(r.exec_seconds for r in warm):.6f}); "
          f"{peak_memory(torch, held)}")
    print(f"masked_spgemm launches over {1 + len(warm)} count(): {matrix_launches}")
    check(first.algorithm == "matrix", "algorithm = matrix")
    check(m["num_triples"] == 90025 and m["block"] == 128,
          f"num_triples = {m['num_triples']}, block = {m['block']}")
    check(all(r.count == EXPECTED_ORKUT for r in [first] + warm),
          f"count() = {first.count} every time, = oracle")
    check(matrix_launches == {"masked_spgemm_wgmma": 1 + len(warm),
                              "masked_spgemm": 0},
          "one tensor-core masked_spgemm_wgmma launch per count(), no "
          "float32 launch")
    check(lane_peak < 2 * 2**30,
          f"the orkut-like lane's own peak {lane_peak / 2**30:.4f} GiB < 2 GiB")
    spgemm_paths = [("orkut-like", tc.plan.stages[0].args)]
    del tc
    k512 = complete_graph(512)
    res = TriangleCounter(k512).count()
    check(res.algorithm == "matrix" and res.count == EXPECTED_K512
          and res.count == triangle_count_scipy(k512),
          f"complete_graph(512): auto → {res.algorithm}, count {res.count} "
          f"(> 2^24, num_triples {res.meta['num_triples']})")
    for name in ("coauthors-like", "road-like"):
        reset_ms_launch_counts()
        s = TriangleCounter(load_dataset(name), algorithm="matrix")
        c = s.count()
        check(c.count == truths[name],
              f"{name} matrix count {c.count} = scipy (block {c.meta['block']}, "
              f"num_triples {c.meta['num_triples']}, warm count "
              f"{s.count().exec_seconds * 1e3:.3f} ms, launches "
              f"{dict(MS_LAUNCHES)})")
        if name == "road-like":
            check(c.meta["block"] == 32, "road-like takes B = 32")
            road_launches = dict(MS_LAUNCHES)
            route = "masked_spgemm_wgmma" if 32 in WGMMA_BLOCKS else "masked_spgemm"
            check(road_launches[route] == 2 == sum(road_launches.values()),
                  f"road-like's two count() launched {route} (B = 32 "
                  f"{'is' if 32 in WGMMA_BLOCKS else 'is not'} in "
                  f"WGMMA_BLOCKS = {WGMMA_BLOCKS})")
            spgemm_paths.append((name, s.plan.stages[0].args))

    # -- phase 3c: the subgraph lane ----------------------------------------
    phase(f"phase 3c: subgraph lane, TriangleCounter(grid_graph({GRID_SIDE}, "
          f"diagonals=True, spur_fraction=0.35, seed=3))")
    t0 = time.perf_counter()
    g = grid_graph(GRID_SIDE, diagonals=True, spur_fraction=0.35, seed=3)
    t_gen = time.perf_counter() - t0
    oracle = triangle_count_forward_scipy(g)
    t_oracle = time.perf_counter() - t0 - t_gen
    alive_np, np_rounds = two_core_numpy(np, g)
    avg_deg = 2 * g.m_undirected / g.n
    print(f"graph: n={g.n} m={g.m_undirected} max_degree={g.max_degree} "
          f"skew={g.max_degree / avg_deg:.2f}; host generation {t_gen:.2f} s, "
          f"forward scipy oracle {t_oracle:.2f} s, numpy 2-core "
          f"{time.perf_counter() - t0 - t_gen - t_oracle:.2f} s "
          f"({np_rounds} rounds)")
    check(oracle == EXPECTED_GRID, f"forward scipy oracle = {oracle} = 2·2999²")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tc = TriangleCounter(g)
    first = tc.count()
    warm = [tc.count() for _ in range(5)]
    subgraph_launches = dict(LAUNCHES)
    reset_launch_counts()
    t0 = time.perf_counter()
    tpv = tc.triangles_per_vertex()
    tpv_s = time.perf_counter() - t0
    m = first.meta
    print(f"algorithm={first.algorithm} vertices_pruned={m['vertices_pruned']} "
          f"peel_rounds={m['peel_rounds']} edges_after={m['edges_after']} "
          f"buckets={m['bucket_shapes']} strategies={first.bucket_strategies} "
          f"edges/bucket={m['bucket_edges']}")
    print(f"prep_seconds={first.prep_seconds:.4f} first count() "
          f"{first.exec_seconds:.4f} s; warm count() seconds "
          f"{[round(r.exec_seconds, 6) for r in warm]} (median "
          f"{statistics.median(r.exec_seconds for r in warm):.6f}); "
          f"triangles_per_vertex {tpv_s:.3f} s; {peak_memory(torch, held)}")
    print(f"launches over {1 + len(warm)} count(): {subgraph_launches}; "
          f"over triangles_per_vertex(): {dict(LAUNCHES)}")
    check(first.algorithm == "subgraph", "auto resolved to subgraph")
    check(all(r.count == EXPECTED_GRID for r in [first] + warm),
          f"count() = {first.count} every time, = oracle")
    check(m["vertices_pruned"] == int((~alive_np).sum())
          and m["peel_rounds"] == np_rounds,
          f"peel = numpy 2-core ({m['vertices_pruned']} pruned, "
          f"{np_rounds} rounds)")
    check(subgraph_launches["broadcast"] > 0,
          "broadcast kernel launched by count()")
    check(int(tpv.sum()) == 3 * first.count and tpv.shape == (g.n,),
          f"triangles_per_vertex().sum() = {int(tpv.sum())} = 3 × count")
    check(first.meta["num_embeddings"] == 6 * first.count,
          "num_embeddings = 6 × count")
    subgraph_stages = tc.plan.stages
    grid, grid_tpv = g, tpv  # phase 3e counts the same graph again
    del tc, tpv, g, alive_np
    for name in analogues:
        s = TriangleCounter(load_dataset(name), algorithm="subgraph")
        c = s.count()
        check(c.count == truths[name]
              and bool((s.triangles_per_vertex() == inter_tpv[name]).all()),
              f"{name} subgraph count {c.count} = scipy, per-vertex = "
              f"intersection lane ({c.meta['vertices_pruned']} pruned)")

    # labeled triangle queries: their u rows lose the ids without the third
    # label in place and are sorted again before K2, which merges
    g = rmat_graph(12, 8, seed=3)
    labels = np.random.default_rng(7).integers(0, 3, size=g.n)
    queries = [((0, 1, 2), labels), ((2, 0, 1), labels),
               ((1, 1, 0), labels), ((0, 0, 0), np.zeros(g.n, np.int64))]
    cpu = torch.device("cpu")
    reset_launch_counts()
    on_card = [subgraph_match_triangle(g, lab, q) for q, lab in queries]
    query_launches = dict(LAUNCHES)
    on_cpu = [subgraph_match_triangle(g, lab, q, device=cpu)
              for q, lab in queries]
    print(f"labeled queries on rmat_graph(12, 8, seed=3): "
          f"{[q for q, _ in queries]} -> card {on_card}, cpu {on_cpu}; "
          f"launches {query_launches}")
    check(on_card == on_cpu and min(on_card) > 0,
          "labeled triangle queries on the card = the CPU's plain path")
    check(on_card[-1] == 6 * triangle_count_scipy(g),
          "all-one-label query = 6 × scipy")
    check(query_launches["probe"] > 0, "probe kernel launched by the queries")
    del g, labels, queries

    # -- phase 4: kernels against their plain versions ----------------------
    phase("phase 4: kernels against plain torch versions")
    wrappers = {
        "broadcast": (intersect_counts_kernel, intersect_counts_broadcast),
        "probe": (intersect_counts_probe_kernel, intersect_counts_probe),
        "bitmap": (intersect_counts_bitmap_kernel, intersect_counts_bitmap),
    }
    # the main path's probe buckets launch K2's CSR form (its own entry
    # below); the padded K2's main path is phase 3g's tiled count, whose
    # chunks that phase holds and times
    main_csr = csr_stages(main_stages)
    paths = {
        "broadcast": [st for st in main_stages if st.strategy == "broadcast"],
        "probe": [],
        "bitmap": bitmap_stages,
    }
    def intersect_case(strategy, st):
        """Hold one path stage's kernel against its plain version, exactly,
        and time both; returns the shape's record."""
        kern, plain = wrappers[strategy]
        u, v = st.args
        kw = dict(num_bits=st.bitmap_bits) if strategy == "bitmap" else {}
        k_out = kern(u, v, **kw)
        p_out = plain(u, v, **kw)
        torch.cuda.synchronize()
        err = int((k_out.long() - p_out.long()).abs().max()) if u.shape[0] else 0
        check(err == 0, f"{strategy} kernel == plain at {tuple(u.shape)} "
                        f"{kw or ''}")
        k_ms = time_ms(torch, lambda: kern(u, v, **kw), 7, flush)
        p_ms = time_ms(torch, lambda: plain(u, v, **kw), 3, flush)
        b_ms, b_by = bound_ms(*u.shape)
        shape = dict(shape=list(u.shape), ms=k_ms, plain_ms=p_ms,
                     bound_ms=b_ms, bound_by=b_by, max_abs_err=err, **kw)
        if strategy == "probe":
            shape.update(probe_extras(u, v, b_ms, b_by))
        print(f"  {strategy} {tuple(u.shape)} {kw or ''}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
              + (probe_line(shape) if strategy == "probe" else ""), flush=True)
        return shape

    def probe_extras(u, v, b_ms, b_by):
        """K2 is held against the bytes it must read (``bound_ms``); the
        all-bytes bound stays beside it, with the searchsorted yardstick."""
        extra = probe_read_bound(torch, u, v)
        return dict(bound_ms=extra["must_read_ms"], bound_by=extra["must_read_by"],
                    all_bytes_bound_ms=b_ms, all_bytes_bound_by=b_by,
                    must_read_bytes=extra["must_read_bytes"],
                    live_rows=extra["live_rows"],
                    skipped_rows=extra["skipped_rows"],
                    yardstick_ms=time_ms(torch, lambda: torch.searchsorted(
                        v, u, out_int32=True), 3, flush))

    def probe_line(shape):
        return (f"; must-read bound {shape['bound_ms']:.4f} ms "
                f"({shape['live_rows']} rows read, {shape['skipped_rows']} "
                f"skipped by the range test; K2 at "
                f"{100 * shape['bound_ms'] / shape['ms']:.1f} % of it), "
                f"torch.searchsorted {shape['yardstick_ms']:.4f} ms")

    def add_shape(entry, shape):
        entry["shapes"].append(shape)
        entry["ms"] += shape["ms"]
        entry["plain_ms"] += shape["plain_ms"]
        entry["bound_ms"] += shape["bound_ms"]
        entry["max_abs_err"] = max(entry["max_abs_err"], shape["max_abs_err"])

    report = []
    for strategy in wrappers:
        entry = dict(name=KERNELS[strategy]["name"], route="cuda",
                     source="src/repro_torch/csrc/intersect.cu",
                     replaces=KERNELS[strategy]["replaces"],
                     plain=KERNELS[strategy]["plain"],
                     path={"broadcast": "scale-18 R-MAT count()",
                           "probe": "phase 3g: scale-18 R-MAT count() tiled "
                                    "under max_device_bytes 1 GiB",
                           "bitmap": "forced bitmap on the Table-1 "
                                     "analogues"}[strategy],
                     # phase 3g fills in the padded K2's launches
                     launches=(main_launches if strategy != "bitmap"
                               else forced_launches)[strategy]
                     if strategy != "probe" else 0,
                     tolerance=0, max_abs_err=0, ms=0.0, plain_ms=0.0,
                     bound_ms=0.0,
                     bound_by=None, library_ms=None, shapes=[])
        for st in paths[strategy]:
            add_shape(entry, intersect_case(strategy, st))
        if strategy != "probe":
            check(bool(entry["shapes"]),
                  f"{strategy} kernel has shapes on its path")
            # the largest shape's bound names the kernel's
            entry["bound_by"] = max(entry["shapes"],
                                    key=lambda x: x["bound_ms"])["bound_by"]
        else:
            entry["yardstick"] = "torch.searchsorted(v, u, out_int32=True) " \
                                 "(positions only, not the same function)"
            entry["yardstick_ms"] = 0.0
            entry["bound"] = ("must-read bytes: both rows where the id ranges "
                              "overlap, the row ends elsewhere")
            entry["all_bytes_bound_ms"] = 0.0
        # the subgraph lane's buckets on the road_central-sized grid, kept
        # apart from the scale-18 totals above
        sub = [intersect_case(strategy, st) for st in subgraph_stages
               if st.strategy == strategy and not any(
                   st is x for x in csr_stages(subgraph_stages))]
        if sub:
            entry["subgraph_path"] = dict(
                path=f"grid_graph({GRID_SIDE}) subgraph count()",
                launches=subgraph_launches[strategy], shapes=sub)
            entry["max_abs_err"] = max([entry["max_abs_err"]]
                                       + [x["max_abs_err"] for x in sub])
        report.append(entry)
    # K2's CSR form on the main path's resident probe buckets
    entry = dict(name=KERNELS["probe_csr"]["name"], route="cuda",
                 source="src/repro_torch/csrc/intersect.cu",
                 replaces=KERNELS["probe_csr"]["replaces"],
                 plain=KERNELS["probe_csr"]["plain"],
                 path="scale-18 R-MAT count()",
                 launches=main_launches["probe_csr"], tolerance=0,
                 max_abs_err=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 bound_by=None, library_ms=None, shapes=[],
                 bound=("needed bytes: each row that a live edge needs, "
                        "once; the row offsets and ends; the endpoints and "
                        "counts"))
    for st in main_csr:
        add_shape(entry, csr_case(torch, st, flush))
    check(len(main_csr) >= 1 and main_launches["probe_csr"]
          == len(main_csr) * counts_run,
          f"K2's CSR form has {len(main_csr)} shapes on its path, one "
          f"launch each a count()")
    entry["bound_by"] = max(entry["shapes"],
                            key=lambda x: x["bound_ms"])["bound_by"]
    sub = [csr_case(torch, st, flush) for st in csr_stages(subgraph_stages)]
    if sub:
        entry["subgraph_path"] = dict(
            path=f"grid_graph({GRID_SIDE}) subgraph count()",
            launches=subgraph_launches["probe_csr"], shapes=sub)
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [x["max_abs_err"] for x in sub])
    report.append(entry)

    rng = np.random.default_rng(0)
    ragged = [(1, 8, 50, 0), (255, 8, 64, 3), (257, 32, 300, 17),
              (1000, 100, 700, 1), (4097, 128, 2000, 97), (999, 257, 1500, 0),
              (333, 512, 4000, 33), (129, 1000, 5000, 5), (77, 1024, 9000, 7),
              (64, 1500, 6000, 2), (9, 8200, 20000, 1),
              (300, 2048, 20000, 7), (64, 8192, 40000, 3)]
    for e, w, id_hi, pad in ragged:
        u_np, v_np = ragged_lists(np, rng, e, w, id_hi, pad)
        u = torch.from_numpy(u_np).to(dev)
        v = torch.from_numpy(v_np).to(dev)
        cases = [("broadcast", {}), ("probe", {}), ("bitmap", dict(num_bits=32)),
                 ("bitmap", dict(num_bits=65536))]
        for strategy, kw in cases:
            kern, plain = wrappers[strategy]
            err = int((kern(u, v, **kw).long() - plain(u, v, **kw).long())
                      .abs().max())
            torch.cuda.synchronize()
            check(err == 0, f"ragged {strategy} ({e}, {w}) {kw or ''} "
                            f"kernel == plain")
    # K2 on its row families (tests/probe_rows.py): duplicates, touching and
    # disjoint ranges, padding and mixed batches, W from 1 to 20000, E past
    # one sweep of the persistent grid; each also as a view that starts
    # mid-allocation (the 4-byte copy route)
    probe_rows = load_test_module("probe_rows")
    for name, e, w in probe_rows.CARD_CASES:
        u_np, v_np = probe_rows.tiled(name, e, w, seed=e + w)
        u = torch.from_numpy(u_np).to(dev)
        v = torch.from_numpy(v_np).to(dev)
        want = intersect_counts_probe(u, v)
        errs = []
        for a, b in ((u, v), (probe_rows.offset_view(u),
                            probe_rows.offset_view(v))):
            errs.append(int((intersect_counts_probe_kernel(a, b).long()
                             - want.long()).abs().max()))
        torch.cuda.synchronize()
        check(max(errs) == 0, f"probe family {name} ({e}, {w}) kernel == "
                              f"plain, aligned and mid-allocation")

    # K1 and K3 on their row families (tests/intersect_rows.py): unsorted
    # rows, duplicates, ids outside the bitmap's range and the int32
    # extremes, padding, W from 1 to 63 (K3 also its wide rows), E past one
    # sweep of the persistent grids; each also as a view that starts
    # mid-allocation (K1's 4-byte route); K3 at the family's capacity and at
    # the 65536-bit cap
    intersect_rows = load_test_module("intersect_rows")
    entries = {s: next(x for x in report if x["name"] == KERNELS[s]["name"])
               for s in KERNELS}
    for strategy, make, cases in (
            ("broadcast", intersect_rows.family, intersect_rows.CARD_CASES),
            ("bitmap", intersect_rows.bitmap_family,
             intersect_rows.CARD_CASES + intersect_rows.BITMAP_WIDE_CASES)):
        kern, plain = wrappers[strategy]
        wrong, runs = [], 0
        for name, e, w in cases:
            u_np, v_np, bits = intersect_rows.tiled(make, name, e, w, seed=e + w)
            u = torch.from_numpy(u_np).to(dev)
            v = torch.from_numpy(v_np).to(dev)
            offset = (probe_rows.offset_view(u), probe_rows.offset_view(v))
            for kw in ([{}] if strategy == "broadcast" else
                       [dict(num_bits=bits), dict(num_bits=1 << 16)]):
                want = plain(u, v, **kw)
                for a, b in ((u, v), offset):
                    err = int((kern(a, b, **kw).long() - want.long()).abs().max())
                    runs += 1
                    if err:
                        wrong.append((name, e, w, kw, a.data_ptr() % 16, err))
        torch.cuda.synchronize()
        check(not wrong, f"{strategy} kernel == plain on {len(cases)} row "
                         f"families of tests/intersect_rows.py ({runs} launches, "
                         f"aligned and mid-allocation){f': {wrong}' if wrong else ''}")
        entries[strategy]["families"] = dict(cases=len(cases), launches=runs,
                                             max_abs_err=0)
    # K1's and K3's builds: registers and spills of every instance
    lib = _build.build("intersect")
    for strategy, entry_re, label, count in (
            ("broadcast", r"broadcast_(reg_kernelILi(\d+)ELb([01])|counts_kernel)",
             lambda h: (f"broadcast_reg_kernel<{h[2]}, "
                        f"{'true' if h[3] == '1' else 'false'}>" if h[2]
                        else "broadcast_counts_kernel"), 11),
            ("bitmap", r"bitmap_warp_kernelILi(\d+)E",
             lambda h: f"bitmap_warp_kernel<{h[1]}>", 4)):
        build = kernel_build_facts(lib, entry_re, label)
        for inst in build:
            print(f"  build: {inst}")
        check(len(build) == count and all(
            i.get("spill_stores") == 0 and i.get("spill_loads") == 0
            for i in build),
            f"ptxas: the {count} {strategy} instances compile without spills")
        entries[strategy]["build"] = build
    grid_k1 = next(x for x in entries["broadcast"]["subgraph_path"]["shapes"]
                   if x["shape"] == [33554432, 8])
    print(f"  headline: K1 on the grid subgraph (33554432, 8) bucket "
          f"{grid_k1['ms']:.4f} ms against its bound {grid_k1['bound_ms']:.4f} "
          f"ms ({100 * grid_k1['bound_ms'] / grid_k1['ms']:.1f} % of it)",
          flush=True)

    # K4, the masked block-SpGEMM: at the matrix lane's gathered form, on
    # ragged gathered bf16 cases, then on ragged float32 stacks
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardsticks in full fp32

    def gathered_case(label, args, launches=0, full=False):
        """Hold K4's gathered form against its plain version and the
        library call on the same tiles, exactly, and time all three (the
        tensor-core route in both launch orders; the float32 route ignores
        the order); at a path shape also the float32 yardstick on stacks
        gathered for it alone and, for bf16 tiles, the float32 CUDA-core
        kernel on the same triples and the tensor-core kernel with every
        index 0 (one tile of each, served from L2: what the kernel's own
        pipeline takes without tile traffic). Returns the record."""
        l, u, a, li, ui, ai, order = args
        t, b = int(li.shape[0]), int(l.shape[1])
        route = ("masked_spgemm_wgmma" if l.dtype == torch.bfloat16
                 else "masked_spgemm")
        lidx = [x.long() for x in (li, ui, ai)]

        def kern(o=order):
            return masked_spgemm_gathered(l, u, a, li, ui, ai, order=o)

        k_out = kern()
        h_out = kern(None)
        p_out = masked_spgemm_gathered_chunked(l, u, a, li, ui, ai)
        y_out = spgemm_library_gathered(torch, l, u, a, *lidx)
        torch.cuda.synchronize()
        err = float(torch.maximum((k_out - p_out).abs().max(),
                                  (h_out - p_out).abs().max())) if t else 0.0
        y_err = float((k_out - y_out).abs().max()) if t else 0.0
        what = f"({t}, {b}, {b}) {str(l.dtype)[6:]} {label}"
        check(err == 0 and y_err == 0,
              f"{route} == plain == library on the same tiles at {what}, in "
              f"both launch orders")
        del k_out, h_out, p_out, y_out
        wgmma = route == "masked_spgemm_wgmma"
        sorted_ms = time_ms(torch, kern, 7, flush)
        heavy_ms = time_ms(torch, lambda: kern(None), 7, flush) if wgmma \
            else None
        p_ms = time_ms(torch, lambda: masked_spgemm_gathered_chunked(
            l, u, a, li, ui, ai), 3, flush)
        y_ms = time_ms(torch, lambda: spgemm_library_gathered(
            torch, l, u, a, *lidx), 3, flush)
        read = spgemm_read_bytes(torch, args)
        b_ms, b_by = spgemm_bound_ms(t, b, read)
        rec = dict(shape=[t, b, b], label=label, route=route,
                   dtype=str(l.dtype)[6:], launches=launches, ms=sorted_ms,
                   plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                   read_bytes=read, library_ms=y_ms, max_abs_err=err,
                   library_max_abs_err=y_err)
        line = f"  {route} {what}: kernel {sorted_ms:.4f} ms"
        if wgmma:
            rec.update(sorted_order_ms=sorted_ms, heavy_first_ms=heavy_ms,
                       tflops=2 * t * b ** 3
                       / (min(sorted_ms, heavy_ms) * 1e-3) / 1e12)
            line += (f" in the (a_index, l_index) order, {heavy_ms:.4f} ms "
                     f"heavy-first ({rec['tflops']:.1f} TFLOP/s at the "
                     f"faster)")
        line += (f"; plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
                 f"{read / 1e9:.4f} GB named); library on the same tiles "
                 f"{y_ms:.4f} ms")
        if full:
            stacks = [x.index_select(0, i).float() for x, i in
                      ((l, li), (u, ui), (a, ai))]
            f_err = float((spgemm_library(torch, *stacks)
                           - masked_spgemm_gathered_chunked(
                               l, u, a, li, ui, ai)).abs().max())
            check(f_err == 0, f"float32 yardstick == plain at {what}")
            rec["fp32_library_ms"] = time_ms(
                torch, lambda: spgemm_library(torch, *stacks), 3, flush)
            del stacks
            line += (f"; yardstick (torch.bmm(L, U) * A).sum((1, 2)) on "
                     f"float32 stacks {rec['fp32_library_ms']:.4f} ms")
            if wgmma:
                l32, u32 = l.float(), u.float()
                a32 = u32 if a is u else a.float()
                c_out = masked_spgemm_gathered(l32, u32, a32, li, ui, ai)
                c_err = float((c_out - masked_spgemm_gathered_chunked(
                    l, u, a, li, ui, ai)).abs().max())
                check(c_err == 0, f"float32 CUDA-core kernel == plain at {what}")
                rec["cuda_core_ms"] = time_ms(torch, lambda: masked_spgemm_gathered(
                    l32, u32, a32, li, ui, ai), 5, flush)
                del l32, u32, a32, c_out
                line += (f"; the float32 CUDA-core kernel on the same "
                         f"triples {rec['cuda_core_ms']:.4f} ms")
                zero = torch.zeros_like(li)
                z_out = masked_spgemm_gathered(l, u, a, zero, zero, zero)
                z_want = masked_spgemm_gathered_chunked(
                    l, u, a, zero[:1], zero[:1], zero[:1])
                check(bool((z_out == z_want).all()),
                      f"{route} with every index 0 == plain at {what}")
                rec["one_tile_ms"] = time_ms(torch, lambda: masked_spgemm_gathered(
                    l, u, a, zero, zero, zero), 5, flush)
                del zero, z_out
                line += (f"; diagnostic, every index 0 (tiles from L2) "
                         f"{rec['one_tile_ms']:.4f} ms")
        print(line, flush=True)
        return rec

    def spgemm_case(label, l, u, a):
        """Hold K4's stacked form (float32, the CUDA-core route) against
        its plain version, exactly, and time it, the plain version and the
        float32 library yardstick; returns the record."""
        t, b = int(l.shape[0]), int(l.shape[1])
        k_out = masked_spgemm_kernel(l, u, a)
        p_out = masked_spgemm_chunked(l, u, a)
        y_out = spgemm_library(torch, l, u, a)
        torch.cuda.synchronize()
        err = float((k_out - p_out).abs().max()) if t else 0.0
        y_err = float((k_out - y_out).abs().max()) if t else 0.0
        check(err == 0, f"masked_spgemm kernel == plain at ({t}, {b}, {b}) "
                        f"{label}")
        k_ms = time_ms(torch, lambda: masked_spgemm_kernel(l, u, a), 7, flush)
        p_ms = time_ms(torch, lambda: masked_spgemm_chunked(l, u, a), 3, flush)
        y_ms = time_ms(torch, lambda: spgemm_library(torch, l, u, a), 3, flush)
        b_ms, b_by = spgemm_bound_ms(t, b)
        print(f"  masked_spgemm ({t}, {b}, {b}) {label}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
              f"{y_ms:.4f} ms (|kernel - library| max {y_err})", flush=True)
        return dict(shape=[t, b, b], label=label, route="masked_spgemm",
                    dtype="float32", ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=y_ms, max_abs_err=err,
                    library_max_abs_err=y_err)

    path_launches = {"orkut-like": matrix_launches, "road-like": road_launches}
    shapes = [gathered_case(label, args, sum(path_launches[label].values()),
                            full=True) for label, args in spgemm_paths]
    del spgemm_paths
    rng = np.random.default_rng(12)
    ragged = []
    for b in WGMMA_BLOCKS:
        for t in (1, 7, 132 * 3 + 5, 1000, 132 * 40 + 5):
            rec = gathered_case("ragged", gathered_tiles(torch, np, rng, t, b,
                                                         dev))
            check(rec["route"] == "masked_spgemm_wgmma",
                  f"bf16 B = {b} takes the tensor-core route")
            ragged.append(rec)
    for t in (1, 7, 1000):
        for b in (1, 8, 33, 48, 100, 128, 256):
            l, u, a = (torch.from_numpy(x).to(dev)
                       for x in random_tiles(np, rng, t, b))
            ragged.append(spgemm_case("ragged", l, u, a))
    k4 = shapes[0]
    check(k4["route"] == "masked_spgemm_wgmma",
          "the orkut-like path runs the tensor-core route")
    routes = []
    for name, kernel in (("masked_spgemm_wgmma", "masked_spgemm_wgmma_kernel<B>"),
                         ("masked_spgemm", "masked_spgemm_kernel<TM>")):
        mine = [r for r in shapes if r["route"] == name]
        routes.append(dict(
            name=name, kernel=kernel,
            dtype="bfloat16" if name == "masked_spgemm_wgmma" else "float32",
            path=", ".join(r["label"] for r in mine) or None,
            launches=sum(r["launches"] for r in mine),
            ms=sum(r["ms"] for r in mine) if mine else None,
            bound_ms=sum(r["bound_ms"] for r in mine) if mine else None,
            library_ms=sum(r["library_ms"] for r in mine) if mine else None,
            plain_ms=sum(r["plain_ms"] for r in mine) if mine else None,
            ragged_cases=sum(r["route"] == name for r in ragged)))
    build = spgemm_build_facts(_build.build("masked_spgemm"))
    for inst in build["instances"]:
        print(f"  build: {inst}")
    print(f"  build: {build['hgmma']} HGMMA instructions in the library's SASS")
    check(len(build["instances"]) == len(WGMMA_BLOCKS) and all(
        i.get("spill_stores") == 0 and i.get("spill_loads") == 0
        for i in build["instances"]),
        f"ptxas: the {len(WGMMA_BLOCKS)} tensor-core K4 instance(s) compile "
        f"without spills")
    check(build["hgmma"] > 0, f"the library holds {build['hgmma']} HGMMA "
                              f"(wgmma) instructions: the tensor cores run K4")
    order = ("sorted" if k4["sorted_order_ms"] <= k4["heavy_first_ms"]
             else "heavy-first")
    print(f"K4 at orkut-like: {k4['ms']:.4f} ms in the plan's (a_index, "
          f"l_index) launch order, {k4['heavy_first_ms']:.4f} ms "
          f"heavy-first (faster: {order}); bound {k4['bound_ms']:.4f} ms "
          f"({k4['bound_ms'] / k4['ms'] * 100:.1f} % of it); library on "
          f"the same bf16 tiles {k4['library_ms']:.4f} ms (the kernel "
          f"x{k4['ms'] / k4['library_ms']:.3f}); float32 yardstick "
          f"{k4['fp32_library_ms']:.4f} ms; float32 CUDA-core kernel "
          f"{k4['cuda_core_ms']:.4f} ms (x{k4['cuda_core_ms'] / k4['ms']:.2f}); "
          f"every index 0 {k4['one_tile_ms']:.4f} ms")
    entry = dict(
        name="masked_spgemm", route="cuda",
        source="src/repro_torch/csrc/masked_spgemm.cu",
        replaces="src/repro/kernels/masked_spgemm/masked_spgemm.py:35",
        plain="masked_spgemm_gathered_chunked",
        path="orkut-like matrix count() (bf16 tiles: the tensor-core route)",
        launches=k4["launches"], tolerance=0,
        max_abs_err=max(r["max_abs_err"] for r in shapes + ragged),
        ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
        bound_by=k4["bound_by"], library_ms=k4["library_ms"],
        library="(torch.bmm(L[li], U[ui]) * U[ai]).sum((1, 2), "
                "dtype=torch.float32) on the same bf16 tiles (the same "
                "function; the port never calls it)",
        yardstick="(torch.bmm(L, U) * A).sum((1, 2)) on float32 stacks "
                  "gathered for it alone, TF32 off",
        yardstick_ms=k4["fp32_library_ms"],
        cuda_core_ms=k4["cuda_core_ms"], launch_order=order,
        heavy_first_ms=k4["heavy_first_ms"], one_tile_ms=k4["one_tile_ms"],
        design="bf16, B = 128: masked_spgemm_wgmma_kernel, a persistent "
               "grid of one block an SM walking the launch order, 3 "
               "warpgroups (1 TMA producer thread, 2 consumers of 64 "
               "rows), a 2-stage ring of L, U and A tiles by TMA (128-byte "
               "swizzle, 96 KB a stage) and mbarriers, 8 wgmma m64n128k16 "
               "a triple (U MN-major), the mask read from the staged A "
               "tile; float32: masked_spgemm_kernel on the CUDA cores, one "
               "block a triple",
        build=build, routes=routes, shapes=shapes, ragged=ragged)
    report.append(entry)

    # release every plan of phases 2-3c: the new lanes run on an empty card
    del (main_stages, main_csr, bitmap_stages, subgraph_stages, paths, first,
         warm, s, c, res, base, st, l, u, a, v, shapes, ragged, entry)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"released the earlier lanes' plans: memory_allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    report.append(hash_phase(torch, np, dev, flush, analogues, truths))
    edge_ctx = dict(entries=entries, intersect_case=intersect_case,
                    main_tpv=main_tpv, analogues=analogues, flush=flush)
    edge_dynamic_phase(torch, np, dev, edge_ctx)
    tiled_ctx = dict(
        entries=entries, k4=next(x for x in report
                                 if x["name"] == "masked_spgemm"),
        intersect_case=intersect_case, wrappers=wrappers, flush=flush,
        main_count=main_count, main_tpv=main_tpv, main_warm_s=main_warm_s,
        grid=grid, grid_tpv=grid_tpv, analogues=analogues)
    tiled_batch_phase(torch, np, dev, tiled_ctx)
    # phase 3n serves phase 3j's pool and phase 3k's graph again
    service_ctx = dict(
        entries=entries, intersect_case=intersect_case, main_count=main_count,
        main_tpv=main_tpv, pool=tiled_ctx.pop("pool"),
        pool_truths=tiled_ctx.pop("pool_truths"),
        **{k: edge_ctx.pop(k) for k in ("scale18", "scale18_support",
                                        "scale18_truss")})
    del main_tpv, edge_ctx, tiled_ctx

    # -- phase 3e: the bfs lane -----------------------------------------------
    phase(f"phase 3e: bfs lane, TriangleCounter(grid_graph({GRID_SIDE}, ...), "
          f"algorithm='bfs')")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tc = TriangleCounter(grid, algorithm="bfs")
    first = tc.count()
    warm = [tc.count() for _ in range(5)]
    bfs_launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    tpv = tc.triangles_per_vertex()
    tpv_s = time.perf_counter() - t0
    m = first.meta
    print(f"levels_max={m['levels_max']} bfs_rounds={m['bfs_rounds']} "
          f"bfs_sources={m['bfs_sources']} buckets={m['bucket_shapes']} "
          f"strategies={first.bucket_strategies} "
          f"edges/bucket={m['bucket_edges']}")
    print(f"prep_seconds={first.prep_seconds:.4f} first count() "
          f"{first.exec_seconds:.4f} s; warm count() seconds "
          f"{[round(r.exec_seconds, 6) for r in warm]} (median "
          f"{statistics.median(r.exec_seconds for r in warm):.6f}); "
          f"triangles_per_vertex {tpv_s:.3f} s; {peak_memory(torch, held)}")
    print(f"launches over {1 + len(warm)} count(): {bfs_launches}")
    check(all(r.count == EXPECTED_GRID for r in [first] + warm),
          f"count() = {first.count} every time, = 2·2999²")
    check(sum(bfs_launches.values()) == len(m["bucket_shapes"]) * (1 + len(warm)),
          "one intersection launch per bucket per count()")
    check(int(tpv.sum()) == 3 * first.count
          and bool((tpv == grid_tpv).all()),
          f"triangles_per_vertex().sum() = {int(tpv.sum())} = 3 × count, "
          f"= the subgraph lane's per-vertex counts")
    for strategy, entry in entries.items():
        shapes = [intersect_case(strategy, st) for st in tc.plan.stages
                  if st.strategy == strategy]
        if shapes:
            entry["bfs_path"] = dict(
                path=f"grid_graph({GRID_SIDE}) bfs count()",
                launches=bfs_launches[strategy], shapes=shapes)
            entry["max_abs_err"] = max([entry["max_abs_err"]]
                                       + [x["max_abs_err"] for x in shapes])
    check(all(st.strategy in entries and "bfs_path" in entries[st.strategy]
              for st in tc.plan.stages),
          "every bfs grid stage held against its plain version")
    del tc, tpv, first, warm, grid, grid_tpv
    bfs_wide = []
    for name in analogues:
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s = TriangleCounter(load_dataset(name), algorithm="bfs")
        c = s.count()
        m = c.meta
        check(c.count == truths[name]
              and bool((s.triangles_per_vertex() == inter_tpv[name]).all()),
              f"{name} bfs count {c.count} = scipy, per-vertex = intersection "
              f"lane (levels_max {m['levels_max']}, {m['bfs_rounds']} rounds, "
              f"buckets {m['bucket_shapes']}, strategies "
              f"{c.bucket_strategies}, prep {c.prep_seconds:.3f} s, warm "
              f"count {s.count().exec_seconds * 1e3:.3f} ms, "
              f"{peak_memory(torch, held)})")
        for st in s.plan.stages:
            if st.shape_key[1] >= 8192 and st.strategy == "probe":
                u_, v_ = st.args
                k_out = intersect_counts_probe_kernel(u_, v_)
                p_out = intersect_counts_probe(u_, v_)
                torch.cuda.synchronize()
                err = int((k_out.long() - p_out.long()).abs().max())
                check(err == 0, f"{name} bfs probe kernel == plain at "
                                f"{tuple(u_.shape)} "
                                f"({2 * u_.numel() * 4 / 2**30:.2f} GiB)")
                del k_out, p_out
                k_ms = time_ms(torch, lambda: intersect_counts_probe_kernel(
                    u_, v_), 5, flush)
                p_ms = time_ms(torch, lambda: intersect_counts_probe(u_, v_),
                               1, flush)
                b_ms, b_by = bound_ms(*u_.shape)
                shape = dict(graph=name, shape=list(u_.shape), ms=k_ms,
                             plain_ms=p_ms, max_abs_err=err,
                             **probe_extras(u_, v_, b_ms, b_by))
                print(f"  probe {tuple(u_.shape)} ({name} bfs): kernel "
                      f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, all-bytes bound "
                      f"{b_ms:.4f} ms ({b_by})" + probe_line(shape), flush=True)
                bfs_wide.append(shape)
                del u_, v_
        del s, c, st  # st would keep the last stage's rows (up to 16 GiB)
        gc.collect()
        torch.cuda.empty_cache()
    check(bool(bfs_wide), "the bfs lane gave K2 a W ≥ 8192 bucket")
    entries["probe"]["bfs_analogues"] = dict(
        path="bfs forced on the Table-1 analogues", shapes=bfs_wide)

    chooser = chooser_phase(torch, np, dev, dict(analogues=analogues,
                                                 truths=truths))
    service = triangle_service_phase(torch, np, dev, service_ctx)
    sharded_phase(torch, np, dev, dict(
        service_ctx, flush=flush,
        k4=next(x for x in report if x["name"] == "masked_spgemm")))
    del service_ctx
    counters_of = {KERNELS[s]["name"]: (s,) for s in KERNELS}
    counters_of.update(masked_spgemm=("masked_spgemm", "masked_spgemm_wgmma"),
                       hash_probe=("hash_probe",))
    for entry in report:  # K1-K5 ran in the chooser's timed counts
        keys = counters_of.get(entry["name"])
        if keys:
            entry["chooser_path"] = dict(
                path="phase 3m: calibrate() of the sweep, all five lanes",
                launches=sum(chooser["launches"][k] for k in keys))
    serve = serve_phase(torch, np, dev, get_config, get_model, greedy_generate,
                        fa)
    lm_layers = {INT8_ARCH: INT8_LAYERS,
                 VLM_ARCH: get_config(VLM_ARCH).num_layers}
    lm_layers.update(MOE_RUNS)
    whisper = get_config(ENCDEC_ARCH).replace(**SERVE_CUTS[ENCDEC_ARCH])
    lm_layers.update({"encoder": whisper.encoder_layers,
                      "self": whisper.num_layers, "cross": whisper.num_layers,
                      "decode cross": whisper.num_layers,
                      "encoder_seq": whisper.encoder_seq,
                      "whisper_depth": (get_config(ENCDEC_ARCH).encoder_layers,
                                        get_config(ENCDEC_ARCH).num_layers),
                      HYBRID_ARCH: block_kinds(get_config(HYBRID_ARCH).replace(
                          **SERVE_CUTS[HYBRID_ARCH])).count("attn")})
    k6 = flash_phase(torch, np, dev, fa, flush, serve, lm_layers)
    report.append(k6)
    lm_args = (torch, np, dev, get_config, get_model, greedy_generate, fa)
    int8 = int8_phase(*lm_args)
    moe = moe_phase(*lm_args, flush)
    vlm = vlm_phase(*lm_args)
    encdec = own_model_phase(*lm_args, "3s", ENCDEC_ARCH, ENCDEC_BATCH,
                             ENCDEC_PROMPT, ENCDEC_STEPS)
    ssm = own_model_phase(*lm_args, "3t", SSM_ARCH, SSM_BATCH, SSM_PROMPT,
                          SSM_STEPS)
    hybrid = own_model_phase(*lm_args, "3u", HYBRID_ARCH, HYBRID_BATCH,
                             HYBRID_PROMPT, HYBRID_STEPS)
    grad = flash_grad_phase(torch, np, dev, fa, flush, get_config)
    train = train_phase(torch, np, dev, get_config, get_model, fa)
    train_cut = train_cut_phase(torch, np, dev, get_config, get_model, fa)
    sharded_train = sharded_train_phase(torch, np, dev, get_config, get_model,
                                        fa, train, smi)
    sharded_serve = sharded_serve_phase(torch, np, dev, get_config, get_model,
                                        greedy_generate, fa, flush, smi)
    # K6's launches on each serving path of this slice, each read around
    # its own greedy_generate
    k6["serve_paths"] = [
        dict(path=r["path"], launches=r["launches"], prefill_s=r["prefill_s"],
             decode_ms_per_token=r["decode_ms_per_token"],
             own_peak_gib=r["own_peak_gib"])
        for r in [int8, *moe, vlm, encdec, hybrid]]
    k6["lm_serving"] = dict(int8=int8, moe=moe, vlm=vlm, encdec=encdec,
                            hybrid=hybrid)
    # the training paths: K6 forward through FlashAttention (its backward
    # the chunked scan's gradient), launches read around each step
    k6["train_paths"] = [
        dict(path=train["path"], launches=train["launches_per_step"],
             step_s=train["step_s"], tokens_per_s=train["tokens_per_s"],
             own_peak_gib=train["own_peak_gib"])] + [
        dict(path=f"{r['arch']} make_train_step ({r['cut']}): batch "
                  f"{r['batch']} x {r['seq']} in {r['microbatches']} "
                  f"microbatches", launches=r["launches"],
             step_s=r["kernel"]["seconds"]) for r in train_cut]
    k6["training"] = dict(gemma2=train, cut_depth=train_cut, gradient=grad)
    # the sharded training paths: K6 on each rank's local heads
    k6["sharded_train_paths"] = sharded_train["paths"]
    k6["sharded_training"] = sharded_train
    # the sharded serving paths: K6 on each rank's heads, launches read
    # around each prefill; the dry run held to them; K4's share of the
    # paper core's dry-run cell
    k6["sharded_serve_paths"] = sharded_serve["paths"]
    k6["sharded_serving"] = dict(dryrun=sharded_serve["dryrun"],
                                 seconds=sharded_serve["seconds"])
    next(x for x in report if x["name"] == "masked_spgemm")["dryrun_tc"] = \
        sharded_serve["tc"]
    grad_launches = {r["label"].split(" (")[0]: r["launches_per_step"]
                     for r in grad["shapes"]}
    check(train["launches_per_step"]
          == grad_launches[f"{TRAIN_ARCH} local layer"]
          + grad_launches[f"{TRAIN_ARCH} global layer"]
          and all(r["launches"] == sum(
              n for label, n in grad_launches.items()
              if label.startswith(r["arch"])) for r in train_cut),
          "phase 4d's shapes cover every K6 launch of the 3v and 3w steps")
    check([r["launches"] for r in [int8, *moe, vlm]]
          == [r["launches_per_prefill"] for r in
              k6["serve_shapes"] + k6["prefix_shapes"][:1]],
          "phase 4c's layer shapes cover every launch of the 3p–3r prefills")
    enc = {r["label"].split(" (")[0]: r["launches_per_prefill"]
           for r in k6["encdec_shapes"]}
    check(encdec["launches"] == enc[f"{ENCDEC_ARCH} encoder"]
          + enc[f"{ENCDEC_ARCH} self"] + enc[f"{ENCDEC_ARCH} cross"]
          + ENCDEC_STEPS * enc[f"{ENCDEC_ARCH} decode cross"]
          and hybrid["launches"]
          == k6["hybrid_shapes"][0]["launches_per_prefill"],
          "phase 4c's layer shapes cover every launch of the 3s and 3u runs")
    # mamba2-780m runs no kernel (the reference has none for its family);
    # its serving run is reported beside the kernels
    ssm_path = dict(ssm, kernels="none: the reference has no Pallas kernel "
                                 "for the ssm family")
    # K2's CSR form at the benchmark cell's buckets, once everything above
    # has been released
    entries["probe_csr"]["benchmark_cell"] = probe_csr_phase(
        torch, np, dev, flush)
    for entry in report:
        entry.update(max_abs_diff=entry["max_abs_err"], kernel_ms=entry["ms"])

    # -- phase 5: the result --------------------------------------------------
    phase("phase 5: result")
    print(json.dumps({"lm_without_kernels": [ssm_path]}))
    print(json.dumps({"kernels": report}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def main_k2csr() -> int:
    """``python3 chip_smoke.py k2csr``: phase 4e alone (K2's CSR form at
    the graph500-s19 cell's probe buckets), with the environment line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    print(f"nvidia-smi name, power.limit: {nvidia_smi_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib = _build.build("intersect")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    result = probe_csr_phase(torch, np, dev, flush)
    print(json.dumps({"k2_csr_form": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main_k2csr() if sys.argv[1:] == ["k2csr"] else main())
