"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Twelve paths. The conv path is the paper's experiment: the five ResNet-50
convolutions at their published widths and batch 1000, planned for the H100
preset and run through ``repro_torch.ops.conv2d`` on the ``cuda`` backend
(the hand-written direct conv) and the ``im2col`` backend (patch expansion +
the hand-written GEMM), with bf16 inputs and f32 outputs. The serving path
is ``repro_torch.serving.Engine`` serving Qwen2.5-3B at its published widths
(36 layers, d_model 2048, 16 query heads over 2 KV heads, hd 128) with
seeded random weights, through the hand-written flash-attention and
paged-decode kernels. The int8 path is the paper's mixed-precision claim:
the same five layers quantized and run through ``ops.conv2d_q`` (int8 in,
bf16 out), ``ops.matmul_q`` at the reference's GEMM shapes and conv5_x's
Im2Col GEMM, and the same model served from the int8 paged KV pool
(``Engine(kv_dtype="int8")``). The hybrid path serves Jamba-1.5 at its
published widths (d_model 8192, 64 query heads over 8 KV heads, hd 128, d_ff
24576, d_inner 16384, state 16, conv kernel 4, chunk 256, vocab 65536) cut
to one pattern unit of 8 layers (7 mamba, 1 attention) with its MoE FFN
replaced by the dense SwiGLU, through the contiguous engine, the
hand-written causal conv1d kernel (every mamba prefill) and the flash
kernel. The MoE path serves OLMoE-1B-7B at its published widths and full
depth (its routed expert FFN in aten einsums, as the reference leaves it to
XLA) and InternVL2-1B's language backbone, also on stub patch embeddings,
through the same attention kernels. The training path
(``repro_torch.train``) trains HuBERT-xLarge at its published widths and
full depth (48 layers, d_model 1280, 16 heads of hd 80: the hd-80
instance of the flash kernel, non-causal) on stub frame embeddings, and
Qwen2.5-3B at its published widths cut to 8 layers through ``Trainer``,
then checkpoints and resumes the smoke config through
``repro_torch.launch.train``. The recurrent path serves xLSTM-1.3B at its
published widths and full depth (48 layers alternating mLSTM and sLSTM,
d_model 2048, 4 heads of hd 512, chunk 256, vocab 50304) through the
contiguous engine; its blocks are aten (no kernel, as the reference's call
no Pallas kernel). Qwen2.5-3B is also served with the fused (B, KV, L, 2,
hd) KV leaf. The fault-handling path (``repro_torch.resilience``) runs
seeded fault campaigns through the conv path and the two Qwen engines. The
distributed path is the paper's §4.2: ResNet-50's conv1 and conv2_x at
batch 1000 through ``ops.conv2d_dist`` (``repro_torch.distributed``'s
halo-exchange conv) on an in-process mesh of 8 shards on the card, and
conv2_x over 4 ranks of a gloo process group sharing the card. The
language-model mesh path trains the Qwen2.5-3B cut on a (data 2, model 2)
DTensor mesh of 4 gloo ranks sharing the card and dry-runs production
cells on a fake process group. The MoE mesh path trains OLMoE-1B-7B at
its published widths cut to 2 layers on the same mesh, its expert FFN
resharded between groups and experts by all-to-alls (the reference's
``moe_shard_hints``). The mamba mesh path trains Jamba-1.5's mamba block
at its published widths (one block and its dense SwiGLU FFN) on a (data
1, model 4) mesh of 4 gloo ranks sharing the card, each rank's conv1d
kernel on its quarter of the channels. The xLSTM mesh path trains
xLSTM-1.3B at its published widths cut to two (mLSTM, sLSTM) units on the
same (data 1, model 4) mesh, one mLSTM head and 512 sLSTM channels a
rank, and saves a checkpoint from the ranks. The long-context decode
path runs Qwen2.5-3B's ``decode_32k`` step at published widths and full
depth over a 32,768-position cache sharded along its sequence on the
same (data 1, model 4) mesh, each rank's attention through the flash
kernel's launch with row statistics and the shards merged by
all-reduces, against one card.
Phases, each fatal on failure (from phase 3 to phase 24, and in phase
26, each phase's dispatch decisions are recorded, and it fails if one of
them was degraded or the quarantine table is not empty at its end: an
organic fault never passes as a demotion):

  1. device: a CUDA device is required; name, power limit and versions;
  2. build: all seven kernels (and the flash launch with row statistics,
     counted apart from the same library), one nvcc per source (six),
     started together;
     the tensor-core variants of the GEMM, of the direct conv and of flash
     attention (every (hd, block, C) instance of ``flash_tc_kernel``), of
     paged decode (every head-dim instance of ``paged_decode_tc_kernel``),
     of the int8 GEMM (``matmul_q_tc_kernel``) and of the int8 conv
     (``conv2d_q_tc_kernel``): registers and spills from ptxas and the count
     of tensor-core instructions in their SASS (cuobjdump; HMMA for the bf16
     kernels, IMMA for the int8 ones), fatal if a variant has none or a
     main-path variant spills (flash: hd 128 and hd 80 at block 64; paged decode: hd
     128; matmul_q: the variant of the (128, 256) and (256, 128) plans,
     bf16 out; conv2d_q: the (2, 8) variant of the five layers' plans, bf16
     out); the direct conv's LINEAR variant (narrow tiles) is reported
     with the others;
  3. conv and GEMM kernels against their plain PyTorch versions on ragged,
     stride-2 and main-path shapes (TF32 off); each check names the kernel
     its dtype took (bf16: tensor core, f32: fma). The bf16 GEMM cases
     include conv1's 294-byte pitch, a k that is not a multiple of the
     ring's span, m < 16 and an odd pitch over several spans; the conv
     cases c_I = 40 over stages of 16 (the last ragged), a 392-row tile,
     conv5_x's and conv1's tiles, and bf16 inputs 2, 4 and 8 bytes off a
     16-byte boundary; three narrow convs whose H100 plans only the LINEAR
     warp layout covers (784 x 16, 1800 x 8 and 1568 x 8 accumulators, f32
     and bf16 out, fatal unless LINEAR on the tensor cores); conv1, conv2_x
     and conv5_x at full batch (first and last 8 images);
  4. the conv path, launch counters set to 0 just before and read just
     after: one JSON line per layer and backend (tiles, measured words, bound
     ratio, Im2Col/tiled gap, median ms, F.conv2d ms, launches, tensor-core
     launches, error); fatal unless every ``cuda`` conv launch and every
     ``im2col`` GEMM was a tensor-core launch;
  5. each conv-path kernel's time beside its plain version, one library call
     and its bound at the conv path's shapes, with TFLOP/s and GB/s, and for
     the conv its plan-word floor (the words the plan's tiles issue, at the
     HBM rate) (``F.conv2d`` and ``torch.matmul``, the library calls, write
     bf16: half the kernels' f32 output bytes);
  6. flash attention and paged decode against their plain versions (bf16 and
     f32; GQA groups 1 and 8; hd 64 and 128; ragged lengths; int and
     per-row offsets; a pad-tail key mask with one fully masked row; then
     every compiled (hd, block) instance in bf16 at runtime tiles bq 8, 24,
     40 and 128, so that every warp grid R x C runs, over 37, 300 and
     2,085 keys (the last split over clusters of 2 to 8 CTAs wherever the
     folded queries fit one row slab, the launch's cluster that of
     ``launch_config``); ``PAGED_CASES``: paged
     tables with padding and a dead row on block 0, g 1, 8 and 16, hd 16,
     32, 64 and 128, blocks of 4 and 16 keys, w from 1 to 32 with several
     slots a CTA, rows of length 0; and the paged engine's launch, its
     split from the table capacity 512 / 16 = 32: a row of 70 keys must be
     bit-equal at every table width from 5 to 32); each flash and paged
     check names the kernel it took (bf16: tensor core, f32: fma) and fails
     on the other;
  7. the serving path inside ``ops.record_dispatch()``: the paged engine
     and the contiguous engine on the same 8 greedy requests, then a
     cache-less forward of one prompt, the counters set to 0 just before
     and read just after each of the three runs (the paged engine must
     launch both kernels, the other two runs the flash kernel; every flash
     and every paged-decode launch must be a tensor-core launch); every
     request must finish "length" with 32 tokens, both engines must give
     each request the same first token, and no attention decision may
     leave ``cuda``; the launches must be the steps': 36 flash launches a
     prefill (and, contiguous, a decode step) and 36 paged-decode launches a
     decode step (2,232 at 62 steps). Each decode step after the serve's
     first (an eager warm-up) must be a CUDA graph replay, with one graph a
     table width (paged) or one graph (contiguous), each replayed; the
     launches and decisions are met through the replays' credit. Each
     serve's line adds the warm-up steps, replays, graphs and capture
     seconds and the CUDA-event device times of its replays, eager step and
     prefills with their busy share of the wall time; then
     teacher-forced logits of two requests under the ``cuda`` and ``torch``
     backends, and every generated token of both engines against the
     cache-less ``torch`` forward (tolerances below); then the paged
     engine's serve once more under ``torch.profiler``: device time by
     kernel kind and by kernel, the device's busy share against the
     untraced serve's wall time beside the CUDA events' device time of the
     same traced serve (a profiler sum below the events' lost kernels), and
     the traced serve's own wall time and decode step (the profiler's cost
     on the host);
  8. each attention kernel's time beside its plain version, its library call
     and its bound at the serving shapes, and ``ops.explain``'s words and
     bound ratio for one prefill and one decode call; for flash attention,
     SDPA and paged decode also a per-launch time (CUDA events around 50
     back-to-back calls, divided by 50) and the device time of a call (a
     CUDA graph of 20 calls, replayed: no host work between them), the
     prefill's TFLOP/s on the compulsory work, and paged decode's split S
     and CTA count (paged decode launched as the engine launches it, its
     split from the table capacity 32);
  9. the int8 kernels against their plain versions: phase 3's six conv cases
     (ragged tiles, stride 2, h_F = 1, c_I = 3), each main-path int8 tile at
     a small N, H and W with ragged edges (conv1's one stage and zero plane;
     c_I = 37 over ring stages of 32; three stages; whole-plane windows),
     stride 2 over two stages, a tile only the LINEAR warp layout covers,
     and int8 inputs 1, 4 and 8 bytes past a 16-byte boundary, each conv
     check naming the kernel it took (``on tensor core``), fatal on
     another; and the GEMMs: five with
     ragged m/n/k, the main path's (128, 256) and (256, 128) tiles at a
     small m with k ragged against the ring's span (and once with an odd
     pitch), a bm = 1 tile over three row tiles, a tile only the LINEAR
     warp layout covers, two row slices of A (one 16-byte aligned, one at
     an odd offset), and the narrow plans of GEMMs with m or n of 16 or
     less, which the kernel cuts into CTA shares (m in {1, 4, 8, 16} x n in
     {2048, 4096} at k = 4096, and (m, k, n) = (2048, 64, 16) and
     (2048, 4096, 16)), quantized with ``quantize_conv_operands`` /
     ``quantize_matmul_operands``, f32 and bf16 out; each GEMM check names
     the kernel it took (``on tensor core``) and fails on another;
 10. the int8 conv path, the counter set to 0 just before and read just
     after: phase 4's bf16 inputs quantized on the card, through
     ``ops.conv2d_q`` on ``cuda``; one JSON line per layer (tiles, measured
     words, mixed-precision bound and ratio, the ratio to the bf16 conv's
     words, which must be <= 0.55 as the reference gates it, median ms,
     launches, error on the first and last images); fatal unless every
     launch (30) was a tensor-core launch;
 11. the int8 GEMMs, counter to 0 before and read after: (m, k, n) =
     (512, 384, 256) and (2048, 2048, 2048) (the reference's
     scripts/verify.py) and conv5_x's Im2Col GEMM (49000, 4608, 512); fatal
     unless every launch (18) was a tensor-core launch; words, bound ratio,
     ms, plain ms, ``torch._int_mm`` + scale as library time, TOP/s and
     GB/s on the compulsory work, error on the first and last rows; then,
     after the counts are read, the time a launch takes back to back (50
     calls) and the device time of a call (a replayed CUDA graph, as in
     phase 8), for the kernel and for ``torch._int_mm`` + scale, as the
     per-call time of the small GEMMs is mostly host work;
 12. the int8 KV serve: phase 7's 8 requests through ``Engine(paged=True,
     kv_dtype="int8")``, counters to 0 before and read after; every request
     must finish "length" with 32 tokens, its first token must equal the
     bf16 paged engine's, every ``attention`` decision must be ``cuda`` and
     every ``attention_decode_quant`` decision ``torch`` by request, every
     flash launch a tensor-core launch, every decode step but the warm-up a
     replay (phase 7's graph gates), and phase 7's decode check must
     pass; the share of tokens equal to the bf16
     pool's, the pool's capacity gain and the serve's times are reported,
     and the serve is traced as in phase 7; then, per int8 conv layer, a
     call (phase 10's), a launch (50 back-to-back calls) and the device time
     (a replayed CUDA graph, as in phase 8) beside the plain version's time
     and the bound, with TOP/s, GB/s and the share of the bound on the
     device time, and their sums;
 13. the conv1d kernel against its plain version (bf16 and f32), each
     check naming the copy its launch took (16-byte ``cp.async.cg``, 8- or
     4-byte ``cp.async.ca``, or 2-byte loads), the CTA's channel span and
     the grid: ragged B and D, K in {1, 2, 4, 8}, L = 1, L < K - 1, L at
     one ring chunk and one row past it, L = 1000 (more chunks than ring
     slots), nD == 1 (the counter's one-fetch case), plan tiles split over
     CTAs, the path's shape (1, 300, 16384) at K = 4 and 8, also as the
     strided x half of the in-projection, and strided views 1, 2 and 4
     elements past an aligned base (the narrower copies); expected error 0;
 14. the hybrid serve inside ``ops.record_dispatch()``, counters set to 0
     just before and read just after: 8 greedy requests (prompt lengths
     from ``numpy.default_rng(0)`` with lengths 1 and 2 admitted into used
     slots and one of 300, two SSD chunks), 32 new tokens, 4 slots,
     ``max_len`` 512; every request must finish "length" with 32 tokens,
     conv1d must launch exactly 7 x 8 = 56 times, every flash launch must
     be a tensor-core launch, every ``conv1d_causal`` and ``attention``
     decision must be ``cuda``, every decode step but the warm-up a replay
     of the one graph; then phase 7's
     teacher-forced and decode checks at 8 layers; the serve's times, its
     ``torch.profiler`` trace, and one decode step's forward alone
     (launches, device time) beside the weight-stream floor;
 15. the conv1d kernel at each prefill shape of the serve, and
     ``F.conv1d`` (groups = D, on a channels-first copy made outside the
     timing), each timed as a call (CUDA events around one call, host work
     included), a launch (50 back-to-back calls) and on the device (a
     replayed CUDA graph of 20 calls), with the device time's share of the
     bound, the plain version's time and ``ops.explain``'s words; fatal
     unless the kernel's error is 0; then one line of sums;
 16. the static audit (``repro_torch.verify``) of every main-path
     dispatch at full width under ``H100``, on the operands phases 4, 8, 10,
     11 and 15 leave: the five layers on ``cuda``, ``im2col`` and
     ``conv2d_q``, phase 11's three GEMMs, the Qwen prefill and contiguous
     decode attention, phase 8's paged decode with its tables and lengths
     (at capacity w and at the engine's capacity 32),
     and the hybrid's 8 conv1d prefill shapes. Each is audited by
     ``ops.explain(..., audit=True)`` (counted words equal to the counter,
     shared memory within the card's, every ``cp.async`` ring schedule
     hazard-free), launched once through its public entry, and held to its
     plan: the wrapper's ``last_launch`` grid, block, shared memory and
     cluster must be the plan's, and the words the counter does not charge
     and the shortfall must equal their formulas (the int8 kernels'
     per-CTA scale slices, conv1d's per-CTA filter reads, paged decode's
     dead slots, the im2col GEMM's padded k-step and filter transpose,
     flash's offsets; the window runs' overhang within run - 1 elements a
     row); one ``{"audit": ...}`` line each, fatal on any mismatch;
 17. the autotuner (``repro_torch.plan.autotune``) on the device timer:
     ``Planner(H100).autotune`` with the default policy on the five layers
     as bf16 convs (``conv2d_tc_kernel``) and as int8 convs under
     ``H100.with_quant`` (``conv2d_q_tc_kernel``), their five Im2Col GEMMs
     (``matmul_tc_kernel``) and phase 11's three int8 GEMMs
     (``matmul_q_tc_kernel``): 18 searches on the operands phase 16 leaves.
     Every timed candidate runs once at full size and is held against the
     plain version (the first and last images or 4,096 rows), fatal on
     disagreement; each tuned plan then goes through its public entry
     (``ops.conv2d``/``matmul``/``conv2d_q``/``matmul_q`` with
     ``autotune=True``): ``plan_source`` "tuned", the winner's words, the
     static audit, ``last_launch`` equal to the plan and the output; the
     plan cache's save/clear/load round trip must then re-plan all 18 with
     no search. Last, the five bf16 conv searches again with
     ``bound_cap=inf``. One ``{"autotune": ...}`` line a search (candidates
     enumerated, in the frontier, audited, not auditable by reason; the
     analytic tiles, the winner and the roofline's pick with words and
     device ms; words against time as a rank correlation; the fitted
     ``DMA_SETUP_SECONDS``) and a summary line;
 18. the decode steps as CUDA graphs (``repro_torch.serving.graphs``):
     for the paged bf16, contiguous and paged int8 engines of Qwen2.5-3B
     and the hybrid engine of phase 14's Jamba cut, at published widths
     with 4 slots, a seeded random cache and one step's inputs
     (``probe_inputs``: every row live at a random depth), the step run
     eagerly and as a captured graph's replay on clones of that state
     (``check_replay``); fatal unless the logits and every cache leaf are
     equal bit for bit. One ``{"graph_step": ...}`` line an engine: the
     eager step's host and device ms, the replay's host and device ms, the
     capture's seconds, five replays under ``torch.profiler`` (its kernel
     time a replay beside the CUDA events' of the same run: whether the
     profiler loses kernels of a graph), the weight-stream floor, and the
     graphs, warm-ups
     and capture seconds of that engine's serve in phases 7, 12 and 14;
 19. OLMoE-1B-7B, the MoE FFN (``repro_torch.models.moe``) at published
     widths and full depth (16 layers, d_model 2048, 16 query heads over 16
     KV heads, hd 128, 64 experts top 8 of d_ff 1024, vocab 50304; 6.92 B
     seeded random parameters made on the card after the earlier phases'
     models and operands are freed; the peak of allocated memory printed):
     phase 7's 8 requests through the paged and the contiguous engine at
     the published capacity factor 1.25, inside ``ops.record_dispatch()``
     and ``moe.count_drops`` (the choices dropped at capacity, replays
     included), each held to ``serve_and_gate`` (32 tokens "length", phase
     7's graph gates, 16 flash launches a prefill and 16 paged-decode
     launches a decode step, all on the tensor cores), every attention
     decision on ``cuda``, first tokens equal across the engines, and
     teacher-forced logits of two requests (below); then a paged serve at
     capacity factor E / K = 8, where no group can drop a choice (fatal on
     a drop), whose every token goes through ``decode_check``; then one
     decode step eagerly and replayed (phase 18's ``check_replay``, bit for
     bit, fatal otherwise) with its device and host ms, kernels a replay
     and capture seconds beside the step's two weight floors: all weights
     but the embedding (the dense dispatch reads every expert) and one
     token's active ones;
 20. InternVL2-1B's language backbone at published widths and full depth
     (24 layers, d_model 896, 14 query heads over 2 KV heads: a group of
     7, hd 64, vocab 151655): the same 8 requests through the paged engine
     with phase 19's gates, teacher-forced and decode checks; then one
     forward over stub patch embeddings ((2, 256, 896), seeded) through
     ``embeds=``, its 24 flash launches on the tensor cores and its logits
     under ``cuda`` within the allowance of the ``torch`` backend's;
 21. HuBERT-xLarge trained at published widths and full depth (1.26 B
     seeded f32 parameters made on the card after the earlier phases'
     models are freed; one fixed batch of 8 x 512 frames of stub
     embeddings 0.1 N(0, 1) and labels in [0, 504)): from the same weights
     and batch, the ``cuda`` forward's logits within the allowance of the
     ``torch`` backend's (n_layers = 48), the ``cuda`` step's loss within
     the same allowance and its gradient's global norm within 1e-2
     relative of the ``torch`` backend's (both run the same aten backward,
     on inputs that differ by one bf16 rounding a layer); 48 flash launches
     in the step's forward, all on the tensor cores, every attention
     decision on ``cuda``; 8 steps of ``make_train_step`` (AdamW lr 1e-3,
     warm-up 2, 8 steps; no remat) with every loss and grad norm finite,
     the parameters moved and the last loss below the first. Reported:
     step ms (CUDA events, median of steps 2-8), frames/s, the plain
     products' share 6 N tokens / step time / 989 TFLOP/s, peak memory;
     one more step taken apart (forward, backward and AdamW between CUDA
     events, its kernels by kind under ``torch.profiler``); then the hd-80
     instance at the step's attention shape (a call, a launch, device
     time) beside SDPA's;
 22. Qwen2.5-3B at published widths cut to 8 layers (its full 36 layers'
     3.09 B parameters need 49 GB of f32 weights, gradients and moments
     before any activation; phase 21 is the full-depth leg), 8 steps
     through ``Trainer`` on ``SyntheticSource`` batches of 4 x 512 tokens
     with the chunked cross entropy (8 chunks): 8 flash launches a
     forward, all on the tensor cores; the first batch's logits and loss
     under ``cuda`` within the allowance of ``torch``'s; every loss
     finite. Then the smoke config through ``launch.train.main`` for 6
     steps with a checkpoint every 3, the newest checkpoint removed and
     the run started again: it resumes at step 3 and its losses equal the
     uninterrupted run's within 1e-3 relative;
 23. the fused KV layout: Qwen2.5-3B rebuilt from phase 7's seed with
     ``fused_kv_cache=True`` (one (B, KV, L, 2, hd) leaf a layer) through
     the contiguous engine on phase 7's 8 requests, under
     ``serve_and_gate`` (36 flash launches a prefill and a decode step, all
     on the tensor cores, every attention decision on ``cuda``); every
     token must equal phase 7's split contiguous serve's bit for bit (the
     kernel reads the same values); then one decode step of the split and
     of the fused layout eagerly and replayed (phase 18's ``check_replay``,
     bit for bit), with each replay's device and host ms and, under
     ``torch.profiler``, its copy kernels (the ``.contiguous()`` of the
     strided K and V views before the flash kernel) and their share of the
     replay's kernel time;
 24. xLSTM-1.3B at published widths and full depth (1,113,229,504 seeded
     parameters made on the card after the earlier phases' models are
     freed; the count and the peak memory printed): on layer 0's weights at
     L = 600 (three chunks, the last ragged), ``mlstm_block`` against
     ``mlstm_block_ref``, ``mlstm_block`` from a carried state (300 + 300)
     against the whole 600, and ``slstm_block`` against 600
     ``slstm_decode_step``s, each within 2^-7 x max(1, max|ref|); then
     phase 7's 8 prompts over vocab 50304 and one of 600 tokens through the
     contiguous engine with 4 slots under ``serve_and_gate`` (32 tokens
     "length", no kernel launched: the blocks are aten), in the published
     bf16 compute and again in f32 compute on the f32 weights; every
     generated token through ``decode_check`` against the cache-less
     forward (the chunked prefill and the recurrent decode against the
     chunked forward): the f32 serve's within ``logit_allowance(48)``, the
     bf16 serve's within the larger of that allowance and the bf16
     forward's own noise (below); and ``check_replay`` on a probe state,
     bit for bit; reported: the replay's device and host ms, kernels a
     replay, capture seconds, tok/s, the prefill median and two floors
     (the bf16 weight stream; the f32 recurrent state read and written a
     step at 4 slots);
 25. fault handling (``repro_torch.resilience``), the launch counters
     set to 0 before each half and read after it. (a) The conv path's
     degradation, priced: on each of the five layers (batch 1000, bf16 in,
     f32 out, H100 plan, ``cuda`` context) a rate-1.0 launch fault must
     give one decision, ``degraded`` with ``fault`` "KernelLaunchError" and
     ``chosen`` "im2col", its ``measured_words`` equal to ``ops.explain``
     on an ``im2col`` context, its output bit-equal to ``ops.conv2d`` there
     and the injection resolved "degraded"; the calls the quarantine still
     serves run on Im2Col (timed with CUDA events) and the next one, the
     8th resolution since the fault (``QUARANTINE_PROBE_AFTER``), runs on
     ``cuda`` again, bit-equal to the un-faulted conv, with the quarantine
     table empty; on conv1 a numeric fault (the kernel runs, its NaN is
     caught, the call degrades, bit-equal to Im2Col) and a device fault
     (``DeviceLost`` propagates, resolved "fatal", nothing quarantined).
     One line a layer: the words ratio degraded over primary and both
     calls' ms. On the ``cuda`` GEMM (no ``degrade_to``) at 2048^3 a
     launch, a dma and a numeric fault each retry in place on ``cuda``
     (never ``torch``), bit-equal, resolved "retried"; a persistent one
     raises after ``MAX_RUNTIME_ATTEMPTS`` attempts with no launch. (b) The
     serving campaign: Qwen2.5-3B (seeded again) through the paged bf16
     and the contiguous engine with phase 7's requests and slots, one clean
     serve each, then campaigns over launch+dma+numeric+oom+pool at seeds
     0, 1 and 2 (rate 0.2) and seed 0 at rate 0.05 (``robust_bench``'s
     default), and on the paged engine seeds 3, 4, ... until the union has
     injected at all six engine sites. Each campaign must account every
     injection (``verify_accounted``), finish every request, replay graphs,
     make no degraded or off-``cuda`` decision, and give each request the
     clean serve's tokens bit for bit (a failed one a clean prefix of
     them); at rate 0.05, run three times in turns with three more clean
     serves (whose tokens must be the first clean serve's), completion
     must be >= 0.99 in each and the faulted serves' median tok/s >= 0.4x
     the clean serves' median. After each pool rebuild every live row's K/V in the
     rebuilt pool is compared with the old pool's, through the old and new
     tables (the corruption is metadata only); where a rebuild is not bit
     for bit, a request live across it is held to phase 7's decode check
     instead. One line a campaign (summary, injections by site, kind and
     resolution, completion, tok/s, rebuilds, graph resets, captures, the
     rebuilds' K/V differences) and a summary line;
 26. the distributed conv (``repro_torch.distributed``), inside
     ``ops.record_dispatch()`` and fatal if a decision was degraded.
     (a) ResNet-50's conv1 and conv2_x at batch 1000 (phase 4's bf16
     inputs, f32 out) through ``ops.conv2d_dist`` on a ``cuda`` context
     whose target is ``H100.from_mesh(mesh)``, on a ``LocalConvMesh`` of
     P = 8 shards on the card, and through ``distributed.allgather_conv``,
     the naive baseline, on each of three grids: the parallel LP's (fatal
     unless it is the reference's {"N": 8}) and the reference bench's
     probes {"hO": 4, "wO": 2} and {"cI": 2, "hO": 2, "wO": 2}; the
     launch counters set to 0 just before each run and read just after:
     fatal unless every one of the 8 shard-local ``conv2d`` decisions is
     ``cuda``, not degraded and without a parallel section, and all 8
     launches are tensor-core launches; every device's counted wire words
     (by kind: shifts, psum, all-gathers) must equal ``ops.explain``'s
     ``measured_words``, the counters and the reference's word table
     (``DIST_WORDS``) exactly, the combined Thm 2.2/2.3 bound at 2^20
     words the reference's; the single-device ``cuda`` conv and both
     outputs must agree with the plain version (``conv2d_plain``, whole
     batch, same inputs) within phase 3's f32 tolerance, and both outputs
     with the single-device conv too (each line says whether bit for
     bit); the halo conv must move fewer words
     than the all-gather on the LP grid and on {"hO": 4, "wO": 2} (on the
     cI probe of conv1 it moves more, 216.5e6 against 94.2e6: printed,
     not gated). One ``{"dist_conv": ...}`` line a (layer, grid) with the
     words, the plan's own parallel bound at the H100's M_eff, and the
     CUDA-event ms of the halo conv, the all-gather conv and the
     single-device conv (the shards run in turn on one card: what the
     decomposition costs one card, not a speedup). (b) Phase 16's audit
     of one shard-local dispatch a (layer, grid), on a window of the
     shard's exact shape (conv1's {"hO": 4, "wO": 2}: (1000, 3, 63, 121)
     under a 7 x 7 stride-2 filter): audited clean, launched as its
     access plan says, on the tensor cores, within phase 3's f32
     tolerance of the plain version on that window, the uncounted words
     only the window runs' overhang; one ``{"dist_audit": ...}`` line
     each with the shard conv's ms. (c) conv2_x cut to batch 64 through 4 gloo
     ranks (``GroupConvMesh``; each rank this script with ``--dist-rank``,
     a process of its own, started after phase 2's build, its shard on
     ``cuda:0`` and its conv on ``conv2d_tc_kernel``, one launch a grid),
     joined under ``GROUP_TIMEOUT`` (a hung rank is killed, and fails the
     phase): {"hO": 2, "wO": 2} bit-equal to the in-process mesh, {"cI":
     2, "hO": 2} within 1e-4 (gloo's sum order), both within phase 3's
     f32 tolerance of the plain version, every rank's counted words equal
     to the counter's; one ``{"dist_group": ...}`` line a grid and a
     summary line. A ``{"cycle_check": ...}`` line after every phase
     gives the card memory that only reference cycles held (a collection
     frees it; ``flag`` where not 0), fatal after (a)-(b) and after (c);
 27. the language-model mesh. (a) Qwen2.5-3B at published widths cut to
     ``MESH_TRAIN_LAYERS`` = 4 layers (B 4, L 512, seed 0), 2 AdamW steps (lr
     1e-3) through ``launch/train.py`` on one card, then through
     ``launch/train.py --mesh 2,2`` on 4 gloo ranks sharing the card (each
     this script with ``--mesh-rank``, ``torchrun``'s environment, joined
     under ``MESH_TIMEOUT``): every rank's losses within 1e-2 relative of
     the single-device run's and within ``MESH_LOSS_TIGHT`` (1e-4), which a
     run that did not update fails (the no-update control: the
     single-device run's first parameters on the second batch, fatal if it
     reads inside the bound), its parameters within 2 x lr x steps of
     them, its AdamW first moments (0.09 g1 + 0.1 g2 after two steps: the
     gradients of both steps) within ``MESH_MOMENT_TOL`` of the
     single-device run's relative to each leaf's largest |value| (no
     update reads 1, a wrong sign 2), its 8 flash launches all on the
     tensor cores, its wire bytes
     by kind each step and its argument bytes equal to
     ``dryrun.count_train_step``'s count of the same step on a fake group
     of 4, and the single-device checkpoint restored onto the mesh with
     ``shardings=`` and gathered back over a CPU mesh bit for bit. Then
     2 more steps from the same init with ``MESH_OPTIONS`` on
     (``microbatches=2``, ``compress_grads``, ``remat``), on one card and
     in the same ranks, under the same gates against one card and the
     count of that step (flash 32 times a rank: a forward a microbatch,
     and remat's recomputation); the step s a rank and on one card, plain
     and with the options, in the summary line. (b)
     In a process of its own (``--dryrun``, no card memory), started
     with phase 27 so that its host work runs beside phases 27-31, and
     read after phase 31 (fatal past ``DRYRUN_TIMEOUT`` from its start):
     the dry run at full depth of 27 of the 31 cells of
     ``configs.all_cells()`` on (16, 16) (``DRYRUN_LEFT_OUT``: four
     ``train_4k`` cells) and Qwen2.5-3B's ``train_4k`` on (2, 16, 16),
     OLMoE-1B-7B's and Phi-3.5-MoE's ``train_4k`` with
     ``moe_shard_hints`` (fatal unless each counts all-to-alls), and
     Jamba-1.5's and xLSTM-1.3B's ``train_4k`` and ``prefill_32k``
     extrapolated from R = 1 and 2 to the model's repeats (Jamba's 9,
     xLSTM's 24; fatal otherwise); one ``{"dryrun": ...}`` line a cell
     with its host seconds, the report's tables, and the process's own
     seconds;
 28. the MoE FFN on the mesh: OLMoE-1B-7B at published widths (d_model
     2048, 16 heads over 16 KV heads, 64 experts top 8 of d_ff 1024, vocab
     50304) cut to 2 layers (1.05 B f32 parameters), B 4, L 512, seed 0,
     2 AdamW steps (lr 1e-3) through ``launch/train.py --moe-shard-hints
     --moe-groups 4`` on one card, then with ``--mesh 2,2`` on 4 gloo
     ranks sharing the card (each this script with ``--moe-rank``; 8 query
     heads and 32 experts a rank; the dispatch's groups one a rank, each
     G <-> E reshard an all-to-all), under phase 27 (a)'s gates (losses
     within 1e-2 and ``MESH_LOSS_TIGHT`` beside the no-update control at
     the same 4 groups, first moments within ``MESH_MOMENT_TOL``,
     parameters within 2 x lr x steps, 4 flash launches a rank all on the
     tensor cores, wire bytes by kind each step and argument bytes equal
     to ``dryrun.count_train_step``'s), fatal unless every rank's every
     step holds all-to-alls; each forward's routing is recorded on both
     sides (``moe.record_routing``) and the (token, k) choices that differ
     on each rank's groups, the kept masks that differ, the drops and the
     single run's smallest k-th to (k+1)-th probability gap are printed
     beside the gates (a near-tie that bf16 noise breaks otherwise on the
     mesh sends a token to another expert);
 29. the mamba block on the mesh: Jamba-1.5 at published widths (d_model
     8192, d_inner 16384, 128 heads of 128, state 16, conv kernel 4, d_ff
     24576, vocab 65536) cut to one mamba block and its dense SwiGLU FFN
     (``dataclasses.replace(cfg, pattern=("mamba",), n_layers=1,
     n_experts=0)``: 2,083,086,720 f32 parameters), B 4, L 512 (two
     256-token chunks), seed 0, 2 AdamW steps (lr 1e-3, the launcher's
     schedule) through ``Trainer`` on one card, then ``Trainer(mesh=)`` on
     a (data 1, model 4) mesh of 4 gloo ranks sharing the card (each this
     script with ``--mamba-rank``; a quarter of every ``model``-sharded
     leaf a rank, placed as it is made), under phase 27 (a)'s gates on
     losses (beside the no-update control), parameters and first moments,
     plus: every rank's wire bytes by kind each step and its argument
     bytes equal to ``dryrun.count_train_step``'s, 2 ``conv1d_ring_kernel``
     launches a rank (one a forward) and 2 on one card, each rank's first
     local launch (its (4, 512, 4096) channels) equal to its plain
     version on the same inputs (``conv1d_causal_plain``, the kernel's
     order of taps: expected error 0) and within one bf16 rounding of
     the aten oracle (``conv1d_causal_ref``); a step's seconds, GB a rank
     after the run and at peak, and each kind of leaf's worst error
     (mamba, FFN, embedding and head, norms) printed;
 30. the xLSTM blocks on the mesh: xLSTM-1.3B at published widths
     (d_model 2048, 4 heads of hd 512, chunk 256, vocab 50304) cut to
     ``XLSTM_MESH_LAYERS`` = 4 layers, two (mLSTM, sLSTM) units
     (282,126,352 f32 parameters), computed in f32 (in bf16 re-associated
     partial sums alone move its first moments by up to half their
     largest value: ``scripts/xlstm_mesh_bf16.py``), B 4, L 512, seed 0,
     2 AdamW steps
     (lr 1e-3, the launcher's schedule) through ``Trainer`` on one card,
     then ``Trainer(mesh=)`` on a (data 1, model 4) mesh of 4 gloo ranks
     sharing the card (each this script with ``--xlstm-rank``; one mLSTM
     head and 512 sLSTM channels a rank), under phase 29's gates (losses
     beside the no-update control, parameters, first moments, wire and
     argument bytes equal to ``dryrun.count_train_step``'s), each kind
     of leaf's worst error printed (mLSTM, sLSTM, embedding and head,
     norms); the hand-written kernels' launches on the ranks and on one
     card by kind (the blocks dispatch none: every count 0, fatal
     otherwise). Then the ranks save a checkpoint
     (``Trainer.save_checkpoint``: each leaf made whole by all-reduces,
     rank 0 writes), fatal if any all-gather is counted there; rank 0
     writes a sha256 of each gathered leaf, and the checkpoint restored
     on the card (``checkpoint.restore``) must match every digest;
     a step's seconds and GB a rank printed;
 31. decode over a sequence-sharded cache, beside phase 27 (b)'s dry
     run. (a) The flash launch with row statistics (``stats=True``: the
     unnormalised f32 accumulator, the row max and the row sum) against
     its plain version at a rank's shard (16 rows = B 8 x KV 2, 8 folded
     queries, 8,192 keys, hd 128, bf16) and at one card's cache (32,768
     keys), with a scalar, a per-row and a negative offset (every key
     masked), and at the rank's shard in f32 (the FMA kernel, not split):
     the accumulator within 2^-7 (bf16) or 1e-4 (f32) x max(1,
     max|plain|), m and l within 1e-4 relative, the masked shard's m
     exactly NEG_INF and its merge weight exactly 0, HMMA in the
     instance's SASS and every bf16 launch a tensor-core launch on the
     key split (S 8, 128 CTAs, the grid and cluster of
     ``launch_config``); the bf16 launches' ms (a call, a launch, device)
     beside the plain version, aten's
     ``_scaled_dot_product_flash_attention`` on the folded rows and the
     bound; then one card's launch without statistics (bf16 out, the
     launch of (b)'s one-card step) within 2^-7 of its plain version, on
     the split, timed beside ``F.scaled_dot_product_attention`` on the
     same folded rows. (b) Qwen2.5-3B at published widths and
     full depth (36 layers), B 8 (one data group's share of
     ``decode_32k``), a 32,768-position cache: one card fills it with a
     32,760-token seeded prompt (``hidden_forward`` a row at a time, no
     full logits) and decodes 8 greedy steps through
     ``dryrun.build_decode_step``; the cache's four sequence shards reach
     4 gloo ranks on (data 1, model 4) through CUDA IPC (each this script
     with ``--seqdec-rank``; no gloo), which decode the same 8 steps on
     the ``cuda`` backend teacher-forced on one card's tokens: every
     step's logits within the teacher-forced allowance (36 layers) of
     one card's, 288 stats launches a rank all on the tensor cores and no
     other launch, 288 plain flash launches on one card, each step's
     wire bytes by kind and the argument bytes equal to
     ``dryrun.count_decode_step``'s count under
     ``dtensors.all_reduce_gathers`` (all-reduces only); the prefill's
     and a step's seconds, GB a rank printed;
 32. the ``kernels`` JSON line (the flash entry lists its compiled
     instances, the hd-80 timing and phases 27's and 28's rank launches;
     the conv entry its phase-26 shard launches; the conv1d entry phase
     29's rank launches; the stats entry phase 31 (b)'s rank launches and
     phase 31 (a)'s times), the card's name and power limit, and the last
     line ``{"ok": true, "device": {...}}``.

Inputs are random, made on the device from fixed seeds. Tolerance: an
output agrees when max|kernel - plain| <= tol * max(1, max|plain|), with tol
1e-4 for f32 outputs (both sides accumulate in f32, in a different order;
bf16 x bf16 products are exact in f32) and 2^-7 for bf16 outputs (one bf16
rounding). The int8 kernels sum exactly in int32 and their plain versions
exactly in float64, then both convert to f32, scale and cast the same way, so
their expected error is 0; they are held to the same tolerances. The
conv1d kernel and its plain version add the taps in one order with f32
roundings (no FMA contraction), so their expected error is 0 too.

Teacher-forced logits: the two backends share every bf16 projection and
differ only in the attention outputs, which may round to neighbouring bf16
values (2^-8 relative). One such rounding enters the residual stream per
attention layer and is carried through the remaining layers, so the logit
difference grows like a random walk over the layers: the check allows
max|cuda - torch| <= 4 * 2^-8 * sqrt(n_layers) * max(1, max|logits|) (four
standard deviations of that walk; 0.094 of the logit scale at 36 layers)
and prints the measured error beside it. With experts (phase 19) a near-tie
of the router that the two backends break differently sends a token to
another expert and, at capacity, moves which later tokens are dropped:
the ``torch`` forward is run twice, routed freely (its error, the (token,
layer, k) choices that differ and the smallest k-th to (k+1)-th
probability gap are printed) and routed to the ``cuda`` run's choices
(``expert_choices``), which is held to the allowance. On the hybrid path
the mamba layers' conv1d outputs differ between the backends in the same
way (the oracle sums its taps in another order before the bf16 cast), one
rounding per layer: the same allowance with n_layers = 8.

Generated tokens: the engines decode from their KV caches (paged blocks,
shared prefixes, per-row slots), so each request's prompt and generated
tokens go once more through the cache-less forward under the ``torch``
backend. Each greedy token was the argmax of the engine's logits, which
differ from those of that forward only by attention roundings; so the
token's logit there must lie within the same allowance of its row's max
(a near-tie where the two argmaxes differ). A wrong block table, slot
write or shared-block mapping gives the token a logit far from the max, and
so does a mamba state spliced wrongly into its slot (a conv tail shorter
than K - 1 rows written at the start of the slot's tail).
The check prints how many positions were the exact argmax.

The allowance's premise, one rounding a layer, does not hold for xLSTM in
bf16: its recurrent state carries every step's roundings into all later
positions and layers. ``scripts/xlstm_noise.py`` measures it on a
205-token sequence (NVIDIA H100 80GB HBM3, 700.00 W): at 48 layers two
equally valid cache-less forwards (chunk 256 and chunk 64) differ by 0.88
over the 32 decoded rows and a teacher-forced decode by 0.67, against an
allowance of 0.52, and the gap grows faster than the allowance's square
root of the depth (0.016 at 2 layers, 0.37 at 32); in f32 compute the
recurrent decode and the chunked forward differ by 6.7e-4. So phase 24
holds an f32 serve's tokens to the allowance, and the bf16 serve's to the
larger of the allowance and that forward noise, measured on each request's
own sequence (the forward at chunk 16 against the forward at the config's
chunk, over the rows its tokens came from), and prints how many requests
needed more than the allowance.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES, PEAK_F32_FLOPS, PEAK_FLOPS as PEAK_BF16_FLOPS,
    PEAK_INT8_OPS, bound_ms)
from repro_torch.analysis import timing  # noqa: E402

ARCH = "qwen2_5_3b"
HYBRID_ARCH = "jamba_1_5_large"
MOE_ARCH = "olmoe_1b_7b"
VLM_ARCH = "internvl2_1b"
BATCH = 1000
WARMUP, TIMED = 1, 5
BLOCK = 8  # images compared with the plain version at each end of the batch
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
SEED = 0
# phase 11's int8 GEMMs, (m, k, n): the reference's scripts/verify.py and
# conv5_x's Im2Col GEMM at batch 1000
INT8_GEMMS = {"512x384x256": (512, 384, 256),
              "2048x2048x2048": (2048, 2048, 2048),
              "conv5_x Im2Col 49000x4608x512": (BATCH * 49, 4608, 512)}
CONV_LIBRARY_NOTE = ("F.conv2d on the bf16 operands writes bf16, half the "
                     "kernel's f32 output bytes")


# phase 3's narrow convs, (N, c_I, c_O, H = W) with 3 x 3 filters: their H100
# plans (784 x 16, 1800 x 8 and 1568 x 8 accumulators) take the LINEAR layout
NARROW_CONVS = ((4, 8, 16, 16), (4, 3, 8, 32), (8, 16, 8, 30))


class _Shape:
    """A stride-1 3 x 3 conv's shape, as ``conv_tiles`` reads a layer."""

    def __init__(self, N, c_I, c_O, h_O, w_O):
        self.N, self.c_I, self.c_O, self.h_O, self.w_O = N, c_I, c_O, h_O, w_O
        self.h_F = self.w_F = 3
        self.sh = self.sw = 1


# operands that phases 4, 8, 10, 11 and 15 leave for phase 16's audit; the
# conv path's stay for phase 17's autotune
HELD: dict = {}
# each serve's graph line (phases 7, 12 and 14), printed again by phase 18
GRAPHS: dict = {}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def median_ms(fn, warmup: int = WARMUP, timed: int = TIMED) -> float:
    """Median of per-call CUDA-event times, after warm-up calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, allowed error) under the stated tolerance."""
    tol = TOL[want.dtype]
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             "non-finite output")
    err = (got - want).abs().max().item()
    return err, tol * max(1.0, want.abs().max().item())


def zero_counts() -> None:
    """Every kernel's launch counters to 0 (just before a counted run)."""
    from repro_torch.kernels import KERNELS

    for k in KERNELS.values():
        k.launches = 0
        k.tensor_core_launches = 0


def cycle_check(phases: str, fatal: bool = False) -> None:
    """Card memory that only reference cycles still held after some
    phases: memory the garbage collector would free at some later moment,
    so that the next phase may run out. Printed after every phase (a
    ``flag`` where it is not 0); fatal where ``fatal`` (phase 26's own)."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    held = before - torch.cuda.memory_allocated()
    print(json.dumps({"cycle_check": phases,
                      "card_gb_held_by_cycles": held / 1e9,
                      "flag": held > 0}), flush=True)
    if held > 0 and fatal:
        fail(f"phases {phases}: {held / 1e9} GB of card memory held only by "
             "reference cycles")


def flash_on_tensor_cores(run: str) -> int:
    """The flash kernel's tensor-core launches since ``zero_counts``; fatal
    unless they are all its launches (every bf16 serving run)."""
    from repro_torch.kernels import KERNELS

    k = KERNELS["flash_attention"]
    print(f"{run}: flash_attention on the tensor cores "
          f"{k.tensor_core_launches} of {k.launches}", flush=True)
    if k.tensor_core_launches != k.launches:
        fail(f"{run}: {k.launches - k.tensor_core_launches} flash launches "
             "took the FMA kernel, not the tensor cores")
    return k.tensor_core_launches


def per_launch_ms(fn, n: int = 50, warmup: int = 3) -> float:
    """CUDA events around ``n`` back-to-back calls, divided by ``n``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms_per_call(fn, n: int = 20, replays: int = 5):
    """Device time of one call (``repro_torch.analysis.timing``: ``n``
    calls captured in a CUDA graph, replayed ``replays`` times between two
    CUDA events); "not measured" where the calls cannot be captured."""
    try:
        return timing.graph_ms_per_call(fn, n, replays)
    except RuntimeError as exc:
        print(f"graph capture failed: {exc}", flush=True)
        return "not measured"


def layer_inputs(gen: torch.Generator, i: int, s):
    """Layer i's bf16 input and filter at its published shape, made on the
    card from a fixed seed (the conv path's inputs, phases 4, 5 and 10)."""
    gen.manual_seed(SEED + 1 + i)
    H = (s.h_O - 1) * s.sh + s.h_F
    W = (s.w_O - 1) * s.sw + s.w_F
    x = torch.randn((s.N, s.c_I, H, W), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((s.c_O, s.c_I, s.h_F, s.w_F), generator=gen,
                     device="cuda") * (s.c_I * s.h_F * s.w_F) ** -0.5).to(
        torch.bfloat16)
    return x, w


def int8_conv_times(xq, wq, sc, s, ctx) -> dict:
    """Row 6's times of one int8 conv layer through ``ops.conv2d_q``: a
    launch (50 back-to-back calls) and the device time of a call (a
    replayed CUDA graph), beside the bound (int8 operations at the int8
    tensor rate, or the compulsory bytes: x and w read once, the bf16
    output written once, the scale once) and, on the device time, TOP/s,
    GB/s and the share of the bound."""
    from repro_torch import ops

    stride = (s.sh, s.sw)

    def kernel():
        return ops.conv2d_q(xq, wq, sc, stride, ctx=ctx)

    nbytes = xq.numel() + wq.numel() + 2 * s.output_size + 4 * s.c_O
    bms, by = bound_ms(2.0 * s.G, nbytes, PEAK_INT8_OPS)
    row = {"ms_per_launch": per_launch_ms(kernel),
           "device_ms": graph_ms_per_call(kernel), "bound_ms": bms,
           "bound_by": by, "gop": 2.0 * s.G / 1e9, "gbytes": nbytes / 1e9}
    dev = row["device_ms"]
    if isinstance(dev, float):
        row.update(tops_per_s=2.0 * s.G / dev / 1e9,
                   gbytes_per_s=nbytes / dev / 1e6, share_of_bound=bms / dev)
    return row


def decode_check(name: str, reqs, cfg, params, ref_ctx, allowance,
                 noise_chunk=None) -> dict:
    """Every generated token of one engine's requests against the
    cache-less ``torch`` forward: the token's logit there must lie within
    ``allowance`` of its row's max (module docstring). With
    ``noise_chunk``, a recurrent model's forward runs once more at that
    chunk size, and a token may instead lie within that forward noise: the
    largest difference between the two forwards' logits over the rows its
    request's tokens came from (module docstring). Returns the summary row;
    fails on the first token outside what it is allowed."""
    import dataclasses

    import numpy as np

    from repro_torch.models import transformer as T

    def forward(c, seq):
        with torch.inference_mode():
            return T.forward(params, c, ctx=ref_ctx, tokens=torch.as_tensor(
                seq[None], device="cuda"))[0]

    exact = total = 0
    gaps = []  # (largest gap, allowed) per request
    noise, beyond = [], 0  # forward noise; requests past the allowance
    for i, r in enumerate(reqs):
        seq = np.concatenate([r.prompt, r.out_tokens]).astype(np.int64)
        b = forward(cfg, seq)
        n, p = len(r.out_tokens), len(r.prompt)
        rows = b[0, p - 1:p - 1 + n].float()  # the logits each token came from
        out = torch.as_tensor(r.out_tokens.astype(np.int64), device="cuda")
        gap = (rows.max(-1).values
               - rows.gather(1, out[:, None])[:, 0]).max().item()
        allowed = allowance(b)
        beyond += int(gap > allowed)
        if noise_chunk:
            alt = forward(dataclasses.replace(cfg, chunk_size=noise_chunk),
                          seq)[0, p - 1:p - 1 + n].float()
            noise.append((alt - rows).abs().max().item())
            allowed = max(allowed, noise[-1])
            del alt
        exact += int((rows.argmax(-1) == out).sum().item())
        total += n
        gaps.append((gap, allowed))
        if not gap <= allowed:
            fail(f"{name} engine, request {i}: a generated token trails "
                 f"the torch forward's max logit by {gap}, above {allowed}")
        del b, rows
    worst = max(gaps, key=lambda ga: ga[0] / ga[1])
    row = {"decode_check": name, "tokens": total, "exact_argmax": exact,
           "max_gap_to_row_max": worst[0], "allowed": worst[1]}
    if noise_chunk:
        row.update(noise_chunk=noise_chunk, forward_noise=noise,
                   gaps=[g for g, _ in gaps],
                   requests_beyond_the_allowance=beyond)
    print(json.dumps(row), flush=True)
    return row


@contextlib.contextmanager
def serve_events():
    """CUDA events around every graph replay, eager decode step and
    prefill forward of the serves run inside (``DecodeGraphs.replay`` and
    ``.eager``, ``Engine._prefill``), and the host seconds each replay call
    takes; yields the record that ``events_summary`` reads."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.graphs import DecodeGraphs

    rec = {"replay": [], "eager": [], "prefill": [], "replay_host": [],
           "keys": []}
    saved = [(DecodeGraphs, "replay"), (DecodeGraphs, "eager"),
             (Engine, "_prefill")]
    saved = [(cls, name, getattr(cls, name)) for cls, name in saved]

    def timed(kind, fn):
        def wrapper(self, *args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = fn(self, *args, **kw)
            host = time.perf_counter() - t0
            end.record()
            rec[kind].append((start, end))
            if kind == "replay":
                rec["replay_host"].append(host)
                rec["keys"].append(args[0])
            return out
        return wrapper

    for cls, name, fn in saved:
        setattr(cls, name, timed(name.strip("_"), fn))
    try:
        yield rec
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def events_summary(rec: dict, wall_ms: float) -> dict:
    """Device milliseconds of the serve's replays (median, sum), eager
    steps and prefill forwards from ``serve_events``' record, the replays'
    host milliseconds to return, and the events' busy share: their sum over
    the serve's wall time (kernels outside them, the sampler's and the
    cache landing's, are not in it)."""
    torch.cuda.synchronize()
    ms = {k: [a.elapsed_time(b) for a, b in rec[k]]
          for k in ("replay", "eager", "prefill")}
    total = sum(sum(v) for v in ms.values())
    return {"replays": len(ms["replay"]),
            "replay_device_ms_median": (statistics.median(ms["replay"])
                                        if ms["replay"] else None),
            "replay_device_ms_sum": sum(ms["replay"]),
            "replay_host_ms_median": (
                1e3 * statistics.median(rec["replay_host"])
                if rec["replay_host"] else None),
            "eager_step_device_ms": ms["eager"],
            "prefill_device_ms_sum": sum(ms["prefill"]),
            "events_device_ms": total,
            "events_busy_share": total / wall_ms}


def graph_gates(name: str, eng, rec: dict) -> dict:
    """Fatal unless every decode step of the serve just run was a graph
    replay but its one eager warm-up, each captured graph was replayed,
    and the graphs are one per table width (paged) or one (contiguous).
    Returns the serve's graph line."""
    st = eng.stats
    runs = st.warmup_steps + st.replayed_steps
    if st.eager_steps or st.warmup_steps != 1 or runs < len(st.decode_s):
        fail(f"{name}: {st.warmup_steps} warm-up steps, {st.replayed_steps} "
             f"replays and {st.eager_steps} other eager steps for "
             f"{len(st.decode_s)} decode steps: every step but the warm-up "
             "must be a replay")
    if len(set(st.graphs)) != len(st.graphs) or \
            set(st.graphs) != set(rec["keys"]):
        fail(f"{name}: graphs {st.graphs}, replayed keys "
             f"{sorted(set(rec['keys']), key=str)}")
    if (eng.paged and None in st.graphs) or (
            not eng.paged and st.graphs != [None]):
        fail(f"{name}: graphs {st.graphs}: one a table width (paged) or one "
             "(contiguous) expected")
    return {"warmup_steps": st.warmup_steps,
            "replayed_steps": st.replayed_steps,
            "graphs": len(st.graphs),
            "graph_widths": [w for w in st.graphs if w is not None],
            "capture_s_sum": sum(st.capture_s),
            "capture_s_max": max(st.capture_s, default=0.0)}


def trace_serve(what: str, eng, prompts, untraced_ms: float) -> None:
    """Serve ``prompts`` (32 new tokens each) once more under
    ``torch.profiler`` and print device time by kernel kind and by kernel,
    the device's busy share against the untraced serve's wall time, and the
    traced serve's own wall time and decode step (the profiler's cost on
    the host)."""
    from repro_torch.serving import Request

    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with serve_events() as rec, \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        traced = 1e3 * (time.perf_counter() - t0)
    events = events_summary(rec, traced)
    by_name, by_kind = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.device_time_total / 1e3
        kind = ("attention kernels" if "flash_kernel" in e.name
                or "flash_tc_kernel" in e.name
                or "paged_decode" in e.name else
                "conv1d kernels" if "conv1d" in e.name else
                "GEMMs (cuBLAS)" if "nvjet" in e.name or "gemm" in e.name
                else "other aten kernels")
        for table, key in ((by_name, e.name[:80]), (by_kind, kind)):
            n, t = table.get(key, (0, 0.0))
            table[key] = (n + 1, t + ms)
    busy = sum(t for _, t in by_kind.values())
    # the profiler's kernel time against the replays', eager steps' and
    # prefills' CUDA events of the same traced serve: a profiler sum below
    # the events' lost kernels (the events miss only the sampler's and the
    # cache landing's, so they are a floor of the device's work)
    print(json.dumps({
        "traced": what,
        "untraced_wall_ms": untraced_ms,
        "traced_wall_ms": traced,
        "traced_decode_step_ms_median":
            1e3 * statistics.median(eng.stats.decode_s),
        "device_kernel_ms": busy or "not measured",
        "device_busy_share": busy / untraced_ms if busy else "not measured",
        "events_device_ms": events["events_device_ms"],
        "events_busy_share_of_untraced": events["events_device_ms"]
        / untraced_ms,
        "profiler_over_events": (busy / events["events_device_ms"]
                                 if busy else "not measured"),
        "traced_replay_device_ms_median": events["replay_device_ms_median"],
        "decode_steps": len(eng.stats.decode_s),
        "by_kind": {k: {"launches": n, "ms": t}
                    for k, (n, t) in by_kind.items()},
        "top_kernels": [{"name": k, "launches": n, "ms": t}
                        for k, (n, t) in sorted(by_name.items(),
                                                key=lambda kv: -kv[1][1])
                        [:10]]}), flush=True)


def serving_prompt_lens() -> tuple:
    """The serve's 8 prompt lengths (phases 7 and 8) and the generator that
    goes on to draw the prompts."""
    import numpy as np

    rng = np.random.default_rng(0)
    return rng, rng.integers(17, 201, size=8)


def serving_prompts(vocab: int) -> tuple:
    """The 8 greedy requests' prompts of phases 7, 19 and 20 over ``vocab``
    token ids, two of them sharing a 32-token prefix. Returns (lengths,
    prompts, the sharing requests)."""
    import numpy as np

    rng, lens = serving_prompt_lens()
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
               for n in lens]
    shared = rng.integers(0, vocab, size=32).astype(np.int32)
    sharing = [i for i in range(len(prompts)) if lens[i] >= 32][:2]
    for i in sharing:  # two requests share a 32-token prefix
        prompts[i][:32] = shared
    return lens, prompts, sharing


def logit_allowance(n_layers: int):
    """The teacher-forced tolerance (module docstring) of an ``n_layers``
    model, as a function of the reference logits."""
    def allowance(logits):
        return (4 * 2.0 ** -8 * n_layers ** 0.5
                * max(1.0, logits.abs().max().item()))
    return allowance


def count_launches(run: str, must_launch, fn) -> tuple:
    """The attention kernels' counters to 0 just before ``fn``, read just
    after; fail unless every kernel of ``must_launch`` ran and every flash
    and paged-decode launch took its tensor-core kernel. Returns ``fn()``,
    the run's launches and its tensor-core launches, by kernel."""
    from repro_torch.kernels import KERNELS

    names = ("flash_attention", "paged_decode")
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    launched = {n: KERNELS[n].launches for n in names}
    print(f"{run} launches: {json.dumps(launched)}", flush=True)
    for n in must_launch:
        if launched[n] <= 0:
            fail(f"{run}: the {n} kernel was never launched")
    tc = {"flash_attention": flash_on_tensor_cores(run)}
    pk = KERNELS["paged_decode"]
    print(f"{run}: paged_decode on the tensor cores "
          f"{pk.tensor_core_launches} of {pk.launches}", flush=True)
    if pk.tensor_core_launches != pk.launches:
        fail(f"{run}: {pk.launches - pk.tensor_core_launches} paged "
             "decode launches took the FMA kernel, not the tensor cores")
    tc["paged_decode"] = pk.tensor_core_launches
    return out, launched, tc


def serve_and_gate(name: str, eng, prompts, count=None) -> tuple:
    """Serve ``prompts`` greedily (32 new tokens each) on ``eng`` through
    ``count(run, must_launch, fn)`` (the counted run, returning ``fn()``
    and the launches; default ``count_launches``), under
    ``serve_events``. Fatal unless every request finishes "length" with 32
    tokens, the graph gates hold (``graph_gates``) and the attention
    launches are the steps': flash once an attention layer at each prefill
    (and, contiguous, at each decode step), paged decode once an attention
    layer at each decode step (a model without attention layers launches
    neither). Returns the requests and the serve's row."""
    from repro_torch.serving import Request

    cfg = eng.cfg
    n_attn = cfg.pattern.count("attn") * cfg.repeats
    must = (() if not n_attn else ("flash_attention", "paged_decode")
            if eng.paged else ("flash_attention",))
    if count is None:
        def count(run, must_launch, fn):
            return count_launches(run, must_launch, fn)[:2]
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    torch.cuda.synchronize()
    with serve_events() as ev:
        t0 = time.perf_counter()
        _, launched = count(f"{name} engine", must, lambda: eng.serve(reqs))
        wall = time.perf_counter() - t0
    ntok = sum(len(r.out_tokens) for r in reqs)
    st = eng.stats
    graphs_row = graph_gates(f"{name} engine", eng, ev)
    runs = st.warmup_steps + st.replayed_steps
    want = {"flash_attention": n_attn * (
        len(st.prefill_s) + (0 if eng.paged else runs)),
        "paged_decode": n_attn * runs if eng.paged else 0}
    if launched != want:
        fail(f"{name} engine: launches {launched}, expected {want} "
             f"({n_attn} attention layers, {len(st.prefill_s)} prefills, "
             f"{runs} decode steps)")
    for r in reqs:
        if r.finish_reason != "length" or len(r.out_tokens) != 32:
            fail(f"{name} engine: a request finished {r.finish_reason!r} "
                 f"with {len(r.out_tokens)} tokens, not 'length' with 32")
    row = {"engine": name, "requests": len(reqs),
           "prompt_lens": [len(p) for p in prompts],
           "generated_tokens": ntok, "wall_s": wall, "tok_per_s": ntok / wall,
           "prefill_ms_mean": 1e3 * statistics.mean(st.prefill_s),
           "prefill_ms_median": 1e3 * statistics.median(st.prefill_s),
           "decode_step_ms_median": 1e3 * statistics.median(st.decode_s),
           "decode_steps": len(st.decode_s), "launches": launched,
           **graphs_row, **events_summary(ev, 1e3 * wall)}
    return reqs, row


def routing_differences(ra, rb, k: int) -> dict:
    """Two recorded forwards' routing (``moe.record_routing`` logs): the
    (token, layer, k) expert choices that differ, all choices, the smallest
    gap between the k-th and (k+1)-th router probability of the first, and
    each run's choices dropped at capacity."""
    return {
        "routing_flips": sum(int((x.gate_idx != y.gate_idx).sum().item())
                             for x, y in zip(ra, rb)),
        "routing_choices": sum(x.gate_idx.numel() for x in ra),
        "min_topk_gap": min(
            (lambda v: (v[..., k - 1] - v[..., k]).min().item())(
                torch.topk(x.probs, k + 1, dim=-1).values) for x in ra),
        "dropped_choices": [sum(int((x.kept == 0).sum().item()) for x in r)
                            for r in (ra, rb)]}


def teacher_forced(key: str, i: int, seq, cfg, params, ctx, ref_ctx,
                   allowance) -> dict:
    """Request ``i``'s prompt and generated tokens ``seq`` through the
    cache-less forward under ``ctx`` and ``ref_ctx``; prints one ``{key:
    i, ...}`` line and fails if the logits differ by more than
    ``allowance``. A model with experts runs the ``ref_ctx`` forward twice:
    routed freely (its error, the routing flips and the smallest top-k gap
    are printed) and routed to the ``ctx`` run's expert choices, the one
    held to the allowance (module docstring)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    toks = torch.as_tensor(seq[None], device="cuda")
    with torch.inference_mode(), moe.record_routing() as ra:
        a, _, _ = T.forward(params, cfg, tokens=toks, ctx=ctx)
    with torch.inference_mode(), moe.record_routing() as rb:
        b, _, _ = T.forward(params, cfg, tokens=toks, ctx=ref_ctx)
    row = {key: i, "tokens": len(seq)}
    if ra:
        row.update(routing_differences(ra, rb, cfg.experts_per_token),
                   max_abs_err_routed_freely=(a - b).abs().max().item())
        with torch.inference_mode():
            b, _, _ = T.forward(params, cfg, tokens=toks, ctx=ref_ctx,
                                expert_choices=[r.gate_idx for r in ra])
    err = (a - b).abs().max().item()
    allowed = allowance(b)
    row.update(max_abs_err=err, mean_abs_err=(a - b).abs().mean().item(),
               allowed=allowed, max_abs_logit=b.abs().max().item(),
               argmax_agreement=(a.argmax(-1) == b.argmax(-1)).float()
               .mean().item())
    print(json.dumps(row), flush=True)
    if not err <= allowed:
        fail(f"{key} {i}: cuda vs torch logit error {err} above {allowed}")
    return row


def paged_decode_operands(gen: torch.Generator, cfg, lens) -> tuple:
    """Phase 8's paged-decode call: 4 rows of a bf16 pool of 16-position
    blocks, at depths from the serve's prompt lengths ``lens``, their blocks
    drawn at random from the pool (block 0 unused). Returns (q, k pool, v
    pool, block tables, lengths, depths, table width)."""
    dev = torch.device("cuda")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    w = -(-(int(lens.max()) + 32) // 16)
    depths = [int(lens.max()) + 31, int(lens[1]) + 16, int(lens[2]) + 8, 40]
    nb = 1 + 4 * w
    kp = randn((nb, KV, 16, hd))
    vp = randn((nb, KV, 16, hd))
    qp = randn((4, H, 1, hd))
    tables = torch.zeros((4, w), dtype=torch.int32, device=dev)
    perm = 1 + torch.randperm(nb - 1, generator=gen, device=dev)
    used = 0
    for r, d in enumerate(depths):
        n = -(-(d + 1) // 16)
        tables[r, :n] = perm[used:used + n].to(torch.int32)
        used += n
    lengths = torch.tensor([d + 1 for d in depths], dtype=torch.int32,
                           device=dev)
    return qp, kp, vp, tables, lengths, depths, w


# phase 6's paged-decode checks, (B, KV, g, hd, bs, w, lengths): the
# serving shape with padding and a dead row, g 1 and 16 at hd 16 over 4-key
# blocks with several slots a CTA and a length-0 row, hd 32 and 64, and the
# serve's own table width with a length-0 row
PAGED_CASES = [
    (4, 2, 8, 128, 16, 32, (512, 17, 1, 1)),
    (4, 2, 1, 16, 4, 25, (100, 7, 1, 0)),
    (4, 2, 16, 16, 4, 25, (100, 7, 1, 0)),
    (4, 2, 16, 128, 4, 7, (28, 7, 1, 0)),
    (3, 4, 4, 32, 16, 8, (128, 31, 0)),
    (3, 4, 4, 64, 16, 9, (144, 16, 0)),
    (4, 2, 8, 128, 16, 13, (205, 151, 0, 41)),
    (1, 2, 8, 128, 16, 1, (16,)),
]


def paged_checks(gen: torch.Generator, record) -> None:
    """Phase 6's paged-decode checks against the plain version, bf16 and
    f32, each naming the kernel its dtype took (bf16: tensor core, f32:
    fma) and the split; fatal on the other kernel. Rows past the first have
    padding at garbage block 0 and the last row is dead (all block 0)."""
    from repro_torch.kernels import (KERNELS, paged_decode_attention,
                                     paged_decode_plain)
    from repro_torch.kernels.flash_attention import paged_launch_config

    dev = torch.device("cuda")
    pk = KERNELS["paged_decode"]
    gen.manual_seed(SEED + 11)
    for B, KV, g, hd, bs, w, lens in PAGED_CASES:
        nb = 1 + B * w
        for dt in (torch.bfloat16, torch.float32):
            kp = torch.randn((nb, KV, bs, hd), generator=gen,
                             device=dev).to(dt)
            vp = torch.randn((nb, KV, bs, hd), generator=gen,
                             device=dev).to(dt)
            q = torch.randn((B, KV * g, 1, hd), generator=gen,
                            device=dev).to(dt)
            tables = (1 + torch.randperm(nb - 1, generator=gen, device=dev)
                      [:B * w]).reshape(B, w).to(torch.int32)
            for r, n in enumerate(lens):  # padding points at block 0
                tables[r, max(1, -(-n // bs)):] = 0
            if B > 1:
                tables[-1, :] = 0  # a dead row reads garbage block 0
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            tc = pk.tensor_core_launches
            got = paged_decode_attention(q, kp, vp, tables, lengths)
            torch.cuda.synchronize()
            path = "tensor core" if pk.tensor_core_launches > tc else "fma"
            if path != ("tensor core" if dt == torch.bfloat16 else "fma"):
                fail(f"paged_decode: a {dt} call took the {path} kernel")
            cfg = paged_launch_config(B, KV, g, hd, bs, w, dt)
            record("paged_decode", got,
                   paged_decode_plain(q, kp, vp, tables, lengths),
                   f"{dt} B={B} KV={KV} g={g} hd={hd} bs={bs} w={w} lengths "
                   f"{lens} on {path}, S {cfg['split']} x "
                   f"{cfg['slots_per_cta']} slots")
        del kp, vp, q
    # the serving engine's launch, its split from the table capacity
    # (max_len 512 / 16 = 32): a row of 70 keys (5 live slots) at every
    # width from 5 to 32 gives a bit-equal output, held to the plain version
    B, KV, g, hd, bs, cap = 4, 2, 8, 128, 16, 512 // 16
    nb = 1 + B * cap
    for dt in (torch.bfloat16, torch.float32):
        kp, vp = (torch.randn((nb, KV, bs, hd), generator=gen,
                              device=dev).to(dt) for _ in range(2))
        q = torch.randn((B, KV * g, 1, hd), generator=gen, device=dev).to(dt)
        tables = (1 + torch.randperm(nb - 1, generator=gen, device=dev)
                  ).reshape(B, cap).to(torch.int32)
        lengths = torch.tensor((70, 41, 1, 0), dtype=torch.int32, device=dev)
        first = None
        for w in range(5, cap + 1):
            tw = tables[:, :w].contiguous()
            got = paged_decode_attention(q, kp, vp, tw, lengths, cap)
            torch.cuda.synchronize()
            first = got[0] if first is None else first
            if not torch.equal(got[0], first):
                fail(f"paged_decode {dt}: the row of 70 keys differs at w {w} "
                     "from w 5 at capacity 32")
            if w in (5, 13, cap):
                lc = paged_launch_config(B, KV, g, hd, bs, w, dt, cap)
                record("paged_decode", got,
                       paged_decode_plain(q, kp, vp, tw, lengths),
                       f"{dt} B={B} g={g} hd={hd} w={w} capacity {cap} "
                       f"lengths (70, 41, 1, 0), S {lc['split']} x "
                       f"{lc['slots_per_cta']} slots")
        print(f"paged_decode {dt}: the row of 70 keys bit-equal at every w "
              f"from 5 to {cap} (capacity {cap})", flush=True)
        del kp, vp, q
    torch.cuda.empty_cache()


def serving_phases(gen: torch.Generator, record) -> tuple:
    """Phases 6-8 (module docstring): the attention kernels against their
    plain versions, the serving path at full width, and the attention
    kernels' times. Returns the two kernels' entries of the ``kernels``
    line (``max_abs_err`` is filled in by the caller) and what the int8
    serve of phase 12 reuses: the model, its weights, the requests and the
    bf16 paged engine's results."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import (KERNELS, flash_attention,
                                     flash_attention_plain,
                                     paged_decode_attention,
                                     paged_decode_plain)
    from repro_torch.kernels.flash_attention import (FLASH_INSTANCES,
                                                     paged_launch_config)
    from repro_torch.kernels.flash_attention import \
        launch_config as flash_config
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.serving import Engine, Request

    dev = torch.device("cuda")

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    # -- 6. attention kernels against their plain versions ------------------
    fk = KERNELS["flash_attention"]

    def flash_check(what, q, k, v, off, q_seq_len, mask, block=None,
                    causal=True):
        """One flash call against its plain version, naming the kernel it
        took (bf16: tensor core, f32: fma); fatal on the other."""
        tc = fk.tensor_core_launches
        got = flash_attention(q, k, v, causal=causal, q_offset=off,
                              q_seq_len=q_seq_len, key_mask=mask,
                              block_q=block, block_k=block)
        torch.cuda.synchronize()
        path = "tensor core" if fk.tensor_core_launches > tc else "fma"
        if path != ("tensor core" if q.dtype == torch.bfloat16 else "fma"):
            fail(f"flash_attention {what}: a {q.dtype} call took the {path} "
                 "kernel")
        fold = q_seq_len if q_seq_len and q_seq_len < q.shape[1] else None
        want = flash_attention_plain(q, k, v, causal, off, fold, None, mask)
        record("flash_attention", got, want, f"{what} on {path}")

    gen.manual_seed(SEED + 10)
    B = 2
    for dt in (torch.bfloat16, torch.float32):
        for g in (1, 8):
            for hd in (64, 128):
                for Lq in (1, 37, 200):
                    for Lk in (37, 512):
                        rows = B * 2
                        q = randn((rows, g * Lq, hd), dt)
                        k = randn((rows, Lk, hd), dt)
                        v = randn((rows, Lk, hd), dt)
                        top = max(0, Lk - Lq)
                        km = torch.ones((B, Lk), dtype=torch.bool, device=dev)
                        km[0, Lk - 5:] = False  # a pad tail
                        km[1, :] = False  # a fully masked row: averages V
                        for kind, off, mask in (
                                ("int", top, None),
                                ("rows", randint(0, top + 1, (rows,)), None),
                                ("mask", 0, km)):
                            flash_check(f"{dt} g={g} hd={hd} Lq={Lq} Lk={Lk} "
                                        f"{kind}", q, k, v, off, Lq, mask)
    # every compiled (hd, block) instance of the bf16 kernel at runtime
    # tiles bq 8, 24, 40 and 128 (every warp grid R x C it compiles),
    # folded GQA groups, per-row offsets, a pad-tail mask with a fully
    # masked row, one resident key tile (Lk 37 at block 64 and 128) and
    # several; hd 80 (the encoder's) causal and not; 2,085 keys (17 to 66
    # tiles) split over clusters of 2 to 8 CTAs wherever the folded
    # queries fit one row slab (R 1, every C the split takes)
    for hd, blk in sorted(FLASH_INSTANCES):
        for g, Lq in ((1, 8), (8, 3), (1, 40), (8, 16)):
            for Lk in (37, 300, 2085):
                rows = B * 2
                q = randn((rows, g * Lq, hd), torch.bfloat16)
                k = randn((rows, Lk, hd), torch.bfloat16)
                v = randn((rows, Lk, hd), torch.bfloat16)
                km = torch.ones((B, Lk), dtype=torch.bool, device=dev)
                km[0, Lk - 5:] = False
                km[1, :] = False
                offs = randint(0, Lk, (rows,))
                for kind, mask in (("rows", None), ("rows+mask", km)):
                    fc = flash_config(g * Lq, Lk, hd, blk, torch.bfloat16)
                    r, c = fc["warp_grid"]
                    for causal in (True, False) if hd == 80 else (True,):
                        flash_check(f"bf16 hd={hd} block={blk} (R {r}, C "
                                    f"{c}, S {fc['split']}) g={g} Lq={Lq} "
                                    f"Lk={Lk} {kind}"
                                    f"{'' if causal else ' non-causal'}", q,
                                    k, v, offs, Lq, mask, blk, causal)
                        if fk.last_launch["cluster"] != fc["cluster"]:
                            fail(f"flash_attention: launched "
                                 f"{fk.last_launch}, launch_config says "
                                 f"cluster {fc['cluster']}")
    paged_checks(gen, record)
    del q, k, v
    torch.cuda.empty_cache()

    # -- 7. the serving path ------------------------------------------------
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    master = T.init_params(cfg, seed=SEED, device="cuda")
    params = T.compute_params(master, cfg)
    del master  # the engines and forwards use the bf16 copy
    torch.cuda.synchronize()
    print(f"serving: {cfg.name} at published widths ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
          f"{cfg.hd}, vocab {cfg.padded_vocab}); random weights made on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    lens, prompts, sharing = serving_prompts(cfg.vocab_size)
    ctx = ExecutionContext(target=H100, backend="cuda")
    attn_names = ("flash_attention", "paged_decode")
    serve_launches = dict.fromkeys(
        attn_names + ("flash_tensor_core", "paged_tensor_core"), 0)

    def counted(run: str, must_launch, fn):
        """``count_launches``, adding the run's launches to the path's."""
        out, launched, tc = count_launches(run, must_launch, fn)
        for n in attn_names:
            serve_launches[n] += launched[n]
        serve_launches["flash_tensor_core"] += tc["flash_attention"]
        serve_launches["paged_tensor_core"] += tc["paged_decode"]
        return out, launched

    served, stats = {}, {}
    with ops.record_dispatch() as log:
        for name, paged in (("paged", True), ("contiguous", False)):
            eng = Engine(cfg, params, max_len=512, batch_size=4, ctx=ctx,
                         block_size=16, paged=paged)
            served[name], stats[name] = serve_and_gate(name, eng, prompts,
                                                       counted)
            stats[name]["shared_prefix_requests"] = sharing
            GRAPHS[name] = {k: stats[name][k] for k in (
                "warmup_steps", "replayed_steps", "graphs", "graph_widths",
                "capture_s_sum", "capture_s_max")}
            print(json.dumps(stats[name]), flush=True)
            del eng
        tokens = torch.as_tensor(prompts[0][None].astype(np.int64),
                                 device=dev)
        with torch.inference_mode():
            (logits, _, _), _ = counted(
                "cache-less forward", ("flash_attention",),
                lambda: T.forward(params, cfg, tokens=tokens, ctx=ctx))
        if (logits.shape != (1, len(prompts[0]), cfg.padded_vocab)
                or not torch.isfinite(logits).all()):
            fail("cache-less forward: bad logits")
    print(f"serving path launches: {json.dumps(serve_launches)}", flush=True)
    attn = [d for d in log if d.op in ("attention", "attention_decode")]
    off = [d for d in attn if d.chosen != "cuda"]
    print(f"serving path dispatch: {len(attn)} attention decisions, "
          f"{len(off)} off cuda", flush=True)
    if not attn or off:
        fail(f"attention decisions chosen off cuda: {off[:3]}")
    firsts = {n: [int(r.out_tokens[0]) for r in reqs]
              for n, reqs in served.items()}
    if firsts["paged"] != firsts["contiguous"]:
        fail(f"first tokens differ between engines: {firsts}")
    same = sum(int(np.array_equal(a.out_tokens, b.out_tokens))
               for a, b in zip(served["paged"], served["contiguous"]))
    print(f"engines agree on the first token of all {len(prompts)} requests; "
          f"whole outputs equal for {same}", flush=True)

    # teacher-forced logits: cuda against torch on the card
    ref_ctx = ExecutionContext(target=H100, backend="torch")
    allowance = logit_allowance(cfg.n_layers)
    for i in (0, 1):
        r = served["paged"][i]
        teacher_forced("teacher_forced", i,
                       np.concatenate([r.prompt, r.out_tokens]).astype(
                           np.int64), cfg, params, ctx, ref_ctx, allowance)
    del logits

    # every generated token of both engines against the cache-less torch
    # forward: a near-tie of that row's max (docstring)
    for name, reqs in served.items():
        decode_check(name, reqs, cfg, params, ref_ctx, allowance)
    torch.cuda.empty_cache()

    # where the paged engine's time goes: the same serve again, traced
    trace_serve("paged engine, the same 8 requests",
                Engine(cfg, params, max_len=512, batch_size=4, ctx=ctx,
                       block_size=16, paged=True),
                prompts, 1e3 * stats["paged"]["wall_s"])

    # -- 8. kernel times at the serving shapes ------------------------------
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = H // KV
    gen.manual_seed(SEED + 20)
    Lq = -(-int(lens[0]) // 16) * 16  # the first request's prefill bucket
    Lk = 512
    q = randn((1, H, Lq, hd), torch.bfloat16)
    k = randn((1, KV, Lk, hd), torch.bfloat16)
    v = randn((1, KV, Lk, hd), torch.bfloat16)
    km = torch.zeros((1, Lk), dtype=torch.bool, device=dev)
    km[0, :int(lens[0])] = True
    km[0, Lq:] = True  # the cache tail past the window stays valid
    off0 = torch.zeros((), dtype=torch.int32, device=dev)
    qf = q.reshape(KV, g * Lq, hd)
    kf, vf = k.reshape(KV, Lk, hd), v.reshape(KV, Lk, hd)
    flash_ms = median_ms(lambda: flash_attention(
        qf, kf, vf, q_offset=off0, q_seq_len=Lq, key_mask=km), 2, 10)
    flash_plain = median_ms(lambda: flash_attention_plain(
        qf, kf, vf, True, off0, Lq, None, km), 1, 5)
    qpos = torch.arange(Lq, device=dev)
    kpos = torch.arange(Lk, device=dev)
    allowed = (kpos[None, :] <= qpos[:, None]) & km[0][None, :]
    sdpa_mask = allowed[None, None]
    flash_lib = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask, enable_gqa=True), 2, 10)
    # beside the per-call medians (host work of the wrapper included): a
    # per-launch time over 50 back-to-back calls, and the device time of a
    # call from a replayed CUDA graph
    def prefill():
        return flash_attention(qf, kf, vf, q_offset=off0, q_seq_len=Lq,
                               key_mask=km)

    def prefill_lib():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                              enable_gqa=True)

    flash_launch = per_launch_ms(prefill)
    flash_lib_launch = per_launch_ms(prefill_lib)
    flash_dev = graph_ms_per_call(prefill)
    flash_lib_dev = graph_ms_per_call(prefill_lib)
    pairs = float(allowed.sum().item()) * H  # (query, key) pairs the data needs
    flash_flops = 4.0 * pairs * hd
    needed_keys = float(allowed.any(0).sum().item())  # keys any query sees
    flash_bytes = (q.numel() * 2 * 2 + 2 * needed_keys * KV * hd * 2
                   + km.numel())
    flash_bound, flash_by = bound_ms(flash_flops, flash_bytes,
                                     PEAK_BF16_FLOPS)
    dec_prefill = ops.explain("attention", ctx, dtype=q.dtype,
                              needs=("dynamic_q_offset", "key_mask"),
                              spec_args=(q, k, v))
    print(json.dumps({"kernel_shape": "flash_attention", "phase": "prefill",
                      "B": 1, "H": H, "KV": KV, "Lq": Lq, "Lk": Lk, "hd": hd,
                      "ms": flash_ms, "plain_ms": flash_plain,
                      "library_ms": flash_lib, "ms_per_launch": flash_launch,
                      "library_ms_per_launch": flash_lib_launch,
                      "device_ms_per_call": flash_dev,
                      "library_device_ms_per_call": flash_lib_dev,
                      "bound_ms": flash_bound,
                      "bound_by": flash_by, "gflop_needed": flash_flops / 1e9,
                      "tflop_per_s_per_launch": flash_flops / flash_launch
                      / 1e9,
                      "tflop_per_s_device": (
                          flash_flops / flash_dev / 1e9
                          if isinstance(flash_dev, float) else flash_dev),
                      "measured_words": dec_prefill.measured_words,
                      "lower_bound_words": dec_prefill.lower_bound,
                      "bound_ratio": dec_prefill.bound_ratio}), flush=True)
    # contiguous-engine decode: 4 rows at their own depths, Lq = 1
    qd = randn((4, H, 1, hd), torch.bfloat16)
    kd = randn((4, KV, Lk, hd), torch.bfloat16)
    vd = randn((4, KV, Lk, hd), torch.bfloat16)
    depth = torch.tensor([230, 120, 60, 17], dtype=torch.int32, device=dev)
    rows_off = depth.repeat_interleave(KV)
    dq = qd.reshape(4 * KV, g, hd)
    dk, dv = kd.reshape(4 * KV, Lk, hd), vd.reshape(4 * KV, Lk, hd)
    dec_ms = median_ms(lambda: flash_attention(dq, dk, dv, q_offset=rows_off,
                                               q_seq_len=1), 2, 20)
    dec_plain = median_ms(lambda: flash_attention_plain(
        dq, dk, dv, True, rows_off, 1), 1, 5)
    dec_lib = median_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=(kpos[None, :] <= depth[:, None])[:, None, None],
        enable_gqa=True), 2, 20)
    dec_mask = (kpos[None, :] <= depth[:, None])[:, None, None]

    def decode():
        return flash_attention(dq, dk, dv, q_offset=rows_off, q_seq_len=1)

    def decode_lib():  # the mask made once, outside the timing
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=dec_mask,
                                              enable_gqa=True)

    dec_launch = per_launch_ms(decode)
    dec_lib_launch = per_launch_ms(decode_lib)
    dec_dev = graph_ms_per_call(decode)
    dec_lib_dev = graph_ms_per_call(decode_lib)
    dec_needed = float((depth + 1).sum().item()) * H
    dec_bound, dec_by = bound_ms(4.0 * dec_needed * hd,
                                 (2 * qd.numel() + 2 * float(
                                     (depth + 1).sum().item()) * KV * hd) * 2,
                                 PEAK_BF16_FLOPS)
    print(json.dumps({"kernel_shape": "flash_attention",
                      "phase": "contiguous decode", "B": 4, "Lq": 1,
                      "Lk": Lk, "ms": dec_ms, "plain_ms": dec_plain,
                      "library_ms": dec_lib, "ms_per_launch": dec_launch,
                      "library_ms_per_launch": dec_lib_launch,
                      "device_ms_per_call": dec_dev,
                      "library_device_ms_per_call": dec_lib_dev,
                      "bound_ms": dec_bound, "bound_by": dec_by}), flush=True)
    # paged decode: the serving pool's block size, the deepest row's width,
    # the split from the engine's table capacity (max_len 512 / 16), as the
    # paged engine launches it
    qp, kp, vp, tables, lengths, depths, w = paged_decode_operands(gen, cfg,
                                                                   lens)
    cap = 512 // 16
    HELD["attention"] = {"prefill": (q, k, v, off0, km),
                         "decode": (qd, kd, vd, depth),
                         "paged": (qp, kp, vp, tables, lengths)}

    def paged():
        return paged_decode_attention(qp, kp, vp, tables, lengths, cap)

    paged_ms = median_ms(paged, 2, 20)
    paged_plain = median_ms(lambda: paged_decode_plain(qp, kp, vp, tables,
                                                       lengths), 1, 5)

    paged_launch = per_launch_ms(paged)
    paged_dev = graph_ms_per_call(paged)
    live = float(sum(d + 1 for d in depths))
    used_entries = sum(-(-(d + 1) // 16) for d in depths)  # table reads needed
    paged_bytes = ((2 * qp.numel() + 2 * live * KV * hd) * 2
                   + (used_entries + len(depths)) * 4)
    paged_bound, paged_by = bound_ms(4.0 * live * H * hd, paged_bytes,
                                     PEAK_BF16_FLOPS)
    dec_decode = ops.explain("attention_decode", ctx, dtype=qp.dtype,
                             spec_args=(qp, kp, vp, tables, lengths),
                             spec_kw={"capacity": cap})
    paged_cfg = paged_launch_config(4, KV, g, hd, 16, w, qp.dtype, cap)
    print(json.dumps({"kernel_shape": "paged_decode", "phase": "paged decode",
                      "B": 4, "KV": KV, "g": g, "hd": hd, "block_size": 16,
                      "w": w, "capacity": cap,
                      "lengths": [d + 1 for d in depths],
                      "split": paged_cfg["split"], "ctas": paged_cfg["ctas"],
                      "ms": paged_ms, "plain_ms": paged_plain,
                      "ms_per_launch": paged_launch,
                      "device_ms_per_call": paged_dev,
                      "library_ms": None,
                      "library_note": "no single PyTorch call reads a paged "
                                      "pool",
                      "bound_ms": paged_bound, "bound_by": paged_by,
                      "measured_words": dec_decode.measured_words,
                      "lower_bound_words": dec_decode.lower_bound,
                      "bound_ratio": dec_decode.bound_ratio}), flush=True)
    state = {"cfg": cfg, "params": params, "prompts": prompts,
             "sharing": sharing, "bf16_paged": served["paged"],
             "bf16_stats": stats["paged"], "ctx": ctx, "ref_ctx": ref_ctx,
             "allowance": allowance, "contiguous": served["contiguous"],
             "contiguous_stats": stats["contiguous"]}
    return [
        {"name": "flash_attention", "route": "cuda",
         "also_replaces": "src/repro/kernels/flash_attention.py:96",
         "launches": serve_launches["flash_attention"],
         "tensor_core_launches": serve_launches["flash_tensor_core"],
         "ms": flash_ms, "plain_ms": flash_plain, "bound_ms": flash_bound,
         "bound_by": flash_by, "library_ms": flash_lib,
         "ms_per_launch": flash_launch,
         "library_ms_per_launch": flash_lib_launch,
         "device_ms_per_call": flash_dev, "ok": True,
         "shapes": f"{cfg.name} prefill: B 1, H {H}/{KV}, Lq {Lq}, Lk {Lk}, "
                   f"hd {hd}, bf16, causal + key mask"},
        {"name": "paged_decode", "route": "cuda",
         "launches": serve_launches["paged_decode"],
         "tensor_core_launches": serve_launches["paged_tensor_core"],
         "split": paged_cfg["split"], "ctas": paged_cfg["ctas"],
         "ms": paged_ms,
         "ms_per_launch": paged_launch, "device_ms_per_call": paged_dev,
         "plain_ms": paged_plain, "bound_ms": paged_bound,
         "bound_by": paged_by, "library_ms": None, "ok": True,
         "shapes": f"{cfg.name} decode: B 4, KV {KV}, g {g}, hd {hd}, "
                   f"block 16, w {w}, bf16, S {paged_cfg['split']}"},
    ], state


def ptxas(log: str, match: str = "") -> tuple:
    """(registers per thread, spilling functions) from nvcc's -Xptxas -v
    report, for the functions whose mangled name contains ``match``."""
    regs, spills, fn = set(), 0, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        if match not in fn:
            continue
        if "Used " in ln:
            regs.add(int(ln.split("Used ")[1].split()[0]))
        if "spill" in ln and not ln.strip().startswith("0 bytes"):
            spills += 1
    return sorted(regs), spills


def ptxas_functions(log: str) -> dict:
    """{mangled function: (registers per thread, spill bytes)} from nvcc's
    -Xptxas -v report (spill bytes: the larger of stores and loads)."""
    out, fn, spill = {}, "", 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn, spill = ln.split("'")[1], 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if fn and m:
            spill = max(int(m.group(1)), int(m.group(2)))
        if fn and "Used " in ln:
            out[fn] = (int(ln.split("Used ")[1].split()[0]), spill)
    return out


def sass_functions(library) -> dict:
    """{mangled function: SASS text} of a built kernel library, as the
    toolkit's cuobjdump disassembles it."""
    from repro_torch.kernels._build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = body
    return funcs


def template_symbol(kernel: str, *args) -> str:
    """The mangled-name part of ``kernel<args...>``: an int argument as
    ``Li<n>E``, a bool as ``Lb<n>E``, the output types ``"float"`` and
    ``"bf16"`` as ``f`` and ``13__nv_bfloat16``."""
    parts = []
    for a in args:
        if isinstance(a, bool):
            parts.append(f"Lb{int(a)}E")
        elif isinstance(a, int):
            parts.append(f"Li{a}E")
        else:
            parts.append({"float": "f", "bf16": "13__nv_bfloat16"}[a])
    return f"{kernel}I{''.join(parts)}E"


def tc_variants(name: str, kernel: str, variants, main,
                opcode: str = "HMMA") -> None:
    """Phase 2 for one source's tensor-core kernel: for each ``(label,
    template arguments)`` of ``variants``, the instance's registers and
    spill bytes (ptxas) and its count of ``opcode`` (HMMA: bf16 products,
    IMMA: int8) in its SASS; fatal if an instance has none or an instance
    whose label is in ``main`` (the main path's) spills."""
    from repro_torch.kernels import KERNELS

    regs_of = ptxas_functions(KERNELS[name].build_log)
    sass = sass_functions(KERNELS[name].library_path())
    for label, args in variants:
        sym = template_symbol(kernel, *args)
        found = [f for f in regs_of if sym in f]
        body = [t for f, t in sass.items() if sym in f]
        if len(found) != 1 or len(body) != 1:
            fail(f"{name}: {sym} not found once in the build "
                 f"({len(found)} in ptxas, {len(body)} in SASS)")
        regs, spill = regs_of[found[0]]
        mma = body[0].count(opcode)
        used = label in main
        print(f"build {name} tensor-core variant {label}"
              f"{'; main path' if used else ''}: registers {regs}, "
              f"spill bytes {spill}, {opcode} instructions {mma}", flush=True)
        if mma == 0:
            fail(f"{name}: {sym} has no {opcode}: not on the tensor cores")
        if used and spill:
            fail(f"{name}: main-path variant {sym} spills {spill} bytes")


def gemm_like_variants(variants, main_variants, linear=None,
                       main_out="float"):
    """``tc_variants``' (label, arguments) for the GEMMs' and the conv's
    ``<Tout, MI, NI[, LINEAR]>`` instances, both output types, and the
    labels of those the main path takes (``main_out``: f32 for the bf16
    conv path, bf16 for the int8 GEMMs)."""
    out, main = [], set()
    for v, (mi, ni) in enumerate(variants):
        for tout in ("float", "bf16"):
            label = (f"{v} (MI {mi}, NI {ni}"
                     f"{', LINEAR' if v == linear else ''}; "
                     f"{'f32' if tout == 'float' else 'bf16'} out)")
            args = (tout, mi, ni) + (() if linear is None
                                     else (v == linear,))
            out.append((label, args))
            if v in main_variants and tout == main_out:
                main.add(label)
    return out, main


def conv_tiles(s, prec=(0.5, 0.5, 1.0)) -> tuple:
    """The H100 plan's (bN, b_cI, b_cO, b_hO, b_wO) tiles of a conv layer,
    bf16 in and f32 out (``prec``, words an element of x, w and the output:
    (0.25, 0.25, 0.5) for the int8 path), and their halo window (h_in,
    w_in)."""
    from repro_torch.core.conv_model import Precision
    from repro_torch.plan import H100, ConvSpec, Planner

    spec = ConvSpec(N=s.N, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O, h_O=s.h_O,
                    w_F=s.w_F, h_F=s.h_F, sw=s.sw, sh=s.sh,
                    prec=Precision(*prec))
    t = tuple(Planner(H100).plan(spec).tiles)
    return t, ((t[3] - 1) * s.sh + s.h_F, (t[4] - 1) * s.sw + s.w_F)


def gemm_tiles(s) -> tuple:
    """(m, n, k) and the H100 plan's (bm, bn, bk) of a conv layer's Im2Col
    GEMM, bf16 in and f32 out, as ``kernels.matmul`` resolves them."""
    from repro_torch.core.conv_model import Precision
    from repro_torch.plan import H100, MatmulSpec, Planner

    m, n, k = s.N * s.h_O * s.w_O, s.c_O, s.c_I * s.h_F * s.w_F
    spec = MatmulSpec(m=m, n=n, k=k, prec=Precision(0.5, 0.5, 1.0))
    return (m, n, k), tuple(Planner(H100).plan(spec).tiles)


def int8_gemm_tiles(m: int, k: int, n: int) -> tuple:
    """The H100 plan's (bm, bn, bk) of an int8 GEMM, bf16 out, as
    ``ops.matmul_q`` resolves them."""
    from repro_torch.core.conv_model import Precision
    from repro_torch.plan import H100, MatmulSpec, Planner

    spec = MatmulSpec(m=m, n=n, k=k, prec=Precision(0.25, 0.25, 0.5))
    return tuple(Planner(H100).plan(spec).tiles)


def quant_phases(gen: torch.Generator, record, serve: dict) -> list:
    """Phases 9-12 (module docstring): the int8 kernels against their plain
    versions, the int8 conv path, the int8 GEMMs and the int8 KV serve.
    ``serve`` is what phase 7 leaves: the model, its weights, its requests
    and the bf16 paged engine's results. Returns the two int8 kernels'
    entries of the ``kernels`` line (``max_abs_err`` filled in by the
    caller)."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.core.conv_model import resnet50_layers
    from repro_torch.kernels import (KERNELS, conv2d_q, conv2d_q_plain,
                                     matmul_q, matmul_q_plain)
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.quant import (quantize_conv_operands,
                                   quantize_matmul_operands)
    from repro_torch.serving import Engine, Request, kv

    dev = torch.device("cuda")
    ctx = ExecutionContext(target=H100, backend="cuda")

    # -- 9. int8 kernels against their plain versions -----------------------
    gen.manual_seed(SEED + 30)
    conv_cases = [  # (N, c_I, c_O, H, W, h_F, w_F, sh, sw, tiles): phase 3's
        (2, 4, 8, 25, 25, 3, 3, 1, 1, (1, 4, 8, 5, 7)),
        (2, 4, 8, 25, 25, 3, 3, 2, 2, (2, 4, 8, 1, 23)),
        (2, 4, 8, 25, 25, 3, 3, 2, 1, (1, 4, 8, 23, 4)),
        (3, 5, 7, 11, 13, 3, 5, 1, 2, None),
        (4, 3, 32, 20, 20, 7, 7, 2, 2, None),
        (2, 6, 8, 16, 16, 1, 1, 2, 2, (1, 6, 8, 3, 5)),
    ]
    # the tensor-core conv's edge cases (tests/test_torch_quant.py,
    # TC_CONV_CASES): each main-path tile at a small N, H and W with ragged
    # edges (conv1's one stage and zero plane, its filter as one run; c_I =
    # 37 over stages of 32 and 333-byte filter rows; 16-byte filter copies;
    # three stages; whole-plane windows), stride 2 over two stages, and a
    # tile only the LINEAR warp layout covers
    tc_cases = [
        (3, 3, 70, 41, 41, 7, 7, 2, 2, (2, 3, 64, 16, 16)),
        (2, 37, 72, 12, 62, 3, 3, 1, 1, (1, 16, 64, 8, 56)),
        (6, 48, 70, 20, 20, 3, 3, 1, 1, (5, 16, 64, 14, 7)),
        (6, 72, 64, 16, 16, 3, 3, 1, 1, (5, 16, 64, 14, 7)),
        (11, 40, 70, 9, 9, 3, 3, 1, 1, (10, 16, 64, 7, 7)),
        (2, 36, 40, 23, 23, 3, 3, 2, 2, (1, 16, 32, 5, 6)),
        (2, 8, 32, 40, 40, 3, 3, 1, 1, (1, 8, 32, 32, 32)),
    ]

    def conv_q_check(xq, wq, sc, stride, od, tiles, what):
        tc = KERNELS["conv2d_q"].tensor_core_launches
        got = conv2d_q(xq, wq, sc, stride, out_dtype=od, tiles=tiles)
        torch.cuda.synchronize()
        if KERNELS["conv2d_q"].tensor_core_launches != tc + 1:
            fail(f"conv2d_q {what} did not launch the tensor-core kernel")
        record("conv2d_q", got, conv2d_q_plain(xq, wq, sc, stride, od),
               what + " on tensor core")

    for od in (torch.float32, torch.bfloat16):
        for (N, cI, cO, H, W, hF, wF, sh, sw, tiles) in conv_cases + tc_cases:
            x = torch.randn((N, cI, H, W), generator=gen, device=dev)
            w = torch.randn((cO, cI, hF, wF), generator=gen, device=dev)
            xq, wq, sc = quantize_conv_operands(x, w)
            conv_q_check(xq, wq, sc, (sh, sw), od, tiles,
                         f"->{od} {(N, cI, cO, H, W, hF, wF, sh, sw)} "
                         f"tiles {tiles}")
    # int8 inputs 1, 4 and 8 bytes past a 16-byte boundary: the wrapper
    # realigns them with one copy for the 16-byte window copies
    for off in (1, 4, 8):
        for (N, cI, cO, H, W, hF, wF, sh, sw, tiles) in (tc_cases[0],
                                                          tc_cases[4]):
            n = N * cI * H * W
            x = torch.randn((n + 16,), generator=gen, device=dev)
            w = torch.randn((cO, cI, hF, wF), generator=gen, device=dev)
            xq, wq, sc = quantize_conv_operands(x, w)
            xq = xq[off:off + n].view(N, cI, H, W)
            conv_q_check(xq, wq, sc, (sh, sw), torch.bfloat16, tiles,
                         f"int8 at +{off} bytes {(N, cI, cO, H, W)} tiles "
                         f"{tiles}")
        for (m, k, n, tiles, rows) in [
                (100, 77, 300, None, None), (130, 129, 257, None, None),
                (1, 64, 128, None, None),
                (130, 129, 257, (32, 48, 16), None),
                (40, 30, 20, (16, 8, 6), None),
                # the main path's tiles at a small m, k ragged against the
                # ring's 128-deep span (4592 = 35 x 128 + 112), ragged n
                (64, 4592, 512, (128, 256, 16), None),
                (48, 2000, 384, (256, 128, 16), None),
                (33, 1001, 300, (128, 256, 16), None),  # an odd pitch
                (3, 4608, 512, (1, 256, 16), None),  # bm = 1, 3 row tiles
                (1040, 50, 40, (1024, 32, 16), None),  # LINEAR only
                # row slices of A: 16-byte aligned, and at an odd offset
                (100, 4608, 512, (128, 256, 16), slice(5, 45)),
                (50, 77, 300, None, slice(3, 40)),
                # narrow plans (decode rows against a wide weight, and the
                # transpose), cut into CTA shares
                *[(m, 4096, n, None, None) for m in (1, 4, 8, 16)
                  for n in (2048, 4096)],
                (2048, 64, 16, None, None), (2048, 4096, 16, None, None)]:
            a = torch.randn((m, k), generator=gen, device=dev)
            b = torch.randn((k, n), generator=gen, device=dev)
            aq, bq, sc = quantize_matmul_operands(a, b)
            what = f"->{od} (m, k, n) {(m, k, n)} tiles {tiles}"
            if rows is not None:
                aq = aq[rows]
                what += f" rows {rows.start}..{rows.stop - 1}"
            tc = KERNELS["matmul_q"].tensor_core_launches
            got = matmul_q(aq, bq, sc, out_dtype=od, tiles=tiles)
            torch.cuda.synchronize()
            if KERNELS["matmul_q"].tensor_core_launches != tc + 1:
                fail(f"matmul_q {(m, k, n)} tiles {tiles} did not launch the "
                     "tensor-core kernel")
            record("matmul_q", got, matmul_q_plain(aq, bq, sc, od),
                   what + " on tensor core")

    # -- 10. the int8 conv path ---------------------------------------------
    layers = resnet50_layers(BATCH)
    conv_rows = {}
    zero_counts()
    for i, (name, s) in enumerate(layers.items()):
        x, w = layer_inputs(gen, i, s)  # phase 4's bf16 inputs
        stride = (s.sh, s.sw)
        bf16 = ops.explain("conv2d", ctx, dtype=x.dtype, spec_args=(x, w),
                           spec_kw={"stride": stride,
                                    "out_dtype": torch.float32})
        xq, wq, sc = quantize_conv_operands(x, w)
        del x, w
        d = ops.explain("conv2d_q", ctx, dtype=xq.dtype,
                        spec_args=(xq, wq, sc),
                        spec_kw={"stride": stride,
                                 "out_dtype": torch.bfloat16})
        before = KERNELS["conv2d_q"].launches
        out = {}

        def run():
            out["y"] = ops.conv2d_q(xq, wq, sc, stride, ctx=ctx)

        ms = median_ms(run)
        launched = KERNELS["conv2d_q"].launches - before
        if launched <= 0:
            fail(f"int8 {name}: the conv2d_q kernel was not launched")
        y = out.pop("y")
        if y.shape != (s.N, s.c_O, s.h_O, s.w_O) or y.dtype != torch.bfloat16:
            fail(f"int8 {name}: output {tuple(y.shape)} {y.dtype}")
        errs = [record("conv2d_q", y[sl],
                       conv2d_q_plain(xq[sl], wq, sc, stride),
                       f"int8 {name} images {sl.start}..{sl.stop - 1}")
                for sl in (slice(0, BLOCK), slice(s.N - BLOCK, s.N))]
        ratio = d.measured_words / bf16.measured_words
        if not ratio <= 0.55:
            fail(f"int8 {name}: {ratio:.3f}x the bf16 conv words, above the "
                 "reference's 0.55 gate")
        row = {"int8_layer": name, "backend": "cuda",
               "tiles": list(d.plan.tiles),
               "measured_words": d.measured_words,
               "mixed_precision_bound": d.lower_bound,
               "bound_ratio": d.bound_ratio,
               "bf16_conv_words": bf16.measured_words,
               "int8_over_bf16_words": ratio, "ms": ms,
               "launches": launched, "max_abs_err": max(errs),
               "checked_images": [[0, BLOCK - 1], [s.N - BLOCK, s.N - 1]]}
        conv_rows[name] = row
        print(json.dumps(row), flush=True)
        HELD.setdefault("conv_q", {})[name] = (xq, wq, sc)
        del xq, wq, sc, y
        torch.cuda.empty_cache()
    conv_launches = KERNELS["conv2d_q"].launches
    conv_tc = KERNELS["conv2d_q"].tensor_core_launches
    print(f"int8 conv path launches: conv2d_q {conv_launches}, on the tensor "
          f"cores {conv_tc} of {conv_launches}", flush=True)
    if conv_launches <= 0:
        fail("the conv2d_q kernel was never launched on the int8 conv path")
    if conv_tc != conv_launches:
        fail(f"{conv_launches - conv_tc} conv2d_q launches were not "
             "tensor-core launches")

    # -- 11. the int8 GEMMs -------------------------------------------------
    mm_rows, kept = {}, {}
    zero_counts()
    for label, (m, k, n) in INT8_GEMMS.items():
        gen.manual_seed(SEED + 40 + m % 97)
        a = torch.randn((m, k), generator=gen, device=dev)
        b = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        aq, bq, sc = quantize_matmul_operands(a, b)
        del a, b
        d = ops.explain("matmul_q", ctx, dtype=aq.dtype,
                        spec_args=(aq, bq, sc),
                        spec_kw={"out_dtype": torch.bfloat16})
        before = KERNELS["matmul_q"].launches
        out = {}

        def run():
            out["y"] = ops.matmul_q(aq, bq, sc, ctx=ctx)

        ms = median_ms(run)
        if KERNELS["matmul_q"].launches - before <= 0:
            fail(f"matmul_q {label}: the kernel was not launched")
        y = out.pop("y")
        rows_ = min(m, 4096)
        errs = [record("matmul_q", y[sl], matmul_q_plain(aq[sl], bq, sc),
                       f"{label} rows {sl.start}..{sl.stop - 1}")
                for sl in (slice(0, rows_), slice(m - rows_, m))]
        plain = median_ms(lambda: matmul_q_plain(aq, bq, sc), 0, 1)
        library = median_ms(lambda: (torch._int_mm(aq, bq).float() * sc).to(
            torch.bfloat16))
        ops_ = 2.0 * m * n * k
        nbytes = m * k + k * n + 2 * m * n + 4 * n
        bms, by = bound_ms(ops_, nbytes, PEAK_INT8_OPS)
        mm_rows[label] = {
            "matmul_q": label, "m": m, "k": k, "n": n,
            "tiles": list(d.plan.tiles), "measured_words": d.measured_words,
            "mixed_precision_bound": d.lower_bound,
            "bound_ratio": d.bound_ratio, "ms": ms, "plain_ms": plain,
            "library_ms": library, "library": "torch._int_mm + scale",
            "bound_ms": bms, "bound_by": by,
            "tops_per_s": ops_ / ms / 1e9, "gbytes_per_s": nbytes / ms / 1e6,
            "max_abs_err": max(errs),
            "checked_rows": [[0, rows_ - 1], [m - rows_, m - 1]]}
        kept[label] = (aq, bq, sc)
        del y
        torch.cuda.empty_cache()
    mm_launches = KERNELS["matmul_q"].launches
    mm_tc = KERNELS["matmul_q"].tensor_core_launches
    print(f"int8 GEMM path launches: matmul_q {mm_launches}, on the tensor "
          f"cores {mm_tc} of {mm_launches}", flush=True)
    if mm_launches <= 0:
        fail("the matmul_q kernel was never launched on the int8 GEMM path")
    if mm_tc != mm_launches:
        fail(f"{mm_launches - mm_tc} matmul_q launches were not tensor-core "
             "launches")
    # per-launch (50 back-to-back calls) and device time of a call's
    # kernels, after the counts are read (these calls launch the kernel too)
    for label, (aq, bq, sc) in kept.items():
        row = mm_rows[label]

        def kernel():
            return ops.matmul_q(aq, bq, sc, ctx=ctx)

        def library():
            return (torch._int_mm(aq, bq).float() * sc).to(torch.bfloat16)

        row.update(ms_per_launch=per_launch_ms(kernel),
                   library_ms_per_launch=per_launch_ms(library),
                   device_ms=graph_ms_per_call(kernel),
                   library_device_ms=graph_ms_per_call(library))
        if isinstance(row["device_ms"], float):
            row["device_tops_per_s"] = 2.0 * row["m"] * row["n"] * row[
                "k"] / row["device_ms"] / 1e9
        print(json.dumps(row), flush=True)
    HELD["matmul_q"] = kept
    del kept
    torch.cuda.empty_cache()

    # -- 12. int8 KV serving ------------------------------------------------
    cfg, params = serve["cfg"], serve["params"]
    reqs = [Request(prompt=p, max_new_tokens=32) for p in serve["prompts"]]
    eng = Engine(cfg, params, max_len=512, batch_size=4, ctx=serve["ctx"],
                 block_size=16, paged=True, kv_dtype="int8")
    torch.cuda.synchronize()
    zero_counts()
    with ops.record_dispatch() as log, serve_events() as ev:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graphs_row = GRAPHS["paged int8"] = graph_gates("int8 KV engine", eng, ev)
    launched = {n: KERNELS[n].launches for n in ("flash_attention",
                                                  "paged_decode")}
    print(f"int8 KV engine launches: {json.dumps(launched)}", flush=True)
    if launched["flash_attention"] <= 0:
        fail("int8 KV engine: the flash_attention kernel was never launched")
    flash_on_tensor_cores("int8 KV engine")
    for r in reqs:
        if r.finish_reason != "length" or len(r.out_tokens) != 32:
            fail(f"int8 KV engine: a request finished {r.finish_reason!r} "
                 f"with {len(r.out_tokens)} tokens, not 'length' with 32")
    attn = [d for d in log if d.op == "attention"]
    quant = [d for d in log if d.op == "attention_decode_quant"]
    if not attn or any(d.chosen != "cuda" for d in attn):
        fail("int8 KV engine: an attention decision left cuda")
    if not quant or any(d.requested != "torch" or d.chosen != "torch"
                        for d in quant):
        fail("int8 KV engine: an attention_decode_quant decision was not "
             "torch by request")
    bf16 = serve["bf16_paged"]
    if [int(r.out_tokens[0]) for r in reqs] != [int(r.out_tokens[0])
                                                 for r in bf16]:
        fail("int8 KV engine: first tokens differ from the bf16 pool's")
    same = sum(int((a.out_tokens == b.out_tokens).sum())
               for a, b in zip(reqs, bf16))
    total = sum(len(r.out_tokens) for r in reqs)
    check = decode_check("int8 paged", reqs, cfg, params, serve["ref_ctx"],
                         serve["allowance"])
    st = eng.stats
    huge = 10 ** 6  # enough slots that the HBM budget binds
    gain = (kv.plan_pool_blocks(cfg, 512, huge, 16, target=H100,
                                quantized=True)
            / kv.plan_pool_blocks(cfg, 512, huge, 16, target=H100))
    print(json.dumps({
        "engine": "paged int8 KV", "requests": len(reqs),
        "generated_tokens": total, "wall_s": wall, "tok_per_s": total / wall,
        "prefill_ms_mean": 1e3 * statistics.mean(st.prefill_s),
        "prefill_ms_median": 1e3 * statistics.median(st.prefill_s),
        "decode_step_ms_median": 1e3 * statistics.median(st.decode_s),
        "decode_steps": len(st.decode_s), "num_blocks": eng.num_blocks,
        "launches": launched, "attention_decisions": len(attn),
        "attention_decode_quant_decisions": len(quant),
        "tokens_equal_to_bf16_pool": same / total,
        "requests_equal_to_bf16_pool": sum(
            int(np.array_equal(a.out_tokens, b.out_tokens))
            for a, b in zip(reqs, bf16)),
        "max_gap_to_row_max": check["max_gap_to_row_max"],
        "pool_capacity_gain_over_bf16": gain,
        "bf16_paged_decode_step_ms_median":
            serve["bf16_stats"]["decode_step_ms_median"],
        **graphs_row, **events_summary(ev, 1e3 * wall)}), flush=True)
    del eng, reqs
    # where the int8 pool's decode time goes, beside phase 7's bf16 trace
    trace_serve("paged int8 KV engine, the same 8 requests",
                Engine(cfg, params, max_len=512, batch_size=4,
                       ctx=serve["ctx"], block_size=16, paged=True,
                       kv_dtype="int8"),
                serve["prompts"], 1e3 * wall)

    # -- rows 6-7 of the kernel table: plain, launch, device, bound ---------
    # (after phase 10's counts are read: these calls launch the kernel too)
    sums = ("ms", "ms_per_launch", "device_ms", "plain_ms", "bound_ms")
    totals = {**dict.fromkeys(sums, 0.0),
              "by": {"bytes": 0.0, "operations": 0.0}}
    for i, (name, s) in enumerate(layers.items()):
        x, w = layer_inputs(gen, i, s)
        xq, wq, sc = quantize_conv_operands(x, w)
        del x, w
        torch.cuda.empty_cache()
        stride = (s.sh, s.sw)
        row = {"kernel_layer": "conv2d_q", "layer": name,
               "ms": conv_rows[name]["ms"],
               **int8_conv_times(xq, wq, sc, s, ctx),
               "plain_ms": median_ms(
                   lambda: conv2d_q_plain(xq, wq, sc, stride), 0, 1),
               "library_ms": None}
        for key in sums:
            both = isinstance(row[key], float) and isinstance(totals[key],
                                                              float)
            totals[key] = totals[key] + row[key] if both else "not measured"
        totals["by"][row["bound_by"]] += row["bound_ms"]
        print(json.dumps(row), flush=True)
        del xq, wq, sc
        torch.cuda.empty_cache()
    mm = {key: sum(r[key] for r in mm_rows.values())
          for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return [
        {"name": "conv2d_q", "route": "cuda",
         "launches": conv_launches, "tensor_core_launches": conv_tc,
         "ms": totals["ms"], "ms_per_launch": totals["ms_per_launch"],
         "device_ms_per_call": totals["device_ms"],
         "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
         "bound_by": max(totals["by"], key=totals["by"].get),
         "library_ms": None,
         "library_note": "none: no PyTorch call convolves int8 on the card",
         "ok": True,
         "shapes": "sum over the five ResNet-50 layers at batch 1000, int8 "
                   "in, bf16 out"},
        {"name": "matmul_q", "route": "cuda",
         "launches": mm_launches, "tensor_core_launches": mm_tc,
         "ms": mm["ms"], "plain_ms": mm["plain_ms"],
         "bound_ms": mm["bound_ms"],
         "bound_by": max(("bytes", "operations"), key=lambda b: sum(
             r["bound_ms"] for r in mm_rows.values() if r["bound_by"] == b)),
         "library_ms": mm["library_ms"], "ok": True,
         "shapes": "sum over (m, k, n) = " + ", ".join(INT8_GEMMS)
                   + ", int8 in, bf16 out; library torch._int_mm + scale"},
    ]


def hybrid_prompts(vocab: int):
    """Phase 14's prompt lengths and prompts: 8 lengths from
    ``numpy.default_rng(0)``, one of 300 (two SSD chunks: the state carried
    between chunks) and two shorter than K - 1 (admitted into used slots)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(3, 257, size=8)
    lens[1] = 300
    lens[5], lens[6] = 1, 2
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
               for n in lens]
    return lens, prompts


def conv1d_shape_times(gen: torch.Generator, L: int, w: torch.Tensor,
                       plain: bool = True):
    """Phase 15 at one prefill shape: the conv1d kernel's wrapper and
    ``F.conv1d`` (groups = D, on a channels-first copy made outside the
    timing) on the hybrid serve's operand, the strided x half of a seeded
    (1, L, 2 D) bf16 in-projection; each timed as a call (CUDA events
    around one call, host work included), a launch (50 back-to-back
    calls) and on the device (a replayed CUDA graph of 20 calls), with the
    bound and the device time's share of it. Returns the JSON row and the
    operand."""
    from repro_torch.kernels import conv1d_causal, conv1d_causal_plain

    K, D = w.shape
    xz = torch.randn((1, L, 2 * D), generator=gen, device=w.device
                     ).to(w.dtype)
    x = xz[..., :D]  # the in-projection's x half, as the path passes it
    xc = x.transpose(1, 2).contiguous()  # channels-first, made untimed
    wc = w.t().contiguous()[:, None, :]  # (D, 1, K) for F.conv1d

    def kernel():
        return conv1d_causal(x, w)

    def library():
        return F.conv1d(xc, wc, padding=K - 1, groups=D)[..., :L]

    want = conv1d_causal_plain(x, w)
    err, _ = rel_err(kernel(), want)
    lib_err, _ = rel_err(library().transpose(1, 2), want)
    nbytes = (2 * L * D + K * D) * x.element_size()
    bms, by = bound_ms(2.0 * K * L * D, nbytes, PEAK_F32_FLOPS)
    row = {"kernel_shape": "conv1d_causal", "B": 1, "L": L, "D": D, "K": K,
           "dtype": str(x.dtype).replace("torch.", ""),
           "ms": median_ms(kernel, 3, 20), "ms_per_launch": per_launch_ms(kernel),
           "device_ms": graph_ms_per_call(kernel)}
    if plain:
        row["plain_ms"] = median_ms(lambda: conv1d_causal_plain(x, w), 2, 10)
    row.update(library_ms=median_ms(library, 3, 20),
               library_ms_per_launch=per_launch_ms(library),
               library_device_ms=graph_ms_per_call(library),
               library="F.conv1d groups=D, channels-first copy made outside "
                       "the timing",
               max_abs_err_vs_plain=err, library_max_abs_err_vs_plain=lib_err,
               bound_ms=bms, bound_by=by, compulsory_words=nbytes / 4)
    for key in ("device_ms", "library_device_ms"):
        if isinstance(row[key], float):
            row[key.replace("ms", "bound_share")] = bms / row[key]
    return row, x


def hybrid_phases(gen: torch.Generator, record) -> dict:
    """Phases 13-15 (module docstring): the conv1d kernel against its plain
    version, the hybrid serve of Jamba-1.5 at published widths (one pattern
    unit, experts off) and the conv1d kernel's times. Returns the kernel's
    entry of the ``kernels`` line (``max_abs_err`` filled in by the
    caller)."""
    import dataclasses

    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, conv1d_causal, conv1d_causal_plain
    from repro_torch.kernels.conv1d import CHUNK as CONV1D_CHUNK
    from repro_torch.kernels.conv1d import _conv1d_geometry, operand_width
    from repro_torch.kernels.conv1d import launch_config as conv1d_config
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.serving import Engine, Request

    dev = torch.device("cuda")

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    # -- 13. conv1d against its plain version -------------------------------
    gen.manual_seed(SEED + 50)
    cases = [  # (B, L, D, K, tiles)
        (3, 50, 37, 4, None),        # ragged D (bD 16)
        (19, 40, 45, 4, None),       # ragged B and D (bB 16)
        (2, 64, 64, 1, None), (2, 64, 64, 2, None), (2, 64, 64, 4, None),
        (2, 1, 64, 4, None),         # L = 1
        (2, 2, 64, 4, None),         # L < K - 1
        (2, CONV1D_CHUNK, 64, 4, None),      # L = one ring chunk
        (2, CONV1D_CHUNK + 1, 64, 4, None),  # L = one chunk and a row
        (1, 1000, 256, 4, None),     # more chunks than ring slots
        (3, 1000, 40, 8, None),      # the same over ragged D, K = 8
        (20, 30, 16, 4, None),       # nD == 1, nB == 2
        (3, 33, 130, 4, (2, 130)),   # nD == 1 from explicit tiles, split
        (2, 17, 300, 8, (1, 256)),   # K = 8, a tile split over CTAs
        (1, 300, 16384, 4, None),    # the serve's prefill shape
        (1, 300, 16384, 8, None),    # K = 8 at the serve's width
    ]

    def check(x, w, tiles, what):
        bB, bD, _, _, grid = _conv1d_geometry(x, w, tiles, None)
        c = conv1d_config(w.shape[0], bB, bD, grid, x.element_size(),
                          operand_width(x))
        got = conv1d_causal(x, w, tiles=tiles)
        torch.cuda.synchronize()
        record("conv1d_causal", got, conv1d_causal_plain(x, w),
               f"{x.dtype} {what}: copies {c['copy']} {c['copy_bytes']} B, "
               f"span {c['span']} x {c['parts']} parts, grid {c['grid']}")

    for dt in (torch.bfloat16, torch.float32):
        for (B, L, D, K, tiles) in cases:
            check(randn((B, L, D), dt), randn((K, D), dt, K ** -0.5), tiles,
                  f"(B, L, D, K) {(B, L, D, K)} tiles {tiles}")
        # the path's operand: the x half of the in-projection, row-strided
        xz = randn((1, 300, 2 * 16384), dt)
        check(xz[..., :16384], randn((4, 16384), dt, 0.5), None,
              "(1, 300, 16384, 4) strided view of (1, 300, 32768)")
        # strided views 1, 2 and 4 elements past an aligned base: narrower
        # copies (bf16: 2-byte loads, 4- and 8-byte cp.async)
        xz = randn((2, 100, 2 * 64 + 8), dt)
        w = randn((4, 64), dt, 0.5)
        for off in (1, 2, 4):
            check(xz[..., off:off + 64], w, None,
                  f"(2, 100, 64, 4) view at element {off} of (2, 100, 136)")
    del xz, w
    torch.cuda.empty_cache()

    # -- 14. the hybrid serve -----------------------------------------------
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, n_experts=0, experts_per_token=0,
                              n_layers=len(full.pattern))
    t0 = time.perf_counter()
    master = T.init_params(cfg, seed=SEED, device="cuda")
    params = T.compute_params(master, cfg)
    del master  # the engine and forwards use the bf16 copy
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    n_mamba = cfg.pattern.count("mamba")
    print(f"hybrid: {cfg.name} at published widths (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, d_inner {cfg.d_inner}, state {cfg.ssm_state_dim}, "
          f"conv kernel {cfg.conv_kernel}, chunk {cfg.chunk_size}, vocab "
          f"{cfg.padded_vocab}); reduced: depth {full.n_layers} -> "
          f"{cfg.n_layers} (one pattern unit: {n_mamba} mamba + "
          f"{cfg.pattern.count('attn')} attention), MoE FFN ({full.n_experts} "
          f"experts, top {full.experts_per_token}) -> dense SwiGLU at every "
          f"position; {cfg.param_count() / 1e9:.2f} B parameters, random "
          f"weights made on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    lens, prompts = hybrid_prompts(cfg.vocab_size)
    ctx = ExecutionContext(target=H100, backend="cuda")
    ref_ctx = ExecutionContext(target=H100, backend="torch")
    eng = Engine(cfg, params, max_len=512, batch_size=4, ctx=ctx)
    if eng.paged or eng.prefill_bucket != 1:
        fail("hybrid engine: expected the contiguous cache and exact-length "
             "prefill")
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    names = ("conv1d_causal", "flash_attention")
    torch.cuda.synchronize()
    with ops.record_dispatch() as log, serve_events() as ev:
        zero_counts()
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {n: KERNELS[n].launches for n in names}
    graphs_row = GRAPHS["hybrid"] = graph_gates("hybrid engine", eng, ev)
    print(f"hybrid engine launches: {json.dumps(launched)}", flush=True)
    flash_on_tensor_cores("hybrid engine")
    if launched["conv1d_causal"] != n_mamba * len(reqs):
        fail(f"hybrid engine: conv1d_causal launched "
             f"{launched['conv1d_causal']} times, not {n_mamba} mamba layers "
             f"x {len(reqs)} prefills")
    if launched["flash_attention"] <= 0:
        fail("hybrid engine: the flash_attention kernel was never launched")
    for r in reqs:
        if r.finish_reason != "length" or len(r.out_tokens) != 32:
            fail(f"hybrid engine: a request finished {r.finish_reason!r} "
                 f"with {len(r.out_tokens)} tokens, not 'length' with 32")
    decisions = {n: [d for d in log if d.op == n]
                 for n in ("conv1d_causal", "attention")}
    for n, ds in decisions.items():
        if not ds or any(d.chosen != "cuda" for d in ds):
            fail(f"hybrid engine: a {n} decision left cuda (or none made)")
    st = eng.stats
    ntok = sum(len(r.out_tokens) for r in reqs)
    weight_bytes = sum(t.numel() * t.element_size() for n, t in
                       params.state_dict().items() if n != "embed")
    serve_row = {
        "engine": "contiguous hybrid", "requests": len(reqs),
        "prompt_lens": [int(n) for n in lens], "generated_tokens": ntok,
        "wall_s": wall, "tok_per_s": ntok / wall,
        "prefill_ms_mean": 1e3 * statistics.mean(st.prefill_s),
        "prefill_ms_median": 1e3 * statistics.median(st.prefill_s),
        "prefill_ms_by_prompt": [1e3 * t for t in st.prefill_s],
        "decode_step_ms_median": 1e3 * statistics.median(st.decode_s),
        "decode_steps": len(st.decode_s), "launches": launched,
        "decisions": {n: len(ds) for n, ds in decisions.items()},
        "weight_stream_gb": weight_bytes / 1e9,
        "weight_stream_floor_ms": 1e3 * weight_bytes / PEAK_BYTES,
        **graphs_row, **events_summary(ev, 1e3 * wall)}
    print(json.dumps(serve_row), flush=True)

    # teacher-forced logits, cuda against torch, and every generated token
    # under the cache-less torch forward (phase 7's checks at 8 layers)
    allowance = logit_allowance(cfg.n_layers)
    for i in (5, 1):  # the 1-token prompt and the two-chunk prompt
        r = reqs[i]
        teacher_forced("hybrid_teacher_forced", i,
                       np.concatenate([r.prompt, r.out_tokens]).astype(
                           np.int64), cfg, params, ctx, ref_ctx, allowance)
    decode_check("hybrid contiguous", reqs, cfg, params, ref_ctx, allowance)
    torch.cuda.empty_cache()

    # where the time goes: the same serve traced, and one decode step's
    # forward alone (its launches and device time)
    trace_serve("contiguous hybrid engine, the same 8 requests",
                Engine(cfg, params, max_len=512, batch_size=4, ctx=ctx),
                prompts, 1e3 * wall)
    cache = T.init_cache(cfg, 4, 512, device="cuda")
    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
    depth = torch.tensor([300, 120, 40, 2], dtype=torch.int32, device=dev)

    def step():
        with torch.inference_mode():
            T.forward(params, cfg, tokens=tok, cache=cache,
                      cache_index=depth, ctx=ctx, decode=True)

    step_ms = median_ms(step, 2, 10)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in kern) / 1e3
    print(json.dumps({
        "hybrid_decode_step_forward": "B 4, depths 300/120/40/2",
        "ms": step_ms, "kernel_launches": len(kern),
        "device_kernel_ms": dev_ms or "not measured",
        "weight_stream_floor_ms": serve_row["weight_stream_floor_ms"]}),
        flush=True)
    del cache, eng, params
    torch.cuda.empty_cache()

    # -- 15. conv1d: kernel, plain version, library call, bound, words ------
    sums = dict.fromkeys(("ms", "ms_per_launch", "device_ms", "plain_ms",
                          "library_ms", "library_ms_per_launch",
                          "library_device_ms", "bound_ms"), 0.0)
    by_sum = {"bytes": 0.0, "operations": 0.0}
    D, K = cfg.d_inner, cfg.conv_kernel
    gen.manual_seed(SEED + 60)
    w = randn((K, D), torch.bfloat16, K ** -0.5)
    for L in sorted({int(n) for n in lens}):
        row, x = conv1d_shape_times(gen, L, w)
        if row["max_abs_err_vs_plain"] != 0.0:
            fail(f"conv1d_causal at L {L}: error {row['max_abs_err_vs_plain']}"
                 " against its plain version, not 0")
        d = ops.explain("conv1d_causal", ctx, dtype=x.dtype, spec_args=(x, w))
        row.update(measured_words=d.measured_words,
                   words_over_compulsory=d.measured_words
                   / row["compulsory_words"])
        for key in sums:
            both = isinstance(row[key], float) and isinstance(sums[key], float)
            sums[key] = sums[key] + row[key] if both else "not measured"
        by_sum[row["bound_by"]] += row["bound_ms"]
        print(json.dumps(row), flush=True)
        HELD.setdefault("conv1d", []).append((L, x, w))
        del x
    for key in ("device_ms", "library_device_ms"):
        if isinstance(sums[key], float):
            sums[key.replace("ms", "bound_share")] = (sums["bound_ms"]
                                                      / sums[key])
    print(json.dumps({"kernel_shapes_sum": "conv1d_causal", **sums}),
          flush=True)
    return {"name": "conv1d_causal", "route": "cuda",
            "launches": launched["conv1d_causal"], **sums,
            "bound_by": max(by_sum, key=by_sum.get), "ok": True,
            "shapes": "sum over the hybrid serve's 8 prefill shapes (1, L, "
                      f"{D}) x ({K}, {D}), bf16, x the strided half of the "
                      "in-projection; ms a call, ms_per_launch 50 back to "
                      "back, device_ms a replayed CUDA graph; library "
                      "F.conv1d (groups=D)"}


def overhang_bound(s, t, p, run):
    """Words of run - 1 elements for every window row of every CTA: the
    most the window runs' overhang can add to a conv launch of shape ``s``
    and tiles ``t`` at ``p`` words an element (phases 16 and 26)."""
    h_in = (t[3] - 1) * s.sh + s.h_F
    rows = (-(-s.N // t[0]) * t[0] * s.c_I * h_in * -(-s.h_O // t[3])
            * -(-s.w_O // t[4]) * -(-s.c_O // t[2]))
    return p * (run - 1) * rows


def audit_phase() -> int:
    """Phase 16 (module docstring): every main-path dispatch, on the
    operands the earlier phases left in ``HELD``, audited by
    ``ops.explain(..., audit=True)`` (an ``AuditError`` ends the run),
    launched once through its public entry and held to its access plan: the
    wrapper's ``last_launch`` grid, block, dynamic shared memory and
    cluster must be the plan's, and the words the counter does not charge
    (and the shortfall) must equal their formulas, computed here from the
    launch and the shapes. One JSON line a dispatch; returns their count."""
    from repro_torch import ops
    from repro_torch.core.conv_model import resnet50_layers, round_up
    from repro_torch.kernels import KERNELS, paged_decode_hbm_words
    from repro_torch.kernels.conv1d import _conv1d_geometry
    from repro_torch.kernels.flash_attention import paged_decode_issued_words
    from repro_torch.kernels.matmul import launch_config as mm_config
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100

    ctxs = {be: ExecutionContext(target=H100, backend=be)
            for be in ("cuda", "im2col")}
    layers = resnet50_layers(BATCH)
    count = 0

    def check(name, op, kernel, backend, spec_args, spec_kw, needs, run,
              expect):
        nonlocal count
        d = ops.explain(op, ctxs[backend], dtype=spec_args[0].dtype,
                        needs=needs, spec_args=spec_args, spec_kw=spec_kw,
                        audit=True)
        rep = d.audit_report
        if not rep.ok or d.audited != d.measured_words:
            fail(f"audit {name}: {rep.problems} {rep.hazards}")
        KERNELS[kernel].last_launch = None
        run()
        torch.cuda.synchronize()
        got, plan = KERNELS[kernel].last_launch, rep.launch
        want = {"grid": plan.grid, "block": plan.block,
                "smem": plan.smem_bytes, "cluster": plan.cluster}
        if got != want:
            fail(f"audit {name}: the {kernel} wrapper launched {got}, the "
                 f"access plan says {want}")
        uncounted = {k: v for k, v in rep.uncounted.items() if v}
        exp_unc, exp_short, overhang = expect(d, got)
        if overhang is not None:
            # the window runs' overhang has no closed form: it must lie
            # within run - 1 elements of every window row
            words = uncounted.pop("input run overhang", 0.0)
            if not 0 <= words <= overhang:
                fail(f"audit {name}: run overhang {words} words, above "
                     f"{overhang}")
        if uncounted != exp_unc or rep.shortfall != exp_short:
            fail(f"audit {name}: uncounted {uncounted}, shortfall "
                 f"{rep.shortfall}; the formulas give {exp_unc}, "
                 f"{exp_short}")
        print(json.dumps({
            "audit": name, "backend": backend, "kernel": plan.kernel,
            "grid": list(got["grid"]), "block": list(got["block"]),
            "cluster": list(got["cluster"]), "smem_bytes": got["smem"],
            "counted_words": rep.counted_words,
            "measured_words": d.measured_words,
            "issued_words": rep.issued_words, "uncounted": rep.uncounted,
            "shortfall": rep.shortfall, "bound_ratio": d.bound_ratio,
            "hazards": len(rep.hazards)}), flush=True)
        count += 1

    def ctas(got):
        return got["grid"][0] * got["grid"][1] * got["grid"][2]

    for name, s in layers.items():
        x, w = HELD["conv"][name]
        stride = (s.sh, s.sw)
        kw = {"stride": stride, "out_dtype": torch.float32}

        def conv_expect(d, got, s=s):
            return {}, 0.0, overhang_bound(s, d.plan.tiles, 0.5, 8)

        def im2col_expect(d, got, s=s):
            (m, _, k), (bm, bn, bk) = gemm_tiles(s)
            cfg = mm_config(bm, bn, bk, 2, k)
            kp = round_up(k, bk)
            short = kp - min(kp, cfg["n_spans"] * cfg["ks"])
            tiles = -(-m // bm) * -(-s.c_O // bn)
            return ({"filter transpose read": 0.5 * s.c_O * k,
                     "filter transpose write": 0.5 * s.c_O * k},
                    tiles * short * (bm + bn) * 0.5, None)

        check(f"conv2d/{name}", "conv2d", "conv2d", "cuda", (x, w), kw, (),
              lambda: ops.conv2d(x, w, stride, ctx=ctxs["cuda"],
                                 out_dtype=torch.float32), conv_expect)
        check(f"conv2d/{name}", "conv2d", "matmul", "im2col", (x, w), kw, (),
              lambda: ops.conv2d(x, w, stride, ctx=ctxs["im2col"],
                                 out_dtype=torch.float32), im2col_expect)
        torch.cuda.empty_cache()
    for name, s in layers.items():
        xq, wq, sc = HELD["conv_q"][name]
        stride = (s.sh, s.sw)

        def conv_q_expect(d, got, s=s):
            t = d.plan.tiles
            n_co = -(-s.c_O // t[2])
            return ({"scale (per-CTA slices)": float((ctas(got) - n_co)
                                                     * t[2])},
                    0.0, overhang_bound(s, t, 0.25, 16))

        check(f"conv2d_q/{name}", "conv2d_q", "conv2d_q", "cuda",
              (xq, wq, sc), {"stride": stride, "out_dtype": torch.bfloat16},
              (), lambda: ops.conv2d_q(xq, wq, sc, stride,
                                       ctx=ctxs["cuda"]), conv_q_expect)
    for label, (aq, bq, sc) in HELD["matmul_q"].items():
        def mm_q_expect(d, got, n=bq.shape[1]):
            bn = d.plan.tiles[1]
            excess = float((ctas(got) - -(-n // bn)) * bn)
            return ({"scale (per-CTA slices)": excess} if excess else {},
                    0.0, None)

        check(f"matmul_q/{label}", "matmul_q", "matmul_q", "cuda",
              (aq, bq, sc), {"out_dtype": torch.bfloat16}, (),
              lambda: ops.matmul_q(aq, bq, sc, ctx=ctxs["cuda"]),
              mm_q_expect)
    att = HELD.pop("attention")
    q, k, v, off0, km = att["prefill"]

    def flash_expect(d, got):
        return {"q_offset/kv_lens": 2.0 * ctas(got)}, 0.0, None

    check("attention/qwen prefill", "attention", "flash_attention", "cuda",
          (q, k, v), None, ("dynamic_q_offset", "key_mask"),
          lambda: ops.attention(q, k, v, q_offset=off0, key_mask=km,
                                ctx=ctxs["cuda"]), flash_expect)
    qd, kd, vd, depth = att["decode"]
    check("attention/qwen contiguous decode", "attention", "flash_attention",
          "cuda", (qd, kd, vd), None, ("per_row_q_offset",),
          lambda: ops.attention(qd, kd, vd, q_offset=depth,
                                ctx=ctxs["cuda"]), flash_expect)
    # a rank's launch with row statistics over its shard of Qwen2.5-3B's
    # sequence-sharded decode_32k cache (phase 31): per-row offsets, some
    # past every key of the shard
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 16)
    qs = torch.randn((SEQ_BATCH, 16, 1, 128), generator=gen,
                     device="cuda").to(torch.bfloat16)
    ks, vs = (torch.randn((SEQ_BATCH, 2, SEQ_LEN // MESH_RANKS, 128),
                          generator=gen, device="cuda").to(torch.bfloat16)
              for _ in "kv")
    offs = torch.randint(-SEQ_LEN // 2, SEQ_LEN // MESH_RANKS, (SEQ_BATCH,),
                         generator=gen, device="cuda", dtype=torch.int32)
    check("attention/qwen sequence-sharded decode, a rank's stats launch",
          "attention", "flash_attention_stats", "cuda", (qs, ks, vs),
          {"stats": True}, ("per_row_q_offset",),
          lambda: ops.attention(qs, ks, vs, q_offset=offs, ctx=ctxs["cuda"],
                                stats=True), flash_expect)
    del qs, ks, vs
    qp, kp, vp, tables, lengths = att["paged"]

    def paged_expect(d, got):
        B, H, _, hd = qp.shape
        KV, bs, w = kp.shape[1], kp.shape[2], tables.shape[1]
        lens = lengths.tolist()
        return {}, (paged_decode_hbm_words(B, KV, H // KV, w, bs, hd, 0.5,
                                           0.5, 0.5)
                    - paged_decode_issued_words(lens, B, KV, H // KV, w, bs,
                                                hd, 0.5, 0.5, 0.5)), None

    check("attention_decode/qwen paged", "attention_decode", "paged_decode",
          "cuda", (qp, kp, vp, tables, lengths), None, (),
          lambda: ops.attention_decode(qp, kp, vp, tables, lengths,
                                       ctx=ctxs["cuda"]), paged_expect)
    # the engine's launch: the split from its table capacity (512 / 16)
    check("attention_decode/qwen paged, engine capacity 32",
          "attention_decode", "paged_decode", "cuda",
          (qp, kp, vp, tables, lengths), {"capacity": 32}, (),
          lambda: ops.attention_decode(qp, kp, vp, tables, lengths,
                                       ctx=ctxs["cuda"], capacity=32),
          paged_expect)
    for L, x, w in HELD.pop("conv1d"):
        def conv1d_expect(d, got, x=x, w=w):
            K = w.shape[0]
            bB, bD, Bp, Dp, (nB, nD) = _conv1d_geometry(x, w, None, H100)
            exp = {}
            if nD == 1 and nB > 1:
                exp["w (per-CTA fetches)"] = (nB - 1) * K * bD * 0.5
            B, L_, D = x.shape
            pad = nB * nD * bB * L_ * bD - B * L_ * D
            w_pad = (nB * nD if nD > 1 else 1) * K * bD - (
                nB if nD > 1 else 1) * K * D
            return exp, float((2 * pad + w_pad) * 0.5), None

        check(f"conv1d_causal/jamba prefill L{L}", "conv1d_causal",
              "conv1d_causal", "cuda", (x, w), None, (),
              lambda: ops.conv1d_causal(x, w, ctx=ctxs["cuda"]),
              conv1d_expect)
    return count


def rank_correlation(xs, ys):
    """Spearman's rank correlation of two lists; None for fewer than 3
    points or a constant list."""
    from scipy.stats import spearmanr

    if len(xs) < 3 or len(set(xs)) < 2 or len(set(ys)) < 2:
        return None
    return float(spearmanr(xs, ys)[0])


def autotune_phase() -> dict:
    """Phase 17 (module docstring): ``Planner(H100).autotune`` on the device
    timer for the conv path's four kernels (the five layers as bf16 and as
    int8 convs, their five Im2Col GEMMs, phase 11's three int8 GEMMs: 18
    searches), every timed candidate held once against its plain version
    on the operands phase 16 leaves in ``HELD``; each tuned plan through its
    public entry point (plan source, words, audit, launch, output); the plan
    cache's save/clear/load round trip (zero re-searches); then the five
    bf16 conv searches again with ``bound_cap=inf``. One ``{"autotune":
    ...}`` line a search; returns the summary."""
    import dataclasses
    import tempfile

    from repro_torch import ops
    from repro_torch.analysis.roofline import hbm_seconds
    from repro_torch.core.conv_model import Precision, resnet50_layers
    from repro_torch.kernels import KERNELS, conv2d_plain, matmul_plain
    from repro_torch.kernels.conv2d import conv2d as conv2d_kernel
    from repro_torch.kernels.im2col import im2col_patches
    from repro_torch.kernels.matmul import matmul as matmul_kernel
    from repro_torch.kernels.quant import (conv2d_q as conv2d_q_kernel,
                                           conv2d_q_plain,
                                           matmul_q as matmul_q_kernel,
                                           matmul_q_plain)
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import (H100, AutotunePolicy, ConvSpec,
                                  MatmulSpec, Planner)
    from repro_torch.plan import autotune
    from repro_torch.quant import INT8_SPEC

    t_phase = time.perf_counter()
    bf16, int8 = Precision(0.5, 0.5, 1.0), Precision(0.25, 0.25, 0.5)
    ctx = ExecutionContext(target=H100, backend="cuda", autotune=True)
    qctx = dataclasses.replace(ctx, target=H100.with_quant(INT8_SPEC))
    layers = resnet50_layers(BATCH)
    fits, lines, tuned = [], [], {}

    def case(label, op, ectx, kernel, operands, plain, entry, spec_kw, call,
             cut):
        """One search's op and target, the kernel wrapper that runs a
        candidate's tiles on ``operands``, the plain version of a slice of
        rows (images), the public entry and its call, and the rows held
        against the plain version at each end."""
        return dict(label=label, op=op, ctx=ectx, kernel=kernel,
                    operands=operands, plain=plain, entry=entry,
                    spec_args=tuple(t for t in operands
                                    if isinstance(t, torch.Tensor)),
                    spec_kw=spec_kw, call=call, cut=cut)

    def slices(n, cut):
        return ([slice(0, n)] if n <= 2 * cut
                else [slice(0, cut), slice(n - cut, n)])

    def held(c, got, wants, what):
        worst = 0.0
        for sl, want in zip(slices(got.shape[0], c["cut"]), wants):
            err, allowed = rel_err(got[sl], want)
            if not err <= allowed:
                fail(f"autotune {c['label']}: {what} disagrees with the "
                     f"plain version ({err} above {allowed})")
            worst = max(worst, err)
        return worst

    def search(c, policy, tag, wants):
        n0 = autotune.search_count()
        t0 = time.perf_counter()
        plan = Planner(c["ctx"].target).autotune(c["op"], policy=policy)
        secs = time.perf_counter() - t0
        if autotune.search_count() != n0 + 1:
            fail(f"autotune {c['label']}: no search ran")
        rep = autotune.search_report(c["op"], c["ctx"].target)
        if rep.timer != "device":
            fail(f"autotune {c['label']}: timed on the {rep.timer}")
        err = 0.0
        for cand in rep.timed:  # the first run of these kernels at these tiles
            got = c["kernel"](*c["operands"], tiles=cand.tiles)
            torch.cuda.synchronize()
            err = max(err, held(c, got, wants, f"tiles {cand.tiles}"))
            del got
        xs = [autotune._transfers(t.grid) for t in rep.timed]
        ys = [t.seconds - hbm_seconds(t.words) for t in rep.timed]
        fits.extend(zip(xs, ys))
        an, win = rep.analytic_candidate, rep.winner

        def row(t):
            return {"tiles": list(t.tiles), "words": t.words,
                    "bound_ratio": t.words / plan.lower_bound,
                    "device_ms": t.seconds * 1e3}

        line = {"autotune": c["label"], "policy": tag, "op": c["op"].to_dict(),
                "candidates": {"enumerated": rep.enumerated,
                               "frontier": rep.frontier, "kept": rep.kept,
                               "audited": len(rep.timed),
                               "not_auditable": dict(rep.not_auditable)},
                "analytic": row(an), "winner": row(win),
                "roofline_pick": row(rep.roofline_pick),
                "winner_over_analytic": win.seconds / an.seconds,
                "words_ms_rank_correlation": rank_correlation(
                    [t.words for t in rep.timed],
                    [t.seconds for t in rep.timed]),
                "timed": [[list(t.tiles), t.words, t.seconds * 1e3]
                          for t in rep.timed],
                "fitted_dma_setup_seconds": (
                    sum(x * y for x, y in zip(xs, ys))
                    / sum(x * x for x in xs)),
                "max_abs_err": err, "search_seconds": secs}
        print(json.dumps(line), flush=True)
        return line

    def gate(c, line):
        """The tuned plan through the public entry point: plan source,
        words, the static audit, the launch and the output."""
        d = ops.explain(c["entry"], c["ctx"], dtype=c["spec_args"][0].dtype,
                        spec_args=c["spec_args"], spec_kw=c["spec_kw"],
                        audit=True)
        if d.plan_source != "tuned" or \
                list(d.plan.tiles) != line["winner"]["tiles"]:
            fail(f"autotune {c['label']}: the entry resolved the "
                 f"{d.plan_source} plan {d.plan.tiles}")
        if d.measured_words != d.plan.tuned.winner_words or \
                d.audited != d.measured_words:
            fail(f"autotune {c['label']}: words {d.measured_words}, winner "
                 f"{d.plan.tuned.winner_words}, audited {d.audited}")
        KERNELS[c["entry"]].last_launch = None
        y = c["call"]()
        torch.cuda.synchronize()
        la = d.audit_report.launch
        want = {"grid": la.grid, "block": la.block, "smem": la.smem_bytes,
                "cluster": la.cluster}
        if KERNELS[c["entry"]].last_launch != want:
            fail(f"autotune {c['label']}: launched "
                 f"{KERNELS[c['entry']].last_launch}, the plan says {want}")
        return y

    def run(c):
        wants = [c["plain"](sl)
                 for sl in slices(c["operands"][0].shape[0], c["cut"])]
        line = search(c, AutotunePolicy(), "default", wants)
        lines.append(line)
        tuned[c["label"]] = (c["op"], c["ctx"].target,
                             line["winner"]["tiles"])
        held(c, gate(c, line), wants, "the public entry's output")

    def conv_case(name, s, q):
        x, w, *scale = HELD["conv_q" if q else "conv"][name]
        st = (s.sh, s.sw)
        op = ConvSpec(N=s.N, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O, h_O=s.h_O,
                      w_F=s.w_F, h_F=s.h_F, sw=s.sw, sh=s.sh,
                      prec=int8 if q else bf16)
        if q:
            sc = scale[0]
            return case(f"conv2d_q/{name}", op, qctx, conv2d_q_kernel,
                        (x, w, sc, st),
                        lambda sl: conv2d_q_plain(x[sl], w, sc, st),
                        "conv2d_q", {"stride": st,
                                     "out_dtype": torch.bfloat16},
                        lambda: ops.conv2d_q(x, w, sc, st, ctx=qctx), BLOCK)
        return case(f"conv2d/{name}", op, ctx, conv2d_kernel, (x, w, st),
                    lambda sl: conv2d_plain(x[sl], w, st), "conv2d",
                    {"stride": st, "out_dtype": torch.float32},
                    lambda: ops.conv2d(x, w, st, ctx=ctx,
                                       out_dtype=torch.float32), BLOCK)

    bf16_convs = [conv_case(n, s, False) for n, s in layers.items()]
    for c in bf16_convs:
        run(c)
    for name, s in layers.items():  # one layer's patches alive at a time
        x, w = HELD["conv"][name]
        a = im2col_patches(x, s.h_F, s.w_F, (s.sh, s.sw))
        b = w.reshape(s.c_O, -1).t().contiguous()
        run(case(f"matmul/{name} Im2Col",
                 MatmulSpec(a.shape[0], s.c_O, a.shape[1], bf16), ctx,
                 matmul_kernel, (a, b), lambda sl: matmul_plain(a[sl], b),
                 "matmul", {"out_dtype": torch.float32},
                 lambda: ops.matmul(a, b, ctx=ctx), 4096))
        del a, b
        torch.cuda.empty_cache()
    for name, s in layers.items():
        run(conv_case(name, s, True))
    for label, (aq, bq, sc) in HELD["matmul_q"].items():
        run(case(f"matmul_q/{label}",
                 MatmulSpec(aq.shape[0], bq.shape[1], aq.shape[1], int8),
                 qctx, matmul_q_kernel, (aq, bq, sc),
                 lambda sl: matmul_q_plain(aq[sl], bq, sc), "matmul_q",
                 {"out_dtype": torch.bfloat16},
                 lambda: ops.matmul_q(aq, bq, sc, ctx=qctx), 4096))

    # serving never re-searches: save, clear, load, re-plan all 18
    n0 = autotune.search_count()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plans.json")
        Planner.cache.save(path)
        Planner.cache.clear()
        Planner.cache.load(path)
    for label, (op, target, tiles) in tuned.items():
        ep = Planner(target).plan(op)
        if ep.tuned is None or list(ep.tiles) != tiles:
            fail(f"autotune {label}: the reloaded cache serves {ep.tiles}")
    re_searches = autotune.search_count() - n0
    if re_searches:
        fail(f"{re_searches} re-searches after the plan cache's "
             "save/clear/load round trip")

    # the five bf16 conv searches again, with no bound cap
    autotune.clear_records()
    wide = AutotunePolicy(bound_cap=float("inf"))
    uncapped = []
    for c in bf16_convs:
        wants = [c["plain"](sl)
                 for sl in slices(c["operands"][0].shape[0], c["cut"])]
        uncapped.append(search(c, wide, "bound_cap=inf", wants))
        d = ops.explain("conv2d", ctx, dtype=torch.bfloat16,
                        spec_args=c["spec_args"], spec_kw=c["spec_kw"],
                        audit=True)  # its winner audits too
        if list(d.plan.tiles) != uncapped[-1]["winner"]["tiles"]:
            fail(f"autotune {c['label']}: uncapped winner not served")
    autotune.clear_records()
    sums = {}
    for line in lines:  # device ms per kernel over its searches
        t = sums.setdefault(line["autotune"].split("/")[0],
                            {"analytic_ms": 0.0, "tuned_ms": 0.0})
        t["analytic_ms"] += line["analytic"]["device_ms"]
        t["tuned_ms"] += line["winner"]["device_ms"]
    summary = {
        "autotune_summary": len(lines) + len(uncapped),
        "searches_default": len(lines), "searches_uncapped": len(uncapped),
        "timed_candidates": sum(line["candidates"]["audited"]
                                for line in lines + uncapped),
        "re_searches_after_reload": re_searches,
        "winner_faster_than_analytic": sum(
            line["winner_over_analytic"] < 1.0 for line in lines),
        "winner_faster_beyond_3_percent": sum(
            line["winner_over_analytic"] < 0.97 for line in lines),
        "roofline_pick_is_winner": sum(
            line["roofline_pick"]["tiles"] == line["winner"]["tiles"]
            for line in lines),
        "device_ms_sums": sums,
        "fitted_dma_setup_seconds_pooled": (
            sum(x * y for x, y in fits) / sum(x * x for x, _ in fits)),
        "phase_seconds": time.perf_counter() - t_phase}
    print(json.dumps(summary), flush=True)
    return summary


def graph_phase() -> None:
    """Phase 18 (module docstring): one decode step of each engine eagerly
    and as a captured graph's replay, on equal random state at published
    widths; fatal unless logits and every cache leaf are equal bit for bit.
    One ``{"graph_step": ...}`` line an engine."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.serving import Engine
    from repro_torch.serving.graphs import check_replay, probe_inputs

    ctx = ExecutionContext(target=H100, backend="cuda")
    paged = dict(paged=True, block_size=16)
    models = (
        (ARCH, (("paged bf16", "paged", paged),
                ("contiguous", "contiguous", dict(paged=False)),
                ("paged int8", "paged int8", dict(paged, kv_dtype="int8")))),
        (HYBRID_ARCH, (("hybrid", "hybrid", {}),)))
    for arch, engines in models:
        cfg = get_config(arch)
        if arch == HYBRID_ARCH:  # phase 14's cut: one unit, experts off
            cfg = dataclasses.replace(cfg, n_experts=0, experts_per_token=0,
                                      n_layers=len(cfg.pattern))
        master = T.init_params(cfg, seed=SEED, device="cuda")
        params = T.compute_params(master, cfg)
        del master
        weight_bytes = sum(t.numel() * t.element_size() for n, t in
                           params.state_dict().items() if n != "embed")
        for name, serve_key, kw in engines:
            eng = Engine(cfg, params, max_len=512, batch_size=4, ctx=ctx,
                         **kw)
            with torch.inference_mode():
                state = probe_inputs(eng, seed=SEED + 80)
                res = check_replay(eng, *state, profile=True)
            row = {"graph_step": name, "model": cfg.name,
                   "layers": cfg.n_layers, "batch": 4,
                   "table_width": state[4],
                   "logits_equal": res["logits_equal"],
                   "leaves_equal": res["leaves_equal"],
                   "written_leaves": res["written_leaves"],
                   "eager_step_host_ms": 1e3 * res["eager_host_s"],
                   "eager_step_device_ms": 1e3 * res["eager_device_s"],
                   "replay_host_ms": 1e3 * res["replay_host_s"],
                   "replay_device_ms": 1e3 * res["replay_device_s"],
                   "capture_s": res["capture_s"],
                   # the same replays traced: a profiler sum below the
                   # events' time is kernels lost, or idle between nodes
                   "profiled_replay": res["profiled_replay"],
                   "weight_stream_floor_ms": 1e3 * weight_bytes / PEAK_BYTES,
                   "serve": GRAPHS.get(serve_key)}
            print(json.dumps(row), flush=True)
            if not (res["logits_equal"] and res["leaves_equal"]
                    and res["finite"] and res["written_leaves"]):
                fail(f"{name}: a replayed decode step differs from the eager "
                     f"one (unequal leaves {res['unequal_leaves'][:4]}, "
                     f"logits equal {res['logits_equal']})")
            del eng, state
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()


def moe_weight_floors(params, cfg) -> dict:
    """A decode step's two weight floors at the HBM rate: every weight but
    the embedding read once (the dense dispatch einsums read every expert),
    and one token's active weights (K of E experts)."""
    sd = params.state_dict()
    expert = sum(t.numel() * t.element_size() for n, t in sd.items()
                 if ".ffn.w_" in n)
    other = sum(t.numel() * t.element_size() for n, t in sd.items()
                if n != "embed" and ".ffn.w_" not in n)
    active = other + expert * cfg.experts_per_token / cfg.n_experts
    return {"expert_gb": expert / 1e9, "other_gb": other / 1e9,
            "all_expert_floor_ms": 1e3 * (expert + other) / PEAK_BYTES,
            "active_gb": active / 1e9,
            "active_floor_ms": 1e3 * active / PEAK_BYTES}


def lm_serve_phase(arch: str, engines, tag: str) -> dict:
    """Phases 19 and 20 (module docstring): ``arch`` at published widths
    and full depth with seeded random weights, served greedily through
    ``engines`` ((name, Engine keywords)) inside
    ``ops.record_dispatch()`` with ``moe.count_drops``; each serve held to
    ``serve_and_gate``; every attention decision on ``cuda``; first tokens
    equal across the engines; teacher-forced logits of two requests under
    ``cuda`` and ``torch`` (with the routing flips of an MoE model). Returns
    what the phase's own checks reuse: config, weights, contexts, prompts,
    allowance, the first engine's requests and rows."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.serving import Engine

    HELD.clear()  # phases 16-17 are done with their operands
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    t0 = time.perf_counter()
    master = T.init_params(cfg, seed=SEED, device="cuda")
    n_params = sum(t.numel() for t in master.parameters())
    params = T.compute_params(master, cfg)
    del master  # the engines and forwards use the bf16 copy
    torch.cuda.synchronize()
    print(f"{tag}: {cfg.name} at published widths and full depth "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, {cfg.n_experts} experts top "
          f"{cfg.experts_per_token}, capacity factor {cfg.capacity_factor}, "
          f"vocab {cfg.padded_vocab}); {n_params / 1e9:.3f} B parameters made "
          f"on the card in {time.perf_counter() - t0:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    _, prompts, sharing = serving_prompts(cfg.vocab_size)
    ctx = ExecutionContext(target=H100, backend="cuda")
    ref_ctx = ExecutionContext(target=H100, backend="torch")
    served, rows = {}, {}
    with ops.record_dispatch() as log:
        for name, kw in engines:
            eng = Engine(cfg, params, max_len=512, batch_size=4, ctx=ctx,
                         block_size=16, **kw)
            with moe.count_drops("cuda") as drops:
                served[name], rows[name] = serve_and_gate(
                    f"{tag} {name}", eng, prompts)
                dropped, routed = drops.tolist()
            rows[name].update(model=cfg.name, shared_prefix_requests=sharing,
                              pool_blocks=eng.num_blocks,
                              dropped_choices=dropped, routed_choices=routed,
                              dropped_share=dropped / routed if routed
                              else 0.0)
            print(json.dumps(rows[name]), flush=True)
            del eng
    attn = [d for d in log if d.op in ("attention", "attention_decode")]
    off = [d for d in attn if d.chosen != "cuda"]
    print(f"{tag} dispatch: {len(attn)} attention decisions, {len(off)} off "
          "cuda", flush=True)
    if not attn or off:
        fail(f"{tag}: attention decisions chosen off cuda: {off[:3]}")
    firsts = {n: [int(r.out_tokens[0]) for r in reqs]
              for n, reqs in served.items()}
    if len({tuple(f) for f in firsts.values()}) != 1:
        fail(f"{tag}: first tokens differ between engines: {firsts}")
    allowance = logit_allowance(cfg.n_layers)
    first = engines[0][0]
    for i in (0, 1):
        r = served[first][i]
        teacher_forced(f"{tag}_teacher_forced", i,
                       np.concatenate([r.prompt, r.out_tokens]).astype(
                           np.int64), cfg, params, ctx, ref_ctx, allowance)
    torch.cuda.empty_cache()
    return {"cfg": cfg, "params": params, "ctx": ctx, "ref_ctx": ref_ctx,
            "prompts": prompts, "allowance": allowance,
            "requests": served[first], "rows": rows}


def moe_phase() -> None:
    """Phase 19 (module docstring): OLMoE-1B-7B at published widths and
    full depth."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.serving import Engine
    from repro_torch.serving.graphs import check_replay, probe_inputs

    t_phase = time.perf_counter()
    run = lm_serve_phase(MOE_ARCH, (("paged", dict(paged=True)),
                                    ("contiguous", dict(paged=False))), "moe")
    cfg, params, ctx = run["cfg"], run["params"], run["ctx"]
    # every generated token against the cache-less forward, on a serve at
    # capacity factor E / K, where no group drops a choice: at 1.25 the
    # drops depend on how the tokens are grouped (module docstring)
    cfg8 = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    eng = Engine(cfg8, params, max_len=512, batch_size=4, ctx=ctx,
                 block_size=16, paged=True)
    with moe.count_drops("cuda") as drops:
        reqs8, row8 = serve_and_gate(
            f"moe paged, capacity factor {cfg8.capacity_factor:g}", eng,
            run["prompts"])
        dropped8, routed8 = drops.tolist()
    row8.update(dropped_choices=dropped8, routed_choices=routed8)
    print(json.dumps(row8), flush=True)
    if dropped8:
        fail(f"moe: {dropped8} choices dropped at capacity factor "
             f"{cfg8.capacity_factor:g}, where no group can drop one")
    decode_check(f"moe paged, capacity factor {cfg8.capacity_factor:g}",
                 reqs8, cfg8, params, run["ref_ctx"], run["allowance"])
    del eng
    # one decode step eagerly and replayed (phase 18's check) at 1.25:
    # bit-equal, its device and host time and its graph's kernels
    eng = Engine(cfg, params, max_len=512, batch_size=4, ctx=ctx,
                 block_size=16, paged=True)
    with torch.inference_mode():
        state = probe_inputs(eng, seed=SEED + 90)
        res = check_replay(eng, *state, profile=True)
    del eng, state
    floors = moe_weight_floors(params, cfg)
    paged = run["rows"]["paged"]
    row = {"moe_step": cfg.name, "batch": 4,
           "logits_equal": res["logits_equal"],
           "leaves_equal": res["leaves_equal"],
           "replay_device_ms": 1e3 * res["replay_device_s"],
           "replay_host_ms": 1e3 * res["replay_host_s"],
           "eager_step_device_ms": 1e3 * res["eager_device_s"],
           "capture_s": res["capture_s"],
           "kernels_per_replay": res["profiled_replay"]["profiler_kernels"],
           "profiled_replay": res["profiled_replay"], **floors,
           "serve_replay_device_ms_median": paged["replay_device_ms_median"],
           "serve_decode_step_ms_median": paged["decode_step_ms_median"],
           "serve_prefill_ms_median": paged["prefill_ms_median"],
           "serve_tok_per_s": paged["tok_per_s"],
           "dropped_share_at_1.25": paged["dropped_share"],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": smi(), "phase_seconds": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    if not (res["logits_equal"] and res["leaves_equal"] and res["finite"]
            and res["written_leaves"]):
        fail(f"moe: a replayed decode step differs from the eager one "
             f"(unequal leaves {res['unequal_leaves'][:4]})")
    del params, run
    torch.cuda.empty_cache()


def vlm_phase() -> None:
    """Phase 20 (module docstring): InternVL2-1B's backbone at published
    widths and full depth, and one forward over stub patch embeddings."""
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    run = lm_serve_phase(VLM_ARCH, (("paged", dict(paged=True)),), "vlm")
    cfg, params = run["cfg"], run["params"]
    decode_check("vlm paged", run["requests"], cfg, params, run["ref_ctx"],
                 run["allowance"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 100)
    embeds = torch.randn((2, 256, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)

    def forward(c):
        with torch.inference_mode():
            return T.forward(params, cfg, embeds=embeds, ctx=c)[0]

    a, launched, _ = count_launches("vlm stub-embedding forward",
                                    ("flash_attention",),
                                    lambda: forward(run["ctx"]))
    b = forward(run["ref_ctx"])
    err = (a - b).abs().max().item()
    allowed = run["allowance"](b)
    print(json.dumps({
        "vlm_embeds_forward": list(embeds.shape), "launches": launched,
        "logits_shape": list(a.shape), "max_abs_err": err,
        "allowed": allowed, "argmax_agreement":
        (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
        "phase_seconds": time.perf_counter() - t_phase}), flush=True)
    if (a.shape != (2, 256, cfg.padded_vocab) or not torch.isfinite(a).all()
            or launched["flash_attention"] != cfg.n_layers):
        fail(f"vlm: stub-embedding forward gave {tuple(a.shape)} logits, "
             f"{launched} launches")
    if not err <= allowed:
        fail(f"vlm: stub-embedding logits, cuda vs torch error {err} above "
             f"{allowed}")
    del a, b, params, run
    torch.cuda.empty_cache()


HUBERT_ARCH = "hubert_xlarge"
TRAIN_ARCH = "qwen2_5_3b"
TRAIN_LAYERS = 8  # phase 22's depth cut (module docstring)


def median_event_ms(fn, times: int) -> tuple:
    """``times`` calls of ``fn``, each between two CUDA events; returns
    (the per-call ms list, the calls' results)."""
    ms, outs = [], []
    for _ in range(times):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(fn())
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return ms, outs


def step_breakdown(params, opt, batch, cfg, ctx) -> None:
    """One more training step, taken apart: the forward (``loss_fn``), the
    backward and the AdamW update between CUDA events, under
    ``torch.profiler``, whose kernels are summed by kind (the flash
    kernel, cuBLAS GEMMs, other aten kernels). Prints one
    ``{"train_step_breakdown": ...}`` line; reported, not gated."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig, apply_updates

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        ev[0].record()
        total, _ = T.loss_fn(params, cfg, batch, ctx=ctx)
        ev[1].record()
        total.backward()
        ev[2].record()
        grads = {n: p.grad for n, p in params.named_parameters()}
        apply_updates(params, grads, opt, AdamWConfig(lr=1e-4))
        ev[3].record()
        torch.cuda.synchronize()
    params.zero_grad(set_to_none=True)
    del grads, total
    by_kind, by_name = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("flash kernel" if "flash_tc_kernel" in e.name else
                "GEMMs (cuBLAS)" if any(w in e.name for w in (
                    "nvjet", "gemm", "cutlass", "xmma")) else
                "other aten kernels")
        for table, key in ((by_kind, kind), (by_name, e.name[:80])):
            n, t = table.get(key, (0, 0.0))
            table[key] = (n + 1, t + e.device_time_total / 1e3)
    parts = dict(zip(("forward_ms", "backward_ms", "adamw_ms"),
                     (ev[i].elapsed_time(ev[i + 1]) for i in range(3))))
    print(json.dumps({
        "train_step_breakdown": cfg.name, **parts,
        "step_ms": sum(parts.values()), "params": len(opt.m),
        "profiled_kernel_ms": sum(t for _, t in by_kind.values()),
        "by_kind": {k: {"launches": n, "ms": t}
                    for k, (n, t) in by_kind.items()},
        "top_kernels": [{"name": k, "launches": n, "ms": t}
                        for k, (n, t) in sorted(by_name.items(),
                                                key=lambda kv: -kv[1][1])
                        [:12]]}), flush=True)


def hubert_phase() -> dict:
    """Phase 21 (module docstring): HuBERT-xLarge trained at published
    widths and full depth on a fixed batch of stub frame embeddings, the
    ``cuda`` step held to the ``torch`` backend's; then the hd-80 flash
    instance timed at the step's attention shape. Returns the ``hd80``
    part of the ``kernels`` line's flash entry."""
    import dataclasses

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import (KERNELS, flash_attention,
                                     flash_attention_plain)
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.train.optimizer import (AdamWConfig, global_norm,
                                             init_state)
    from repro_torch.train.trainer import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    HELD.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(HUBERT_ARCH)
    B, L = 8, 512  # 512 frames of 20 ms: a 10.2 s utterance
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 110)
    batch = {"embeds": 0.1 * torch.randn((B, L, cfg.d_model), generator=gen,
                                         device="cuda"),
             "labels": torch.randint(0, cfg.vocab_size, (B, L), generator=gen,
                                     device="cuda")}
    torch.cuda.synchronize()
    print(f"hubert: {cfg.name} at published widths and full depth "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of hd {cfg.hd}, d_ff {cfg.d_ff}, {cfg.vocab_size} labels, "
          f"causal={cfg.causal}); {n_params / 1e9:.3f} B f32 parameters made "
          f"on the card in {time.perf_counter() - t0:.1f} s; batch {B} x {L} "
          "frames of stub embeddings", flush=True)
    ctx = ExecutionContext(target=H100, backend="cuda")
    ref_ctx = ExecutionContext(target=H100, backend="torch")
    allowance = logit_allowance(cfg.n_layers)
    # the same weights and batch through both backends: logits, loss, and
    # the gradient's global norm (one aten backward each)
    with torch.inference_mode():
        a, _, _ = T.forward(params, cfg, embeds=batch["embeds"], ctx=ctx)
        b, _, _ = T.forward(params, cfg, embeds=batch["embeds"],
                            ctx=ref_ctx)
    err, allowed = (a - b).abs().max().item(), allowance(b)
    row = {"hubert_forward": [B, L], "logits_shape": list(a.shape),
           "max_abs_err": err, "allowed": allowed,
           "argmax_agreement": (a.argmax(-1) == b.argmax(-1)).float().mean()
           .item()}
    if (a.shape != (B, L, cfg.padded_vocab) or not torch.isfinite(a).all()
            or not err <= allowed):
        fail(f"hubert: cuda vs torch logits {tuple(a.shape)}, error {err} "
             f"above {allowed}")
    del a, b
    loss_ref, _ = T.loss_fn(params, cfg, batch, ctx=ref_ctx)
    loss_ref.backward()
    gnorm_ref = global_norm(p.grad for p in params.parameters()).item()
    loss_ref = loss_ref.item()
    params.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    step = make_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
        TrainConfig(remat=False, ctx=ctx))
    opt = init_state(params)
    before = params.layers[0]["b0"].core.wq.detach().clone()
    losses, gnorms, step_ms = [], [], []
    with ops.record_dispatch() as log:
        zero_counts()
        ms, outs = median_event_ms(lambda: step(params, opt, batch)[2], 1)
    k = KERNELS["flash_attention"]
    launched, tc = k.launches, k.tensor_core_launches
    attn = [d for d in log if d.op == "attention"]
    off = [d for d in attn if d.chosen != "cuda"]
    step_ms += ms
    losses.append(outs[0]["loss"].item())
    gnorms.append(outs[0]["grad_norm"].item())
    ms, outs = median_event_ms(lambda: step(params, opt, batch)[2], 7)
    step_ms += ms
    losses += [o["loss"].item() for o in outs]
    gnorms += [o["grad_norm"].item() for o in outs]
    moved = (params.layers[0]["b0"].core.wq - before).abs().max().item()
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_step = statistics.median(step_ms[1:]) / 1e3
    tokens = B * L
    row.update(
        launches_first_step=launched, tensor_core_launches=tc,
        attention_decisions=len(attn), off_cuda=len(off),
        loss_cuda=losses[0], loss_torch=loss_ref,
        loss_abs_err=abs(losses[0] - loss_ref),
        grad_norm_cuda=gnorms[0], grad_norm_torch=gnorm_ref,
        grad_norm_rel_err=abs(gnorms[0] - gnorm_ref) / gnorm_ref,
        losses=losses, grad_norms=gnorms, step_ms=step_ms,
        step_ms_median_2_8=1e3 * t_step, frames_per_s=tokens / t_step,
        plain_product_share=6.0 * n_params * tokens / t_step
        / PEAK_BF16_FLOPS, params_b=n_params / 1e9,
        max_param_change=moved, max_memory_allocated_gb=peak, card=smi())
    print(json.dumps(row), flush=True)
    if launched != cfg.n_layers or tc != launched:
        fail(f"hubert: {launched} flash launches ({tc} on the tensor cores) "
             f"in a step's forward, expected {cfg.n_layers}")
    if not attn or off:
        fail(f"hubert: attention decisions off cuda: {off[:3]}")
    if not abs(losses[0] - loss_ref) <= allowed:
        fail(f"hubert: cuda loss {losses[0]} vs torch {loss_ref}, above "
             f"{allowed}")
    if not abs(gnorms[0] - gnorm_ref) <= 1e-2 * gnorm_ref:
        fail(f"hubert: grad norm {gnorms[0]} vs torch {gnorm_ref}")
    if (not all(map(math.isfinite, losses + gnorms)) or not moved > 0
            or not losses[-1] < losses[0]):
        fail(f"hubert: losses {losses}, grad norms {gnorms}, parameter "
             f"change {moved}: not trained")
    step_breakdown(params, opt, batch, cfg, ctx)
    del params, opt, batch, step
    torch.cuda.empty_cache()
    # the hd-80 instance at the step's attention shape, beside SDPA
    H, hd = cfg.n_heads, cfg.hd
    q, kk, v = (torch.randn((B, H, L, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(3))
    qf, kf, vf = (t.reshape(B * H, L, hd) for t in (q, kk, v))

    def kernel():
        return flash_attention(qf, kf, vf, causal=False)

    def library():
        return F.scaled_dot_product_attention(q, kk, v)

    zero_counts()
    got = kernel()
    torch.cuda.synchronize()
    if (KERNELS["flash_attention"].tensor_core_launches != 1
            or KERNELS["flash_attention"].launches != 1):
        fail("hubert: the hd-80 flash call was not one tensor-core launch")
    want = flash_attention_plain(qf, kf, vf, False)
    kerr, kallowed = rel_err(got, want)
    if not kerr <= kallowed:
        fail(f"hubert: hd-80 flash error {kerr} above {kallowed}")
    flops = 4.0 * B * H * L * L * hd
    nbytes = 4 * q.numel() * 2
    bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    hd80 = {"instance": "(80, 64, 1)", "shape": f"{cfg.name} step: B {B}, "
            f"H {H}, L {L}, hd {hd}, bf16, non-causal",
            "launches_per_forward": cfg.n_layers,
            "max_abs_err": kerr, "allowed": kallowed,
            "ms": median_ms(kernel, 2, 10),
            "ms_per_launch": per_launch_ms(kernel),
            "device_ms_per_call": graph_ms_per_call(kernel),
            "plain_ms": median_ms(lambda: flash_attention_plain(
                qf, kf, vf, False), 1, 3),
            "library_ms": median_ms(library, 2, 10),
            "library_ms_per_launch": per_launch_ms(library),
            "library_device_ms_per_call": graph_ms_per_call(library),
            "bound_ms": bms, "bound_by": by}
    print(json.dumps({"kernel_shape": "flash_attention", "phase": "hubert",
                      **hd80}), flush=True)
    del q, kk, v, qf, kf, vf, got, want
    torch.cuda.empty_cache()
    print(json.dumps({"hubert_phase_seconds": time.perf_counter() - t_phase,
                      "max_memory_allocated_gb": peak}), flush=True)
    return hd80


def lm_train_phase() -> None:
    """Phase 22 (module docstring): Qwen2.5-3B at published widths cut to
    8 layers, trained 8 steps through ``Trainer`` on ``SyntheticSource``
    batches with the chunked loss; then a checkpoint and resume of the
    smoke config through ``repro_torch.launch.train.main``."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    B, L, steps = 4, 512, 8
    ctx = ExecutionContext(target=H100, backend="cuda")
    ref_ctx = ExecutionContext(target=H100, backend="torch")
    trainer = Trainer(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps),
        TrainConfig(steps=steps, loss_chunks=8, log_every=0, ctx=ctx,
                    seed=SEED),
        DataConfig(batch_size=B, seq_len=L, vocab_size=cfg.vocab_size,
                   seed=SEED))
    trainer.init(SEED)
    n_params = sum(p.numel() for p in trainer.params.parameters())
    print(f"train: {cfg.name} at published widths (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.padded_vocab}) cut to {cfg.n_layers} "
          f"layers; {n_params / 1e9:.3f} B f32 parameters", flush=True)
    tokens = torch.as_tensor(trainer.source.batch(0)["tokens"], device="cuda")
    allowance = logit_allowance(cfg.n_layers)
    with torch.inference_mode():
        a, _, _ = T.forward(trainer.params, cfg, tokens=tokens, ctx=ctx)
        b, _, _ = T.forward(trainer.params, cfg, tokens=tokens, ctx=ref_ctx)
        err, allowed = (a - b).abs().max().item(), allowance(b)
        del a, b
        loss_ref, _ = T.loss_fn(trainer.params, cfg, {"tokens": tokens},
                                ctx=ref_ctx, loss_chunks=8)
    torch.cuda.empty_cache()
    with ops.record_dispatch() as log:
        zero_counts()
        hist = trainer.run()
    k = KERNELS["flash_attention"]
    attn = [d for d in log if d.op == "attention"]
    off = [d for d in attn if d.chosen != "cuda"]
    row = {"train_lm": cfg.name, "layers": cfg.n_layers, "batch": [B, L],
           "reduced": f"n_layers 36 -> {cfg.n_layers}: the full depth's "
                      "3.09 B parameters need 49 GB of f32 weights, "
                      "gradients and AdamW moments before any activation",
           "params_b": n_params / 1e9, "loss_chunks": 8,
           "losses": hist["loss"], "step_s": hist["step_time"],
           "step_ms_median": 1e3 * statistics.median(hist["step_time"][1:]),
           "tokens_per_s": B * L / statistics.median(hist["step_time"][1:]),
           "skipped_steps": trainer.skipped_steps,
           "flash_launches": k.launches, "tensor_core_launches":
           k.tensor_core_launches, "attention_decisions": len(attn),
           "off_cuda": len(off), "logits_max_abs_err": err,
           "allowed": allowed, "first_loss_torch": loss_ref.item(),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(row), flush=True)
    if not err <= allowed:
        fail(f"train: cuda vs torch logits error {err} above {allowed}")
    if len(hist["loss"]) != steps or not all(map(math.isfinite,
                                                 hist["loss"])):
        fail(f"train: losses {hist['loss']}, {trainer.skipped_steps} "
             "skipped")
    if not abs(hist["loss"][0] - loss_ref.item()) <= allowed:
        fail(f"train: first loss {hist['loss'][0]} vs torch "
             f"{loss_ref.item()}, above {allowed}")
    if (k.launches != cfg.n_layers * steps or k.tensor_core_launches
            != k.launches or not attn or off):
        fail(f"train: {k.launches} flash launches ({k.tensor_core_launches} "
             f"on the tensor cores, {len(off)} decisions off cuda), "
             f"expected {cfg.n_layers} a step's forward")
    del trainer, tokens
    torch.cuda.empty_cache()
    # checkpoint and resume on the smoke config, through the launcher
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        argv = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "6",
                "--ckpt-every", "3", "--ckpt-dir", tmp]
        whole = launch_train.main(argv)
        shutil.rmtree(os.path.join(tmp, "step_00000006"))
        resumed = launch_train.main(argv)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rel = [abs(x - y) / abs(y) for x, y in zip(resumed["loss"],
                                               whole["loss"][3:])]
    print(json.dumps({"train_resume": TRAIN_ARCH + " smoke",
                      "uninterrupted": whole["loss"],
                      "resumed_steps": resumed["step"],
                      "resumed": resumed["loss"], "max_rel_err": max(rel),
                      "phase_seconds": time.perf_counter() - t_phase}),
          flush=True)
    if resumed["step"] != [3, 4, 5] or not max(rel) <= 1e-3:
        fail(f"train: resumed steps {resumed['step']} losses "
             f"{resumed['loss']} vs {whole['loss'][3:]}")
    torch.cuda.empty_cache()


XLSTM_ARCH = "xlstm_1_3b"
XLSTM_LONG_PROMPT = 600  # three mLSTM chunks of 256, the last ragged


def replay_kernels(eng, cache, tok, idx, repeats: int = 5) -> dict:
    """``repeats`` replays of ``eng``'s decode step on ``cache`` (advanced
    in place) under ``torch.profiler``: kernels and kernel ms a replay,
    and those of the copy kernels (names holding "copy": ``.contiguous()``,
    ``torch.cat``, casts) with their share of the kernel time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    run = eng.decode_graphs(cache)
    key = run.load(tok, idx)
    run.eager(key)  # the warm-up, on the runner's stream
    run.capture(key)
    run.replay(key)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(repeats):
            run.replay(key)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.device_time_total / 1e3)
    copies = {k: v for k, v in by_name.items() if "copy" in k.lower()}
    total = sum(t for _, t in by_name.values())
    copy_ms = sum(t for _, t in copies.values())
    return {"kernels_per_replay": sum(n for n, _ in by_name.values())
            / repeats,
            "kernel_ms_per_replay": total / repeats,
            "copy_kernels_per_replay": sum(n for n, _ in copies.values())
            / repeats,
            "copy_ms_per_replay": copy_ms / repeats,
            "copy_share": copy_ms / total if total else "not measured",
            "top_copies": [{"name": k[:90], "per_replay": n / repeats,
                            "ms_per_replay": t / repeats}
                           for k, (n, t) in sorted(copies.items(),
                                                   key=lambda kv: -kv[1][1])
                           [:4]]}


def fused_phase(split: dict) -> None:
    """Phase 23 (module docstring): Qwen2.5-3B with the fused K/V leaf
    through the contiguous engine, its tokens against phase 7's split
    contiguous serve (``split``: its requests and row), then one decode
    step of each layout eagerly and replayed, with the copy kernels of a
    replay."""
    import dataclasses

    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.serving import Engine
    from repro_torch.serving.graphs import check_replay, probe_inputs

    t_phase = time.perf_counter()
    HELD.clear()
    torch.cuda.empty_cache()
    cfg = get_config(ARCH)
    fused = dataclasses.replace(cfg, fused_kv_cache=True)
    master = T.init_params(cfg, seed=SEED, device="cuda")  # phase 7's
    params = T.compute_params(master, cfg)
    del master
    _, prompts, _ = serving_prompts(cfg.vocab_size)
    ctx = ExecutionContext(target=H100, backend="cuda")
    eng = Engine(fused, params, max_len=512, batch_size=4, ctx=ctx)
    cache = T.init_cache(fused, 1, 8, device="meta")
    leaves = {n: list(t.shape) for n, t in cache["b0"].items()}
    print(f"fused: {cfg.name} with fused_kv_cache: a layer's leaves at B 1, "
          f"max_len 8: {leaves}; paged {eng.paged}", flush=True)
    if eng.paged or sorted(cache["b0"]) != ["kv"]:
        fail("fused: the engine took the paged pool or the cache has no "
             "kv leaf")
    with ops.record_dispatch() as log:
        reqs, row = serve_and_gate("fused contiguous", eng, prompts)
    attn = [d for d in log if d.op == "attention"]
    off = [d for d in attn if d.chosen != "cuda"]
    differ = [i for i, (a, b) in enumerate(zip(reqs, split["contiguous"]))
              if not np.array_equal(a.out_tokens, b.out_tokens)]
    row.update(attention_decisions=len(attn), off_cuda=len(off),
               requests_unequal_to_split=differ)
    print(json.dumps(row), flush=True)
    if not attn or off:
        fail(f"fused: attention decisions chosen off cuda: {off[:3]}")
    if differ:
        fail(f"fused: requests {differ} generated other tokens than phase "
             "7's split contiguous serve")
    del eng
    steps = {}
    for name, c in (("split", cfg), ("fused", fused)):
        eng = Engine(c, params, max_len=512, batch_size=4, ctx=ctx,
                     paged=False)
        with torch.inference_mode():
            state = probe_inputs(eng, seed=SEED + 80)
            res = check_replay(eng, *state, profile=True)
            copies = replay_kernels(eng, *state[:3])
        steps[name] = {
            "logits_equal": res["logits_equal"],
            "leaves_equal": res["leaves_equal"],
            "written_leaves": res["written_leaves"],
            "replay_device_ms": 1e3 * res["replay_device_s"],
            "replay_host_ms": 1e3 * res["replay_host_s"],
            "eager_step_device_ms": 1e3 * res["eager_device_s"],
            "capture_s": res["capture_s"],
            "profiled_replay": res["profiled_replay"], **copies}
        if not (res["logits_equal"] and res["leaves_equal"]
                and res["finite"] and res["written_leaves"]):
            fail(f"fused: the {name} layout's replayed decode step differs "
                 f"from the eager one (unequal leaves "
                 f"{res['unequal_leaves'][:4]})")
        del eng, state
        torch.cuda.empty_cache()
    f, sp = steps["fused"], steps["split"]
    print(json.dumps({
        "fused_step": cfg.name, "batch": 4, "max_len": 512, **steps,
        "replay_device_ms_fused_over_split":
            f["replay_device_ms"] / sp["replay_device_ms"],
        "copy_ms_fused_minus_split":
            f["copy_ms_per_replay"] - sp["copy_ms_per_replay"],
        "serve_replay_device_ms_median": {
            "fused": row["replay_device_ms_median"],
            "split": split["contiguous_stats"]["replay_device_ms_median"]},
        "serve_tok_per_s": {"fused": row["tok_per_s"],
                            "split": split["contiguous_stats"]["tok_per_s"]},
        "card": smi(), "phase_seconds": time.perf_counter() - t_phase}),
        flush=True)
    del params
    torch.cuda.empty_cache()


def xlstm_phase() -> None:
    """Phase 24 (module docstring): xLSTM-1.3B at published widths and full
    depth: block checks on one layer's weights, the serve with every token
    held against the cache-less forward, the replay check and the step's
    floors."""
    import dataclasses

    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as X
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.serving import Engine
    from repro_torch.serving.graphs import check_replay, probe_inputs

    t_phase = time.perf_counter()
    HELD.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(XLSTM_ARCH)
    H, hd, D = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.d_model
    t0 = time.perf_counter()
    master = T.init_params(cfg, seed=SEED, device="cuda")
    n_params = sum(t.numel() for t in master.parameters())
    params = T.compute_params(master, cfg)  # the f32 serve keeps the master
    torch.cuda.synchronize()
    print(f"xlstm: {cfg.name} at published widths and full depth "
          f"({cfg.n_layers} layers: {cfg.repeats} x {cfg.pattern}, d_model "
          f"{D}, {H} heads of hd {hd}, chunk {cfg.chunk_size}, vocab "
          f"{cfg.padded_vocab}); {n_params:,} parameters (param_count "
          f"{cfg.param_count():,}) made on the card in "
          f"{time.perf_counter() - t0:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    # -- block checks on layer 0's weights, three chunks, the last ragged
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 110)
    L = XLSTM_LONG_PROMPT
    x = torch.randn((1, L, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    mcore, score = params.layers[0]["b0"].core, params.layers[0]["b1"].core

    def block_check(what, got, want):
        err = (got.float() - want.float()).abs().max().item()
        allowed = TOL[torch.bfloat16] * max(1.0, want.float().abs().max()
                                            .item())
        print(json.dumps({"xlstm_block_check": what, "shape": list(
            got.shape), "max_abs_err": err, "allowed": allowed}), flush=True)
        if not (torch.isfinite(got).all() and err <= allowed):
            fail(f"xlstm {what}: error {err} above {allowed}")

    with torch.inference_mode():
        whole, _ = X.mlstm_block(mcore, x, cfg)
        block_check("mlstm_block vs mlstm_block_ref at L 600", whole,
                    X.mlstm_block_ref(mcore, x, cfg))
        a, st = X.mlstm_block(mcore, x[:, :300], cfg,
                              X.init_mlstm_state(cfg, 1, device="cuda"))
        b, _ = X.mlstm_block(mcore, x[:, 300:], cfg, st)
        block_check("mlstm_block 300 + 300 from the carried state vs 600",
                    torch.cat([a, b], dim=1), whole)
        got, _ = X.slstm_block(score, x, cfg)
        st, outs = X.init_slstm_state(cfg, 1, device="cuda"), []
        for t in range(L):
            o, st = X.slstm_decode_step(score, x[:, t:t + 1], cfg, st)
            outs.append(o)
        block_check("slstm_block vs 600 slstm_decode_steps", got,
                    torch.cat(outs, dim=1))
    del x, whole, a, b, got, outs

    # -- the serve: phase 7's 8 prompts over this vocab and one of 600, in
    # the published bf16 compute, then in f32 compute on the f32 weights
    _, prompts, _ = serving_prompts(cfg.vocab_size)
    prompts = list(prompts) + [np.random.default_rng(SEED + 111).integers(
        0, cfg.vocab_size, size=L).astype(np.int32)]
    ctx = ExecutionContext(target=H100, backend="cuda")
    ref_ctx = ExecutionContext(target=H100, backend="torch")
    eng = Engine(cfg, params, max_len=L + 40, batch_size=4, ctx=ctx)
    if eng.paged or eng.prefill_bucket != 1:
        fail("xlstm: the engine must take the contiguous cache and "
             "exact-length prefill")
    with ops.record_dispatch() as log:
        reqs, row = serve_and_gate("xlstm contiguous", eng, prompts)
    launched = {n: k.launches for n, k in KERNELS.items()}
    row.update(model=cfg.name, dispatch_decisions=len(log),
               kernel_launches=launched)
    print(json.dumps(row), flush=True)
    if any(launched.values()):
        fail(f"xlstm: its blocks call no kernel, but the serve launched "
             f"{launched}")
    allowance = logit_allowance(cfg.n_layers)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    eng32 = Engine(cfg32, master, max_len=L + 40, batch_size=4, ctx=ctx)
    reqs32, row32 = serve_and_gate("xlstm contiguous f32", eng32, prompts)
    del eng32
    print(json.dumps(row32), flush=True)
    # f32: the recurrent decode and the chunked forward differ by f32
    # rounding alone, every token within the allowance (module docstring)
    check32 = decode_check("xlstm contiguous f32", reqs32, cfg32, master,
                           ref_ctx, allowance)
    # bf16: within the allowance or the bf16 forward's own noise
    check = decode_check("xlstm contiguous bf16", reqs, cfg, params,
                         ref_ctx, allowance, noise_chunk=16)
    del master

    # -- one decode step eagerly and replayed (phase 18's check)
    with torch.inference_mode():
        state = probe_inputs(eng, seed=SEED + 120)
        res = check_replay(eng, *state, profile=True)
    del eng, state
    sd = params.state_dict()
    weight_bytes = sum(t.numel() * t.element_size() for n, t in sd.items()
                       if n != "embed")
    row_state = T.init_cache(cfg, 1, 1, device="meta")
    state_bytes = sum(t.numel() * t.element_size()
                      for lv in row_state.values() for t in lv.values())
    print(json.dumps({
        "xlstm_step": cfg.name, "batch": 4,
        "logits_equal": res["logits_equal"],
        "leaves_equal": res["leaves_equal"],
        "written_leaves": res["written_leaves"],
        "replay_device_ms": 1e3 * res["replay_device_s"],
        "replay_host_ms": 1e3 * res["replay_host_s"],
        "eager_step_device_ms": 1e3 * res["eager_device_s"],
        "eager_step_host_ms": 1e3 * res["eager_host_s"],
        "capture_s": res["capture_s"],
        "kernels_per_replay": res["profiled_replay"]["profiler_kernels"],
        "profiled_replay": res["profiled_replay"],
        "weight_gb": weight_bytes / 1e9,
        "weight_stream_floor_ms": 1e3 * weight_bytes / PEAK_BYTES,
        "state_mb_per_row": state_bytes / 1e6,
        "state_read_and_written_floor_ms":
            1e3 * 2 * 4 * state_bytes / PEAK_BYTES,
        "serve_replay_device_ms_median": row["replay_device_ms_median"],
        "serve_decode_step_ms_median": row["decode_step_ms_median"],
        "serve_prefill_ms_median": row["prefill_ms_median"],
        "serve_tok_per_s": row["tok_per_s"],
        "decode_check_exact_argmax": check["exact_argmax"],
        "decode_check_requests_beyond_the_allowance":
            check["requests_beyond_the_allowance"],
        "f32_decode_check_max_gap": check32["max_gap_to_row_max"],
        "f32_serve_replay_device_ms_median": row32["replay_device_ms_median"],
        "f32_serve_tok_per_s": row32["tok_per_s"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": smi(), "phase_seconds": time.perf_counter() - t_phase}),
        flush=True)
    if not (res["logits_equal"] and res["leaves_equal"] and res["finite"]
            and res["written_leaves"]):
        fail(f"xlstm: a replayed decode step differs from the eager one "
             f"(unequal leaves {res['unequal_leaves'][:4]})")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 25: fault handling (repro_torch.resilience) at published widths.
# ---------------------------------------------------------------------------

FAULT_SITES = ("admit/launch", "admit/numeric", "admit/oom", "decode/numeric",
               "decode/pool", "finish/pool")
CHAOS_KINDS = ("launch", "dma", "numeric", "oom", "pool")
# robust_bench's floors at its DEFAULT_SPEC (rate 0.05, seed 0)
COMPLETION_FLOOR, TOK_S_FLOOR = 0.99, 0.4


def _decisions(fn):
    """``fn()`` inside ``ops.record_dispatch()``, synchronized; returns its
    result and the decisions it published."""
    from repro_torch import ops

    with ops.record_dispatch() as log:
        out = fn()
    torch.cuda.synchronize()
    return out, list(log)


def conv_fault_checks(gen: torch.Generator) -> list:
    """Phase 25 (a), the conv path's degradation priced (module
    docstring). Returns one row a layer."""
    from repro_torch import ops
    from repro_torch.core.conv_model import resnet50_layers
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.resilience import errors as flt
    from repro_torch.resilience import faults as fj

    ctx = ExecutionContext(target=H100, backend="cuda")
    im2 = ExecutionContext(target=H100, backend="im2col")

    def once(kind, op="conv2d", cap=1):
        return fj.FaultCampaign(seed=0, rate=1.0, kinds=(kind,), ops=(op,),
                                max_faults=cap)

    rows = []
    for i, (name, s) in enumerate(resnet50_layers(BATCH).items()):
        x, w = layer_inputs(gen, i, s)
        stride = (s.sh, s.sw)
        kw = {"stride": stride, "out_dtype": torch.float32}
        primary, im2col = (ops.explain("conv2d", c, dtype=x.dtype,
                                       spec_args=(x, w), spec_kw=kw)
                           for c in (ctx, im2))

        def conv(c=ctx):
            return ops.conv2d(x, w, stride, ctx=c, out_dtype=torch.float32)

        clean, want = conv(), conv(im2)
        # a rate-1.0 launch fault: quarantined, degraded to Im2Col, priced
        camp = once("launch")
        with fj.activate(camp):
            got, log = _decisions(conv)
        camp.verify_accounted()
        d = log[0] if len(log) == 1 else None
        if (d is None or not d.degraded or d.fault != "KernelLaunchError"
                or d.chosen != "im2col" or d.requested != "cuda"
                or camp.summary()["resolutions"] != {"degraded": 1}):
            fail(f"faults {name}: a launch fault gave decisions {log}, "
                 f"{camp.summary()}")
        if d.measured_words != im2col.measured_words:
            fail(f"faults {name}: degraded words {d.measured_words}, Im2Col's "
                 f"{im2col.measured_words}")
        if not torch.equal(got, want):
            fail(f"faults {name}: the degraded conv is not Im2Col's output")
        (q,) = ops.quarantined().values()
        # the calls the quarantine still serves on Im2Col, timed (one
        # warm-up), then the next call probes cuda again
        under = q["probe_in"] - 1
        degraded_ms, log = _decisions(lambda: median_ms(conv, 1, under - 1))
        if len(log) != under or not all(
                e.degraded and e.chosen == "im2col" for e in log):
            fail(f"faults {name}: under quarantine {[e.chosen for e in log]}")
        back, log = _decisions(conv)
        if (len(log) != 1 or log[0].chosen != "cuda" or log[0].degraded
                or ops.quarantined() or not torch.equal(back, clean)):
            fail(f"faults {name}: the probe back gave {log}, quarantine "
                 f"{ops.quarantined()}, bit-equal "
                 f"{torch.equal(back, clean)}")
        primary_ms, log = _decisions(lambda: median_ms(conv))
        if any(e.degraded or e.chosen != "cuda" for e in log):
            fail(f"faults {name}: the primary after the probe gave {log}")
        row = {"faults_conv": name, "fault": d.fault, "chosen": d.chosen,
               "primary_words": primary.measured_words,
               "degraded_words": d.measured_words,
               "words_ratio": d.measured_words / primary.measured_words,
               "primary_bound_ratio": primary.bound_ratio,
               "degraded_bound_ratio": d.bound_ratio,
               "degraded_ms": degraded_ms, "primary_ms": primary_ms,
               "ms_ratio": degraded_ms / primary_ms,
               "calls_on_im2col": 1 + under,
               "back_on_cuda_at_call_after_the_fault": under + 1}
        if i == 0:
            # a numeric fault: the kernel runs, its NaN is detected, the
            # call degrades
            camp = once("numeric")
            with fj.activate(camp):
                got, log = _decisions(conv)
            camp.verify_accounted()
            inj = camp.injections[0]
            if (len(log) != 1 or log[0].chosen != "im2col"
                    or log[0].fault != "NumericFault"
                    or inj.resolution != "degraded"
                    or inj.detail != {"leaf": 0}
                    or not torch.equal(got, want)):
                fail(f"faults {name}: a numeric fault gave {log}, {inj}")
            ops.clear_quarantine()
            # a device fault: fatal, propagates, nothing quarantined
            camp = once("device")
            try:
                with fj.activate(camp):
                    conv()
                fail(f"faults {name}: DeviceLost did not propagate")
            except flt.DeviceLost:
                pass
            if (camp.injections[0].resolution != "fatal"
                    or ops.quarantined()):
                fail(f"faults {name}: a device fault left {camp.summary()}, "
                     f"quarantine {ops.quarantined()}")
            row["numeric_fault"] = "degraded to im2col, bit-equal"
            row["device_fault"] = "DeviceLost propagated, fatal"
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, w, clean, want, got, back
        torch.cuda.empty_cache()

    # the matmul (no degrade_to): a transient fault retries in place on
    # cuda, never torch; a persistent one raises after MAX_RUNTIME_ATTEMPTS
    from repro_torch.kernels import KERNELS

    gen.manual_seed(SEED + 40)
    a = torch.randn((2048, 2048), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = (torch.randn((2048, 2048), generator=gen, device="cuda")
         * 2048 ** -0.5).to(torch.bfloat16)
    clean = ops.matmul(a, b, ctx=ctx)
    for kind in ("launch", "dma", "numeric"):
        camp = once(kind, "matmul")
        with fj.activate(camp):
            got, log = _decisions(lambda: ops.matmul(a, b, ctx=ctx))
        camp.verify_accounted()
        if ([(e.chosen, e.degraded) for e in log] != [("cuda", False)]
                or camp.summary()["resolutions"] != {"retried": 1}
                or ops.quarantined() or not torch.equal(got, clean)):
            fail(f"faults matmul {kind}: {log}, {camp.summary()}, "
                 f"quarantine {ops.quarantined()}")
    camp = fj.FaultCampaign(seed=0, rate=1.0, kinds=("launch",),
                            ops=("matmul",))
    before = KERNELS["matmul"].launches
    try:
        with fj.activate(camp):
            ops.matmul(a, b, ctx=ctx)
        fail("faults matmul: a persistent launch fault did not raise")
    except flt.KernelLaunchError:
        pass
    if (camp.draws != ops.MAX_RUNTIME_ATTEMPTS
            or KERNELS["matmul"].launches != before or ops.quarantined()):
        fail(f"faults matmul: persistent fault after {camp.draws} attempts")
    print(json.dumps({"faults_matmul": "2048^3 bf16", "transient":
                      {"launch": "retried", "dma": "retried",
                       "numeric": "retried"}, "chosen": "cuda",
                      "bit_equal": True, "persistent_raises_after":
                      camp.draws}), flush=True)
    return rows


def kv_difference(old, old_tables, lengths, new, new_tables, bs: int) -> dict:
    """Every row live across a pool rebuild (a nonzero row of
    ``old_tables``), its first ``lengths[s]`` positions of K and V in every
    layer, gathered through its old table from the ``old`` pool and through
    its new table from the ``new`` one: the largest difference and whether
    they are bit-equal."""
    import numpy as np

    worst, equal, rows, positions = 0.0, True, 0, 0
    for s in range(old_tables.shape[0]):
        if not old_tables[s].any():
            continue
        n = int(lengths[s])
        nb = -(-n // bs)
        rows += 1
        positions += n
        dev = next(iter(old.values()))["kp"].device
        ids = [torch.as_tensor(t[s, :nb].astype(np.int64), device=dev)
               for t in (old_tables, new_tables)]
        for u in old:
            for leaf in ("kp", "vp"):
                a, b = (c[u][leaf][:, i] for c, i in ((old, ids[0]),
                                                      (new, ids[1])))
                R, _, KV, _, hd = a.shape
                a, b = (t.transpose(1, 2).reshape(R, KV, nb * bs, hd)
                        [:, :, :n] for t in (a, b))
                worst = max(worst, (a.float() - b.float()).abs().max().item())
                equal = equal and torch.equal(a, b)
    return {"rows": rows, "positions": positions, "max_abs_diff": worst,
            "bit_equal": equal}


def rebuild_probed_engine(**kw):
    """An ``Engine`` whose decode runner measures each pool rebuild
    (``kv_difference`` of the old pool, which the allocator corruption
    left intact, against the rebuilt one, at the first step after it, into
    ``engine.kv_diffs``) and which keeps every prefill's tokens
    (``engine.prefills``: a re-prefill's run past its request's prompt)."""
    import numpy as np

    from repro_torch.serving import Engine
    from repro_torch.serving.graphs import DecodeGraphs

    class Probe(DecodeGraphs):
        def __init__(self, engine, cache):
            super().__init__(engine._decode_forward, cache,
                             engine.batch_size, engine.device)
            self.engine, self.last, self.pending = engine, None, None

        def load(self, tok, idx, tables=None, width=None):
            key = super().load(tok, idx, tables, width)
            if self.pending is not None:
                old, old_tables, lengths = self.pending
                self.pending = None
                diff = kv_difference(old, old_tables, lengths, self.cache,
                                     tables, self.engine.block_size)
                if diff["rows"]:  # a rebuild with no live row copies none
                    self.engine.kv_diffs.append(diff)
            if tables is not None:
                self.last = (tables, np.array(idx))
            return key

        def reset(self, cache):
            # a rebuild at the top of a round: every live row was active at
            # the last step, so it has written its index + 1 positions
            if self.last is not None and self.pending is None:
                tables, idx = self.last
                self.pending = (self.cache, tables.copy(), idx + 1)
            super().reset(cache)

    class ProbedEngine(Engine):
        def __init__(self, **kw_):
            super().__init__(**kw_)
            self.kv_diffs, self.prefills = [], []

        def decode_graphs(self, cache):
            return Probe(self, cache)

        def _prefill(self, tokens, mask, last):
            self.prefills.append(np.array(tokens[0, :int(mask.sum())]))
            return super()._prefill(tokens, mask, last)

    return ProbedEngine(**kw)


def serving_fault_checks() -> dict:
    """Phase 25 (b), the serving campaign (module docstring). Returns the
    phase's summary."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.resilience import faults as fj
    from repro_torch.serving import Request

    cfg = get_config(ARCH)
    master = T.init_params(cfg, seed=SEED, device="cuda")
    params = T.compute_params(master, cfg)
    del master
    _, prompts, _ = serving_prompts(cfg.vocab_size)
    ctx = ExecutionContext(target=H100, backend="cuda")
    ref_ctx = ExecutionContext(target=H100, backend="torch")
    allowance = logit_allowance(cfg.n_layers)

    def serve(paged, camp):
        eng = rebuild_probed_engine(cfg=cfg, params=params, max_len=512,
                                    batch_size=4, ctx=ctx, block_size=16,
                                    paged=paged)
        reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
        scope = (fj.activate(camp) if camp is not None
                 else contextlib.nullcontext())
        torch.cuda.synchronize()
        with ops.record_dispatch() as log, scope:
            t0 = time.perf_counter()
            eng.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        off = [d for d in log if d.degraded or d.chosen != "cuda"]
        if off or ops.quarantined():
            fail(f"faults serve: decisions {off[:3]} off cuda or degraded, "
                 f"quarantine {ops.quarantined()}")
        return eng, reqs, wall

    def clean_serve(paged, first=None):
        """A fault-free serve: every request "length" with 32 tokens, and
        the tokens of ``first`` (an earlier clean serve) bit for bit.
        Returns the requests and their tok/s."""
        _, reqs, wall = serve(paged, None)
        for r, f in zip(reqs, first or reqs):
            if (r.finish_reason != "length" or len(r.out_tokens) != 32
                    or not np.array_equal(r.out_tokens, f.out_tokens)):
                fail(f"faults {name}: a clean request finished "
                     f"{r.finish_reason!r} with {len(r.out_tokens)} tokens, "
                     "or not those of the first clean serve")
        return reqs, sum(len(r.out_tokens) for r in reqs) / wall

    summary = {"sites": set(), "seeds": {}, "kv_diffs": [], "held": 0,
               "throughput": {}}
    zero_counts()
    for name, paged in (("paged", True), ("contiguous", False)):
        clean, tok_s = clean_serve(paged)
        # tok/s at rate 0.05: three faulted serves (the same schedule) in
        # turns with three more clean ones, compared by their medians
        clean_tok_s, faulted_tok_s, completions = [tok_s], [], []
        runs = [(0, 0.2), (1, 0.2), (2, 0.2)] + [(0, 0.05)] * 3
        extra = 3
        while runs:
            seed, rate = runs.pop(0)
            camp = fj.FaultCampaign(seed=seed, rate=rate, kinds=CHAOS_KINDS)
            eng, reqs, wall = serve(paged, camp)
            camp.verify_accounted()
            st = eng.stats
            rebuilt = {i for i, r in enumerate(reqs) for p in eng.prefills
                       if len(p) > len(r.prompt)
                       and np.array_equal(p[:len(r.prompt)], r.prompt)}
            exact = all(d["bit_equal"] for d in eng.kv_diffs)
            held = []
            for i, (c, f) in enumerate(zip(clean, reqs)):
                if f.finish_reason is None:
                    fail(f"faults {name} seed {seed}: request {i} never "
                         "finished")
                if f.finish_reason == "error":
                    same = np.array_equal(f.out_tokens,
                                          c.out_tokens[:len(f.out_tokens)])
                else:
                    same = (f.finish_reason == c.finish_reason
                            and np.array_equal(f.out_tokens, c.out_tokens))
                if same:
                    continue
                if i in rebuilt and not exact:
                    held.append(f)  # the rebuild's K/V differ: below
                else:
                    why = ("live across a rebuild" if i in rebuilt
                           else "no rebuild")
                    fail(f"faults {name} seed {seed} rate {rate}: request "
                         f"{i} ({f.finish_reason}) is not the clean serve's "
                         f"({why})")
            if st.replayed_steps <= 0:
                fail(f"faults {name} seed {seed}: no graph replayed")
            done = [r for r in reqs if r.finish_reason not in ("error",
                                                                "timeout")]
            completion = len(done) / len(reqs)
            tok_s = sum(len(r.out_tokens) for r in reqs) / wall
            by_site = {}
            for inj in camp.injections:
                key = f"{inj.site}:{inj.kind}:{inj.resolution}"
                by_site[key] = by_site.get(key, 0) + 1
                summary["sites"].add(inj.site)
            row = {"faults_serve": name, "seed": seed, "rate": rate,
                   **camp.summary(), "by_site": by_site,
                   "completion": completion, "tok_per_s": tok_s,
                   "clean_tok_per_s": statistics.median(clean_tok_s),
                   "tok_s_over_clean": tok_s
                   / statistics.median(clean_tok_s),
                   "rebuilds": st.rebuilds, "graph_resets": st.graph_resets,
                   "captures": len(st.capture_s),
                   "replayed_steps": st.replayed_steps,
                   "warmup_steps": st.warmup_steps,
                   "kv_rebuild_diffs": eng.kv_diffs,
                   "requests_live_across_a_rebuild": sorted(rebuilt),
                   "held_to_the_allowance": len(held),
                   "finish_reasons": [r.finish_reason for r in reqs]}
            print(json.dumps(row), flush=True)
            summary["seeds"].setdefault(name, []).append([seed, rate])
            summary["kv_diffs"] += eng.kv_diffs
            summary["held"] += len(held)
            if rate == 0.05:
                completions.append(completion)
                faulted_tok_s.append(tok_s)
                clean_tok_s.append(clean_serve(paged, clean)[1])
            if held:
                decode_check(f"faults {name} seed {seed}", held, cfg, params,
                             ref_ctx, allowance)
            if (paged and not runs
                    and not set(FAULT_SITES) <= summary["sites"]):
                if extra > 20:
                    fail(f"faults: sites {sorted(summary['sites'])} after "
                         f"seeds up to {extra - 1}")
                runs.append((extra, 0.2))  # until every site has injected
                extra += 1
            del eng
        ratio = (statistics.median(faulted_tok_s)
                 / statistics.median(clean_tok_s))
        summary["throughput"][name] = row = {
            "faults_throughput": name, "rate": 0.05,
            "completion": completions, "clean_tok_per_s": clean_tok_s,
            "faulted_tok_per_s": faulted_tok_s, "median_ratio": ratio}
        print(json.dumps(row), flush=True)
        if min(completions) < COMPLETION_FLOOR or ratio < TOK_S_FLOOR:
            fail(f"faults {name} at rate 0.05: completion {completions}, "
                 f"tok/s {faulted_tok_s} against clean {clean_tok_s}")
        torch.cuda.empty_cache()
    launched = {n: KERNELS[n].launches for n in ("flash_attention",
                                                  "paged_decode")}
    if min(launched.values()) <= 0:
        fail(f"faults serve: launches {launched}")
    summary.update(launches=launched, sites=sorted(summary["sites"]))
    del params
    torch.cuda.empty_cache()
    return summary


def faults_phase(gen: torch.Generator) -> None:
    """Phase 25 (module docstring): fault handling at published widths;
    the launch counters to 0 before each half and read after it."""
    from repro_torch import ops
    from repro_torch.kernels import KERNELS
    from repro_torch.resilience import faults as fj

    HELD.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zero_counts()
    rows = conv_fault_checks(gen)
    conv_launches = {n: KERNELS[n].launches for n in ("conv2d", "matmul")}
    if min(conv_launches.values()) <= 0:
        fail(f"faults conv: launches {conv_launches}")
    serve = serving_fault_checks()
    ops.clear_quarantine()
    fj.install(None)
    if set(serve["sites"]) != set(FAULT_SITES):
        fail(f"faults: sites injected {serve['sites']}, not all of "
             f"{FAULT_SITES}")
    print(json.dumps({
        "faults_phase": "summary",
        "words_ratios": {r["faults_conv"]: r["words_ratio"] for r in rows},
        "ms_ratios": {r["faults_conv"]: r["ms_ratio"] for r in rows},
        "conv_launches": conv_launches, "serve_launches": serve["launches"],
        "seeds": serve["seeds"], "sites": serve["sites"],
        "rebuilds_measured": len(serve["kv_diffs"]),
        "rebuild_max_abs_kv_diff": max((d["max_abs_diff"]
                                        for d in serve["kv_diffs"]),
                                       default=None),
        "rebuilds_bit_equal": all(d["bit_equal"] for d in serve["kv_diffs"]),
        "requests_held_to_the_allowance": serve["held"],
        "tok_s_ratio_at_rate_0.05": {n: r["median_ratio"] for n, r in
                                     serve["throughput"].items()},
        "seconds": time.perf_counter() - t0}), flush=True)


# ---------------------------------------------------------------------------
# Phase 26: the paper's §4.2 distributed conv (repro_torch.distributed)
# ---------------------------------------------------------------------------

# the fig3 shapes of the reference's distributed bench, at P = 8: its LP
# grid and its two probe grids
DIST_LAYERS = ("conv1", "conv2_x")
DIST_P = 8
DIST_PROBES = ({"hO": 4, "wO": 2}, {"cI": 2, "hO": 2, "wO": 2})
# (halo, psum, comm, all-gather) words a device, bf16 input: the
# reference's counters on these shapes and grids (shape-only)
DIST_WORDS = {
    ("conv1", "lp"): (0, 0, 0, 69_431_250),
    ("conv1", "probe0"): (1_342_500, 0, 1_342_500, 70_644_000),
    ("conv1", "probe1"): (1_185_000, 215_296_000, 216_481_000, 94_195_136),
    ("conv2_x", "lp"): (0, 0, 0, 94_192_000),
    ("conv2_x", "probe0"): (2_944_000, 0, 2_944_000, 97_440_000),
    ("conv2_x", "probe1"): (1_920_000, 53_824_000, 55_744_000, 94_201_216),
}
# the combined Thm 2.2/2.3 bound a device at M = 2^20 words, P = 8
DIST_BOUND_2_20 = {"conv1": 2_018_848, "conv2_x": 2_606_848}
# (c): the process-group route, 4 gloo ranks sharing the card
GROUP_GRIDS = ({"hO": 2, "wO": 2}, {"cI": 2, "hO": 2})
GROUP_BATCH = 64
GROUP_RANKS = 4
GROUP_TIMEOUT = 300  # seconds for the ranks to finish


def dist_grids(s) -> list:
    """(tag, ParallelBlocking) of phase 26: the LP's grid at P = 8 (fatal
    unless it is the reference's {"N": 8}) and the two probes."""
    from repro_torch.core.parallel_tiling import (ParallelBlocking,
                                                  optimize_parallel_blocking)
    from repro_torch.distributed import DIST_AXES

    lp = optimize_parallel_blocking(s, DIST_P, restrict_axes=DIST_AXES)
    grid = {k: v for k, v in lp.grid.items() if v > 1}
    if grid != {"N": DIST_P}:
        fail(f"dist: the LP chose {grid} for {s}, the reference {{'N': 8}}: "
             "a parity fault")
    return [("lp", lp)] + [(f"probe{i}", ParallelBlocking.from_grid(s, g))
                           for i, g in enumerate(DIST_PROBES)]


def dist_shard_audit(name: str, geom, s, ctx) -> dict:
    """Phase 26 (b): phase 16's audit of one shard-local dispatch, on a
    window of the shard's exact shape: audited clean, launched as planned,
    the uncounted words only the window runs' overhang."""
    from repro_torch import ops
    from repro_torch.core.conv_model import ConvShape
    from repro_torch.kernels import KERNELS, conv2d_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b_cI = geom.cIp // geom.grid[1]
    xw = torch.randn((geom.bN, b_cI, geom.h_ext, geom.w_ext), generator=gen,
                     device="cuda").to(torch.bfloat16)
    wb = torch.randn((s.c_O, b_cI, s.h_F, s.w_F), generator=gen,
                     device="cuda").to(torch.bfloat16)
    stride = (s.sh, s.sw)
    d = ops.explain("conv2d", ctx, dtype=xw.dtype, spec_args=(xw, wb),
                    spec_kw={"stride": stride, "out_dtype": torch.float32},
                    audit=True)
    rep = d.audit_report
    if not rep.ok or d.audited != d.measured_words:
        fail(f"dist audit {name}: {rep.problems} {rep.hazards}")
    k = KERNELS["conv2d"]
    k.last_launch = None
    tc = k.tensor_core_launches
    y = ops.conv2d(xw, wb, stride, ctx=ctx, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err, allowed = rel_err(y, conv2d_plain(xw, wb, stride))
    if not err <= allowed:
        fail(f"dist audit {name}: the shard window's launch is {err} from "
             f"the plain version, allowed {allowed}")
    del y
    got, plan = k.last_launch, rep.launch
    want = {"grid": plan.grid, "block": plan.block, "smem": plan.smem_bytes,
            "cluster": plan.cluster}
    if got != want or k.tensor_core_launches != tc + 1:
        fail(f"dist audit {name}: launched {got} (tensor core: "
             f"{k.tensor_core_launches - tc}), the access plan says {want}")
    local = ConvShape(N=geom.bN, c_I=b_cI, c_O=s.c_O, h_O=geom.bh,
                      w_O=geom.bw, h_F=s.h_F, w_F=s.w_F, sh=s.sh, sw=s.sw)
    uncounted = {n: v for n, v in rep.uncounted.items() if v}
    over = uncounted.pop("input run overhang", 0.0)
    bound = overhang_bound(local, d.plan.tiles, 0.5, 8)
    if uncounted or rep.shortfall or not 0 <= over <= bound:
        fail(f"dist audit {name}: uncounted {uncounted}, shortfall "
             f"{rep.shortfall}, overhang {over} (at most {bound})")
    shard_ms = median_ms(lambda: ops.conv2d(xw, wb, stride, ctx=ctx,
                                            out_dtype=torch.float32))
    line = {"dist_audit": name, "window": list(xw.shape),
            "filter": list(wb.shape), "tiles": list(d.plan.tiles),
            "kernel": plan.kernel, "grid": list(got["grid"]),
            "block": list(got["block"]), "smem_bytes": got["smem"],
            "counted_words": rep.counted_words,
            "measured_words": d.measured_words,
            "issued_words": rep.issued_words, "overhang_words": over,
            "bound_ratio": d.bound_ratio, "hazards": len(rep.hazards),
            "max_abs_err_vs_plain": err, "allowed": allowed,
            "shard_conv_ms": shard_ms,
            "shard_conv_ms_x_P": shard_ms * DIST_P,
            "timing_note": "CUDA events, one shard's conv a call (phase 5's "
                           "median); x P: the kernels' share of a "
                           "distributed conv", "card": smi()}
    print(json.dumps(line), flush=True)
    return line


def dist_in_process(gen: torch.Generator, card: str) -> tuple:
    """Phase 26 (a) and (b) (module docstring): the counters set to 0 just
    before each distributed conv and read just after. Returns the total
    shard launches and the audits' count."""
    from repro_torch import distributed as td
    from repro_torch import ops
    from repro_torch.core.bounds import combined_parallel_bound
    from repro_torch.core.conv_model import BF16_ACC32, resnet50_layers
    from repro_torch.distributed import DistConvGeometry
    from repro_torch.kernels import KERNELS, conv2d_plain
    from repro_torch.launch import make_conv_mesh
    from repro_torch.plan import H100, HardwareTarget

    layers = resnet50_layers(BATCH)
    k = KERNELS["conv2d"]
    single_ctx = ops.ExecutionContext(target=H100, backend="cuda")
    shard_launches = audits = 0
    for name in DIST_LAYERS:
        i = list(layers).index(name)
        s = layers[name].with_precision(BF16_ACC32)
        x, w = layer_inputs(gen, i, s)
        stride = (s.sh, s.sw)
        ref = ops.conv2d(x, w, stride, ctx=single_ctx,
                         out_dtype=torch.float32)
        # the plain version on the same inputs, whole batch: the kernel's
        # single-device and shard launches are each held against it
        plain = conv2d_plain(x, w, stride)
        ref_err, ref_allowed = rel_err(ref, plain)
        if not ref_err <= ref_allowed:
            fail(f"dist {name}: the single-device cuda conv is {ref_err} "
                 f"from the plain version, allowed {ref_allowed}")
        torch.cuda.synchronize()
        bound_2_20 = combined_parallel_bound(s, DIST_P, 2.0 ** 20)
        if bound_2_20 != DIST_BOUND_2_20[name]:
            fail(f"dist {name}: bound at 2^20 {bound_2_20}, the reference's "
                 f"{DIST_BOUND_2_20[name]}")
        single_ms = median_ms(lambda: ops.conv2d(
            x, w, stride, ctx=single_ctx, out_dtype=torch.float32))
        for tag, pb in dist_grids(s):
            grid = {a: v for a, v in pb.grid.items() if v > 1}
            label = f"{name} {json.dumps(grid)}"
            geom = DistConvGeometry.from_shape(s, pb)
            halo_w, psum_w, comm_w, ag_w = DIST_WORDS[name, tag]
            runs = {}
            for kind, fn in (("halo", td.halo_conv),
                             ("allgather", td.allgather_conv)):
                mesh = make_conv_mesh(pb)
                ctx = ops.ExecutionContext(
                    target=HardwareTarget.from_mesh(mesh), backend="cuda")
                zero_counts()
                with ops.record_dispatch() as log:
                    if kind == "halo":
                        out = ops.conv2d_dist(x, w, stride, blocking=pb,
                                              mesh=mesh, ctx=ctx,
                                              out_dtype=torch.float32)
                    else:
                        out = fn(x, w, stride, blocking=pb, mesh=mesh,
                                 ctx=ctx, local_backend="cuda",
                                 out_dtype=torch.float32)
                torch.cuda.synchronize()
                launches, tc = k.launches, k.tensor_core_launches
                local = [d for d in log if d.op == "conv2d"]
                if (len(local) != DIST_P or launches != DIST_P
                        or tc != DIST_P or any(
                            d.chosen != "cuda" or d.degraded
                            or d.plan.parallel is not None for d in local)):
                    fail(f"dist {kind} {label}: {len(local)} shard "
                         f"decisions ({[(d.chosen, d.degraded) for d in local]}"
                         f"), {launches} launches, {tc} on the tensor cores; "
                         f"want {DIST_P} of each on cuda")
                shard_launches += launches
                if kind == "halo":
                    (dd,) = [d for d in log if d.op == "conv2d_dist"]
                    if dd.chosen != "cuda" or dd.degraded:
                        fail(f"dist halo {label}: decision {dd}")
                    d = ops.explain("conv2d_dist", ctx, dtype=x.dtype,
                                    spec_args=(x, w),
                                    spec_kw={"stride": stride,
                                             "out_dtype": torch.float32,
                                             "blocking": pb, "mesh": mesh})
                    want = {"shift": halo_w, "psum": psum_w,
                            "all_gather": 0}
                    words = d.measured_words
                    if (words != comm_w or dd.measured_words != comm_w
                            or td.conv2d_dist_comm_words(x, w, stride, pb)
                            != comm_w):
                        fail(f"dist halo {label}: explain {words}, the "
                             f"table {comm_w}")
                else:
                    want = {"shift": 0, "psum": 0, "all_gather": ag_w}
                    words = td.allgather_comm_words(x, w, stride, pb)
                    if words != ag_w:
                        fail(f"dist allgather {label}: counter {words}, the "
                             f"table {ag_w}")
                for dev in range(DIST_P):
                    if mesh.wire[dev] != want:
                        fail(f"dist {kind} {label}: device {dev} counted "
                             f"{mesh.wire[dev]}, the counters give {want}")
                err, allowed = rel_err(out, ref)
                if not err <= allowed:
                    fail(f"dist {kind} {label}: error {err} against the "
                         f"single-device cuda conv, allowed {allowed}")
                plain_err, plain_allowed = rel_err(out, plain)
                if not plain_err <= plain_allowed:
                    fail(f"dist {kind} {label}: error {plain_err} against "
                         f"the plain version, allowed {plain_allowed}")
                runs[kind] = {"words": words, "max_abs_err": err,
                              "allowed": allowed,
                              "max_abs_err_vs_plain": plain_err,
                              "allowed_vs_plain": plain_allowed,
                              "bit_equal": bool(torch.equal(out, ref)),
                              "launches": launches,
                              "tensor_core_launches": tc}
                del out
                if kind == "halo":
                    plan_bound = d.lower_bound
                    runs[kind]["ms"] = median_ms(lambda: ops.conv2d_dist(
                        x, w, stride, blocking=pb, mesh=mesh, ctx=ctx,
                        out_dtype=torch.float32))
                else:
                    runs[kind]["ms"] = median_ms(lambda: fn(
                        x, w, stride, blocking=pb, mesh=mesh, ctx=ctx,
                        local_backend="cuda", out_dtype=torch.float32))
                torch.cuda.empty_cache()
            fewer = runs["halo"]["words"] < runs["allgather"]["words"]
            if tag in ("lp", "probe0") and not fewer:
                fail(f"dist {label}: the halo conv moves "
                     f"{runs['halo']['words']} words, the all-gather "
                     f"{runs['allgather']['words']}")
            print(json.dumps({
                "dist_conv": name, "grid": grid, "tag": tag, "P": DIST_P,
                "halo_words": geom.halo_words(0.5),
                "psum_words": geom.psum_words(1.0),
                "comm_words": runs["halo"]["words"],
                "allgather_words": runs["allgather"]["words"],
                "halo_fewer_than_allgather": fewer,
                "plan_parallel_lower_bound_at_H100_M_eff": plan_bound,
                "combined_bound_at_2^20": bound_2_20,
                "comm_over_bound_at_2^20": runs["halo"]["words"]
                / max(bound_2_20, 1.0),
                "halo": runs["halo"], "allgather": runs["allgather"],
                "single_device_ms": single_ms,
                "single_device_max_abs_err_vs_plain": ref_err,
                "timing_note": "CUDA events a call; the 8 shards run in "
                               "turn on one card, so this is what the "
                               "decomposition costs one card, not a speedup",
                "card": card}), flush=True)
            lctx = ops.ExecutionContext(target=H100, backend="cuda")
            dist_shard_audit(label, geom, s, lctx)
            audits += 1
        del x, w, ref, plain
        torch.cuda.empty_cache()
    return shard_launches, audits


def dist_rank_main(rank: int, outdir: str) -> None:
    """One rank of phase 26 (c): join the gloo group through the file
    store, run each of ``GROUP_GRIDS`` through ``ops.conv2d_dist`` on a
    ``GroupConvMesh`` with this rank's shard on ``cuda:0`` (the shard conv
    on ``conv2d_tc_kernel``), and save its output block, its wire counts,
    its launches and its decisions."""
    import torch.distributed as dist

    from repro_torch import ops
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import make_conv_mesh
    from repro_torch.plan import HardwareTarget

    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(outdir, "store"),
        world_size=GROUP_RANKS, rank=rank)
    data = torch.load(os.path.join(outdir, "inputs.pt"))
    x, w = data["x"].to("cuda"), data["w"].to("cuda")
    k = KERNELS["conv2d"]
    res = {}
    for i, grid in enumerate(GROUP_GRIDS):
        mesh = make_conv_mesh(grid, group=dist.group.WORLD)
        ctx = ops.ExecutionContext(target=HardwareTarget.from_mesh(mesh),
                                   backend="cuda")
        zero_counts()
        with ops.record_dispatch() as log:
            y = ops.conv2d_dist(x, w, blocking=grid, mesh=mesh, ctx=ctx,
                                out_dtype=torch.float32)
        torch.cuda.synchronize()
        res[i] = {"y": y.cpu(), "device": y.device.type,
                  "wire": mesh.wire[rank],
                  "launches": k.launches, "tc": k.tensor_core_launches,
                  "decisions": [(d.op, d.chosen, d.degraded) for d in log]}
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def dist_group(gen: torch.Generator, card: str) -> int:
    """Phase 26 (c): conv2_x cut to batch 64 through 4 gloo ranks, each a
    process of its own sharing the card; the ranks are joined under
    ``GROUP_TIMEOUT`` and killed if one hangs. Returns their launches."""
    import tempfile

    from repro_torch import distributed as td
    from repro_torch import ops
    from repro_torch.core.conv_model import BF16_ACC32, resnet50_layers
    from repro_torch.kernels import conv2d_plain
    from repro_torch.launch import make_conv_mesh
    from repro_torch.plan import HardwareTarget

    layers = resnet50_layers(BATCH)
    s = layers["conv2_x"].with_precision(BF16_ACC32)
    x, w = layer_inputs(gen, list(layers).index("conv2_x"), s)
    x = x[:GROUP_BATCH].contiguous()
    outdir = tempfile.mkdtemp(prefix="dist_group_")
    torch.save({"x": x.cpu(), "w": w.cpu()}, os.path.join(outdir,
                                                          "inputs.pt"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dist-rank",
         str(r), outdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(GROUP_RANKS)]
    logs = []
    try:
        for p in procs:
            left = GROUP_TIMEOUT - (time.perf_counter() - t0)
            logs.append(p.communicate(timeout=max(left, 1.0))[0])
    except subprocess.TimeoutExpired:
        fail(f"dist group: a rank did not finish in {GROUP_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        fail("dist group: rank exit codes "
             f"{[p.returncode for p in procs]}:\n" + "\n".join(logs)[-4000:])
    ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
             for r in range(GROUP_RANKS)]
    plain = conv2d_plain(x, w)
    launches = 0
    for i, grid in enumerate(GROUP_GRIDS):
        mesh = make_conv_mesh(grid)
        ctx = ops.ExecutionContext(target=HardwareTarget.from_mesh(mesh),
                                   backend="cuda")
        want = td.halo_conv(x, w, blocking=grid, mesh=mesh, ctx=ctx,
                            out_dtype=torch.float32, full_output=True)
        got = mesh.assemble({r: ranks[r][i]["y"].to("cuda")
                             for r in range(GROUP_RANKS)}, td.halo.OUT_SPEC)
        words = td.conv2d_dist_comm_words(x, w, blocking=grid)
        for r in range(GROUP_RANKS):
            rec = ranks[r][i]
            if (sum(rec["wire"].values()) != words
                    or rec["wire"] != mesh.wire[r]):
                fail(f"dist group {grid}: rank {r} counted {rec['wire']}, "
                     f"the counter {words}, the in-process mesh "
                     f"{mesh.wire[r]}")
            if rec["device"] != "cuda":
                fail(f"dist group {grid}: rank {r}'s output left the card "
                     f"({rec['device']})")
            if rec["launches"] != 1 or rec["tc"] != 1 or any(
                    d[0] == "conv2d" and (d[1] != "cuda" or d[2])
                    for d in rec["decisions"]):
                fail(f"dist group {grid}: rank {r} launches "
                     f"{rec['launches']} ({rec['tc']} tensor core), "
                     f"decisions {rec['decisions']}")
            launches += rec["launches"]
        if "cI" in grid:
            err, allowed = rel_err(got, want)
            ok = err <= allowed
        else:
            err, allowed = (got - want).abs().max().item(), 0.0
            ok = bool(torch.equal(got, want))
        if not ok:
            fail(f"dist group {grid}: error {err} against the in-process "
                 f"mesh, allowed {allowed}")
        valid = tuple(slice(0, n) for n in plain.shape)  # got is padded
        plain_err, plain_allowed = rel_err(got[valid], plain)
        if not plain_err <= plain_allowed:
            fail(f"dist group {grid}: error {plain_err} against the plain "
                 f"version, allowed {plain_allowed}")
        print(json.dumps({
            "dist_group": "conv2_x", "batch": GROUP_BATCH, "grid": grid,
            "ranks": GROUP_RANKS, "backend": "gloo, staged through host",
            "bit_equal_to_in_process": bool(torch.equal(got, want)),
            "max_abs_err": err, "allowed": allowed,
            "max_abs_err_vs_plain": plain_err,
            "allowed_vs_plain": plain_allowed, "words_per_rank": words,
            "launches_per_rank": [ranks[r][i]["launches"]
                                  for r in range(GROUP_RANKS)],
            "seconds_all_ranks": seconds, "card": card}), flush=True)
    return launches


def dist_phase(gen: torch.Generator) -> dict:
    """Phase 26 (module docstring): the §4.2 distributed conv at full width
    on an in-process mesh, its shard dispatches audited, and the
    process-group route over 4 gloo ranks. Fatal on any failure."""
    # the memory the full-width runs start from (cycle_check("25") has
    # reported what the earlier phases left in reference cycles)
    torch.cuda.empty_cache()
    print(json.dumps({"dist_phase": "start",
                      "allocated_gb": torch.cuda.memory_allocated() / 1e9}),
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    card = smi()
    t0 = time.perf_counter()
    shard_launches, audits = dist_in_process(gen, card)
    cycle_check("26 (a)-(b)", fatal=True)
    group_launches = dist_group(gen, card)
    cycle_check("26 (c)", fatal=True)
    summary = {"dist_phase": "summary", "shard_launches": shard_launches,
               "shard_audits": audits,
               "group_rank_launches": group_launches,
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "seconds": time.perf_counter() - t0, "card": card}
    print(json.dumps(summary), flush=True)
    return summary


MESH_SHAPE = (2, 2)  # (data, model): one KV head, 8 query heads a rank
MESH_RANKS = 4
MESH_STEPS = 2
MESH_LR = 1e-3
MESH_TIMEOUT = 600  # seconds for the ranks to finish
# the losses' tight bound: a step moves the loss by about 1e-3 relative,
# the mesh's bf16 partial sums move it by about 1e-5
MESH_LOSS_TIGHT = 1e-4
# the first moments' bound relative to each leaf's largest |value|: the
# bf16 forward and backward split over the mesh move every kind of leaf by
# 1.1e-2 to 3.6e-2 (NVIDIA H100 80GB HBM3, 700.00 W); no update reads 1
MESH_MOMENT_TOL = 1e-1
# phase 28's bound for the MoE FFN's leaves (router and experts), where a
# (token, k) choice that bf16 noise flips on the mesh moves that token's
# whole contribution between two experts: 0.149 on the card (w_up of layer
# 1, 2.5-3.6% of its choices flipped; NVIDIA H100 80GB HBM3, 700.00 W);
# no update reads 1, a wrong sign 2
MOE_MOMENT_TOL = 0.5
# seconds for phase 27 (b)'s process, from its start with phase 27
DRYRUN_TIMEOUT = 900
# phase 27 (a)'s depth cut of Qwen2.5-3B: half of phase 22's 8 layers
# (the script's time limit)
MESH_TRAIN_LAYERS = 4
# phase 27 (a)'s second run from the same init: the step's three options
# (``TrainConfig``), on the ranks and on one card alike
MESH_OPTIONS = {"microbatches": 2, "compress_grads": True, "remat": True}
# phase 27 (b): (arch, shape, multi-pod, overrides): the cells of
# ``configs.all_cells()`` at full depth on (16, 16) but four train_4k cells
# (their 74 s of host time on the card's host would push the process's read
# past phase 30: PERF.md §6 records them from a run of
# ``repro_torch.launch.dryrun``, and Tier-1 pins them on 2 x 2),
# OLMoE-1B-7B's and Phi-3.5-MoE's train_4k with the MoE shard hints, and
# Qwen2.5-3B's train_4k on (2, 16, 16)
MOE_HINTS = {"moe_shard_hints": True}
MOE_HINTS_CELLS = (("olmoe_1b_7b", "train_4k"), ("phi3_5_moe_42b", "train_4k"))
DRYRUN_LEFT_OUT = (("stablelm_1_6b", "train_4k"),
                   ("phi3_medium_14b", "train_4k"),
                   ("minitron_8b", "train_4k"), ("hubert_xlarge", "train_4k"))


def dryrun_cells() -> list:
    """Phase 27 (b)'s cells (above)."""
    from repro_torch.configs import all_cells

    return [(arch, s.name, False,
             MOE_HINTS if (arch, s.name) in MOE_HINTS_CELLS else None)
            for arch, s in all_cells()
            if (arch, s.name) not in DRYRUN_LEFT_OUT] + [
                ("qwen2_5_3b", "train_4k", True, None)]


# the recurrent cells that the dry run extrapolates in repeats (Jamba-1.5's
# and xLSTM-1.3B's)
EXTRAPOLATED_CELLS = ("train_4k", "prefill_32k")
# phase 28: OLMoE-1B-7B at published widths cut to 2 layers, its MoE
# dispatch in 4 groups (gcd(4 x 512 tokens, 4 ranks)) on the mesh and on
# one card alike
MOE_MESH_LAYERS = 2
MOE_MESH_GROUPS = MESH_RANKS
# phases 29 and 30: Jamba-1.5's mamba block and its dense FFN, and
# xLSTM-1.3B's two units, at published widths on (data 1, model 4): a
# quarter of every model-sharded leaf a rank (on (2, 2) each phase-29 rank
# would hold half, 17-20 GB, 70-80 GB for the four)
RECURRENT_MESH_SHAPE = (1, 4)
# phase 30: xLSTM-1.3B at published widths cut to two (mlstm, slstm) units
# on (data 1, model 4): one mLSTM head and 512 sLSTM channels a rank
XLSTM_MESH_LAYERS = 4


def mesh_train_argv() -> list:
    """Phase 27 (a)'s ``launch/train.py`` arguments: Qwen2.5-3B at
    published widths cut to ``MESH_TRAIN_LAYERS`` layers, B 4, L 512, its
    seed (the launcher's, 0 = ``SEED``)."""
    return ["--arch", TRAIN_ARCH, "--layers", str(MESH_TRAIN_LAYERS),
            "--batch", "4", "--seq", "512", "--steps", str(MESH_STEPS),
            "--lr", str(MESH_LR), "--device", "cuda", "--backend", "cuda"]


def step_options(options: dict) -> tuple:
    """Of a run with the step options ``options`` (``TrainConfig`` fields,
    ``MESH_OPTIONS`` or empty for the plain step): (the launcher's flags,
    the tag of the single-device run's files, flash's forwards a layer
    and step: one a microbatch, twice with remat's recomputation)."""
    mb = options.get("microbatches", 1)
    flags = (["--microbatches", str(mb)] if mb > 1 else []) + \
        (["--compress-grads"] if options.get("compress_grads") else []) + \
        (["--remat"] if options.get("remat") else [])
    return (flags, "_options" if options else "",
            mb * (2 if options.get("remat") else 1))


def moe_mesh_argv() -> list:
    """Phase 28's ``launch/train.py`` arguments: OLMoE-1B-7B at published
    widths cut to ``MOE_MESH_LAYERS`` layers, B 4, L 512, the MoE shard
    hints on (a no-op on one card) and ``MOE_MESH_GROUPS`` dispatch groups
    on one card as on the mesh."""
    return ["--arch", MOE_ARCH, "--layers", str(MOE_MESH_LAYERS), "--batch",
            "4", "--seq", "512", "--steps", str(MESH_STEPS), "--lr",
            str(MESH_LR), "--device", "cuda", "--backend", "cuda",
            "--moe-shard-hints", "--moe-groups", str(MOE_MESH_GROUPS)]


MESH_PHASES = {  # phase: (the launcher's arguments, the ranks' flag)
    "27": (mesh_train_argv, "--mesh-rank"),
    "28": (moe_mesh_argv, "--moe-rank")}


def mesh_rank_report(phase: str, outdir: str, options: dict = None):
    """One rank of phase 27 (a) or 28, started as ``torchrun`` would start
    it (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): the
    launcher's mesh run (``launch.train.train``; with the step
    ``options``, :func:`step_options`) with the flash counts set to 0 just
    before and (phase 28) every MoE call's routing recorded; then this
    device's chunk of each parameter and first moment against the
    single-device run's files in ``outdir``. Returns (the report, the
    trainer, the routing log)."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.models import moe

    flags, tag, _ = step_options(options or {})
    argv = MESH_PHASES[phase][0]() + flags + [
        "--mesh", ",".join(map(str, MESH_SHAPE))]
    flash = KERNELS["flash_attention"]
    flash.launches = flash.tensor_core_launches = 0
    with (moe.record_routing() if phase == "28"
          else contextlib.nullcontext([])) as routing:
        trainer, hist = launch_train.train(argv)
    report = {"rank": int(os.environ["RANK"]), "loss": hist["loss"],
              "step_time": hist["step_time"],
              "collectives": trainer.collectives,
              "flash_launches": flash.launches,
              "flash_tensor_core_launches": flash.tensor_core_launches,
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 1e9,
              "argument_bytes": argument_bytes(
                  (trainer.params, trainer.opt_state,
                   trainer.place_batch(trainer.source.batch(0))))}
    report.update(chunk_errors(trainer, single_files(outdir, tag)),
                  memory_allocated_gb_after=(
                      torch.cuda.memory_allocated() / 1e9))
    return report, trainer, routing


def single_files(outdir: str, tag: str = "") -> tuple:
    """The single-device run's parameter and first-moment files (``tag``:
    :func:`step_options`'s)."""
    return (os.path.join(outdir, f"single_params{tag}.pt"),
            os.path.join(outdir, f"single_m{tag}.pt"))


def chunk_errors(trainer, files: tuple) -> dict:
    """This device's chunk of each parameter and AdamW first moment of a
    mesh trainer against the single-device run's ``files``: the
    parameters' largest error (and those over 2 x lr x steps), each
    parameter's own, and each first moment's relative to its chunk's
    largest |value|."""
    from repro_torch.train.trainer import shardings_for

    specs = shardings_for(trainer.model_cfg, trainer.mesh)
    params_file, m_file = files
    want = torch.load(params_file, mmap=True)
    params, over = {}, []
    for name, p in trainer.params.named_parameters():
        chunk = want[name][specs[name].local_slices(p.shape)]
        err = (p.to_local().detach().cpu() - chunk).abs().max().item()
        params[name] = err
        if not err <= 2 * MESH_LR * MESH_STEPS:
            over.append((name, err))
    # the first moments: this device's chunk of each against the
    # single-device run's, relative to the chunk's largest |value|
    want = torch.load(m_file, mmap=True)
    moments = {}
    for name, m in trainer.opt_state.m.items():
        chunk = want[name][specs[name].local_slices(m.shape)]
        scale = chunk.abs().max().item()
        err = (m.to_local().detach().cpu() - chunk).abs().max().item()
        moments[name] = (err / scale if scale else
                         (0.0 if err == 0 else math.inf))
    return {"param_max_abs_err": max(params.values()), "param_abs_err":
            params, "params_over": over[:5], "moment_rel_err": moments}


def mesh_rank_main(rank: int, outdir: str) -> None:
    """One rank of phase 27 (a): :func:`mesh_rank_report`, then the
    single-device checkpoint restored onto the mesh with ``shardings=``
    and gathered back over a CPU mesh of the same ranks, then the run with
    ``MESH_OPTIONS`` from the same init (its report under ``options``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.convert import tree_from_named
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt

    report, trainer, _ = mesh_rank_report("27", outdir)
    mesh, cfg = trainer.mesh, trainer.model_cfg
    del trainer
    torch.cuda.empty_cache()
    with torch.device("meta"):
        meta = T.Transformer(cfg)
    template = {"params": tree_from_named(dict(meta.named_parameters()))}
    tree = {"params": shd.stacked_param_specs(cfg)}
    directory = os.path.join(outdir, "ckpt")
    placed, _ = ckpt.restore(directory, template, device="cuda",
                             shardings=shd.shardings(mesh, tree))
    plain, _ = ckpt.restore(directory, template, device="cpu")
    cpu_mesh = make_host_mesh(*MESH_SHAPE, device_type="cpu")
    equal, sharded = True, 0
    for (key, a), (_, b) in zip(ckpt._flatten_with_paths(placed),
                                ckpt._flatten_with_paths(plain)):
        local = a.to_local()
        sharded += tuple(local.shape) != tuple(a.shape)
        whole = DTensor.from_local(local.cpu(), cpu_mesh, a.placements,
                                   run_check=False, shape=a.shape,
                                   stride=a.stride()).full_tensor()
        equal = equal and bool(torch.equal(whole, b))
    del placed, plain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    options, trainer, _ = mesh_rank_report("27", outdir, MESH_OPTIONS)
    options["local_device"] = str(
        next(trainer.params.parameters()).to_local().device)
    del trainer
    with open(os.path.join(outdir, f"checks{rank}.json"), "w") as f:
        json.dump(dict(report, restore_bit_equal=equal,
                       restored_sharded_leaves=sharded,
                       local_device=str(local.device), options=options), f)
    dist.destroy_process_group()


def moe_rank_main(rank: int, outdir: str) -> None:
    """One rank of phase 28: :func:`mesh_rank_report` with the routing
    recorded, then each forward's expert choices on this device's groups
    against the single-device run's choices for the same groups (the
    hints put G's 4 groups one a device over (``data``, ``model``))."""
    import torch.distributed as dist

    from repro_torch.models import sharding as shd

    report, trainer, log = mesh_rank_report("28", outdir)
    device = next(trainer.params.parameters()).to_local().device
    want = torch.load(os.path.join(outdir, "single_routing.pt"))
    groups = shd.NamedSharding(trainer.mesh, shd.P(("data", "model")))
    rows = []
    for i, (r, w) in enumerate(zip(log, want)):
        sl = groups.local_slices((w["gate_idx"].shape[0],))[0]
        idx, kept = r.gate_idx.cpu(), r.kept.cpu()
        rows.append({"forward": i, "groups": [sl.start, sl.stop],
                     "routing_flips": int((idx != w["gate_idx"][sl]).sum()),
                     "routing_choices": idx.numel(),
                     "kept_differ": int((kept != w["kept"][sl]).sum()),
                     "dropped": int((kept == 0).sum()),
                     "single_dropped": int((w["kept"][sl] == 0).sum())})
    with open(os.path.join(outdir, f"checks{rank}.json"), "w") as f:
        json.dump(dict(report, routing=rows, forwards=len(log),
                       local_device=str(device)), f)
    dist.destroy_process_group()


def dryrun_main() -> None:
    """Phase 27 (b) in a process of its own (``--dryrun``): each cell of
    :func:`dryrun_cells` through ``launch.dryrun.run_cell`` on a fake group
    (no card memory), one ``{"dryrun": ...}`` line a cell with its host
    seconds, then the report's two tables."""
    from repro_torch.analysis import report
    from repro_torch.launch import dryrun

    recs = []
    t_start = time.perf_counter()
    for arch, shape, multi_pod, overrides in dryrun_cells():
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                              verbose=False, overrides=overrides,
                              variant="hints" if overrides else "base")
        recs.append(rec)
        print(json.dumps({
            "dryrun": arch, "shape": shape, "mesh": rec["mesh"],
            "overrides": overrides, "n_layers": rec["n_layers"],
            "n_groups": rec["n_groups"],
            "bytes_per_device": rec["bytes_per_device"],
            "extrapolated": rec.get("extrapolated"),
            "hlo_flops": rec["hlo_flops"], "hlo_bytes": rec["hlo_bytes"],
            "collectives": rec["collectives"],
            "collective_calls": rec["collective_calls"],
            "compute_s": rec["compute_s"], "memory_s": rec["memory_s"],
            "collective_s": rec["collective_s"],
            "dominant": rec["dominant"], "mfu": rec["mfu"],
            "host_s": time.perf_counter() - t0,
            "torch": rec["torch"]}), flush=True)
    print(report.dryrun_table(recs), flush=True)
    for mesh in ("16x16", "2x16x16"):
        print(report.roofline_table(recs, mesh=mesh), flush=True)
    print(json.dumps({"dryrun_total_s": time.perf_counter() - t_start}),
          flush=True)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_dryrun() -> tuple:
    """Phase 27 (b)'s process (this script with ``--dryrun``; host work
    only), started with phase 27 so that it runs beside phases 27-31 (not
    beside the host-paced timings of the earlier phases): (the process,
    its output file, its start time). It is stopped at exit if it still
    runs."""
    import atexit
    import tempfile

    log = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dryrun"], stdout=log,
                            stderr=subprocess.STDOUT, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, log, time.perf_counter()


def mesh_phase() -> dict:
    """Phase 27 (a) (module docstring): the mesh trainer over 4 gloo ranks
    sharing the card against the single-device trainer and the dry run's
    count. Fatal on any failure; the single-device run's files are
    removed at the end."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=MESH_TRAIN_LAYERS)
    outdir = tempfile.mkdtemp(prefix="mesh_train_")
    try:
        row = mesh_train_gates(cfg, outdir, "27")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    opt = row["options"]
    summary = {"mesh_phase": "summary",
               "rank_flash_launches": sum(row["rank_flash_launches"]),
               "options_rank_flash_launches": sum(opt["rank_flash_launches"]),
               "step_s": {"plain": {"rank": row["rank_step_s"],
                                    "card": row["single_step_s"]},
                          "options": {"rank": opt["rank_step_s"],
                                      "card": opt["single_step_s"]}},
               "seconds": time.perf_counter() - t_phase, "card": row["card"]}
    print(json.dumps(summary), flush=True)
    return summary


def dryrun_phase(dry: tuple) -> dict:
    """Phase 27 (b) (module docstring): the dry run's process
    (:func:`start_dryrun`'s ``dry``), read after phase 31: its lines, and
    its gates. Fatal on any failure."""
    from repro_torch.configs import get_config

    proc, log, t_dry = dry
    try:
        proc.wait(timeout=max(
            DRYRUN_TIMEOUT - (time.perf_counter() - t_dry), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"dry run: not done in {DRYRUN_TIMEOUT} s")
    log.seek(0)
    out = log.read()
    lines = [x for x in out.splitlines() if not x.startswith("[rank")
             and "Warning" not in x and "warn(" not in x]
    print("\n".join(lines), flush=True)
    cells = [x for x in lines if x.startswith('{"dryrun"')]
    want = len(dryrun_cells())
    if proc.returncode != 0 or len(cells) != want:
        fail(f"dry run: exit code {proc.returncode}, {len(cells)} of "
             f"{want} cells:\n" + out[-4000:])
    moe_cells = [json.loads(x) for x in cells
                 if json.loads(x)["overrides"] == MOE_HINTS]
    if not moe_cells or any(c["collective_calls"].get("all-to-all", 0) <= 0
                            for c in moe_cells):
        fail(f"dry run: a MoE cell with the hints issued no all-to-all: "
             f"{[c['collective_calls'] for c in moe_cells]}")
    for arch in (HYBRID_ARCH, XLSTM_ARCH):
        repeats = get_config(arch).repeats
        ext = [json.loads(x) for x in cells if json.loads(x)["dryrun"]
               == arch and json.loads(x)["shape"] in EXTRAPOLATED_CELLS]
        if len(ext) != len(EXTRAPOLATED_CELLS) or any(
                c["extrapolated"] != f"R=1,2 -> R={repeats}" for c in ext):
            fail(f"dry run: {arch}'s recurrent cells not extrapolated to "
                 f"its {repeats} repeats: {[c['extrapolated'] for c in ext]}")
    total = [json.loads(x)["dryrun_total_s"] for x in lines
             if x.startswith('{"dryrun_total_s"')]
    summary = {"dryrun_phase": "summary", "dry_run_cells": len(cells),
               "process_cells_s": total[0] if total else None,
               "seconds_since_start": time.perf_counter() - t_dry}
    print(json.dumps(summary), flush=True)
    return summary


def no_update_loss(cfg, ctx, n_groups: int = 1) -> tuple:
    """The single-device trainer's loss at its first parameters (the
    launcher's seed) on its first and on its second batch: the first
    reproduces the run's first loss; the second is the loss of a run that
    did not update at its second step, the control of the losses' tight
    bound."""
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainConfig

    tc = TrainConfig(ctx=ctx)
    params = T.init_params(cfg, seed=tc.seed, device="cuda")
    source = make_source(DataConfig(batch_size=4, seq_len=512,
                                    vocab_size=cfg.vocab_size))
    out = []
    with torch.no_grad():
        for step in (0, 1):
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in source.batch(step).items()}
            total, _ = T.loss_fn(params, cfg, batch, ctx=ctx,
                                 n_groups=n_groups,
                                 aux_weight=tc.aux_weight,
                                 loss_chunks=tc.loss_chunks)
            out.append(float(total))
    del params
    torch.cuda.empty_cache()
    return out[0], out[1]


def mesh_train_gates(cfg, outdir: str, phase: str) -> dict:
    """Phase 27 (a) or 28: the single-device run (its parameters and first
    moments written to ``outdir``; phase 27 its checkpoint, phase 28 its
    routing), the no-update control, the dry run's count, then the 4
    ranks, and every gate; returns the phase's row. Phase 27 also runs
    ``MESH_OPTIONS`` from the same init on one card and on the ranks, and
    gates it alike (its row under ``options``)."""
    from repro_torch.convert import transformer_tree
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import TrainConfig

    argv_fn, flag = MESH_PHASES[phase]
    moe_phase_ = phase == "28"
    groups = MOE_MESH_GROUPS if moe_phase_ else 1
    card = smi()
    at_start, control = no_update_loss(
        cfg, ExecutionContext(target=H100, backend="cuda", device="cuda"),
        groups)
    # the single-device run: the same launcher, the same arguments
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k = KERNELS["flash_attention"]
    k.launches = k.tensor_core_launches = 0
    with (moe.record_routing() if moe_phase_
          else contextlib.nullcontext([])) as routing:
        trainer, single = launch_train.train(argv_fn())
    single_launches = (k.launches, k.tensor_core_launches)
    single_peak = torch.cuda.max_memory_allocated() / 1e9
    save_single(trainer, single_files(outdir))
    if moe_phase_:
        torch.save([{"gate_idx": r.gate_idx.cpu(), "kept": r.kept.cpu()}
                    for r in routing],
                   os.path.join(outdir, "single_routing.pt"))
        gaps = [(lambda v: (v[..., -2] - v[..., -1]).min().item())(
            torch.topk(r.probs, cfg.experts_per_token + 1, dim=-1).values)
            for r in routing]
    else:
        ckpt.save(os.path.join(outdir, "ckpt"), MESH_STEPS,
                  {"params": transformer_tree(trainer.params)})
    del trainer, routing
    gc.collect()
    torch.cuda.empty_cache()
    tokens = {"tokens": torch.empty((4, 512), dtype=torch.int32,
                                    device="meta")}
    if not moe_phase_:  # the options' run from the same init
        flags, tag, _ = step_options(MESH_OPTIONS)
        torch.cuda.reset_peak_memory_stats()
        k.launches = k.tensor_core_launches = 0
        trainer, single_o = launch_train.train(argv_fn() + flags)
        single_o.update(launches=(k.launches, k.tensor_core_launches),
                        peak=torch.cuda.max_memory_allocated() / 1e9)
        save_single(trainer, single_files(outdir, tag))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        count_o = dryrun.count_train_step(
            cfg, MESH_SHAPE, tokens,
            TrainConfig(n_groups=MESH_RANKS, **MESH_OPTIONS))
    # the dry run's count of the same step under the same placements
    count = dryrun.count_train_step(cfg, MESH_SHAPE, tokens,
                                    TrainConfig(n_groups=MESH_RANKS))
    t0 = time.perf_counter()
    env = dict(os.environ, WORLD_SIZE=str(MESH_RANKS),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               LOCAL_RANK="0")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r),
         outdir], env=dict(env, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_RANKS)]
    logs = []
    try:
        for p in procs:
            left = MESH_TIMEOUT - (time.perf_counter() - t0)
            logs.append(p.communicate(timeout=max(left, 1.0))[0])
    except subprocess.TimeoutExpired:
        fail(f"mesh train: a rank did not finish in {MESH_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        fail("mesh train: rank exit codes "
             f"{[p.returncode for p in procs]}:\n" + "\n".join(logs)[-6000:])
    checks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(outdir, f"checks{r}.json")) as f:
            checks.append(json.load(f))
    single.update(launches=single_launches, peak=single_peak,
                  gaps=gaps if moe_phase_ else None)
    row = mesh_run_gates(cfg, phase, single, checks, count, at_start,
                         control, groups, seconds, card)
    if not moe_phase_:
        row["options"] = mesh_run_gates(
            cfg, phase, single_o, [c["options"] for c in checks], count_o,
            at_start, control, groups, seconds, card, MESH_OPTIONS)
    return row


def save_single(trainer, files: tuple) -> None:
    """The single-device run's parameters and first moments, on the host,
    to ``files`` (:func:`single_files`)."""
    params_file, m_file = files
    torch.save({n: p.detach().cpu() for n, p in
                trainer.params.named_parameters()}, params_file)
    torch.save({n: m.cpu() for n, m in trainer.opt_state.m.items()}, m_file)


def mesh_run_gates(cfg, phase: str, single: dict, checks: list, count: dict,
                   at_start: float, control: float, groups: int,
                   seconds: float, card, options: dict = None) -> dict:
    """One run of phase 27 (a) or 28 (with the step ``options``:
    ``MESH_OPTIONS``'s run) against one card's and the dry run's count:
    its row, printed, and every gate (fatal)."""
    moe_phase_ = phase == "28"
    options = options or {}
    single_launches, single_peak = single["launches"], single["peak"]
    bound = 2 * MESH_LR * MESH_STEPS
    rel = [abs(a - b) / abs(b) for c in checks
           for a, b in zip(c["loss"], single["loss"])]
    # the first moments' worst leaf, over every leaf and (phase 28) apart
    # for the MoE FFN's leaves, which the routing's flips move
    moments = {}
    for c in checks:
        for name, err in c["moment_rel_err"].items():
            moments[name] = max(moments.get(name, 0.0), err)
    routed = {n for n in moments if moe_phase_ and ".ffn." in n}
    gated = {n: (MOE_MOMENT_TOL if n in routed else MESH_MOMENT_TOL)
             for n in moments}
    top = max(moments, key=lambda n: moments[n] / gated[n])
    rest = [n for n in moments if n not in routed]
    top_rest = max(rest, key=moments.get)
    control_rel = abs(control - single["loss"][1]) / abs(single["loss"][1])
    row = {"mesh_train": cfg.name, "phase": phase, "layers": cfg.n_layers,
           "step_options": options,
           "mesh": {"data": MESH_SHAPE[0], "model": MESH_SHAPE[1]},
           "ranks": MESH_RANKS, "backend": "gloo, one card",
           "batch": [4, 512], "steps": MESH_STEPS, "n_groups": groups,
           "moe_shard_hints": cfg.moe_shard_hints,
           "single_losses": single["loss"],
           "rank_losses": [c["loss"] for c in checks],
           "loss_max_rel_err": max(rel), "loss_bound": MESH_LOSS_TIGHT,
           "no_update_loss": control, "no_update_loss_rel_err": control_rel,
           "first_loss_recomputed": at_start,
           "single_step_s": single["step_time"],
           "rank_step_s": [c["step_time"] for c in checks],
           "param_max_abs_err": max(c["param_max_abs_err"] for c in checks),
           "param_bound": bound,
           "moment_max_rel_err": moments[top_rest],
           "moment_worst_leaf": top_rest,
           "moment_bound": MESH_MOMENT_TOL,
           "wire_bytes_per_step": checks[0]["collectives"][0],
           "dry_run_wire_bytes": count["collectives"],
           "dry_run_calls": count["calls"],
           "argument_bytes": [c["argument_bytes"] for c in checks],
           "dry_run_argument_bytes": count["argument_bytes"],
           "rank_flash_launches": [c["flash_launches"] for c in checks],
           "rank_tensor_core_launches": [c["flash_tensor_core_launches"]
                                         for c in checks],
           "single_flash_launches": single_launches[0],
           "rank_max_memory_allocated_gb": [
               c["max_memory_allocated_gb"] for c in checks],
           "single_max_memory_allocated_gb": single_peak,
           "ranks_seconds": seconds, "card": card}
    if moe_phase_:
        flips = [[f["routing_flips"] for f in c["routing"]] for c in checks]
        worst_routed = max(routed, key=moments.get)
        by_kind = {}
        for n, err in moments.items():
            kind = n.rsplit(".", 1)[-1]
            by_kind[kind] = max(by_kind.get(kind, 0.0), err)
        row.update(
            routed_moment_max_rel_err=moments[worst_routed],
            routed_moment_worst_leaf=worst_routed,
            routed_moment_bound=MOE_MOMENT_TOL,
            moment_max_rel_err_by_kind=by_kind,
            rank_memory_allocated_gb_after=[
                c["memory_allocated_gb_after"] for c in checks],
            routing_flips_by_forward=[sum(x) for x in zip(*flips)],
            routing_choices_by_forward=[
                sum(f["routing_choices"] for f in fs) for fs in
                zip(*[c["routing"] for c in checks])],
            kept_differ_by_forward=[
                sum(f["kept_differ"] for f in fs) for fs in
                zip(*[c["routing"] for c in checks])],
            dropped_by_forward=[sum(f["dropped"] for f in fs) for fs in
                                zip(*[c["routing"] for c in checks])],
            single_dropped_by_forward=[
                sum(f["single_dropped"] for f in fs) for fs in
                zip(*[c["routing"] for c in checks])],
            single_min_topk_gap_by_forward=single["gaps"])
    elif not options:
        row["restore_bit_equal"] = [c["restore_bit_equal"] for c in checks]
    print(json.dumps(row), flush=True)
    if not max(rel) <= 1e-2 or any(len(c["loss"]) != MESH_STEPS
                                   for c in checks):
        fail(f"mesh train: losses {row['rank_losses']} vs "
             f"{single['loss']}")
    if not abs(at_start - single["loss"][0]) <= \
            MESH_LOSS_TIGHT * abs(single["loss"][0]):
        fail(f"mesh train: the control's first loss {at_start} is not the "
             f"single-device run's {single['loss'][0]}")
    if not control_rel > MESH_LOSS_TIGHT:
        fail(f"mesh train: a run that did not update reads {control_rel}, "
             f"inside the losses' bound {MESH_LOSS_TIGHT}")
    if not max(rel) <= MESH_LOSS_TIGHT:
        fail(f"mesh train: losses {row['rank_losses']} vs "
             f"{single['loss']}: {max(rel)} relative, above "
             f"{MESH_LOSS_TIGHT}")
    if not row["param_max_abs_err"] <= bound:
        fail(f"mesh train: parameters {[c['params_over'] for c in checks]} "
             f"off the single-device run's by more than {bound}")
    if not moments[top] <= gated[top]:
        fail(f"mesh train: first moments off the single-device run's by "
             f"{moments[top]} of the leaf's largest |value| ({top}), above "
             f"{gated[top]}")
    want = cfg.n_layers * MESH_STEPS * step_options(options)[2]
    if not single_launches[0] == want == single_launches[1]:
        fail(f"mesh train: the single-device run launched flash "
             f"{single_launches}, expected {want}")
    for c in checks:
        if not (c["flash_launches"] == want
                == c["flash_tensor_core_launches"]):
            fail(f"mesh train: rank {c['rank']} launched flash "
                 f"{c['flash_launches']} times "
                 f"({c['flash_tensor_core_launches']} on the tensor "
                 f"cores), expected {want}")
        if any(step != count["collectives"] for step in c["collectives"]):
            fail(f"mesh train: rank {c['rank']} wire bytes "
                 f"{c['collectives']} vs the dry run's "
                 f"{count['collectives']}")
        if c["argument_bytes"] != count["argument_bytes"]:
            fail(f"mesh train: rank {c['rank']} argument bytes "
                 f"{c['argument_bytes']} vs the dry run's "
                 f"{count['argument_bytes']}")
        if not c["local_device"].startswith("cuda"):
            fail(f"mesh train: rank {c['rank']} ran on {c['local_device']}")
    if moe_phase_:
        for c in checks:
            if not all(step["all-to-all"] > 0 for step in c["collectives"]):
                fail(f"moe mesh: rank {c['rank']} issued no all-to-all: "
                     f"{c['collectives']}")
            if c["forwards"] != cfg.n_layers * MESH_STEPS:
                fail(f"moe mesh: rank {c['rank']} recorded {c['forwards']} "
                     "MoE calls")
    elif not options and not all(c["restore_bit_equal"] and
                                 c["restored_sharded_leaves"] > 0
                                 for c in checks):
        fail(f"mesh train: checkpoint restore onto the mesh {checks}")
    return row


def moe_mesh_phase() -> dict:
    """Phase 28 (module docstring): OLMoE-1B-7B cut to
    ``MOE_MESH_LAYERS`` layers through the mesh trainer with the MoE shard
    hints over 4 gloo ranks sharing the card, against the single-device
    trainer at the same dispatch groups and the dry run's count. Fatal on
    any failure; the single-device run's files are removed at the end."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_MESH_LAYERS,
                              moe_shard_hints=True)
    outdir = tempfile.mkdtemp(prefix="moe_mesh_")
    try:
        row = mesh_train_gates(cfg, outdir, "28")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    summary = {"moe_mesh_phase": "summary",
               "rank_flash_launches": sum(row["rank_flash_launches"]),
               "all_to_all_calls_per_step": row["dry_run_calls"][
                   "all-to-all"],
               "routing_flips_by_forward": row["routing_flips_by_forward"],
               "seconds": time.perf_counter() - t_phase, "card": row["card"]}
    print(json.dumps(summary), flush=True)
    return summary


def mamba_mesh_cfg():
    """Phase 29's cut of Jamba-1.5: one mamba block and its dense SwiGLU
    FFN (pattern position 1's form) at published widths."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(HYBRID_ARCH), pattern=("mamba",),
                               n_layers=1, n_experts=0)


def recurrent_trainer(cfg, mesh=None):
    """Phases 29's and 30's ``Trainer``: B 4, L 512, ``MESH_STEPS`` AdamW
    steps at ``MESH_LR`` with the launcher's schedule, the ``cuda``
    backend, seed 0; on ``mesh`` if given."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    ctx = ExecutionContext(target=H100, backend="cuda", device="cuda")
    return Trainer(cfg, AdamWConfig(lr=MESH_LR, warmup_steps=5,
                                    total_steps=MESH_STEPS),
                   TrainConfig(steps=MESH_STEPS, ctx=ctx, log_every=0),
                   DataConfig(batch_size=4, seq_len=512,
                              vocab_size=cfg.vocab_size), mesh=mesh)


@contextlib.contextmanager
def first_conv1d_launch():
    """Inside the ``with``: the conv1d kernel's first launch through the
    dispatcher's ``cuda`` entry, its inputs and output kept (copies, taken
    after the launch: no launch added)."""
    from repro_torch.ops import registry

    seen = {}
    launch = registry._conv1d_cuda

    def keep(x, w, **kw):
        out = launch(x, w, **kw)
        if not seen:
            seen.update(x=x.detach().clone(), w=w.detach().clone(),
                        out=out.detach().clone())
        return out

    registry._conv1d_cuda = keep
    try:
        yield seen
    finally:
        registry._conv1d_cuda = launch


def leaf_kind(name: str, pattern) -> str:
    """Phases 29's and 30's kinds of leaf: a block's by its kind in
    ``pattern`` (``mamba``, ``mlstm``, ``slstm``), the FFN's, the
    embedding and head, the norms."""
    if ".core." in name:
        return pattern[int(name.split(".")[2][1:])]
    if ".ffn." in name:
        return "ffn"
    return "embed_head" if name in ("embed", "head") else "norm"


def mamba_rank_main(rank: int, outdir: str) -> None:
    """One rank of phase 29: the mesh trainer on ``RECURRENT_MESH_SHAPE``
    over gloo (``RANK`` and the rest of ``torchrun``'s environment), the
    conv1d counts set to 0 just before its run and read just after, its
    first local conv1d launch kept, then its chunks against the
    single-device run's files in ``outdir``."""
    import torch.distributed as dist

    from repro_torch.kernels import KERNELS, conv1d_causal_plain
    from repro_torch.kernels.ref import conv1d_causal_ref
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=MESH_RANKS)
    mesh = make_host_mesh(*RECURRENT_MESH_SHAPE, device_type="cuda")
    trainer = recurrent_trainer(mamba_mesh_cfg(), mesh)
    k = KERNELS["conv1d_causal"]
    torch.cuda.reset_peak_memory_stats()
    k.launches = 0
    with first_conv1d_launch() as first:
        hist = trainer.run()
    launches = k.launches
    out = first["out"].float()
    # the plain version adds the taps in the kernel's order (expected
    # error 0); the aten oracle in its own, before the bf16 cast
    err = (out - conv1d_causal_plain(first["x"], first["w"]).float()
           ).abs().max().item()
    want = conv1d_causal_ref(first["x"], first["w"]).float()
    oracle = ((out - want).abs().max() / want.abs().max().clamp(min=1.0)
              ).item()
    report = {"rank": rank, "loss": hist["loss"],
              "step_time": hist["step_time"],
              "collectives": trainer.collectives,
              "conv1d_launches": launches,
              "first_launch": {"x": list(first["x"].shape),
                               "w": list(first["w"].shape),
                               "dtype": str(first["x"].dtype),
                               "max_abs_err": err,
                               "oracle_rel_err": oracle},
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 1e9,
              "memory_allocated_gb_after":
                  torch.cuda.memory_allocated() / 1e9,
              "argument_bytes": argument_bytes(
                  (trainer.params, trainer.opt_state,
                   trainer.place_batch(trainer.source.batch(0)))),
              "local_device": str(next(trainer.params.parameters())
                                  .to_local().device)}
    report.update(chunk_errors(trainer, single_files(outdir)))
    with open(os.path.join(outdir, f"checks{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def mamba_mesh_phase() -> dict:
    """Phase 29 (module docstring): Jamba-1.5's mamba block through the
    mesh trainer over 4 gloo ranks sharing the card, against the
    single-device trainer and the dry run's count. Fatal on any failure;
    the single-device run's files are removed at the end."""
    import shutil
    import tempfile

    from repro_torch.kernels import KERNELS
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.train.trainer import TrainConfig

    t_phase = time.perf_counter()
    cfg = mamba_mesh_cfg()
    with torch.device("meta"):
        n_params = sum(p.numel() for p in T.Transformer(cfg).parameters())
    card = smi()
    outdir = tempfile.mkdtemp(prefix="mamba_mesh_")
    try:
        at_start, control = no_update_loss(
            cfg, ExecutionContext(target=H100, backend="cuda",
                                  device="cuda"))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        k = KERNELS["conv1d_causal"]
        k.launches = 0
        trainer = recurrent_trainer(cfg)
        single = trainer.run()
        single_launches = k.launches
        single_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.save({n: p.detach().cpu() for n, p in
                    trainer.params.named_parameters()},
                   os.path.join(outdir, "single_params.pt"))
        torch.save({n: m.cpu() for n, m in trainer.opt_state.m.items()},
                   os.path.join(outdir, "single_m.pt"))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        count = dryrun.count_train_step(
            cfg, RECURRENT_MESH_SHAPE, {"tokens": torch.empty(
                (4, 512), dtype=torch.int32, device="meta")}, TrainConfig())
        t0 = time.perf_counter()
        env = dict(os.environ, WORLD_SIZE=str(MESH_RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   LOCAL_RANK="0")
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mamba-rank",
             str(r), outdir], env=dict(env, RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(MESH_RANKS)]
        logs = []
        try:
            for p in procs:
                left = MESH_TIMEOUT - (time.perf_counter() - t0)
                logs.append(p.communicate(timeout=max(left, 1.0))[0])
        except subprocess.TimeoutExpired:
            fail(f"mamba mesh: a rank did not finish in {MESH_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            fail("mamba mesh: rank exit codes "
                 f"{[p.returncode for p in procs]}:\n"
                 + "\n".join(logs)[-6000:])
        checks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(outdir, f"checks{r}.json")) as f:
                checks.append(json.load(f))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    bound = 2 * MESH_LR * MESH_STEPS
    rel = [abs(a - b) / abs(b) for c in checks
           for a, b in zip(c["loss"], single["loss"])]
    moments, params = {}, {}
    for c in checks:
        for name, err in c["moment_rel_err"].items():
            moments[name] = max(moments.get(name, 0.0), err)
        for name, err in c["param_abs_err"].items():
            params[name] = max(params.get(name, 0.0), err)
    top = max(moments, key=moments.get)
    by_kind = {}
    for name in moments:
        m, p = by_kind.setdefault(leaf_kind(name, cfg.pattern), [0.0, 0.0])
        by_kind[leaf_kind(name, cfg.pattern)] = [max(m, moments[name]),
                                    max(p, params[name])]
    control_rel = abs(control - single["loss"][1]) / abs(single["loss"][1])
    row = {"mamba_mesh_train": cfg.name, "phase": "29",
           "pattern": list(cfg.pattern), "layers": cfg.n_layers,
           "parameters": n_params,
           "mesh": {"data": RECURRENT_MESH_SHAPE[0],
                    "model": RECURRENT_MESH_SHAPE[1]},
           "ranks": MESH_RANKS, "backend": "gloo, one card",
           "batch": [4, 512], "steps": MESH_STEPS,
           "single_losses": single["loss"],
           "rank_losses": [c["loss"] for c in checks],
           "loss_max_rel_err": max(rel), "loss_bound": MESH_LOSS_TIGHT,
           "no_update_loss": control, "no_update_loss_rel_err": control_rel,
           "first_loss_recomputed": at_start,
           "single_step_s": single["step_time"],
           "rank_step_s": [c["step_time"] for c in checks],
           "param_max_abs_err": max(params.values()), "param_bound": bound,
           "moment_max_rel_err": moments[top], "moment_worst_leaf": top,
           "moment_bound": MESH_MOMENT_TOL,
           "worst_by_kind_moment_rel_param_abs": by_kind,
           "wire_bytes_per_step": checks[0]["collectives"][0],
           "dry_run_wire_bytes": count["collectives"],
           "dry_run_calls": count["calls"],
           "argument_bytes": [c["argument_bytes"] for c in checks],
           "dry_run_argument_bytes": count["argument_bytes"],
           "single_conv1d_launches": single_launches,
           "rank_conv1d_launches": [c["conv1d_launches"] for c in checks],
           "rank_first_launch": [c["first_launch"] for c in checks],
           "rank_max_memory_allocated_gb": [
               c["max_memory_allocated_gb"] for c in checks],
           "rank_memory_allocated_gb_after": [
               c["memory_allocated_gb_after"] for c in checks],
           "single_max_memory_allocated_gb": single_peak,
           "ranks_seconds": seconds, "card": card}
    print(json.dumps(row), flush=True)
    if not max(rel) <= 1e-2 or any(len(c["loss"]) != MESH_STEPS
                                   for c in checks):
        fail(f"mamba mesh: losses {row['rank_losses']} vs {single['loss']}")
    if not abs(at_start - single["loss"][0]) <= \
            MESH_LOSS_TIGHT * abs(single["loss"][0]):
        fail(f"mamba mesh: the control's first loss {at_start} is not the "
             f"single-device run's {single['loss'][0]}")
    if not control_rel > MESH_LOSS_TIGHT:
        fail(f"mamba mesh: a run that did not update reads {control_rel}, "
             f"inside the losses' bound {MESH_LOSS_TIGHT}")
    if not max(rel) <= MESH_LOSS_TIGHT:
        fail(f"mamba mesh: losses {row['rank_losses']} vs {single['loss']}: "
             f"{max(rel)} relative, above {MESH_LOSS_TIGHT}")
    if not row["param_max_abs_err"] <= bound:
        fail(f"mamba mesh: parameters {[c['params_over'] for c in checks]} "
             f"off the single-device run's by more than {bound}")
    if not moments[top] <= MESH_MOMENT_TOL:
        fail(f"mamba mesh: first moments off the single-device run's by "
             f"{moments[top]} of the leaf's largest |value| ({top}), above "
             f"{MESH_MOMENT_TOL}")
    want = cfg.n_layers * MESH_STEPS  # one launch a forward
    if single_launches != want:
        fail(f"mamba mesh: the single-device run launched conv1d "
             f"{single_launches} times, expected {want}")
    for c in checks:
        if c["conv1d_launches"] != want:
            fail(f"mamba mesh: rank {c['rank']} launched conv1d "
                 f"{c['conv1d_launches']} times, expected {want}")
        if c["first_launch"]["max_abs_err"] != 0.0 or not \
                c["first_launch"]["oracle_rel_err"] <= TOL[torch.bfloat16]:
            fail(f"mamba mesh: rank {c['rank']}'s conv1d launch "
                 f"{c['first_launch']} differs from its plain version (or "
                 "from the aten oracle past one bf16 rounding)")
        if any(step != count["collectives"] for step in c["collectives"]):
            fail(f"mamba mesh: rank {c['rank']} wire bytes "
                 f"{c['collectives']} vs the dry run's "
                 f"{count['collectives']}")
        if c["argument_bytes"] != count["argument_bytes"]:
            fail(f"mamba mesh: rank {c['rank']} argument bytes "
                 f"{c['argument_bytes']} vs the dry run's "
                 f"{count['argument_bytes']}")
        if not c["local_device"].startswith("cuda"):
            fail(f"mamba mesh: rank {c['rank']} ran on {c['local_device']}")
    summary = {"mamba_mesh_phase": "summary",
               "rank_conv1d_launches": sum(row["rank_conv1d_launches"]),
               "all_to_all_calls_per_step": count["calls"].get(
                   "all-to-all", 0),
               "seconds": time.perf_counter() - t_phase, "card": card}
    print(json.dumps(summary), flush=True)
    return summary


def xlstm_mesh_cfg():
    """Phase 30's cut of xLSTM-1.3B: ``XLSTM_MESH_LAYERS`` layers (two
    (mlstm, slstm) units) at published widths, computed in f32: in bf16
    the mesh's re-associated partial sums alone move xLSTM's first
    moments past any bound that tells a wrong run from a right one
    (``scripts/xlstm_mesh_bf16.py``)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(XLSTM_ARCH),
                               n_layers=XLSTM_MESH_LAYERS,
                               compute_dtype="float32")


def kernel_launches() -> dict:
    """Every hand-written kernel's launches since :func:`zero_counts`."""
    from repro_torch.kernels import KERNELS

    return {n: k.launches for n, k in KERNELS.items()}


def leaf_digest(t: torch.Tensor) -> str:
    """The sha256 of a leaf's bytes on the host."""
    import hashlib

    return hashlib.sha256(
        t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        .numpy().tobytes()
    ).hexdigest()


def xlstm_rank_main(rank: int, outdir: str) -> None:
    """One rank of phase 30: the mesh trainer on ``RECURRENT_MESH_SHAPE``
    over gloo (``RANK`` and the rest of ``torchrun``'s environment), every
    kernel's count set to 0 just before its run and read just after; its
    chunks against the single-device run's files in ``outdir``; then the
    checkpoint saved from the ranks (``Trainer.save_checkpoint``: rank 0
    writes it under ``outdir``/ckpt and the sha256 of each gathered
    leaf)."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint as ckpt

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=MESH_RANKS)
    mesh = make_host_mesh(*RECURRENT_MESH_SHAPE, device_type="cuda")
    trainer = recurrent_trainer(xlstm_mesh_cfg(), mesh)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    hist = trainer.run()
    launches = kernel_launches()
    report = {"rank": rank, "loss": hist["loss"],
              "step_time": hist["step_time"],
              "collectives": trainer.collectives,
              "kernel_launches": launches,
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 1e9,
              "memory_allocated_gb_after":
                  torch.cuda.memory_allocated() / 1e9,
              "argument_bytes": argument_bytes(
                  (trainer.params, trainer.opt_state,
                   trainer.place_batch(trainer.source.batch(0)))),
              "local_device": str(next(trainer.params.parameters())
                                  .to_local().device)}
    report.update(chunk_errors(trainer, single_files(outdir)))
    trainer.train_cfg.ckpt_dir = os.path.join(outdir, "ckpt")
    t0 = time.perf_counter()
    tree = trainer.save_checkpoint(MESH_STEPS)
    report.update(save_collectives=trainer.state_collectives,
                  save_s=time.perf_counter() - t0,
                  save_max_memory_allocated_gb=(
                      torch.cuda.max_memory_allocated() / 1e9))
    if rank == 0:
        report["digests"] = {k: leaf_digest(t) for k, t in
                             ckpt._flatten_with_paths(tree)}
    with open(os.path.join(outdir, f"checks{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def restored_digests(cfg, directory: str) -> dict:
    """The phase-30 checkpoint restored on the card (the state tree's
    template on the meta device): the sha256 of each leaf."""
    from repro_torch.convert import tree_from_named
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt

    with torch.device("meta"):
        named = dict(T.Transformer(cfg).named_parameters())
    f32 = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
           for n, p in named.items()}
    template = {"params": tree_from_named(named),
                "opt": (torch.zeros((), dtype=torch.int32, device="meta"),
                        tree_from_named(f32), tree_from_named(f32))}
    tree, _ = ckpt.restore(directory, template, device="cuda")
    out = {k: leaf_digest(t) for k, t in ckpt._flatten_with_paths(tree)}
    del tree
    torch.cuda.empty_cache()
    return out


def xlstm_mesh_phase() -> dict:
    """Phase 30 (module docstring): xLSTM-1.3B's blocks through the mesh
    trainer over 4 gloo ranks sharing the card, against the single-device
    trainer and the dry run's count, then a checkpoint saved from the
    ranks and restored on the card. Fatal on any failure; the files are
    removed at the end."""
    import shutil
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.train.trainer import TrainConfig

    t_phase = time.perf_counter()
    cfg = xlstm_mesh_cfg()
    with torch.device("meta"):
        n_params = sum(p.numel() for p in T.Transformer(cfg).parameters())
    card = smi()
    outdir = tempfile.mkdtemp(prefix="xlstm_mesh_")
    try:
        at_start, control = no_update_loss(
            cfg, ExecutionContext(target=H100, backend="cuda",
                                  device="cuda"))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = recurrent_trainer(cfg)
        zero_counts()
        single = trainer.run()
        single_launches = kernel_launches()
        single_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.save({n: p.detach().cpu() for n, p in
                    trainer.params.named_parameters()},
                   os.path.join(outdir, "single_params.pt"))
        torch.save({n: m.cpu() for n, m in trainer.opt_state.m.items()},
                   os.path.join(outdir, "single_m.pt"))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        count = dryrun.count_train_step(
            cfg, RECURRENT_MESH_SHAPE, {"tokens": torch.empty(
                (4, 512), dtype=torch.int32, device="meta")}, TrainConfig())
        t0 = time.perf_counter()
        env = dict(os.environ, WORLD_SIZE=str(MESH_RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   LOCAL_RANK="0")
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--xlstm-rank",
             str(r), outdir], env=dict(env, RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(MESH_RANKS)]
        logs = []
        try:
            for p in procs:
                left = MESH_TIMEOUT - (time.perf_counter() - t0)
                logs.append(p.communicate(timeout=max(left, 1.0))[0])
        except subprocess.TimeoutExpired:
            fail(f"xlstm mesh: a rank did not finish in {MESH_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            fail("xlstm mesh: rank exit codes "
                 f"{[p.returncode for p in procs]}:\n"
                 + "\n".join(logs)[-6000:])
        checks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(outdir, f"checks{r}.json")) as f:
                checks.append(json.load(f))
        torch.cuda.reset_peak_memory_stats()
        restored = restored_digests(cfg, os.path.join(outdir, "ckpt"))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    bound = 2 * MESH_LR * MESH_STEPS
    rel = [abs(a - b) / abs(b) for c in checks
           for a, b in zip(c["loss"], single["loss"])]
    moments, params = {}, {}
    for c in checks:
        for name, err in c["moment_rel_err"].items():
            moments[name] = max(moments.get(name, 0.0), err)
        for name, err in c["param_abs_err"].items():
            params[name] = max(params.get(name, 0.0), err)
    top = max(moments, key=moments.get)
    by_kind = {}
    for name in moments:
        kind = leaf_kind(name, cfg.pattern)
        m, p = by_kind.setdefault(kind, [0.0, 0.0])
        by_kind[kind] = [max(m, moments[name]), max(p, params[name])]
    control_rel = abs(control - single["loss"][1]) / abs(single["loss"][1])
    digests = checks[0]["digests"]
    differ = sorted(k for k in digests if restored.get(k) != digests[k])
    row = {"xlstm_mesh_train": cfg.name, "phase": "30",
           "pattern": list(cfg.pattern), "layers": cfg.n_layers,
           "parameters": n_params,
           "mesh": {"data": RECURRENT_MESH_SHAPE[0],
                    "model": RECURRENT_MESH_SHAPE[1]},
           "ranks": MESH_RANKS, "backend": "gloo, one card",
           "batch": [4, 512], "steps": MESH_STEPS,
           "single_losses": single["loss"],
           "rank_losses": [c["loss"] for c in checks],
           "loss_max_rel_err": max(rel), "loss_bound": MESH_LOSS_TIGHT,
           "no_update_loss": control, "no_update_loss_rel_err": control_rel,
           "first_loss_recomputed": at_start,
           "single_step_s": single["step_time"],
           "rank_step_s": [c["step_time"] for c in checks],
           "param_max_abs_err": max(params.values()), "param_bound": bound,
           "moment_max_rel_err": moments[top], "moment_worst_leaf": top,
           "moment_bound": MESH_MOMENT_TOL,
           "worst_by_kind_moment_rel_param_abs": by_kind,
           "wire_bytes_per_step": checks[0]["collectives"][0],
           "dry_run_wire_bytes": count["collectives"],
           "dry_run_calls": count["calls"],
           "argument_bytes": [c["argument_bytes"] for c in checks],
           "dry_run_argument_bytes": count["argument_bytes"],
           "single_kernel_launches": single_launches,
           "rank_kernel_launches": [c["kernel_launches"] for c in checks],
           "save_wire_bytes": [c["save_collectives"] for c in checks],
           "save_s": [c["save_s"] for c in checks],
           "checkpoint_leaves": len(digests),
           "restored_leaves_differ": differ[:5],
           "rank_max_memory_allocated_gb": [
               c["max_memory_allocated_gb"] for c in checks],
           "rank_memory_allocated_gb_after": [
               c["memory_allocated_gb_after"] for c in checks],
           "rank_save_max_memory_allocated_gb": [
               c["save_max_memory_allocated_gb"] for c in checks],
           "single_max_memory_allocated_gb": single_peak,
           "restore_max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "ranks_seconds": seconds, "card": card}
    print(json.dumps(row), flush=True)
    if not max(rel) <= 1e-2 or any(len(c["loss"]) != MESH_STEPS
                                   for c in checks):
        fail(f"xlstm mesh: losses {row['rank_losses']} vs {single['loss']}")
    if not abs(at_start - single["loss"][0]) <= \
            MESH_LOSS_TIGHT * abs(single["loss"][0]):
        fail(f"xlstm mesh: the control's first loss {at_start} is not the "
             f"single-device run's {single['loss'][0]}")
    if not control_rel > MESH_LOSS_TIGHT:
        fail(f"xlstm mesh: a run that did not update reads {control_rel}, "
             f"inside the losses' bound {MESH_LOSS_TIGHT}")
    if not max(rel) <= MESH_LOSS_TIGHT:
        fail(f"xlstm mesh: losses {row['rank_losses']} vs {single['loss']}: "
             f"{max(rel)} relative, above {MESH_LOSS_TIGHT}")
    if not row["param_max_abs_err"] <= bound:
        fail(f"xlstm mesh: parameters {[c['params_over'] for c in checks]} "
             f"off the single-device run's by more than {bound}")
    if not moments[top] <= MESH_MOMENT_TOL:
        fail(f"xlstm mesh: first moments off the single-device run's by "
             f"{moments[top]} of the leaf's largest |value| ({top}), above "
             f"{MESH_MOMENT_TOL}")
    # the blocks, the embedding and the loss dispatch no kernel
    if any(single_launches.values()):
        fail(f"xlstm mesh: the single-device run launched {single_launches}")
    for c in checks:
        if any(c["kernel_launches"].values()):
            fail(f"xlstm mesh: rank {c['rank']} launched "
                 f"{c['kernel_launches']}")
        if any(step != count["collectives"] for step in c["collectives"]):
            fail(f"xlstm mesh: rank {c['rank']} wire bytes "
                 f"{c['collectives']} vs the dry run's "
                 f"{count['collectives']}")
        if c["argument_bytes"] != count["argument_bytes"]:
            fail(f"xlstm mesh: rank {c['rank']} argument bytes "
                 f"{c['argument_bytes']} vs the dry run's "
                 f"{count['argument_bytes']}")
        if not c["local_device"].startswith("cuda"):
            fail(f"xlstm mesh: rank {c['rank']} ran on {c['local_device']}")
        if c["save_collectives"]["all-gather"] or not \
                c["save_collectives"]["all-reduce"]:
            fail(f"xlstm mesh: rank {c['rank']}'s checkpoint save issued "
                 f"{c['save_collectives']}, not all-reduces only")
    if not digests or differ or len(restored) != len(digests):
        fail(f"xlstm mesh: the checkpoint restored on the card differs from "
             f"rank 0's gathered leaves at {differ[:5]} ({len(restored)} "
             f"leaves restored, {len(digests)} digests)")
    summary = {"xlstm_mesh_phase": "summary",
               "rank_kernel_launches": sum(
                   sum(c["kernel_launches"].values()) for c in checks),
               "all_to_all_calls_per_step": count["calls"].get(
                   "all-to-all", 0),
               "checkpoint_leaves_bit_equal": len(digests),
               "seconds": time.perf_counter() - t_phase, "card": card}
    print(json.dumps(summary), flush=True)
    return summary


# phase 31: decode over a sequence-sharded cache on the card. Qwen2.5-3B at
# published widths and full depth; B 8 is one data group's share of
# decode_32k (128 rows over data 16), its 32,768-position cache split over
# RECURRENT_MESH_SHAPE's model axis (cache_specs), 8,192 positions a rank
SEQ_ARCH = "qwen2_5_3b"
SEQ_BATCH = 8
SEQ_LEN = 32768
SEQ_PROMPT = SEQ_LEN - 8  # the one-card prefill; the steps fill the rest
SEQ_STEPS = 8
SEQ_TIMEOUT = 600  # seconds for the ranks to finish


def stats_kernel_phase() -> dict:
    """Phase 31 (a) (module docstring): the flash launch with row
    statistics against its plain version at a rank's shard and at one
    card's cache (bf16: the tensor-core kernel, split over a cluster of
    CTAs), and at a rank's shard in f32 (the FMA kernel, not split), with
    a scalar, a per-row and a negative offset; the bf16 launches' times
    beside the plain version, the library's flash attention (which
    returns the log-sum-exp) and the bound; then one card's launch
    without statistics (bf16 out) against its plain version, timed beside
    ``F.scaled_dot_product_attention``. Returns the ``kernels`` line's
    entry (``launches`` set by phase 31 (b)). Fatal on any failure."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.flash_attention import (NEG_INF,
                                                     flash_attention,
                                                     flash_attention_plain,
                                                     launch_config)

    kern = KERNELS["flash_attention_stats"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)
    rows, fq, hd = SEQ_BATCH * 2, 8, 128  # (B x KV, g x Lq): Qwen's fold
    c = launch_config(fq, SEQ_LEN // MESH_RANKS, hd, 64, torch.bfloat16,
                      rows=rows)["warp_grid"][1]
    sym = template_symbol("flash_tc_kernel", hd, 64, c, True)  # the split's
    body = [t for f, t in sass_functions(kern.library_path()).items()
            if sym in f]
    hmma = body[0].count("HMMA") if len(body) == 1 else 0
    if hmma == 0:
        fail(f"flash stats: {sym} has no HMMA in its SASS")
    entry, worst = {}, 0.0
    shard_keys = SEQ_LEN // MESH_RANKS

    def split_launch(tag, k, cfg):
        """The launch just made was the key split: S 8, 128 CTAs in
        clusters of 8 (launch_config's, as the wrapper passed them)."""
        got = k.last_launch
        line = {"flash_split": tag, "split": cfg["split"],
                "ctas": cfg["ctas"], "grid": list(got["grid"]),
                "cluster": list(got["cluster"]), "symbol": sym,
                "hmma": hmma}
        print(json.dumps(line), flush=True)
        if cfg["split"] != 8 or cfg["ctas"] != 8 * rows or \
                got["grid"] != (*cfg["grid"], 1) or \
                got["cluster"] != cfg["cluster"]:
            fail(f"flash split: {tag}: {line}, launch_config {cfg}")
        return line

    for tag, Lk, dt in (("rank shard", shard_keys, torch.bfloat16),
                        ("one card", SEQ_LEN, torch.bfloat16),
                        ("rank shard, f32", shard_keys, torch.float32)):
        tc = dt == torch.bfloat16
        cfg = launch_config(fq, Lk, hd, 64, dt, rows=rows)
        q = torch.randn((rows, fq, hd), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((rows, Lk, hd), generator=gen,
                            device=dev).to(dt) for _ in "kv")
        offs = {"scalar": Lk - 1,
                "per-row": torch.randint(0, Lk, (rows,), generator=gen,
                                         device=dev, dtype=torch.int32),
                "negative": -5}  # a shard wholly past every query
        parts = {}
        for name, off in offs.items():
            n0, tc0 = kern.launches, kern.tensor_core_launches
            got = flash_attention(q, k, v, True, off, q_seq_len=1,
                                  stats=True)
            torch.cuda.synchronize()
            want = flash_attention_plain(q, k, v, True, off, 1, stats=True)
            acc_err = (got[0] - want[0]).abs().max().item()
            acc_tol = TOL[dt] * max(1.0, want[0].abs().max().item())
            m_rel = ((got[1] - want[1]).abs()
                     / want[1].abs().clamp(min=1.0)).max().item()
            l_rel = ((got[2] - want[2]).abs() / want[2]).max().item()
            line = {"flash_stats": tag, "offset": name, "rows": rows,
                    "folded_q": fq, "Lk": Lk, "hd": hd,
                    "acc_max_abs_err": acc_err, "acc_allowed": acc_tol,
                    "m_max_rel_err": m_rel, "l_max_rel_err": l_rel,
                    "bound": 1e-4, "launched": kern.launches == n0 + 1,
                    "tensor_core": kern.tensor_core_launches == tc0 + int(tc),
                    "hmma": hmma}
            print(json.dumps(line), flush=True)
            if not (acc_err <= acc_tol and m_rel <= 1e-4 and l_rel <= 1e-4
                    and line["launched"] and line["tensor_core"]):
                fail(f"flash stats: {tag}, {name} offset: {line}")
            if tc:
                split_launch(f"{tag}, {name} offset", kern, cfg)
            elif kern.last_launch["cluster"] != (1, 1, 1):
                fail(f"flash stats: {tag}: the FMA kernel was split")
            worst = max(worst, acc_err)
            parts[name] = got
        m_neg = parts["negative"][1]
        w = torch.exp(m_neg - torch.maximum(m_neg, parts["scalar"][1]))
        if not bool((m_neg == NEG_INF).all()) or not bool((w == 0).all()):
            fail(f"flash stats: {tag}: the shard past every query reports "
                 f"m in [{m_neg.min().item()}, {m_neg.max().item()}], "
                 f"merge weight up to {w.max().item()}")
        if not tc:
            continue
        # the decode launch (every key valid) and its yardstick: aten's
        # flash attention on the folded rows (it returns the log-sum-exp)
        qs, ks, vs = (t.reshape(1, rows, -1, hd) for t in (q, k, v))

        def run(q=q, k=k, v=v, Lk=Lk):
            return flash_attention(q, k, v, True, Lk - 1, q_seq_len=1,
                                   stats=True)

        def run_lib(qs=qs, ks=ks, vs=vs):
            return torch.ops.aten._scaled_dot_product_flash_attention(
                qs, ks, vs, scale=hd ** -0.5)

        ms = median_ms(run, 3, 20)
        nbytes = (2 * k.numel() + q.numel()) * 2 + rows * fq * (hd + 2) * 4
        bms, by = bound_ms(4.0 * rows * fq * Lk * hd, nbytes,
                           PEAK_BF16_FLOPS)
        times = {"ms": ms, "ms_per_launch": per_launch_ms(run),
                 "device_ms_per_call": graph_ms_per_call(run),
                 "plain_ms": median_ms(lambda: flash_attention_plain(
                     q, k, v, True, Lk - 1, 1, stats=True), 1, 3),
                 "library_ms": median_ms(run_lib, 3, 20),
                 "library_ms_per_launch": per_launch_ms(run_lib),
                 "library_device_ms_per_call": graph_ms_per_call(run_lib),
                 "bound_ms": bms, "bound_by": by,
                 "kv_bytes": 2 * k.numel() * 2,
                 "gbytes_per_s": nbytes / ms / 1e6}
        times.update(split=cfg["split"], ctas=cfg["ctas"])
        print(json.dumps({"flash_stats_times": tag, **times,
                          "card": smi()}), flush=True)
        entry[tag] = times
        if tag == "one card":
            entry["one card, bf16 out"] = one_card_plain(
                q, k, v, cfg, split_launch)
        del q, k, v, parts
        torch.cuda.empty_cache()
    shard = entry["rank shard"]
    return {"name": "flash_attention_stats", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:96",
            "max_abs_err": worst, "ms": shard["ms"],
            "plain_ms": shard["plain_ms"], "bound_ms": shard["bound_ms"],
            "bound_by": shard["bound_by"],
            "library_ms": shard["library_ms"],
            "ms_per_launch": shard["ms_per_launch"],
            "device_ms_per_call": shard["device_ms_per_call"],
            "library_ms_per_launch": shard["library_ms_per_launch"],
            "library_device_ms_per_call": shard["library_device_ms_per_call"],
            "library_call":
                "torch.ops.aten._scaled_dot_product_flash_attention",
            "one_card": entry["one card"],
            "one_card_bf16_out": entry["one card, bf16 out"],
            "split": shard["split"], "ctas": shard["ctas"], "ok": True,
            "shapes": f"rank shard: {rows} rows x {fq} folded queries, "
                      f"{SEQ_LEN // MESH_RANKS} keys, hd {hd}, bf16 in, f32 "
                      "out with row max and sum"}


def one_card_plain(q, k, v, cfg, split_launch) -> dict:
    """Phase 31 (a)'s last check: one card's launch without statistics
    (bf16 out) over the whole 32,768-key cache (16 folded rows of 8
    queries, every key valid), as phase 31 (b)'s one-card step launches
    it, against its plain version (2^-7), on the key split, timed (a call,
    a launch, device) beside ``F.scaled_dot_product_attention`` on the
    same folded rows (each row a head: the same function with every key
    valid) and the bound. Fatal on any failure."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    kern = KERNELS["flash_attention"]
    rows, fq, hd = q.shape
    Lk = k.shape[1]
    n0, tc0 = kern.launches, kern.tensor_core_launches
    got = flash_attention(q, k, v, True, Lk - 1, q_seq_len=1)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, True, Lk - 1, 1)
    err = (got.float() - want.float()).abs().max().item()
    allowed = TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item())
    line = split_launch("one card, bf16 out", kern, cfg)
    if not (err <= allowed and kern.launches == n0 + 1
            and kern.tensor_core_launches == tc0 + 1):
        fail(f"flash split: one card, bf16 out: max abs err {err} (allowed "
             f"{allowed}), launches {kern.launches - n0}, tensor core "
             f"{kern.tensor_core_launches - tc0}")
    qs, ks, vs = (t.reshape(1, rows, -1, hd) for t in (q, k, v))

    def run():
        return flash_attention(q, k, v, True, Lk - 1, q_seq_len=1)

    def run_lib():
        return F.scaled_dot_product_attention(qs, ks, vs)

    lib = run_lib()
    lib_err = (lib.reshape(got.shape).float() - want.float()).abs().max()
    ms = median_ms(run, 3, 20)
    nbytes = (2 * k.numel() + 2 * q.numel()) * 2
    bms, by = bound_ms(4.0 * rows * fq * Lk * hd, nbytes, PEAK_BF16_FLOPS)
    times = {"flash_one_card": "bf16 out", "rows": rows, "folded_q": fq,
             "Lk": Lk, "hd": hd, "max_abs_err": err, "allowed": allowed,
             "library_max_abs_err": lib_err.item(), "ms": ms,
             "ms_per_launch": per_launch_ms(run),
             "device_ms_per_call": graph_ms_per_call(run),
             "plain_ms": median_ms(lambda: flash_attention_plain(
                 q, k, v, True, Lk - 1, 1), 1, 3),
             "library_ms": median_ms(run_lib, 3, 20),
             "library_ms_per_launch": per_launch_ms(run_lib),
             "library_device_ms_per_call": graph_ms_per_call(run_lib),
             "library_call": "F.scaled_dot_product_attention",
             "bound_ms": bms, "bound_by": by, "split": line["split"],
             "ctas": line["ctas"], "gbytes_per_s": nbytes / ms / 1e6}
    print(json.dumps({**times, "card": smi()}), flush=True)
    return times


def seq_decode_rank_main(rank: int, outdir: str) -> None:
    """One rank of phase 31 (b): Qwen2.5-3B's parameters placed as they are
    made (``placed_as_made``: a quarter of every ``model``-sharded leaf),
    its shard of the one-card cache from the parent through CUDA IPC (no
    gloo), then ``SEQ_STEPS`` decode steps through
    ``launch.dryrun.build_decode_step`` on the ``cuda`` backend, teacher
    forced on the one card's tokens, every kernel's count set to 0 just
    before and read just after, each step's collectives counted
    (``CostMode``, the gloo guard on); its logits (made whole by
    all-reduces after each step) against the one card's."""
    import pickle

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import dtensors
    from repro_torch.analysis.roofline import CostMode, collective_bytes
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.train.trainer import placed_as_made

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=MESH_RANKS)
    mesh = make_host_mesh(*RECURRENT_MESH_SHAPE, device_type="cuda")
    cfg = get_config(SEQ_ARCH)
    with placed_as_made(cfg, mesh):
        params = T.init_params(cfg, seed=SEED, device="cuda")
    cspecs = shd.shardings(mesh, shd.cache_specs(cfg, mesh, SEQ_BATCH,
                                                 SEQ_LEN))
    leaf = (cfg.repeats, SEQ_BATCH, cfg.n_kv_heads, SEQ_LEN, cfg.hd)
    seq = cspecs["b0"]["k"].local_slices(leaf)[3]
    shard = seq.start // (seq.stop - seq.start)
    with open(os.path.join(outdir, f"shard{shard}.ipc"), "rb") as f:
        local = pickle.load(f)  # the parent's tensors, mapped (CUDA IPC)
    shard_bytes = sum(t.numel() * t.element_size()
                      for leaves in local.values() for t in leaves.values())
    cache = {b: {n: DTensor.from_local(t, mesh, cspecs[b][n].placements,
                                       run_check=False)
                 for n, t in leaves.items()} for b, leaves in local.items()}
    single = torch.load(os.path.join(outdir, "single.pt"))
    tok_sh = shd.NamedSharding(mesh, shd.P(shd.batch_axes(mesh), None))
    step = dr.build_decode_step(cfg, math.gcd(SEQ_BATCH, MESH_RANKS),
                                ctx=ExecutionContext(target=H100,
                                                     backend="cuda"))
    allowance = logit_allowance(cfg.n_layers)
    report = {"rank": rank, "shard": [seq.start, seq.stop],
              "logit_err": [], "logit_allowed": [], "collectives": [],
              "step_s": [], "local_device": str(
                  next(params.parameters()).to_local().device)}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for i in range(SEQ_STEPS):
        tok = tok_sh.place(single["tokens"][i][:, None].cuda())
        if i == 0:
            report["argument_bytes"] = dr.argument_bytes(
                (params, cache, tok, SEQ_PROMPT))
        count = CostMode(counts_only=True, check=dtensors.gloo_guard)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count:
            logits, cache = step(params, cache, tok, SEQ_PROMPT + i)
        torch.cuda.synchronize()
        report["step_s"].append(time.perf_counter() - t0)
        report["collectives"].append(collective_bytes(count.collectives))
        got = dtensors.whole(logits).float().cpu()
        want = single["logits"][i]
        report["logit_err"].append((got - want).abs().max().item())
        report["logit_allowed"].append(allowance(want))
        report["finite"] = (report.get("finite", True)
                            and bool(torch.isfinite(got).all()))
    report["kernel_launches"] = kernel_launches()
    report["tensor_core_launches"] = {n: k.tensor_core_launches
                                      for n, k in KERNELS.items()}
    report["max_memory_allocated_gb"] = (torch.cuda.max_memory_allocated()
                                         / 1e9)
    report["shard_gb"] = shard_bytes / 1e9
    with open(os.path.join(outdir, f"checks{rank}.json"), "w") as f:
        json.dump(report, f)
    del cache, local
    dist.destroy_process_group()


def seq_decode_phase(stats: dict) -> dict:
    """Phase 31 (b) (module docstring): Qwen2.5-3B decoded over a cache
    sharded along its sequence on 4 gloo ranks sharing the card, against
    one card and the dry run's count of the step. ``stats`` is phase 31
    (a)'s ``kernels`` entry; its ``launches`` are set here. Fatal on any
    failure; the files and the shared shards are released at the end."""
    import shutil
    import tempfile
    from multiprocessing.reduction import ForkingPickler

    import torch.multiprocessing  # noqa: F401  (CUDA tensors' IPC reducer)

    from repro_torch import dtensors
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import lm_logits
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100

    t_phase = time.perf_counter()
    card = smi()
    cfg = get_config(SEQ_ARCH)
    ctx = ExecutionContext(target=H100, backend="cuda")
    outdir = tempfile.mkdtemp(prefix="seq_decode_")
    shards = []
    try:
        t0 = time.perf_counter()
        with dtensors.all_reduce_gathers():  # what gloo runs on the card
            count = dr.count_decode_step(cfg, RECURRENT_MESH_SHAPE,
                                         SEQ_BATCH, SEQ_LEN, SEQ_PROMPT)
        count_s = time.perf_counter() - t0
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 32)
        params = T.init_params(cfg, seed=SEED, device="cuda")
        cache = T.init_cache(cfg, SEQ_BATCH, SEQ_LEN, device="cuda")
        prompt = torch.randint(0, cfg.vocab_size, (SEQ_BATCH, SEQ_PROMPT),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = []
        with torch.no_grad():
            # a row at a time: at B 8 one (B, L, d_ff) activation is 5.8 GB
            for b in range(SEQ_BATCH):
                row = {blk: {n: t[:, b:b + 1] for n, t in leaves.items()}
                       for blk, leaves in cache.items()}
                x, _, _ = T.hidden_forward(params, cfg,
                                           tokens=prompt[b:b + 1],
                                           cache=row, cache_index=0, ctx=ctx)
                first.append(lm_logits(params.head, x[:, -1:],
                                       torch.bfloat16)[:, -1].float()
                             .argmax(-1))
                del x
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        # each rank's shard of the filled cache, shared through CUDA IPC
        n = SEQ_LEN // MESH_RANKS
        for j in range(MESH_RANKS):
            shards.append({blk: {nm: t[:, :, :, j * n:(j + 1) * n]
                                 .contiguous() for nm, t in leaves.items()}
                           for blk, leaves in cache.items()})
            with open(os.path.join(outdir, f"shard{j}.ipc"), "wb") as f:
                f.write(ForkingPickler.dumps(shards[-1]))
        step = dr.build_decode_step(cfg, math.gcd(SEQ_BATCH, MESH_RANKS),
                                    ctx=ctx)
        tok = torch.cat(first).to(torch.int32)
        toks, logits, single_s = [], [], []
        zero_counts()
        for i in range(SEQ_STEPS):
            toks.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = step(params, cache, tok[:, None], SEQ_PROMPT + i)
            torch.cuda.synchronize()
            single_s.append(time.perf_counter() - t0)
            logits.append(lg.float().cpu())
            tok = lg.float().argmax(-1).to(torch.int32)
        single_launches = kernel_launches()
        single_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.save({"tokens": torch.stack(toks).cpu(),
                    "logits": torch.stack(logits)},
                   os.path.join(outdir, "single.pt"))
        del params, cache, step, lg, prompt
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        env = dict(os.environ, WORLD_SIZE=str(MESH_RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   LOCAL_RANK="0")
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--seqdec-rank",
             str(r), outdir], env=dict(env, RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(MESH_RANKS)]
        logs = []
        try:
            for p in procs:
                left = SEQ_TIMEOUT - (time.perf_counter() - t0)
                logs.append(p.communicate(timeout=max(left, 1.0))[0])
        except subprocess.TimeoutExpired:
            fail(f"seq decode: a rank did not finish in {SEQ_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            fail("seq decode: rank exit codes "
                 f"{[p.returncode for p in procs]}:\n"
                 + "\n".join(logs)[-6000:])
        checks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(outdir, f"checks{r}.json")) as f:
                checks.append(json.load(f))
    finally:
        shards.clear()
        shutil.rmtree(outdir, ignore_errors=True)
        torch.cuda.empty_cache()
    per_step = cfg.n_layers * SEQ_STEPS
    row = {"seq_decode": cfg.name, "phase": "31", "layers": cfg.n_layers,
           "mesh": {"data": RECURRENT_MESH_SHAPE[0],
                    "model": RECURRENT_MESH_SHAPE[1]},
           "ranks": MESH_RANKS, "backend": "gloo, one card",
           "batch": SEQ_BATCH, "cache": SEQ_LEN, "prompt": SEQ_PROMPT,
           "steps": SEQ_STEPS, "shards": [c["shard"] for c in checks],
           "rank_logit_max_err": [max(c["logit_err"]) for c in checks],
           "logit_allowed": checks[0]["logit_allowed"],
           "rank_logit_err_per_step": checks[0]["logit_err"],
           "wire_bytes_per_step": checks[0]["collectives"][0],
           "dry_run_wire_bytes": count["collectives"],
           "dry_run_calls": count["calls"],
           "argument_bytes": [c["argument_bytes"] for c in checks],
           "dry_run_argument_bytes": count["argument_bytes"],
           "dry_run_count_s": count_s,
           "rank_kernel_launches": [c["kernel_launches"] for c in checks],
           "rank_tensor_core_launches": [c["tensor_core_launches"]
                                         for c in checks],
           "single_kernel_launches": single_launches,
           "prefill_s": prefill_s, "single_step_s": single_s,
           "rank_step_s": [c["step_s"] for c in checks],
           "rank_gb": [c["max_memory_allocated_gb"] + c["shard_gb"]
                       for c in checks],
           "rank_shard_gb": checks[0]["shard_gb"],
           "single_max_memory_allocated_gb": single_peak,
           "ranks_seconds": ranks_s, "card": card}
    print(json.dumps(row), flush=True)
    for c in checks:
        r = c["rank"]
        if not c["finite"] or len(c["logit_err"]) != SEQ_STEPS or any(
                e > a for e, a in zip(c["logit_err"], c["logit_allowed"])):
            fail(f"seq decode: rank {r}'s logits {c['logit_err']} vs one "
                 f"card's, allowed {c['logit_allowed']}")
        kl, tc = c["kernel_launches"], c["tensor_core_launches"]
        if kl["flash_attention_stats"] != per_step or \
                tc["flash_attention_stats"] != per_step or any(
                    v for k, v in kl.items() if k != "flash_attention_stats"):
            fail(f"seq decode: rank {r} launched {kl} ({tc} on the tensor "
                 f"cores), not {per_step} stats launches alone")
        if any(s != count["collectives"] for s in c["collectives"]) or \
                set(count["calls"]) != {"all-reduce"}:
            fail(f"seq decode: rank {r} wire bytes {c['collectives']} vs "
                 f"the dry run's {count['collectives']} "
                 f"({count['calls']}): all-reduces only")
        if c["argument_bytes"] != count["argument_bytes"]:
            fail(f"seq decode: rank {r} argument bytes "
                 f"{c['argument_bytes']} vs the dry run's "
                 f"{count['argument_bytes']}")
        if not c["local_device"].startswith("cuda"):
            fail(f"seq decode: rank {r} ran on {c['local_device']}")
    if single_launches["flash_attention"] != per_step or any(
            v for k, v in single_launches.items() if k != "flash_attention"):
        fail(f"seq decode: one card launched {single_launches}, not "
             f"{per_step} flash launches alone")
    stats["launches"] = checks[0]["kernel_launches"]["flash_attention_stats"]
    stats["tensor_core_launches"] = checks[0]["tensor_core_launches"][
        "flash_attention_stats"]
    stats["rank_launches"] = [c["kernel_launches"]["flash_attention_stats"]
                              for c in checks]
    summary = {"seq_decode_phase": "summary",
               "rank_stats_launches": sum(stats["rank_launches"]),
               "all_reduce_calls_per_step": count["calls"]["all-reduce"],
               "seconds": time.perf_counter() - t_phase, "card": card}
    print(json.dumps(summary), flush=True)
    return summary


def main() -> None:
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch import ops
    from repro_torch.core.conv_model import resnet50_layers
    from repro_torch.kernels import KERNELS, conv2d_plain, matmul_plain
    from repro_torch.kernels._build import build_all, nvcc_path
    from repro_torch.kernels.conv2d import conv2d as conv2d_kernel
    from repro_torch.kernels.im2col import im2col_patches
    from repro_torch.kernels.matmul import matmul as matmul_kernel
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {nvcc[-1]}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    # -- 2. build -----------------------------------------------------------
    secs = build_all(KERNELS.values())
    print(f"build: {json.dumps(secs)} seconds (parallel nvcc)", flush=True)
    for name, k in KERNELS.items():
        # the int8 entries share quant.cu's build: report each one's kernels
        regs, spills = ptxas(k.build_log, {"conv2d_q": "conv2d_q_tc_kernel",
                                           "matmul_q": "matmul_q_tc_kernel"}
                             .get(name, ""))
        print(f"build {name}: registers per thread {regs}; "
              f"spilling variants {spills}", flush=True)
    # the bf16 paths of the GEMM and the direct conv: every tensor-core
    # variant holds HMMA in its SASS (the product runs on the tensor cores);
    # those the main path takes (f32 out) must not spill
    from repro_torch.kernels.conv2d import LINEAR as CONV_LINEAR
    from repro_torch.kernels.conv2d import TC_VARIANTS as CONV_VARIANTS
    from repro_torch.kernels.conv2d import launch_config as conv_config
    from repro_torch.kernels.matmul import (LINEAR, LINEAR_TILES,
                                            TC_VARIANTS)
    from repro_torch.kernels.flash_attention import (flash_split_instances,
                                                     flash_tc_instances)
    from repro_torch.kernels.matmul import launch_config as mm_config
    layers = resnet50_layers(BATCH)
    main_variants = {mm_config(*t, 2, mnk[2])["variant"] for mnk, t in
                     map(gemm_tiles, layers.values())}
    tc_variants("matmul", "matmul_tc_kernel", *gemm_like_variants(
        TC_VARIANTS + ((1, LINEAR_TILES),), main_variants, LINEAR))
    main_variants = set()
    for s in layers.values():
        t, (h_in, w_in) = conv_tiles(s)
        main_variants.add(conv_config(t, s.h_F, s.w_F, h_in, w_in, 2,
                                      s.c_I)["variant"])
    tc_variants("conv2d", "conv2d_tc_kernel", *gemm_like_variants(
        CONV_VARIANTS + ((1, LINEAR_TILES),), main_variants, CONV_LINEAR))
    # flash attention's bf16 kernel: every (hd, block, C) instance, without
    # and with the key split; the main path takes hd 128 at block 64 (C 1 at
    # prefill, 4 at decode, 2 at the hybrid's short prefills, 4 split at
    # phase 31's long caches) and, training HuBERT-xLarge, hd 80 at block 64
    flash_variants = [(f"(hd {hd}, block {b}, C {c}{', split' if sp else ''})",
                       (hd, b, c, sp))
                      for sp, inst in ((False, flash_tc_instances()),
                                       (True, flash_split_instances()))
                      for hd, b, c in inst]
    tc_variants("flash_attention", "flash_tc_kernel", flash_variants,
                {label for label, (hd, b, _, _) in flash_variants
                 if (hd, b) in ((128, 64), (80, 64))})
    # paged decode's bf16 kernel: HMMA in every head-dim instance; the main
    # path's (hd 128) must not spill
    from repro_torch.kernels.flash_attention import PAGED_HEAD_DIMS
    tc_variants("paged_decode", "paged_decode_tc_kernel",
                [(f"(hd {hd})", (hd,)) for hd in PAGED_HEAD_DIMS],
                {"(hd 128)"})
    # the int8 GEMM: IMMA (mma.sync s8) in every instance; the variant of
    # phase 11's plans, (128, 256) and (256, 128), with bf16 out must not
    # spill
    from repro_torch.kernels.quant import LINEAR as MMQ_LINEAR
    from repro_torch.kernels.quant import TC_VARIANTS as MMQ_VARIANTS
    from repro_torch.kernels.quant import matmul_launch_config
    main_variants = {matmul_launch_config(*int8_gemm_tiles(m, k, n), k)
                     ["variant"] for m, k, n in INT8_GEMMS.values()}
    tc_variants("matmul_q", "matmul_q_tc_kernel", *gemm_like_variants(
        MMQ_VARIANTS + ((1, LINEAR_TILES),), main_variants, MMQ_LINEAR,
        main_out="bf16"), opcode="IMMA")
    # the int8 conv: IMMA in every instance; the variant of phase 10's plans
    # with bf16 out must not spill
    from repro_torch.kernels.quant import conv_launch_config
    main_variants = set()
    for s in layers.values():
        t, (h_in, w_in) = conv_tiles(s, (0.25, 0.25, 0.5))
        hw = ((s.h_O - 1) * s.sh + s.h_F, (s.w_O - 1) * s.sw + s.w_F)
        main_variants.add(conv_launch_config(t, s.h_F, s.w_F, h_in, w_in,
                                             s.c_I, hw)["variant"])
    tc_variants("conv2d_q", "conv2d_q_tc_kernel", *gemm_like_variants(
        MMQ_VARIANTS + ((1, LINEAR_TILES),), main_variants, MMQ_LINEAR,
        main_out="bf16"), opcode="IMMA")

    max_err = {name: 0.0 for name in KERNELS}

    # every phase's decisions, checked at its end: an organic fault must
    # never pass as a demotion (phase 25 alone plants faults)
    quiet = contextlib.ExitStack()
    decisions = quiet.enter_context(ops.record_dispatch())

    def no_quiet_degradation(phases: str) -> None:
        bad = [d for d in decisions if d.degraded]
        if bad or ops.quarantined():
            fail(f"phases {phases}: degraded decisions {bad[:3]}, quarantine "
                 f"{ops.quarantined()}")
        print(f"phases {phases}: {len(decisions)} dispatch decisions, none "
              "degraded; the quarantine table is empty", flush=True)
        decisions.clear()
        cycle_check(phases)

    def record(name, got, want, what):
        err, allowed = rel_err(got, want)
        print(f"check {name} {what}: max_abs_err {err:.3e} "
              f"(allowed {allowed:.3e})", flush=True)
        if not err <= allowed:
            fail(f"{name} {what} disagrees with its plain version")
        max_err[name] = max(max_err[name], err)
        return err

    # -- 3. kernels against their plain versions ----------------------------
    gen.manual_seed(SEED)
    ctx_plan = ExecutionContext(target=H100, backend="cuda")
    conv_cases = [  # (N, c_I, c_O, H, W, h_F, w_F, sh, sw, tiles)
        (2, 4, 8, 25, 25, 3, 3, 1, 1, (1, 4, 8, 5, 7)),   # ragged h/w tiles
        (2, 4, 8, 25, 25, 3, 3, 2, 2, (2, 4, 8, 1, 23)),  # stride 2
        (2, 4, 8, 25, 25, 3, 3, 2, 1, (1, 4, 8, 23, 4)),
        (3, 5, 7, 11, 13, 3, 5, 1, 2, None),              # ragged c_I, c_O
        (4, 3, 32, 20, 20, 7, 7, 2, 2, None),             # c_I = 3, 7x7/2
        (2, 6, 8, 16, 16, 1, 1, 2, 2, (1, 6, 8, 3, 5)),   # h_F = 1
        # c_I = 40 over stages of 16 (the last ragged): whole planes
        # (16-byte copies), and rows of a 4-byte pitch with ragged h/w tiles
        (3, 40, 48, 12, 12, 3, 3, 1, 1, (2, 16, 32, 10, 10)),
        (3, 40, 48, 16, 16, 3, 3, 1, 1, (2, 16, 32, 6, 6)),
        (2, 32, 40, 30, 30, 3, 3, 1, 1, (1, 16, 32, 28, 14)),  # 392 rows
        (6, 40, 70, 9, 9, 3, 3, 1, 1, (5, 32, 64, 7, 7)),      # conv5_x's
        (4, 3, 64, 229, 229, 7, 7, 2, 2, (2, 3, 32, 16, 16)),  # conv1's
    ]
    for dt in (torch.float32, torch.bfloat16):
        kind = "tensor core" if dt == torch.bfloat16 else "fma"
        for od in (torch.float32, torch.bfloat16):
            for (N, cI, cO, H, W, hF, wF, sh, sw, tiles) in conv_cases:
                x = randn((N, cI, H, W), dt)
                w = randn((cO, cI, hF, wF), dt, (cI * hF * wF) ** -0.5)
                tc = KERNELS["conv2d"].tensor_core_launches
                got = conv2d_kernel(x, w, (sh, sw), out_dtype=od,
                                    tiles=tiles)
                torch.cuda.synchronize()
                path = ("tensor core" if KERNELS["conv2d"].tensor_core_launches
                        > tc else "fma")
                if path != kind:
                    fail(f"conv2d {dt} {(N, cI, cO, H, W)} took the {path} "
                         "kernel")
                record("conv2d", got, conv2d_plain(x, w, (sh, sw), od),
                       f"{dt}->{od} {(N, cI, cO, H, W, hF, wF, sh, sw)} "
                       f"tiles {tiles} on {path}")
            for (m, n, k, tiles) in [(100, 300, 77, None),
                                     (130, 257, 129, None),
                                     (1, 128, 64, None),
                                     (130, 257, 129, (32, 48, 16)),
                                     # conv1's 294-byte pitch and tiles
                                     (3000, 64, 147, (128, 64, 144)),
                                     # k = 3.25 stage spans of 64
                                     (1000, 96, 208, None),
                                     (5, 200, 96, None),  # m < 16
                                     # an odd pitch over several spans
                                     (257, 72, 1001, None)]:
                a = randn((m, k), dt)
                b = randn((k, n), dt, k ** -0.5)
                tc = KERNELS["matmul"].tensor_core_launches
                got = matmul_kernel(a, b, out_dtype=od, tiles=tiles)
                torch.cuda.synchronize()
                path = ("tensor core" if KERNELS["matmul"].tensor_core_launches
                        > tc else "fma")
                if path != ("tensor core" if dt == torch.bfloat16 else "fma"):
                    fail(f"matmul {dt} {(m, n, k)} took the {path} kernel")
                record("matmul", got, matmul_plain(a, b, od),
                       f"{dt}->{od} {(m, n, k)} tiles {tiles} on {path}")
    # bf16 inputs whose base is 2, 4 or 8 bytes past a 16-byte boundary:
    # the wrapper realigns them with one copy for the tensor-core kernel's
    # 16-byte window copies
    for off in (1, 2, 4):
        for (N, cI, cO, H, W, hF, wF, sh, sw, tiles) in conv_cases[-4:]:
            n = N * cI * H * W
            x = randn((n + 8,), torch.bfloat16)[off:off + n].view(N, cI, H, W)
            w = randn((cO, cI, hF, wF), torch.bfloat16, (cI * hF * wF) ** -0.5)
            got = conv2d_kernel(x, w, (sh, sw), tiles=tiles)
            torch.cuda.synchronize()
            record("conv2d", got, conv2d_plain(x, w, (sh, sw)),
                   f"bf16 at +{2 * off} bytes {(N, cI, cO, H, W)} tiles "
                   f"{tiles}")
    # narrow convs (few output channels, many pixels a tile): their H100
    # plans take the LINEAR warp layout, which no rectangular block covers
    for (N, cI, cO, H) in NARROW_CONVS:
        x = randn((N, cI, H, H), torch.bfloat16)
        w = randn((cO, cI, 3, 3), torch.bfloat16, (cI * 9) ** -0.5)
        tiles, (h_in, w_in) = conv_tiles(_Shape(N, cI, cO, H - 2, H - 2))
        cfg = conv_config(tiles, 3, 3, h_in, w_in, 2, cI, (H, H))
        if cfg["variant"] != CONV_LINEAR:
            fail(f"conv2d narrow {(N, cI, cO, H)}: plan {tiles} took variant "
                 f"{cfg['variant']}, not LINEAR")
        for od in (torch.float32, torch.bfloat16):
            tc = KERNELS["conv2d"].tensor_core_launches
            got = conv2d_kernel(x, w, out_dtype=od, ctx=ctx_plan)
            torch.cuda.synchronize()
            if KERNELS["conv2d"].tensor_core_launches != tc + 1:
                fail(f"conv2d narrow {(N, cI, cO, H)} was not a tensor-core "
                     "launch")
            record("conv2d", got, conv2d_plain(x, w, (1, 1), od),
                   f"narrow bf16->{od} {(N, cI, cO, H, H, 3, 3)} plan "
                   f"{tiles} on tensor core, LINEAR ({cfg['threads'] // 32} "
                   f"warps, {cfg['rows']} x {cfg['cols']} covered)")
    # main-path shapes: conv1, conv2_x and conv5_x at full batch, and the
    # GEMM of conv5_x's Im2Col
    for name in ("conv1", "conv2_x", "conv5_x"):
        s = layers[name]
        x, w = layer_inputs(gen, list(layers).index(name), s)
        got = conv2d_kernel(x, w, (s.sh, s.sw), ctx=ctx_plan)
        torch.cuda.synchronize()
        for sl in (slice(0, BLOCK), slice(BATCH - BLOCK, BATCH)):
            record("conv2d", got[sl], conv2d_plain(x[sl], w, (s.sh, s.sw)),
                   f"{name} images {sl.start}..{sl.stop - 1}")
        del x, w, got
    torch.cuda.empty_cache()
    a = randn((BATCH * 49, 4608), torch.bfloat16)
    b = randn((4608, 512), torch.bfloat16, 4608 ** -0.5)
    got = matmul_kernel(a, b, ctx=ctx_plan)
    torch.cuda.synchronize()
    for sl in (slice(0, 4096), slice(BATCH * 49 - 4096, BATCH * 49)):
        record("matmul", got[sl], matmul_plain(a[sl], b),
               f"conv5_x GEMM rows {sl.start}..{sl.stop - 1}")
    del a, b, got
    torch.cuda.empty_cache()

    no_quiet_degradation("2-3")

    # -- 4. the main path ---------------------------------------------------
    backends = ("cuda", "im2col")
    ctxs = {be: ExecutionContext(target=H100, backend=be) for be in backends}

    rows = {}
    for k in KERNELS.values():
        k.launches = 0
        k.tensor_core_launches = 0
    for i, (name, s) in enumerate(layers.items()):
        x, w = layer_inputs(gen, i, s)
        stride = (s.sh, s.sw)
        kw = {"stride": stride, "out_dtype": torch.float32}
        dec = {be: ops.explain("conv2d", ctxs[be], dtype=x.dtype,
                               spec_args=(x, w), spec_kw=kw)
               for be in backends}
        gap = dec["im2col"].measured_words / dec["cuda"].measured_words
        library = median_ms(lambda: F.conv2d(x, w, stride=stride))
        for be in backends:
            before = {n: k.launches for n, k in KERNELS.items()}
            tc_before = {n: KERNELS[n].tensor_core_launches
                         for n in ("conv2d", "matmul")}
            out = {}

            def run():
                out["y"] = ops.conv2d(x, w, stride, ctx=ctxs[be],
                                      out_dtype=torch.float32)

            ms = median_ms(run)
            launched = {n: k.launches - before[n]
                        for n, k in KERNELS.items()}
            kernel = "conv2d" if be == "cuda" else "matmul"
            if launched[kernel] <= 0:
                fail(f"{name}/{be}: the {kernel} kernel was not launched")
            tc_launched = {n: KERNELS[n].tensor_core_launches - c
                           for n, c in tc_before.items()}
            for n, c in tc_launched.items():
                if c != launched[n]:
                    fail(f"{name}/{be}: {launched[n] - c} bf16 {n} launches "
                         "took the FMA kernel, not the tensor cores")
            y = out.pop("y")
            if y.shape != (s.N, s.c_O, s.h_O, s.w_O):
                fail(f"{name}/{be}: output shape {tuple(y.shape)}")
            errs = []
            for sl in (slice(0, BLOCK), slice(s.N - BLOCK, s.N)):
                err, allowed = rel_err(y[sl], conv2d_plain(x[sl], w, stride))
                if not err <= allowed:
                    fail(f"{name}/{be}: error {err} above {allowed}")
                errs.append(err)
            max_err[kernel] = max(max_err[kernel], *errs)
            d = dec[be]
            row = {"layer": name, "backend": be, "tiles": list(d.plan.tiles),
                   "measured_words": d.measured_words,
                   "lower_bound": d.lower_bound,
                   "bound_ratio": d.bound_ratio,
                   "im2col_over_tiled_words": gap, "ms": ms,
                   "library_ms": library, "launches": launched,
                   "tensor_core_launches": tc_launched,
                   "max_abs_err": max(errs),
                   "checked_images": [[0, BLOCK - 1],
                                      [s.N - BLOCK, s.N - 1]]}
            rows[(name, be)] = row
            print(json.dumps(row), flush=True)
            del y
        HELD.setdefault("conv", {})[name] = (x, w)  # phase 16's operands
        del x, w
        torch.cuda.empty_cache()
    main_launches = {n: KERNELS[n].launches for n in ("conv2d", "matmul")}
    main_tc = {n: KERNELS[n].tensor_core_launches for n in main_launches}
    print(f"main path launches: {json.dumps(main_launches)}; on the tensor "
          f"cores {json.dumps(main_tc)}", flush=True)
    for n, c in main_tc.items():
        if c != main_launches[n]:
            fail(f"{c} of {main_launches[n]} main-path {n} launches took the "
                 "tensor cores")
    for n, c in main_launches.items():
        if c <= 0:
            fail(f"the {n} kernel was never launched on the main path")
    for name in layers:
        if not (rows[(name, "cuda")]["measured_words"]
                < rows[(name, "im2col")]["measured_words"]):
            fail(f"{name}: tiled words not below Im2Col words")

    no_quiet_degradation("4")

    # -- 5. kernel, plain version, library call, bound ----------------------
    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "by": {"bytes": 0.0, "operations": 0.0}}
              for n in KERNELS}
    for i, (name, s) in enumerate(layers.items()):
        x, w = layer_inputs(gen, i, s)
        stride = (s.sh, s.sw)
        flops = 2.0 * s.G
        conv_bytes = (x.numel() + w.numel()) * 2 + s.output_size * 4
        a = im2col_patches(x, s.h_F, s.w_F, stride)
        bmat = w.reshape(s.c_O, -1).t().contiguous()
        mm_bytes = (a.numel() + bmat.numel()) * 2 + a.shape[0] * s.c_O * 4
        timings = {
            "conv2d": (rows[(name, "cuda")]["ms"],
                       median_ms(lambda: conv2d_plain(x, w, stride), 0, 3),
                       rows[(name, "cuda")]["library_ms"], conv_bytes),
            "matmul": (median_ms(lambda: matmul_kernel(a, bmat, ctx=ctx_plan)),
                       median_ms(lambda: matmul_plain(a, bmat), 0, 3),
                       median_ms(lambda: torch.matmul(a, bmat)), mm_bytes),
        }
        for kname, (ms, plain, lib, nbytes) in timings.items():
            bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            f32_ms, _ = bound_ms(flops, 0, PEAK_F32_FLOPS)
            t = totals[kname]
            t["ms"] += ms
            t["plain_ms"] += plain
            t["library_ms"] += lib
            t["bound_ms"] += bms
            t["by"][by] += bms
            line = {"kernel_layer": kname, "layer": name, "ms": ms,
                    "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
                    "bound_by": by, "f32_fma_bound_ms": f32_ms,
                    "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
                    "tflop_per_s": flops / ms / 1e9,
                    "gbytes_per_s": nbytes / ms / 1e6}
            if kname == "conv2d":
                # the words the plan's tiles make the kernel issue (windows
                # and filters re-read, no credit for the L2), at the HBM rate
                floor = (rows[(name, "cuda")]["measured_words"] * 4
                         / PEAK_BYTES * 1e3)
                line.update(plan_word_floor_ms=floor,
                            library_note=CONV_LIBRARY_NOTE)
            print(json.dumps(line), flush=True)
        del x, w, a, bmat
        torch.cuda.empty_cache()

    no_quiet_degradation("5")

    # -- 6.-8. the serving path --------------------------------------------
    attn_kernels, serve = serving_phases(gen, record)
    no_quiet_degradation("6-8")

    # -- 9.-12. the int8 paths ----------------------------------------------
    quant_kernels = quant_phases(gen, record, serve)
    no_quiet_degradation("9-12")
    split = {k: serve[k] for k in ("contiguous", "contiguous_stats")}
    del serve  # phase 23 rebuilds the model from its seed
    torch.cuda.empty_cache()

    # -- 13.-15. the hybrid mamba path ---------------------------------------
    conv1d_kernel = hybrid_phases(gen, record)
    no_quiet_degradation("13-15")

    # -- 16. the static audit of every main-path dispatch --------------------
    audited = audit_phase()
    print(f"audit: {audited} dispatches audited, launched and held to their "
          "access plans", flush=True)
    no_quiet_degradation("16")

    # -- 17. autotune on the card --------------------------------------------
    autotune_phase()
    no_quiet_degradation("17")

    # -- 18. the decode steps as CUDA graphs: replay against eager ----------
    graph_phase()
    no_quiet_degradation("18")

    # -- 19. OLMoE-1B-7B, the MoE FFN at published widths --------------------
    moe_phase()
    no_quiet_degradation("19")

    # -- 20. InternVL2-1B's backbone and its stub frontend's embeddings ------
    vlm_phase()
    no_quiet_degradation("20")

    # -- 21. HuBERT-xLarge trained at published widths and full depth --------
    hd80 = hubert_phase()
    no_quiet_degradation("21")

    # -- 22. a causal LM trained through Trainer; checkpoint and resume ------
    lm_train_phase()
    no_quiet_degradation("22")

    # -- 23. the fused (B, KV, L, 2, hd) KV layout ---------------------------
    fused_phase(split)
    no_quiet_degradation("23")

    # -- 24. xLSTM-1.3B served at published widths and full depth -----------
    xlstm_phase()
    no_quiet_degradation("24")
    quiet.close()

    # -- 25. fault handling: campaigns at published widths -------------------
    faults_phase(gen)
    cycle_check("25")

    # -- 26. the paper's §4.2 distributed conv -------------------------------
    quiet = contextlib.ExitStack()
    decisions = quiet.enter_context(ops.record_dispatch())
    dist = dist_phase(gen)
    no_quiet_degradation("26")
    quiet.close()

    # -- 27. the language-model mesh: the mesh trainer and the dry run -------
    dry = start_dryrun()  # (b), on the host beside phases 27-31
    mesh = mesh_phase()
    cycle_check("27")

    # -- 28. the MoE FFN on the mesh: OLMoE through the shard hints ----------
    moe_mesh = moe_mesh_phase()
    cycle_check("28")

    # -- 29. the mamba block on the mesh: Jamba-1.5's, at published widths -
    mamba_mesh = mamba_mesh_phase()
    cycle_check("29")

    # -- 30. the xLSTM blocks on the mesh, and a checkpoint from the ranks -
    xlstm_mesh_phase()
    cycle_check("30")

    # -- 31. decode over a sequence-sharded cache: the stats kernel, then
    # Qwen2.5-3B on 4 gloo ranks against one card (beside the dry run) ---
    stats_kernel = stats_kernel_phase()
    seq_decode_phase(stats_kernel)
    cycle_check("31")

    # -- 27 (b). the dry run of production cells, read after phase 31 ------
    dryrun_phase(dry)

    # -- 32. summary --------------------------------------------------------
    csrc, ref = "src/repro_torch/kernels/csrc/", "src/repro/kernels/"
    meta = {"conv2d": (csrc + "conv2d.cu", ref + "conv2d.py:82"),
            "matmul": (csrc + "matmul.cu", ref + "matmul.py:41"),
            "flash_attention": (csrc + "flash_attention.cu",
                                ref + "flash_attention.py:48"),
            "paged_decode": (csrc + "paged_decode.cu",
                             ref + "flash_attention.py:257"),
            "conv2d_q": (csrc + "quant.cu", ref + "quant.py:75"),
            "matmul_q": (csrc + "quant.cu", ref + "quant.py:324"),
            "conv1d_causal": (csrc + "conv1d.cu", ref + "conv1d.py:22")}
    kernels = []
    for n in ("conv2d", "matmul"):
        source, replaces = meta[n]
        t = totals[n]
        kernels.append({
            "name": n, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[n],
            "max_abs_err": max_err[n], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": max(t["by"], key=t["by"].get),
            "library_ms": t["library_ms"], "ok": True,
            "shapes": "sum over the five ResNet-50 layers at batch 1000"})
    for k in kernels:
        k["tensor_core_launches"] = main_tc[k["name"]]
    # phase 26: the distributed conv's shard launches, all on the tensor
    # cores (in process; the process-group ranks' counted in their own)
    kernels[0]["dist_shard_launches"] = dist["shard_launches"]
    kernels[0]["dist_group_rank_launches"] = dist["group_rank_launches"]
    kernels[0]["library_note"] = CONV_LIBRARY_NOTE
    kernels[1]["library_note"] = ("torch.matmul on the bf16 operands writes "
                                  "bf16, half the kernel's f32 output bytes")
    for k in attn_kernels + quant_kernels + [conv1d_kernel]:
        source, replaces = meta[k["name"]]
        k.update(source=source, replaces=replaces,
                 max_abs_err=max_err[k["name"]])
    from repro_torch.kernels.flash_attention import (flash_split_instances,
                                                     flash_tc_instances)
    attn_kernels[0].update(
        instances=[list(i) for i in flash_tc_instances()],
        split_instances=[list(i) for i in flash_split_instances()], hd80=hd80,
        mesh_train_rank_launches=mesh["rank_flash_launches"],
        mesh_train_options_rank_launches=mesh["options_rank_flash_launches"],
        moe_mesh_rank_launches=moe_mesh["rank_flash_launches"])
    conv1d_kernel["mamba_mesh_rank_launches"] = mamba_mesh[
        "rank_conv1d_launches"]
    kernels += attn_kernels + quant_kernels + [conv1d_kernel, stats_kernel]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:  # phase 26 (c) starts its ranks so
        dist_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--mesh-rank"]:  # and phase 27 (a) its ranks
        mesh_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--dryrun"]:  # and phase 27 (b) its dry run
        dryrun_main()
    elif sys.argv[1:2] == ["--moe-rank"]:  # and phase 28 its ranks
        moe_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--mamba-rank"]:  # and phase 29 its ranks
        mamba_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--xlstm-rank"]:  # and phase 30 its ranks
        xlstm_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--seqdec-rank"]:  # and phase 31 (b) its ranks
        seq_decode_rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        main()
