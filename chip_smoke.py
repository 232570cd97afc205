#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--phases build,rwkv_kernels]

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and
``nvcc``. Phases, each of which fails the run if it fails:

1. card (always run): the card's name and power limit, as nvidia-smi
   reports them;
2. build: every CUDA kernel of the port (flash attention, RWKV6, the
   selective scan), from the sources in this checkout, into
   ``build/repro_torch_kernels/``:
   one nvcc per source file, all started together, then one link per
   library;
3. kernels: flash attention against its plain PyTorch version at the
   reference's test shapes, at the granite-8b prefill shape (in float32
   as well, and in bf16 at mixtral-8x7b's window of 4096) and at the edges of the bf16 Hopper kernel (``sm90``:
   ragged S, a cache with q_offset, window, soft cap, K/V views of a
   larger cache, hd 64 at the repro-lm-100m widths); every bf16 case
   also against the plain version run in float32, to one bf16 step. At
   the granite prefill shape the sm90 kernel, the first kernel
   (``fma``), the plain version and one PyTorch library call computing
   the same function are timed in turns (CUDA events around
   back-to-back calls, median of 3 turns) beside the roofline bound; the
   sm90 kernel's row LSE (which the backward reads) is held to the plain
   version's there too;
4. rwkv kernels: the RWKV6 recurrence against its plain version, y and
   the final state, at the reference's cases (zero and random state),
   a ragged length, the edges of the bf16 tensor-core kernel (``mma``:
   chunks of 32 and 16 with ragged tails, one token, r, k, v as views of
   one wider tensor) and the rwkv6-7b prefill shape (float32, and the
   model's types with two draws of the decay), under a gate scaled to
   the output; each case logs the kernel ``wkv6`` chose. At the bf16
   prefill shape the first kernel (``fma``) is held too, and the mma
   kernel, the fma kernel and the plain version are timed in turns
   beside the bound (no PyTorch call computes the recurrence);
5. serve: the full granite-8b configuration in bf16 (random weights from
   a seed) serves 8 seeded requests through ``ServingEngine``; the
   launch counts show every prefill attention call went through the
   sm90 kernel; then
   one prefill call and one decode step run under torch.profiler (wall
   time, device-busy share, the kernels that take the most time);
6. token equality: the same geometry at full width with 2 layers in
   float32 — continuous-batched greedy output equals the port's own
   sequential prefill + decode_step, token for token, save at near-ties
   within the measured batched-vs-sequential logit difference;
7. rwkv generate: the full rwkv6-7b configuration in bf16 (random
   weights from a seed): one ``prefill`` of 8 prompts of 1024 tokens,
   then 31 greedy ``decode_step`` calls; the launch counts show every
   layer's prefill went through the mma RWKV6 kernel and no decode step
   launched one; then one prefill and one decode step under
   torch.profiler;
8. rwkv equality: full width, 2 layers, float32 — batched greedy output
   equals each request generated alone (near-tie rule of phase 6), and
   prefill of 512 tokens then ``decode_step`` on the next 512 (the
   kernel seeded with a non-zero state) matches one prefill of 1024 in
   logits and every state leaf;
9. plan: trace → partition → plan for full granite-8b's paged decode
   step (bf16, random weights from a seed) at the serve phase's
   geometry. At the reduced size the graph's fingerprint must be the
   same traced on the CPU and on the card; at
   full width the trace's matmul FLOPs must equal a count from the
   config; ParDNN partitions it at K=4 under a quarter of the card per
   PE and under a tight cap (1.2 x (resident + largest transient bytes)
   / 4), every node in [0, 4) and, where the plan says feasible, every
   peak under its planned cap; the plan is saved, loaded and bound to a
   fresh trace (fingerprint and assignment equal); then the predicted
   step time (emulated makespan, one PE and K=4) is printed beside the
   measured eager step (wall, and device time under torch.profiler). No
   kernel launches on this path (one query token). The static verifier
   must refuse the quarter-cap plan as it now does (RP020 and RP040 on
   PE 3: its certificate holds more there than the partitioner's
   emulated order does) and accept the plan under half the card per PE,
   which is the one saved;
10. plan execute: the plans run with their PEs folded onto the card
   (``device_map=[0] * 4``), through ``PartitionPlan.execute``: (a) 2
   layers in float32, the compiled runtime against the eager step
   within 2e-5; (b) full granite-8b in bf16, the verified K=4 plan
   (half cap; the plan phase's trace and plan when it ran: the graph
   depends on shapes and dtypes only), its parameters read in place and
   its other inputs copied
   into the runtime's buffers (a call with other pools leaves the first
   call's as they were): compiled async bit-equal to sync over three
   calls each, both against
   the eager step (greedy tokens equal on every row, logits within
   2^-7 x max |logits|), every segment replayed from its CUDA graph;
   (c) the same trace at K=1, one graph for the whole step, the same
   gates; (d) 8 layers at full width, the op-by-op interpreter against
   the compiled runtime (bit-equal expected; else the bf16 gate). For
   (b) and (c): wall ms of async, sync and eager, device time under
   torch.profiler, the predicted makespan, segments, transfers, input
   copies and output clones, the logical peak per PE beside the plan's
   peaks and the verifier's certificate, max_memory_allocated, capture
   seconds. No kernel launches on this path.
11. plan serve: full granite-8b in bf16 served from a K=4 ParDNN plan
   (PEs folded onto the card) beside the local engine, one parameter
   tree, each engine's pools released before the next is built: (a) the
   half-cap plan the plan phase saved (partitioned here when that phase
   did not run), loaded without a trace so that the engine retraces and
   binds it, serves the serve phase's 8 requests: greedy tokens equal to
   the local engine's request for request (a divergence only at a
   near-tie under phase 6's rule, with d the two engines' logit
   difference at the first decode step), 0 leaked blocks, every pool
   leaf on its PE's device, every decode step a replay of every segment
   with no capture after the first, all prefill flash launches sm90;
   (b) a block-starved pool (``STARVED``), its own K=4 half-cap plan,
   plan-served against local: preemptions equal and above 0, tokens
   equal under the same rule; then the same requests admitted in a
   shuffled order: the in-order plan-served tokens request for request
   (the rule with (b)'s d), 0 leaked blocks; (c) the engine traces
   valid (a lane per request, an ``evicted`` instant per preemption),
   and one
   ``plan.execute(trace=)`` of a decode step: measured lanes (CUDA
   events) and predicted lanes with the same ``seg{sid}`` names,
   predicted against measured makespan; (d) ``launch.serve --plan-devices
   4 --fold --trace --metrics`` in process, both files valid. Prints
   plan-served and local tok/s, TTFT p50 and decode ms side by side,
   segments, capture seconds and max_memory_allocated beside the card's
   name and power limit.
11b. conformance serving: ``python -m repro_torch.conformance --arch
   granite-8b --serving --devices 4 --fold --trace PATH`` in a child
   process (``conformance.subproc``): the reference's serving scenario,
   reduced granite-8b (float32) served through ``plan.serve`` at K=4
   folded onto the card under a block-starved pool (block 4, 10 blocks,
   max_batch 4, max_len 20) and a shuffled admission order: exit 0 and
   ok, preemptions forced, 0 leaked blocks in both schedules, 4 requests
   completed, every pool leaf on a PE of the plan, the trace valid (both
   lane groups, an ``evicted`` instant per preemption), at least one
   flash launch and all of them fma (float32, hd 16). With phase 29 it
   runs beside that phase's cells, which time nothing on the card.
12. train kernels: the three flash backward kernels (``sm90``: bf16 at
   hd 64/128, wgmma and the forward's LSE; ``mma``, the earlier
   mma.sync design, and ``fma``, the first, on every bf16 case too; fma
   alone in float32) against the plain backward run in float32 on the
   same inputs (BWD_CASES: the training shape in bf16 and float32, hd
   64 at repro-lm-100m widths, ragged S, window, q_offset, softcap,
   G = 1 and 4, fully masked rows, the training shape at mixtral's
   window of 4096, internvl2-1b's training shape: hd 64, GQA group 7,
   B=2, S=4096), each given the forward kernel's
   output and LSE, repeated calls bit-equal; at the training shape the
   three kernels, the plain version and SDPA's backward timed in turns
   beside the bound, the sm90 backward's four kernels (D, dK/dV, their
   sum over a KV head's query heads, dQ) timed apart under
   torch.profiler, and their registers and spills from ptxas;
13. train: granite-8b's training step at full width (bf16, random
   weights from a seed, B=1, S=2048, SGD at lr 1e-3), after phase 12
   (which it runs too): (b) the eager step at the depth the
   printed memory arithmetic allows (36 layers on an 80 GB card): loss
   near ln V, L forward (all sm90) and L backward (all sm90) launches,
   step ms, tokens/s, peak memory, device busy under torch.profiler; (c)
   the 12-layer step traced on fake tensors (no ``select_backward``, no
   whole-stack op but the restacks, product FLOPs equal to the config's
   count), partitioned at K=4 under a generous and a tight cap,
   verified, saved, loaded and bound; the verified plan executed with
   its PEs folded onto the card (async = sync over 3 calls, loss, new
   parameters and every grad leaf bit-equal to the eager step or within
   TRAIN_GATE), K=1 the same, the interpreter at 4 layers against
   compiled; wall, device time, segments, capture, replays, peaks per PE
   beside the plan's and the certificate, measured against predicted
   makespan.
14. calibrate: ``repro_torch.profiling`` on the card, closing the
   predict-measure loop on two plans folded onto it: (a) full granite-8b's
   paged decode step (bf16, 36 layers, the serve geometry), the K=4
   half-cap plan (the plan phase's trace and plan when it ran); (b)
   granite-8b's training step (B=1, S=2048, TRAIN["plan_layers"]
   layers), K=4 under half the card per PE. Each:
   ``accuracy_report`` (segments serialised, CUDA events around each
   graph replay), ``api.calibrate`` (every op signature timed by the
   robust estimator, the copy ladder, the dispatch overhead, the
   whole-step replay for the fusion factor), the profile saved and loaded
   back with the device check (bit-equal), ``annotate``, the old plan
   refused (RP102), re-partitioned, verified, executed against the eager
   step by the gates of phases 10 and 13, ``accuracy_report`` again and
   ``compare`` against rr and topo; prints the fingerprint, signatures,
   fitted rates, the calibration's seconds and both scorecards. Every
   flash node the calibration replays launches sm90; the flash nodes'
   profiled seconds stand beside CUDA events at the same shape. (c)
   ``benchmark_runtimes`` on a TRAIN["interp_layers"]-layer training
   plan. The phase reads its own launch counts (reset before
   ``api.calibrate``, read after).
15. rwkv train kernels: the two wkv6 backward kernels
   (``rwkv6_bwd_mma.cu``, bf16 at hd 64; ``rwkv6_bwd.cu``, the rest)
   against their plain version ``wkv_bwd_ref`` on the same inputs
   (RWKV_BWD_CASES: the rwkv6-7b training shape in bf16 and float32, hd
   16 and 32, ragged S, chunks under 64, a given state0 and dS_last,
   B·H = 2, a fast decay at the edge of the kernels' stated range): the
   one ``select_bwd_variant`` names, and in bf16 at hd 64 the fma kernel
   by name too, each gradient under the gate written in rwkv6_bwd.cu,
   repeated calls bit-equal; at the training shape, in turns, the mma
   kernel, the fma kernel and the fma kernel cut after its forward walk
   (a copy of its source built apart), then one call of the plain
   version (``once_ms``), beside the bound; the mma kernel's two stages
   timed apart, registers, spills and blocks per SM;
16. rwkv train: rwkv6-7b's SGD step at full width (bf16, random weights
   from a seed, B=1, S=2048, lr 1e-3), after phase 15 (which it runs
   too): (a) the eager step at the depth the printed memory arithmetic
   allows (all 32 layers on an 80 GB card): loss near ln V, L forward
   (all mma) and L backward (all mma) launches, step ms, tokens/s, peak
   memory,
   device busy; (b) the 12-layer step traced (one wkv6 and one wkv6_bwd
   node a layer, product FLOPs equal to the config's count),
   partitioned at K=4, verified, and executed with its PEs folded onto
   the card: every leaf bit-equal to the eager step or within
   TRAIN_GATE;
17. launch train: ``repro_torch.launch.train``'s body in process for
   granite-8b and rwkv6-7b at full width (bf16, B=1, S=2048, AdamW,
   remat full, passed by name: ``build_train_step`` defaults to the
   reference's ``dots``): (a) 4 steps at the depth the printed AdamW arithmetic
   allows (16 bytes a parameter plus the activations, measured at 2 and
   4 layers): step ms, tokens/s, peak memory, 2L forward and L backward
   launches a step (rwkv's backward all mma), one step more under
   torch.profiler; (b) at
   CKPT_LAYERS, 4 steps with a checkpoint every 2, then a fresh run
   resumed from the step-2 checkpoint alone: every
   parameter and optimizer leaf against the uninterrupted run's
   (bit-equal, else within TRAIN_GATE); (c) ``launch.serve --ckpt-dir``
   serves 4 requests from granite's newest checkpoint, its parameters
   equal to the resumed run's. The checkpoint run is cut in depth, not
   the deep one: at 19 layers a checkpoint of parameters and AdamW
   state is 60 GB, written three times a run.
18. mixtral serve: mixtral-8x7b in bf16 (random weights from a seed,
   8 experts top-2, window 4096) at full width and the depth the printed
   arithmetic lets 90% of the card hold (24 of 32 layers), serving the
   serve phase's 8 requests at its geometry: every prefill attention
   call launches the sm90 kernel at window 4096 (L per prefill call), 0
   leaked blocks; tok/s, TTFT p50, decode ms, peak memory; one prefill
   and one decode step under torch.profiler, device time by role (expert
   products, dispatch and combine, router, the rest), and the share of
   routed assignments capacity dropped in each. Then the same engine on
   the plain attention path, fed the kernel path's tokens: every token
   the plain path's argmax, or behind it by no more than the near-tie
   limit of phase 6 (4 x the two paths' logit difference at the prefill
   and the first decode step). Batched and sequential decoding differ
   under MoE capacity (a lone token never drops, a batch of 8 rows can),
   so this phase has no batched = sequential gate;
19. mixtral train: mixtral-8x7b's SGD step at full width (bf16, B=1,
   S=2048, lr 1e-3, the loss with its router term): (a) in place, at
   the depth the printed arithmetic allows (parameters and grads): L
   flash forward and L backward launches, all sm90, the cross entropy
   at init near ln V; step
   ms, tokens/s, peak memory, device time by role; (b) traced,
   partitioned at K=4 under half the card per PE at the deepest depth
   whose plan's summed peaks and the returned clones fit 90% of the card
   (folded onto one card each PE keeps its own graph pool), verified,
   executed with its PEs folded onto the card: async = sync bit for bit,
   every leaf within TRAIN_GATE of the eager step; nodes, partition
   seconds, predicted makespan, async, sync and eager ms, logical peak
   per PE beside the plan's.
20. wide head kernels: the sm90 flash kernels at the head dims off 64
   and 128 on main paths, in bf16: q/k 192 with v at its own 128 at
   deepseek-v2-lite's training shape (B=1, S=2048, 16 heads; forward and
   backward), hd 256 at gemma3-1b's prefill shape (B=8, S=1024, 4 / 1
   heads) and at its training shape with window 1024 at S=2048 (forward
   and backward), hd 80 with every key visible at hubert-xlarge's
   encoder shape (B=8, S=4096, 16 heads) and training shape (B=2;
   forward and backward): each against its plain version under the gates of
   phases 3 and 12, repeated calls bit-equal, its registers and spills
   (ptxas), timed in turns with the fma kernel it replaces (held too; v
   and dO zero-padded inside its wrapper) and SDPA at the same shape
   (the backend that took it), then one call of the plain version,
   beside the bound of the
   work these inputs need, and faster than the fma kernel (the sm90
   kernels replayed from a CUDA graph of 20 calls, since back to back
   their eager calls time the host; the eager time is printed too); the sm90
   forward held at qwen2.5-14b's, starcoder2-7b's and internvl2-1b's
   prefill shapes (GQA groups of 5, 9 and 7) and internvl2-1b's training
   shape (B=2, S=4096);
21. deepseek serve: deepseek-v2-lite-16b in bf16 (random weights from a
   seed) at full width and the depth the printed arithmetic lets 90% of
   the card hold (all 27 layers) at the serve phase's geometry: no flash
   launch (MLA with a cache attends in the latent space, as plain
   products), 0 leaked blocks; the engine's first prefill logits equal
   ``prefill_batched`` on the same padded batch and its first decode
   step's within 2^-7 of their scale of ``decode_step`` on that
   prefill's dense caches (the 3-D latent and rope-key leaves through
   the pages); a second drain gives the same tokens; a starved pool
   preempts and leaks nothing; tok/s, TTFT p50, prefill and decode ms and
   busy share, peak memory, device time by role (MLA attention, expert
   products, dispatch and combine, router, the rest) and the share of
   routed assignments capacity dropped, on the first prefill and decode
   step;
22. deepseek train: its SGD step as phase 19 runs mixtral's: eager at
   the depth the printed arithmetic allows (all 27 layers), L sm90 flash
   forward and L sm90 backward launches at q/k 192 with v read at 128
   (asserted call by call), the cross entropy at
   init near ln V; the K=4 plan at the deepest depth that folds onto the
   card, verified, async = sync, every leaf within TRAIN_GATE of eager;
23. dense configs: gemma3-1b served and trained eagerly at all 26 layers
   (every flash launch sm90 at hd 256, window 1024 on 22 of them);
   qwen2.5-14b (48 layers) and starcoder2-7b (32) served with a short
   drain, every prefill launch sm90; tok/s, TTFT, decode ms and peak
   memory for each.
24. ssm kernels: Mamba's selective scan (``kernels/ssm``: the forward
   and its backward, float32; ``reg``, the main path's kernels, states in
   registers, and ``lane``, the first design, one thread per (batch,
   channel, state), kept as the comparison) against the plain versions at
   jamba's shapes (d_inner 8192, N 16): prefill B=8, S=1024; training
   B=1, S=2048, forward and backward; decode S=1 from a state; every
   output of both variants within ``SSM_GATE`` of its largest
   magnitude, repeated calls bit-equal; each kernel timed in turns from
   a CUDA graph of GRAPH_CALLS calls beside one call of the plain version
   and the bound (bytes at 3.35 TB/s or exponentials at the SFU rate, the
   larger): GB/s and the share of the bound; no PyTorch call computes
   the scan; registers and spills (ptxas);
25. jamba serve: jamba-v0.1-52b in bf16 (random weights from a seed) at
   full width and 16 layers (two periods, by the printed parameter
   arithmetic): one ``prefill`` of 8 x 1024 tokens, 31 decode steps; 14
   scan launches in the prefill and 14 a decode step (all ``reg``, none
   ``lane``), 2 flash launches in the prefill (sm90 at (128, 128)), none
   in decode; the first mamba block, prompt and one decode step, through
   the kernel against the plain scan; tok/s, TTFT, decode ms, peak
   memory, a profile of each call with the scan kernels' share of its
   device time;
26. jamba train: its SGD step in place at 8 layers (B=1, S=2048, lr
   1e-3, the loss with its router term): the cross entropy at init near
   ln V, aux in [K/2, E] a MoE layer, 7 scan forward and 7 backward
   launches (all ``reg``), 1 sm90 flash forward and 1 backward; step ms,
   tokens/s, peak memory, device time by role; then the step traced,
   partitioned at K=4 and verified. The plan is not executed: the
   runtime returns clones of the new parameters and grads, and 3P at 8
   layers is over 90% of the card.
27. hubert: hubert-xlarge (encoder-only, non-causal, hd 80; its audio
   frontend stubbed: frame embeddings from a seed) in bf16 at full width
   and all 48 layers: (i) ``encoder_logits`` through
   ``train.build_prefill_step`` at B=8, S=4096: 48 sm90 forward launches
   at (80, 80), non-causal, 0 fma; the logits against the same path
   through the plain attention, a row at a time (``PATH_GATE``), and a
   control that must miss the gate (the plain path with a causal mask
   planted, one row); (ii) eager SGD in place
   at B=2, S=4096 (B lowered only where the printed arithmetic says the
   step does not fit): 48 sm90 forward and 48 sm90 backward launches a
   step, 0 fma, the cross entropy at init near ln V; (iii) the step
   traced, partitioned at K=4 under half the card per PE, verified and
   executed with its PEs folded onto the card at the deepest depth whose
   summed per-PE peaks and returned clones fit 90% of the card (all 48
   when they do): async = sync, every leaf within TRAIN_GATE of eager.
   Step ms, frames or tokens/s, busy share, peak memory (held under 90%
   of the card) and the flash kernels' device time for each;
28. internvl: internvl2-1b (its vision frontend stubbed) in bf16 at full
   width and all 24 layers: (i) ``prefill`` of B=8 x (256 patch
   embeddings + 768 prompt tokens) into caches of 1056: 24 sm90 forward
   launches at (64, 64), causal, GQA group 7; the last logits against the
   plain attention path (``PATH_GATE``); (ii) 31 greedy ``decode_step``
   calls fed tokens, no flash launch (the paged engine refuses a
   non-token frontend, as the reference's does); (iii) eager SGD in place
   at B=2, S=4096: 24 sm90 forward and 24 sm90 backward launches a step,
   0 fma; tok/s, TTFT, decode and step ms, busy share, peak memory (held
   under 90% of the card) and the flash kernels' device time.
29. dryrun: the single-device tools on the card, in the order (b), then
   (c) in a child process (and phase 11b's) while (a) and (d)'s priced
   peaks trace, then (d). (a)
   ``launch.dryrun.run_cell`` at full width and each shape's full global
   batch, remat ``dots``, traced on fake tensors: granite-8b
   ``train_4k``, hubert-xlarge ``prefill_32k``, jamba-v0.1-52b
   ``decode_32k``, each status OK with a finite roofline (nodes, trace
   seconds, the one-card peak in the trace's order and whether one card
   holds it, the emulator's one-PE peak, the bound and
   its dominant term, model FLOPs and the useful ratio); then the
   granite-8b ``train_4k`` cell on ``--mesh multi``: rank 0 of (pod 2,
   data 16, model 16) traced with its collectives (trace seconds, nodes,
   the rank's peak and fits, collective bytes by kind, the collective
   share of the roofline), its all-reduce bytes within MULTI_GATE of
   the count from the shapes (:func:`multi_all_reduce_bytes`); then the
   multi serving cells granite-8b ``decode_32k``, jamba-v0.1-52b
   ``long_500k`` and granite-8b ``prefill_32k``
   (:data:`DRYRUN_MULTI_SERVE`): OK, fits, the rank's all-reduce and
   all-gather bytes equal to the count from the shapes
   (:func:`serve_tp_bytes`); (b)
   ``run_pardnn_plan`` for reduced granite-8b (float32), K=4 folded onto
   the card, executed, linted and traced: 0 verifier errors, compiled
   within PARDNN_DRIFT of the interpreter, at least one fma flash forward
   launch, the trace valid; measured and predicted peaks per PE; (c)
   ``python -m repro_torch.analysis`` on that plan with ``--arch
   granite-8b`` in a child process: exit 0; (d) granite-8b at full width
   and REMAT["layers"] layers, bf16, B=1, S=2048, AdamW without warm-up,
   one step under each remat policy (none, full, dots, dots_no_batch)
   from the same parameters and batch: L, 2L, L and 2L flash forward
   launches and L backward, all sm90; the loss, grad norm, new
   parameters and first moments within TRAIN_GATE of the none step; step
   ms, max_memory_allocated and the peak of the loss and its gradient
   alone over what the card held before, against the dry run's
   trace-order peak of the same call (traced on fake tensors) less its
   inputs: within F11_FACTOR either way.
30. distributed: the collective parts (``repro_torch.distributed``) in
   one launch of 4 ranks sharing the card (``conformance.subproc.
   start_ranks``; each rank its own CUDA context; gloo, every payload
   staged through host memory, as the run says), with phase 29 beside
   its cells: (a) ``pipeline_apply`` over 4 stages of one full-width
   granite-8b block (bf16), 4 microbatches of (1, 1024), forward and
   backward: 7 sm90 flash forward and 7 backward launches a rank (the
   ticks), 0 fma, the outputs, loss and every gradient of the rank's
   block within 2^-7 of its scale of the same 4 blocks run on one rank;
   (b) ``launch.train``'s body over the (pod 2, data 2, model 1) mesh at
   the depth the launch phase's AdamW arithmetic lets 90% of the card
   hold for 4 ranks: ZeRO-1, global batch 4 x 1024, 3 steps, every loss
   finite and the same on every rank, the first within DIST_LOSS_GATE of
   the one-rank loss on the global batch, 2L sm90 forward and L backward
   launches a step; its state checkpointed (gathered, rank 0 writes) and
   restored onto 2 ranks in a second launch, each rank's blocks equal to
   the saving rank's; (c) ``make_compressed_psum`` over ``pod`` on each
   rank's first full-width gradient tree of one layer (the embedding,
   the head and a block), in groups of leaves: within 0.03
   of the exact mean, residual + dequantized equal to the input within
   2 ulp of the scale; then tensor parallelism over ``model``, in bf16
   at full width: (d) TP["blocks"] granite-8b blocks over (data 1, model
   4), B=1, S=1024, each rank its Megatron blocks (8 query and 2 KV heads
   of 128), forward and backward: the output, the loss and every
   gradient within 2^-7 of its scale of the same blocks run whole (each
   rank's block of the whole gradient), L sm90 flash forward and L
   backward launches a rank, 0 fma, all-reduce bytes 4 x B·S·D x 2 a
   layer; (e) one mixtral-8x7b layer over (data 1, model 4), 2 experts a
   rank, under the same gate, its aux and dropped share against the
   whole layer's; (f) ``launch.train``'s body over (data 2, model 2) at
   (b)'s depth, TP["train_steps"] steps, no checkpoint: the first loss
   within DIST_LOSS_GATE of the one-rank loss, 2L sm90 forward and L
   backward launches a step; then serving over a mesh
   (``build_prefill_step`` and ``build_serve_step`` with ``mesh``, each
   rank its blocks of the parameters and of the caches), bf16 at full
   width (:func:`_serve_cases`): (j) 2 granite-8b layers over (data 1,
   model 4), a prompt of 4 x 1020 into caches of 4096 (1024 positions a
   rank), 12 decode steps into rank 1's slice, 2 sm90 flash forwards a
   rank and 0 fma; (k) deepseek's mla and mla_moe layers, 4 x 1024 into
   caches of 4112; (l) a gemma3-1b period at ``long_500k`` over (data 2,
   model 2), batch 1, caches of 524288 filled from the seed to 524280,
   4 decode steps; (m) 2 rwkv6-7b layers and a jamba mamba + mamba_moe
   pair over (data 1, model 4), 2 mma ``wkv6`` and 26 ``reg`` scan
   launches a rank: each case's logits against the whole bf16 run on
   one rank, anchored on float32, under DIST_GATE with the rounding
   witness, the greedy tokens equal wherever the whole run's top-2 gap
   exceeds the gate, each collective's bytes equal to the count from
   the shapes (:func:`serve_tp_bytes`). Prints the backend, the bytes
   each collective moved a step and each rank's step ms (host-staged
   transport on a shared card: no measure of NVLink or NCCL).

Each phase's seconds are printed when it ends. ``--rank-body`` (not
for users) runs one rank of phase 30.

``--phases`` (a comma list of the names in ``PHASES``; default all) runs
a subset, for iterating on one kernel; the card's name is always read.
The line before the last is the ``kernels`` JSON record (the records of
the kernel phases that ran; ``launches`` is null where the main path that
would count them did not run); the last line is ``{"ok": true, "device":
{...}}``.
Without a CUDA card, or without the rest of the repository beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, float32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# the reference's kernel test cases (tests/test_kernels.py), plus the
# granite-8b prefill shape the serving phase gives the kernel
FLASH_CASES = [
    # (B, H, KV, S, hd, causal, window, dtype)
    (2, 4, 2, 256, 64, True, None, "float32"),
    (1, 4, 4, 128, 128, False, None, "float32"),
    (2, 8, 2, 256, 64, True, 64, "float32"),
    (1, 2, 1, 100, 80, True, None, "float32"),
    (1, 4, 2, 128, 64, True, None, "bfloat16"),
    (1, 2, 2, 64, 32, True, 16, "bfloat16"),
    (2, 2, 1, 192, 64, True, 128, "float32"),
]
GRANITE_PREFILL = (8, 32, 8, 1024, 128, True, None, "bfloat16")
GRANITE_PREFILL_F32 = GRANITE_PREFILL[:-1] + ("float32",)
# mixtral-8x7b's prefill: granite's shape at its sliding window of 4096
MIXTRAL_PREFILL = GRANITE_PREFILL[:6] + (4096, "bfloat16")
#: the sm90 forward's and backward's ms at granite's prefill and training
#: shapes before both were templated on (DQK, DV) (PERF.md, section 6)
GRANITE_EARLIER_MS = (0.2411, 0.3977)
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# At the granite shape 5e-2 is as large as a typical output, so every bf16
# kernel output is also held to the plain version run in float32 on the
# same bf16 inputs. The kernels keep scores and the accumulator in
# float32 (the fma kernel the probabilities too; the sm90 kernel takes P
# as bf16 hi + lo parts, exact to about 2^-17) and round only their
# output, so they may differ by that rounding (at most 2^-8 relative) and
# float32 summation order: the gate is one bf16 step, 2^-7 relative, over
# an absolute 1e-5.
TIGHT = {"atol": 1e-5, "rtol": 2.0 ** -7}
# the forward's row log-sum-exp (values of a few units) against the plain
# version's: float32 scores, another summation order, the hardware's exp2
# (2^-22 relative): 1e-4 absolute
LSE_GATE = 1e-4
# the edges of the bf16 Hopper kernel (flash_attention_sm90.cu), each held
# to TOL and TIGHT; kv_view: k and v are views of a cache twice as long
SM90_CASES = [
    # (B, H, KV, Sq, Sk, hd, causal, window, q_offset, softcap, kv_view)
    (2, 4, 2, 256, 256, 64, True, None, 0, 0.0, False),
    (1, 4, 4, 128, 128, 128, False, None, 0, 0.0, False),
    (2, 8, 2, 256, 256, 64, True, 64, 0, 0.0, False),
    (2, 2, 1, 192, 192, 64, True, 128, 0, 0.0, False),
    (2, 4, 2, 1000, 1000, 128, True, None, 0, 0.0, False),   # ragged
    (2, 8, 2, 512, 1024, 128, True, None, 512, 0.0, False),  # with a cache
    (2, 8, 2, 1024, 1024, 128, True, 256, 0, 0.0, False),    # window
    (2, 8, 2, 512, 512, 128, True, None, 0, 30.0, False),    # soft cap
    (2, 8, 2, 300, 1000, 128, True, None, 700, 0.0, True),   # k, v views
    (8, 12, 4, 1024, 1024, 64, True, None, 0, 0.0, False),   # repro-lm-100m
]

# the reference's RWKV6 kernel cases (tests/test_kernels.py), a ragged
# length, and the rwkv6-7b prefill shape (B=8, S=1024, H=64, hd=64)
RWKV_CASES = [
    # (B, H, S, hd, chunk, dtype of r, k, v)
    (2, 2, 128, 64, 32, "float32"),
    (1, 4, 96, 64, 64, "float32"),
    (2, 1, 70, 32, 16, "float32"),
    (1, 2, 64, 64, 64, "bfloat16"),
    (1, 1, 33, 16, 8, "float32"),
    (2, 4, 1000, 64, 64, "bfloat16"),
]
# the edges of the bf16 tensor-core kernel (rwkv6_mma.cu), each with zero
# and random state0; view: r, k, v are views of one (B, S, 3, H, hd)
# tensor (16-byte aligned strides, as the kernel's cp.async needs)
MMA_CASES = [
    # (B, H, S, hd, chunk, dtype, view)
    (1, 2, 130, 64, 32, "bfloat16", False),    # chunk 32, ragged tail
    (2, 1, 77, 64, 16, "bfloat16", False),     # chunk 16, ragged tail
    (2, 2, 1, 64, 64, "bfloat16", False),      # one token
    (2, 4, 200, 64, 64, "bfloat16", True),     # r, k, v views
]
RWKV_PREFILL = (8, 64, 1024, 64, 64, "bfloat16")
RWKV_PREFILL_F32 = RWKV_PREFILL[:-1] + ("float32",)
# The kernel and its plain version compute in float32 from the same
# inputs and differ only in the order of their sums, ~1e-6 of the
# output's scale: the gate is max |diff| <= 2e-5 * max(1, max |plain|),
# for y and the final state each.
RWKV_GATE = 2e-5
# prefill-of-512 + decode_step-of-512 against one prefill of 1024, float32:
# the same arithmetic save cuBLAS's choice of kernel for other row counts;
# held to the port's model tolerance against the reference, 1e-4 of the
# scale.
SPLIT_GATE = 1e-4


# The kernel wrappers whose launch counts the main paths read, by name
# (filled in by count_kernels()).
COUNTED: dict = {}


def count_kernels() -> None:
    """Fill :data:`COUNTED` with the six kernel wrappers (in the main
    process and in each rank of the distributed phase)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rwkv6 import ops as rops
    from repro_torch.kernels.ssm import ops as sops
    COUNTED.update(flash_attention=ops.flash_attention,
                   flash_attention_bwd=ops.flash_attention_bwd,
                   wkv6=rops.wkv6, wkv6_bwd=rops.wkv6_bwd,
                   selective_scan=sops.selective_scan,
                   selective_scan_bwd=sops.selective_scan_bwd)


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    """Every kernel's launch counts (the total and, where a wrapper has
    several kernels, each one's) to 0, just before a main path runs."""
    for fn in COUNTED.values():
        fn.launches = 0
        for variant in getattr(fn, "variant_launches", {}):
            fn.variant_launches[variant] = 0


def read_counts() -> dict:
    """{name: total, "name/variant": that kernel's launches}."""
    counts = {}
    for name, fn in COUNTED.items():
        counts[name] = fn.launches
        for variant, n in getattr(fn, "variant_launches", {}).items():
            counts[f"{name}/{variant}"] = n
    return counts


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 3,
            rounds: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around
    ``reps`` back-to-back calls, over the count, the median of
    ``rounds`` such runs. Back to back, the host enqueues a call while
    the device runs the one before, so the wrapper's host time stays out
    of the number unless it exceeds the device time (events around each
    single call would count it in)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def once_ms(torch, fn) -> float:
    """Device ms of one call of ``fn`` after one warm-up call (CUDA
    events around it), for a plain version of ms to seconds: timed in
    rounds it adds seconds to the run and nothing to the number's use,
    a yardstick."""
    return cuda_ms(torch, fn, reps=1, warmup=1, rounds=1)


def timed_turns(torch, fns: dict, reps: dict, rounds: int = 3) -> dict:
    """Device ms of one call of each function, timed in turns (each
    round times every function once with :func:`cuda_ms`), the median
    over the rounds: drift of the card's clock or power hits all of them
    alike."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_ms(torch, fn, reps=reps.get(name, 10),
                                       rounds=1))
    return {name: statistics.median(t) for name, t in times.items()}


def graphed(torch, fn, calls: int):
    """``calls`` back-to-back calls of ``fn`` captured in one CUDA graph
    (after a warm-up on a side stream); its ``replay`` runs them with no
    host work between launches. A kernel faster than its wrapper's host
    time (the custom op's dispatch, the checks, the ctypes call: ~0.1 ms)
    is timed by the host when eager calls run back to back; replayed,
    the events time the card alone."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    return g


def visible_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave, i.e. the work these inputs
    need."""
    qp = np.arange(Sq)
    hi = np.minimum(Sk, qp + 1) if causal else np.full(Sq, Sk)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def phase_card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = res.stdout.strip().splitlines()[0]
    log(card)
    return card


def phase_build(libs: dict, build) -> float:
    """Build every kernel library at once (in threads; each library
    compiles its sources in parallel nvcc processes)."""
    def timed(ops):
        t0 = time.perf_counter()
        ops.load()
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        secs = dict(zip(libs, pool.map(timed, libs.values())))
    total = time.perf_counter() - t0
    for name, ops in libs.items():
        so, _ = build.library_path(name, ops.CSRC)
        log(f"build: {name} in {secs[name]:.1f} s -> "
            f"{so.relative_to(ROOT)}")
        for kernel, used in ptxas_report(build, ops, name).items():
            log(f"  ptxas {kernel}: {used}")
    log(f"build: {len(libs)} libraries in {total:.1f} s")
    return total


def ptxas_report(build, ops, name: str) -> dict:
    """{mangled kernel name: "Used ... registers, ...; ... spill ..."},
    one entry per kernel, from the ``ptxas -v`` log kept beside the
    library."""
    so, _ = build.library_path(name, ops.CSRC)
    report, kernel, spills = {}, "", ""
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line:
            report[kernel] = f"{line.split(':', 1)[1].strip()}; {spills}"
    return report


def _inputs(torch, case, seed):
    B, H, KV, S, hd, _, _, dtype = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)
    return rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)


def _hold(torch, ref, label, out, q, k, v, dtype, **kw) -> tuple:
    """The kernel's output against the plain version on the same inputs
    (TOL), and in bf16 also against the plain version run in float32
    (TIGHT). Returns (max |out - plain|, TIGHT ratio or None): the worst
    |out - plain32| over its allowance, which holds while <= 1."""
    plain = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    ok = torch.allclose(out.float(), plain.float(), atol=TOL[dtype],
                        rtol=TOL[dtype]) and bool(torch.isfinite(out).all())
    tight = None
    if dtype == "bfloat16":
        plain32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                          **kw)
        tight = ((out.float() - plain32).abs() / (
            TIGHT["atol"] + TIGHT["rtol"] * plain32.abs())).max().item()
        ok = ok and tight <= 1
        del plain32
    log(f"kernel flash_attention {label}: max_abs_err {err:.3g} (tol "
        f"{TOL[dtype]})" + ("" if tight is None else
                            f", error / TIGHT {tight:.3g}")
        + f" {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {label}")
    return err, tight


def phase_kernels(torch, ops, ref) -> dict:
    """Both flash kernels vs the plain version at every case; times at
    the prefill shape. Returns the sm90 kernel's record; its launches stay
    None unless the serve phase runs and fills them in."""
    import torch.nn.functional as F
    sm90 = ops.flash_attention.variant_launches
    for i, case in enumerate(FLASH_CASES + [GRANITE_PREFILL_F32,
                                            MIXTRAL_PREFILL]):
        B, H, KV, S, hd, causal, window, dtype = case
        q, k, v = _inputs(torch, case, seed=i)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        variant = ops.select_variant(q.dtype, hd)
        _hold(torch, ref, f"{case} [{variant}]", out, q, k, v, dtype,
              causal=causal, window=window)
    for i, case in enumerate(SM90_CASES):
        B, H, KV, Sq, Sk, hd, causal, window, q_offset, softcap, view = case
        g = torch.Generator(device="cuda").manual_seed(100 + i)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").bfloat16()
        q = rnd(B, Sq, H, hd)
        k, v = rnd(B, 2 * Sk, KV, hd), rnd(B, 2 * Sk, KV, hd)
        k, v = (k[:, :Sk], v[:, Sk:]) if view else \
            (k[:, :Sk].contiguous(), v[:, :Sk].contiguous())
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  softcap=softcap)
        before = sm90["sm90"]
        out = ops.flash_attention(q, k, v, **kw)
        assert sm90["sm90"] == before + 1, f"{case} did not run sm90"
        _hold(torch, ref, f"{case} [sm90]", out, q, k, v, "bfloat16", **kw)

    # the granite-8b prefill shape: both kernels held to the plain version,
    # then all four timed in turns
    B, H, KV, S, hd, causal, window, dtype = GRANITE_PREFILL
    q, k, v = _inputs(torch, GRANITE_PREFILL, seed=len(FLASH_CASES) + 1)
    kw = dict(causal=causal, window=window)
    assert ops.select_variant(q.dtype, hd) == "sm90"
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    err, tight = _hold(torch, ref, f"{GRANITE_PREFILL} [sm90]", out, q, k,
                       v, dtype, **kw)
    # the rows' LSE the backward reads: float32 scores in both, summed in
    # another order, exp2 approximated (2^-22) in the kernel
    _, plain_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    lse_err = (lse - plain_lse).abs().max().item()
    log(f"kernel flash_attention {GRANITE_PREFILL} [sm90] LSE: max abs err "
        f"{lse_err:.3g} against the plain version (gate {LSE_GATE}) "
        f"{'ok' if lse_err <= LSE_GATE else 'MISMATCH'}")
    if not lse_err <= LSE_GATE:
        raise AssertionError("the sm90 forward's LSE disagrees with its "
                             "plain version")
    del lse, plain_lse
    earlier, _ = ops.run_variant("fma", q, k, v, **kw)
    _, earlier_tight = _hold(torch, ref, f"{GRANITE_PREFILL} [fma]", earlier,
                             q, k, v, dtype, **kw)
    # library yardstick: SDPA on (B, H, S, hd) with the KV heads repeated
    # for GQA (the repeat is outside the timed call)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    lib_err = (lib.transpose(1, 2).float() - out.float()).abs().max()
    ms = timed_turns(torch, {
        "sm90": lambda: ops.flash_attention(q, k, v, **kw),
        "fma": lambda: ops.run_variant("fma", q, k, v, **kw),
        "plain": lambda: ref.flash_attention_ref(q, k, v, **kw),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal),
    }, reps={"fma": 5, "plain": 5})
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    flops = 4 * B * H * hd * visible_pairs(S, S, causal, window)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    log(f"timing flash_attention at {GRANITE_PREFILL}, in turns: sm90 "
        f"(LSE written) "
        f"{ms['sm90']:.4f} ms ({flops / ms['sm90'] / 1e9:.1f} TFLOP/s), "
        f"fma {ms['fma']:.4f} ms ({flops / ms['fma'] / 1e9:.2f} TFLOP/s), "
        f"plain {ms['plain']:.4f} ms, sdpa {ms['sdpa']:.4f} ms "
        f"({flops / ms['sdpa'] / 1e9:.1f} TFLOP/s; max |sdpa - sm90| "
        f"{lib_err.item():.3g}); bound {max(t_bytes, t_ops):.4f} ms "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 2**20:.1f} MiB); fma against "
        f"the float32 plain version: error / TIGHT {earlier_tight:.3g}")
    record = {
        "name": "flash_attention", "variant": "sm90", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
        "launches": None, "variant_launches": None,
        "max_abs_err": err, "tight_gate_ratio": tight,
        "ms": ms["sm90"], "plain_ms": ms["plain"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": ms["sdpa"],
        "earlier_ms": ms["fma"],
        "earlier_source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention.cu",
    }
    del q, k, v, out, earlier, qt, kt, vt, lib
    torch.cuda.empty_cache()
    return record


def profile(torch, label: str, fn, top: int = 6,
            part=None) -> tuple[float, float]:
    """Host time, device-busy time and the kernels that take the most
    device time for one call of ``fn`` (torch.profiler, after warm-up);
    with ``part`` = (name, substring), also the device time of the
    kernels whose names hold the substring and their share of the busy
    time. Returns (wall ms, device-busy ms)."""
    from torch.profiler import ProfilerActivity
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    log(f"profile {label}: wall {host_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / host_ms:.1%}), {sum(e.count for e in evs)} "
        f"kernels")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} "
            f"{e.key[:90]}")
    if part is not None:
        mine = [e for e in evs if part[1] in e.key]
        part_ms = sum(e.self_device_time_total for e in mine) / 1e3
        log(f"profile {label}: {part[0]} kernels {part_ms:.3f} ms "
            f"(x{sum(e.count for e in mine)}) of {busy_ms:.2f} ms of device "
            f"time ({part_ms / busy_ms:.1%})")
    return host_ms, busy_ms


def _requests(Request, cfg, n, seed, plen=(128, 1024), max_new=32):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(plen[0],
                                                         plen[1] + 1))
                                        ).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


GEOMETRY = dict(max_batch=8, max_len=2048, block_size=16, num_blocks=1025)


def phase_serve(torch, ops, cfg) -> dict:
    """Full granite-8b in bf16 through the engine; returns the kernels'
    launch counts of the measured run."""
    from repro_torch import obs
    from repro_torch.models import init_params, prefill_batched
    from repro_torch.serving import Request, ServingEngine
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.num_layers} layers d_model "
        f"{cfg.d_model} {cfg.dtype}, {cfg.param_count() / 1e9:.2f} B "
        f"params, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # warm-up: a separate engine, so cuBLAS and the allocator are set up
    # before the measured run
    warm = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    for r in _requests(Request, cfg, 1, seed=99, plen=(128, 128),
                       max_new=2):
        warm.submit(r)
    warm.run_until_drained()
    del warm
    torch.cuda.empty_cache()

    eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    reqs = _requests(Request, cfg, 8, seed=0)
    for r in reqs:
        eng.submit(r)
    tracer = obs.get_tracer()
    tracer.drain()
    obs.enable(True)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    obs.enable(False)
    spans = {}
    for ev in tracer.drain():
        if ev[0] == "X":
            spans.setdefault(ev[1], []).append(ev[6] / 1e3)   # ms
    s = eng.stats
    assert len(done) == len(reqs), f"{len(done)} of {len(reqs)} completed"
    assert all(len(r.output) == r.max_new_tokens for r in done.values())
    assert all(0 <= t < cfg.vocab_size for r in done.values()
               for t in r.output), "token outside the vocab"
    assert s.leaked_blocks == 0, f"{s.leaked_blocks} blocks leaked"
    want = cfg.num_layers * s.prefill_calls
    assert launches["flash_attention"] == want > 0, \
        f"flash_attention launched {launches['flash_attention']} times, " \
        f"expected {cfg.num_layers} x {s.prefill_calls} prefill calls"
    assert launches["flash_attention/sm90"] == want, \
        f"{launches['flash_attention/sm90']} of {want} prefill attention " \
        f"launches went to the sm90 kernel"
    assert launches["wkv6"] == 0, "granite-8b has no RWKV layer"
    summary = s.to_dict()
    prefill_ms = spans.get("serving/prefill_batch", [])
    decode_ms = spans.get("serving/decode_step", [])
    log(f"serve: {len(done)} requests, {s.prefill_tokens} prompt tokens, "
        f"{s.generated_tokens} generated in {wall:.3f} s -> "
        f"{s.generated_tokens / wall:.1f} tok/s; ttft p50 "
        f"{summary['ttft_p50_s']:.4f} s; {s.prefill_calls} prefill calls "
        f"({', '.join(f'{t:.1f}' for t in prefill_ms)} ms); "
        f"{s.decode_steps} decode steps, median "
        f"{statistics.median(decode_ms):.2f} ms; "
        f"{s.preempted} preemptions; peak "
        f"{s.peak_blocks_in_use}/{eng.allocator.capacity} blocks; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve: flash_attention launches {launches['flash_attention']} "
        f"= {cfg.num_layers} layers x {s.prefill_calls} prefill calls, "
        f"{launches['flash_attention/sm90']} of them sm90")
    # where the time goes: one prefill call and one decode step at this
    # geometry, under the profiler (after the measured run)
    B, W = eng.max_batch, eng.max_blocks_per_req
    tokens = torch.ones((B, 1024), dtype=torch.int32, device="cuda")
    plens = torch.full((B,), 1024, dtype=torch.int32, device="cuda")
    logits, _ = prefill_batched(cfg, params, tokens, plens)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    profile(torch, "prefill B=8 S=1024",
            lambda: prefill_batched(cfg, params, tokens, plens))
    bt = torch.arange(1, 1 + B * W, dtype=torch.int32,
                      device="cuda").reshape(B, W)
    lens = torch.full((B,), 1040, dtype=torch.int32, device="cuda")
    profile(torch, "decode step B=8 max_len=2048",
            lambda: eng._decode(bt, tokens[:, :1], lens))
    del eng, params, logits
    torch.cuda.empty_cache()
    return launches


def _stack_rows(torch, caches: list):
    """One batch from per-request caches (a copy; leaves under
    ``periods`` carry the batch on axis 1)."""
    from repro_torch.tree import tree_map_with_path
    return tree_map_with_path(
        lambda path, *rows: torch.cat(rows, dim=1 if path[0] == "periods"
                                      else 0), caches[0], *caches[1:])


def phase_token_equality(torch, cfg) -> None:
    """Continuous batching == sequential prefill + decode_step, float32,
    full width, 2 layers.

    A batched and a sequential call run cuBLAS in different summation
    orders, so their logits differ by some d, measured here at the
    prefill and at the first decode step. The sequential reference is
    fed the engine's tokens; at every step the engine's token must be
    the reference's argmax, or, where two logits lie within
    ``limit = 4 d`` of each other (a near-tie that d can flip), within
    ``limit`` of the reference's maximum."""
    from repro_torch.models import (decode_step, init_params, prefill,
                                    prefill_batched)
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         "cuda")
    eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    reqs = _requests(Request, cfg, 8, seed=1)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert eng.stats.leaked_blocks == 0
    outs = [done[r.rid].output for r in reqs]
    plens = [len(r.prompt) for r in reqs]
    # sequential prefill, one request at a time
    seq = [prefill(cfg, params, {"tokens": torch.from_numpy(
        r.prompt[None]).cuda()}, GEOMETRY["max_len"]) for r in reqs]
    # batched-vs-sequential logit difference d: the padded batched
    # prefill the engine runs, and one decode step over the stacked
    # sequential caches at per-row positions
    S = 1 << max(3, (max(plens) - 1).bit_length())
    tokens = torch.zeros((len(reqs), S), dtype=torch.int32, device="cuda")
    for j, r in enumerate(reqs):
        tokens[j, :plens[j]] = torch.from_numpy(r.prompt)
    lens = torch.tensor(plens, dtype=torch.int32, device="cuda")
    b_logits, _ = prefill_batched(cfg, params, tokens, lens)
    d_prefill = max(float((b_logits[j, -1] - seq[j][0][0, -1]).abs().max())
                    for j in range(len(reqs)))
    first = torch.tensor([[o[0]] for o in outs], device="cuda")
    b_logits, _ = decode_step(cfg, params,
                              _stack_rows(torch, [c for _, c in seq]),
                              first, lens)
    # sequential decode, fed the engine's tokens; per step: (request,
    # step, top-2 gap, argmax, engine's token, how far its logit lies
    # below the maximum)
    d_decode, steps = 0.0, []
    for j, r in enumerate(reqs):
        logits, caches = seq[j]
        pos = plens[j]
        for i, tok in enumerate(outs[j]):
            row = logits[0, -1]
            if i == 1:
                d_decode = max(d_decode, float(
                    (b_logits[j, -1] - row).abs().max()))
            top2 = row.topk(2)
            steps.append((r.rid, i, float(top2.values[0] - top2.values[1]),
                          int(top2.indices[0]), tok,
                          float(top2.values[0] - row[tok])))
            if i + 1 < len(outs[j]):
                logits, caches = decode_step(
                    cfg, params, caches,
                    torch.tensor([[tok]], device="cuda"), pos)
                pos += 1
    limit = 4 * max(d_prefill, d_decode)
    ties = sum(gap <= limit for _, _, gap, _, _, _ in steps)
    flips = sum(tok != top for _, _, _, top, tok, _ in steps)
    mismatched = [(rid, i) for rid, i, _, top, tok, behind in steps
                  if tok != top and behind > limit]
    log(f"token equality: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"float32, {len(reqs)} requests x {reqs[0].max_new_tokens} tokens,"
        f" {eng.stats.prefill_calls} prefill calls; batched-vs-sequential "
        f"max |logit diff| prefill {d_prefill:.3g} decode {d_decode:.3g}, "
        f"near-tie limit {limit:.3g}; min top-2 logit gap "
        f"{min(s[2] for s in steps):.3g}; {ties} steps within the limit, "
        f"{flips} tokens differ from the sequential argmax, mismatched "
        f"(request, step) {mismatched}")
    assert not mismatched, f"continuous batching != sequential at " \
        f"{mismatched}"
    del eng, params, seq, b_logits
    torch.cuda.empty_cache()


def _rwkv_inputs(torch, case, seed, decay: str, state: bool,
                 view: bool = False):
    """r, k, v ~ N(0, 1) in the case's dtype (k ~ 0.3 N for the test
    draw); u ~ 0.1 N; decay from the reference test's distribution
    (``test``: w = exp(-exp(0.5 N - 2))) or the model's at init
    (``model``: w = exp(-exp(-6 + 0.05 N)), w0 = -6 and a small LoRA
    term); state0 ~ N(0, 1) or None. With ``view``, r, k and v are views
    of one (B, S, 3, H, hd) tensor."""
    B, H, S, hd, _, dtype = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    dt = getattr(torch, dtype)
    if view:
        rkv = n(B, S, 3, H, hd)
        rkv[:, :, 1] *= 0.3 if decay == "test" else 1.0
        r, k, v = rkv.to(dt).unbind(2)
    else:
        r, k, v = n(B, S, H, hd), n(B, S, H, hd), n(B, S, H, hd)
        k = k * 0.3 if decay == "test" else k
    if decay == "test":
        w = torch.exp(-torch.exp(n(B, S, H, hd) * 0.5 - 2.0))
    else:
        w = torch.exp(-torch.exp(-6.0 + 0.05 * n(B, S, H, hd)))
    u = n(H, hd) * 0.1
    s0 = n(B, H, hd, hd) if state else None
    return r.to(dt), k.to(dt), v.to(dt), w, u, s0


def _gate(out, plain) -> tuple[float, float]:
    """(max |out - plain|, that over the gate's allowance)."""
    err = (out - plain).abs().max().item()
    allow = RWKV_GATE * max(1.0, plain.abs().max().item())
    return err, err / allow


def _hold_rwkv(torch, ref, label, out, args, chunk) -> tuple:
    """A kernel's (y, S_last) against the plain version on the same
    inputs under RWKV_GATE, finite; logs and returns (max |y - plain|,
    the worse error / gate), and raises past 1."""
    y, s_last = out
    y_p, s_p = ref.wkv_ref(*args, chunk)
    torch.cuda.synchronize()
    (ey, ry), (es, rs) = _gate(y, y_p), _gate(s_last, s_p)
    ok = max(ry, rs) <= 1 and bool(torch.isfinite(y).all()) and \
        bool(torch.isfinite(s_last).all())
    log(f"kernel wkv6 {label}: max |y - plain| {ey:.3g} (max |y| "
        f"{y_p.abs().max().item():.3g}), max |S - plain| {es:.3g} (max |S| "
        f"{s_p.abs().max().item():.3g}); error / gate y {ry:.3g} S "
        f"{rs:.3g} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"wkv6 disagrees with its plain version at "
                             f"{label}")
    return ey, max(ry, rs)


def phase_rwkv_kernels(torch, ops, ref) -> dict:
    """Both RWKV6 kernels against the plain version, y and S_last, at
    every case; times at the rwkv6-7b prefill shape. Returns the mma
    kernel's record; its launches stay None unless the rwkv_generate
    phase runs and fills them in."""
    runs = [(c, "test", st) for c in RWKV_CASES + MMA_CASES
            for st in (False, True)]
    runs += [(RWKV_PREFILL_F32, "model", True),
             (RWKV_PREFILL, "model", True), (RWKV_PREFILL, "test", True)]
    counts = ops.wkv6.variant_launches
    worst, record = 0.0, None
    for i, (case, decay, state) in enumerate(runs):
        view = len(case) > 6 and case[6]
        args = _rwkv_inputs(torch, case, 100 + i, decay, state, view)
        r, k, v, w, u, s0 = args
        B, H, S, hd, chunk, dtype = case[:6]
        variant = ops.select_variant(r.dtype, hd)
        before = counts[variant]
        out = ops.wkv6(*args, chunk)
        assert counts[variant] == before + 1, f"{case} did not run {variant}"
        label = (f"{case} decay={decay} state0="
                 f"{'random' if state else 'zero'} [{variant}]")
        err, ratio = _hold_rwkv(torch, ref, label, out, args, chunk)
        worst = max(worst, ratio)
        if case is not RWKV_PREFILL:
            continue
        # the bf16 prefill shape: the first kernel held as well
        assert variant == "mma", f"wkv6 chose {variant} at {case}"
        earlier = ops.run_variant("fma", *args, chunk)
        _, earlier_ratio = _hold_rwkv(
            torch, ref, label.replace("[mma]", "[fma]"), earlier, args, chunk)
        if decay != "model":
            continue
        y, s_last = out
        ms = timed_turns(torch, {
            "mma": lambda: ops.wkv6(*args, chunk),
            "fma": lambda: ops.run_variant("fma", *args, chunk),
            "plain": lambda: ref.wkv_ref(*args, chunk),
        }, reps={"plain": 5})
        nbytes = sum(t.numel() * t.element_size()
                     for t in (r, k, v, w, u, s0, y, s_last))
        nchunks = -(-S // chunk)
        # four products per (b, h, chunk): r_in k_inᵀ (C x C x hd),
        # r_inter S (C x hd x hd), A v (C x C x hd), k_tailᵀ v (hd x C x hd)
        flops = 2 * B * H * nchunks * (2 * chunk * chunk * hd
                                       + 2 * chunk * hd * hd)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        blocks = ops.mma_blocks_per_sm()
        log(f"timing wkv6 at {case}, in turns: mma {ms['mma']:.4f} ms "
            f"({flops / ms['mma'] / 1e9:.2f} TFLOP/s, "
            f"{nbytes / ms['mma'] / 1e6:.1f} GB/s; {blocks} blocks per "
            f"SM), fma {ms['fma']:.4f} ms, plain {ms['plain']:.4f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 2**20:.1f} MiB, "
            f"{flops / 1e9:.2f} GFLOP); fma error / gate "
            f"{earlier_ratio:.3g}; no PyTorch call computes the recurrence")
        record = {
            "name": "wkv6", "variant": "mma", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6_mma.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:74",
            "launches": None, "variant_launches": None,
            "max_abs_err": err, "ms": ms["mma"], "plain_ms": ms["plain"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "earlier_ms": ms["fma"],
            "earlier_source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
            "blocks_per_sm": blocks,
        }
        del earlier
    record["gate_ratio"] = worst
    log(f"kernel wkv6: {len(runs)} runs, worst error / gate {worst:.3g}")
    del args, out, r, k, v, w, u, s0
    torch.cuda.empty_cache()
    return record


def _greedy(torch, cfg, params, tokens, n_new: int):
    """prefill + (n_new - 1) greedy decode_step calls. Returns the
    generated tokens (B, n_new) and the logits of every step."""
    from repro_torch.models import decode_step, prefill
    B, S = tokens.shape
    logits, caches = prefill(cfg, params, {"tokens": tokens}, S + n_new)
    steps = [logits[:, -1]]
    out = [logits[:, -1].argmax(-1)]
    for i in range(n_new - 1):
        logits, caches = decode_step(cfg, params, caches, out[-1][:, None],
                                     S + i)
        out.append(logits[:, -1].argmax(-1))
        steps.append(logits[:, -1])
    return torch.stack(out, 1), steps


def phase_rwkv_generate(torch, cfg) -> dict:
    """Full rwkv6-7b in bf16: one prefill of 8 x 1024 tokens, 31 decode
    steps; returns the kernels' launch counts of that run."""
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    leaves = []
    tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    log(f"rwkv: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{cfg.dtype}, {n_params / 1e9:.3f} B parameters in the tensors "
        f"({cfg.param_count() / 1e9:.3f} B by the reference's analytic "
        f"count, which leaves out w_g and cm_r), init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    B, S, n_new = 8, 1024, 32
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))
                              .astype(np.int32)).cuda()
    # warm-up (cuBLAS handles, the allocator), then the measured run
    _greedy(torch, cfg, params, tokens[:, :128], 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, params, {"tokens": tokens}, S + n_new)
    out = [logits[:, -1].argmax(-1)]
    out[-1].cpu()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = read_counts()
    step_ms = []
    for i in range(n_new - 1):
        t1 = time.perf_counter()
        logits, caches = decode_step(cfg, params, caches, out[-1][:, None],
                                     S + i)
        out.append(logits[:, -1].argmax(-1))
        out[-1].cpu()                     # the host needs the token
        step_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    gen = torch.stack(out, 1)
    assert gen.shape == (B, n_new)
    assert bool(((gen >= 0) & (gen < cfg.vocab_size)).all()), \
        "token outside the vocab"
    assert bool(torch.isfinite(logits).all())
    assert after_prefill["wkv6"] == cfg.num_layers > 0, \
        f"wkv6 launched {after_prefill['wkv6']} times in one prefill " \
        f"call, expected {cfg.num_layers}"
    assert after_prefill["wkv6/mma"] == cfg.num_layers, \
        f"{after_prefill['wkv6/mma']} of {cfg.num_layers} prefill wkv6 " \
        f"launches went to the mma kernel"
    assert launches["wkv6"] == after_prefill["wkv6"] and \
        launches["wkv6/mma"] == after_prefill["wkv6/mma"], \
        "a decode step launched an RWKV6 kernel"
    assert launches["flash_attention"] == 0, "rwkv6-7b has no attention"
    log(f"rwkv: {B} requests x {S} prompt tokens, {B * n_new} generated in "
        f"{wall:.3f} s -> {B * n_new / wall:.1f} tok/s; prefill (= TTFT) "
        f"{prefill_ms:.1f} ms; {n_new - 1} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms (min {min(step_ms):.2f}, "
        f"max {max(step_ms):.2f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"rwkv: wkv6 launches {launches['wkv6']} = {cfg.num_layers} layers "
        f"x 1 prefill call, {launches['wkv6/mma']} of them mma; 0 in "
        f"{n_new - 1} decode steps")
    profile(torch, f"rwkv prefill B={B} S={S}",
            lambda: prefill(cfg, params, {"tokens": tokens}, S + n_new))
    profile(torch, f"rwkv decode step B={B}",
            lambda: decode_step(cfg, params, caches, out[-1][:, None],
                                S + n_new))
    del params, caches, logits
    torch.cuda.empty_cache()
    return launches


def phase_rwkv_equality(torch, cfg) -> None:
    """Full width, 2 layers, float32: (a) batched greedy == each request
    alone, with the near-tie rule of phase_token_equality; (b) prefill
    of 512 then decode_step of 512 == prefill of 1024."""
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_map_with_path
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         "cuda")
    B, S, n_new = 8, 1024, 32
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))
                              .astype(np.int32)).cuda()
    gen, b_steps = _greedy(torch, cfg, params, tokens, n_new)
    # each request alone, fed the batched run's tokens; per step:
    # (request, step, top-2 gap, argmax, batched token, how far its logit
    # lies below the maximum)
    d_prefill = d_decode = 0.0
    steps = []
    for j in range(B):
        logits, caches = prefill(cfg, params, {"tokens": tokens[j:j + 1]},
                                 S + n_new)
        for i in range(n_new):
            row = logits[0, -1]
            d = float((b_steps[i][j] - row).abs().max())
            if i == 0:
                d_prefill = max(d_prefill, d)
            elif i == 1:
                d_decode = max(d_decode, d)
            top2 = row.topk(2)
            tok = int(gen[j, i])
            steps.append((j, i, float(top2.values[0] - top2.values[1]),
                          int(top2.indices[0]), tok,
                          float(top2.values[0] - row[tok])))
            if i + 1 < n_new:
                logits, caches = decode_step(cfg, params, caches,
                                             gen[j:j + 1, i:i + 1], S + i)
    limit = 4 * max(d_prefill, d_decode)
    ties = sum(gap <= limit for _, _, gap, _, _, _ in steps)
    flips = sum(tok != top for _, _, _, top, tok, _ in steps)
    mismatched = [(j, i) for j, i, _, top, tok, behind in steps
                  if tok != top and behind > limit]
    log(f"rwkv equality: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"float32, {B} requests x {n_new} tokens; batched-vs-alone max "
        f"|logit diff| prefill {d_prefill:.3g} decode {d_decode:.3g}, "
        f"near-tie limit {limit:.3g}; min top-2 logit gap "
        f"{min(st[2] for st in steps):.3g}; {ties} steps within the limit,"
        f" {flips} tokens differ from the alone argmax, mismatched "
        f"(request, step) {mismatched}")
    assert not mismatched, f"batched != alone at {mismatched}"

    # (b) the kernel seeded from a non-zero state on the main path
    half = S // 2
    full_logits, full = prefill(cfg, params, {"tokens": tokens}, S)
    _, split = prefill(cfg, params, {"tokens": tokens[:, :half]}, S)
    reset_counts()
    split_logits, split = decode_step(cfg, params, split, tokens[:, half:],
                                      half)
    assert read_counts()["wkv6"] == cfg.num_layers, \
        "decode_step with several tokens did not run the kernel"
    ratios = {}

    def compare(path, a, b):
        err = float((a.float() - b.float()).abs().max())
        scale = max(1.0, float(b.float().abs().max()))
        ratios["/".join(map(str, path))] = (err, err / (SPLIT_GATE * scale))
    compare(("logits",), split_logits[:, -1], full_logits[:, -1])
    tree_map_with_path(compare, split, full)
    worst = max(r for _, r in ratios.values())
    log(f"rwkv split prefill: prefill 512 + decode_step 512 vs prefill "
        f"1024: max |diff| " + ", ".join(
            f"{k} {e:.3g}" for k, (e, _) in ratios.items())
        + f"; worst error / gate ({SPLIT_GATE} of the scale) {worst:.3g} "
        f"{'ok' if worst <= 1 else 'MISMATCH'}")
    assert worst <= 1, "split prefill disagrees with one prefill"
    del params, full, split, full_logits, split_logits, b_steps
    torch.cuda.empty_cache()


def decode_matmul_flops(cfg, batch: int, max_len: int) -> float:
    """Matmul FLOPs of one paged decode step, counted from the config
    (independently of any trace): the q/k/v/o projections, the MLP,
    attention of one query over the ``max_len`` view (scores and the
    weighted sum), and the LM head, for ``batch`` rows."""
    d, hd = cfg.d_model, cfg.head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    proj = 2 * batch * d * (2 * q + 2 * kv)
    mlp = (3 if cfg.gated_mlp else 2) * 2 * batch * d * cfg.d_ff
    attn = 2 * 2 * batch * cfg.num_heads * max_len * hd
    head = 2 * batch * d * cfg.padded_vocab
    return float(cfg.num_layers * (proj + mlp + attn) + head)


#: How the static verifier judges full granite-8b's quarter-cap K=4
#: plan today: ParDNN calls it feasible, but the certificate, which
#: replays the segment schedule, holds more on PE 3 than the cap
#: (ROADMAP: reconcile the emulator's feasibility with the certificate).
QUARTER_CAP_REFUSAL = {("RP020", 3), ("RP040", 3)}


def _serving_meta(cfg, geometry: dict) -> dict:
    """The metadata ``serving.partition_for_serving`` records, so that
    ``plan.serve`` rebuilds the engine at ``geometry``."""
    from repro_torch.serving import serving_geometry
    return {"serving": serving_geometry(**geometry), "arch": cfg.name,
            "static_argnums": [0]}


def _half_cap_plan(api, traced, card: float, quarter=None, meta=None):
    """The K=4 plan under half the card per PE, verified clean, after
    asserting that the verifier refuses the quarter-cap plan exactly as
    ``QUARTER_CAP_REFUSAL`` says (a change either way fails here, so
    that it is seen). Logs both verifications."""
    plans = {"quarter": quarter if quarter is not None
             else api.partition(traced, devices=4, memory=card / 4,
                                meta=meta),
             "half": api.partition(traced, devices=4, memory=card / 2,
                                   meta=meta)}
    for label, plan in plans.items():
        rep = plan.verify()
        c = rep.counts()
        cert, segments = _certificate(plan)
        log(f"verify: K=4 {label} cap ({plan.devices.memory / 2**30:.3f} "
            f"GiB per PE, feasible={plan.feasible}, {segments} segments, "
            f"certificate [" + ", ".join(f"{x / 2**30:.3f}" for x in cert)
            + f"] GiB): {c['error']}E/{c['warn']}W/{c['info']}I, passes "
            f"{', '.join(rep.passes_run)}"
            + "".join(f"; {d}" for d in rep.errors[:2]))
        refused = {(d.code, d.device) for d in rep.errors}
        want = QUARTER_CAP_REFUSAL if label == "quarter" else set()
        assert refused == want, \
            f"the verifier's errors on the {label}-cap plan are " \
            f"{sorted(refused)}, expected {sorted(want)}"
    return plans["half"]


def phase_plan(torch, cfg, plan_path: Path) -> tuple:
    """Trace → partition → plan for the paged decode step at full
    granite-8b width (bf16, random weights from a seed) at the serve
    phase's geometry: trace on cuda with the program recorded, the
    matmul FLOPs held to a count from the config; partition at K=4 under
    a quarter of the card and under a tight cap; save the half-cap plan
    to ``plan_path`` (the plan_serve phase serves it), load it and bind
    it to a fresh trace; the predicted step time beside the measured
    eager step. First, at the reduced size, the graph's fingerprint must
    be the same for a trace on the CPU and on the card. Returns the trace
    and the verified half-cap plan (plan_execute runs them)."""
    from repro_torch import api
    from repro_torch.configs import reduced
    from repro_torch.core.costmodel import H100
    from repro_torch.core.emulator import emulate
    from repro_torch.core.graph import RESIDUAL
    from repro_torch.core.tracing import DOT_OPS
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import tree_map

    small = reduced(cfg)
    cpu_params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    prints = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        eng = ServingEngine(small, params, device=dev, **GEOMETRY)
        prints[dev] = api.trace(eng._decode_impl,
                                *eng._decode_example_args()).fingerprint
    assert len(set(prints.values())) == 1, \
        f"the reduced graph's fingerprint depends on the device: {prints}"
    log(f"plan: reduced {small.name} fingerprint {prints['cpu'][:16]} on "
        f"cpu and cuda")
    del cpu_params, params, eng

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    reset_counts()
    t0 = time.perf_counter()
    traced = api.trace(eng._decode_impl, *eng._decode_example_args(),
                       record=True)
    trace_s = time.perf_counter() - t0
    g = traced.graph
    n_edges = sum(len(e) for e in g.out_edges)
    res_bytes = float(g.mem[g.ntype == RESIDUAL].sum())
    transient = float(g.mem[g.ntype != RESIDUAL].max())
    mm = float(sum(g.op_flops[i] for i in range(g.n)
                   if g.names[i] in DOT_OPS))
    want = decode_matmul_flops(cfg, GEOMETRY["max_batch"],
                               GEOMETRY["max_len"])
    log(f"plan: traced {cfg.name} decode step (B={GEOMETRY['max_batch']}, "
        f"max_len={GEOMETRY['max_len']}) on cuda in {trace_s:.2f} s: "
        f"{g.n} nodes, {n_edges} edges, {len(traced.program.input_nodes)} "
        f"input leaves, RESIDUAL {res_bytes / 2**30:.3f} GiB, largest "
        f"transient {transient / 2**30:.3f} GiB, {g.op_flops.sum():.6g} "
        f"FLOPs, matmul {mm:.6g} (from the config {want:.6g})")
    assert mm == want, f"matmul FLOPs {mm} != {want} counted from the config"

    k = 4
    card = torch.cuda.get_device_properties(0).total_memory
    caps = {"quarter": card / k,
            "tight": 1.2 * (res_bytes + transient) / k}
    plans = {}
    meta = _serving_meta(cfg, GEOMETRY)
    for label, cap in caps.items():
        t0 = time.perf_counter()
        plan = api.partition(traced, devices=k, memory=cap, meta=meta)
        part_s = time.perf_counter() - t0
        a, peaks = plan.assignment, plan.peak_mem
        assert a.shape == (g.n,) and a.min() >= 0 and a.max() < k, \
            f"{label}: a node is assigned outside [0, {k})"
        planned = cap * api.PardnnOptions().memory_fraction
        if plan.feasible:
            assert (peaks <= planned).all(), \
                f"{label}: feasible, but peaks {peaks} exceed {planned}"
        stages = {st: round(t, 3)
                  for st, t in plan.report.stage_seconds.items()}
        cut, cut_by_src = 0, {}
        for u in range(g.n):
            for v, c in g.out_edges[u]:
                if a[u] != a[v]:
                    cut += 1
                    src = g.names[u].split(".")[0]
                    cut_by_src[src] = cut_by_src.get(src, 0.0) + \
                        (c - H100.link_latency) * H100.link_bw
        cut_bytes = sum(cut_by_src.values())
        top_cut = sorted(cut_by_src.items(), key=lambda x: -x[1])[:3]
        log(f"plan: K={k} {label} cap {cap / 2**30:.3f} GiB per PE "
            f"(planned to {planned / 2**30:.3f}): partition {part_s:.2f} s, "
            f"feasible={plan.feasible}, peaks "
            f"[{', '.join(f'{p / 2**30:.3f}' for p in peaks)}] GiB, moved "
            f"{plan.report.moved_nodes} nodes in "
            f"{plan.report.counters.get('step2_rounds')} Step-2 rounds, "
            f"{cut} cut edges, {cut_bytes / 2**20:.1f} MiB cut ("
            + ", ".join(f"from {n} {b / 2**20:.1f}" for n, b in top_cut)
            + f"), makespan {plan.makespan * 1e3:.3f} ms; stages {stages}")
        plans[label] = plan

    # save verifies the plan first, as the reference's does
    plan, label = _half_cap_plan(api, traced, card, plans["quarter"],
                                 meta), "half"
    loaded = api.PartitionPlan.load(plan.save(str(plan_path)))
    t0 = time.perf_counter()
    fresh = api.trace(eng._decode_impl, *eng._decode_example_args(),
                      record=True)
    retrace_s = time.perf_counter() - t0
    loaded.bind(fresh)
    assert loaded.fingerprint == fresh.fingerprint == traced.fingerprint
    assert loaded.assignment.dtype == plan.assignment.dtype
    assert np.array_equal(loaded.assignment, plan.assignment), \
        "the loaded plan's assignment differs"
    log(f"plan: the {label}-cap plan saved, loaded and bound to a fresh "
        f"trace ({retrace_s:.2f} s): fingerprint and assignment equal")

    one_pe = emulate(g, np.zeros(g.n, dtype=np.int64), 1).makespan
    by_op: dict = {}
    for i in range(g.n):
        name = g.names[i].split(".")[0]
        by_op[name] = by_op.get(name, 0.0) + float(g.comp[i])
    top = sorted(by_op.items(), key=lambda x: -x[1])[:6]
    log(f"plan: predicted step on one PE {one_pe * 1e3:.3f} ms "
        f"({', '.join(f'{n} {t * 1e3:.2f}' for n, t in top)} ms), at K={k} "
        f"(quarter cap) {plans['quarter'].makespan * 1e3:.3f} ms, ({label} "
        f"cap) {plan.makespan * 1e3:.3f} ms")
    B, W = eng.max_batch, eng.max_blocks_per_req
    bt = torch.arange(1, 1 + B * W, dtype=torch.int32,
                      device="cuda").reshape(B, W)
    toks = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    lens = torch.full((B,), 1040, dtype=torch.int32, device="cuda")
    walls = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._decode(bt, toks, lens)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms, busy_ms = profile(
        torch, "plan: eager decode step B=8 max_len=2048",
        lambda: eng._decode(bt, toks, lens), top=3)
    launches = read_counts()
    assert not any(launches.values()), \
        f"a kernel launched on the plan path (one query token): {launches}"
    log(f"plan: measured eager step median {statistics.median(walls):.2f} "
        f"ms wall over {len(walls)} steps; profiled {wall_ms:.2f} ms wall, "
        f"{busy_ms:.2f} ms device; predicted one PE {one_pe * 1e3:.3f} ms, "
        f"K={k} {plans['quarter'].makespan * 1e3:.3f} ms (quarter cap)")
    # the recorded program keeps its example arguments (these parameters,
    # for calibration): plan_execute draws its own
    traced.program.in_tree_example = None
    del eng, params, fresh, plans, loaded
    _release(torch)
    return traced, plan


# compiled vs eager in bf16: the logits within 2^-7 of their largest
# magnitude (one bf16 step at that scale), greedy tokens equal on every
# row; in float32 the tolerance the reference holds its engines to
PLAN_BF16_GATE = 2.0 ** -7
PLAN_F32_GATE = 2e-5


def _decode_inputs(torch, eng, seed: int):
    """Random pools and a block table, tokens and lengths drawn from a
    seed at the engine's geometry: each row owns distinct blocks, the
    last row is padding aimed at the null block."""
    from repro_torch.tree import tree_map
    g = torch.Generator(device="cuda").manual_seed(seed)
    pools = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                           device="cuda").to(t.dtype),
                     eng.pools)
    B, W, bs = eng.max_batch, eng.max_blocks_per_req, eng.block_size
    per_row = min(W, (GEOMETRY["num_blocks"] - 1) // B)
    bt = torch.zeros((B, W), dtype=torch.int32, device="cuda")
    bt[:, :per_row] = (torch.randperm(B * per_row, generator=g,
                                      device="cuda") + 1).reshape(
        B, per_row).int()
    lens = torch.randint(0, per_row * bs, (B,), generator=g,
                         device="cuda").int()
    bt[-1], lens[-1] = 0, 0
    toks = torch.randint(1, eng.cfg.vocab_size, (B, 1), generator=g,
                         device="cuda").int()
    return pools, bt, toks, lens


def _leaves(out):
    from repro_torch.tree import tree_flatten
    logits, pools = out
    return [logits] + tree_flatten(pools)[0]


def _certificate(plan):
    """The verifier's per-PE peak-memory certificate of a plan, and the
    number of segments its schedule cuts the program into."""
    from repro_torch.analysis.passes import AnalysisContext, \
        abstract_interpret
    from repro_torch.core.segments import cut_segments
    prog = plan.traced.program
    sched = cut_segments(prog, plan.assignment, k=plan.k)
    ctx = AnalysisContext(prog=prog, assignment=plan.assignment, k=plan.k,
                          schedule=sched, graph=plan.traced.graph)
    return abstract_interpret(ctx).cert_peaks, sched.num_segments


def _hold_to_eager(torch, label, got, want, gate: float) -> bool:
    """Compiled (logits, pools) against the eager step's: greedy tokens
    equal on every row and the logits within ``gate`` x max |logits|.
    Returns whether every leaf was bit-equal."""
    g, w = _leaves(got), _leaves(want)
    scale = float(w[0].float().abs().max())
    err = float((g[0].float() - w[0].float()).abs().max())
    tok_g, tok_w = g[0][:, -1].argmax(-1), w[0][:, -1].argmax(-1)
    pool_err = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(g[1:], w[1:]))
    bit = all(torch.equal(a, b) for a, b in zip(g, w))
    ok = bool(torch.equal(tok_g, tok_w)) and err <= gate * scale and \
        all(bool(torch.isfinite(t.float()).all()) for t in g)
    log(f"plan_execute {label}: max |logits - eager| {err:.3g} (gate "
        f"{gate:.3g} x {scale:.3g}), greedy tokens "
        f"{'equal' if torch.equal(tok_g, tok_w) else 'DIFFER'} on "
        f"{tok_g.numel()} rows, max |pools - eager| {pool_err:.3g}; "
        f"bit-equal to eager: {bit} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"plan_execute {label}: compiled disagrees "
                             f"with the eager step")
    return bit


def _wall_ms(torch, fn, n: int = 10) -> float:
    """Median host ms of ``n`` calls of ``fn``, each ending in a
    synchronise (after two warm-up calls)."""
    times = []
    for i in range(n + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _release(torch) -> float:
    """Free what the last case left (cycles included); returns the GiB
    still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2 ** 30


def _execute_cell(torch, label, plan, eng, params, inputs, one_pe_ms):
    """Compiled async and sync and the eager step on one plan: the
    gates, then the times and the runtime's counters."""
    from repro_torch.tree import tree_flatten, tree_map
    pools, bt, toks, lens = inputs
    fold = [0] * plan.k
    rep = plan.verify(strict=True)
    c = rep.counts()
    log(f"plan_execute {label}: verified {c['error']}E/{c['warn']}W/"
        f"{c['info']}I, passes {', '.join(rep.passes_run)}; "
        f"{_release(torch):.3f} GiB allocated before the first call")
    args = (params, pools, bt, toks, lens)

    def run(mode, *given):
        # the parameters are read in place, the other leaves copied
        return plan.execute(*(given or args), device_map=fold, mode=mode,
                            static_argnums=(0,))
    torch.cuda.reset_peak_memory_stats()
    first = run("sync")
    first_peak = torch.cuda.max_memory_allocated()
    st = plan._compiled_runtime[1].stats
    same = all(torch.equal(a, b) for mode in ("sync", "async") * 3
               for a, b in zip(_leaves(run(mode)), _leaves(first)))
    # the pools given as other tensors: copied into the runtime's buffers
    moved = run("async", params, tree_map(torch.clone, pools), bt, toks,
                lens)
    copies = st.input_copies
    same = same and copies == 5 and all(
        torch.equal(a, b) for a, b in zip(_leaves(moved), _leaves(first)))
    log(f"plan_execute {label}: {st.num_segments} segments "
        f"{st.segments_per_device} per PE; async x3 and sync x3 "
        f"bit-equal to the first call, and a call with the pools as other "
        f"tensors ({copies} input copies): {same}")
    if not same:
        raise AssertionError(f"plan_execute {label}: sync and async "
                             f"dispatch disagree")
    # the next step, on the pools the last call returned, leaves the
    # first call's pools as they were
    kept = tree_map(torch.clone, pools)
    again = run("async", params, moved[1], bt, toks, lens)
    unchanged = all(torch.equal(a, b) for a, b in zip(
        tree_flatten(pools)[0], tree_flatten(kept)[0]))
    log(f"plan_execute {label}: a call with the first call's output pools "
        f"as its pools left the first call's pools unchanged: {unchanged}")
    if not unchanged:
        raise AssertionError(f"plan_execute {label}: a call wrote into an "
                             f"earlier call's arguments")
    del moved, again, kept
    if not (st.graph_replays == st.num_segments and st.eager_segments == 0):
        raise AssertionError(
            f"plan_execute {label}: {st.graph_replays} graph replays and "
            f"{st.eager_segments} eager segments for {st.num_segments} "
            f"segments")
    # the eager step writes its pools in place: a copy of its own
    eager_pools = tree_map(torch.clone, pools)

    def eager():
        return eng._decode_impl(params, eager_pools, bt, toks, lens)
    want = eng._decode_impl(params, tree_map(torch.clone, pools), bt, toks,
                            lens)
    _hold_to_eager(torch, label, first, want, PLAN_BF16_GATE)
    del want, first

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run("async")
    call_peak = torch.cuda.max_memory_allocated() - base
    ms = {"compiled async": _wall_ms(torch, lambda: run("async")),
          "compiled sync": _wall_ms(torch, lambda: run("sync"))}
    after = torch.cuda.memory_allocated() / 2 ** 30
    ms["eager"] = _wall_ms(torch, eager)
    log(f"plan_execute {label}: median wall over 10 calls " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in ms.items())
        + f"; predicted {plan.makespan * 1e3:.3f} ms (one PE "
        f"{one_pe_ms:.3f} ms)")
    prof = {}
    for name, fn in (("compiled async", lambda: run("async")),
                     ("eager", eager)):
        prof[name] = profile(torch, f"plan_execute {label} {name}", fn,
                             top=3)
    del eager_pools
    cert, _ = _certificate(plan)
    gib = 2 ** 30
    log(f"plan_execute {label}: capture {st.compile_seconds:.2f} s "
        f"(warm-up + {st.num_segments} captures), {st.graph_replays} graph "
        f"replays per step, 0 eager; transfers {st.transfers} "
        f"({st.transfer_bytes / 2**20:.1f} MiB), of them aliased "
        f"{st.aliased_reads} ({st.aliased_read_bytes / 2**20:.1f} MiB); "
        f"input copies {st.input_copies} ({st.input_copy_bytes / 2**20:.1f} "
        f"MiB), output clones {st.output_clone_bytes / gib:.3f} GiB; "
        f"{st.reuse_waits} cross-pool reuse waits")
    log(f"plan_execute {label}: logical peak per PE [" + ", ".join(
        f"{x / gib:.3f}" for x in st.peak_live_bytes) + "] GiB; plan [" +
        ", ".join(f"{x / gib:.3f}" for x in plan.peak_mem) +
        "]; certificate [" + ", ".join(f"{x / gib:.3f}" for x in cert) +
        f"]; max_memory_allocated first call {first_peak / gib:.3f} GiB, "
        f"over a steady call +{call_peak / gib:.3f} GiB above "
        f"{base / gib:.3f}, {after:.3f} after 20 more calls; reserved "
        f"{torch.cuda.memory_reserved() / gib:.3f} GiB")
    return ms, prof, st


def phase_plan_execute(torch, cfg, planned: tuple | None = None) -> None:
    """Execute ParDNN plans of the paged decode step on the card, with PEs
    folded onto it: (1) full granite-8b bf16 at K=4 (half cap: the
    verifier refuses the quarter-cap plan; ``planned``, the plan phase's
    trace and half-cap plan, when that phase ran), the
    compiled runtime async and sync against the eager step, every
    segment replayed from a CUDA graph; (2) the same trace at K=1, one
    graph for the whole step; (3) the op-by-op interpreter at 8 layers
    against the compiled runtime; (4) 2 layers in float32 against the
    eager step within PLAN_F32_GATE. Run first is (4), the cheapest."""
    from repro_torch import api
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine, partition_for_serving
    from repro_torch.tree import tree_map
    reset_counts()
    log(f"plan_execute: {_release(torch):.3f} GiB allocated at the start")
    card = torch.cuda.get_device_properties(0).total_memory
    fold = api.fold_device_map(4)
    assert fold == [0, 0, 0, 0], f"expected one card, device_map {fold}"

    # (4) 2 layers, float32
    small = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params = init_params(small, torch.Generator(device="cuda").manual_seed(2),
                         "cuda")
    plan = partition_for_serving(small, params, devices=4, memory=card / 4,
                                 device="cuda", **GEOMETRY)
    eng = ServingEngine(small, params, device="cuda", **GEOMETRY)
    pools, bt, toks, lens = _decode_inputs(torch, eng, seed=3)
    got = plan.execute(params, pools, bt, toks, lens, device_map=fold)
    want = eng._decode_impl(params, tree_map(torch.clone, pools), bt, toks,
                            lens)
    worst = max(float(((a - b).abs() / (PLAN_F32_GATE * (1 + b.abs())))
                      .max()) for a, b in zip(_leaves(got), _leaves(want)))
    st = plan._compiled_runtime[1].stats
    log(f"plan_execute float32 {small.num_layers} layers K=4: "
        f"{st.num_segments} segments, capture {st.compile_seconds:.2f} s; "
        f"logits and pools against eager, worst error / (2e-5 (1 + |eager|))"
        f" {worst:.3g}; bit-equal "
        f"{all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))}"
        f" {'ok' if worst <= 1 else 'MISMATCH'}")
    assert worst <= 1, "float32 compiled step disagrees with the eager step"
    del plan, eng, params, pools, got, want
    _release(torch)

    # (1) and (2): full granite-8b, bf16
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    inputs = _decode_inputs(torch, eng, seed=4)
    eng.pools = None                    # the inputs carry their own pools
    t0 = time.perf_counter()
    if planned is None:
        traced = api.trace(eng._decode_impl, params, *inputs, record=True)
        plan = _half_cap_plan(api, traced, card)
    else:
        # the plan phase's trace of the same step (its graph depends on
        # the shapes and dtypes only) and its verified half-cap plan
        traced, plan = planned
    one = api.partition(traced, devices=1)
    whose = "traced and partitioned here" if planned is None else \
        "the plan phase's trace and plan"
    log(f"plan_execute: {cfg.name} ({traced.n} nodes) at K=4 (half cap, "
        f"feasible={plan.feasible}, predicted {plan.makespan * 1e3:.3f} ms;"
        f" {whose}) and at K=1, partitioned in "
        f"{time.perf_counter() - t0:.2f} s")
    one_pe_ms = one.makespan * 1e3
    cells = {}
    for label, p in (("K=4", plan), ("K=1", one)):
        cells[label] = _execute_cell(torch, f"{cfg.name} {label}", p, eng,
                                     params, inputs, one_pe_ms)
        del p._compiled_runtime
    del traced, plan, one, inputs, eng, params
    _release(torch)

    # (3) the interpreter at 8 layers, full width, bf16
    mid = dataclasses.replace(cfg, num_layers=8)
    params = init_params(mid, torch.Generator(device="cuda").manual_seed(5),
                         "cuda")
    plan = partition_for_serving(mid, params, devices=4, memory=card / 4,
                                 device="cuda", **GEOMETRY)
    eng = ServingEngine(mid, params, device="cuda", **GEOMETRY)
    pools, bt, toks, lens = _decode_inputs(torch, eng, seed=6)
    eng.pools = None
    args = (params, pools, bt, toks, lens)
    compiled = _leaves(plan.execute(*args, device_map=fold, mode="sync"))
    t0 = time.perf_counter()
    interp = _leaves(plan.execute(*args, device_map=fold,
                                  runtime="interpret"))
    torch.cuda.synchronize()
    interp_s = time.perf_counter() - t0
    bit = all(torch.equal(a, b) for a, b in zip(interp, compiled))
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(interp, compiled))
    scale = float(compiled[0].float().abs().max())
    log(f"plan_execute interpreter {mid.num_layers} layers K=4 "
        f"({plan.n} nodes): {interp_s:.2f} s, bit-equal to compiled sync: "
        f"{bit}; max |diff| {err:.3g}")
    if not bit:
        tok_i, tok_c = interp[0][:, -1].argmax(-1), compiled[0][:, -1].argmax(-1)
        assert torch.equal(tok_i, tok_c) and \
            float((interp[0].float() - compiled[0].float()).abs().max()) \
            <= PLAN_BF16_GATE * scale, "the interpreter disagrees"
    del plan, eng, params, pools, compiled, interp, args
    _release(torch)
    launches = read_counts()
    assert not any(launches.values()), \
        f"a kernel launched on the plan path (one query token): {launches}"
    for label, (ms, prof, st) in cells.items():
        log(f"plan_execute {label} summary: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in ms.items()) + "; device busy " +
            ", ".join(f"{k} {b:.2f} ms of {w:.2f} ms ({b / w:.1%})"
                      for k, (w, b) in prof.items())
            + f"; {st.num_segments} segments")


#: full granite-8b against a block-starved pool: the 8 requests of seed 7
#: (prompts of 128-1024 tokens, 32 new tokens each) over 299 allocatable
#: blocks of 16 force a preemption (1 when the scheduler ran the same
#: schedule on the CPU at reduced width: admission and eviction depend
#: on lengths alone)
STARVED = dict(GEOMETRY, num_blocks=300)
STARVED_SEED = 7


def _watch_steps(torch, eng) -> dict:
    """Wrap ``eng._decode``: per call, each active row's top-1 / top-2
    logit gap keyed by (request id, index of the token the step emits),
    the first call's last-position logits, and for a plan-served engine
    the runtime and its counters after the call."""
    watch = {"gaps": {}, "first": None, "runtime": []}
    inner = eng._decode

    def step(bt, toks, lens):
        logits = inner(bt, toks, lens)
        last = logits[:, -1].float()
        top2 = last.topk(2, dim=-1).values.cpu().numpy()
        owner = {r.blocks[0]: r for r in eng.scheduler.active if r.blocks}
        for row, b0 in enumerate(bt[:, 0].tolist()):
            r = owner.get(b0)
            if r is not None:
                watch["gaps"][(r.rid, len(r.output))] = \
                    float(top2[row, 0] - top2[row, 1])
        if watch["first"] is None:
            watch["first"] = last.clone()
        if eng.plan is not None:
            rt = eng.plan._compiled_runtime[1]
            watch["runtime"].append((rt, rt.stats.graph_replays,
                                     rt.stats.eager_segments,
                                     rt.stats.compile_seconds))
        return logits
    eng._decode = step
    return watch


def _serve_run(torch, cfg, eng, reqs, label: str) -> dict:
    """Drain ``reqs`` through ``eng`` (which writes its trace) with the
    kernels' counts set to 0 just before and read just after; the
    flash-attention gates of the serve phase; returns the run's
    numbers."""
    from repro_torch.obs.trace import SERVING_PID, load_trace
    watch = _watch_steps(torch, eng)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    s = eng.stats
    assert len(done) == len(reqs), f"{label}: {len(done)} completed"
    assert all(len(r.output) == r.max_new_tokens for r in done.values())
    assert s.leaked_blocks == 0, f"{label}: {s.leaked_blocks} blocks leaked"
    want = cfg.num_layers * s.prefill_calls
    assert launches["flash_attention"] == want > 0 and \
        launches["flash_attention/sm90"] == want, \
        f"{label}: flash_attention launches {launches}, expected {want} sm90"
    assert launches["wkv6"] == 0, "granite-8b has no RWKV layer"
    doc = load_trace(eng._trace_path)
    spans = {}      # the engine lane's spans, ms
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X" and ev["pid"] == SERVING_PID and \
                ev["tid"] == 0:
            spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    summary = s.to_dict()
    run = {"done": done, "watch": watch, "wall": wall, "doc": doc,
           "tok_s": s.generated_tokens / wall,
           "ttft_p50": summary["ttft_p50_s"],
           "decode_ms": statistics.median(spans["decode_step"]),
           "prefill_ms": spans["prefill_batch"], "launches": launches,
           "stats": s}
    log(f"plan_serve {label}: {len(done)} requests, {s.prefill_tokens} "
        f"prompt tokens in {s.prefill_calls} prefill calls ("
        + ", ".join(f"{t:.1f}" for t in run["prefill_ms"]) + " ms), "
        f"{s.generated_tokens} generated in {wall:.3f} s -> "
        f"{run['tok_s']:.1f} tok/s; ttft p50 {run['ttft_p50']:.4f} s; "
        f"{s.decode_steps} decode steps, median {run['decode_ms']:.2f} ms; "
        f"{s.preempted} preemptions; peak {s.peak_blocks_in_use}/"
        f"{eng.allocator.capacity} blocks; flash_attention "
        f"{launches['flash_attention']} launches = {cfg.num_layers} x "
        f"{s.prefill_calls}, {launches['flash_attention/sm90']} sm90")
    return run


def _hold_tokens(torch, label: str, local: dict, served: dict,
                 d: float | None = None) -> float:
    """Plan-served tokens against the local engine's, request for
    request, under phase 6's near-tie rule: d is the largest logit
    difference of the two engines' first decode steps (the same inputs;
    passed in when the two runs admitted the requests in other orders),
    and a request may diverge only at a step where the local engine's
    top-2 gap is within 4 d; the step and the margin are printed.
    Returns d."""
    given = d is not None
    if not given:
        d = float((served["watch"]["first"] - local["watch"]["first"])
                  .abs().max())
    limit = 4 * d
    ties, mismatched = [], []
    for rid, req in sorted(local["done"].items()):
        a, b = req.output, served["done"][rid].output
        i = next((j for j in range(len(a)) if a[j] != b[j]), None)
        if i is None:
            continue
        gap = local["watch"]["gaps"].get((rid, i))
        (ties if gap is not None and gap <= limit else mismatched).append(
            (rid, i, gap))
    gaps = local["watch"]["gaps"].values()
    log(f"plan_serve {label}: max |logits plan - local| at the first decode "
        f"step{' (given)' if given else ''} {d:.3g}, near-tie limit "
        f"{limit:.3g}; min top-2 gap "
        f"{min(gaps):.3g}; tokens equal on "
        f"{len(local['done']) - len(ties) - len(mismatched)} of "
        f"{len(local['done'])} requests; divergent at near-ties "
        f"(request, step, gap) {ties}; mismatched {mismatched}")
    assert not mismatched, f"plan_serve {label}: plan-served tokens != " \
        f"local at {mismatched}"
    return d


def _hold_replays(label: str, run: dict) -> tuple:
    """Every decode step replayed every segment from its graph, the
    graphs captured in the first step only. Returns (segments, capture
    seconds)."""
    calls = run["watch"]["runtime"]
    rt = calls[0][0]
    n = rt.stats.num_segments
    assert all(c[0] is rt for c in calls), f"{label}: runtime rebuilt"
    assert all(c[1] == n and c[2] == 0 for c in calls), \
        f"{label}: replays {[c[1] for c in calls]}, {n} segments"
    assert all(c[3] == calls[0][3] for c in calls), \
        f"{label}: a capture after the first step"
    log(f"plan_serve {label}: {len(calls)} decode steps x {n} segments = "
        f"{sum(c[1] for c in calls)} graph replays, 0 eager; capture "
        f"{calls[0][3]:.2f} s in the first step only; {rt.stats.reuse_waits} "
        f"reuse waits")
    return n, calls[0][3]


def phase_plan_serve(torch, cfg, plan_path: Path, work: Path,
                     card_line: str) -> dict:
    """Serve full granite-8b (bf16, seeded weights) from a K=4 ParDNN plan
    on the card, beside the local engine, one parameter tree for all:
    (a) the plan the plan phase saved (partitioned here when that phase
    did not run), loaded without a trace so the engine retraces and
    binds it, served to the serve phase's 8 requests; (b) a K=4 half-cap
    plan of a block-starved pool (``STARVED``); (c) the engine traces,
    and one ``plan.execute(trace=)`` of a decode step: measured against
    predicted segment lanes; (d) the launcher in-process with a folded
    plan, its trace and metrics files. Returns the plan-served run's
    kernel launch counts."""
    from repro_torch import api
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import init_params
    from repro_torch.obs.metrics import validate_file
    from repro_torch.obs.trace import (MEASURED_PID, PREDICTED_PID,
                                       SERVING_PID, load_trace,
                                       predicted_vs_measured, validate_trace)
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.tree import tree_flatten
    card = torch.cuda.get_device_properties(0).total_memory
    fold = api.fold_device_map(4)
    assert fold == [0, 0, 0, 0], f"expected one card, device_map {fold}"
    log(f"plan_serve: {_release(torch):.3f} GiB allocated at the start")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if not plan_path.exists():
        eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
        traced = api.trace(eng._decode_impl, *eng._decode_example_args(),
                           record=True)
        _half_cap_plan(api, traced, card,
                       meta=_serving_meta(cfg, GEOMETRY)).save(
            str(plan_path))
        del eng, traced
        _release(torch)

    # (a) local, then the saved plan, at the serve geometry
    warm = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    for r in _requests(Request, cfg, 1, seed=99, plen=(128, 128),
                       max_new=2):
        warm.submit(r)
    warm.run_until_drained()
    del warm
    _release(torch)
    local = _serve_run(torch, cfg, ServingEngine(
        cfg, params, device="cuda", trace=str(work / "local.trace.json"),
        **GEOMETRY), _requests(Request, cfg, 8, seed=0), "(a) local")
    _release(torch)
    plan = api.PartitionPlan.load(str(plan_path))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = plan.serve(cfg, params, device_map=fold,
                     trace=str(work / "plan.trace.json"))
    bind_s = time.perf_counter() - t0
    devs = plan._torch_devices(None, fold)
    leaves = tree_flatten(eng.pools)[0]
    assert all(leaf.device == eng.pool_devices[i] == devs[eng.pool_pes[i]]
               for i, leaf in enumerate(leaves)), "a pool leaf is misplaced"
    log(f"plan_serve (a): the saved half-cap plan loaded, retraced and bound "
        f"in {bind_s:.2f} s; {len(leaves)} pool leaves on PEs "
        f"{eng.pool_pes}, each on its PE's device "
        f"{sorted({str(d) for d in eng.pool_devices})}")
    served = _serve_run(torch, cfg, eng, _requests(Request, cfg, 8, seed=0),
                        "(a) plan")
    launches = served["launches"]
    peak = torch.cuda.max_memory_allocated()
    _hold_tokens(torch, "(a)", local, served)
    segments, capture_s = _hold_replays("(a)", served)
    assert plan.report.serving["completed"] == 8

    # (c) the traces: the engine's, and one execute of a decode step
    doc = served["doc"]
    problems = validate_trace(doc)
    lanes = [e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "thread_name" and e["pid"] == SERVING_PID]
    assert problems == [] and sorted(lanes) == sorted(
        ["engine"] + [f"request {i}" for i in range(8)]), \
        f"engine trace: {problems[:3]}, lanes {lanes}"
    B, W = eng.max_batch, eng.max_blocks_per_req
    bt = torch.arange(1, 1 + B * W, dtype=torch.int32,
                      device="cuda").reshape(B, W)
    toks = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    lens = torch.full((B,), 1040, dtype=torch.int32, device="cuda")
    path = str(work / "step.trace.json")
    plan.execute(params, eng.pools, bt, toks, lens, device_map=fold,
                 trace=path)
    tl = plan._compiled_runtime[1].stats.timeline()
    step = load_trace(path)
    rows = predicted_vs_measured(step)
    names = {pid: sorted(e["name"] for e in step["traceEvents"]
                         if e.get("ph") == "X" and e["pid"] == pid)
             for pid in (MEASURED_PID, PREDICTED_PID)}
    assert validate_trace(step) == [] and len(rows) == segments and \
        names[MEASURED_PID] == names[PREDICTED_PID], \
        f"plan trace: {len(rows)} matched segments of {segments}"
    pred_end = max(e["ts"] + e["dur"] for e in step["traceEvents"]
                   if e.get("ph") == "X" and e["pid"] == PREDICTED_PID)
    ratios = sorted(r["ratio"] for r in rows if r["ratio"] is not None)
    log(f"plan_serve (c): engine trace valid, {len(lanes) - 1} request "
        f"lanes; plan trace of one decode step valid, {len(rows)} segments "
        f"in both lane groups: predicted makespan {plan.makespan * 1e3:.3f} "
        f"ms (segment emulator {pred_end / 1e3:.3f} ms), measured "
        f"{tl['makespan_s'] * 1e3:.3f} ms (CUDA events); sum over segments "
        f"predicted {sum(r['predicted_s'] for r in rows) * 1e3:.3f} ms, "
        f"measured {sum(r['measured_s'] for r in rows) * 1e3:.3f} ms; "
        f"measured / predicted per segment median "
        f"{statistics.median(ratios):.3g} (range {ratios[0]:.3g}-"
        f"{ratios[-1]:.3g}); input waits "
        f"{sum(tl['transfer_wait_s']) * 1e3:.3f} ms")
    del eng, plan, served["done"], served["watch"]
    _release(torch)

    # (b) forced eviction: a block-starved pool, plan against local
    eng = ServingEngine(cfg, params, device="cuda",
                        trace=str(work / "local_b.trace.json"), **STARVED)
    t0 = time.perf_counter()
    traced = api.trace(eng._decode_impl, *eng._decode_example_args(),
                       record=True)
    starved = _half_cap_plan(api, traced, card,
                             meta=_serving_meta(cfg, STARVED))
    log(f"plan_serve (b): {STARVED['num_blocks']} blocks: traced and "
        f"partitioned in {time.perf_counter() - t0:.2f} s")
    del traced
    local_b = _serve_run(torch, cfg, eng, _requests(
        Request, cfg, 8, seed=STARVED_SEED), "(b) local")
    del eng
    _release(torch)
    eng = starved.serve(cfg, params, device_map=fold,
                        trace=str(work / "plan_b.trace.json"))
    served_b = _serve_run(torch, cfg, eng, _requests(
        Request, cfg, 8, seed=STARVED_SEED), "(b) plan")
    pre = (local_b["stats"].preempted, served_b["stats"].preempted)
    assert pre[0] == pre[1] > 0, f"(b): preemptions local/plan {pre}"
    d_b = _hold_tokens(torch, "(b)", local_b, served_b)
    _hold_replays("(b)", served_b)
    evicted = sum(e.get("name") == "evicted"
                  for e in served_b["doc"]["traceEvents"])
    assert validate_trace(served_b["doc"]) == [] and evicted == pre[1], \
        f"(b): {evicted} evicted instants for {pre[1]} preemptions"
    log(f"plan_serve (b): {pre[1]} preemptions on both engines, {evicted} "
        f"evicted instants in the plan engine's trace")
    # the same requests admitted in a shuffled order: the in-order
    # plan-served tokens, request for request (the near-tie rule with the
    # plan-versus-local difference above), nothing leaked
    del eng
    _release(torch)
    order = [int(i) for i in np.random.default_rng(STARVED_SEED)
             .permutation(8)]
    reqs = _requests(Request, cfg, 8, seed=STARVED_SEED)
    eng = starved.serve(cfg, params, device_map=fold,
                        trace=str(work / "plan_b_shuffled.trace.json"))
    shuffled = _serve_run(torch, cfg, eng, [reqs[i] for i in order],
                          f"(b) plan, admitted in the order {order}")
    _hold_tokens(torch, "(b) shuffled against in order", served_b, shuffled,
                 d=d_b)
    del eng, starved, local_b, served_b, shuffled, params
    _release(torch)

    # (d) the launcher, in process: a folded K=4 plan at its defaults
    paths = [str(work / "launch.trace.json"), str(work / "launch.json")]
    t0 = time.perf_counter()
    eng = launch_serve.main(["--arch", "granite-8b", "--plan-devices", "4",
                             "--fold", "--trace", paths[0], "--metrics",
                             paths[1]])
    launch_s = time.perf_counter() - t0
    rep = eng.plan.verify()
    c = rep.counts()
    assert validate_trace(paths[0]) == [] and validate_file(paths[1]) == [], \
        "the launcher's trace or metrics file does not validate"
    log(f"plan_serve (d): launch.serve --plan-devices 4 --fold in "
        f"{launch_s:.2f} s: {eng.plan.summary()}; verified {c['error']}E/"
        f"{c['warn']}W/{c['info']}I; {eng.stats.completed} requests, "
        f"trace and metrics valid")
    del eng
    _release(torch)
    steady = served["stats"].generated_tokens / (served["wall"] - capture_s)
    log(f"plan_serve summary ({card_line}): plan-served "
        f"{served['tok_s']:.1f} tok/s ({steady:.1f} without the capture), "
        f"ttft p50 {served['ttft_p50']:.4f} s, decode median "
        f"{served['decode_ms']:.2f} ms; local {local['tok_s']:.1f} tok/s, "
        f"ttft p50 {local['ttft_p50']:.4f} s, decode median "
        f"{local['decode_ms']:.2f} ms; {segments} segments, capture "
        f"{capture_s:.2f} s; max_memory_allocated while plan-served "
        f"{peak / 2**30:.3f} GiB")
    return launches


# ------------------------------------------------------------------ serving
# conformance: the reference's serving scenario in a child process
# ---------------------------------------------------------------------------
#: the child's command line, the trace path appended
SERVING_ARGV = ["-m", "repro_torch.conformance", "--arch", "granite-8b",
                "--serving", "--devices", "4", "--fold", "--trace"]


def _serving_start(work: Path) -> tuple:
    """Start the conformance_serving child (``conformance.subproc.
    start_json``); returns what :func:`_serving_check` takes."""
    from repro_torch.conformance.subproc import start_json
    path = work / "conformance.serving.trace.json"
    return start_json(SERVING_ARGV + [str(path)]), path, time.perf_counter()


def _serving_check(started: tuple, card: str) -> None:
    """Wait for the conformance_serving child and hold its record: exit
    0 and ok, preemptions forced, 0 leaked blocks in both schedules, 4
    requests completed, every pool leaf on a PE of the plan, the trace
    valid (checked here again), every prefill attention call a launch of
    the fma kernel (float32, hd 16)."""
    from repro_torch.conformance.subproc import wait_json
    from repro_torch.obs.trace import validate_trace
    proc, path, t0 = started
    rec = wait_json(proc, timeout=600)
    fl = rec["flash_launches"]
    st = rec["serving_stats"]
    log(f"conformance_serving: {' '.join(SERVING_ARGV)} PATH exited 0 "
        f"{time.perf_counter() - t0:.1f} s after its start; ok {rec['ok']}, "
        f"{rec['num_nodes']} nodes partitioned in {rec['partition_s']:.2f} "
        f"s, device_map {rec['device_map']}; {rec['evictions']} evictions, "
        f"leaked blocks {rec['leaked_blocks_evict']} (in order) and "
        f"{rec['leaked_blocks_shuffled']} (admitted in the order "
        f"{rec['admission_order']}); {rec['completed']} requests completed "
        f"in {st['ticks']} ticks, {st['prefill_calls']} prefill calls, "
        f"{st['decode_steps']} decode steps; pool leaves on PEs "
        f"{rec['pool_pes']} ({rec['pool_devices']}); reference min top-2 "
        f"gap {rec['reference_min_gap']:.3g}; the schedule with evictions "
        f"served in {rec['serve_s']:.2f} s; flash launches {fl}; {card}")
    assert rec["ok"] and not rec["violations"], rec["violations"]
    assert rec["evictions"] > 0 and rec["leaked_blocks_evict"] == 0 and \
        rec["leaked_blocks_shuffled"] == 0, rec
    assert rec["completed"] == st["completed"] == 4, rec
    assert rec["pool_pes"] and set(rec["pool_pes"]) <= set(range(4)), rec
    assert validate_trace(str(path)) == [] and \
        rec["trace_path"] == str(path), "the scenario's trace is invalid"
    assert fl["fma"] >= 1 and fl["total"] == fl["fma"], \
        f"conformance_serving: flash launches {fl}"


def phase_conformance_serving(torch, work: Path, card: str) -> None:
    """``python -m repro_torch.conformance --arch granite-8b --serving
    --devices 4 --fold --trace PATH`` in a child process: reduced
    granite-8b (float32) served through ``plan.serve`` at K=4 folded onto
    the card under the reference's block-starved pool and a shuffled
    admission order, held by :func:`_serving_check`. With the dryrun
    phase it runs beside that phase's cells instead (no card timing
    there)."""
    _serving_check(_serving_start(work), card)


# ------------------------------------------------------------------ train
#: the training cell: full granite-8b width, one sequence of 2048 tokens,
#: SGD at the reference conformance's lr; the eager step at full depth
#: when the printed arithmetic fits the card, the plan path at 12 layers
#: (its runtime holds the outputs in its pools and returns clones), the
#: interpreter (every intermediate kept) at 4
TRAIN = dict(batch=1, seq=2048, lr=1e-3, plan_layers=12, interp_layers=4)
#: the backward kernel's cases: the training shape in both dtypes, then
#: the edges
BWD_CASES = [
    # (B, H, KV, Sq, Sk, hd, causal, window, q_offset, softcap, dtype)
    (1, 32, 8, 2048, 2048, 128, True, None, 0, 0.0, "bfloat16"),
    (1, 32, 8, 2048, 2048, 128, True, None, 0, 0.0, "float32"),
    (8, 12, 4, 1024, 1024, 64, True, None, 0, 0.0, "bfloat16"),  # lm-100m
    (2, 4, 2, 1000, 1000, 128, True, None, 0, 0.0, "bfloat16"),  # ragged
    (2, 8, 2, 1024, 1024, 128, True, 256, 0, 0.0, "bfloat16"),   # window
    (2, 8, 2, 512, 1024, 128, True, None, 512, 0.0, "bfloat16"),  # offset
    (2, 8, 2, 512, 512, 128, True, None, 0, 30.0, "bfloat16"),   # softcap
    (1, 8, 8, 256, 256, 64, True, None, 0, 0.0, "bfloat16"),     # G = 1
    (1, 16, 4, 256, 256, 64, False, None, 0, 0.0, "float32"),    # G = 4
    (1, 4, 2, 128, 128, 64, True, 64, 100, 0.0, "float32"),      # masked
    (1, 32, 8, 2048, 2048, 128, True, 4096, 0, 0.0, "bfloat16"),  # mixtral
    (2, 14, 2, 4096, 4096, 64, True, None, 0, 0.0, "bfloat16"),  # internvl
]
# The backward kernels against their plain version run in float32 on the
# same inputs: max |kernel - plain| <= gate x max |plain|, per gradient.
# float32: sums in another order. bf16: the outputs rounded to bf16 (2^-9
# of the scale), D = rowsum(dO o O) taken from the bf16 forward output
# (up to 3.6e-3 of dq's scale in a CPU check of the formula) and, in the
# sm90 and mma kernels, P and dS rounded to bf16 for their products: two
# bf16 steps.
BWD_GATE = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
# compiled against the eager step, per leaf: bit-equal, or else within
# one bf16 step of the leaf's largest magnitude (the eager step's
# autograd engine may sum a gradient's parts in another order)
TRAIN_GATE = 2.0 ** -7
#: the kernels' names in a profile: the sm90 and fma forwards, and the sm90
#: backward's last kernel (one per backward launch on the training path)
FWD_KERNELS = ("flash_fwd_sm90", "flash_fwd_kernel")
BWD_KERNEL = "bwd_dq_sm90"
#: the sm90 backward's four kernels in stream order, as a profile names
#: them: D and the padded LSE, dK/dV partials, their sum, dQ
SM90_BWD_KERNELS = ("bwd_delta_sm90", "bwd_dkdv_sm90", "bwd_reduce_sm90",
                    "bwd_dq_sm90")
#: the flash kernels by name (forward sm90 and fma; the sm90 backward's
#: four kernels; the fma backward's three, with the "<" of their template
#: arguments, so that no name is a prefix of an sm90 kernel's and a sum
#: over the names counts each launch once)
FLASH_KERNEL_NAMES = FWD_KERNELS + ("bwd_delta_sm90", "bwd_dkdv_sm90",
                                    "bwd_reduce_sm90", BWD_KERNEL,
                                    "bwd_prep<", "bwd_dkdv<", "bwd_dq<")


def _hold_bwd(torch, label, got, again, want, dt) -> tuple:
    """A backward kernel's (dq, dk, dv) against the plain version's:
    each within BWD_GATE x its max |plain|, finite, and a repeated call
    bit-equal. Returns (worst error / gate, max abs error)."""
    ratios, errs = [], []
    for a, w in zip(got, want):
        errs.append(float((a.float() - w).abs().max()))
        ratios.append(errs[-1] / (BWD_GATE[dt] * max(float(w.abs().max()),
                                                     1e-30)))
    rep = all(torch.equal(a, b) for a, b in zip(got, again))
    fin = all(bool(torch.isfinite(a).all()) for a in got)
    ok = rep and fin and max(ratios) <= 1
    log(f"kernel flash_attention_bwd {label}: error / gate (dq, dk, dv) "
        f"[{', '.join(f'{r:.3g}' for r in ratios)}] (gate "
        f"{BWD_GATE[dt]:.3g} x max |plain|), max abs err {max(errs):.3g}; "
        f"repeated call bit-equal {rep} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"flash_attention_bwd disagrees with its plain "
                             f"version at {label}")
    return max(ratios), max(errs)


#: calls of the recorded profiler step in :func:`kernel_split`
SPLIT_CALLS = 20


def _device_events(torch, fn, calls: int) -> list:
    """torch.profiler's device events (key averages) over ``calls``
    calls of ``fn``, recorded after a warm-up call and one unrecorded
    profiler step of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, schedule
    fn()
    torch.cuda.synchronize()
    got = []
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: got.append(p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    # the device side of the profiler's own step annotation is no kernel
    return [e for e in got[-1]
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def kernel_split(torch, fn, names, calls: int = SPLIT_CALLS) -> dict:
    """{name: (device ms per launch, launches recorded)} for each named
    kernel that ``fn`` launches once a call, from torch.profiler over
    ``calls`` calls (after a warm-up). torch.profiler has missed the
    first kernels launched in its window, up to all 5 of a 5-call window
    late in this script: the profiler runs one unrecorded step of
    ``calls`` calls first, which cut the misses but did not end them,
    and the window is long enough that a few missed leave most recorded.
    The mean is over the launches recorded; a kernel it recorded none of
    reads None, not a time."""
    evs = _device_events(torch, fn, calls)
    split = {}
    for name in names:
        hits = [e for e in evs if name in e.key]
        n = sum(e.count for e in hits)
        split[name] = (sum(e.self_device_time_total for e in hits) / 1e3 / n
                       if n else None, n)
    return split


def split_text(split: dict, calls: int = SPLIT_CALLS) -> str:
    """:func:`kernel_split`'s result for the log, with the sum of the
    per-launch times when every kernel was recorded."""
    parts = [f"{k} {'not recorded' if ms_ is None else f'{ms_:.4f}'} "
             f"({n} of {calls})" for k, (ms_, n) in split.items()]
    times = [ms_ for ms_, _ in split.values()]
    total = ("not measured" if None in times else f"{sum(times):.4f}")
    return ", ".join(parts) + f"; sum {total}"


def phase_train_kernel(torch, ops, ref, build) -> dict:
    """The three backward kernels against the plain version at every case
    of BWD_CASES (the forward kernel's output and LSE as ``out`` and
    ``lse``): the one ``select_bwd_variant`` names (``sm90`` in bf16,
    ``fma`` in float32), and in bf16 the earlier kernels (``mma``,
    ``fma``) by name; repeated calls bit-equal. Then at the training shape
    the sm90, mma and fma kernels, the plain version and SDPA's backward
    (a yardstick the port never calls) timed in turns beside the bound;
    the sm90 backward's four kernels timed apart (torch.profiler) and
    their registers and spills (ptxas). Returns the sm90 kernel's record
    (launches filled in by the eager step)."""
    import torch.nn.functional as F
    worst = {}
    counts = ops.flash_attention_bwd.variant_launches
    for i, case in enumerate(BWD_CASES):
        B, H, KV, Sq, Sk, hd, causal, window, q_offset, softcap, dt = case
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        dtype = getattr(torch, dt)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        q, k, v, do = (rnd(B, Sq, H, hd), rnd(B, Sk, KV, hd),
                       rnd(B, Sk, KV, hd), rnd(B, Sq, H, hd))
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  softcap=softcap)
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        want = ref.flash_attention_bwd_ref(do.float(), q.float(), k.float(),
                                           v.float(), **kw)
        variant = ops.select_bwd_variant(dtype, hd)
        before = counts[variant]
        got = ops.flash_attention_bwd(do, q, k, v, out, lse, **kw)
        again = ops.flash_attention_bwd(do, q, k, v, out, lse, **kw)
        assert counts[variant] == before + 2, f"{case} did not run {variant}"
        worst[(case, variant)] = _hold_bwd(torch, f"{case} [{variant}]", got,
                                           again, want, dt)
        earlier = ("mma", "fma") if variant == "sm90" else ()
        for name in earlier:
            got = ops.run_bwd_variant(name, do, q, k, v, out, lse, **kw)
            again = ops.run_bwd_variant(name, do, q, k, v, out, lse, **kw)
            worst[(case, name)] = _hold_bwd(torch, f"{case} [{name}]", got,
                                            again, want, dt)
        del q, k, v, do, out, lse, got, again, want
    by_kernel = {name: max(r for (_, n), (r, _) in worst.items()
                           if n == name) for name in ops.BWD_VARIANTS}
    log(f"kernel flash_attention_bwd: worst error / gate "
        f"{max(r for r, _ in worst.values()):.3g} over {len(worst)} "
        f"(case, kernel) pairs; by kernel " + ", ".join(
            f"{name} {r:.3g}" for name, r in by_kernel.items()))

    B, H, KV, S, hd, causal, window, q_offset, softcap, dt = \
        BWD_CASES[0][:4] + BWD_CASES[0][5:]
    assert ops.select_bwd_variant(torch.bfloat16, hd) == "sm90"
    g = torch.Generator(device="cuda").manual_seed(300)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                   for shape in ((B, S, H, hd), (B, S, KV, hd),
                                 (B, S, KV, hd), (B, S, H, hd)))
    out, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    # SDPA on (B, H, S, hd) with GQA; its backward alone is timed
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    dot = do.transpose(1, 2)
    ms = timed_turns(torch, {
        "sm90": lambda: ops.flash_attention_bwd(do, q, k, v, out, lse,
                                                causal=True),
        "mma": lambda: ops.run_bwd_variant("mma", do, q, k, v, out, lse,
                                           causal=True),
        "fma": lambda: ops.run_bwd_variant("fma", do, q, k, v, out, lse,
                                           causal=True),
        "plain": lambda: ref.flash_attention_bwd_ref(do, q, k, v,
                                                     causal=True),
        "sdpa": lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                            retain_graph=True),
    }, reps={"mma": 5, "fma": 3, "plain": 2})
    split = kernel_split(torch, lambda: ops.flash_attention_bwd(
        do, q, k, v, out, lse, causal=True), SM90_BWD_KERNELS)
    pairs = visible_pairs(S, S, True, None)
    flops = 8 * B * H * hd * pairs
    nbytes = 2 * sum(t.numel() * t.element_size() for t in (q, k, v)) + \
        2 * out.numel() * out.element_size()
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    log(f"timing flash_attention_bwd at the training shape {BWD_CASES[0]}, "
        f"in turns: sm90 {ms['sm90']:.4f} ms "
        f"({flops / ms['sm90'] / 1e9:.1f} TFLOP/s), mma {ms['mma']:.4f} ms "
        f"({flops / ms['mma'] / 1e9:.1f} TFLOP/s), fma {ms['fma']:.4f} ms "
        f"({flops / ms['fma'] / 1e9:.1f} TFLOP/s), plain {ms['plain']:.4f} "
        f"ms, sdpa backward {ms['sdpa']:.4f} ms "
        f"({flops / ms['sdpa'] / 1e9:.1f} TFLOP/s); bound "
        f"{max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP of the four "
        f"backward products on {pairs} visible pairs, {nbytes / 2**20:.1f} "
        f"MiB); sm90 is {ms['mma'] / ms['sm90']:.2f}x mma and "
        f"{ms['sm90'] / ms['sdpa']:.2f}x sdpa; the 1.0 ms design target "
        f"{'met' if ms['sm90'] <= 1.0 else 'not met'}")
    log("timing flash_attention_bwd sm90 by kernel (torch.profiler, ms per "
        "launch, launches recorded of those made): " + split_text(split))
    regs = {k: v for k, v in ptxas_report(build, ops, "flash_attention")
            .items() if "sm90" in k and "bwd_" in k}
    for kernel, used in regs.items():
        log(f"  ptxas {kernel}: {used}")
    record = {
        "name": "flash_attention_bwd", "variant": "sm90", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
        "note": "the gradient of that kernel; the reference has no "
                "backward kernel (it differentiates models/layers.py:259 "
                "_plain_gqa)",
        "launches": None, "variant_launches": None,
        "max_abs_err": worst[(BWD_CASES[0], "sm90")][1],
        "gate_ratio": max(r for r, _ in worst.values()),
        "ms": ms["sm90"], "plain_ms": ms["plain"],
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": ms["sdpa"],
        "earlier_ms": ms["mma"],
        "earlier_source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention_bwd_mma.cu",
        "first_ms": ms["fma"],
        "first_source": "src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention_bwd.cu",
        "kernel_ms": {k: ms_ for k, (ms_, _) in split.items()},
    }
    del q, k, v, do, out, lse, qt, kt, vt, lib_out, dot
    _release(torch)
    return record


def _train_batch(torch, cfg, seed: int, batch: int = TRAIN["batch"],
                 seq: int = TRAIN["seq"]) -> dict:
    """Random targets and inputs: int32 tokens or, for a config with a
    stubbed frontend, float32 embeddings (standard normals x 0.1), as
    the conformance batch makes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, seq)
    if cfg.frontend is not None:
        x = {"embeds": torch.randn((*shape, cfg.d_model), generator=g,
                                   device="cuda") * 0.1}
    else:
        x = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                     device="cuda", dtype=torch.int32)}
    return {**x, "targets": torch.randint(0, cfg.vocab_size, shape,
                                          generator=g, device="cuda",
                                          dtype=torch.int32)}


def train_dot_flops(cfg, batch: int, seq: int) -> float:
    """Product FLOPs of one training step from the config: 3 x 2·T·(the
    matmul parameters, lm head included) and, per layer, the attention's
    dense products, 4·B·H·S²·hd forward and 8·B·H·S²·hd backward (priced
    as the reference's graph prices its ``_plain_gqa``; an MLA layer's hd
    is nope + rope, the width its zero-padded v reaches the kernel at,
    and its matmul parameters its six projections). An MoE layer's FFN
    on G groups of N tokens with C slots an expert: the router 3 x
    2·T·d·E, dispatch 2 x 2·G·N·E·C·d (no gradient into the one-hots),
    combine 3 x that (its weights take a gradient through the router),
    the expert products 3 x m x 2·E·G·C·d·f (m matrices an expert) and
    the shared experts' dense products."""
    from repro_torch.models.moe import capacity
    T, d, H = batch * seq, cfg.d_model, cfg.num_heads
    mats = 3 if cfg.gated_mlp else 2
    mm, attn = d * cfg.padded_vocab, 0.0
    for kind in list(cfg.prelude) + list(cfg.block_pattern) \
            * cfg.num_periods:
        if kind.startswith("mla"):
            r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                             cfg.qk_rope_dim, cfg.v_head_dim)
            mm += (d * H * (nd + rd) + d * (r + rd) + r * H * (nd + vd)
                   + H * vd * d)
            attn += 12.0 * batch * H * seq ** 2 * (nd + rd)
        else:
            mm += d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
            attn += 12.0 * batch * H * seq ** 2 * cfg.head_dim
        if kind.endswith("moe"):
            m = cfg.moe
            E, N = m.num_experts, min(1024, T)
            G, C = T // N, capacity(cfg, N)
            mm += mats * d * m.d_ff * m.num_shared_experts
            attn += (6 * T * d * E + 10 * G * N * E * C * d
                     + 6 * mats * E * G * C * d * m.d_ff)
        else:
            mm += mats * d * cfg.d_ff
    return 6.0 * T * mm + attn


def _profile_step(torch, label: str, fn,
                  kernels=FWD_KERNELS + (BWD_KERNEL,)) -> dict:
    """One call of ``fn`` under torch.profiler (after two warm-up
    calls): wall and device-busy ms, the top kernels, and the launches
    of the ``kernels`` by name (they count replays of captured graphs,
    which the wrappers' counters do not) and their device ms."""
    from torch.profiler import ProfilerActivity
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    counts = {name: sum(e.count for e in evs if name in e.key)
              for name in kernels}
    named_ms = {name: sum(e.self_device_time_total for e in evs
                          if name in e.key) / 1e3 for name in kernels}
    log(f"profile {label}: wall {host_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / host_ms:.1%}), "
        f"{sum(e.count for e in evs)} kernels; launches by name {counts}; "
        f"device ms by name " + ", ".join(
            f"{name} {t:.3f}" for name, t in named_ms.items() if t))
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} "
            f"{e.key[:90]}")
    return {"wall_ms": host_ms, "busy_ms": busy_ms, "counts": counts,
            "named_ms": named_ms}


def _train_leaves(out) -> list:
    from repro_torch.tree import tree_flatten
    return tree_flatten(out)[0]


def _trace_aten(step, params, batch):
    """``api.trace(step, params, batch, record=True, autograd=True)`` and
    the aten graph it is built from, of one trace: the graph's shapes
    tell an op that makes a whole stacked leaf from another op of the
    same size (at full width a stacked wq, the embedding and the float32
    logits can have the same bytes)."""
    from repro_torch import api
    from repro_torch.core import tracing
    from repro_torch.core.costmodel import H100
    gm, out = tracing._functional_graph(step, (params, batch),
                                        autograd=True)
    g, prog = tracing._cost_graph(gm, out, (params, batch), dev=H100,
                                  params_residual=True, record=True)
    return api.TracedModel(graph=g, program=prog,
                           fingerprint=g.fingerprint(),
                           device_model=H100), gm


def _whole_stack_ops(torch, gm, params) -> tuple[list, list]:
    """(the ops of ``gm`` whose output has a stacked period leaf's shape,
    those shapes)."""
    from repro_torch.core.tracing import op_name
    from repro_torch.tree import tree_flatten
    stacked = [tuple(t.shape) for t in tree_flatten(params["periods"])[0]]
    whole = sorted(op_name(n.target) for n in gm.graph.nodes
                   if n.op == "call_function"
                   and isinstance(n.meta.get("val"), torch.Tensor)
                   and tuple(n.meta["val"].shape) in stacked)
    return whole, stacked


def _hold_train(torch, label: str, got, want) -> bool:
    """(loss, new params, grads) against the eager step's: every leaf
    finite, and bit-equal or within TRAIN_GATE x its max |eager|.
    Returns whether every leaf was bit-equal."""
    g, w = _train_leaves(got), _train_leaves(want)
    assert len(g) == len(w), f"{label}: {len(g)} leaves against {len(w)}"
    bits, worst = 0, 0.0
    for a, b in zip(g, w):
        b = b.to(a.device)              # an eager step kept on the host
        if torch.equal(a, b):
            bits += 1
            continue
        scale = float(b.float().abs().max())
        worst = max(worst, float((a.float() - b.float()).abs().max())
                    / (TRAIN_GATE * max(scale, 1e-30)))
    fin = all(bool(torch.isfinite(a.float()).all()) for a in g)
    ok = fin and worst <= 1
    log(f"train {label}: {bits} of {len(g)} leaves (loss, new params, "
        f"grads) bit-equal to the eager step; worst other leaf error / "
        f"(2^-7 x max |eager|) {worst:.3g}; loss {float(g[0]):.6f} "
        f"against {float(w[0]):.6f} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"train {label}: compiled disagrees with the "
                             f"eager step")
    return bits == len(g)


def _train_plan_cell(torch, label, plan, params, batch, eager_fn, want,
                     layers: int,
                     kernels=FWD_KERNELS + (BWD_KERNEL,)) -> dict:
    """A training plan folded onto the card: async = sync over 3 calls,
    against the eager step, every segment a replay; then times, device
    time, counters, peaks beside the plan's and the certificate, and one
    measured timeline beside the predicted makespan."""
    fold = [0] * plan.k
    rep = plan.verify(strict=True)
    c = rep.counts()
    log(f"train {label}: verified {c['error']}E/{c['warn']}W/{c['info']}I; "
        f"{_release(torch):.3f} GiB allocated before the first call")

    def run(mode):
        return plan.execute(params, batch, device_map=fold, mode=mode,
                            static_argnums=(0,))
    torch.cuda.reset_peak_memory_stats()
    first = run("sync")
    first_peak = torch.cuda.max_memory_allocated()
    st = plan._compiled_runtime[1].stats
    same = all(torch.equal(a, b) for mode in ("async", "sync") * 3
               for a, b in zip(_train_leaves(run(mode)),
                               _train_leaves(first)))
    log(f"train {label}: {st.num_segments} segments "
        f"{st.segments_per_device} per PE, capture {st.compile_seconds:.2f} "
        f"s; async x3 and sync x3 bit-equal to the first call: {same}")
    if not same:
        raise AssertionError(f"train {label}: sync and async dispatch "
                             f"disagree")
    if not (st.graph_replays == st.num_segments and st.eager_segments == 0):
        raise AssertionError(f"train {label}: {st.graph_replays} replays "
                             f"and {st.eager_segments} eager segments for "
                             f"{st.num_segments} segments")
    bit = _hold_train(torch, label, first, want)
    del first
    ms = {"compiled async": _wall_ms(torch, lambda: run("async"), n=5),
          "compiled sync": _wall_ms(torch, lambda: run("sync"), n=5),
          "eager": _wall_ms(torch, eager_fn, n=5)}
    prof = {name: _profile_step(torch, f"train {label} {name}", fn, kernels)
            for name, fn in (("compiled async", lambda: run("async")),
                             ("eager", eager_fn))}
    # a report, not a gate: inside one long graph replay the profiler
    # has been seen to miss launches (10 of 12 forwards at K=1, while
    # every leaf was bit-equal to the eager step, which launches 12)
    counts = prof["compiled async"]["counts"]
    log(f"train {label}: kernel launches per step in the profile "
        f"{counts} (the step has {layers} layers)")
    with tempfile.TemporaryDirectory() as tmp:
        plan.execute(params, batch, device_map=fold, static_argnums=(0,),
                     trace=f"{tmp}/train.trace.json")
    measured = st.timeline()["makespan_s"]
    cert, _ = _certificate(plan)
    gib = 2 ** 30
    log(f"train {label}: median wall of 5 calls " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in ms.items())
        + f"; {st.graph_replays} graph replays per step; measured makespan "
        f"{measured * 1e3:.3f} ms (CUDA events) against the predicted "
        f"{plan.makespan * 1e3:.3f} ms; transfers {st.transfers} "
        f"({st.transfer_bytes / 2**20:.1f} MiB, {st.aliased_reads} aliased), "
        f"input copies {st.input_copies}, output clones "
        f"{st.output_clone_bytes / gib:.3f} GiB, {st.reuse_waits} reuse "
        f"waits")
    log(f"train {label}: logical peak per PE [" + ", ".join(
        f"{x / gib:.3f}" for x in st.peak_live_bytes) + "] GiB; plan [" +
        ", ".join(f"{x / gib:.3f}" for x in plan.peak_mem) +
        "]; certificate [" + ", ".join(f"{x / gib:.3f}" for x in cert) +
        f"]; max_memory_allocated first call {first_peak / gib:.3f} GiB")
    return {"ms": ms, "prof": prof, "segments": st.num_segments,
            "capture_s": st.compile_seconds, "bit": bit,
            "measured_ms": measured * 1e3, "predicted_ms": plan.makespan * 1e3}


def _param_bytes(params) -> int:
    from repro_torch.tree import tree_flatten
    return sum(t.numel() * t.element_size()
               for t in tree_flatten(params)[0])


def fit_depth(torch, cfg, label: str, build, holds: str,
              fraction: float = 0.9, measured: dict | None = None
              ) -> tuple[int, float, float]:
    """The depth at which one step of ``cfg`` fits on the card: ``build(c)``
    gives (params, step) for a config ``c``; the step runs twice at 2 and
    at 4 layers and max_memory_allocated of its second call, parameters
    included, is extrapolated linearly to ``cfg.num_layers``. Logs the
    arithmetic; returns ``cfg.num_layers`` or the depth that keeps the
    peak under ``fraction`` of the card, and the parameters' bytes per
    layer and at 0 layers. ``measured``, when given, receives the peak at
    2 layers and the slope (``"peak2"``, ``"slope"``) for
    :func:`depth_within`."""
    total = torch.cuda.get_device_properties(0).total_memory
    gb = 1e9
    peaks, pbytes = {}, {}
    for n in (2, 4):
        params, step = build(dataclasses.replace(cfg, num_layers=n))
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peaks[n] = float(torch.cuda.max_memory_allocated())
        pbytes[n] = float(_param_bytes(params))
        del params, step
        _release(torch)
    slope, pslope = (peaks[4] - peaks[2]) / 2, (pbytes[4] - pbytes[2]) / 2
    if measured is not None:
        measured.update(peak2=peaks[2], slope=slope)
    layers = cfg.num_layers
    need = peaks[2] + slope * (layers - 2)
    log(f"{label}: depth arithmetic: parameters P(L) = {pslope / gb:.4f} L "
        f"+ {(pbytes[2] - 2 * pslope) / gb:.4f} GB; the step holds about "
        f"{holds} plus the activations: measured peaks {peaks[2] / gb:.3f} "
        f"GB at 2 layers and {peaks[4] / gb:.3f} GB at 4, {slope / gb:.3f} "
        f"GB a layer ({slope / pslope:.2f} P), so {need / gb:.2f} GB at "
        f"{layers} layers of the card's {total / gb:.2f} GB")
    if need > fraction * total:
        layers = 2 + int((fraction * total - peaks[2]) // slope)
        log(f"{label}: the step does not fit at {cfg.num_layers} layers "
            f"in {fraction:.0%} of the card: cut to {layers}")
    return layers, pslope, pbytes[2] - 2 * pslope


def depth_within(torch, cfg, label: str, measured: dict,
                 fraction: float) -> int:
    """The depth whose step, by :func:`fit_depth`'s measured arithmetic
    (``measured``), keeps its peak under ``fraction`` of the card (at
    most ``cfg.num_layers``); logged."""
    total = torch.cuda.get_device_properties(0).total_memory
    layers = min(cfg.num_layers, 2 + int((fraction * total
                                          - measured["peak2"])
                                         // measured["slope"]))
    log(f"{label}: {measured['peak2'] / 1e9:.3f} GB at 2 layers + "
        f"{measured['slope'] / 1e9:.3f} GB a layer under {fraction:.4f} of "
        f"the card's {total / 1e9:.2f} GB: {layers} layers")
    return layers


@contextlib.contextmanager
def _attention_calls(plain: bool = False, causal=None):
    """Yields a list that records (q/k head dim, v width, causal,
    window) of every attention call with more than one query token (the
    calls that take the flash kernel) while the block runs; with
    ``plain`` those calls run the plain version instead, and launch
    nothing; a ``causal`` given (with ``plain``) replaces the calls'
    mask: a planted fault, the control of a path check."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers as model_layers
    calls, mha = [], model_layers.multi_head_attention

    def seen(q, k, v, **kw):
        if q.shape[1] > 1:
            calls.append((q.shape[-1], v.shape[-1], kw["causal"],
                          kw["window"]))
            if plain:
                if causal is not None:
                    kw = dict(kw, causal=causal)
                return flash_attention_ref(q, k, v, **kw)
        return mha(q, k, v, **kw)
    model_layers.multi_head_attention = seen
    try:
        yield calls
    finally:
        model_layers.multi_head_attention = mha


def _under_card(torch, label: str, peak: float) -> None:
    """Logs a cell's measured peak (max_memory_allocated) against 90% of
    the card and fails the phase above it."""
    fit = 0.9 * torch.cuda.get_device_properties(0).total_memory
    log(f"{label}: memory arithmetic: peak {peak / 1e9:.2f} GB against 90% "
        f"of the card, {fit / 1e9:.2f} GB: "
        f"{'fits' if peak <= fit else 'does not fit'}")
    assert peak <= fit, \
        f"{label}: peak {peak / 1e9:.2f} GB over {fit / 1e9:.2f} GB"


def _flash_want(L: int, variant: str = "sm90") -> dict:
    """The launch counts of a training step with L attention layers: L
    flash forward and L backward launches, every one of ``variant``."""
    from repro_torch.kernels.flash_attention import ops
    want = {"flash_attention": L, "flash_attention_bwd": L}
    for name, variants in (("flash_attention", ops.VARIANTS),
                           ("flash_attention_bwd", ops.BWD_VARIANTS)):
        want.update({f"{name}/{v}": L if v == variant else 0
                     for v in variants})
    return want


def _eager_sgd(torch, cfg, label: str, params, batch: dict, lr: float,
               card: str, want: dict, *, calls=None, in_place: bool = True,
               near_ln_v: bool = True, reps: int = 3,
               kernels=FLASH_KERNEL_NAMES, moe_group=None) -> dict:
    """The eager SGD step of ``cfg`` on ``params`` (updated in place
    unless ``in_place`` is false), one warm-up call, then one call with
    the counts at 0. Gates: the launch counts ``want``, key for key;
    with ``calls``, the (q/k head dim, v width, causal, window) of every
    attention call in order; the peak under 90% of the card; the loss
    finite and, with ``near_ln_v``, within 2 of ln V (the cross entropy
    at init; an MoE loss adds its router term, and its phase holds the
    cross entropy itself). Logs step ms (median of ``reps``), tokens/s,
    device busy and the port's kernels' device time (``kernels`` by name
    from :func:`_profile_step`, or with ``moe_group`` the flash and scan
    roles of :func:`_moe_profile`). Returns the launch counts, the
    median step ms and the peak."""
    from repro_torch.conformance import make_train_step
    L = cfg.num_layers
    B, S = batch["targets"].shape
    step = make_train_step(cfg, lr, in_place=in_place)

    def fn():
        return step(params, batch)
    fn()                                # warm-up: cuBLAS, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with _attention_calls() as seen:
        loss = float(fn()[0])
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    got = {k: launches[k] for k in want}
    ln_v = math.log(cfg.vocab_size)
    log(f"{label} eager: {L} layers, B={B}, S={S}, loss after one update "
        f"{loss:.4f} (ln {cfg.vocab_size} = {ln_v:.4f}), launches {got}, "
        f"flash calls at (q/k head dim, v width, causal, window) "
        f"{sorted(set(seen), key=str)} x {len(seen)}, max_memory_allocated "
        f"{peak / 2**30:.3f} GiB ({peak / 1e9:.2f} GB), one step "
        f"{first_ms:.1f} ms")
    assert got == want, f"{label} eager: launches {got}, want {want}"
    assert calls is None or seen == calls, f"{label} eager: flash calls " \
        f"{sorted(set(seen), key=str)} x {len(seen)}"
    _under_card(torch, f"{label} eager", peak)
    assert math.isfinite(loss) and (not near_ln_v or abs(loss - ln_v) < 2), \
        f"{label} eager: loss {loss} far from ln V at init"
    step_ms = _wall_ms(torch, fn, n=reps)
    name = f"{label} eager {L} layers B={B} S={S}"
    if moe_group:
        prof = _moe_profile(torch, name, fn, cfg, moe_group)
        ours = prof["roles"]["flash kernels"] + prof["roles"].get(
            "scan kernels", 0.0)
    else:
        prof = _profile_step(torch, name, fn, kernels)
        ours = sum(prof["named_ms"].values())
    log(f"{label} eager: median step {step_ms:.2f} ms, "
        f"{B * S / step_ms * 1e3:.1f} tokens/s; device busy "
        f"{prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms "
        f"({prof['busy_ms'] / prof['wall_ms']:.1%}); the port's kernels "
        f"{ours:.3f} ms ({ours / prof['busy_ms']:.1%} of device time); "
        f"max_memory_allocated {peak / 2**30:.3f} GiB; {card}")
    return {"launches": launches, "step_ms": step_ms, "peak": peak}


def phase_train(torch, ops, cfg, card: str, record: dict) -> dict:
    """The training main path at full granite-8b width (bf16, random
    weights from a seed, B=1, S=2048, SGD), after (a) the backward
    kernels' phase (:func:`phase_train_kernel`): (b) the eager step at
    the depth the printed arithmetic allows, with its launch counts; (c)
    ParDNN on
    the traced step at TRAIN["plan_layers"] layers: the graph's gates,
    K=4 under a generous and a tight cap, the verified plan executed
    folded onto the card against the eager step, K=1 the same, the
    interpreter at TRAIN["interp_layers"] against compiled, save / load /
    bind. Fills in the backward kernel's ``record`` (from (a)) and
    returns it."""
    from repro_torch import api
    from repro_torch.conformance import make_train_step
    from repro_torch.core.costmodel import H100
    from repro_torch.core.graph import RESIDUAL
    from repro_torch.models import init_params
    B, S, lr = TRAIN["batch"], TRAIN["seq"], TRAIN["lr"]
    gb = 1e9

    # (b) the eager step: its depth from the arithmetic
    total = torch.cuda.get_device_properties(0).total_memory
    batch = _train_batch(torch, cfg, seed=2)

    def sgd_step(c):
        p = init_params(c, torch.Generator(device="cuda").manual_seed(1),
                        "cuda")
        st = make_train_step(c, lr)
        return p, lambda: st(p, batch)
    layers, p1, p0 = fit_depth(torch, cfg, "train", sgd_step,
                               "3P (parameters, grads, new parameters)")
    log(f"train: the plan path also holds the grads as outputs and returns "
        f"clones (about 2P more); at {TRAIN['plan_layers']} layers P = "
        f"{(p0 + TRAIN['plan_layers'] * p1) / gb:.2f} GB")
    deep = dataclasses.replace(cfg, num_layers=layers)
    params = init_params(deep, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    hd = cfg.head_dim
    launches = _eager_sgd(
        torch, deep, "train", params, batch, lr, card,
        {**_flash_want(layers), "wkv6": 0},
        calls=[(hd, hd, True, None)] * layers, in_place=False)["launches"]
    record["launches"] = launches["flash_attention_bwd"]
    record["variant_launches"] = {
        v: launches[f"flash_attention_bwd/{v}"] for v in ops.BWD_VARIANTS}
    del params
    _release(torch)

    # (c) ParDNN on the traced step
    L = TRAIN["plan_layers"]
    mid = dataclasses.replace(cfg, num_layers=L)
    params = init_params(mid, torch.Generator(device="cuda").manual_seed(3),
                         "cuda")
    step = make_train_step(mid, lr, return_grads=True)
    t0 = time.perf_counter()
    traced, gm = _trace_aten(step, params, batch)
    trace_s = time.perf_counter() - t0
    g = traced.graph
    names = [n.split(".")[0] for n in g.names]
    res_bytes = float(g.mem[g.ntype == RESIDUAL].sum())
    transient = float(g.mem[g.ntype != RESIDUAL].max())
    dot, want_dot = float(g.op_dot_flops.sum()), train_dot_flops(mid, B, S)
    # the aten graph's shapes: which ops make a tensor of a whole stacked
    # leaf's shape; sizes alone coincide at this width (the embedding,
    # the logits and a stacked wq are 402,653,184 bytes each at 12
    # layers)
    whole, stacked = _whole_stack_ops(torch, gm, params)
    del gm
    log(f"train plan: traced the {L}-layer step on cuda in {trace_s:.2f} s: "
        f"{g.n} nodes, {names.count('flash_attention')} flash forward and "
        f"{names.count('flash_attention_bwd')} backward nodes, "
        f"{names.count('select_backward')} select_backward, "
        f"{len(whole)} ops of a stacked leaf's shape ({sorted(set(whole))}"
        f", {len(stacked)} stacked leaves), RESIDUAL {res_bytes / 2**30:.3f} "
        f"GiB, largest transient {transient / 2**30:.3f} GiB; product FLOPs "
        f"{dot:.6g} (from the config {want_dot:.6g}), all FLOPs "
        f"{g.op_flops.sum():.6g}")
    assert names.count("flash_attention") == L and \
        names.count("flash_attention_bwd") == L
    assert "select_backward" not in names, "the step differentiates through " \
        "the stacked periods"
    assert whole == ["stack"] * len(stacked), \
        f"whole-stack nodes other than the restacks: {whole}"
    assert dot == want_dot, f"product FLOPs {dot} != {want_dot}"

    k = 4
    caps = {"generous": total / 2,
            "tight": 1.2 * (res_bytes + transient) / k}
    meta = {"arch": cfg.name, "layers": L, "static_argnums": [0]}
    plans, accepted = {}, {}
    for label, cap in caps.items():
        t0 = time.perf_counter()
        plan = api.partition(traced, devices=k, memory=cap, meta=meta)
        part_s = time.perf_counter() - t0
        a = plan.assignment
        assert a.shape == (g.n,) and a.min() >= 0 and a.max() < k
        cut = sum((c - H100.link_latency) * H100.link_bw
                  for u in range(g.n) for v, c in g.out_edges[u]
                  if a[u] != a[v])
        rep = plan.verify()
        cnt = rep.counts()
        cert, segments = _certificate(plan)
        log(f"train plan: K={k} {label} cap {cap / 2**30:.3f} GiB per PE: "
            f"partition {part_s:.2f} s, feasible={plan.feasible}, peaks ["
            + ", ".join(f"{p / 2**30:.3f}" for p in plan.peak_mem)
            + f"] GiB, cut {cut / 2**20:.1f} MiB, makespan "
            f"{plan.makespan * 1e3:.3f} ms; verified {cnt['error']}E/"
            f"{cnt['warn']}W/{cnt['info']}I ({segments} segments, "
            f"certificate [" + ", ".join(f"{x / 2**30:.3f}" for x in cert)
            + "] GiB)" + "".join(f"; {d}" for d in rep.errors[:2]))
        plans[label] = plan
        if not rep.has_errors():
            accepted[label] = plan
    assert "generous" in accepted, "the verifier refuses the generous plan"
    # the tight plan where ParDNN found it feasible and the verifier agrees
    label = "tight" if "tight" in accepted and plans["tight"].feasible \
        else "generous"
    plan = accepted[label]
    path = f"{tempfile.mkdtemp()}/train.plan.json"
    loaded = api.PartitionPlan.load(plan.save(path), traced=traced)
    assert np.array_equal(loaded.assignment, plan.assignment) and \
        loaded.meta["static_argnums"] == [0]
    log(f"train plan: the {label}-cap plan saved, loaded and bound: "
        f"fingerprint and assignment equal")
    del plans, accepted, loaded

    want = step(params, batch)
    again = step(params, batch)
    eager_det = all(torch.equal(a, b) for a, b in
                    zip(_train_leaves(want), _train_leaves(again)))
    log(f"train plan: the eager {L}-layer step repeated bit-equal: "
        f"{eager_det}")
    del again
    cells = {}
    one = api.partition(traced, devices=1, meta=meta)
    for name, p in ((f"K=4 {label} cap", plan), ("K=1", one)):
        cells[name] = _train_plan_cell(
            torch, name, p, params, batch, lambda: step(params, batch), want,
            L)
        del p._compiled_runtime
        _release(torch)
    del traced, plan, one, want, params, step
    _release(torch)

    # the interpreter keeps every intermediate: a shallower step
    L4 = TRAIN["interp_layers"]
    small = dataclasses.replace(cfg, num_layers=L4)
    params = init_params(small, torch.Generator(device="cuda").manual_seed(4),
                         "cuda")
    step = make_train_step(small, lr, return_grads=True)
    traced = api.trace(step, params, batch, record=True, autograd=True)
    plan = api.partition(traced, devices=k, memory=total / 2, meta=meta)
    fold = [0] * k
    compiled = _train_leaves(plan.execute(params, batch, device_map=fold,
                                          mode="sync", static_argnums=(0,)))
    t0 = time.perf_counter()
    interp = _train_leaves(plan.execute(params, batch, device_map=fold,
                                        runtime="interpret"))
    torch.cuda.synchronize()
    interp_s = time.perf_counter() - t0
    bit = all(torch.equal(a, b) for a, b in zip(interp, compiled))
    worst = max(float((a.float() - b.float()).abs().max()) /
                (TRAIN_GATE * max(float(b.float().abs().max()), 1e-30))
                for a, b in zip(interp, compiled))
    log(f"train interpreter {L4} layers K={k} ({plan.n} nodes): "
        f"{interp_s:.2f} s, bit-equal to compiled sync: {bit}; worst leaf "
        f"error / (2^-7 x max |compiled|) {worst:.3g}")
    assert bit or worst <= 1, "the interpreter disagrees with compiled"
    del plan, traced, params, step, compiled, interp
    _release(torch)
    for name, c in cells.items():
        log(f"train plan {name} summary ({L} layers): " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in c["ms"].items()) + "; device busy "
            + ", ".join(f"{k} {p['busy_ms']:.2f} of {p['wall_ms']:.2f} ms"
                        for k, p in c["prof"].items())
            + f"; {c['segments']} segments, capture {c['capture_s']:.2f} s; "
            f"measured makespan {c['measured_ms']:.3f} ms against the "
            f"predicted {c['predicted_ms']:.3f} ms; bit-equal to eager "
            f"{c['bit']}; {card}")
    return record


# ---------------------------------------------------------------------------
# calibration: measure the card, fit the device model, score the plans
# ---------------------------------------------------------------------------
#: accuracy_report's profiled passes (serialised, medians taken)
CALIBRATE_REPS = 3

#: the scorecard entries the calibrate phase prints for each plan
SCORECARD = ("stage_mape_pct", "device_mape_pct", "predicted_makespan_s",
             "measured_wall_s", "makespan_ratio",
             "predicted_serialized_makespan_s", "serialized_makespan_ratio",
             "predicted_overlap_makespan_s", "measured_async_wall_s",
             "overlap_makespan_ratio", "num_stages", "stages_scored")


def _fmt(v, scale: float = 1.0, unit: str = "", digits: int = 4) -> str:
    return "not fitted" if v is None else f"{v * scale:.{digits}g}{unit}"


def _scorecard(label: str, when: str, acc: dict) -> dict:
    card = {k: acc[k] for k in SCORECARD}
    log(f"calibrate {label} {when}: stage MAPE "
        f"{_fmt(acc['stage_mape_pct'], unit=' %')} over "
        f"{acc['stages_scored']} of {acc['num_stages']} stages, device MAPE "
        f"{_fmt(acc['device_mape_pct'], unit=' %')}; predicted makespan "
        f"{acc['predicted_makespan_s'] * 1e3:.3f} ms against "
        f"{acc['measured_wall_s'] * 1e3:.3f} ms measured (sync, ratio "
        f"{_fmt(acc['makespan_ratio'])}; serialised prediction "
        f"{_fmt(acc['predicted_serialized_makespan_s'], 1e3, ' ms')}, "
        f"ratio {_fmt(acc['serialized_makespan_ratio'])}); overlap "
        f"prediction "
        f"{_fmt(acc['predicted_overlap_makespan_s'], 1e3, ' ms')} against "
        f"{acc['measured_async_wall_s'] * 1e3:.3f} ms (async, ratio "
        f"{_fmt(acc['overlap_makespan_ratio'])}); cost model "
        f"{acc['cost_model']}")
    if not acc["stages_scored"] > 0:
        raise AssertionError(f"calibrate {label} {when}: no stage scored")
    return card


def _calibrate_cell(torch, api, label: str, traced, plan, args, cap: float,
                    hold, work: Path) -> dict:
    """One plan through the loop, folded onto the card: accuracy_report;
    calibrate (saved, loaded back with the device check, bit-equal);
    annotate; the old plan refuses to bind (RP102); re-partition at
    ``cap``, verify, execute held to eager by ``hold``; accuracy_report
    again; compare against rr and topo."""
    from repro_torch.core.errors import (RP102_FINGERPRINT_MISMATCH,
                                         PlanValidationError)
    from repro_torch.profiling import (CalibrationProfile,
                                       profile_differences)
    fold = [0] * plan.k
    before = _scorecard(label, "before calibration",
                        plan.accuracy_report(*args, device_map=fold,
                                             reps=CALIBRATE_REPS))
    del plan._compiled_runtime
    _release(torch)
    path = str(work / f"{label.split()[0]}.calib.json")
    reset_counts()
    t0 = time.perf_counter()
    profile = api.calibrate(traced, *args, device="cuda", save=path,
                            meta={"plan": label})
    calib_s = time.perf_counter() - t0
    launches = read_counts()
    _release(torch)
    loaded = CalibrationProfile.load(path, expect_device=True)
    differ = profile_differences(profile, loaded)
    f, m, dm = profile.fitted, profile.meta, profile.device_model()
    log(f"calibrate {label}: fingerprint {profile.device_fingerprint}; "
        f"{m['signatures_measured']} of {m['signatures']} signatures "
        f"measured over {len(traced.program.program)} op nodes in "
        f"{calib_s:.2f} s; fitted: sustained "
        f"{_fmt(f['flop_efficiency'], dm.peak_flops / 1e12, ' TFLOP/s')} "
        f"(flop_efficiency {_fmt(f['flop_efficiency'])} of "
        f"{dm.peak_flops / 1e12:.0f}), HBM "
        f"{_fmt(f['hbm_bw'], 1e-9, ' GB/s')}, link alpha "
        f"{_fmt(f['link_latency'], 1e6, ' us')} beta "
        f"{_fmt(None if f['link_bw'] is None else 1 / f['link_bw'], 1e12, ' ps/B')}"
        f" ({_fmt(f['link_bw'], 1e-9, ' GB/s')}; {m['transfer_probe']}), "
        f"dispatch overhead {profile.dispatch_overhead_s * 1e6:.2f} us, "
        f"fusion factor {profile.fusion_factor:.4f}; saved and loaded back "
        f"with expect_device=True, bit-equal: {not differ}")
    if differ:
        raise AssertionError(f"calibrate {label}: the profile did not "
                             f"round-trip bit-equal: {differ}")
    old = traced.fingerprint
    traced.annotate(loaded)
    try:
        plan.bind(traced)
    except PlanValidationError as e:
        refused = e.code == RP102_FINGERPRINT_MISMATCH
    else:
        refused = False
    log(f"calibrate {label}: annotated ({old[:12]} -> "
        f"{traced.fingerprint[:12]}); the old plan refuses to bind with "
        f"RP102: {refused}")
    if not refused:
        raise AssertionError(f"calibrate {label}: the old plan still binds "
                             f"to the re-priced trace")
    new = api.partition(traced, devices=plan.k, memory=cap, meta=plan.meta)
    rep = new.verify(strict=True)
    c = rep.counts()
    moved = int(np.count_nonzero(new.assignment != plan.assignment))
    log(f"calibrate {label}: re-partitioned at {cap / 2**30:.3f} GiB per "
        f"PE: feasible={new.feasible}, {moved} of {new.n} nodes moved, "
        f"predicted makespan {new.makespan * 1e3:.3f} ms (before "
        f"{plan.makespan * 1e3:.3f} on the old prices); verified "
        f"{c['error']}E/{c['warn']}W/{c['info']}I")
    hold(new.execute(*args, device_map=fold))
    after = _scorecard(label, "after calibration",
                       new.accuracy_report(*args, device_map=fold,
                                           reps=CALIBRATE_REPS))
    json.loads(json.dumps(new.report.to_dict()))      # valid JSON
    cmp = new.compare(("rr", "topo"))
    log(f"calibrate {label}: compare on the calibrated graph: ParDNN "
        f"{new.makespan * 1e3:.3f} ms; " + "; ".join(
            f"{name} {r['makespan_s'] * 1e3:.3f} ms ({r['speedup']:.3f}x)"
            for name, r in cmp.items()))
    del new._compiled_runtime
    _release(torch)
    fell = after["stage_mape_pct"] < before["stage_mape_pct"]
    log(f"calibrate {label}: stage MAPE {before['stage_mape_pct']:.2f} % "
        f"-> {after['stage_mape_pct']:.2f} % "
        f"({'fell' if fell else 'did NOT fall'})")
    return {"before": before, "after": after, "compare": cmp,
            "calibration_s": calib_s, "profile": profile,
            "launches": launches, "fitted": dict(f),
            "dispatch_overhead_s": profile.dispatch_overhead_s,
            "fusion_factor": profile.fusion_factor,
            "signatures": m["signatures_measured"]}


def phase_calibrate(torch, ops, cfg, card: str, train_record,
                    planned: tuple | None = None) -> None:
    """Profile and calibrate on the card, then score ParDNN's plans before
    and after: (a) full granite-8b's paged decode step (bf16, 36 layers,
    the serve phase's geometry), K=4 half-cap plan (``planned``: the plan
    phase's trace and plan, when it ran); (b) granite-8b's
    training step (B=1, S=2048, TRAIN["plan_layers"] layers), K=4 under
    half the card per PE; each through :func:`_calibrate_cell`; (c)
    ``benchmark_runtimes`` on a TRAIN["interp_layers"]-layer training
    plan; the profiled per-call seconds of the flash nodes beside CUDA
    events at the same shape."""
    from repro_torch import api
    from repro_torch.conformance import make_train_step
    from repro_torch.models import init_params
    from repro_torch.profiling.opbench import corrected_seconds
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"calibrate: {_release(torch):.3f} GiB allocated at the start")
    cells = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        # (a) the paged decode step, all 36 layers
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
        inputs = _decode_inputs(torch, eng, seed=4)
        eng.pools = None
        args = (params,) + tuple(inputs)
        if planned is None:
            traced = api.trace(eng._decode_impl, *args, record=True)
            plan = _half_cap_plan(api, traced, total,
                                  meta=_serving_meta(cfg, GEOMETRY))
        else:
            # the plan phase's trace of this step and its verified
            # half-cap plan (the calibration annotates the trace)
            traced, plan = planned
        pools, bt, toks, lens = inputs
        want = eng._decode_impl(params, tree_map(torch.clone, pools), bt,
                                toks, lens)
        label = f"decode {cfg.name} K=4"
        cells["decode"] = _calibrate_cell(
            torch, api, label, traced, plan, args, total / 2,
            lambda got: _hold_to_eager(torch, f"calibrated {label}", got,
                                       want, PLAN_BF16_GATE), work)
        launches = cells["decode"]["launches"]
        assert not any(launches.values()), \
            f"a kernel launched on the decode path: {launches}"
        del traced, plan, want, args, inputs, pools, eng, params
        _release(torch)

        # (b) the training step at TRAIN["plan_layers"] layers
        L, B, S = TRAIN["plan_layers"], TRAIN["batch"], TRAIN["seq"]
        mid = dataclasses.replace(cfg, num_layers=L)
        params = init_params(mid, torch.Generator(device="cuda")
                             .manual_seed(3), "cuda")
        batch = _train_batch(torch, cfg, seed=2)
        step = make_train_step(mid, TRAIN["lr"], return_grads=True)
        traced = api.trace(step, params, batch, record=True, autograd=True)
        meta = {"arch": cfg.name, "layers": L, "static_argnums": [0]}
        plan = api.partition(traced, devices=4, memory=total / 2, meta=meta)
        plan.verify(strict=True)
        want = step(params, batch)
        label = f"train {cfg.name} {L} layers K=4"
        cells["train"] = _calibrate_cell(
            torch, api, label, traced, plan, (params, batch), total / 2,
            lambda got: _hold_train(torch, f"calibrated {label}", got, want),
            work)
        launches = cells["train"]["launches"]
        got = {k: launches[k] for k in ("flash_attention",
                                        "flash_attention/sm90",
                                        "flash_attention_bwd",
                                        "flash_attention_bwd/sm90")}
        log(f"calibrate {label}: launches while calibrating {got} (the "
            f"graph has {L} flash forward and {L} backward nodes)")
        assert got["flash_attention"] == got["flash_attention/sm90"] >= L \
            and got["flash_attention_bwd"] == \
            got["flash_attention_bwd/sm90"] >= L, \
            f"calibrate: a replayed flash node did not launch sm90: {got}"
        prof = cells["train"]["profile"]
        flash = {}
        for s in prof.ops:
            name = s.name.split(".")[0]
            if name in ("flash_attention", "flash_attention_bwd"):
                flash.setdefault(name, []).append(s)
        del traced, plan, want, step, params, prof
        _release(torch)

        # the flash nodes' profiled seconds beside CUDA events
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        g = torch.Generator(device="cuda").manual_seed(301)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .bfloat16() for shape in ((B, S, H, hd),
                                                 (B, S, KV, hd),
                                                 (B, S, KV, hd),
                                                 (B, S, H, hd)))
        out, lse = ops.flash_attention(q, k, v, causal=True,
                                       return_lse=True)
        ev = {"flash_attention": cuda_ms(torch, lambda: ops.flash_attention(
                  q, k, v, causal=True, return_lse=True)),
              "flash_attention_bwd": cuda_ms(
                  torch, lambda: ops.flash_attention_bwd(
                      do, q, k, v, out, lse, causal=True))}
        del q, k, v, do, out, lse
        oh = cells["train"]["dispatch_overhead_s"]
        for name, samples in flash.items():
            log(f"calibrate flash cross-check {name} (B={B}, S={S}, H={H}, "
                f"KV={KV}, hd={hd}, bf16, causal): profiled per call " +
                ", ".join(f"{s.seconds * 1e3:.4f} ms (dispersion "
                          f"{s.dispersion:.3f}, {s.count} nodes; less the "
                          f"dispatch overhead "
                          f"{corrected_seconds(s.seconds, oh) * 1e3:.4f})"
                          for s in samples)
                + f"; CUDA events, back-to-back {ev[name]:.4f} ms"
                + (f"; train_kernels phase {train_record['ms']:.4f} ms"
                   if name == "flash_attention_bwd" and train_record
                   else ""))
        _release(torch)

        # (c) both engines at TRAIN["interp_layers"] layers
        L4 = TRAIN["interp_layers"]
        small = dataclasses.replace(cfg, num_layers=L4)
        params = init_params(small, torch.Generator(device="cuda")
                             .manual_seed(4), "cuda")
        step = make_train_step(small, TRAIN["lr"], return_grads=True)
        traced = api.trace(step, params, batch, record=True, autograd=True)
        plan = api.partition(traced, devices=4, memory=total / 2,
                             meta=dict(meta, layers=L4))
        res = plan.benchmark_runtimes(params, batch, device_map=[0] * 4,
                                      reps=5)
        log(f"calibrate benchmark_runtimes {cfg.name} {L4} layers K=4: "
            f"interpreter {res['interpreter_s'] * 1e3:.2f} ms, compiled "
            f"first call {res['compiled_first_call_s'] * 1e3:.2f} ms, "
            f"compiled async {res['compiled_s'] * 1e3:.2f} ms (dispersion "
            f"{res['compiled_dispersion']:.3f}, {res['compiled_samples']} "
            f"samples), sync {res['compiled_sync_s'] * 1e3:.2f} ms; "
            f"speedup over the interpreter {res['speedup']:.2f}x; "
            f"{res['num_segments']} segments; drift compiled vs interpreter "
            f"{res['output_drift']:.3g}, async vs sync "
            f"{res['sync_async_drift']:.3g}")
        assert res["sync_async_drift"] == 0.0, \
            "benchmark_runtimes: async and sync disagree"
        del plan, traced, params, step, batch
        _release(torch)
    summary = {name: {"before": c["before"], "after": c["after"],
                      "fitted": c["fitted"],
                      "dispatch_overhead_s": c["dispatch_overhead_s"],
                      "fusion_factor": c["fusion_factor"],
                      "signatures": c["signatures"],
                      "calibration_s": c["calibration_s"],
                      "compare": c["compare"]}
               for name, c in cells.items()}
    log("calibrate scorecards " + json.dumps(summary))
    log(f"calibrate: {time.perf_counter() - t_phase:.1f} s; {card}")


# ---------------------------------------------------------------------------
# rwkv6-7b training: the wkv6 backward kernel, the eager step and a plan
# ---------------------------------------------------------------------------
#: the wkv6 backward kernel's cases: the rwkv6-7b training shape in both
#: dtypes (the model's decay at init), then the edges; ``given``: a random
#: state0 and a random cotangent of the last state (else None and zeros);
#: decay ``edge``: every channel's summed log-decay over a chunk near
#: -RWKV_BWD_EDGE, the edge of the range the kernel states
RWKV_BWD_CASES = [
    # (B, H, S, hd, chunk, dtype, given, decay)
    (1, 64, 2048, 64, 64, "bfloat16", True, "model"),    # training shape
    (1, 64, 2048, 64, 64, "float32", False, "model"),
    (2, 4, 131, 16, 16, "float32", True, "test"),        # hd 16, chunk 16
    (1, 4, 1000, 32, 64, "float32", True, "test"),       # hd 32, ragged
    (2, 8, 1000, 64, 32, "bfloat16", True, "test"),      # chunk 32, ragged
    (1, 2, 256, 64, 64, "bfloat16", False, "test"),      # B·H = 2
    (1, 8, 512, 64, 64, "float32", True, "edge"),
    (1, 4, 200, 64, 16, "bfloat16", True, "edge"),
]
RWKV_BWD_EDGE = 150.0
# The gate, from the float32 argument in rwkv6_bwd.cu (written before the
# kernel first ran): each gradient within 2e-5 x max(1, |tot|_max / 20) x
# max(1, max |plain|), |tot|_max the largest summed log-decay of a chunk;
# dr, dk and dv in bf16 one rounding more, 2^-7 x max |plain|.
RWKV_BWD_GATE = 2e-5
RWKV_BWD_ROUND = 2.0 ** -7
#: the mma backward's two kernels in stream order, as a profile names them
RWKV_BWD_STAGES = ("wkv6_bwd_walk_mma", "wkv6_bwd_grad_mma")
#: the training step's kernels in a profile: the wkv6 forwards (mma, fma)
#: and the backwards (the mma one's two stages, the fma one)
RWKV_KERNELS = ("wkv6_mma_kernel", "wkv6_kernel") + RWKV_BWD_STAGES + (
    "wkv6_bwd_kernel",)


def _rwkv_bwd_inputs(torch, case, seed):
    """(r, k, v, w, u, state0, dy, ds_last) for a RWKV_BWD_CASES case."""
    B, H, S, hd, chunk, dtype, given, decay = case
    r, k, v, w, u, s0 = _rwkv_inputs(torch, case[:6], seed,
                                     "test" if decay == "edge" else decay,
                                     given)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    if decay == "edge":
        w = torch.exp(-RWKV_BWD_EDGE / chunk + 0.01 * torch.randn(
            w.shape, generator=g, device="cuda"))
    dy = torch.randn((B, S, H, hd), generator=g, device="cuda")
    ds = torch.randn((B, H, hd, hd), generator=g, device="cuda") if given \
        else torch.zeros((B, H, hd, hd), device="cuda")
    return r, k, v, w, u, s0, dy, ds


def _tot_max(torch, w, chunk: int) -> float:
    """The largest |summed log-decay| over a chunk and a channel."""
    B, S, H, hd = w.shape
    n = -(-S // chunk)
    logw = torch.zeros((B, n * chunk, H, hd), device=w.device)
    logw[:, :S] = torch.log(w)
    return float(logw.reshape(B, n, chunk, H, hd).sum(2).abs().max())


def _hold_rwkv_bwd(torch, label, got, again, want, dtype, tot) -> tuple:
    """The backward kernel's six gradients against the plain version's
    under the RWKV_BWD gate, finite, a repeated call bit-equal. Returns
    (worst error / gate, max abs error)."""
    scale = RWKV_BWD_GATE * max(1.0, tot / 20)
    ratios, errs = [], []
    for i, (a, b) in enumerate(zip(got, want)):
        err = float((a.float() - b).abs().max())
        top = float(b.abs().max())
        allow = scale * max(1.0, top) + (
            RWKV_BWD_ROUND * top if i < 3 and dtype == "bfloat16" else 0.0)
        ratios.append(err / allow)
        errs.append(err)
    rep = all(torch.equal(a, b) for a, b in zip(got, again))
    fin = all(bool(torch.isfinite(a).all()) for a in got)
    ok = rep and fin and max(ratios) <= 1
    log(f"kernel wkv6_bwd {label}: |tot|_max {tot:.3g}; error / gate (dr, "
        f"dk, dv, dw, du, dstate0) [{', '.join(f'{r:.3g}' for r in ratios)}]"
        f", max abs err {max(errs):.3g}; repeated call bit-equal {rep} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"wkv6_bwd disagrees with its plain version "
                             f"at {label}")
    return max(ratios), max(errs)


def _fma_walk_only(torch, rops, build):
    """The fma backward kernel (``rwkv6_bwd.cu``) cut after its phase 1,
    the forward walk over the chunks: a text-substituted copy of its
    source built into a library of its own. Returns ``call(args, chunk)``,
    which launches it on CUDA tensors (its outputs are left unwritten):
    what the fma kernel's design spends on its forward walk."""
    import ctypes
    src = (rops.CSRC / "rwkv6_bwd.cu").read_text()
    marker = "  // ---- 2. backward: the chunks in reverse, carrying dS\n"
    assert src.count(marker) == 1, "rwkv6_bwd.cu: phase 2 not found"
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "rwkv6_bwd.cu").write_text(
            src.replace(marker, "  return;\n" + marker))
        lib = ctypes.CDLL(str(build.build("rwkv6_bwd_walk_only", Path(tmp))))
    fn = lib.repro_wkv6_bwd
    fn.argtypes = rops._BWD_ARGTYPES
    fn.restype = ctypes.c_int

    def call(args, chunk):
        r, k, v, w, u, s0, dy, ds = args
        B, S, H, hd = r.shape
        outs = [torch.empty_like(r) for _ in range(3)] + [
            torch.empty(r.shape, device="cuda"),
            torch.empty((B, H, hd), device="cuda"),
            torch.empty((B, H, hd, hd), device="cuda"),
            torch.empty((B, H, -(-S // chunk), hd, hd), device="cuda")]
        err = fn(*(None if t is None else t.data_ptr()
                   for t in (r, k, v, w, u, s0, dy, ds)),
                 *(t.data_ptr() for t in outs), 1, B, S, H, hd, chunk,
                 *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *w.stride()[:3], *dy.stride()[:3], *r.stride()[:3],
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"the fma walk-only copy: cudaError {err}"
    return call


def phase_rwkv_train_kernel(torch, rops, rref, build) -> dict:
    """The wkv6 backward kernels against their plain version at every case
    of RWKV_BWD_CASES: the one ``select_bwd_variant`` names (``mma`` in
    bf16 at hd 64, else ``fma``) and in bf16 at hd 64 the ``fma`` kernel
    by name too, repeated calls bit-equal. At the training shape, in
    turns: the mma kernel, the fma kernel and the fma kernel cut after
    its forward walk (built meanwhile from a copy of its source), then
    one call of the plain version, beside the bound; the mma kernel's
    two stages timed apart (torch.profiler), the kernels' registers and
    spills (ptxas) and the mma kernel's blocks per SM. Returns the mma
    kernel's record (launches filled in by the rwkv_train phase)."""
    pool = ThreadPoolExecutor(1)
    walk_only = pool.submit(_fma_walk_only, torch, rops, build)
    worst = {}
    counts = rops.wkv6_bwd.variant_launches
    for i, case in enumerate(RWKV_BWD_CASES):
        args = _rwkv_bwd_inputs(torch, case, 400 + i)
        hd, chunk, dtype = case[3:6]
        variant = rops.select_bwd_variant(getattr(torch, dtype), hd)
        want = rref.wkv_bwd_ref(*args, chunk)
        tot = _tot_max(torch, args[3], chunk)
        for name in ("mma", "fma") if variant == "mma" else (variant,):
            before = (rops.wkv6_bwd.launches, counts[name])
            if name == variant:
                got = rops.wkv6_bwd(*args, chunk)
                again = rops.wkv6_bwd(*args, chunk)
            else:
                got = rops.run_bwd_variant(name, *args, chunk)
                again = rops.run_bwd_variant(name, *args, chunk)
            assert (rops.wkv6_bwd.launches, counts[name]) == (
                before[0] + 2, before[1] + 2), f"{case}: {name} not launched"
            worst[(i, name)] = _hold_rwkv_bwd(torch, f"{case} [{name}]", got,
                                              again, want, dtype, tot)
            del got, again
        del args, want
    by_kernel = {name: max(r for (_, n), (r, _) in worst.items()
                           if n == name) for name in rops.BWD_VARIANTS}
    log(f"kernel wkv6_bwd: {len(RWKV_BWD_CASES)} cases, {len(worst)} (case, "
        f"kernel) pairs, worst error / gate by kernel " + ", ".join(
            f"{name} {r:.3g}" for name, r in by_kernel.items()))

    case = RWKV_BWD_CASES[0]
    B, H, S, hd, chunk, dtype = case[:6]
    assert rops.select_bwd_variant(torch.bfloat16, hd) == "mma"
    args = _rwkv_bwd_inputs(torch, case, 400)
    fma_walk = walk_only.result()
    pool.shutdown()
    ms = timed_turns(torch, {
        "mma": lambda: rops.wkv6_bwd(*args, chunk),
        "fma": lambda: rops.run_bwd_variant("fma", *args, chunk),
        "fma walk": lambda: fma_walk(args, chunk),
    }, reps={"fma": 3, "fma walk": 5})
    ms["plain"] = once_ms(torch, lambda: rref.wkv_bwd_ref(*args, chunk))
    split = kernel_split(torch, lambda: rops.wkv6_bwd(*args, chunk),
                         RWKV_BWD_STAGES)
    outs = rops.wkv6_bwd(*args, chunk)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*args, *outs) if t is not None)
    n = -(-S // chunk)
    # the chunked form's backward: twice the forward's four products
    flops = 2 * 2 * B * H * n * (2 * chunk * chunk * hd + 2 * chunk * hd * hd)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    bound = max(t_bytes, t_ops)
    work = B * H * n * hd * hd * 4
    occ = rops.bwd_mma_blocks_per_sm()
    log(f"timing wkv6_bwd at the training shape {case}, in turns: mma "
        f"{ms['mma']:.4f} ms ({nbytes / ms['mma'] / 1e6:.1f} GB/s, "
        f"{bound / ms['mma']:.1%} of the bound), fma "
        f"{ms['fma']:.4f} ms, the fma kernel cut after its forward walk "
        f"{ms['fma walk']:.4f} ms, plain {ms['plain']:.4f} ms; bound "
        f"{bound:.4f} ms ({nbytes / 2**20:.1f} MiB in and out, "
        f"{flops / 1e9:.2f} GFLOP; the mma kernel's two state workspaces, "
        f"{2 * work / 2**20:.1f} MiB written and read, are not counted); mma "
        f"is {ms['fma'] / ms['mma']:.2f}x fma (the 3x goal "
        f"{'met' if ms['fma'] >= 3 * ms['mma'] else 'not met'}; the 0.6 ms "
        f"goal {'met' if ms['mma'] <= 0.6 else 'not met'}); no PyTorch call "
        f"computes it")
    log("timing wkv6_bwd mma by stage (torch.profiler, ms per launch, "
        "launches recorded of those made): " + split_text(split)
        + f"; blocks per SM {occ}")
    regs = {k: v for k, v in ptxas_report(build, rops, "rwkv6").items()
            if "bwd" in k}
    for kernel, used in regs.items():
        log(f"  ptxas {kernel}: {used}")
    record = {
        "name": "wkv6_bwd", "variant": "mma", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6_bwd_mma.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:74",
        "note": "the gradient of that kernel; the reference has no "
                "backward kernel (JAX differentiates models/rwkv.py:56 "
                "_wkv_chunked)",
        "launches": None, "variant_launches": None,
        "max_abs_err": worst[(0, "mma")][1],
        "gate_ratio": max(r for r, _ in worst.values()),
        "ms": ms["mma"], "plain_ms": ms["plain"], "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "earlier_ms": ms["fma"],
        "earlier_source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6_bwd.cu",
        "earlier_walk_ms": ms["fma walk"],
        "kernel_ms": {k: ms_ for k, (ms_, _) in split.items()},
        "blocks_per_sm": occ,
    }
    del args, outs
    _release(torch)
    return record


def rwkv_train_dot_flops(cfg, batch: int, seq: int) -> float:
    """Product FLOPs of one rwkv training step from the config: 3 x
    2·T·(the matmul parameters: five d x d time-mix projections and the
    channel mix's receptance, the decay LoRA, the channel mix's two d x
    d_ff, the head) and, per layer, the recurrence's chunked products,
    2·B·H·n·(2·C²·hd + 2·C·hd²) forward and twice that backward."""
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    per_layer = 6 * d * d + 2 * d * cfg.rwkv.lora_w + 2 * d * cfg.d_ff
    mm = cfg.num_layers * per_layer + d * cfg.padded_vocab
    C, n = min(64, seq), -(-seq // 64)
    rec = 3 * 2 * batch * (d // hd) * n * (2 * C * C * hd + 2 * C * hd * hd)
    return 6.0 * batch * seq * mm + cfg.num_layers * rec


def phase_rwkv_train(torch, cfg, card: str, record: dict) -> dict:
    """rwkv6-7b's training step at full width (bf16, random weights from
    a seed, B=1, S=2048, SGD at lr 1e-3): (a) the eager step at the depth
    the printed arithmetic allows, with its launch counts (L forward, all
    mma, and L backward); (b) the step at TRAIN["plan_layers"] layers
    traced, partitioned at K=4, verified, executed with its PEs folded
    onto the card against the eager step. Fills in the backward kernel's
    ``record`` and returns it."""
    from repro_torch import api
    from repro_torch.conformance import make_train_step
    from repro_torch.models import init_params
    B, S, lr = TRAIN["batch"], TRAIN["seq"], TRAIN["lr"]
    batch = _train_batch(torch, cfg, seed=5)

    def sgd_step(c):
        p = init_params(c, torch.Generator(device="cuda").manual_seed(1),
                        "cuda")
        st = make_train_step(c, lr)
        return p, lambda: st(p, batch)
    layers, _, _ = fit_depth(torch, cfg, "rwkv train", sgd_step,
                             "3P (parameters, grads, new parameters)")
    deep = dataclasses.replace(cfg, num_layers=layers)
    params = init_params(deep, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    launches = _eager_sgd(
        torch, deep, "rwkv train", params, batch, lr, card,
        {"wkv6": layers, "wkv6/mma": layers, "wkv6_bwd": layers,
         "wkv6_bwd/mma": layers, "flash_attention": 0,
         "flash_attention_bwd": 0},
        calls=[], in_place=False, kernels=RWKV_KERNELS)["launches"]
    record["launches"] = launches["wkv6_bwd"]
    record["variant_launches"] = {v: launches[f"wkv6_bwd/{v}"]
                                  for v in ("mma", "fma")}
    del params
    _release(torch)

    # (b) the traced step at plan_layers, K=4, executed folded
    L = TRAIN["plan_layers"]
    mid = dataclasses.replace(cfg, num_layers=L)
    params = init_params(mid, torch.Generator(device="cuda").manual_seed(3),
                         "cuda")
    step = make_train_step(mid, lr, return_grads=True)
    t0 = time.perf_counter()
    traced = api.trace(step, params, batch, record=True, autograd=True)
    trace_s = time.perf_counter() - t0
    g = traced.graph
    names = [n.split(".")[0] for n in g.names]
    dot, want_dot = float(g.op_dot_flops.sum()), rwkv_train_dot_flops(
        mid, B, S)
    log(f"rwkv train plan: traced the {L}-layer step in {trace_s:.2f} s: "
        f"{g.n} nodes, {names.count('wkv6')} wkv6 and "
        f"{names.count('wkv6_bwd')} wkv6_bwd nodes, "
        f"{names.count('select_backward')} select_backward; product FLOPs "
        f"{dot:.6g} (from the config {want_dot:.6g})")
    assert names.count("wkv6") == L and names.count("wkv6_bwd") == L
    assert "select_backward" not in names
    assert dot == want_dot, f"product FLOPs {dot} != {want_dot}"
    total = torch.cuda.get_device_properties(0).total_memory
    meta = {"arch": cfg.name, "layers": L, "static_argnums": [0]}
    t0 = time.perf_counter()
    plan = api.partition(traced, devices=4, memory=total / 2, meta=meta)
    part_s = time.perf_counter() - t0
    a = plan.assignment
    assert a.shape == (g.n,) and a.min() >= 0 and a.max() < 4
    rep = plan.verify()
    cnt = rep.counts()
    log(f"rwkv train plan: K=4 cap {total / 2 / 2**30:.3f} GiB per PE: "
        f"partition {part_s:.2f} s, feasible={plan.feasible}, peaks ["
        + ", ".join(f"{p / 2**30:.3f}" for p in plan.peak_mem)
        + f"] GiB, makespan {plan.makespan * 1e3:.3f} ms; verified "
        f"{cnt['error']}E/{cnt['warn']}W/{cnt['info']}I"
        + "".join(f"; {d}" for d in rep.errors[:2]))
    assert not rep.has_errors(), "the verifier refuses the rwkv plan"
    want_out = step(params, batch)
    cell = _train_plan_cell(torch, "rwkv K=4", plan, params, batch,
                            lambda: step(params, batch), want_out, L,
                            RWKV_KERNELS)
    log(f"rwkv train plan summary ({L} layers): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in cell["ms"].items()) + "; device busy "
        + ", ".join(f"{k} {p['busy_ms']:.2f} of {p['wall_ms']:.2f} ms"
                    for k, p in cell["prof"].items())
        + f"; {cell['segments']} segments, capture {cell['capture_s']:.2f} "
        f"s; measured makespan {cell['measured_ms']:.3f} ms against the "
        f"predicted {cell['predicted_ms']:.3f} ms; bit-equal to eager "
        f"{cell['bit']}; {card}")
    del plan._compiled_runtime, plan, traced, params, step, want_out
    _release(torch)
    return record


# ---------------------------------------------------------------------------
# the training entry point: launch.train, checkpoints, resume, serve
# ---------------------------------------------------------------------------
#: launch.train's run: B=1, S=2048, 4 steps, a checkpoint every 2; the
#: checkpoint and resume run at CKPT_LAYERS (see phase_launch_train)
LAUNCH = dict(batch=1, seq=2048, steps=4, ckpt_every=2, lr=3e-4)
CKPT_LAYERS = 1


def _launch_run(torch, train, cfg, label: str, **kw):
    """launch.train's body on ``cfg``; returns (loop, median ms of the
    steps after the first, max_memory_allocated GiB)."""
    torch.cuda.reset_peak_memory_stats()
    loop = train(cfg, steps=LAUNCH["steps"], batch=LAUNCH["batch"],
                 seq=LAUNCH["seq"], lr=LAUNCH["lr"], device="cuda",
                 log_every=1, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = loop.state
    times = [h["time"] * 1e3 for h in st.history]
    losses = [h["loss"] for h in st.history]
    assert st.step == LAUNCH["steps"] and not st.preempted and \
        st.skipped == 0, f"{label}: {st}"
    assert all(math.isfinite(x) for x in losses), f"{label}: loss {losses}"
    ms = statistics.median(times[1:]) if len(times) > 1 else times[0]
    log(f"launch {label}: steps {[h['step'] for h in st.history]}, losses "
        f"[{', '.join(f'{x:.4f}' for x in losses)}], step ms "
        f"[{', '.join(f'{x:.1f}' for x in times)}], grad norms "
        f"[{', '.join(f'{h['grad_norm']:.3g}' for h in st.history)}]; "
        f"max_memory_allocated {peak:.3f} GiB")
    return loop, ms, peak


def phase_launch_train(torch, card: str) -> dict:
    """``repro_torch.launch.train`` in process (its body, ``train(cfg,
    ...)``) for granite-8b and rwkv6-7b at full width in bf16, B=1,
    S=2048, AdamW: (a) at the depth the printed AdamW arithmetic allows
    (16 bytes a parameter and the activations, measured at 2 and 4
    layers), 4 steps: step ms, tokens/s, peak memory, the kernels'
    launches (remat "full": 2L forward, L backward a step), then one step
    under torch.profiler; (b) at
    CKPT_LAYERS, 4 steps with a checkpoint every 2 into a temporary
    directory, then a fresh run that resumes from the step-2 checkpoint
    alone: its parameters and optimizer state against the uninterrupted
    run's (bit-equal, or within TRAIN_GATE); (c) for granite,
    ``launch.serve --ckpt-dir`` serves 4 requests from that directory's
    newest checkpoint (the resumed run's parameters). Returns granite's
    depth arithmetic (:func:`fit_depth`'s ``measured``)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, build_train_step, init_state
    from repro_torch.tree import tree_flatten
    measured: dict = {}
    for arch in ("granite-8b", "rwkv6-7b"):
        cfg = get_config(arch)
        ocfg = AdamWConfig(lr=LAUNCH["lr"], total_steps=LAUNCH["steps"])
        batch = make_batch(DataConfig(batch_size=LAUNCH["batch"],
                                      seq_len=LAUNCH["seq"],
                                      vocab_size=cfg.vocab_size), 0)

        def adamw_step(c):
            p = init_params(c, torch.Generator(device="cuda").manual_seed(1),
                            "cuda")
            o = init_state(ocfg, p)
            st = build_train_step(c, ocfg, remat_policy="full",
                                  device="cuda")
            return p, lambda: st(p, o, batch)
        layers, p1, p0 = fit_depth(
            torch, cfg, f"launch {arch}", adamw_step,
            "8P (bf16 parameters and grads, float32 mu, nu and master; "
            "remat full)",
            measured=measured if cfg.rwkv is None else None)
        fwd, bwd = ("wkv6", "wkv6_bwd") if cfg.rwkv is not None else \
            ("flash_attention", "flash_attention_bwd")
        reset_counts()
        loop, ms, peak = _launch_run(
            torch, train, dataclasses.replace(cfg, num_layers=layers),
            f"{arch} {layers} layers")
        counts = read_counts()
        n = LAUNCH["steps"]
        want = {fwd: 2 * layers * n, bwd: layers * n}
        if cfg.rwkv is not None:
            want["wkv6_bwd/mma"] = layers * n
        got = {k: counts[k] for k in want}
        assert got == want, f"launch {arch}: launches {got}, want {want}"
        first = loop.state.history[0]["loss"]
        assert abs(first - math.log(cfg.vocab_size)) < 2, \
            f"launch {arch}: first loss {first} far from ln V"
        tok_s = LAUNCH["batch"] * LAUNCH["seq"] / ms * 1e3
        log(f"launch {arch}: {layers} layers, median step {ms:.2f} ms, "
            f"{tok_s:.1f} tokens/s, max_memory_allocated {peak:.3f} GiB; "
            f"launches over {n} steps {got} (remat full: each layer's "
            f"forward twice a step); {card}")
        # where a step's time goes: three more steps of the same loop
        _profile_step(torch, f"launch {arch} {layers} layers AdamW step",
                      lambda: loop.step_fn(loop.params, loop.opt_state,
                                           batch),
                      RWKV_KERNELS if cfg.rwkv is not None
                      else FWD_KERNELS + (BWD_KERNEL,))
        del loop
        _release(torch)

        # (b) checkpoints and resume at CKPT_LAYERS
        small = dataclasses.replace(cfg, num_layers=CKPT_LAYERS)
        ckpt_gb = 7 * (p0 + CKPT_LAYERS * p1) / 1e9
        with tempfile.TemporaryDirectory() as tmp:
            first_dir, resume_dir = Path(tmp) / "run", Path(tmp) / "resume"
            t0 = time.perf_counter()
            straight, _, _ = _launch_run(
                torch, train, small, f"{arch} {CKPT_LAYERS} layers, "
                f"checkpoints", ckpt_dir=str(first_dir),
                ckpt_every=LAUNCH["ckpt_every"])
            run_s = time.perf_counter() - t0
            steps = sorted(p.name for p in first_dir.iterdir())
            resume_dir.mkdir()
            shutil.move(str(first_dir / "step_00000002"),
                        str(resume_dir / "step_00000002"))
            shutil.rmtree(first_dir)
            t0 = time.perf_counter()
            resumed, _, _ = _launch_run(
                torch, train, small, f"{arch} {CKPT_LAYERS} layers, resumed "
                f"at step 2", ckpt_dir=str(resume_dir),
                ckpt_every=LAUNCH["ckpt_every"])
            resume_s = time.perf_counter() - t0
            assert [h["step"] for h in resumed.state.history] == [3, 4], \
                "the fresh run did not resume at step 2"
            a = tree_flatten({"p": resumed.params, "o": resumed.opt_state})[0]
            b = tree_flatten({"p": straight.params,
                              "o": straight.opt_state})[0]
            bits = sum(torch.equal(x, y) for x, y in zip(a, b))
            worst = max(float((x.float() - y.float()).abs().max())
                        / (TRAIN_GATE * max(float(y.float().abs().max()),
                                            1e-30)) for x, y in zip(a, b))
            log(f"launch {arch} resume: checkpoints {steps} ({ckpt_gb:.2f} "
                f"GB each: 7 bytes a bf16 parameter's 2); the run with "
                f"checkpoints {run_s:.1f} s, the resumed run {resume_s:.1f} "
                f"s; {bits} of {len(a)} leaves (parameters and optimizer "
                f"state) bit-equal to the uninterrupted run's, worst other "
                f"leaf error / (2^-7 x max |leaf|) {worst:.3g}; last loss "
                f"{resumed.state.history[-1]['loss']:.6f} against "
                f"{straight.state.history[-1]['loss']:.6f}")
            del a, b
            assert steps == ["step_00000002", "step_00000004"], steps
            assert worst <= 1, f"launch {arch}: resumed != uninterrupted"
            del straight
            if cfg.rwkv is None:
                eng = serve_main(["--arch", arch, "--ckpt-dir",
                                  str(resume_dir), "--requests", "4",
                                  "--max-new", "8", "--max-len", "256"],
                                 cfg=small)
                served = tree_flatten(eng.params)[0]
                same = all(torch.equal(x, y) for x, y in zip(
                    served, tree_flatten(resumed.params)[0]))
                toks = [r.output for r in eng.completed.values()]
                log(f"launch serve --ckpt-dir: {len(toks)} requests, "
                    f"{sum(map(len, toks))} tokens in {eng.stats.ticks} "
                    f"ticks; served parameters equal to the resumed run's: "
                    f"{same}")
                assert same, "launch.serve did not serve the checkpoint"
                assert len(toks) == 4 and all(
                    len(t) == 8 and all(0 <= x < cfg.vocab_size for x in t)
                    for t in toks), f"launch.serve tokens {toks}"
                del eng, served
            del resumed
            log(f"launch {arch}: {_release(torch):.3f} GiB left allocated")
    return measured


# ---------------------------------------------------------------------------
# mixtral-8x7b: the MoE family served and trained at full width
# ---------------------------------------------------------------------------
def _product_role(cfg, shapes, slots: int) -> str:
    """The role of one aten mm / bmm in an MoE step, from its operands'
    shapes: an expert product has a dim of the expert d_ff; dispatch and
    combine a dim of the E·C slots; the router d_model and E as an
    operand's last dim; MLA's absorbed attention (deepseek serving) the
    latent rank or the rope width and not d_model; the plain (decode)
    attention the head dim and not d_model."""
    dims = {x for s in shapes for x in (s or [])}
    if cfg.moe.d_ff in dims:
        return "experts"
    if slots in dims:
        return "dispatch/combine"
    if cfg.d_model in dims and any(s and s[-1] == cfg.moe.num_experts
                                   for s in shapes):
        return "router"
    if cfg.kv_lora_rank and cfg.d_model not in dims and (
            cfg.kv_lora_rank in dims or cfg.qk_rope_dim in dims):
        return "MLA attention"
    if cfg.head_dim in dims and cfg.d_model not in dims:
        return "plain attention"
    return "other products"


def _moe_profile(torch, label: str, fn, cfg, group: int) -> dict:
    """One call of ``fn`` under torch.profiler, shapes recorded (after
    two warm-up calls): wall and device-busy ms, and the device ms of
    the products by role (:func:`_product_role`, groups of ``group``
    tokens), of the flash kernels by name, and of the rest (elementwise
    passes, the routing, copies)."""
    from torch.profiler import ProfilerActivity
    from repro_torch.models.moe import capacity
    slots = cfg.moe.num_experts * capacity(cfg, group)
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    roles = dict.fromkeys(("experts", "dispatch/combine", "router",
                           "plain attention", "other products",
                           "flash kernels")
                          + (("MLA attention",) if cfg.kv_lora_rank
                             else ())
                          + (("scan kernels",) if cfg.mamba else ()), 0.0)
    calls = dict.fromkeys(roles, 0)
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != cuda and e.key in ("aten::mm", "aten::bmm"):
            role = _product_role(cfg, e.input_shapes or [], slots)
            roles[role] += e.device_time_total / 1e3
            calls[role] += e.count
    for e in kernels:
        if any(name in e.key for name in FLASH_KERNEL_NAMES):
            roles["flash kernels"] += e.self_device_time_total / 1e3
            calls["flash kernels"] += e.count
        elif cfg.mamba and "ssm_" in e.key:
            roles["scan kernels"] += e.self_device_time_total / 1e3
            calls["scan kernels"] += e.count
    rest = busy_ms - sum(roles.values())
    log(f"profile {label}: wall {host_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / host_ms:.1%}), "
        f"{sum(e.count for e in kernels)} kernels; device ms by role: "
        + ", ".join(f"{k} {v:.3f} (x{calls[k]})" for k, v in roles.items())
        + f", the rest {rest:.3f} (elementwise, routing, copies)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} "
            f"{e.key[:90]}")
    return {"wall_ms": host_ms, "busy_ms": busy_ms, "roles": roles,
            "rest_ms": rest}


class _Steps:
    """Wraps a serving engine's two model calls (the module's
    ``prefill_batched`` and the engine's ``_decode``) to keep the first
    call of each (its inputs and its last-position logits), and, with
    ``force`` ({rid: tokens}), every call's logits on the host and the
    tokens each request emits replaced by ``force``'s: the engine then
    runs on another engine's tokens, and each step records (request,
    token index, top-2 gap, argmax, forced token, how far the forced
    token's logit lies below the maximum). The engine emits a call's
    tokens in the order of its logits' rows, which is how a row is
    matched to its request."""

    def __init__(self, eng, reqs, force=None):
        from repro_torch.serving import engine as engine_mod
        self.eng, self.mod, self.reqs = eng, engine_mod, reqs
        self.first, self.steps, self.force = {}, [], force
        self._rows, self._row = None, 0
        self._prefill = engine_mod.prefill_batched
        self._decode = eng._decode
        engine_mod.prefill_batched = self._wrap("prefill", self._prefill,
                                                pair=True)
        eng._decode = self._wrap("decode", self._decode, pair=False)
        if force is not None:
            for r in reqs:
                r.emit = self._emit(r, r.emit)

    def _wrap(self, name, fn, pair: bool):
        """``fn`` recording its logits: ``out[0]`` where it returns
        (logits, caches), else ``out``."""
        def call(*args):
            out = fn(*args)
            logits = out[0] if pair else out
            last = logits[:, -1]
            if name not in self.first:
                self.first[name] = (tuple(a.clone() if hasattr(a, "clone")
                                          else a for a in args),
                                    last.float().clone())
            if self.force is not None:
                self._rows, self._row = last.float().cpu(), 0
            return out
        return call

    def _emit(self, req, emit):
        def forced(token, now=None):
            row = self._rows[self._row]
            self._row += 1
            i = len(req.output)
            tok = self.force[req.rid][i]
            top2 = row.topk(2)
            self.steps.append((req.rid, i, float(top2.values[0]
                                                - top2.values[1]),
                               int(top2.indices[0]), tok,
                               float(top2.values[0] - row[tok])))
            return emit(tok, now)
        return forced

    def restore(self) -> None:
        """Undo the wrapping and drop every reference to the engine and
        its requests (an engine holding a wrapper of itself is a cycle
        that keeps its parameters and pools until the collector runs)."""
        self.mod.prefill_batched = self._prefill
        del self.eng._decode
        if self.force is not None:
            for r in self.reqs:
                del r.emit
        self.eng = self.reqs = self._decode = None


def _moe_drops(torch, run) -> list:
    """The share of routed (token, k) assignments that capacity dropped
    in each MoE layer during ``run()``: ``apply_moe`` wrapped to route
    its input a second time and count."""
    from repro_torch.models import transformer
    from repro_torch.models.moe import dropped_share
    inner, shares = transformer.apply_moe, []

    def counted(cfg_, p, x, *a, **kw):
        shares.append(dropped_share(cfg_, p["router"], x))
        return inner(cfg_, p, x, *a, **kw)
    transformer.apply_moe = counted
    try:
        with torch.no_grad():
            run()
    finally:
        transformer.apply_moe = inner
    return shares


def phase_mixtral_serve(torch, cfg, card: str) -> dict:
    """mixtral-8x7b in bf16 (random weights from a seed) at full width
    through ``ServingEngine`` at the serve phase's geometry, as deep as
    the printed arithmetic lets 90% of the card hold it. Returns the
    kernels' launch counts of the measured run."""
    from repro_torch.models import init_params, prefill_batched
    from repro_torch.serving import Request, ServingEngine
    t_phase = time.perf_counter()
    _release(torch)
    big = _requests(Request, cfg, 8, seed=0)
    B = 1 << (len(big) - 1).bit_length()
    S = 1 << max(3, (max(len(r.prompt) for r in big) - 1).bit_length())

    def engine_prefill(c):
        p = init_params(c, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
        eng = ServingEngine(c, p, device="cuda", **GEOMETRY)
        tokens = torch.ones((B, S), dtype=torch.int32, device="cuda")
        plens = torch.full((B,), S, dtype=torch.int32, device="cuda")
        # the engine (its pool) lives as long as the step
        return p, lambda eng=eng: prefill_batched(c, p, tokens, plens)
    layers_n, p1, p0 = fit_depth(
        torch, cfg, "mixtral_serve", engine_prefill,
        f"P plus the pool ({GEOMETRY['num_blocks']} blocks of "
        f"{GEOMETRY['block_size']}) and the prefill of B={B}, S={S} "
        f"(kernel path)")
    deep = dataclasses.replace(cfg, num_layers=layers_n)
    t0 = time.perf_counter()
    params = init_params(deep, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"mixtral_serve: {layers_n} of {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.experts_per_token}, window {cfg.sliding_window}, "
        f"{deep.param_count() / 1e9:.2f} B params "
        f"({_param_bytes(params) / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    warm = ServingEngine(deep, params, device="cuda", **GEOMETRY)
    for r in _requests(Request, deep, 1, seed=99, plen=(128, 128),
                       max_new=2):
        warm.submit(r)
    warm.run_until_drained()
    del warm
    _release(torch)

    # (a) the measured run on the kernel path
    eng = ServingEngine(deep, params, device="cuda", **GEOMETRY)
    reqs = _requests(Request, deep, 8, seed=0)
    record = _Steps(eng, reqs)
    try:
        with _attention_calls() as calls:
            run = _drain(torch, deep, eng, reqs, "mixtral_serve")
    finally:
        record.restore()
    windows = [c[3] for c in calls]
    s, launches, done = run["stats"], run["launches"], run["done"]
    want = layers_n * s.prefill_calls
    assert launches["flash_attention"] == want > 0, \
        f"flash_attention launched {launches['flash_attention']} times, " \
        f"expected {layers_n} x {s.prefill_calls} prefill calls"
    assert launches["flash_attention/sm90"] == want, \
        f"{launches['flash_attention/sm90']} of {want} prefill attention " \
        f"launches went to the sm90 kernel"
    assert set(windows) == {cfg.sliding_window} and len(windows) == want, \
        f"flash windows {sorted(set(windows))} over {len(windows)} calls"
    assert launches["flash_attention_bwd"] == launches["wkv6"] == 0
    log(f"mixtral_serve: flash_attention launches "
        f"{launches['flash_attention']} = {layers_n} layers x "
        f"{s.prefill_calls} prefill calls, "
        f"{launches['flash_attention/sm90']} of them sm90, every one at "
        f"window {cfg.sliding_window}")
    outs = {r.rid: list(done[r.rid].output) for r in reqs}
    kernel_first = record.first

    # (b) where the time goes and how much capacity dropped, on (a)'s
    # first prefill and first decode step
    # (the engine's pools hold every request's context: no block was
    # reused, so the first decode step's inputs read what they read then)
    assert s.preempted == 0
    p_args = kernel_first["prefill"][0]
    d_args = kernel_first["decode"][0]
    Bp, Sp = p_args[2].shape
    prefill = _moe_profile(
        torch, f"mixtral prefill B={Bp} S={Sp}",
        lambda: prefill_batched(deep, params, p_args[2], p_args[3]), deep,
        min(1024, Bp * Sp))
    decode = _moe_profile(torch, f"mixtral decode step B={d_args[0].shape[0]}",
                          lambda: eng._decode(*d_args), deep,
                          d_args[0].shape[0])
    drops = {"prefill": _moe_drops(torch, lambda: prefill_batched(
        deep, params, p_args[2], p_args[3])),
        "decode": _moe_drops(torch, lambda: eng._decode(*d_args))}
    for name, shares in drops.items():
        assert len(shares) == layers_n
        log(f"mixtral_serve: {name}: assignments dropped by capacity, "
            f"mean over the {layers_n} layers {statistics.mean(shares):.4f}"
            f", max {max(shares):.4f}, first layer {shares[0]:.4f}")
    del eng
    _release(torch)

    # (c) the same engine on the plain attention path, fed (a)'s tokens
    with _attention_calls(plain=True):
        reset_counts()
        plain_eng = ServingEngine(deep, params, device="cuda", **GEOMETRY)
        preqs = _requests(Request, deep, 8, seed=0)
        for r in preqs:
            plain_eng.submit(r)
        forced = _Steps(plain_eng, preqs, force=outs)
        try:
            plain_eng.run_until_drained()
        finally:
            forced.restore()
        assert read_counts()["flash_attention"] == 0
    assert plain_eng.stats.leaked_blocks == 0
    assert plain_eng.stats.prefill_calls == s.prefill_calls and \
        plain_eng.stats.decode_steps == s.decode_steps, "admissions differ"
    n = len(reqs)
    d_prefill = float((kernel_first["prefill"][1][:n]
                       - forced.first["prefill"][1][:n]).abs().max())
    d_decode = float((kernel_first["decode"][1][:n]
                      - forced.first["decode"][1][:n]).abs().max())
    limit = 4 * max(d_prefill, d_decode)
    steps = forced.steps
    flips = sum(tok != top for _, _, _, top, tok, _ in steps)
    mismatched = [(rid, i) for rid, i, _, top, tok, behind in steps
                  if tok != top and behind > limit]
    log(f"mixtral_serve: kernel path against the plain attention path, "
        f"same engine, same admissions, {len(steps)} tokens: max |logit "
        f"diff| prefill {d_prefill:.3g} first decode step {d_decode:.3g}, "
        f"near-tie limit {limit:.3g}; min top-2 gap "
        f"{min(x[2] for x in steps):.3g}; {flips} tokens differ from the "
        f"plain path's argmax, mismatched (request, step) {mismatched}")
    assert len(steps) == sum(len(o) for o in outs.values())
    assert not mismatched, f"kernel path != plain path at {mismatched}"
    del plain_eng
    _release(torch)

    log(f"mixtral_serve summary: {layers_n} layers, "
        f"{run['tok_s']:.1f} tok/s, ttft p50 "
        f"{run['ttft_p50'] * 1e3:.1f} ms, decode median "
        f"{run['decode_ms']:.2f} ms, device busy prefill "
        f"{prefill['busy_ms'] / prefill['wall_ms']:.1%} decode "
        f"{decode['busy_ms'] / decode['wall_ms']:.1%}, peak "
        f"{run['peak'] / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    del params, record, forced, kernel_first, p_args, d_args
    log(f"mixtral_serve: {_release(torch):.3f} GiB left allocated")
    return launches


def _host(leaves) -> list:
    return [t.detach().cpu() for t in leaves]


def _same_host(torch, got, host) -> bool:
    g = _train_leaves(got)
    return len(g) == len(host) and all(
        torch.equal(a, h.to(a.device)) for a, h in zip(g, host))


#: the plan path's depth search starts at the deepest L with PLAN_START
#: x P(L) under 90% of the card: folded onto one card, the K=4 plans'
#: summed per-PE peaks and the returned clones came to 7.5 P (mixtral, 3
#: layers) and 8.2 P (deepseek-v2-lite, 8 layers)
PLAN_START = 7


def _plan_cell(torch, cfg, label: str, batch: dict, L: int, lr: float,
               card: str, t_phase: float) -> None:
    """(b) of the training phases that run a plan at full width: the SGD
    step (``conformance.make_train_step``) at ``L`` layers traced,
    partitioned at K=4 under half the card per PE, verified and executed
    with its PEs folded onto the card. Folded onto one card, each PE
    captures its segments into its own graph pool, which keeps that PE's
    peak: the card holds the sum of the plan's peaks, and beside it the
    clones a call returns (new parameters and grads, 2P). Where that is
    over 90% of the card, a shallower depth (printed), down to 1. Gates: one
    flash forward and one backward node a layer, one sort and cumsum a
    MoE layer, no ``select_backward``, no whole-stack op but the
    restacks, product FLOPs equal to the config's count, async = sync
    bit for bit, every leaf within TRAIN_GATE of the eager step."""
    from repro_torch import api
    from repro_torch.conformance import make_train_step
    from repro_torch.core.graph import RESIDUAL
    from repro_torch.models import init_params
    B, S = (batch["targets"].shape[0], batch["targets"].shape[1])
    total = torch.cuda.get_device_properties(0).total_memory
    fit, gb, k = 0.9 * total, 1e9, 4
    while True:
        mid = dataclasses.replace(cfg, num_layers=L)
        params = init_params(mid, torch.Generator(device="cuda")
                             .manual_seed(3), "cuda")
        step = make_train_step(mid, lr, return_grads=True)
        t0 = time.perf_counter()
        traced, gm = _trace_aten(step, params, batch)
        trace_s = time.perf_counter() - t0
        meta = {"arch": cfg.name, "layers": L, "static_argnums": [0]}
        t0 = time.perf_counter()
        plan = api.partition(traced, devices=k, memory=total / 2, meta=meta)
        part_s = time.perf_counter() - t0
        pbytes = _param_bytes(params)
        need = float(sum(plan.peak_mem)) + 2 * pbytes
        log(f"{label} plan: depth arithmetic at {L} layers: the "
            f"K={k} plan's peaks [" + ", ".join(
                f"{p / gb:.2f}" for p in plan.peak_mem) + f"] GB sum to "
            f"{float(sum(plan.peak_mem)) / gb:.2f} GB, plus the returned "
            f"clones 2P = {2 * pbytes / gb:.2f} GB: {need / gb:.2f} GB "
            f"against 90% of the card, {fit / gb:.2f} GB: "
            f"{'fits' if need <= fit else 'does not fit'}")
        if need <= fit or L == 1:
            break
        del plan, traced, gm, params, step
        _release(torch)
        # need grows by about a layer's share a layer, on top of a fixed
        # part: L x fit / need is at or above the deepest depth that fits
        L = max(1, min(L - 1, int(L * fit / need)))
    g = traced.graph
    names = [n.split(".")[0] for n in g.names]
    dot, want_dot = float(g.op_dot_flops.sum()), \
        train_dot_flops(mid, B, S)
    whole, stacked = _whole_stack_ops(torch, gm, params)
    del gm
    log(f"{label} plan: traced the {L}-layer step in {trace_s:.2f} "
        f"s: {g.n} nodes, {names.count('flash_attention')} flash forward "
        f"and {names.count('flash_attention_bwd')} backward nodes, "
        f"{names.count('sort')} sort and {names.count('cumsum')} cumsum "
        f"(the routing), {names.count('bmm')} bmm, "
        f"{names.count('select_backward')} select_backward, {len(whole)} "
        f"ops of a stacked leaf's shape ({sorted(set(whole))}, "
        f"{len(stacked)} stacked leaves), RESIDUAL "
        f"{float(g.mem[g.ntype == RESIDUAL].sum()) / 2**30:.3f} GiB; "
        f"product FLOPs {dot:.6g} (from the config {want_dot:.6g})")
    assert names.count("flash_attention") == L and \
        names.count("flash_attention_bwd") == L
    n_moe = sum(kind.endswith("moe") for kind in list(mid.prelude)
                + list(mid.block_pattern) * mid.num_periods)
    assert names.count("sort") == names.count("cumsum") == n_moe
    assert "select_backward" not in names
    assert whole == ["stack"] * len(stacked), \
        f"whole-stack nodes other than the restacks: {whole}"
    assert dot == want_dot, f"product FLOPs {dot} != {want_dot}"
    a = plan.assignment
    assert a.shape == (g.n,) and a.min() >= 0 and a.max() < k
    rep = plan.verify(strict=True)
    c = rep.counts()
    log(f"{label} plan: K={k} under {total / 2 / 2**30:.3f} GiB per "
        f"PE: partition {part_s:.2f} s, feasible={plan.feasible}, "
        f"predicted makespan {plan.makespan * 1e3:.3f} ms, peaks [" +
        ", ".join(f"{p / 2**30:.3f}" for p in plan.peak_mem) +
        f"] GiB; verified {c['error']}E/{c['warn']}W/{c['info']}I")

    # the eager step at this depth, kept on the host
    out = step(params, batch)
    want_host = _host(_train_leaves(out))
    del out
    eager_ms = _wall_ms(torch, lambda: step(params, batch), n=3)
    _release(torch)
    fold = [0] * k

    def run(mode):
        return plan.execute(params, batch, device_map=fold, mode=mode,
                            static_argnums=(0,))
    torch.cuda.reset_peak_memory_stats()
    first = run("sync")
    first_peak = torch.cuda.max_memory_allocated()
    st = plan._compiled_runtime[1].stats
    bit = _hold_train(torch, f"{label} K={k} plan", first, want_host)
    first_host = _host(_train_leaves(first))
    del first, want_host
    same = all(_same_host(torch, run(mode), first_host)
               for mode in ("async", "sync"))
    log(f"{label} plan: {st.num_segments} segments "
        f"{st.segments_per_device} per PE, capture "
        f"{st.compile_seconds:.2f} s; async and sync bit-equal to the "
        f"first call: {same}")
    assert same, f"{label} plan: sync and async dispatch disagree"
    assert st.graph_replays == st.num_segments and st.eager_segments == 0, \
        f"{st.graph_replays} replays, {st.eager_segments} eager segments"
    del first_host
    ms = {"async": _wall_ms(torch, lambda: run("async"), n=3),
          "sync": _wall_ms(torch, lambda: run("sync"), n=3)}
    gib = 2 ** 30
    log(f"{label} plan summary ({L} layers, K={k} folded onto the "
        f"card): {g.n} nodes, partition {part_s:.2f} s, predicted makespan "
        f"{plan.makespan * 1e3:.3f} ms; median wall async {ms['async']:.2f} "
        f"ms, sync {ms['sync']:.2f} ms, eager {eager_ms:.2f} ms; logical "
        f"peak per PE [" + ", ".join(f"{x / gib:.3f}"
                                     for x in st.peak_live_bytes)
        + "] GiB, plan [" + ", ".join(f"{x / gib:.3f}"
                                      for x in plan.peak_mem)
        + f"]; max_memory_allocated first call {first_peak / gib:.3f} GiB;"
        f" bit-equal to eager {bit}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    del plan, traced, params, step
    _release(torch)


def _hold_moe_init(torch, label: str, cfg, params, batch: dict) -> None:
    """An MoE config's loss at init, without a gradient: its cross
    entropy within 2 of ln V, and the router term's aux within [K/2, E]
    a MoE layer. aux is E x sum_e (share of the assignments to e) x
    (mean probability of e) a layer: K when balanced, more when the
    routing is correlated, at most E."""
    from repro_torch.models import loss_fn
    n_moe = sum(k.endswith("moe") for k in list(cfg.prelude)
                + list(cfg.block_pattern) * cfg.num_periods)
    with torch.no_grad():
        _, parts = loss_fn(cfg, params, batch)
    ce, aux = float(parts["ce"]), float(parts["aux"])
    K, E = cfg.moe.experts_per_token, cfg.moe.num_experts
    log(f"{label}: at init ce {ce:.4f} (ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.4f}), aux {aux:.4f} over {n_moe} MoE "
        f"layers ({aux / n_moe:.4f} a layer; K = {K}, E = {E})")
    assert math.isfinite(aux) and abs(ce - math.log(cfg.vocab_size)) < 2, \
        f"{label}: ce {ce} far from ln V at init"
    assert K / 2 <= aux / n_moe <= E, \
        f"{label}: aux {aux / n_moe} a layer outside [K/2, E]"


def phase_moe_train(torch, cfg, card: str, label: str,
                    variant: str) -> dict:
    """An MoE config's SGD step at full width (bf16, random weights from
    a seed, B=1, S=2048, lr 1e-3, the loss with its router term): (a)
    eager, in place, as deep as the printed arithmetic lets 90% of the
    card hold it: L flash forward and L backward launches, all of the
    kernel ``variant`` and at the config's attention head dim (for MLA
    q and k at nope + rope, v at its own width); (b) the step traced at
    the plan
    depth (its own printed arithmetic: the runtime keeps new parameters
    and grads as outputs and returns clones of them; the search starts
    at the deepest L with PLAN_START x P(L) under 90% of the card),
    partitioned at K=4 under half the card per PE, verified, executed
    with its PEs folded onto the card: async = sync bit for bit, every
    leaf within TRAIN_GATE of the eager step. Returns the eager step's
    launch counts."""
    from repro_torch.conformance import make_train_step
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    mla = bool(cfg.kv_lora_rank)
    hd = cfg.qk_nope_dim + cfg.qk_rope_dim if mla else cfg.head_dim
    vd = cfg.v_head_dim if mla else hd
    _release(torch)
    B, S, lr = TRAIN["batch"], TRAIN["seq"], TRAIN["lr"]
    total = torch.cuda.get_device_properties(0).total_memory
    batch = _train_batch(torch, cfg, seed=2)
    group = min(1024, B * S)

    # (a) the eager step, in place
    def sgd_step(c):
        p = init_params(c, torch.Generator(device="cuda").manual_seed(1),
                        "cuda")
        st = make_train_step(c, lr, in_place=True)
        return p, lambda: st(p, batch)
    layers_n, p1, p0 = fit_depth(
        torch, cfg, label, sgd_step,
        "2P (parameters and grads; the update in place)")
    deep = dataclasses.replace(cfg, num_layers=layers_n)
    params = init_params(deep, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    _hold_moe_init(torch, label, deep, params, batch)
    window = None if mla else cfg.sliding_window
    launches = _eager_sgd(
        torch, deep, label, params, batch, lr, card,
        {**_flash_want(layers_n, variant), "wkv6": 0},
        calls=[(hd, vd, True, window)] * layers_n, near_ln_v=False,
        moe_group=group)["launches"]
    del params
    _release(torch)

    # (b) the plan path. Folded onto one card, each PE captures its
    # segments into its own graph pool, which keeps that PE's peak: the
    # card holds the sum of the plan's peaks, and beside it the clones a
    # call returns (new parameters and grads, 2P). The depth is the
    # deepest from 5 P(L) <= 90% of the card down whose plan fits so.
    fit = 0.9 * total
    L = max([n for n in range(1, layers_n + 1)
             if PLAN_START * (p0 + n * p1) <= fit] or [1])
    _plan_cell(torch, cfg, label, batch, L, lr, card, t_phase)
    return launches


# ---------------------------------------------------------------------------
# the head dims off 64 and 128 (MLA's 192, gemma3's 256, hubert's 80)
# and the other GQA groups
# ---------------------------------------------------------------------------
#: the wide head dims' shapes on this slice's main paths, in bf16:
#: (label, B, H, KV, S, q/k head dim, v width, window, causal, backward).
#: v is read at its own width, as ``apply_mla`` passes it; the sm90
#: kernels take it so, the fma kernels zero-pad it (and dO) inside their
#: wrappers. gemma3-1b's 22 local layers run at window 1024 and its 4
#: global ones at none: a case each (at S = 1024 the window does not
#: bind; at 2048 the global layers see 1.9x the pairs). hubert-xlarge is
#: an encoder: every key visible, hd 80 (five 16-column boxes), its
#: encoder_logits at B=8 and its training step at B=2, S = 4096.
WIDE_CASES = [
    ("deepseek train", 1, 16, 16, 2048, 192, 128, None, True, True),
    ("gemma3 prefill", 8, 4, 1, 1024, 256, 256, 1024, True, False),
    ("gemma3 prefill global", 8, 4, 1, 1024, 256, 256, None, True, False),
    ("gemma3 train", 1, 4, 1, 2048, 256, 256, 1024, True, True),
    ("gemma3 train global", 1, 4, 1, 2048, 256, 256, None, True, True),
    ("hubert encoder", 8, 16, 16, 4096, 80, 80, None, False, False),
    ("hubert train", 2, 16, 16, 4096, 80, 80, None, False, True),
]
#: calls of the sm90 kernels captured in one CUDA graph to time them at
#: WIDE_CASES (see :func:`graphed`)
GRAPH_CALLS = 20
#: the sm90 forward at the shapes of the configs whose GQA group is not
#: 4: the prefills of qwen2.5-14b (40 / 8 heads, 5), starcoder2-7b (36 /
#: 4, 9) and internvl2-1b (14 / 2 heads of 64, 7), and internvl2-1b's
#: training step (B=2, S = 4096; its backward is a BWD_CASES row)
GROUP_CASES = [
    ("qwen2.5-14b prefill", (8, 40, 8, 1024, 128, True, None, "bfloat16")),
    ("starcoder2-7b prefill", (8, 36, 4, 1024, 128, True, None,
                               "bfloat16")),
    ("internvl2-1b prefill", (8, 14, 2, 1024, 64, True, None, "bfloat16")),
    ("internvl2-1b train", (2, 14, 2, 4096, 64, True, None, "bfloat16")),
]


def _sdpa(torch, q, k, v, window, causal: bool):
    """One SDPA call, PyTorch's own choice of backend, on (B, H, S, hd)
    ``q``, ``k`` and ``v`` (v at its own width, KV heads already
    repeated), causal or with every key visible; a window (causal only)
    goes in as a boolean mask. A yardstick: the port never calls it."""
    import torch.nn.functional as F
    kw = {"is_causal": causal}
    if window:
        assert causal, "a window is taken with the causal mask only"
        i = torch.arange(q.shape[2], device=q.device)
        kw = {"attn_mask": (i[None, :] <= i[:, None])
              & (i[None, :] > i[:, None] - window)}
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def top_kernel(torch, fn) -> str:
    """The device kernel that takes the most time in a call of ``fn``
    (torch.profiler, as :func:`kernel_split` records): which library
    kernel a call was dispatched to."""
    evs = _device_events(torch, fn, SPLIT_CALLS)
    if not evs:
        return "not recorded"
    return max(evs, key=lambda e: e.self_device_time_total).key[:100]


def _wide_ptxas(report: dict, kernels, hd: int, vd: int) -> dict:
    """The ptxas lines of the sm90 kernels instantiated at (hd, vd):
    {kernel: "Used ... registers ...; ... spill ..."}."""
    tag = f"ILi{hd}ELi{vd}E"
    return {k: used for k, used in report.items()
            for name in kernels if f"{name}{tag}" in k}


def phase_wide_head_kernels(torch, ops, ref, build) -> list:
    """The sm90 flash kernels, forward and backward, at the head dims
    off 64 and 128 that main paths run (WIDE_CASES: (192, 128) with v at
    its own width, (256, 256), and hubert's (80, 80) with every key
    visible), against their plain versions (TOL and
    TIGHT forward, BWD_GATE backward), repeated calls bit-equal; each
    timed in turns with the fma kernel it replaces (``earlier_ms``; v
    and dO zero-padded inside its wrapper) and SDPA at the same shape (v
    unpadded), and one call of its plain version, beside the bound of
    the work these inputs need (v at its own width), and faster than the
    fma kernel.
    The sm90 kernels are timed from a CUDA graph of GRAPH_CALLS calls
    (:func:`graphed`), since eager calls back to back time their
    wrapper's host work; the eager figure is kept as ``eager_ms``.
    Then the sm90 forward held at GROUP_CASES. Returns the records;
    their launches are filled in by the main paths."""
    counts = ops.flash_attention.variant_launches
    bcounts = ops.flash_attention_bwd.variant_launches
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    report = ptxas_report(build, ops, "flash_attention")
    records = []
    for i, (label, B, H, KV, S, hd, vd, window, causal, backward) in \
            enumerate(WIDE_CASES):
        g = torch.Generator(device="cuda").manual_seed(500 + i)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").bfloat16()
        q, k, v = rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, vd)
        kw = dict(causal=causal, window=window)
        shape = (B, H, KV, S, hd, vd, causal, window, "bfloat16")
        assert ops.select_variant(q.dtype, hd, vd) == "sm90"
        before = dict(counts)
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        again = ops.flash_attention(q, k, v, **kw)
        assert counts["sm90"] == before["sm90"] + 2 and \
            counts["fma"] == before["fma"], f"{label}: not the sm90 kernel"
        rep = torch.equal(out, again)
        del again
        log(f"wide_head_kernels {label}: sm90 forward out "
            f"{tuple(out.shape)}, repeated call bit-equal {rep}")
        assert rep and out.shape == (B, S, H, vd), \
            f"{label}: forward not repeatable"
        err, tight = _hold(torch, ref, f"{label} {shape} [sm90]", out, q,
                           k, v, "bfloat16", **kw)
        fma_out, _ = ops.run_variant("fma", q, k, v, **kw)
        _hold(torch, ref, f"{label} {shape} [fma, v padded inside]",
              fma_out, q, k, v, "bfloat16", **kw)
        del fma_out
        rep_q = q.transpose(1, 2)
        rep_k = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        rep_v = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        sdpa = _sdpa(torch, rep_q, rep_k, rep_v, window, causal)
        backend = top_kernel(torch, sdpa)
        lib_err = float((sdpa().transpose(1, 2).float()
                         - out.float()).abs().max())
        sm90 = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
        graph = graphed(torch, sm90, GRAPH_CALLS)
        fns = {"sm90": graph.replay, "sm90 eager": sm90,
               "fma": lambda: ops.run_variant("fma", q, k, v, **kw),
               "sdpa": sdpa}
        pairs = visible_pairs(S, S, causal, window)
        flops = 2 * B * H * pairs * (hd + vd)
        nbytes = 2 * (B * S * (H + KV) * hd + B * S * (KV + H) * vd)
        ms = timed_turns(torch, fns, reps={"sm90": 1, "sm90 eager": 20,
                                           "fma": 3})
        ms["sm90"] /= GRAPH_CALLS
        ms["plain"] = once_ms(
            torch, lambda: ref.flash_attention_ref(q, k, v, **kw))
        del graph
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        regs = _wide_ptxas(report, ("flash_fwd_sm90",), hd, vd)
        log(f"timing flash_attention at {label} {shape}, in turns: sm90 "
            f"{ms['sm90']:.4f} ms ({flops / ms['sm90'] / 1e9:.2f} TFLOP/s "
            f"of the work needed; {GRAPH_CALLS} calls replayed from a CUDA "
            f"graph; eager through the op, back to back "
            f"{ms['sm90 eager']:.4f} ms), fma {ms['fma']:.4f} ms, plain "
            f"{ms['plain']:.4f} ms, sdpa (top kernel {backend}; v at its "
            f"width {vd}) {ms['sdpa']:.4f} ms (max |sdpa - sm90| "
            f"{lib_err:.3g}); bound {max(t_ops, t_bytes):.4f} ms "
            f"({flops / 1e9:.2f} GFLOP on {B * H * pairs / 1e6:.2f} M "
            f"visible (pair, head)s, {nbytes / 2**20:.1f} MiB); ptxas "
            f"{regs}")
        assert ms["sm90"] < ms["fma"], \
            f"{label}: the sm90 forward is not faster than fma"
        records.append({
            "name": "flash_attention", "variant": "sm90", "case": label,
            "shape": list(shape), "route": "cuda",
            "source": src + "flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
            "launches": None, "max_abs_err": err, "tight_gate_ratio": tight,
            "ms": ms["sm90"], "plain_ms": ms["plain"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": ms["sdpa"], "library_kernel": backend,
            "earlier_variant": "fma", "earlier_ms": ms["fma"],
            "eager_ms": ms["sm90 eager"], "ptxas": regs})
        if backward:
            do = rnd(B, S, H, vd)
            want = ref.flash_attention_bwd_ref(do.float(), q.float(),
                                               k.float(), v.float(), **kw)
            assert ops.select_bwd_variant(q.dtype, hd, vd) == "sm90"
            before = dict(bcounts)
            got = ops.flash_attention_bwd(do, q, k, v, out, lse, **kw)
            again = ops.flash_attention_bwd(do, q, k, v, out, lse, **kw)
            assert bcounts["sm90"] == before["sm90"] + 2 and \
                bcounts["fma"] == before["fma"]
            assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
            ratio, berr = _hold_bwd(torch, f"{label} {shape} [sm90]", got,
                                    again, want, "bfloat16")
            got = ops.run_bwd_variant("fma", do, q, k, v, out, lse, **kw)
            again = ops.run_bwd_variant("fma", do, q, k, v, out, lse, **kw)
            _hold_bwd(torch, f"{label} {shape} [fma, v and dO padded "
                      f"inside]", got, again, want, "bfloat16")
            del want, again, got
            qg, kg, vg = (t.detach().requires_grad_()
                          for t in (rep_q, rep_k, rep_v))
            lib_out = _sdpa(torch, qg, kg, vg, window, causal)()
            dot = do.transpose(1, 2)

            def sdpa_bwd():
                return torch.autograd.grad(lib_out, (qg, kg, vg), dot,
                                           retain_graph=True)
            bbackend = top_kernel(torch, sdpa_bwd)

            def bwd90():
                return ops.flash_attention_bwd(do, q, k, v, out, lse, **kw)
            graph = graphed(torch, bwd90, GRAPH_CALLS)
            bms = timed_turns(torch, {
                "sm90": graph.replay, "sm90 eager": bwd90,
                "fma": lambda: ops.run_bwd_variant("fma", do, q, k, v, out,
                                                   lse, **kw),
                "sdpa": sdpa_bwd,
            }, reps={"sm90": 1, "sm90 eager": 10, "fma": 2})
            bms["sm90"] /= GRAPH_CALLS
            bms["plain"] = once_ms(
                torch, lambda: ref.flash_attention_bwd_ref(do, q, k, v,
                                                           **kw))
            del graph
            bflops = 2 * B * H * pairs * (2 * hd + 2 * vd)
            bbytes = 2 * nbytes + 2 * B * S * H * vd
            b_ops = bflops / PEAK_FLOPS["bfloat16"] * 1e3
            b_bytes = bbytes / PEAK_BYTES * 1e3
            bregs = _wide_ptxas(report, ("bwd_dkdv_sm90", "bwd_dq_sm90"),
                                hd, vd)
            log(f"timing flash_attention_bwd at {label} {shape}, in turns: "
                f"sm90 {bms['sm90']:.4f} ms ({bflops / bms['sm90'] / 1e9:.2f}"
                f" TFLOP/s of the work needed; from a CUDA graph; eager "
                f"{bms['sm90 eager']:.4f} ms), fma {bms['fma']:.4f} ms, plain "
                f"{bms['plain']:.4f} ms, sdpa backward (top kernel "
                f"{bbackend}; v at {vd}) {bms['sdpa']:.4f} ms; bound "
                f"{max(b_ops, b_bytes):.4f} ms ({bflops / 1e9:.2f} GFLOP of "
                f"the four backward products, {bbytes / 2**20:.1f} MiB); "
                f"ptxas {bregs}")
            assert bms["sm90"] < bms["fma"], \
                f"{label}: the sm90 backward is not faster than fma"
            records.append({
                "name": "flash_attention_bwd", "variant": "sm90",
                "case": label, "shape": list(shape), "route": "cuda",
                "source": src + "flash_attention_bwd_sm90.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
                "note": "the gradient of that kernel; the reference has no "
                        "backward kernel",
                "launches": None, "max_abs_err": berr, "gate_ratio": ratio,
                "ms": bms["sm90"], "plain_ms": bms["plain"],
                "bound_ms": max(b_ops, b_bytes),
                "bound_by": "operations" if b_ops >= b_bytes else "bytes",
                "library_ms": bms["sdpa"], "library_kernel": bbackend,
                "earlier_variant": "fma", "earlier_ms": bms["fma"],
                "eager_ms": bms["sm90 eager"], "ptxas": bregs})
            del do, qg, kg, vg, lib_out, dot
        del q, k, v, out, lse, rep_q, rep_k, rep_v
        _release(torch)
    for i, (label, case) in enumerate(GROUP_CASES):
        q, k, v = _inputs(torch, case, seed=600 + i)
        before = counts["sm90"]
        out = ops.flash_attention(q, k, v, causal=True)
        assert counts["sm90"] == before + 1, f"{label}: not sm90"
        _hold(torch, ref, f"{label} {case} [sm90, GQA group "
              f"{case[1] // case[2]}]", out, q, k, v, "bfloat16",
              causal=True)
        del q, k, v, out
        _release(torch)
    return records


# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b: MLA + MoE served and trained at full width
# ---------------------------------------------------------------------------
def _drain(torch, cfg, eng, reqs, label: str) -> dict:
    """Drain ``reqs`` through ``eng`` with the kernels' counts set to 0
    just before and read just after, under the obs spans: the run's
    numbers (tok/s, TTFT p50, prefill and decode ms, peak memory), 0
    leaked blocks and every request complete."""
    from repro_torch import obs
    for r in reqs:
        eng.submit(r)
    tracer = obs.get_tracer()
    tracer.drain()
    obs.enable(True)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        done = eng.run_until_drained()
        torch.cuda.synchronize()
    finally:
        obs.enable(False)
    wall = time.perf_counter() - t0
    launches = read_counts()
    spans = {}
    for ev in tracer.drain():
        if ev[0] == "X":
            spans.setdefault(ev[1], []).append(ev[6] / 1e3)   # ms
    s = eng.stats
    assert len(done) == len(reqs), f"{label}: {len(done)} of {len(reqs)}"
    assert all(len(r.output) == r.max_new_tokens for r in done.values())
    assert all(0 <= t < cfg.vocab_size for r in done.values()
               for t in r.output), f"{label}: a token outside the vocab"
    assert s.leaked_blocks == 0, f"{label}: {s.leaked_blocks} leaked blocks"
    run = {"done": done, "wall": wall, "launches": launches, "stats": s,
           "tok_s": s.generated_tokens / wall,
           "ttft_p50": s.to_dict()["ttft_p50_s"],
           "prefill_ms": spans.get("serving/prefill_batch", []),
           "decode_ms": statistics.median(spans.get("serving/decode_step",
                                                    [float("nan")])),
           "peak": torch.cuda.max_memory_allocated()}
    log(f"{label}: {len(done)} requests, {s.prefill_tokens} prompt tokens "
        f"in {s.prefill_calls} prefill calls ("
        + ", ".join(f"{t:.1f}" for t in run["prefill_ms"]) + " ms), "
        f"{s.generated_tokens} generated in {wall:.3f} s -> "
        f"{run['tok_s']:.1f} tok/s; ttft p50 {run['ttft_p50']:.4f} s; "
        f"{s.decode_steps} decode steps, median {run['decode_ms']:.2f} ms; "
        f"{s.preempted} preemptions; peak {s.peak_blocks_in_use}/"
        f"{eng.allocator.capacity} blocks; max_memory_allocated "
        f"{run['peak'] / 2**30:.2f} GiB ({run['peak'] / 1e9:.2f} GB); "
        f"launches {launches}")
    return run


def _grow_seq(torch, caches, length: int):
    """Dense caches (prelude leaves (B, S, ...), stacked period leaves
    (P, B, S, ...)) zero-padded along the sequence to ``length``."""
    import torch.nn.functional as F
    from repro_torch.tree import tree_map_with_path

    def grow(path, c):
        axis = 2 if "periods" in path else 1
        pad = [0, 0] * (c.dim() - axis - 1) + [0, length - c.shape[axis]]
        return F.pad(c, pad)
    return tree_map_with_path(grow, caches)


def phase_deepseek_serve(torch, cfg, card: str) -> dict:
    """deepseek-v2-lite-16b in bf16 (random weights from a seed) at full
    width through ``ServingEngine`` at the serve phase's geometry, as
    deep as the printed arithmetic lets 90% of the card hold it (all 27
    layers): (a) the measured run: 0 leaked blocks, no flash launch (MLA
    with a cache attends in the absorbed form, as plain products); (b)
    the paged path against the dense one: the engine's first prefill
    logits equal ``prefill_batched`` on the same padded batch, and its
    first decode step's logits within 2^-7 of their scale of
    ``decode_step`` on that prefill's dense caches, which holds the 3-D
    latent and rope-key leaves through the pages; (c) a second drain of
    the same requests gives the same tokens; (d) a block-starved pool
    preempts at least once and leaks nothing. Device time by role and
    the share of routed assignments capacity dropped, on (a)'s first
    prefill and first decode step. Returns (a)'s launch counts."""
    from repro_torch.models import decode_step, init_params, prefill_batched
    from repro_torch.serving import Request, ServingEngine
    t_phase = time.perf_counter()
    _release(torch)
    big = _requests(Request, cfg, 8, seed=0)
    B = 1 << (len(big) - 1).bit_length()
    S = 1 << max(3, (max(len(r.prompt) for r in big) - 1).bit_length())

    def engine_prefill(c):
        p = init_params(c, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
        eng = ServingEngine(c, p, device="cuda", **GEOMETRY)
        tokens = torch.ones((B, S), dtype=torch.int32, device="cuda")
        plens = torch.full((B,), S, dtype=torch.int32, device="cuda")
        return p, lambda eng=eng: prefill_batched(c, p, tokens, plens)
    layers_n, _, _ = fit_depth(
        torch, cfg, "deepseek_serve", engine_prefill,
        f"P plus the pool ({GEOMETRY['num_blocks']} blocks of "
        f"{GEOMETRY['block_size']}) and the prefill of B={B}, S={S}")
    deep = dataclasses.replace(cfg, num_layers=layers_n)
    t0 = time.perf_counter()
    params = init_params(deep, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"deepseek_serve: {layers_n} of {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads, kv_lora_rank "
        f"{cfg.kv_lora_rank}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.experts_per_token} + {cfg.moe.num_shared_experts} "
        f"shared, {deep.param_count() / 1e9:.2f} B params "
        f"({_param_bytes(params) / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    warm = ServingEngine(deep, params, device="cuda", **GEOMETRY)
    for r in _requests(Request, deep, 1, seed=99, plen=(128, 128),
                       max_new=2):
        warm.submit(r)
    warm.run_until_drained()
    del warm
    _release(torch)

    # (a) the measured run
    eng = ServingEngine(deep, params, device="cuda", **GEOMETRY)
    reqs = _requests(Request, deep, 8, seed=0)
    record = _Steps(eng, reqs)
    try:
        run = _drain(torch, deep, eng, reqs, "deepseek_serve (a)")
    finally:
        record.restore()
    s = run["stats"]
    assert s.preempted == 0
    assert run["launches"]["flash_attention"] == 0 and \
        run["launches"]["flash_attention_bwd"] == 0, \
        "MLA with a cache attends in the latent space: no flash launch"
    first = record.first

    # (b) paged against dense, on (a)'s first prefill and decode step
    p_args, p_logits = first["prefill"]
    (bt, toks, lens), d_logits = first["decode"]
    n = len(reqs)
    logits, dense = prefill_batched(deep, params, p_args[2], p_args[3])
    same = torch.equal(logits[:, -1].float(), p_logits)
    dense = _grow_seq(torch, dense, bt.shape[1] * GEOMETRY["block_size"])
    want, _ = decode_step(deep, params, dense, toks, lens)
    want = want[:n, -1].float()
    diff = float((d_logits[:n] - want).abs().max())
    scale = float(want.abs().max())
    leaf = dense["periods"]["b0"]["mix"]
    log(f"deepseek_serve (b): the engine's first prefill logits equal "
        f"prefill_batched on the same padded batch {tuple(p_args[2].shape)}"
        f": {same}; its first decode step (B={toks.shape[0]}, {n} rows) "
        f"against decode_step on the prefill's dense caches (latent "
        f"{tuple(leaf['c_kv'].shape)}, rope key "
        f"{tuple(leaf['k_rope'].shape)}): max |diff| {diff:.3g}, "
        f"{diff / scale:.3g} of the logits' scale {scale:.3g} (gate 2^-7)")
    assert same, "deepseek_serve: the engine's prefill != prefill_batched"
    assert diff <= 2.0 ** -7 * scale, "deepseek_serve: paged != dense"
    del logits, dense, want, leaf

    # where the time goes, and what capacity dropped
    Bp, Sp = p_args[2].shape
    prefill = _moe_profile(
        torch, f"deepseek prefill B={Bp} S={Sp}",
        lambda: prefill_batched(deep, params, p_args[2], p_args[3]), deep,
        min(1024, Bp * Sp))
    decode = _moe_profile(torch, f"deepseek decode step B={bt.shape[0]}",
                          lambda: eng._decode(bt, toks, lens), deep,
                          bt.shape[0])
    drops = {"prefill": _moe_drops(torch, lambda: prefill_batched(
        deep, params, p_args[2], p_args[3])),
        "decode": _moe_drops(torch, lambda: eng._decode(bt, toks, lens))}
    n_moe = deep.num_periods
    for name, shares in drops.items():
        assert len(shares) == n_moe
        log(f"deepseek_serve: {name}: assignments dropped by capacity, "
            f"mean over the {n_moe} MoE layers "
            f"{statistics.mean(shares):.4f}, max {max(shares):.4f}, first "
            f"{shares[0]:.4f}")
    outs = {r.rid: list(run["done"][r.rid].output) for r in reqs}
    del eng, record, first, p_args, p_logits, bt, toks, lens, d_logits
    _release(torch)

    # (c) a second drain of the same requests
    eng = ServingEngine(deep, params, device="cuda", **GEOMETRY)
    again = _drain(torch, deep, eng, _requests(Request, deep, 8, seed=0),
                   "deepseek_serve (c)")
    same_tokens = all(list(again["done"][rid].output) == o
                      for rid, o in outs.items())
    log(f"deepseek_serve (c): a second drain gives the same tokens: "
        f"{same_tokens}")
    assert same_tokens, "deepseek_serve: two drains differ"
    del eng, again
    _release(torch)

    # (d) a block-starved pool
    eng = ServingEngine(deep, params, device="cuda", **STARVED)
    starved = _drain(torch, deep, eng, _requests(Request, deep, 8,
                                                 seed=STARVED_SEED),
                     "deepseek_serve (d)")
    pre = starved["stats"].preempted
    assert pre > 0, "deepseek_serve (d): the starved pool did not preempt"
    del eng, starved
    _release(torch)

    log(f"deepseek_serve summary: {layers_n} layers, {run['tok_s']:.1f} "
        f"tok/s, ttft p50 {run['ttft_p50'] * 1e3:.1f} ms, prefill "
        f"{prefill['wall_ms']:.2f} ms (busy "
        f"{prefill['busy_ms'] / prefill['wall_ms']:.1%}), decode median "
        f"{run['decode_ms']:.2f} ms (profiled step {decode['wall_ms']:.2f} "
        f"ms, busy {decode['busy_ms'] / decode['wall_ms']:.1%}), peak "
        f"{run['peak'] / 2**30:.2f} GiB; dropped: first prefill "
        f"{statistics.mean(drops['prefill']):.4f}, a decode step "
        f"{statistics.mean(drops['decode']):.4f}; {STARVED['num_blocks']}"
        f"-block pool: {pre} preemptions, 0 leaked; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    del params
    log(f"deepseek_serve: {_release(torch):.3f} GiB left allocated")
    return run["launches"]


# ---------------------------------------------------------------------------
# the dense configs: gemma3-1b (hd 256, sm90), qwen2.5-14b and starcoder2-7b
# ---------------------------------------------------------------------------
def _serve_cell(torch, cfg, label: str, variant: str, max_new: int,
                windows) -> dict:
    """``cfg`` served at full depth (bf16, random weights from a seed)
    at the serve phase's geometry: 8 requests of 128-1024 prompt tokens,
    ``max_new`` new each. Every prefill attention call launches the
    ``variant`` kernel at the config's head dim, L per prefill call, at
    the ``windows`` (per layer, in order) given."""
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServingEngine
    _release(torch)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"{label}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.param_count() / 1e9:.2f} B params "
        f"({_param_bytes(params) / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    warm = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    for r in _requests(Request, cfg, 1, seed=99, plen=(128, 128),
                       max_new=2):
        warm.submit(r)
    warm.run_until_drained()
    del warm
    _release(torch)
    eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    with _attention_calls() as calls:
        run = _drain(torch, cfg, eng, _requests(Request, cfg, 8, seed=0,
                                                max_new=max_new), label)
    L, s = cfg.num_layers, run["stats"]
    want = L * s.prefill_calls
    got = run["launches"]
    assert got["flash_attention"] == got[f"flash_attention/{variant}"] \
        == want > 0, f"{label}: launches {got}, want {want} {variant}"
    hd = cfg.head_dim
    assert calls == [(hd, hd, True, w) for w in windows] \
        * s.prefill_calls, \
        f"{label}: flash calls {sorted(set(map(str, calls)))} x {len(calls)}"
    log(f"{label}: {got['flash_attention']} flash launches = {L} layers x "
        f"{s.prefill_calls} prefill calls, all {variant} at hd "
        f"{cfg.head_dim} (windows {sorted(set(map(str, windows)))})")
    del eng, params
    _release(torch)
    return run


def phase_dense_configs(torch, card: str) -> dict:
    """The three dense configs at full width and depth, bf16, random
    weights from a seed: gemma3-1b served (every prefill flash launch sm90
    at hd 256, window 1024 on 22 of 26 layers) and trained (eager SGD in
    place, B=1, S=2048: 26 sm90 forward and 26 sm90 backward launches a
    step, at window 1024 on the same 22); qwen2.5-14b and starcoder2-7b
    served with a short drain, every prefill launch sm90. Returns
    gemma3's launches by WIDE_CASES record, {(kernel name, case label):
    launches}, split by window."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    gemma = get_config("gemma3-1b")
    kinds = list(gemma.prelude) + list(gemma.block_pattern) \
        * gemma.num_periods
    windows = [gemma.sliding_window if k.startswith("swa") else None
               for k in kinds]
    serve = _serve_cell(torch, gemma, "dense_configs gemma3-1b serve",
                        "sm90", 32, windows)
    # _serve_cell held the calls to ``windows``, one a layer a prefill call
    local = sum(w is not None for w in windows)
    calls = serve["stats"].prefill_calls
    split = {("flash_attention", "gemma3 prefill"): local * calls,
             ("flash_attention", "gemma3 prefill global"):
                 (len(windows) - local) * calls}

    # gemma3-1b's SGD step, all 26 layers
    lr = TRAIN["lr"]
    batch = _train_batch(torch, gemma, seed=4)
    params = init_params(gemma, torch.Generator(device="cuda")
                         .manual_seed(1), "cuda")
    L, hd = gemma.num_layers, gemma.head_dim
    # one forward call a layer, each launching the forward kernel once
    # and, in the backward pass, the backward kernel once
    step_ms = _eager_sgd(
        torch, gemma, "dense_configs gemma3-1b train", params, batch, lr,
        card, _flash_want(L), calls=[(hd, hd, True, w) for w in windows],
        reps=5)["step_ms"]
    for name in ("flash_attention", "flash_attention_bwd"):
        split[(name, "gemma3 train")] = local
        split[(name, "gemma3 train global")] = L - local
    log(f"dense_configs gemma3-1b train: {local} of {L} launches each way "
        f"at window {gemma.sliding_window}, {L - local} at none")
    del params, batch
    _release(torch)

    runs = {}
    for name in ("qwen2.5-14b", "starcoder2-7b"):
        cfg = get_config(name)
        runs[name] = _serve_cell(torch, cfg, f"dense_configs {name} serve",
                                 "sm90", 8, [None] * cfg.num_layers)
    log("dense_configs summary: " + "; ".join(
        f"{name} {r['tok_s']:.1f} tok/s, ttft p50 "
        f"{r['ttft_p50'] * 1e3:.1f} ms, decode median {r['decode_ms']:.2f} "
        f"ms, peak {r['peak'] / 2**30:.2f} GiB"
        for name, r in [("gemma3-1b", serve), *runs.items()])
        + f"; gemma3-1b train step {step_ms:.2f} ms; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return split


# ---------------------------------------------------------------------------
# Mamba's selective scan and jamba-v0.1-52b
# ---------------------------------------------------------------------------
#: the scan's shapes on jamba's main paths, at its d_inner and d_state:
#: (label, B, S, with h0, backward too, the factor on A). A at init
#: (-1 ... -16) times dt ~ 1 forgets within a few tokens; the training
#: case takes 0.02 A so that states and gradients carry over hundreds of
#: steps.
SSM_CASES = [("prefill", 8, 1024, False, False, 1.0),
             ("train", 1, 2048, False, True, 0.02),
             ("decode", 8, 1, True, False, 1.0)]
SSM_WIDTH = (8192, 16)
#: max |kernel - plain| over max |plain|, per output. Float32 throughout:
#: the kernels differ from the plain version in the order of the sums
#: (over the 16 states; for dBm and dCm over d_inner's 8192 channels) and
#: in __expf's last bits
SSM_GATE = {"forward": 1e-5, "backward": 3e-5}
#: the exponentials a second of the H100 SXM's special-function units: 16
#: a clock on each of 132 SMs at the 1.98 GHz boost clock
SFU_RATE = 16 * 132 * 1.98e9
SSM_SOURCE = "src/repro_torch/kernels/ssm/csrc/"
SSM_REPLACES = ("none: src/repro/models/ssm.py:47 (_ssm_scan_chunked, "
                "plain JAX; no Pallas kernel)")
#: jamba's serving and training depths, from the printed arithmetic: whole
#: periods of 8 whose parameters (serving) or parameters and grads
#: (training in place) fit 90% of the card
JAMBA = dict(serve_layers=16, train_layers=8, batch=8, prompt=1024,
             new=32)


def _ssm_inputs(torch, B, S, h0: bool, a_scale: float, seed: int):
    """(u, dt, Bm, Cm, A, h0): u, Bm, Cm, h0 ~ N(0, 1); dt the model's
    softplus of N(0, 0.5) around its bias; A = a_scale x -[1..N] a
    channel, as at init."""
    import torch.nn.functional as F
    di, N = SSM_WIDTH
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    dt = F.softplus(0.5 * rnd(B, S, di) + math.log(math.e - 1))
    A = -a_scale * torch.arange(1, N + 1, device="cuda",
                                dtype=torch.float32)[None].repeat(di, 1)
    return (rnd(B, S, di), dt, rnd(B, S, N), rnd(B, S, N), A,
            rnd(B, di, N) if h0 else None)


def _ssm_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _ssm_bytes(B, S, h0: bool, backward: bool) -> int:
    """Bytes the call must move, each input read once and each output
    written once (float32): forward u, dt in, y out, Bm, Cm, A, h0, h_last;
    backward u, dt, dy in, du, ddt out, Bm, Cm, dBm, dCm, A, dA, h0,
    dh_last, dh0."""
    di, N = SSM_WIDTH
    big, small, state = B * S * di, B * S * N, B * di * N
    if backward:
        return 4 * (5 * big + 4 * small + 2 * di * N
                    + (3 if h0 else 2) * state)
    return 4 * (3 * big + 2 * small + di * N + (2 if h0 else 1) * state)


def _ssm_ptxas(report: dict, variant: str, backward: bool) -> dict:
    """The ptxas lines of one variant's forward or backward kernels."""
    tag = {("reg", False): "ssm_fwd_reg", ("reg", True): "ssm_bwd_reg",
           ("lane", False): "ssm_fwd_kernel",
           ("lane", True): "ssm_bwd_kernel"}[(variant, backward)]
    return {k: v for k, v in report.items() if tag in k}


def _hold_ssm(torch, label: str, run, want, gate: float, names) -> tuple:
    """Two calls of ``run`` against ``want`` (the plain version's
    outputs): every output within ``gate`` of its largest magnitude,
    the calls bit-equal. Returns (max |got - want|, {name: rel err})."""
    got, again = run(), run()
    torch.cuda.synchronize()
    rep = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = {n: _ssm_err(a, b) for n, a, b in zip(names, got, want)}
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    log(f"ssm_kernels {label}: max |kernel - plain| {abs_err:.3g}; over max "
        f"|plain|: " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
        + f" (gate {gate}); repeated call bit-equal {rep}")
    assert rep, f"ssm_kernels {label}: not repeatable"
    assert max(errs.values()) <= gate, \
        f"ssm_kernels {label}: {errs} over the gate"
    return abs_err, errs


def _time_ssm(torch, label: str, calls: dict, eager, plain, nbytes: int,
              t_ops: float) -> dict:
    """Each kernel variant in ``calls`` replayed from a CUDA graph of
    GRAPH_CALLS calls and the op ``eager`` (back to back), timed in
    turns, then one call of the plain version; logs GB/s and the share
    of the bound (the bytes at 3.35 TB/s or ``t_ops``, the larger).
    Returns the ms a call and the bound."""
    graphs = {v: graphed(torch, fn, GRAPH_CALLS) for v, fn in calls.items()}
    ms = timed_turns(torch, {**{v: g.replay for v, g in graphs.items()},
                             "eager": eager},
                     reps={**dict.fromkeys(graphs, 1), "eager": 10})
    ms["plain"] = once_ms(torch, plain)
    for v in graphs:
        ms[v] /= GRAPH_CALLS
    del graphs
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_bytes, t_ops)
    log(f"timing {label}, in turns ({GRAPH_CALLS} calls replayed from a "
        f"CUDA graph): " + "; ".join(
            f"{v} {ms[v]:.4f} ms ({nbytes / ms[v] / 1e6:.1f} GB/s, "
            f"{bound / ms[v]:.1%} of the bound)" for v in calls)
        + f"; the op eager, back to back {ms['eager']:.4f} ms; plain "
        f"{ms['plain']:.4f} ms; library: none; bound {bound:.4f} ms (bytes "
        f"{nbytes / 2**20:.1f} MiB at 3.35 TB/s: {t_bytes:.4f} ms; "
        f"exponentials at the SFU's {SFU_RATE / 1e12:.2f} T/s: "
        f"{t_ops:.4f} ms)")
    return dict(ms, bound=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_ssm_kernels(torch, sops, sref, build) -> list:
    """Both selective-scan kernel pairs (``reg``, the main path's, and
    ``lane``, the first design, kept as the comparison) against their
    plain versions at SSM_CASES (d_inner 8192, N 16: jamba's prefill,
    training and decode shapes), under SSM_GATE, repeated calls
    bit-equal; each
    timed in turns from a CUDA graph of GRAPH_CALLS calls (and the op
    eager, back to back) beside one call of its plain version and the
    bound (the
    bytes at 3.35 TB/s or the exponentials at SFU_RATE, the larger); no
    PyTorch call computes the scan; registers and spills from ptxas.
    Returns the two records of the ``reg`` kernels (at the prefill shape
    forward, the training shape backward; ``lane`` as ``earlier_ms``);
    the main paths fill in their launches."""
    sops.load()
    report = ptxas_report(build, sops, "ssm")
    for kernel, used in report.items():
        log(f"ssm_kernels: ptxas {kernel}: {used}")
    di, N = SSM_WIDTH
    assert sops.select_variant(N) == "reg"
    counts = sops.selective_scan.variant_launches
    bcounts = sops.selective_scan_bwd.variant_launches
    cases, records = {}, []
    for i, (label, B, S, h0, backward, a_scale) in enumerate(SSM_CASES):
        u, dt, Bm, Cm, A, h = _ssm_inputs(torch, B, S, h0, a_scale,
                                          seed=700 + i)
        log(f"ssm_kernels {label}: B={B}, S={S}, d_inner {di}, N {N}, h0 "
            f"{h0}, A x {a_scale}; reg holds "
            f"{sops.fwd_states(B, di, N)} states a thread forward, 4 "
            f"backward")
        want = sref.selective_scan_ref(u, dt, Bm, Cm, A, h)
        before = dict(counts)
        y, h_last = sops.selective_scan(u, dt, Bm, Cm, A, h)
        assert counts["reg"] == before["reg"] + 1 and \
            counts["lane"] == before["lane"], f"{label}: not the reg kernel"
        held = {v: _hold_ssm(
            torch, f"{label} forward ({v})",
            lambda v=v: sops.run_variant(v, u, dt, Bm, Cm, A, h), want,
            SSM_GATE["forward"], ("y", "h_last")) for v in sops.VARIANTS}
        del want
        ms = _time_ssm(
            torch, f"selective_scan at {label}",
            {v: (lambda v=v: sops.run_variant(v, u, dt, Bm, Cm, A, h))
             for v in sops.VARIANTS},
            lambda: sops.selective_scan(u, dt, Bm, Cm, A, h),
            lambda: sref.selective_scan_ref(u, dt, Bm, Cm, A, h),
            _ssm_bytes(B, S, h0, False), B * S * di * N / SFU_RATE * 1e3)
        cases[f"forward {label}"] = {
            "shape": [B, S, di, N], "h0": h0,
            "states_a_thread": sops.fwd_states(B, di, N),
            "max_abs_err": held["reg"][0], "rel_err": held["reg"][1],
            "earlier_max_abs_err": held["lane"][0], "ms": ms["reg"],
            "earlier_ms": ms["lane"], "eager_ms": ms["eager"],
            "plain_ms": ms["plain"], "bound_ms": ms["bound"],
            "bound_by": ms["bound_by"]}
        if backward:
            g = torch.Generator(device="cuda").manual_seed(800 + i)
            dy = torch.randn(y.shape, generator=g, device="cuda")
            dh = torch.randn(h_last.shape, generator=g, device="cuda")
            want = sref.selective_scan_bwd_ref(u, dt, Bm, Cm, A, h, dy, dh)
            before = dict(bcounts)
            sops.selective_scan_bwd(u, dt, Bm, Cm, A, h, dy, dh)
            assert bcounts["reg"] == before["reg"] + 1 and \
                bcounts["lane"] == before["lane"], \
                f"{label}: not the reg backward"
            held = {v: _hold_ssm(
                torch, f"{label} backward ({v})",
                lambda v=v: sops.run_bwd_variant(v, u, dt, Bm, Cm, A, h, dy,
                                                 dh),
                want, SSM_GATE["backward"],
                ("du", "ddt", "dBm", "dCm", "dA", "dh0"))
                for v in sops.VARIANTS}
            del want
            bms = _time_ssm(
                torch, f"selective_scan_bwd at {label}",
                {v: (lambda v=v: sops.run_bwd_variant(
                    v, u, dt, Bm, Cm, A, h, dy, dh)) for v in sops.VARIANTS},
                lambda: sops.selective_scan_bwd(u, dt, Bm, Cm, A, h, dy, dh),
                lambda: sref.selective_scan_bwd_ref(u, dt, Bm, Cm, A, h, dy,
                                                    dh),
                _ssm_bytes(B, S, h0, True), B * S * di * N / SFU_RATE * 1e3)
            records.append({
                "name": "selective_scan_bwd", "variant": "reg",
                "case": f"jamba {label}", "shape": [B, S, di, N],
                "route": "cuda",
                "source": SSM_SOURCE + "selective_scan_reg_bwd.cu",
                "replaces": SSM_REPLACES + "; its gradient",
                "launches": None, "variant_launches": None,
                "max_abs_err": held["reg"][0], "rel_errs": held["reg"][1],
                "ms": bms["reg"], "eager_ms": bms["eager"],
                "plain_ms": bms["plain"], "bound_ms": bms["bound"],
                "bound_by": bms["bound_by"], "library_ms": None,
                "earlier_variant": "lane", "earlier_ms": bms["lane"],
                "earlier_source": SSM_SOURCE + "selective_scan_bwd.cu",
                "ptxas": _ssm_ptxas(report, "reg", True),
                "earlier_ptxas": _ssm_ptxas(report, "lane", True)})
            del dy, dh
        del u, dt, Bm, Cm, A, h, y, h_last
        _release(torch)
    main = cases["forward prefill"]
    records.insert(0, {
        "name": "selective_scan", "variant": "reg", "case": "jamba prefill",
        "shape": main["shape"], "route": "cuda",
        "source": SSM_SOURCE + "selective_scan_reg.cu",
        "replaces": SSM_REPLACES, "launches": None,
        "variant_launches": None, "max_abs_err": main["max_abs_err"],
        "ms": main["ms"], "eager_ms": main["eager_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "earlier_variant": "lane", "earlier_ms": main["earlier_ms"],
        "earlier_source": SSM_SOURCE + "selective_scan.cu",
        "cases": cases, "ptxas": _ssm_ptxas(report, "reg", False),
        "earlier_ptxas": _ssm_ptxas(report, "lane", False)})
    return records


def _jamba_depths(cfg, total: float) -> None:
    """Log the parameter arithmetic that fixes jamba's depths: whole
    periods of 8 layers (P at 8, 16, 24 layers, bf16) against 90% of the
    card: P for serving, 2P for training in place, 3P for a plan (the
    runtime returns clones of the new parameters and the grads)."""
    fit = 0.9 * total
    for L in (8, 16, 24):
        P = 2 * dataclasses.replace(cfg, num_layers=L).param_count()
        log(f"jamba depth arithmetic: {L} layers: P = {P / 1e9:.2f} GB, "
            f"2P = {2 * P / 1e9:.2f} GB, 3P = {3 * P / 1e9:.2f} GB against "
            f"90% of the card, {fit / 1e9:.2f} GB: serving "
            f"{'fits' if P <= fit else 'does not fit'}, training in place "
            f"{'fits' if 2 * P <= fit else 'does not fit'}, a plan "
            f"{'fits' if 3 * P <= fit else 'does not fit'}")


def _hold_mamba_block(torch, cfg, params, tokens) -> None:
    """The first mamba layer at full width on the card, bf16: a prompt of
    64 tokens into a zero cache, then one decode step, through the scan
    kernel and again with the op's plain version in its place; the bf16
    outputs and conv window within one bf16 step (2^-7) of their largest
    magnitude, the float32 state within 1e-5 of its (the two differ in
    the order of the scan's sums only)."""
    from repro_torch.kernels.ssm import ref as sref
    from repro_torch.models import embed_inputs
    from repro_torch.models import ssm as model_ssm
    from repro_torch.tree import tree_map
    p = tree_map(lambda t: t[0], params["periods"]["b0"]["mix"])
    x = embed_inputs(cfg, params, {"tokens": tokens[:, :65]})
    runs = {}
    scan = model_ssm.selective_scan
    for label in ("kernel", "plain"):
        if label == "plain":
            model_ssm.selective_scan = (
                lambda u, dt, Bm, Cm, A, h0, chunk:
                sref.selective_scan_ref(u, dt, Bm, Cm, A, h0))
        try:
            cache = model_ssm.mamba_cache_init(cfg, x.shape[0], x.dtype,
                                               x.device)
            out1, _ = model_ssm.apply_mamba(cfg, p, x[:, :64], cache=cache)
            out2, _ = model_ssm.apply_mamba(cfg, p, x[:, 64:], cache=cache)
        finally:
            model_ssm.selective_scan = scan
        runs[label] = (out1, out2, cache["h"], cache["conv"])
    errs = []
    for got, want, gate in zip(runs["kernel"], runs["plain"],
                               (2.0 ** -7, 2.0 ** -7, 1e-5, 2.0 ** -7)):
        assert bool(torch.isfinite(got).all())
        err = _ssm_err(got.float(), want.float())
        errs.append(err)
        assert err <= gate, f"jamba_serve: mamba block {err} over {gate}"
    log(f"jamba_serve: layer 0's mamba block, kernel against the plain "
        f"scan (B={x.shape[0]}, 64 prompt tokens then 1 decode step, "
        f"{x.dtype}): max |diff| over max |plain| prefill out {errs[0]:.3g}, "
        f"decode out {errs[1]:.3g}, state {errs[2]:.3g}, conv window "
        f"{errs[3]:.3g}")


def phase_jamba_serve(torch, cfg, card: str) -> dict:
    """jamba-v0.1-52b in bf16 (random weights from a seed) at full width
    and JAMBA["serve_layers"] layers (two periods; the printed arithmetic):
    one ``prefill`` of 8 x 1024 tokens (equal lengths: a right-padded
    batch would run its pads into the recurrent state), then 31 greedy
    ``decode_step`` calls. Asserts 14 scan launches in the prefill and 14
    a decode step, 2 flash launches in the prefill, all sm90 at (128,
    128), none in decode; the first mamba block through the kernel
    against the plain scan (:func:`_hold_mamba_block`). Returns the run's
    launch counts."""
    from repro_torch.models import decode_step, init_params, prefill
    t_phase = time.perf_counter()
    _release(torch)
    total = torch.cuda.get_device_properties(0).total_memory
    _jamba_depths(cfg, total)
    L = JAMBA["serve_layers"]
    deep = dataclasses.replace(cfg, num_layers=L)
    kinds = list(deep.block_pattern) * deep.num_periods
    n_scan = sum(k.startswith("mamba") for k in kinds)
    n_attn = len(kinds) - n_scan
    t0 = time.perf_counter()
    params = init_params(deep, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"jamba_serve: {L} layers ({n_scan} mamba, {n_attn} attention, "
        f"{sum(k.endswith('moe') for k in kinds)} MoE), "
        f"{_param_bytes(params) / 1e9:.2f} GB of parameters, init "
        f"{time.perf_counter() - t0:.1f} s")
    B, S, n_new = JAMBA["batch"], JAMBA["prompt"], JAMBA["new"]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S + 1))
                              .astype(np.int32)).cuda()
    _greedy(torch, deep, params, tokens[:, :128], 2)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _attention_calls() as widths:
        t0 = time.perf_counter()
        logits, caches = prefill(deep, params, {"tokens": tokens[:, :S]},
                                 S + n_new)
        out = [logits[:, -1].argmax(-1)]
        out[-1].cpu()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        after_prefill = read_counts()
        step_ms = []
        for i in range(n_new - 1):
            t1 = time.perf_counter()
            logits, caches = decode_step(deep, params, caches,
                                         out[-1][:, None], S + i)
            out.append(logits[:, -1].argmax(-1))
            out[-1].cpu()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    gen = torch.stack(out, 1)
    assert gen.shape == (B, n_new) and bool(
        ((gen >= 0) & (gen < cfg.vocab_size)).all())
    assert bool(torch.isfinite(logits).all()), "jamba_serve: logits"
    want_prefill = {"selective_scan": n_scan, "selective_scan/reg": n_scan,
                    "selective_scan/lane": 0, "flash_attention": n_attn,
                    "flash_attention/sm90": n_attn,
                    "selective_scan_bwd": 0}
    got = {k: after_prefill[k] for k in want_prefill}
    assert got == want_prefill, \
        f"jamba_serve prefill: launches {got}, want {want_prefill}"
    assert widths == [(cfg.head_dim, cfg.head_dim, True, None)] * n_attn, \
        f"jamba_serve: flash calls at {widths}"
    want_all = dict(want_prefill, selective_scan=n_scan * n_new,
                    **{"selective_scan/reg": n_scan * n_new})
    got = {k: launches[k] for k in want_all}
    assert got == want_all, \
        f"jamba_serve: launches {got}, want {want_all} ({n_scan} scans a " \
        f"decode step, no flash launch)"
    log(f"jamba_serve: launches in the prefill "
        f"{after_prefill['selective_scan']} scans = {n_scan} mamba layers "
        f"(all reg), "
        f"{after_prefill['flash_attention']} "
        f"flash = {n_attn} attention layers, all sm90 at (128, 128); "
        f"{launches['selective_scan'] - n_scan} scans in {n_new - 1} decode "
        f"steps ({n_scan} a step), 0 flash")
    log(f"jamba_serve: {B} requests x {S} prompt tokens, {B * n_new} "
        f"generated in {wall:.3f} s -> {B * n_new / wall:.1f} tok/s; "
        f"prefill (= TTFT) {prefill_ms:.1f} ms; {n_new - 1} decode steps, "
        f"median {statistics.median(step_ms):.2f} ms (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}); max_memory_allocated"
        f" {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); {card}")
    _hold_mamba_block(torch, deep, params, tokens)
    profile(torch, f"jamba prefill B={B} S={S} ({L} layers)",
            lambda: prefill(deep, params, {"tokens": tokens[:, :S]},
                            S + n_new), part=("scan", "ssm_"))
    _, caches = prefill(deep, params, {"tokens": tokens[:, :S]}, S + n_new)
    profile(torch, f"jamba decode step B={B} ({L} layers)",
            lambda: decode_step(deep, params, caches, tokens[:, S:S + 1], S),
            part=("scan", "ssm_"))
    log(f"jamba_serve: phase {time.perf_counter() - t_phase:.1f} s")
    del params, caches
    _release(torch)
    return launches


def phase_jamba_train(torch, cfg, card: str) -> dict:
    """jamba's SGD step at full width (bf16, random weights from a seed,
    B=1, S=2048, lr 1e-3, the loss with its router term) at
    JAMBA["train_layers"] layers, in place: the depth from the printed
    parameter arithmetic (2P; ``fit_depth`` measures at 2 and 4 layers,
    which jamba's period of 8 does not take), and the peak measured
    there. Gates: the cross entropy at init near ln V, aux in [K/2, E] a
    MoE layer, 7 scan forward and 7 backward launches, 1 flash forward
    and 1 backward, all sm90. Then the step traced, partitioned at K=4
    and verified; the plan is not executed (3P does not fit 90% of the
    card: the runtime returns clones of the new parameters and grads).
    Returns the step's launch counts."""
    from repro_torch import api
    from repro_torch.conformance import make_train_step
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    _release(torch)
    total = torch.cuda.get_device_properties(0).total_memory
    L = JAMBA["train_layers"]
    deep = dataclasses.replace(cfg, num_layers=L)
    P = 2 * deep.param_count()
    P16 = 2 * dataclasses.replace(cfg, num_layers=16).param_count()
    log(f"jamba_train: {L} layers: 2P = {2 * P / 1e9:.2f} GB (parameters "
        f"and grads; the update in place) against 90% of the card, "
        f"{0.9 * total / 1e9:.2f} GB; at 16 layers 2P = "
        f"{2 * P16 / 1e9:.2f} GB does not fit")
    kinds = list(deep.block_pattern) * deep.num_periods
    n_scan = sum(k.startswith("mamba") for k in kinds)
    n_attn = len(kinds) - n_scan
    params = init_params(deep, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    batch = _train_batch(torch, cfg, seed=2)
    B, S = TRAIN["batch"], TRAIN["seq"]
    _hold_moe_init(torch, "jamba_train", deep, params, batch)
    want = {"selective_scan": n_scan, "selective_scan_bwd": n_scan,
            "selective_scan/reg": n_scan, "selective_scan/lane": 0,
            "selective_scan_bwd/reg": n_scan, "selective_scan_bwd/lane": 0,
            **_flash_want(n_attn)}
    launches = _eager_sgd(torch, deep, "jamba_train", params, batch,
                          TRAIN["lr"], card, want, near_ln_v=False,
                          moe_group=min(1024, B * S))["launches"]

    # the plan: traced on fake tensors, partitioned, verified, not executed
    k = 4
    grad_step = make_train_step(deep, TRAIN["lr"], return_grads=True)
    t0 = time.perf_counter()
    traced = api.trace(grad_step, params, batch, record=True, autograd=True)
    trace_s = time.perf_counter() - t0
    g = traced.graph
    names = [n.split(".")[0] for n in g.names]
    t0 = time.perf_counter()
    plan = api.partition(traced, devices=k, memory=total / 2,
                         meta={"arch": cfg.name, "layers": L,
                               "static_argnums": [0]})
    part_s = time.perf_counter() - t0
    rep = plan.verify(strict=True)
    c = rep.counts()
    log(f"jamba_train plan: traced the {L}-layer step in {trace_s:.2f} s: "
        f"{g.n} nodes, {names.count('selective_scan')} scan forward and "
        f"{names.count('selective_scan_bwd')} backward nodes, "
        f"{names.count('flash_attention')} flash forward and "
        f"{names.count('flash_attention_bwd')} backward; K={k} under "
        f"{total / 2 / 2**30:.3f} GiB per PE: partition {part_s:.2f} s, "
        f"feasible={plan.feasible}, predicted makespan "
        f"{plan.makespan * 1e3:.3f} ms, peaks [" + ", ".join(
            f"{p / 2**30:.3f}" for p in plan.peak_mem)
        + f"] GiB; verified {c['error']}E/{c['warn']}W/{c['info']}I")
    assert names.count("selective_scan") == names.count(
        "selective_scan_bwd") == n_scan
    assert names.count("flash_attention") == names.count(
        "flash_attention_bwd") == n_attn
    a = plan.assignment
    assert a.shape == (g.n,) and a.min() >= 0 and a.max() < k
    assert c["error"] == 0, f"jamba_train plan: {c['error']} errors"
    log(f"jamba_train plan: not executed, by the arithmetic above: the "
        f"runtime returns clones of the new parameters and grads, so the "
        f"card would hold 3P = {3 * P / 1e9:.2f} GB before any graph pool, "
        f"over 90% of it ({0.9 * total / 1e9:.2f} GB)")
    log(f"jamba_train: phase {time.perf_counter() - t_phase:.1f} s")
    del plan, traced, params, grad_step
    _release(torch)
    return launches


# ---------------------------------------------------------------------------
# the configs with a stubbed frontend: hubert-xlarge and internvl2-1b
# ---------------------------------------------------------------------------
#: hubert-xlarge's cells: encoder_logits at B=8 and the SGD step at B=2
#: (the reference's train_4k length), S = 4096, all 48 layers
HUBERT = dict(prefill_batch=8, train_batch=2, seq=4096, lr=1e-3)
#: internvl2-1b's cells, all 24 layers: a prefill of B=8 x (256 patch
#: embeddings + 768 prompt tokens), 31 greedy decode steps fed tokens
#: (max_len 1056); the SGD step at B=2, S = 4096
INTERNVL = dict(batch=8, patches=256, prompt=1024, new=32, train_batch=2,
                seq=4096, lr=1e-3)
#: a main path through the flash kernels against the same path with the
#: plain attention in their place, bf16: max |diff| over max |plain| of
#: the logits. The two differ by the kernels' rounding of each layer's
#: attention output (about one bf16 step, 2^-8) grown through the
#: layers. A smoke check beside the per-kernel gates, which hold the
#: kernels themselves: hubert's phase reads a control (the plain path
#: with a causal mask planted) and fails unless the control exceeds it
PATH_GATE = 2.0 ** -4


def _path_err(cfg, got, want) -> float:
    """max |got - want| over max |want| of two logits tensors, over the
    vocabulary's columns (the padding columns are -inf in both)."""
    got, want = (t[..., :cfg.vocab_size].float() for t in (got, want))
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def phase_hubert(torch, cfg, card: str) -> dict:
    """hubert-xlarge at full width and depth (48 layers, bf16, random
    weights from a seed, frame embeddings from a seed; every attention
    call non-causal at (80, 80)): (i) ``encoder_logits`` through
    ``train.build_prefill_step`` at B=8, S=4096: 48 sm90 forward
    launches, no fma, logits finite and, on all 8 rows, within PATH_GATE
    of the same path through the plain attention, while the plain path
    with a causal mask planted is not; (ii) eager SGD in place at
    B=2, S=4096 (B lowered only where fit_depth's printed arithmetic says
    the step does not fit at 48 layers): 48 sm90 forward and 48 sm90
    backward launches a step, 0 fma (asserted); (iii) the step traced,
    partitioned at K=4, verified and executed with its PEs folded onto
    the card (:func:`_plan_cell`: full depth when the plan's summed peaks
    and clones fit 90% of the card, else the deepest depth that does,
    printed). Returns the launches by WIDE_CASES record."""
    from repro_torch.conformance import make_train_step
    from repro_torch.models import init_params
    from repro_torch.train import build_prefill_step
    t_phase = time.perf_counter()
    _release(torch)
    L, hd, S, lr = cfg.num_layers, cfg.head_dim, HUBERT["seq"], HUBERT["lr"]
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"hubert: {L} layers, d_model {cfg.d_model}, {cfg.num_heads} heads "
        f"of {hd}, d_ff {cfg.d_ff}, {cfg.vocab_size} targets, "
        f"{cfg.param_count() / 1e9:.3f} B params "
        f"({_param_bytes(params) / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")

    # (i) encoder_logits, the encoder-only prefill step
    B = HUBERT["prefill_batch"]
    frames = {"embeds": _train_batch(torch, cfg, 5, B, S)["embeds"]}
    prefill_step = build_prefill_step(cfg, max_len=S, device="cuda")
    prefill_step(params, frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _attention_calls() as calls:
        logits, caches = prefill_step(params, frames)
        torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": L, "flash_attention/sm90": L,
            "flash_attention/fma": 0, "flash_attention_bwd": 0}
    got = {k: launches[k] for k in want}
    assert got == want, f"hubert encoder: launches {got}, want {want}"
    _under_card(torch, "hubert encoder", peak)
    assert calls == [(hd, hd, False, None)] * L, \
        f"hubert encoder: flash calls {sorted(set(calls))} x {len(calls)}"
    assert caches is None and logits.dtype == torch.float32 and \
        logits.shape == (B, S, cfg.padded_vocab) and \
        bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()), \
        "hubert encoder: logits"
    ms = _wall_ms(torch, lambda: prefill_step(params, frames), n=3)
    prof = _profile_step(torch, f"hubert encoder_logits {L} layers B={B} "
                         f"S={S}", lambda: prefill_step(params, frames),
                         FLASH_KERNEL_NAMES)
    flash = sum(prof["named_ms"].values())
    log(f"hubert encoder: {L} sm90 forward launches a call at ({hd}, {hd}), "
        f"non-causal, 0 fma; median {ms:.2f} ms, {B * S / ms * 1e3:.1f} "
        f"frames/s; device busy {prof['busy_ms']:.2f} of "
        f"{prof['wall_ms']:.2f} ms ({prof['busy_ms'] / prof['wall_ms']:.1%})"
        f"; the flash kernels {flash:.3f} ms ({flash / prof['busy_ms']:.1%}"
        f" of device time); max_memory_allocated {peak / 2**30:.3f} GiB; "
        f"{card}")
    # the counted call's logits against the plain attention path, a row
    # at a time (the plain version holds each layer's scores in float32);
    # the control: the plain path with the causal mask planted, a fault a
    # kernel could make, which the gate must see
    with _attention_calls(plain=True):
        plain_logits = torch.cat([prefill_step(
            params, {"embeds": frames["embeds"][b:b + 1]})[0]
            for b in range(B)])
    err = _path_err(cfg, logits, plain_logits)
    with _attention_calls(plain=True, causal=True):
        fault = prefill_step(params, {"embeds": frames["embeds"][:1]})[0]
    control = _path_err(cfg, fault, plain_logits[:1])
    log(f"hubert encoder: the {B} rows through the kernels against the "
        f"plain attention, {L} layers: max |diff| / max |plain| {err:.3g} "
        f"(gate {PATH_GATE:.3g}); control, the plain path with a causal "
        f"mask planted, one row: {control:.3g}")
    assert err <= PATH_GATE, f"hubert encoder: kernel path off by {err}"
    assert control > PATH_GATE, \
        f"hubert encoder: the gate does not see a planted mask ({control})"
    del frames, logits, plain_logits, fault
    _release(torch)

    # (ii) the eager SGD step, in place, at the deepest B <= 2 that holds
    # all 48 layers by the printed arithmetic
    for B in range(HUBERT["train_batch"], 0, -1):
        batch = _train_batch(torch, cfg, 6, B, S)

        def sgd_step(c):
            p = init_params(c, torch.Generator(device="cuda").manual_seed(1),
                            "cuda")
            st = make_train_step(c, lr, in_place=True)
            return p, lambda: st(p, batch)
        fits, p1, p0 = fit_depth(torch, cfg, f"hubert train B={B}",
                                 sgd_step, "2P (parameters and grads; the "
                                 "update in place)")
        if fits >= L or B == 1:
            break
    assert fits >= L, f"hubert train: {fits} of {L} layers fit at B=1"
    train = _eager_sgd(torch, cfg, "hubert train", params, batch, lr, card,
                       _flash_want(L),
                       calls=[(hd, hd, False, None)] * L)["launches"]
    del params
    _release(torch)

    # (iii) the plan path
    _plan_cell(torch, cfg, "hubert train", batch, L, lr, card, t_phase)
    return {("flash_attention", "hubert encoder"): launches[
                "flash_attention"],
            ("flash_attention", "hubert train"): train["flash_attention"],
            ("flash_attention_bwd", "hubert train"):
                train["flash_attention_bwd"]}


def phase_internvl(torch, cfg, card: str) -> None:
    """internvl2-1b at full width and depth (24 layers, bf16, random
    weights from a seed; the vision frontend stubbed): (i) ``prefill``
    of B=8 x 1024 embeddings, 256 patch embeddings from a seed and then
    768 prompt tokens embedded by the model's table, into caches of
    1056: 24 sm90 forward launches at (64, 64), causal, GQA group 7, no
    fma; the last logits within PATH_GATE of the same prefill through the
    plain attention; (ii) 31 greedy ``decode_step`` calls fed the tokens
    (the paged engine refuses a non-token frontend, as the reference's
    does): no flash launch, tokens in range; tok/s, TTFT, decode ms,
    peak memory, device busy and the flash kernels' time; (iii) the SGD
    step in place at B=2, S=4096: 24 sm90 forward and 24 sm90 backward
    launches, 0 fma (asserted)."""
    from repro_torch.models import decode_step, init_params, prefill
    t_phase = time.perf_counter()
    _release(torch)
    L, hd = cfg.num_layers, cfg.head_dim
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"internvl: {L} layers, d_model {cfg.d_model}, {cfg.num_heads} / "
        f"{cfg.num_kv_heads} heads of {hd}, vocab {cfg.vocab_size}, tied "
        f"embeddings, {cfg.param_count() / 1e9:.3f} B params "
        f"({_param_bytes(params) / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    B, S, P, n_new = (INTERNVL["batch"], INTERNVL["prompt"],
                      INTERNVL["patches"], INTERNVL["new"])
    g = torch.Generator(device="cuda").manual_seed(7)
    patches = (torch.randn((B, P, cfg.d_model), generator=g, device="cuda")
               * 0.02).bfloat16()
    prompt = torch.randint(1, cfg.vocab_size, (B, S - P), generator=g,
                           device="cuda", dtype=torch.int32)
    with torch.no_grad():
        embeds = torch.cat([patches, params["embed"][prompt.long()]], 1)
        for _ in range(2):              # warm-up
            prefill(cfg, params, {"embeds": embeds}, S + n_new)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with _attention_calls() as calls:
            t0 = time.perf_counter()
            logits, caches = prefill(cfg, params, {"embeds": embeds},
                                     S + n_new)
            out = [logits[:, -1].argmax(-1)]
            out[-1].cpu()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            after_prefill = read_counts()
            step_ms = []
            for i in range(n_new - 1):
                t1 = time.perf_counter()
                logits, caches = decode_step(cfg, params, caches,
                                             out[-1][:, None].int(), S + i)
                out.append(logits[:, -1].argmax(-1))
                out[-1].cpu()
                step_ms.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        gen = torch.stack(out, 1)
        assert gen.shape == (B, n_new) and bool(
            ((gen >= 0) & (gen < cfg.vocab_size)).all())
        assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()), \
            "internvl: logits"
        want = {"flash_attention": L, "flash_attention/sm90": L,
                "flash_attention/fma": 0}
        got = {k: after_prefill[k] for k in want}
        assert got == want, f"internvl prefill: launches {got}, want {want}"
        _under_card(torch, "internvl serve", peak)
        assert calls == [(hd, hd, True, None)] * L, \
            f"internvl: flash calls {sorted(set(calls))} x {len(calls)}"
        assert launches["flash_attention"] == L, \
            "internvl: a decode step launched the flash kernel"
        log(f"internvl serve: {B} requests x ({P} patch embeddings + "
            f"{S - P} prompt tokens), {B * n_new} tokens generated in "
            f"{wall:.3f} s -> {B * n_new / wall:.1f} tok/s; prefill (= TTFT)"
            f" {prefill_ms:.1f} ms with {L} sm90 launches at ({hd}, {hd}), "
            f"causal, GQA group {cfg.num_heads // cfg.num_kv_heads}, 0 fma; "
            f"{n_new - 1} decode steps, median "
            f"{statistics.median(step_ms):.2f} ms (min {min(step_ms):.2f}, "
            f"max {max(step_ms):.2f}), no flash launch; max_memory_allocated"
            f" {peak / 2**30:.2f} GiB; {card}")
        first = prefill(cfg, params, {"embeds": embeds}, S + n_new)[0]
        with _attention_calls(plain=True):
            plain = prefill(cfg, params, {"embeds": embeds}, S + n_new)[0]
        err = _path_err(cfg, first, plain)
        same = int((first[:, -1].argmax(-1) == plain[:, -1].argmax(-1))
                   .sum())
        log(f"internvl prefill: through the kernels against the plain "
            f"attention, {L} layers: max |diff| / max |plain| of the last "
            f"logits {err:.3g} (gate {PATH_GATE:.3g}); first tokens equal "
            f"on {same} of {B} rows")
        assert err <= PATH_GATE, f"internvl prefill: kernel path off by {err}"
        del first, plain
        prof = _profile_step(torch, f"internvl prefill B={B} S={S} ({L} "
                             f"layers)", lambda: prefill(
                                 cfg, params, {"embeds": embeds}, S + n_new),
                             FLASH_KERNEL_NAMES)
        flash = sum(prof["named_ms"].values())
        log(f"internvl prefill: device busy {prof['busy_ms']:.2f} of "
            f"{prof['wall_ms']:.2f} ms "
            f"({prof['busy_ms'] / prof['wall_ms']:.1%}); the flash kernels "
            f"{flash:.3f} ms ({flash / prof['busy_ms']:.1%} of device time)")
        tok = gen[:, -1:].int()
        _profile_step(torch, f"internvl decode step B={B} ({L} layers)",
                      lambda: decode_step(cfg, params, caches, tok, S),
                      FLASH_KERNEL_NAMES)
    del embeds, caches, logits, patches, prompt
    _release(torch)

    # (iii) the eager SGD step at B=2, S=4096
    batch = _train_batch(torch, cfg, 8, INTERNVL["train_batch"],
                         INTERNVL["seq"])
    _eager_sgd(torch, cfg, "internvl train", params, batch, INTERNVL["lr"],
               card, _flash_want(L), calls=[(hd, hd, True, None)] * L)
    del params, batch
    _release(torch)
    log(f"internvl: phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# dryrun: the single-device tools (launch.dryrun, the analysis CLI) and the
# remat policies at full width
# ---------------------------------------------------------------------------
# (arch, shape) of the dry-run cells traced at full width, remat "dots"
DRYRUN_CELLS = (("granite-8b", "train_4k"), ("hubert-xlarge", "prefill_32k"),
                ("jamba-v0.1-52b", "decode_32k"))
# the multi-card cell traced at full width: rank 0 of (pod 2, data 16,
# model 16), remat "dots"; its all-reduce bytes against the arithmetic
# count of :func:`multi_all_reduce_bytes` within this share
DRYRUN_MULTI = ("granite-8b", "train_4k")
MULTI_GATE = 0.01
# the remat policies' step: full granite-8b width, a fixed depth that fits
# under every policy (the arithmetic is logged), AdamW with no warm-up so
# that the step moves every parameter
REMAT = dict(layers=4, batch=1, seq=2048, lr=3e-4)
# flash forward launches a layer a step: "none" and "dots" run each
# layer's forward once ("dots" keeps the flash op's outputs: a product
# with batch dims), "full" and "dots_no_batch" once more in the backward
REMAT_FWD = {"none": 1, "full": 2, "dots": 1, "dots_no_batch": 2}
# the dry run's --pardnn-execute plan: compiled against the interpreter
PARDNN_DRIFT = 1e-5
# the dry run's one-card peak (launch.dryrun.trace_order_peak, the step
# traced on fake tensors) over what it holds besides its inputs, against
# the same step's measured peak over the memory held before it: the
# larger of the two ratios at most this
F11_FACTOR = 1.5


def _dryrun_cells(torch, card: str) -> None:
    """(a) ``launch.dryrun.run_cell`` at full width: status OK, a finite
    roofline; nodes, trace seconds, the one-PE peak, the bound and the
    model FLOPs logged."""
    from repro_torch.launch import dryrun
    for arch, shape in DRYRUN_CELLS:
        r = dryrun.run_cell(arch, shape, "single", remat="dots",
                            device="cuda")
        assert r["status"] == "OK", f"dryrun {arch} {shape}: {r}"
        rf = r["roofline"]
        assert r["nodes"] > 0 and r["graph_flops"] > 0 and \
            math.isfinite(rf["bound_s"]) and rf["bound_s"] > 0, \
            f"dryrun {arch} {shape}: {r}"
        sh = dryrun.SHAPES[shape]
        log(f"dryrun cell {arch} {shape} (remat dots, B={sh.global_batch}, "
            f"S={sh.seq_len}): "
            f"{r['status']}, {r['nodes']} nodes traced in {r['trace_s']} s; "
            f"one-PE peak {r['per_device_total_bytes'] / 2 ** 30:.2f} GiB, "
            f"fits one card {r['fits']}; graph {r['graph_flops']:.4g} FLOPs "
            f"{r['graph_bytes']:.4g} bytes; roofline bound "
            f"{rf['bound_s'] * 1e3:.3f} ms ({rf['dominant']}; compute "
            f"{rf['compute_s'] * 1e3:.3f}, memory {rf['memory_s'] * 1e3:.3f}"
            f" ms); model FLOPs {r['model_flops']:.4g}, useful ratio "
            f"{r['useful_flops_ratio']:.4f}; {card}")


def multi_all_reduce_bytes(cfg, shape, pod=2, data=16, model=16) -> int:
    """The all-reduce bytes of one rank's step of the dense config
    ``cfg`` (bf16; query, MLP and vocab dims split by ``model``) at
    ``shape`` over (pod, data, model) under remat "dots", from the
    shapes: per layer the forward's *g* after attention and after the
    MLP, the recompute's attention *g* (the MLP's feeds nothing the
    backward reads) and the backward's two *f*, one (rows, S, D) bf16
    activation each, and the head's *f* once; the vocab-parallel
    cross entropy's pmax, psum of exponentials and psum of the target
    logit (a float32 a token each); the gradient norm's three squares;
    and each gradient's ZeRO-1 block all-reduced over ``pod`` in
    float32: 1/(model x data) of a tensor split over ``model``, 1/data
    of a norm's scale, which every rank of ``model`` holds whole."""
    L, D, V, F = cfg.num_layers, cfg.d_model, cfg.padded_vocab, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.head_dim
    T = shape.global_batch // (pod * data) * shape.seq_len
    act = T * D * 2
    norms = (2 * L + 1) * D
    P = 2 * V * D + D + L * (2 * D + 2 * D * D + 2 * D * kv + 3 * D * F)
    grads = 4 * ((P - norms) // (model * data) + norms // data)
    return (5 * L + 1) * act + 3 * T * 4 + 3 * 4 + grads


def _dryrun_multi(torch, card: str) -> None:
    """(a) continued: the multi-card train cell at full width, rank 0 of
    the 512-chip mesh traced with its collectives; its all-reduce bytes
    against :func:`multi_all_reduce_bytes`."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    arch, shape = DRYRUN_MULTI
    r = dryrun.run_cell(arch, shape, "multi", remat="dots", device="cuda")
    assert r["status"] == "OK" and r["chips"] == 512, \
        f"dryrun {arch} {shape} multi: {r}"
    by, rf = r["rank_collective_bytes"], r["roofline"]
    want = multi_all_reduce_bytes(get_config(arch), dryrun.SHAPES[shape])
    rel = abs(by["all-reduce"] - want) / want
    sh = dryrun.SHAPES[shape]
    log(f"dryrun cell {arch} {shape} multi (remat dots, rank 0 of (pod 2, "
        f"data 16, model 16), its {sh.global_batch // 32} of "
        f"{sh.global_batch} rows x {sh.seq_len}): {r['status']}, "
        f"{r['nodes']} nodes traced in {r['trace_s']} s; the rank's peak "
        f"{r['per_device_total_bytes'] / 2 ** 30:.2f} GiB, fits "
        f"{r['fits']}; the rank's collective bytes {by}, counts "
        f"{r['collective_schedule']}; all-reduce {by['all-reduce']:.0f} "
        f"against {want} counted from the shapes ({rel:.3g} off, gate "
        f"{MULTI_GATE}); roofline bound {rf['bound_s'] * 1e3:.3f} ms "
        f"({rf['dominant']}; compute {rf['compute_s'] * 1e3:.3f}, memory "
        f"{rf['memory_s'] * 1e3:.3f}, collective "
        f"{rf['collective_s'] * 1e3:.3f} ms at NVLink's rate: "
        f"{rf['collective_s'] / rf['bound_s']:.3f} of the bound); {card}")
    assert rel <= MULTI_GATE, f"dryrun multi: all-reduce {by['all-reduce']}"\
        f" against {want}"


#: the multi-card serving cells traced at full width (rank 0 of (pod 2,
#: data 16, model 16)): OK, fits, and the rank's collective bytes equal
#: to the count from the shapes (:func:`serve_tp_bytes`)
DRYRUN_MULTI_SERVE = (("granite-8b", "decode_32k"),
                      ("jamba-v0.1-52b", "long_500k"),
                      ("granite-8b", "prefill_32k"))


def _dryrun_multi_serve(torch, card: str) -> None:
    """(a) continued: the multi-card serving cells of
    :data:`DRYRUN_MULTI_SERVE`, rank 0's prefill or decode step traced
    with its collectives: status OK, fits, all-reduce and all-gather
    bytes equal to :func:`serve_tp_bytes` at the rank's rows (the
    decode cells one step; ``long_500k``'s one row, its caches' sequence
    over data 16)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    for arch, shape in DRYRUN_MULTI_SERVE:
        r = dryrun.run_cell(arch, shape, "multi", device="cuda")
        sh = dryrun.SHAPES[shape]
        cfg = get_config(arch)
        long = sh.global_batch < 32
        rows = sh.global_batch if long else sh.global_batch // 32
        mesh = {"pod": 2, "data": 16, "model": 16}
        if sh.kind == "prefill":
            want = serve_tp_bytes(cfg, mesh, rows, sh.seq_len, 0, False)
        else:
            want = serve_tp_bytes(cfg, mesh, rows, None, 1, long)
        by = r.get("rank_collective_bytes", {})
        got = {"all-reduce": by.get("all-reduce"),
               "all-gather": by.get("all-gather")}
        counted = {"all-reduce": want["psum"] + want["pmax"],
                   "all-gather": want["all_gather"]}
        rf = r.get("roofline", {})
        log(f"dryrun cell {arch} {shape} multi (rank 0 of (pod 2, data 16, "
            f"model 16), its {rows} of {sh.global_batch} rows x "
            f"{sh.seq_len}{', the sequence over data' if long else ''}): "
            f"{r['status']}, {r.get('nodes')} nodes traced in "
            f"{r.get('trace_s')} s; the rank's peak "
            f"{r.get('per_device_total_bytes', 0) / 2 ** 30:.2f} GiB, fits "
            f"{r.get('fits')}; the rank's collective bytes {by}, counts "
            f"{r.get('collective_schedule')}; against the count from the "
            f"shapes {counted}; roofline bound "
            f"{rf.get('bound_s', 0) * 1e3:.3f} ms ({rf.get('dominant')}); "
            f"{card}")
        assert r["status"] == "OK" and r["fits"] and got == counted, \
            f"dryrun {arch} {shape} multi: {r}"


def _dryrun_pardnn(torch, work: Path) -> str:
    """(b) ``run_pardnn_plan`` on the card: reduced granite-8b (float32),
    K=4 folded onto it, executed, linted and traced. Returns the saved
    plan's path."""
    from repro_torch.launch import dryrun
    from repro_torch.obs.trace import validate_trace
    trace = work / "granite.dryrun.trace.json"
    reset_counts()
    res = dryrun.run_pardnn_plan("granite-8b", 4, str(work), execute=True,
                                 lint=True, trace=str(trace))
    counts = read_counts()
    rt, dc = res["runtime"], res["diagnostics"]["counts"]
    log(f"dryrun --pardnn granite-8b (reduced, float32) K=4 on the card: "
        f"{res['ops']} ops, verified {dc['error']}E/{dc['warn']}W/"
        f"{dc['info']}I, {rt['num_segments']} segments, compiled "
        f"{rt['compiled_s'] * 1e3:.2f} ms (sync "
        f"{rt['compiled_sync_s'] * 1e3:.2f}) against the interpreter's "
        f"{rt['interpreter_s'] * 1e3:.1f} ms, output drift "
        f"{rt['output_drift']:.3g}; peaks per PE measured "
        f"{[round(b / 2 ** 20, 3) for b in rt['measured_peak_bytes']]} "
        f"MiB, predicted "
        f"{[round(b / 2 ** 20, 3) for b in rt['predicted_peak_bytes']]} "
        f"MiB; flash launches {counts['flash_attention']} (fma "
        f"{counts['flash_attention/fma']})")
    assert res["verify_errors"] == 0, f"dryrun --pardnn: {dc}"
    assert rt["output_drift"] <= PARDNN_DRIFT, \
        f"dryrun --pardnn: output drift {rt['output_drift']}"
    assert counts["flash_attention/fma"] >= 1, \
        f"dryrun --pardnn: no fma flash forward launched: {counts}"
    problems = validate_trace(str(trace))
    assert not problems, f"dryrun --pardnn trace: {problems[:5]}"
    return res["path"]


def _dryrun_cli(path: str):
    """(c) ``python -m repro_torch.analysis PLAN --arch granite-8b`` in a
    child process, started (the caller waits for it with
    :func:`_dryrun_cli_wait`)."""
    from repro_torch.conformance.subproc import child_env
    return subprocess.Popen([sys.executable, "-m", "repro_torch.analysis",
                             path, "--arch", "granite-8b"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=child_env())


def _dryrun_cli_wait(cli, path: str, t0: float) -> None:
    out, err = cli.communicate(timeout=300)
    log(f"dryrun: python -m repro_torch.analysis {Path(path).name} --arch "
        f"granite-8b: exit {cli.returncode}, {time.perf_counter() - t0:.1f}"
        f" s after its start; {out.strip().splitlines()[:2]}")
    assert cli.returncode == 0, \
        f"the analysis CLI exited {cli.returncode}: {out[-2000:]} " \
        f"{err[-2000:]}"


def _dryrun_remat(torch, card: str, priced: dict) -> None:
    """(d) granite-8b at full width and REMAT["layers"] layers, bf16,
    B=1, S=2048, one AdamW step under each remat policy from the same
    parameters and batch: the flash launches (REMAT_FWD), the loss, the
    grad norm, the new parameters and the first moments (the clipped
    gradients, float32) within TRAIN_GATE of the "none" step; step ms
    and max_memory_allocated, and the peak of the loss and its gradient
    alone over the parameters and state (the activations the policy
    keeps), held within F11_FACTOR of ``priced[policy]``, the dry run's
    figure for the same call (:func:`_dryrun_priced`)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import init_params, unstack_periods
    from repro_torch.train import AdamWConfig, build_train_step, init_state
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import tree_flatten, tree_map
    cfg = dataclasses.replace(get_config("granite-8b"),
                              num_layers=REMAT["layers"])
    L, P = cfg.num_layers, cfg.param_count()
    fit = 0.9 * torch.cuda.get_device_properties(0).total_memory
    log(f"dryrun remat: memory arithmetic at {L} layers: P = {P / 1e9:.3f} "
        f"B parameters; the untouched copy (2P bytes), the step's bf16 "
        f"parameters and grads and float32 master, mu and nu (16P), and the "
        f"none step's parameters and mu kept for the comparison (6P): "
        f"{24 * P / 1e9:.2f} GB before activations, against 90% of the "
        f"card, {fit / 1e9:.2f} GB")
    gen = torch.Generator(device="cuda").manual_seed(5)
    pristine = init_params(cfg, gen, "cuda")
    ocfg = AdamWConfig(lr=REMAT["lr"], warmup_steps=0, total_steps=2)
    batch = make_batch(DataConfig(batch_size=REMAT["batch"],
                                  seq_len=REMAT["seq"],
                                  vocab_size=cfg.vocab_size), 0)
    tbatch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    base = None
    summary = []
    for policy in REMAT_FWD:
        step = build_train_step(cfg, ocfg, remat_policy=policy,
                                device="cuda")
        for rep in range(2):          # a warm-up, then the measured step
            params = tree_map(lambda t: t.clone(), pristine)
            state = init_state(ocfg, params)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            _, _, met = step(params, state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts()
        want = _flash_want(L)
        want["flash_attention"] = want["flash_attention/sm90"] = \
            REMAT_FWD[policy] * L
        got = {k: counts[k] for k in want}
        assert got == want, f"dryrun remat {policy}: launches {got}, " \
            f"want {want}"
        _under_card(torch, f"dryrun remat {policy}", peak)
        leaves = [met["loss"], met["grad_norm"]] + \
            tree_flatten((params, state["mu"]))[0]
        if base is None:
            base, bits, worst = leaves, len(leaves), 0.0
        else:
            bits, worst = 0, 0.0
            for a, b in zip(leaves, base):
                if torch.equal(a, b):
                    bits += 1
                    continue
                worst = max(worst, float((a.float() - b.float()).abs().max())
                            / (TRAIN_GATE * max(float(b.float().abs().max()),
                                                1e-30)))
        log(f"dryrun remat {policy}: step {ms:.2f} ms, max_memory_allocated "
            f"{peak / 2 ** 30:.3f} GiB ({(peak - before) / 2 ** 30:.3f} GiB "
            f"over the {before / 2 ** 30:.3f} GiB held before the step); "
            f"loss {float(met['loss']):.6f}, grad norm "
            f"{float(met['grad_norm']):.6f}; launches {got}; against none: "
            f"{bits} of {len(leaves)} leaves (loss, grad norm, new "
            f"parameters, mu) bit-equal, worst other / (2^-7 x max |none|) "
            f"{worst:.3g}; {card}")
        assert all(bool(torch.isfinite(x.float()).all()) for x in leaves) \
            and worst <= 1, f"dryrun remat {policy}: disagrees with none"
        # the loss and its gradient alone: the activations each policy
        # keeps, without the optimizer's temporaries over the step's
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = loss_and_grads(cfg, unstack_periods(cfg, params), tbatch,
                               policy)
        torch.cuda.synchronize()
        grad_peak = torch.cuda.max_memory_allocated() - held
        del grads
        log(f"dryrun remat {policy}: the loss and its gradient alone peak "
            f"{grad_peak / 2 ** 30:.3f} GiB over the parameters and state")
        traced = priced[policy]
        summary.append(f"{policy} {ms:.2f} ms, {peak / 2 ** 30:.2f} GiB "
                       f"(gradient {grad_peak / 2 ** 30:.3f} GiB, priced "
                       f"{traced / 2 ** 30:.3f})")
        ratio = max(traced / grad_peak, grad_peak / traced)
        log(f"dryrun remat {policy}: the dry run's trace-order one-card peak "
            f"of the same loss and gradient, less its inputs, "
            f"{traced / 2 ** 30:.3f} GiB against the measured "
            f"{grad_peak / 2 ** 30:.3f} GiB: {ratio:.3f}x (at most "
            f"{F11_FACTOR}x); {card}")
        assert ratio <= F11_FACTOR, \
            f"dryrun remat {policy}: priced peak {traced} B against the " \
            f"measured {grad_peak} B"
        del params, state, met, step, leaves
        _release(torch)
    log(f"dryrun remat summary ({L} layers, B=1, S=2048, AdamW): "
        f"{'; '.join(summary)}; {card}")
    del base, pristine
    _release(torch)


def _dryrun_priced(torch, device: str) -> dict:
    """Per remat policy, the dry run's one-card peak of REMAT's step (the
    loss and gradient of granite-8b at REMAT["layers"] layers, B and S;
    ``launch.dryrun.trace_order_peak``), traced on fake tensors on
    ``device`` (nothing runs: the graph depends on shapes and dtypes
    only), less the bytes of its inputs (the parameters and the
    batch)."""
    from repro_torch.configs import ShapeConfig, get_config
    cfg = dataclasses.replace(get_config("granite-8b"),
                              num_layers=REMAT["layers"])
    shape = ShapeConfig("remat", REMAT["seq"], REMAT["batch"], "train")
    return {p: _priced(torch, cfg, shape, p, device) for p in REMAT_FWD}


def _priced(torch, cfg, shape, policy: str, device: str) -> float:
    """One policy's figure of :func:`_dryrun_priced`."""
    from repro_torch.launch import dryrun
    traced = dryrun._trace_cell(cfg, shape, policy, torch.device(device))
    prog, mem = traced.program, traced.graph.mem
    held = sum(float(mem[n]) for n in prog.input_nodes) + \
        sum(float(mem[n]) for n, _ in prog.const_nodes)
    return dryrun.trace_order_peak(traced) - held


def phase_dryrun(torch, card: str, serving: bool = False,
                 priced: dict | None = None,
                 distributed: int | None = None) -> dict | None:
    """The single-device tools of ``launch.dryrun`` and the analysis CLI
    on the card, and the remat policies at full width: (b), then (c) in
    a child process (and, with ``serving``, the conformance_serving
    child; with ``distributed``, a depth, the distributed phase's ranks)
    while (a) traces on the host (the children's start, imports and the
    card's context overlap the traces, which time nothing on the card),
    and the remat cell's priced peaks unless ``priced`` has them, then
    (d) once the children have ended, so that no other process shares
    its timings. Returns the distributed phase's launches, when it ran."""
    from repro_torch.conformance.subproc import stop_ranks
    launches = None
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = _dryrun_pardnn(torch, Path(tmp))
        t1 = time.perf_counter()
        cli = _dryrun_cli(path)
        started = _serving_start(Path(tmp)) if serving else None
        ranks = None
        try:
            if distributed is not None:
                (Path(tmp) / "distributed").mkdir()
                ranks = _distributed_start(Path(tmp) / "distributed",
                                           distributed)
            _dryrun_cells(torch, card)
            _dryrun_multi(torch, card)
            _dryrun_multi_serve(torch, card)
            if priced is None:
                priced = _dryrun_priced(torch, "cuda")
            t2 = time.perf_counter()
            _dryrun_cli_wait(cli, path, t1)
            if started is not None:
                _serving_check(started, card)
            if ranks is not None:
                launches = _distributed_check(torch, ranks, card)
        finally:
            for proc in (cli, started[0] if started else None):
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            if ranks is not None:
                stop_ranks(ranks[0])
                stop_ranks(ranks[1])
    t3 = time.perf_counter()
    _dryrun_remat(torch, card, priced)
    beside = ["the analysis CLI"] + (["the conformance_serving child"]
                                     if serving else []) + \
        (["the distributed phase's ranks"] if distributed else [])
    log(f"dryrun: --pardnn {t1 - t0:.1f} s, cells {t2 - t1:.1f} s ("
        f"{', '.join(beside)} beside them), their wait {t3 - t2:.1f} s, "
        f"remat policies {time.perf_counter() - t3:.1f} s; {card}")
    return launches


# ---------------------------------------------------------------------------
# distributed: the collective parts over 4 ranks sharing the card
# ---------------------------------------------------------------------------
#: the ranks of the launch, the pipeline case (stages of one granite-8b
#: block, microbatches of (1, S)) and the data-parallel run: the global
#: batch (B rows of S), steps, pods
DIST = dict(ranks=4, micro=4, seq=1024, batch=4, steps=3, pods=2, seed=5,
            lr=3e-4, restore_ranks=2)
#: (a) and each (c) leaf's bound, relative to the leaf's largest magnitude
DIST_GATE = 2.0 ** -7
#: (g)-(i): a quantity over DIST_GATE by its largest element passes only
#: as bf16 rounding: the same split run in float32 within TP32_GATE of
#: the whole float32 run by its largest element (the CPU tests' bound on
#: each gradient against one rank), its L2 error within DIST_GATE, and
#: its largest element's error within TP_ROUNDING times the whole bf16
#: run's (a sum of m partials each rounded, then rounded at each hop,
#: has about twice the one product's rounding)
TP32_GATE = 1e-4
TP_ROUNDING = 2.0
#: (d)-(i): the bytes of a rank's blocks above which its gradients wait
#: in host memory, and the float32 whole runs' bytes (parameters and
#: gradients) the card holds at once, in turns of ranks
TP_STAGE = 2 ** 30
TP_F32 = 24 * 2 ** 30
#: (b): the first loss against the one-rank loss (the reference's
#: tolerance across meshes, tests/test_multidevice.py)
DIST_LOSS_GATE = 1e-3
#: (c): the reference's bound on the compressed mean
COMPRESSION_BOUND = 0.03
DIST_MARK = "DIST_JSON:"
#: (d), (e), (g)-(i): tensor parallel over (data 1, model 4): granite-8b
#: blocks (as many as (a) holds), one mixtral-8x7b layer, deepseek's MLA
#: prelude layer and an mla_moe layer, 2 rwkv6-7b layers, a jamba mamba
#: and mamba_moe block; tokens (1, seq); (f): launch.train over (data 2,
#: model 2), steps, no checkpoint
TP = dict(blocks=4, seq=1024, seed=7, train_model=2, train_steps=2)
#: the seed of (d)-(i)'s weights and tokens, where ``--tp-seed`` does
#: not set another (passed to the ranks in the environment)
TP_SEED_ENV = "CHIP_SMOKE_TP_SEED"
#: the wrappers whose launches a tensor-parallel case counts
TP_KERNELS = ("flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd",
              "selective_scan", "selective_scan_bwd")


def _tp_cases(get_config) -> dict:
    """(d), (e), (g)-(i): the full-width config whose blocks each runs,
    the kernels (wrapper: launches a rank, all of the variant named) its
    tensor-parallel run launches (the others launch none), and whether
    its blocks are chained (each block's output the next one's input:
    (d) and (e)) or side by side (each on the
    embedded tokens: a chained RWKV or Mamba block at random weights
    amplifies the rounding of the blocks before it, the model's
    sensitivity and not the split's, ``PERF.md`` §6)."""
    import dataclasses as dc
    layers = TP["blocks"]
    return {
        "(d)": (dc.replace(get_config("granite-8b"), num_layers=layers),
                {"flash_attention": (layers, "sm90"),
                 "flash_attention_bwd": (layers, "sm90")}, True),
        "(e)": (dc.replace(get_config("mixtral-8x7b"), num_layers=1),
                {"flash_attention": (1, "sm90"),
                 "flash_attention_bwd": (1, "sm90")}, True),
        "(g)": (dc.replace(get_config("deepseek-v2-lite-16b"), num_layers=2),
                {"flash_attention": (2, "sm90"),
                 "flash_attention_bwd": (2, "sm90")}, False),
        "(h)": (dc.replace(get_config("rwkv6-7b"), num_layers=2),
                {"wkv6": (2, "mma"), "wkv6_bwd": (2, "mma")}, False),
        "(i)": (dc.replace(get_config("jamba-v0.1-52b"), num_layers=2,
                           block_pattern=("mamba", "mamba_moe")),
                {"selective_scan": (2, "reg"),
                 "selective_scan_bwd": (2, "reg")}, False),
    }


def _tp_psum_bytes(cfg, seq: int) -> int:
    """The bytes a rank all-reduces in one forward and backward of
    ``cfg``'s blocks over model 4 at (1, seq) in bf16, every block split,
    each sum in its operands' dtype: per block each mixer's *g* forward
    and *f* backward (A, one (1, seq, D) bf16 activation, each), and
    MLA's backward sums of ``w_dkv``, ``w_kr`` (bf16) and ``kv_norm``
    (float32); the RWKV time mix's of its five token-shift coefficients
    and ``w_lora_a`` (bf16), its channel mix's *g* and *f* (2A); Mamba's
    ``w_x`` product summed forward and its gradient backward (seq x (R +
    2N) bf16 each); an MLP's 2A, an MoE's *f* into the experts (A), into
    the float32 top-p weights (seq x K) and its *g* (A)."""
    D, bf16, f32 = cfg.d_model, 2, 4
    A = seq * D
    total = 0
    for kind in cfg.prelude + cfg.block_pattern * cfg.num_periods:
        total += 4 * A * bf16
        if kind == "rwkv":
            total += (5 * D + D * cfg.rwkv.lora_w) * bf16
        elif kind.startswith("mla"):
            total += (D * cfg.kv_lora_rank + D * cfg.qk_rope_dim) * bf16 + \
                cfg.kv_lora_rank * f32
        elif kind.startswith("mamba"):
            total += 2 * seq * (max(D // 16, 1) + 2 * cfg.mamba.d_state) * \
                bf16
        if kind.endswith("moe"):
            total += seq * cfg.moe.experts_per_token * f32
    return total


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want||, over every element."""
    return float((got.float() - want.float()).norm()) / max(
        float(want.float().norm()), 1e-30)


def _rank_pipeline(torch, mesh) -> dict:
    """(a) ``pipeline_apply`` over the 4 ranks' ``stage`` axis, one
    granite-8b block a stage, M microbatches of (1, S) forward and
    backward, against the same 4 blocks run on this rank microbatch by
    microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ProcessMesh
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import init_params
    from repro_torch.models.transformer import _block_apply
    from repro_torch.pipeline.pardnn_pp import (pipeline_apply, plan_stages,
                                                stack_stage_params)
    from repro_torch.tree import tree_flatten, tree_map
    P_, M, S = DIST["ranks"], DIST["micro"], DIST["seq"]
    stages = ProcessMesh(MeshShape((P_,), ("stage",)), "cuda")
    sid = stages.axis_index("stage")
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=P_)
    gen = torch.Generator(device="cuda").manual_seed(DIST["seed"])
    params = init_params(cfg, gen, "cuda")
    blocks = params["periods"]["b0"]          # (4, ...) stacked
    toks = torch.randint(0, cfg.vocab_size, (M, 1, S), generator=gen,
                         device="cuda")
    x = params["embed"][toks].detach()        # (M, 1, S, D) bf16
    del params
    pos = torch.arange(S, dtype=torch.int32, device="cuda")

    def layer(p, h):
        return _block_apply(cfg, "attn", p, h, positions=pos)[0]

    plan = plan_stages(np.ones(P_), np.ones(P_), 0.0, P_)
    sp, mask = stack_stage_params(blocks, plan.boundaries)
    mine = tree_map(lambda a: a[sid].detach().clone().requires_grad_(), sp)
    del sp
    # the process's first block, forward and backward: its cold start
    t0 = time.perf_counter()
    layer(mine, x[0]).float().square().mean().backward()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    for t in tree_flatten(mine)[0]:
        t.grad = None
    reset_counts()
    stages.reset_moved()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline_apply(stages, layer, mine, mask[sid], x)
    loss = (out.float() ** 2).mean()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    ms = {"cold": cold_ms, "forward": (t1 - t0) * 1e3,
          "backward": (time.perf_counter() - t1) * 1e3}
    counts = read_counts()
    moved = {"bytes": dict(stages.moved), "seconds": dict(stages.seconds)}
    # the same 4 blocks on this rank, microbatch by microbatch
    ref = [tree_map(lambda a, i=i: a[i].detach().requires_grad_(), blocks)
           for i in range(P_)]
    outs = []
    for m in range(M):
        h = x[m]
        for i in range(P_):
            h = layer(ref[i], h)
        outs.append(h)
    want = torch.stack(outs)
    ref_loss = (want.float() ** 2).mean()
    ref_loss.backward()
    errs = {"out": max(_rel(out[m], want[m]) for m in range(M)),
            "loss": abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
            "grad": max(_rel(g.grad, w.grad) for g, w in zip(
                tree_flatten(mine)[0], tree_flatten(ref[sid])[0]))}
    del mine, ref, out, want, x, blocks
    return {"ms": ms, "counts": counts, "moved": moved, "errs": errs,
            "loss": float(loss), "ticks": M + P_ - 1}


def _rank_compression(torch, mesh, cfg, local: dict) -> dict:
    """(c) ``make_compressed_psum`` over ``pod`` on this rank's first
    full-width gradient tree (the step-0 batch slice at the initial
    parameters), in groups of leaves: each leaf's mean against the exact
    mean (on the pod-0 ranks, which compute the other pod's gradient on
    its rows themselves: the same seeded parameters), and residual +
    dequantized against what went in (on every rank)."""
    from repro_torch.models import init_params, unstack_periods
    from repro_torch.train.compression import (init_error_state,
                                               make_compressed_psum)
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import tree_flatten
    params = unstack_periods(cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(DIST["seed"]),
        "cuda"))
    _, _, grads = loss_and_grads(cfg, params, local, "full")
    checks = mesh.rank == mesh.members("pod")[0]
    # the pods' rows, in pod order (a few KB); the other pod's gradient
    rows = {k: mesh.all_gather(v, "pod", 0) for k, v in local.items()}
    other = None
    if checks:
        per = local["tokens"].shape[0]
        other = tree_flatten(loss_and_grads(
            cfg, params, {k: v[per:] for k, v in rows.items()},
            "full")[2])[0]
    del params, rows
    fn = make_compressed_psum(mesh, "pod")
    mesh.reset_moved()
    worst = {"rel": 0.0 if checks else None, "feedback": 0.0,
             "residual": 0.0}
    n = 0
    # the tree in groups of about 2^28 elements (a float32 GiB): each
    # group one call, its tensors' collectives overlapped
    groups, group = [], []
    for g in tree_flatten(grads)[0]:
        if group and sum(t.numel() for t in group) + g.numel() > 2 ** 28:
            groups.append(group)
            group = []
        group.append(g)
    groups.append(group)
    i = 0
    for group in groups:
        blocks = [g[None] for g in group]
        red, err = fn(blocks, init_error_state(group))
        scales = mesh.pmax(torch.stack([b.float().abs().max()
                                        for b in blocks]), "pod")
        for b, r, e, s in zip(blocks, red, err, scales):
            # the exact mean, on the pod-0 rank of each pod group (the
            # mean is the same on every rank of it): the pods' bf16
            # blocks summed in float32
            if other is not None:
                exact = (b[0].float() + other[i].float()) / 2
                other[i] = None
                worst["rel"] = max(worst["rel"], _rel(r[0], exact))
                del exact
            i += 1
            gf = b.float()
            scale = s / 127.0 + 1e-12           # float32, as the sender's
            q = torch.round((gf - e) / scale)
            assert float(q.abs().max()) <= 127
            ulp = float(np.spacing(np.float32(float(scale) * 127)))
            worst["feedback"] = max(worst["feedback"], float(
                (e + q * scale - gf).abs().max()) / ulp)
            worst["residual"] = max(worst["residual"], float(
                e.abs().max()) / float(scale))
            n += b.numel()
            del gf, q
        del red, err
    moved = dict(mesh.moved)
    del grads
    return {"worst": worst, "moved": moved, "elements": n}


def _tp_blocks(cfg, tree):
    """(parameters, kind) of each block of ``tree`` (prelude and stacked
    periods) in layer order."""
    from repro_torch.tree import tree_map
    for i, kind in enumerate(cfg.prelude):
        yield tree[f"prelude{i}"], kind
    for n in range(cfg.num_periods):
        for j, kind in enumerate(cfg.block_pattern):
            yield tree_map(lambda t: t[n], tree["periods"][f"b{j}"]), kind


def _rank_tensor_parallel(torch, cfg, chained: bool) -> dict:
    """(d), (e), (g)-(i): ``cfg``'s blocks at full width (bf16) over the
    (data 1, model 4) mesh: each rank its blocks
    (``train.step.shard_params``) under ``activation_sharding``, forward
    and backward of (out^2).mean() plus the MoE aux, the blocks
    ``chained`` (out the last block's) or side by side on the embedded
    tokens (the sum of each block's loss; :func:`_tp_cases`). Then the
    same blocks run whole on this rank in bf16 and in float32 (the ranks
    in turns of as many as :data:`TP_F32` holds; the seeded weights are
    the same on every rank). Per quantity (the
    output, the loss, every gradient: this rank's block of the whole
    runs', the ranks' blocks together being the whole gradient) the
    largest error over the largest magnitude, and the relative L2
    error, of the bf16 tensor-parallel run and of the whole bf16 run
    against the float32 run, and of the one against the other. Side by
    side, where a quantity of the tensor-parallel run is further from
    float32 than the whole run's by more than DIST_GATE by its largest
    element on some rank, the same split runs in float32 and each such
    quantity's largest error against the whole float32 run over its
    largest magnitude is reported. For MoE every run after the first
    takes the bf16 tensor-parallel run's expert choices and slots (each
    run's own probabilities): a token that inputs differing by rounding
    send to
    another expert would differ by a whole expert's output; the whole
    bf16 layer is also run with its own routing, whose aux, dropped
    share (assignments kept of those made) and changed assignments are
    reported, and each of this rank's experts its tokens kept and its
    errors. Also the launches of :data:`TP_KERNELS` and the bytes of the
    bf16 tensor-parallel run."""
    from repro_torch.distributed import ProcessMesh
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import init_params
    from repro_torch.models import moe as M
    from repro_torch.models.layers import activation_sharding
    from repro_torch.models.transformer import _block_apply
    from repro_torch.sharding import rules
    from repro_torch.sharding.rules import _paths
    from repro_torch.train.step import shard_params
    from repro_torch.tree import tree_flatten, tree_map
    mesh = ProcessMesh(MeshShape((1, DIST["ranks"]), ("data", "model")),
                       "cuda")
    S = TP["seq"]
    gen = torch.Generator(device="cuda").manual_seed(
        int(os.environ.get(TP_SEED_ENV, TP["seed"])))
    params = init_params(cfg, gen, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                         device="cuda")
    x = params["embed"][toks].detach()
    # the blocks: the prelude's and the stacked periods' (L, ...)
    whole = {k: v for k, v in params.items()
             if k == "periods" or k.startswith("prelude")}
    names = ["/".join(map(str, q)) for q in _paths(whole)]
    del params
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    places = tree_flatten(rules.param_shardings(whole, mesh))[0]
    mine = tree_map(lambda t: t.detach().clone().requires_grad_(),
                    shard_params(whole, mesh))
    plan = rules.activation_plan(mesh, cfg, kind="train")
    c32 = dataclasses.replace(cfg, dtype="float32")
    seen: list = []          # each route's (top_e, onehot, slots)
    pinned: list = []        # the routing the later runs take, in order
    real = M.route

    def spy(c, router, xg, keep_fn=None):
        probs, top_p, top_e, onehot, poh = real(c, router, xg, keep_fn)
        if pinned:
            top_e, onehot, poh = pinned[len(seen)]
            top_p = probs.gather(-1, top_e)
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
        seen.append((top_e, onehot, poh))
        return probs, top_p, top_e, onehot, poh

    def dropped():
        made = sum(float(o.sum()) for _, o, _ in seen)
        return 1 - sum(float(p.sum()) for _, _, p in seen) / made \
            if seen else None

    def run(c, tree, h):
        seen.clear()
        aux, outs, loss = None, [], 0.0
        for p, kind in _tp_blocks(c, tree):
            y, _, a = _block_apply(c, kind, p, h, positions=pos)
            aux = a if aux is None else (aux + a if a is not None else aux)
            if chained:
                h = y
            else:
                loss = loss + (y.float() ** 2).mean()
                outs.append(y.detach())
        if chained:
            loss, outs = (h.float() ** 2).mean(), [h.detach()]
        return torch.stack(outs), loss if aux is None else loss + aux, aux

    def finish(c, tree, h, where: str):
        """The whole run's output, loss, aux, dropped share and a copy of
        this rank's block of each gradient on ``where``."""
        out, loss, aux = run(c, tree, h)
        loss.backward()
        blocks = [sh.shard(t.grad).to(where, copy=True)
                  for t, sh in zip(tree_flatten(tree)[0], places)]
        return {"out": out.float(), "loss": float(loss), "blocks": blocks,
                "aux": None if aux is None else float(aux),
                "dropped": dropped()}

    def errs(a, b):
        """Per quantity the largest error over the largest magnitude and
        the relative L2 error (``_l2``)."""
        pairs = [(g.to("cuda"), w.to("cuda")) for g, w in zip(
            a["blocks"], b["blocks"])]
        return {"out": _rel(a["out"], b["out"]),
                "out_l2": _rel_l2(a["out"], b["out"]),
                "loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                "grad": [_rel(g, w) for g, w in pairs],
                "grad_l2": [_rel_l2(g, w) for g, w in pairs]}

    def per_expert(f32):
        """Each expert stack of an MoE layer (this rank's experts on
        axis 1): per expert its tokens kept and the bf16 runs' largest
        errors over the stack's largest magnitude."""
        if len(routing) != 1:
            return None
        E = cfg.moe.num_experts
        out = {}
        for i, (name, w) in enumerate(zip(names, f32["blocks"])):
            El = w.shape[1] if w.dim() == 4 else E
            if "/ffn/w_" not in name or El == E:
                continue
            first = mesh.axis_index("model") * El
            kept = routing[0][2][..., first:first + El, :].sum((0, 1, 2, 4))
            scale = float(w.abs().max())
            out[name] = {"tokens": [int(n) for n in kept.tolist()]}
            for k, run_ in (("tp", tp), ("bf16", bf16)):
                d = (run_["blocks"][i].to("cuda").float() - w).abs()
                out[name][k] = (d.amax((0, 2, 3)) / scale).tolist()
        return out

    M.route = spy
    try:
        reset_counts()
        mesh.reset_moved()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with activation_sharding(plan, mesh) as kinds:
            out, loss, aux = run(cfg, mine, x)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: n for k, n in read_counts().items()
                  if k.split("/")[0] in TP_KERNELS}
        moved = dict(mesh.moved)
        # the gradients wait for the float32 run on the card, or in host
        # memory where a rank's blocks pass TP_STAGE bytes: the card
        # holds the float32 runs and six processes' blocks at a time
        leaves = tree_flatten(mine)[0]
        stage = "cpu" if sum(t.numel() * t.element_size()
                             for t in leaves) > TP_STAGE else "cuda"
        tp = {"out": out.float(), "loss": float(loss),
              "blocks": [t.grad.to(stage, copy=True) for t in leaves],
              "aux": None if aux is None else float(aux),
              "dropped": dropped()}
        routing = list(seen)
        for t in tree_flatten(mine)[0]:
            t.grad = None
        del out, loss, aux
        own = None
        if routing:
            # the whole bf16 layer with its own routing: aux, dropped
            # share, and the (token, k) assignments that changed
            with torch.no_grad():
                _, _, a = run(cfg, whole, x)
            own = {"aux": float(a), "dropped": dropped(),
                   "changed": sum(int((e != t).sum()) for (e, _, _), (
                       t, _, _) in zip(seen, routing))}
            pinned[:] = routing
        bf16 = finish(cfg, tree_map(lambda t: t.detach().requires_grad_(),
                                    whole), x, stage)
        f32 = res = None
        kept: dict = {}      # leaf index (-1 the output): float32 whole
        # every rank gives its cached blocks back to the card first: 6
        # processes share it; the float32 runs in turns of as many ranks
        # as TP_F32 holds (parameters and gradients)
        _release(torch)
        group = max(1, int(TP_F32 // (8 * sum(
            t.numel() for t in tree_flatten(whole)[0]))))
        for turn in range(-(-DIST["ranks"] // group)):
            mesh.all_reduce(torch.zeros(1, device="cuda"), "model")
            if mesh.rank // group == turn:
                f32_tree = tree_map(lambda t: t.detach().float()
                                    .requires_grad_(), whole)
                whole = None
                f32 = finish(c32, f32_tree, x.float(), "cuda")
                del f32_tree
                res = {"tp_f32": errs(tp, f32), "bf16_f32": errs(bf16, f32),
                       "tp_bf16": errs(tp, bf16),
                       "experts": per_expert(f32)}
                if not chained:
                    # what is over the gate by its largest element keeps
                    # its float32 whole value for the witness below
                    a, b = res["tp_f32"], res["bf16_f32"]
                    kept = {i: w.to("cpu") for i, (w, e, e_) in enumerate(
                        zip(f32["blocks"], a["grad"], b["grad"]))
                        if e > e_ + DIST_GATE}
                    if a["out"] > b["out"] + DIST_GATE:
                        kept[-1] = f32["out"].to("cpu")
                f32["blocks"] = None
                _release(torch)
        # the witness that such a gap is bf16 rounding: the same split in
        # float32, whose distance from the whole float32 run is the
        # split's own (run where any rank of the case needs it)
        res["split32"] = {}
        need = mesh.all_reduce(torch.tensor([float(len(kept))],
                                            device="cuda"), "model")
        if float(need[0]):
            tree32 = tree_map(lambda t: t.detach().float().requires_grad_(),
                              mine)
            with activation_sharding(plan, mesh):
                out32, loss32, _ = run(c32, tree32, x.float())
            loss32.backward()
            got = [out32] + [t.grad for t in tree_flatten(tree32)[0]]
            res["split32"] = {"out" if i < 0 else names[i]: _rel(
                got[i + 1], w.to("cuda")) for i, w in kept.items()}
            del tree32, out32, loss32, got
        mesh.all_reduce(torch.zeros(1, device="cuda"), "model")
    finally:
        M.route = real

    res.update(counts=counts, moved=moved, ms=ms, kinds=sorted(set(kinds)),
               loss=tp["loss"], blocks=cfg.num_layers, own=own,
               leaves=names, chained=chained)
    for k in ("aux", "dropped"):
        if tp[k] is not None:
            res[k] = {"tp": tp[k], "bf16": bf16[k], "f32": f32[k]}
    del x, mine, kept, tp, bf16, f32, routing, seen[:], pinned[:]
    return res


def _rank_model_parallel_train(torch, layers: int) -> dict:
    """(f) ``launch.train``'s body for granite-8b at ``layers`` layers
    over (data 2, model 2): the ZeRO-1 step tensor parallel over
    ``model``, TP["train_steps"] steps, no checkpoint; and on rank 0 the
    one-rank loss on the global batch (the two data groups' rows)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.distributed import ProcessMesh
    from repro_torch.launch.mesh import mesh_over
    from repro_torch.launch.train import train
    from repro_torch.models import init_params, loss_fn
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=layers)
    mesh = ProcessMesh(mesh_over(DIST["ranks"], model=TP["train_model"]),
                       "cuda")
    dc = DataConfig(batch_size=DIST["batch"], seq_len=DIST["seq"],
                    vocab_size=cfg.vocab_size, seed=DIST["seed"],
                    model_parallel=TP["train_model"])
    whole = {k: mesh.all_gather(torch.as_tensor(v, device="cuda"), "data", 0)
             for k, v in make_batch(dc, 0).items()}
    res: dict = {"mesh": mesh.shape}
    if mesh.rank == 0:
        with torch.no_grad():
            p = init_params(cfg, torch.Generator(device="cuda").manual_seed(
                DIST["seed"]), "cuda")
            res["one_rank_loss"] = float(loss_fn(cfg, p, whole)[0])
            del p
    del whole
    _release(torch)
    reset_counts()
    mesh.reset_moved()
    torch.cuda.reset_peak_memory_stats()
    loop = train(cfg, steps=TP["train_steps"], batch=DIST["batch"],
                 seq=DIST["seq"], lr=DIST["lr"], remat="full",
                 seed=DIST["seed"], device="cuda", log_every=1, mesh=mesh)
    torch.cuda.synchronize()
    res.update(counts=read_counts(), moved=dict(mesh.moved),
               collective_s=dict(mesh.seconds),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=[h["loss"] for h in loop.state.history],
               ms=[h["time"] * 1e3 for h in loop.state.history],
               skipped=loop.state.skipped)
    del loop
    return res


# (j)-(m): serving over a mesh in the same ranks
#: the decode steps of the batched cases, those of the long-context case
#: (l), its caches' length and the position they are filled to, and the
#: seed of the weights, tokens and caches
SERVE_TP = dict(steps=12, long_steps=4, long_len=524288,
                long_pos=524280, seed=11)


def _serve_cases(get_config) -> dict:
    """(j)-(m): per case the full-width config (its depth cut), the mesh
    (data, model), the prompt (B rows of S tokens; S None: long context,
    batch 1, the caches filled from the seed up to
    ``SERVE_TP["long_pos"]``), the caches' length, the decode steps and
    the kernels (wrapper: launches a rank, all of the variant named) the
    mesh run launches (the others none). The batched prompts end 4
    positions before rank 1's slice of the caches (granite: 1,020 of
    1,024; deepseek: 1,024 of 1,028, its 4 x 1,024 tokens 4 whole MoE
    routing groups)."""
    import dataclasses as dc
    steps = SERVE_TP["steps"]
    g = get_config("gemma3-1b")
    return {
        "(j)": (dc.replace(get_config("granite-8b"), num_layers=2), (1, 4),
                4, 1020, 4096, steps, {"flash_attention": (2, "sm90")}),
        "(k)": (dc.replace(get_config("deepseek-v2-lite-16b"), num_layers=2),
                (1, 4), 4, 1024, 4 * 1028, steps, {}),
        "(l)": (dc.replace(g, prelude=(), num_layers=len(g.block_pattern)),
                (2, 2), 1, None, SERVE_TP["long_len"],
                SERVE_TP["long_steps"], {}),
        "(m) rwkv": (dc.replace(get_config("rwkv6-7b"), num_layers=2),
                     (1, 4), 4, 1024, 4096, steps, {"wkv6": (2, "mma")}),
        "(m) jamba": (dc.replace(get_config("jamba-v0.1-52b"), num_layers=2,
                                 block_pattern=("mamba", "mamba_moe")),
                      (1, 4), 4, 1024, 4096, steps,
                      {"selective_scan": (2 * (1 + steps), "reg")}),
    }


def serve_tp_bytes(cfg, mesh_shape: dict, B: int, S, steps: int,
                   long: bool | None = None) -> dict:
    """The payload bytes one rank gives each collective
    (``ProcessMesh.moved``) in a (j)-(m) mesh run of ``cfg`` over the
    mesh of axis sizes ``mesh_shape`` ({"data": ..., "model": ...}, and
    "pod"), B its rows: the prefill of B x S tokens (none where ``S`` is
    None) and ``steps`` decode steps, at long context where ``long``
    says (default: ``S`` None), from the shapes; activations in the
    config's dtype. Per call, T its tokens (B x S, or B):

    * the embedding's D-columns gathered (T x D/m; none for a prefill of
      frontend embeddings); the head: the
      rank's vocab columns of the B last logits gathered (B x V/m
      float32), or a tied head's partial logits psummed (B x V);
    * GQA: the new K and V of the rank's KV heads gathered (T x KV/m x
      hd each) where m divides KV, else the blocks of ``wk`` and ``wv``
      gathered (D x KV·hd/m each); decode batched: the rank's query
      heads gathered (B x H/m x hd), the row maxima pmaxed (B x H
      float32) and the outputs with their sums psummed (B x H x (hd + 1)
      float32) over model; at long context the rank's heads' partials
      over data (B x H/m, B x H/m x (hd + 1)); *g* after ``wo`` (T x D);
    * MLA decode: ``q_lat`` and ``q_rope`` gathered (B x H/m x (r +
      rope)), the combine in the latent space (B x H, B x H x (r + 1)
      float32); *g* (T x D);
    * RWKV6: each of the time mix's and channel mix's ``x_prev`` gathered
      where the caches cut it on D (B x D/n over the axis of n that cuts
      them) and their two *g* (T x D each);
    * Mamba: ``w_x``'s product psummed (T x (R + 2N)) and *g* (T x D);
    * an MLP's or an MoE's *g* (T x D), and where the batch axes split
      the rows and the reference's routing group (min(1024, the global
      batch's tokens)) spans ranks, the top-k choices gathered over them
      (T x K int32)."""
    data, m = mesh_shape["data"], mesh_shape["model"]
    n_dp = data * mesh_shape.get("pod", 1)
    long = S is None if long is None else long
    bf, f4 = (2 if cfg.dtype == "bfloat16" else 4), 4
    D, H, hd, KV = cfg.d_model, cfg.num_heads, cfg.head_dim, \
        cfg.num_kv_heads
    V = cfg.padded_vocab
    kinds = cfg.prelude + cfg.block_pattern * cfg.num_periods
    out = {"all_gather": 0, "psum": 0, "pmax": 0}

    def call(T, decode):
        if decode or cfg.frontend is None:
            out["all_gather"] += T * D // m * bf
        if cfg.tie_embeddings:
            out["psum"] += B * V * f4
        else:
            out["all_gather"] += B * V // m * f4
        for kind in kinds:
            if kind == "rwkv":
                n = data if long else m
                if D >= 1024:
                    out["all_gather"] += 2 * B * D // n * bf
                out["psum"] += 2 * T * D * bf
                continue
            if kind.startswith("mamba"):
                out["psum"] += T * (max(D // 16, 1) + 2 * cfg.mamba.d_state
                                    ) * bf
            elif kind.startswith("mla"):
                if decode:
                    r = cfg.kv_lora_rank
                    out["all_gather"] += B * H // m * (r + cfg.qk_rope_dim) \
                        * bf
                    out["pmax"] += B * H * f4
                    out["psum"] += B * H * (r + 1) * f4
            else:
                if KV % m == 0:
                    out["all_gather"] += 2 * T * KV // m * hd * bf
                else:
                    out["all_gather"] += 2 * D * KV * hd // m * bf
                if decode and long:
                    out["pmax"] += B * H // m * f4
                    out["psum"] += B * H // m * (hd + 1) * f4
                elif decode:
                    out["all_gather"] += B * H // m * hd * bf
                    out["pmax"] += B * H * f4
                    out["psum"] += B * H * (hd + 1) * f4
            out["psum"] += 2 * T * D * bf       # the mixer's g, the FFN's
            if kind.endswith("moe") and not long and n_dp > 1 and \
                    T % min(1024, T * n_dp):
                out["all_gather"] += T * cfg.moe.experts_per_token * 4
    if S is not None:
        call(B * S, False)
    for _ in range(steps):
        call(B, True)
    return out


def _mesh_serve_run(torch, cfg, mesh, params, toks, B: int, S, L: int,
               steps: int, caches=None) -> list:
    """Every step's float32 logits (the prefill's last, then each decode
    step's) of ``cfg`` on ``params`` over ``mesh`` (its blocks), or on
    one rank (``mesh`` None, whole ``params``): the prompt ``toks[:,
    :S]``, then ``steps`` decode steps fed ``toks``' next columns; at long
    context (``S`` None) only the decode steps, from ``caches`` (the
    rank's blocks, or whole), at positions from ``SERVE_TP["long_pos"]``.
    Only the real vocabulary's columns are kept."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.train.step import build_prefill_step, build_serve_step
    got = []
    if S is None:
        pos = SERVE_TP["long_pos"]
    else:
        logits, caches = build_prefill_step(cfg, L, "cuda", mesh)(
            params, {"tokens": toks[:, :S]})
        got.append(logits[..., :cfg.vocab_size].float())
        pos = S
    step = build_serve_step(cfg, ShapeConfig("serve", L, B, "decode"),
                            "cuda", mesh)
    first = 0 if S is None else S
    for t in range(steps):
        _, logits, caches = step(params, caches,
                                 toks[:, first + t:first + t + 1],
                                 torch.tensor(pos + t, dtype=torch.int32,
                                              device="cuda"))
        got.append(logits[..., :cfg.vocab_size].float())
    del caches
    return torch.stack(got)


def _long_caches(torch, cfg, gen, L: int):
    """Whole caches of batch 1 and ``L`` positions in the config's dtype,
    every KV entry up to ``SERVE_TP["long_pos"]`` drawn from ``gen``."""
    from repro_torch.models import init_cache
    from repro_torch.tree import tree_map
    caches = init_cache(cfg, 1, L, "cuda")

    def fill(t):
        n = SERVE_TP["long_pos"]
        t.narrow(-3, 0, n).copy_(torch.randn(
            t.narrow(-3, 0, n).shape, generator=gen, device="cuda"))
        return t
    return tree_map(fill, caches)


class _Routing:
    """The MoE routings of a run (``models.moe.route``'s expert choices
    and slots, call by call), while installed: ``"record"`` keeps each;
    ``"pin"`` makes each call take the recorded one in turn (with its own
    probabilities for the top-k weights), so that a token that inputs
    differing by rounding would send to another expert takes the same
    expert in every run; ``"compare"`` keeps each call's own and counts
    the (token, k) assignments that differ from the recorded ones."""

    def __init__(self):
        self.kept: list = []
        self.mode, self.i, self.changed, self.made = "record", 0, 0, 0

    def __enter__(self):
        from repro_torch.models import moe as M
        self.M, self.real = M, M.route
        M.route = self.route
        return self

    def __exit__(self, *exc):
        self.M.route = self.real

    def use(self, mode: str) -> None:
        self.mode, self.i = mode, 0

    def route(self, c, router, xg, keep_fn=None):
        probs, top_p, top_e, onehot, poh = self.real(c, router, xg, keep_fn)
        if self.mode == "record":
            self.kept.append((top_e, onehot, poh))
            return probs, top_p, top_e, onehot, poh
        e, o, p = self.kept[self.i]
        self.i += 1
        if self.mode == "compare":
            self.changed += int((e != top_e).sum())
            self.made += e.numel()
            return probs, top_p, top_e, onehot, poh
        top_p = probs.gather(-1, e)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
        return probs, top_p, e, o, p


def _rank_serve(torch, label: str, case) -> dict:
    """(j)-(m) on one rank: the case's config at full width (bf16) served
    over its mesh (``build_prefill_step`` and ``build_serve_step`` with
    ``mesh``; each rank its blocks of the parameters and caches), the
    launches of :data:`TP_KERNELS` and the bytes of that run; then, on
    rank 0 (every rank holds the same rows), the same steps on one rank
    whole in bf16 and in float32 (the float32 weights the bf16 ones
    upcast, the long caches likewise), and where the mesh run is further
    from float32 than the whole bf16 run by more than DIST_GATE by the
    largest element, the split run in float32 on every rank (the
    rounding witness). The runs after the mesh run take its MoE routing
    (:class:`_Routing`; the MoE cases (e), (g), (i) do the same), and the
    whole bf16 run once more on its own routing counts the assignments
    that bf16 rounding sends elsewhere. Rank 0 returns the errors and the
    greedy tokens' agreement; every rank its launches, bytes and
    seconds."""
    from repro_torch.distributed import ProcessMesh
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import init_params
    from repro_torch.train.step import shard_caches, shard_params
    from repro_torch.tree import tree_map
    cfg, shape, B, S, L, steps, _ = case
    mesh = ProcessMesh(MeshShape(shape, ("data", "model")), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SERVE_TP["seed"])
    params = init_params(cfg, gen, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (B, (S or 0) + steps),
                         generator=gen, device="cuda")
    whole_caches = _long_caches(torch, cfg, gen, L) if S is None else None
    blocks = tree_map(lambda t: t.clone(), shard_params(params, mesh))
    # the rank's blocks of the long caches, and a copy for the witness
    kept = None if S is not None else shard_caches(whole_caches, mesh,
                                                   long_context=True)
    if mesh.rank != 0:
        params = whole_caches = None
    _release(torch)
    with _Routing() as routing:
        return _rank_serve_runs(torch, cfg, mesh, params, blocks, toks, B,
                                S, L, steps, whole_caches, kept, routing)


def _rank_serve_runs(torch, cfg, mesh, params, blocks, toks, B, S, L,
                     steps, whole_caches, kept, routing) -> dict:
    """The runs of :func:`_rank_serve` under ``routing``."""
    from repro_torch.tree import tree_map
    every = ("data", "model")
    reset_counts()
    mesh.reset_moved()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp = _mesh_serve_run(torch, cfg, mesh, blocks, toks, B, S, L, steps,
                         None if kept is None else
                         tree_map(lambda t: t.clone(), kept))
    torch.cuda.synchronize()
    res = {"ms": (time.perf_counter() - t0) * 1e3,
           "counts": {k: n for k, n in read_counts().items()
                      if k.split("/")[0] in TP_KERNELS},
           "moved": dict(mesh.moved), "rank": mesh.rank}
    c32 = dataclasses.replace(cfg, dtype="float32")
    need = torch.zeros(1, device="cuda")
    if mesh.rank == 0:
        t1 = time.perf_counter()

        def caches(dtype=None):
            """A copy of the whole long caches (in ``dtype``), or None."""
            return None if whole_caches is None else tree_map(
                lambda t: t.to(dtype or t.dtype, copy=True), whole_caches)
        if routing.kept:
            routing.use("compare")
            _mesh_serve_run(torch, cfg, None, params, toks, B, S, L, steps,
                            caches())
            res["routing"] = {"changed": routing.changed,
                              "made": routing.made}
        routing.use("pin")
        bf = _mesh_serve_run(torch, cfg, None, params, toks, B, S, L,
                             steps, caches())
        p32 = tree_map(lambda t: t.float(), params)
        del params
        routing.use("pin")
        f32 = _mesh_serve_run(torch, c32, None, p32, toks, B, S, L, steps,
                              caches(torch.float32))
        del p32
        res["whole_s"] = time.perf_counter() - t1
        res["tp_f32"] = {"max": _rel(tp, f32), "l2": _rel_l2(tp, f32)}
        res["bf16_f32"] = {"max": _rel(bf, f32), "l2": _rel_l2(bf, f32)}
        res["tp_bf16"] = {"max": _rel(tp, bf), "l2": _rel_l2(tp, bf)}
        # greedy tokens wherever the whole bf16 run's top-2 gap exceeds
        # the gate over the row's largest magnitude
        top = bf.topk(2, dim=-1).values
        sure = (top[..., 0] - top[..., 1]) > DIST_GATE * bf.abs().amax(-1)
        same = tp.argmax(-1) == bf.argmax(-1)
        res["tokens"] = {"checked": int(sure.sum()),
                         "of": int(sure.numel()),
                         "differ": int((sure & ~same).sum())}
        need += float(res["tp_f32"]["max"] > res["bf16_f32"]["max"]
                      + DIST_GATE)
        _release(torch)
    if float(mesh.all_reduce(need, every)[0]):
        # the witness: the same split in float32 against the whole
        # float32 run (every rank runs the split; rank 0 compares)
        b32 = tree_map(lambda t: t.float(), blocks)
        c_w = None if kept is None else tree_map(lambda t: t.float(), kept)
        routing.use("pin")
        s32 = _mesh_serve_run(torch, c32, mesh, b32, toks, B, S, L, steps,
                              c_w)
        if mesh.rank == 0:
            res["split32"] = _rel(s32, f32)
        del b32, s32, c_w
    mesh.all_reduce(torch.zeros(1, device="cuda"), every)
    del blocks, tp, kept
    return res


def _local_sums(torch, tree) -> list:
    from repro_torch.tree import tree_flatten
    return [float(t.double().sum()) for t in tree_flatten(tree)[0]]


def rank_distributed(torch, work: Path, layers: int) -> None:
    """One rank of the ``distributed`` phase (``chip_smoke.py --rank-body
    distributed WORK LAYERS``, 4 ranks sharing the card over gloo): (a),
    (c), then (b): ``launch.train``'s body at ``layers`` layers over the
    (pod 2, data 2, model 1) mesh, its checkpoint written by rank 0.
    Prints its results as a ``DIST_JSON:`` line."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.distributed import ProcessMesh, process_group
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import mesh_over
    from repro_torch.launch.train import train
    from repro_torch.models import loss_fn
    count_kernels()
    res: dict = {}
    # the flash library's first call in a process (seconds) while the
    # process group starts: a tiny forward, its launch not counted
    warm = threading.Thread(target=lambda: ops.flash_attention(
        *(torch.zeros((1, 128, 8, 128), dtype=torch.bfloat16,
                      device="cuda"),) * 3, causal=True))
    warm.start()
    with process_group("cuda") as backend:
        warm.join()
        res["backend"] = backend
        mesh = ProcessMesh(mesh_over(DIST["ranks"], pod=DIST["pods"]), "cuda")
        res["rank"], res["coords"] = mesh.rank, mesh.coords
        t0 = time.perf_counter()
        res["pipeline"] = _rank_pipeline(torch, mesh)
        _release(torch)
        t1 = time.perf_counter()
        cfg = dataclasses.replace(get_config("granite-8b"), num_layers=layers)
        dc = DataConfig(batch_size=DIST["batch"], seq_len=DIST["seq"],
                        vocab_size=cfg.vocab_size, seed=DIST["seed"])
        local = {k: torch.as_tensor(v, device="cuda")
                 for k, v in make_batch(dc, 0).items()}
        # (c) on the tree of one layer (embedding, head and a block)
        res["compression"] = _rank_compression(
            torch, mesh, dataclasses.replace(cfg, num_layers=1), local)
        _release(torch)
        # the one-rank loss of the first step: the global batch on rank 0
        whole = {k: mesh.all_gather(v, ("pod", "data"), 0)
                 for k, v in local.items()}
        if mesh.rank == 0:
            from repro_torch.models import init_params
            with torch.no_grad():
                p = init_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(DIST["seed"]), "cuda")
                res["one_rank_loss"] = float(loss_fn(cfg, p, whole)[0])
                del p
        del whole, local
        _release(torch)
        if mesh.rank == 0:      # the restore ranks may start their contexts
            (work / "train_started").touch()
        t2 = time.perf_counter()
        reset_counts()
        mesh.reset_moved()
        torch.cuda.reset_peak_memory_stats()
        loop = train(cfg, steps=DIST["steps"], batch=DIST["batch"],
                     seq=DIST["seq"], lr=DIST["lr"], remat="full",
                     seed=DIST["seed"], device="cuda", log_every=1,
                     mesh=mesh)
        torch.cuda.synchronize()
        res["train"] = {
            "counts": read_counts(), "moved": dict(mesh.moved),
            "collective_s": dict(mesh.seconds),
            "staged": mesh.staged_bytes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": [h["loss"] for h in loop.state.history],
            "ms": [h["time"] * 1e3 for h in loop.state.history],
            "skipped": loop.state.skipped}
        t3 = time.perf_counter()
        ck = CheckpointManager(str(work / "ckpt"))
        ck.save(DIST["steps"], {"params": loop.params,
                                "opt": loop.opt_state},
                extra={"step": DIST["steps"]}, shardings=loop.shardings)
        res["sums"] = _local_sums(torch, {"params": loop.params,
                                          "opt": loop.opt_state})
        del loop
        _release(torch)
        seconds = {"pipeline": t1 - t0, "compression": t2 - t1,
                   "train": t3 - t2, "checkpoint": time.perf_counter() - t3}
        res["tp"] = {}
        for label, (c, _, chained) in _tp_cases(get_config).items():
            t4 = time.perf_counter()
            res["tp"][label] = _rank_tensor_parallel(torch, c, chained)
            _release(torch)
            seconds[label] = time.perf_counter() - t4
        res["serve"] = {}
        for label, case in _serve_cases(get_config).items():
            t5 = time.perf_counter()
            res["serve"][label] = _rank_serve(torch, label, case)
            _release(torch)
            seconds[label] = time.perf_counter() - t5
        t6 = time.perf_counter()
        res["tp_train"] = _rank_model_parallel_train(torch, layers)
        res["seconds"] = dict(seconds, **{"(f)": time.perf_counter() - t6})
    print(DIST_MARK + json.dumps(res), flush=True)


def rank_restore(torch, work: Path, layers: int) -> None:
    """One rank of the elastic restore (``--rank-body restore``, 2 ranks):
    the checkpoint of 4 ranks into the ZeRO-1 layout of the (data 2,
    model 1) mesh; prints each leaf's local sum as a ``DIST_JSON:``
    line."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import ProcessMesh, process_group
    from repro_torch.launch.mesh import mesh_over
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig
    from repro_torch.train.step import init_zero1_state, train_state_shardings
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=layers)
    # started with the 4 ranks: no CUDA context before their (b) starts,
    # so that the 6 processes do not start their contexts at once
    while not (work / "train_started").exists():
        time.sleep(0.2)
    with process_group("cuda"):
        mesh = ProcessMesh(mesh_over(DIST["restore_ranks"]), "cuda")
        # started with the 4 ranks: wait for their checkpoint (renamed
        # into place whole), or for the parent to end this rank; the
        # card holds nothing of this rank's meanwhile
        ck = CheckpointManager(str(work / "ckpt"))
        while ck.latest_step() != DIST["steps"]:
            time.sleep(0.2)
        t0 = time.perf_counter()
        p = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
        o = init_zero1_state(AdamWConfig(), p, mesh)
        tree = {"params": p, "opt": o}
        _, extra = ck.restore(tree,
                              shardings=train_state_shardings(p, o, mesh))
        res = {"rank": mesh.rank, "coords": mesh.coords, "extra": extra,
               "sums": _local_sums(torch, tree),
               "seconds": time.perf_counter() - t0}
    print(DIST_MARK + json.dumps(res), flush=True)


def _dist_json(out: str, label: str) -> dict:
    for line in reversed(out.splitlines()):
        if line.startswith(DIST_MARK):
            return json.loads(line[len(DIST_MARK):])
    raise AssertionError(f"{label}: no {DIST_MARK} line in {out[-2000:]}")


def _distributed_start(work: Path, layers: int):
    """Start the 4 ranks of the phase (:func:`rank_distributed`) and the
    2 that restore their checkpoint (:func:`rank_restore`, which start
    their contexts meanwhile and wait for it); returns what
    :func:`_distributed_check` takes."""
    from repro_torch.conformance.subproc import start_ranks, stop_ranks
    me = str(Path(__file__).resolve())
    ranks = start_ranks([me, "--rank-body", "distributed", str(work),
                         str(layers)], DIST["ranks"])
    try:
        restore = start_ranks([me, "--rank-body", "restore", str(work),
                               str(layers)], DIST["restore_ranks"])
    except BaseException:
        stop_ranks(ranks)
        raise
    return ranks, restore, work, layers, time.perf_counter()


def _distributed_check(torch, started, card: str) -> dict:
    """Wait for the 4 ranks, hold their results to the gates, restore
    their checkpoint onto 2 ranks, and log the figures. Returns the
    launches a rank by wrapper and case ((a), (b), (d)-(f), (h), (i);
    :func:`_tensor_parallel_check`), (g)'s under ``"mla"``."""
    from repro_torch.conformance.subproc import stop_ranks, wait_ranks
    launch, restore, work, layers, t0 = started
    try:
        outs = wait_ranks(launch, timeout=600)
    except BaseException:
        stop_ranks(restore)
        raise
    ran_s = time.perf_counter() - t0
    res = [_dist_json(o, f"distributed rank {r}") for r, o in enumerate(outs)]
    M, P_ = DIST["micro"], DIST["ranks"]
    T = M + P_ - 1
    steps = DIST["steps"]
    log(f"distributed: {P_} ranks over {res[0]['backend']} sharing "
        f"{torch.cuda.get_device_name(0)} ({card}); each rank its own CUDA "
        f"context; every payload staged through host memory; the ranks "
        f"ran {ran_s:.1f} s from their start, stages "
        + "; ".join(f"rank {r['rank']} " + ", ".join(
            f"{k} {v:.1f} s" for k, v in r["seconds"].items())
            for r in res))
    for r in res:
        pl, tr, co = r["pipeline"], r["train"], r["compression"]
        want_a = {"flash_attention": T, "flash_attention/sm90": T,
                  "flash_attention/fma": 0, "flash_attention_bwd": T,
                  "flash_attention_bwd/sm90": T}
        got_a = {k: pl["counts"][k] for k in want_a}
        assert got_a == want_a, f"distributed (a) rank {r['rank']}: " \
            f"launches {got_a}, want {want_a}"
        want_b = {"flash_attention": 2 * layers * steps,
                  "flash_attention/sm90": 2 * layers * steps,
                  "flash_attention/fma": 0,
                  "flash_attention_bwd": layers * steps,
                  "flash_attention_bwd/sm90": layers * steps}
        got_b = {k: tr["counts"][k] for k in want_b}
        assert got_b == want_b, f"distributed (b) rank {r['rank']}: " \
            f"launches {got_b}, want {want_b}"
        assert max(pl["errs"].values()) <= DIST_GATE, \
            f"distributed (a) rank {r['rank']}: {pl['errs']}"
        assert len(tr["losses"]) == steps and tr["skipped"] == 0 and all(
            math.isfinite(x) for x in tr["losses"]), f"distributed (b): {tr}"
        assert co["worst"]["rel"] is None or \
            co["worst"]["rel"] < COMPRESSION_BOUND, \
            f"distributed (c) rank {r['rank']}: {co['worst']}"
        assert co["worst"]["feedback"] <= 2 and \
            co["worst"]["residual"] <= 0.5 * (1 + 1e-5), \
            f"distributed (c) rank {r['rank']}: {co['worst']}"
        log(f"distributed (a) rank {r['rank']}: pipeline_apply over 4 "
            f"stages of one granite-8b block (bf16), {M} microbatches of "
            f"(1, {DIST['seq']}), {T} ticks: forward "
            f"{pl['ms']['forward']:.1f} ms and backward "
            f"{pl['ms']['backward']:.1f} ms after one block's cold start "
            f"({pl['ms']['cold']:.1f} ms) (host-staged transport on a "
            f"shared card: no measure of NVLink or NCCL); launches {got_a}; "
            f"largest error "
            f"against the 4 blocks on one rank / max |leaf|: out "
            f"{pl['errs']['out']:.3g}, loss {pl['errs']['loss']:.3g}, "
            f"grad {pl['errs']['grad']:.3g} (gate {DIST_GATE:.4g}); bytes "
            f"moved {pl['moved']}")
        log(f"distributed (b) rank {r['rank']} {r['coords']}: launch.train "
            f"granite-8b at {layers} layers, global batch {DIST['batch']} x "
            f"{DIST['seq']}, losses ["
            f"{', '.join(f'{x:.6f}' for x in tr['losses'])}], "
            f"step ms [{', '.join(f'{x:.1f}' for x in tr['ms'])}] "
            f"(host-staged transport on a shared card: no measure of NVLink "
            f"or NCCL); bytes a step by collective "
            f"{ {k: v // steps for k, v in tr['moved'].items()} } in "
            f"{ {k: round(v / steps, 3) for k, v in tr['collective_s']
                 .items()} } s, staged through the host "
            f"{tr['staged'] // steps} a step; "
            f"launches "
            f"{got_b}; max_memory_allocated {tr['peak_gb']:.2f} GB")
        log(f"distributed (c) rank {r['rank']}: make_compressed_psum over "
            f"pod on the first gradient tree ({co['elements']} elements): "
            f"worst leaf |mean - exact| / max |exact| "
            + ("- (checked on the pod-0 rank)" if co["worst"]["rel"] is None
               else f"{co['worst']['rel']:.4g} (bound {COMPRESSION_BOUND})")
            + f"; "
            f"residual + dequantized - input at most "
            f"{co['worst']['feedback']:.3g} ulp of the scale, |residual| at "
            f"most {co['worst']['residual']:.3g} scale; bytes {co['moved']}")
    tp_launches = _tensor_parallel_check(res, layers, card)
    for name, n in _serve_check(res, card).items():
        tp_launches[name]["serve_tensor_parallel"] = n
    checked = [r for r in res if r["compression"]["worst"]["rel"] is not None]
    assert len(checked) == P_ // DIST["pods"], \
        f"distributed (c): the exact mean checked on {len(checked)} ranks"
    first = [r["train"]["losses"][0] for r in res]
    one = res[0]["one_rank_loss"]
    log(f"distributed (b): first loss {first[0]:.6f} on every rank "
        f"{len(set(first)) == 1}; the one-rank loss on the global batch "
        f"{one:.6f}; difference {abs(first[0] - one):.3g} (gate "
        f"{DIST_LOSS_GATE})")
    assert len(set(first)) == 1, f"distributed (b): first losses {first}"
    assert abs(first[0] - one) <= DIST_LOSS_GATE, \
        f"distributed (b): first loss {first[0]} against one rank {one}"
    # the checkpoint of 4 ranks restored onto 2
    back = [_dist_json(o, f"restore rank {r}") for r, o in enumerate(
        wait_ranks(restore, timeout=300))]
    for b in back:
        # the same ZeRO-1 blocks as the saving rank with this data index
        saved = next(r for r in res if r["coords"]["data"] ==
                     b["coords"]["data"] and r["coords"]["pod"] == 0)
        assert b["extra"] == {"step": steps}, b["extra"]
        assert b["sums"] == saved["sums"], \
            f"restore rank {b['rank']}: leaves differ from rank " \
            f"{saved['rank']}'s"
    log(f"distributed: the checkpoint of {P_} ranks (rank 0 wrote it) "
        f"restored onto {DIST['restore_ranks']} ranks (started with the 4) "
        f"in {max(b['seconds'] for b in back):.1f} s, ended "
        f"{time.perf_counter() - t0:.1f} s after the start: every rank's "
        f"{len(back[0]['sums'])} leaves equal to the saving rank's blocks; "
        f"{card}")
    tp_launches["flash_attention"].update(pipeline=T,
                                          train=2 * layers * steps)
    tp_launches["flash_attention_bwd"].update(pipeline=T,
                                              train=layers * steps)
    return tp_launches


def _tensor_parallel_check(res: list, layers: int, card: str) -> dict:
    """Hold the ranks' (d)-(i) to their gates and log them; returns their
    launches a rank: by wrapper and case, and under ``"mla"`` by wrapper
    (g)'s, whose attention runs at (192, 128)."""
    from repro_torch.configs import get_config
    steps, tm_ = TP["train_steps"], TP["train_model"]
    cases = _tp_cases(get_config)
    f_want = {"flash_attention": 2 * layers * steps,
              "flash_attention/sm90": 2 * layers * steps,
              "flash_attention/fma": 0,
              "flash_attention_bwd": layers * steps,
              "flash_attention_bwd/sm90": layers * steps}

    def errs_text(case):
        return "; ".join(
            f"{name}: out {case[k]['out']:.4g} (L2 {case[k]['out_l2']:.4g}), "
            f"loss {case[k]['loss']:.3g}, grad max {max(case[k]['grad']):.4g}"
            f" (L2 {max(case[k]['grad_l2']):.4g})"
            for k, name in (("tp_f32", "tensor parallel against float32"),
                            ("bf16_f32", "whole bf16 against float32"),
                            ("tp_bf16", "tensor parallel against whole "
                                        "bf16")))
    what = {"(d)": "full-width granite-8b blocks, 8 query and 2 KV heads of "
                   "128 a rank",
            "(e)": "full-width mixtral-8x7b layer, 2 experts a rank",
            "(g)": "full-width deepseek-v2-lite-16b layers (its mla prelude "
                   "layer and an mla_moe layer), 4 heads at (192, 128) and "
                   "16 of 64 experts a rank",
            "(h)": "full-width rwkv6-7b layers, 16 of 64 heads a rank",
            "(i)": "full-width jamba-v0.1-52b blocks (mamba, mamba_moe), "
                   "2048 of 8192 channels and 4 of 16 experts a rank"}
    failed: list = []        # every case is logged before any gate fails
    for r in res:
        f = r["tp_train"]
        got = {k: f["counts"][k] for k in f_want}
        assert got == f_want, f"distributed (f) rank {r['rank']}: " \
            f"launches {got}, want {f_want}"
        for label, (c, kernels, _) in cases.items():
            case = r["tp"][label]
            w = _launch_want(kernels)
            got = {k: case["counts"].get(k, 0) for k in w}
            if got != w:
                failed.append(f"distributed {label} rank {r['rank']}: "
                              f"launches {got}, want {w}")
            # each quantity of the tensor-parallel run as close to the
            # float32 run as the whole bf16 run is, within DIST_GATE: two
            # bf16 runs that round differently sit a bf16 rounding
            # distance apart, the whole run's own distance from float32;
            # by the largest element's error and by the relative L2 one
            tp_, bf, s32 = case["tp_f32"], case["bf16_f32"], case["split32"]
            names = ["out"] + case["leaves"]
            big = list(zip(names, [tp_["out"]] + tp_["grad"],
                           [bf["out"]] + bf["grad"]))
            l2 = list(zip(names, [tp_["out_l2"]] + tp_["grad_l2"],
                          [bf["out_l2"]] + bf["grad_l2"]))
            over = [q for q in big if q[1] > q[2] + DIST_GATE]
            # side by side, a quantity over the gate by its largest
            # element is held by the witness that its gap is bf16
            # rounding: the same split in float32 within TP32_GATE of the
            # whole float32 run (the split computes the same function),
            # its L2 error within the gate (below) and its largest
            # element's within TP_ROUNDING times the whole run's
            # (PERF.md §6)
            witnessed = [q for q in over if s32.get(q[0], 1.0) <= TP32_GATE
                         and q[1] <= TP_ROUNDING * q[2]]
            worse = [q for q in over if q not in witnessed] + [
                (k + " L2", a_, b_) for k, a_, b_ in l2
                if a_ > b_ + DIST_GATE]
            if tp_["loss"] > bf["loss"] + DIST_GATE:
                worse.append(("loss", tp_["loss"], bf["loss"]))
            if worse:
                failed.append(f"distributed {label} rank {r['rank']}: "
                              f"further from float32 than the whole bf16 "
                              f"run by more than {DIST_GATE} (quantity, "
                              f"tensor parallel, whole): {worse}; the "
                              f"float32 split {s32}")
            gap = max(big, key=lambda q: q[1] - q[2])
            gap_l2 = max(l2, key=lambda q: q[1] - q[2])
            text = (f"; the largest gaps, leaf by leaf (tensor parallel - "
                    f"whole bf16, against float32): {gap[0]} {gap[1]:.5f} "
                    f"- {gap[2]:.5f} = {gap[1] - gap[2]:.5f}, by L2 "
                    f"{gap_l2[0]} {gap_l2[1]:.5f} - {gap_l2[2]:.5f} = "
                    f"{gap_l2[1] - gap_l2[2]:.5f}; over {DIST_GATE:.4g} by "
                    f"the largest element and held by the rounding "
                    f"witness (its float32 split against the whole float32 "
                    f"run, gate {TP32_GATE}): " + (", ".join(
                        f"{k} {a_:.5f} - {b_:.5f} (float32 split "
                        f"{s32[k]:.3g})" for k, a_, b_ in witnessed)
                        or "none"))
            for name, ex in (case["experts"] or {}).items():
                i = case["leaves"].index(name)
                if tp_["grad"][i] - bf["grad"][i] < DIST_GATE / 2:
                    continue
                e = max(range(len(ex["tp"])), key=lambda j: ex["tp"][j])
                text += (f"; {name}: tokens kept a rank expert "
                         f"{min(ex['tokens'])}-{max(ex['tokens'])}, the "
                         f"largest error in expert {e} ({ex['tokens'][e]} "
                         f"tokens): tensor parallel {ex['tp'][e]:.5f}, "
                         f"whole bf16 {ex['bf16'][e]:.5f}")
            psum = _tp_psum_bytes(c, TP["seq"])
            if case["moved"] != {"psum": psum}:
                failed.append(f"distributed {label} rank {r['rank']}: moved "
                              f"{case['moved']}, the count from the shapes "
                              f"{psum}")
            if "aux" in case:
                kinds = c.prelude + c.block_pattern * c.num_periods
                made = TP["seq"] * c.moe.experts_per_token * sum(
                    k.endswith("moe") for k in kinds)
                # on the same routing the dropped share is the same and
                # aux within the gate; the whole layer's own routing, by
                # the same gate
                aux, drop, own = case["aux"], case["dropped"], case["own"]
                aux_err = abs(aux["tp"] - aux["bf16"]) / abs(aux["bf16"])
                own_err = abs(aux["tp"] - own["aux"]) / abs(own["aux"])
                if not (aux_err <= DIST_GATE and drop["tp"] == drop["bf16"]
                        and own_err <= DIST_GATE and
                        abs(drop["tp"] - own["dropped"]) <= DIST_GATE):
                    failed.append(f"distributed {label} rank {r['rank']}: "
                                  f"aux {aux}, dropped {drop}, the whole "
                                  f"layers' own routing {own}")
                text += (f"; the whole runs on the tensor-parallel run's "
                        f"routing: aux {aux['tp']:.7f}, whole bf16 "
                        f"{aux['bf16']:.7f} (relative {aux_err:.3g}), "
                        f"float32 {aux['f32']:.7f}; dropped share "
                        f"{drop['tp']:.6f}, whole bf16 {drop['bf16']:.6f}; "
                        f"the whole bf16 layers on their own routing: aux "
                        f"{own['aux']:.7f} (relative {own_err:.3g}), dropped "
                        f"share {own['dropped']:.6f}, {own['changed']} of "
                        f"{made} (token, k) assignments to another expert")
            log(f"distributed {label} rank {r['rank']}: {case['blocks']} "
                f"{what[label]} (bf16, (1, {TP['seq']})) over (data 1, "
                f"model {DIST['ranks']}), forward and backward "
                f"{case['ms']:.1f} ms (blocks "
                f"{'chained' if case['chained'] else 'side by side'}; "
                f"host-staged transport on a shared card); launches "
                f"{ {k: n for k, n in case['counts'].items() if n} }; "
                f"bytes {case['moved']} (all-reduce: the count from the "
                f"shapes {psum}); "
                f"largest error / max |leaf| (relative L2): "
                f"{errs_text(case)} (gate: each error of the tensor "
                f"parallel run, the largest element's and the relative L2, "
                f"within {DIST_GATE:.4g} of the whole bf16 run's){text}; "
                f"shard kinds {case['kinds']}")
        assert len(f["losses"]) == steps and f["skipped"] == 0 and all(
            math.isfinite(x) for x in f["losses"]), f"distributed (f): {f}"
        log(f"distributed (f) rank {r['rank']} {f['mesh']}: launch.train "
            f"granite-8b at {layers} layers, model-parallel {tm_}, global "
            f"batch {DIST['batch']} x {DIST['seq']}, losses ["
            f"{', '.join(f'{x:.6f}' for x in f['losses'])}], step ms ["
            f"{', '.join(f'{x:.1f}' for x in f['ms'])}]; bytes a step "
            f"{ {k: v // steps for k, v in f['moved'].items()} } in "
            f"{ {k: round(v / steps, 3) for k, v in f['collective_s'].items()} }"
            f" s; max_memory_allocated {f['peak_gb']:.2f} GB")
    assert not failed, "\n".join(failed)
    first = [r["tp_train"]["losses"][0] for r in res]
    one = res[0]["tp_train"]["one_rank_loss"]
    log(f"distributed (f): first loss {first[0]:.6f} on every rank "
        f"{len(set(first)) == 1}; the one-rank loss on the global batch "
        f"{one:.6f}; difference {abs(first[0] - one):.3g} (gate "
        f"{DIST_LOSS_GATE}); {card}")
    assert len(set(first)) == 1, f"distributed (f): first losses {first}"
    assert abs(first[0] - one) <= DIST_LOSS_GATE, \
        f"distributed (f): first loss {first[0]} against one rank {one}"
    out: dict = {name: {} for name in TP_KERNELS + ("mla",)}
    names = {"(d)": "tensor_parallel_blocks", "(e)": "tensor_parallel_moe",
             "(h)": "tensor_parallel_rwkv", "(i)": "tensor_parallel_mamba"}
    for label, (_, kernels, _) in cases.items():
        for name, (n, _) in kernels.items():
            if label == "(g)":
                out["mla"][name] = n
            else:
                out[name][names[label]] = n
    out["flash_attention"]["tensor_parallel_train"] = 2 * layers * steps
    out["flash_attention_bwd"]["tensor_parallel_train"] = layers * steps
    return out


def _launch_want(kernels: dict) -> dict:
    """The launches a rank of a case must count: ``kernels`` (wrapper:
    (launches, variant)), 0 of every other wrapper of TP_KERNELS and of
    the fma flash kernels."""
    out = dict.fromkeys(TP_KERNELS, 0)
    out.update({"flash_attention/fma": 0, "flash_attention_bwd/fma": 0})
    for name, (n, variant) in kernels.items():
        out[name] = out[f"{name}/{variant}"] = n
    return out


def _serve_check(res: list, card: str) -> dict:
    """Hold the ranks' (j)-(m) to their gates and log them: on every rank
    the launches and the collective bytes (:func:`serve_tp_bytes`); on
    rank 0 the logits of the mesh run against the whole float32 run
    within DIST_GATE of the whole bf16 run's error, by the largest
    element (or, over it, held by the rounding witness: the float32
    split within TP32_GATE of the whole float32 run and the error within
    TP_ROUNDING times the whole bf16 run's) and by the relative L2 error,
    and the greedy tokens equal wherever the whole bf16 run's top-2 gap
    exceeds the gate. Returns the launches a rank by wrapper, over the
    cases."""
    from repro_torch.configs import get_config
    what = {"(j)": "2 granite-8b layers, prefill of 4 x 1020 into caches "
                   "of 4096 (1024 positions a rank), 8 of 32 query heads "
                   "a rank",
            "(k)": "deepseek-v2-lite-16b's mla and mla_moe layers, prefill "
                   "of 4 x 1024 into caches of 4112 (1028 a rank), "
                   "absorbed",
            "(l)": "a gemma3-1b period (5 local layers of window 1024, 1 "
                   "global) at long_500k: batch 1, caches of 524288 "
                   "filled from the seed to 524280, the sequence over "
                   "data (262144 a rank), 2 of 4 heads a rank",
            "(m) rwkv": "2 rwkv6-7b layers, prefill of 4 x 1024, 16 of 64 "
                        "heads a rank",
            "(m) jamba": "a jamba-v0.1-52b mamba and mamba_moe pair, "
                         "prefill of 4 x 1024, 2048 of 8192 channels and 4 "
                         "of 16 experts a rank"}
    failed, launches = [], {}
    for label, (cfg, shape, B, S, L, steps, kernels) in \
            _serve_cases(get_config).items():
        want = _launch_want(kernels)
        moved = serve_tp_bytes(cfg, dict(zip(("data", "model"), shape)), B,
                               S, steps)
        for r in res:
            case = r["serve"][label]
            got = {k: case["counts"].get(k, 0) for k in want}
            if got != want:
                failed.append(f"distributed {label} rank {r['rank']}: "
                              f"launches {got}, want {want}")
            if {k: v for k, v in case["moved"].items() if v} != \
                    {k: v for k, v in moved.items() if v}:
                failed.append(f"distributed {label} rank {r['rank']}: "
                              f"moved {case['moved']}, the count from the "
                              f"shapes {moved}")
        for name, (n, _) in kernels.items():
            launches[name] = launches.get(name, 0) + n
        case = res[0]["serve"][label]
        tp_, bf, tok = case["tp_f32"], case["bf16_f32"], case["tokens"]
        over = tp_["max"] > bf["max"] + DIST_GATE
        witnessed = over and case.get("split32", 1.0) <= TP32_GATE and \
            tp_["max"] <= TP_ROUNDING * bf["max"]
        if (over and not witnessed) or tp_["l2"] > bf["l2"] + DIST_GATE \
                or tok["differ"]:
            failed.append(f"distributed {label}: logits against float32 "
                          f"{tp_}, the whole bf16 run's {bf}, the float32 "
                          f"split {case.get('split32')}; greedy tokens "
                          f"{tok}")
        log(f"distributed {label}: {what[label]} (bf16) over (data "
            f"{shape[0]}, model {shape[1]}), {steps} decode steps: the mesh "
            f"run {case['ms']:.1f} ms on rank 0 (host-staged transport on a "
            f"shared card), the whole bf16 and float32 runs "
            f"{case['whole_s']:.1f} s; launches "
            f"{ {k: n for k, n in case['counts'].items() if n} }; bytes "
            f"{case['moved']} (the count from the shapes {moved}); logits' "
            f"largest error / max |logit| (relative L2) against float32: "
            f"mesh {tp_['max']:.4g} ({tp_['l2']:.4g}), whole bf16 "
            f"{bf['max']:.4g} ({bf['l2']:.4g}), mesh against whole bf16 "
            f"{case['tp_bf16']['max']:.4g} ({case['tp_bf16']['l2']:.4g}) "
            f"(gate: within {DIST_GATE:.4g} of the whole bf16 run's"
            + (f"; over it by the largest element and held by the rounding "
               f"witness, the float32 split {case['split32']:.3g} against "
               f"the whole float32 run" if witnessed else "")
            + ")" + (f"; the mesh run's routing taken by the whole runs; on "
                     f"its own the whole bf16 run sends "
                     f"{case['routing']['changed']} of "
                     f"{case['routing']['made']} (token, k) assignments to "
                     f"another expert" if "routing" in case else "")
            + f"; greedy tokens equal at {tok['checked']} of {tok['of']} "
            f"(step, row) where the top-2 gap exceeds the gate, "
            f"{tok['differ']} differ; the case "
            + ", ".join(f"rank {r['rank']} {r['seconds'][label]:.1f} s"
                        for r in res) + f"; {card}")
    assert not failed, "\n".join(failed)
    return launches


def _distributed_depth(torch, cfg, measured: dict | None) -> int:
    """(b)'s depth: the AdamW step's arithmetic of the launch_train phase
    (measured here when that phase did not run) under 90% of the card
    shared by the 4 ranks. A rank holds less than that step (ZeRO-1: half
    of master, mu and nu), so the cut errs on the safe side."""
    if measured is None:
        from repro_torch.models import init_params
        from repro_torch.train import (AdamWConfig, build_train_step,
                                       init_state)
        ocfg = AdamWConfig(lr=DIST["lr"])
        batch = {"tokens": np.zeros((1, DIST["seq"]), np.int32),
                 "targets": np.zeros((1, DIST["seq"]), np.int32)}

        def adamw_step(c):
            p = init_params(c, torch.Generator(device="cuda").manual_seed(1),
                            "cuda")
            o = init_state(ocfg, p)
            st = build_train_step(c, ocfg, remat_policy="full",
                                  device="cuda")
            return p, lambda: st(p, o, batch)
        measured = {}
        fit_depth(torch, cfg, "distributed", adamw_step, "8P (AdamW, remat "
                  "full)", measured=measured)
    return depth_within(torch, cfg, "distributed (b) depth", measured,
                        0.9 / DIST["ranks"])


def phase_distributed(torch, card: str, layers: int) -> dict:
    """The collective parts over 4 ranks sharing the card (gloo, host
    staging): (a) ``pipeline_apply`` at full width, (b) ``launch.train``
    over (pod 2, data 2) with ZeRO-1 and rank-0 checkpoints, restored
    onto 2 ranks, (c) ``make_compressed_psum`` over ``pod``. Run alone;
    with the dryrun phase it runs beside that phase's cells."""
    from repro_torch.conformance.subproc import stop_ranks
    with tempfile.TemporaryDirectory() as tmp:
        started = _distributed_start(Path(tmp), layers)
        try:
            return _distributed_check(torch, started, card)
        finally:
            stop_ranks(started[0])
            stop_ranks(started[1])


PHASES = ("build", "kernels", "rwkv_kernels", "serve",
          "token_equality", "rwkv_generate", "rwkv_equality", "plan",
          "plan_execute", "plan_serve", "conformance_serving",
          "train_kernels", "train",
          "calibrate", "rwkv_train_kernels", "rwkv_train", "launch_train",
          "mixtral_serve", "mixtral_train", "wide_head_kernels",
          "deepseek_serve", "deepseek_train", "dense_configs",
          "ssm_kernels", "jamba_serve", "jamba_train", "hubert",
          "internvl", "distributed", "dryrun")


class _Timed:
    """Logs a phase's seconds when its block ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        log(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all)")
    ap.add_argument("--tp-seed", type=int, default=TP["seed"],
                    help="the seed of the tensor-parallel cases' weights "
                    "and tokens (default %(default)s)")
    ap.add_argument("--rank-body", nargs=3, metavar=("BODY", "WORK",
                                                     "LAYERS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_body:
        # one rank of the distributed phase, started by that phase
        import torch
        sys.path.insert(0, str(ROOT / "src"))
        body, work, layers = args.rank_body
        {"distributed": rank_distributed, "restore": rank_restore}[body](
            torch, Path(work), int(layers))
        return 0
    phases = args.phases.split(",")
    os.environ[TP_SEED_ENV] = str(args.tp_seed)      # read by the ranks
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; known: {', '.join(PHASES)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import ops, ref
        from repro_torch.kernels.rwkv6 import ops as rops
        from repro_torch.kernels.rwkv6 import ref as rref
        from repro_torch.kernels.ssm import ops as sops
        from repro_torch.kernels.ssm import ref as sref
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    count_kernels()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    card = phase_card()
    priced = None
    if "build" in phases:
        with _Timed("build"), ThreadPoolExecutor(1) as pool:
            # the dryrun phase's priced peaks trace on fake CPU tensors
            # while nvcc runs, joined before any kernel does
            pricing = pool.submit(_dryrun_priced, torch, "cpu") \
                if "dryrun" in phases else None
            phase_build({"flash_attention": ops, "rwkv6": rops,
                         "ssm": sops}, build)
            priced = pricing.result() if pricing else None
            if priced:
                log("build: beside it, the dryrun phase's priced peaks "
                    + ", ".join(f"{p} {b / 2**30:.3f} GiB"
                                for p, b in priced.items()))
    record = rwkv_record = None
    if "kernels" in phases:
        with _Timed("kernels"):
            record = phase_kernels(torch, ops, ref)
        log(f"kernels: the sm90 forward at granite's prefill shape "
            f"{record['ms']:.4f} ms; before it was templated on (DQK, DV): "
            f"{GRANITE_EARLIER_MS[0]} ms")
    if "rwkv_kernels" in phases:
        with _Timed("rwkv_kernels"):
            rwkv_record = phase_rwkv_kernels(torch, rops, rref)
    cfg = get_config("granite-8b")
    if "serve" in phases:
        with _Timed("serve"):
            launches = phase_serve(torch, ops, cfg)
        if record is not None:
            record["launches"] = launches["flash_attention"]
            record["variant_launches"] = {
                v: launches[f"flash_attention/{v}"] for v in ops.VARIANTS}
    if "token_equality" in phases:
        with _Timed("token_equality"):
            phase_token_equality(torch, cfg)
    rcfg = get_config("rwkv6-7b")
    if "rwkv_generate" in phases:
        with _Timed("rwkv_generate"):
            rwkv_launches = phase_rwkv_generate(torch, rcfg)
        if rwkv_record is not None:
            rwkv_record["launches"] = rwkv_launches["wkv6"]
            rwkv_record["variant_launches"] = {
                v: rwkv_launches[f"wkv6/{v}"] for v in rops.VARIANTS}
    if "rwkv_equality" in phases:
        with _Timed("rwkv_equality"):
            phase_rwkv_equality(torch, rcfg)
    with tempfile.TemporaryDirectory() as tmp:
        # the plan phase saves the plan here; plan_serve serves it
        work = Path(tmp)
        plan_path = work / "granite-decode.plan.json"
        planned = None
        if "plan" in phases:
            with _Timed("plan"):
                planned = phase_plan(torch, cfg, plan_path)
        if "plan_execute" in phases:
            with _Timed("plan_execute"):
                phase_plan_execute(torch, cfg, planned)
        if "plan_serve" in phases:
            with _Timed("plan_serve"):
                launches = phase_plan_serve(torch, cfg, plan_path, work,
                                            card)
            if record is not None:
                record["plan_serve_launches"] = launches["flash_attention"]
        # with the dryrun phase it runs beside that phase's cells
        if "conformance_serving" in phases and "dryrun" not in phases:
            with _Timed("conformance_serving"):
                phase_conformance_serving(torch, work, card)
    train_record = None
    if "train_kernels" in phases or "train" in phases:
        with _Timed("train_kernels"):
            train_record = phase_train_kernel(torch, ops, ref, build)
        log(f"train_kernels: the sm90 backward at granite's training shape "
            f"{train_record['ms']:.4f} ms; before it was templated on (DQK, "
            f"DV): {GRANITE_EARLIER_MS[1]} ms")
    if "train" in phases:
        with _Timed("train"):
            phase_train(torch, ops, cfg, card, train_record)
    if "calibrate" in phases:
        with _Timed("calibrate"):
            phase_calibrate(torch, ops, cfg, card, train_record, planned)
    del planned
    rwkv_bwd_record = None
    if "rwkv_train_kernels" in phases or "rwkv_train" in phases:
        with _Timed("rwkv_train_kernels"):
            rwkv_bwd_record = phase_rwkv_train_kernel(torch, rops, rref,
                                                      build)
    if "rwkv_train" in phases:
        with _Timed("rwkv_train"):
            phase_rwkv_train(torch, rcfg, card, rwkv_bwd_record)
    launch_depth = None
    if "launch_train" in phases:
        with _Timed("launch_train"):
            launch_depth = phase_launch_train(torch, card)
    mcfg = get_config("mixtral-8x7b")
    if "mixtral_serve" in phases:
        with _Timed("mixtral_serve"):
            launches = phase_mixtral_serve(torch, mcfg, card)
        if record is not None:
            record["mixtral_serve_launches"] = launches["flash_attention"]
    if "mixtral_train" in phases:
        with _Timed("mixtral_train"):
            launches = phase_moe_train(torch, mcfg, card, "mixtral_train",
                                       "sm90")
        if train_record is not None:
            train_record["mixtral_train_launches"] = \
                launches["flash_attention_bwd"]
    # the sm90 kernels at the wide head dims: the deepseek_train and
    # dense_configs main paths fill in their launches
    wide = {}
    if "wide_head_kernels" in phases:
        with _Timed("wide_head_kernels"):
            wide = {(r["name"], r["case"]): r
                    for r in phase_wide_head_kernels(torch, ops, ref, build)}
    dcfg = get_config("deepseek-v2-lite-16b")
    if "deepseek_serve" in phases:
        with _Timed("deepseek_serve"):
            phase_deepseek_serve(torch, dcfg, card)
    if "deepseek_train" in phases:
        with _Timed("deepseek_train"):
            launches = phase_moe_train(torch, dcfg, card, "deepseek_train",
                                       "sm90")
        for name in ("flash_attention", "flash_attention_bwd"):
            if (name, "deepseek train") in wide:
                wide[(name, "deepseek train")]["launches"] = launches[name]
    if "dense_configs" in phases:
        with _Timed("dense_configs"):
            dense = phase_dense_configs(torch, card)
        for key, n in dense.items():
            if key in wide:
                wide[key]["launches"] = n
    # the selective scan: jamba's serve and train paths fill in launches
    ssm = []
    if "ssm_kernels" in phases:
        with _Timed("ssm_kernels"):
            ssm = phase_ssm_kernels(torch, sops, sref, build)
    jcfg = get_config("jamba-v0.1-52b")
    if "jamba_serve" in phases:
        with _Timed("jamba_serve"):
            launches = phase_jamba_serve(torch, jcfg, card)
        for r in ssm:
            if r["name"] == "selective_scan":
                r["launches"] = launches["selective_scan"]
                r["variant_launches"] = {
                    v: launches[f"selective_scan/{v}"] for v in sops.VARIANTS}
    if "jamba_train" in phases:
        with _Timed("jamba_train"):
            launches = phase_jamba_train(torch, jcfg, card)
        for r in ssm:
            key = "launches" if r["name"] == "selective_scan_bwd" \
                else "train_launches"
            r[key] = launches[r["name"]]
            r["variant_" + key] = {
                v: launches[f"{r['name']}/{v}"] for v in sops.VARIANTS}
    if "hubert" in phases:
        with _Timed("hubert"):
            hubert = phase_hubert(torch, get_config("hubert-xlarge"), card)
        for key, n in hubert.items():
            if key in wide:
                wide[key]["launches"] = n
    if "internvl" in phases:
        with _Timed("internvl"):
            phase_internvl(torch, get_config("internvl2-1b"), card)
    dist_layers = dist_launches = None
    if "distributed" in phases:
        dist_layers = _distributed_depth(torch, cfg, launch_depth)
        if "dryrun" not in phases:
            with _Timed("distributed"):
                dist_launches = phase_distributed(torch, card, dist_layers)
    if "dryrun" in phases:
        with _Timed("dryrun"):
            launches = phase_dryrun(
                torch, card, serving="conformance_serving" in phases,
                priced=priced, distributed=dist_layers)
        dist_launches = dist_launches or launches
    if dist_launches:
        # (g)'s attention at (192, 128) into the deepseek records
        for name, n in dist_launches["mla"].items():
            if (name, "deepseek train") in wide:
                wide[(name, "deepseek train")]["distributed_launches"] = {
                    "tensor_parallel_mla": n}
        for r in [record, train_record, rwkv_record, rwkv_bwd_record] + ssm:
            if r is not None and r["name"] in dist_launches:
                r["distributed_launches"] = dist_launches[r["name"]]
    log(card)
    print(json.dumps({"kernels": [r for r in (record, train_record,
                                              rwkv_record, rwkv_bwd_record)
                                  if r is not None] + list(wide.values())
                      + ssm}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
