#!/usr/bin/env python3
"""Chip check of the PyTorch/H100 port: build, hold, serve, report.

    python3 chip_smoke.py [--record PATH]

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin`` or on PATH); runs
from the repository root (it imports ``src/repro_torch``).  Phases, any
failure of which exits non-zero:

1. print the card (``nvidia-smi`` name and power limit); TF32 off;
2. build the CUDA kernels (one ``nvcc`` per source, in parallel), printing
   the build time and ptxas' report (per instance for K3, K5 and both K1b
   sources, the wgmma K1b's twelve at D 64, 128 and 256 among them, none of
   whose instances may spill, nor K5's take more than 128
   registers, nor the wgmma K1b's differ from the entry count its
   setmaxnreg exchange assumes; the wgmma K1b's shared memory, blocks an
   SM and rings at each head dim, and any wgmma serialisation ptxas
   reports, which fails the run at D 128 / 256; K1 and K2 per instance,
   and for their four D-256 instances, none of which may spill, the
   registers, spilled bytes, shared memory and blocks an SM the card
   reports);
3. hold each kernel against its plain PyTorch version on the card, at the
   CPU tests' shapes and at the served models' shapes (qwen2-0.5b: head
   dim 64, d 896; deepseek-moe-16b: head dim 128, d 2048, the grouped
   matmul at its prefill and decode capacities; rwkv6-7b: the WKV scan at
   its prefill shape, at batch 8, with strong and weak decays and a ragged
   V tile; jamba-1.5-large: the selective scan at its prefill shape, at
   batch 8, with strong and weak decays and a ragged channel tile, K1 and
   K2 at head dim 128 with 8 query heads per KV head, K4 at 16 experts of
   8192 x 24576; K3 at every served shape, 8 decode rows and 512 prefill
   rows of d 896, 2048, 4096 and 8192 and of jamba's Mamba norms' 512 and
   16, and at (3, 5, 96), a D off 16 bytes and a view off a 16-byte
   boundary; K1 in bf16 with q_offset and Sq < Sk, ragged 200-token
   sequences at head dim 64 and 128, G = 8 with a window and a softcap; K2
   in bf16 at a half-empty cache, S = 1000, G = 1, 7, 8 and 16 and a ring
   buffer with a window, each also against the split-KV plain version at
   the kernel's own split, and a row without a live slot, which must be
   exactly 0; K4 in bf16 at every row-tile count of its tensor-core
   instance, a D and an F tail, and a view off a 16-byte boundary, which
   must take the WMMA instance; K6 also at its plan's edges: V ragged
   against the 64-column tile, T past the 32-step stages, shorter than the
   ring and one stage at batch 8, one head, V = 6 and r off a 16-byte
   boundary (element-wise loads), and the served shape with L2 flushed
   before each run; K5 also at T = 50 (past its step group and stage), DI
   ragged against its channel tile, T of one ring stage at batch 8, and the
   served shape with L2 flushed before each run; K1 and K2 at head dim 256
   (the CPU tests' D-256 cases, gemma3-4b's prefill with and without its
   window of 1024 and its decode at 2048 slots and on wrapped 1024-slot
   rings) and at gemma2-27b's shapes with softcap 50; K1 and K2 at
   musicgen-large's head dim 64 with one query head per KV head and at
   dbrx-132b's head dim 128 with six, K4 at dbrx's 16 experts of 6144 x
   10752 at its prefill and decode capacities, K3 at chameleon-34b's
   QK-norm rows of head dim 128 and at dbrx's d 6144; every K3, K4, K5 and K6
   check runs twice into NaN-filled memory and the two results must be the
   same bytes), within 2e-2 (bf16) or 1e-4 (f32); time kernel, plain
   version and one PyTorch library call where there is one (a yardstick
   the port never calls) at the serving shapes, with L2 flushed before
   each launch, beside the card's bound for the same work (K1 also in f32,
   its CUDA-core instance; K4's WMMA instance at a ragged F; K3 at every
   served shape, beside the card's launch floor: an empty kernel launched
   through the same route; and K3 and the empty kernel GRAPH_LAUNCHES times
   in one CUDA graph, per launch, beside the same launches issued eagerly);
4. serve full-width qwen2-0.5b (bf16, random weights from a seed, 8 slots,
   1024-slot caches, 16 requests of 512 prompt tokens, 64 new tokens,
   greedy) through the port's Engine with the launch counts reset just
   before: first through ``Engine(compiled=False)``, then through the
   default compiled engine, whose decode ticks and prefills are replays of
   CUDA graphs (as for each model below); check the exact launch counts
   on the compiled run, the same counts on the eager run, the replay
   counts (decode: ticks - 1, prefill: requests - 1) and that every
   request's tokens are the same in both runs; then hold the first
   request's prefill logits and 8 teacher-forced decode steps through the
   kernels against the same through the plain versions, in f32 within
   F32_LOGIT_TOL (bf16 differences are reported beside them), and the f32
   kernel steps against the same steps as graph replays within
   GRAPH_F32_TOL; and report the device busy share of a decode tick and a
   prefill from torch.profiler, eager and replayed (a replayed tick may
   dispatch at most COMPILED_TICK_HOST_OPS host ops), whose kernel names
   (in the eager steps, and in the replays where the profiler names them)
   must show K1's tensor-core instance (and not the
   SIMT one) in the bf16 prefill and both K2 passes in the tick (also for
   deepseek-moe-16b and jamba-1.5-large below, whose prefill and tick must
   also show K4's tensor-core instance gmm_mma and neither other one, and
   rwkv6-7b, whose bf16 prefill must show K6's rwkv6_scan_tiled with its
   cp.async ring and no other K6 kernel, and jamba-1.5-large, whose bf16
   prefill must show K5's mamba_scan_ring with its cp.async ring and no
   other K5 kernel); every profile must show K3's rmsnorm_rows and no
   other RMSNorm kernel;
4b. free it, and serve full-width, full-depth deepseek-moe-16b the same way
   (16 requests of 512 prompt tokens, 32 new tokens), with exact launch
   counts of all four kernels; then three gates: (a) one served MoE layer
   at both token counts through the kernels vs the plain versions, in bf16
   and f32 (the same routing by construction); (b) prefill + 8 decode
   steps at full width with the depth cut to 4 layers, in f32, within
   F32_LOGIT_TOL, with the routing's top-k agreement between the two runs;
   (c) the same at full depth in bf16, reported only;
4c. free it, and serve full-width, full-depth rwkv6-7b the same way (16
   requests of 512 prompt tokens, 32 new tokens; the leaves its init sets
   flat get seeded noise, RWKV_FLAT_NOISE), every prefill's WKV scan
   through K6, with exact launch counts of all five kernels; then the
   first request's prefill + 8 teacher-forced decode steps through the
   kernels and through the plain versions at full depth, in f32 within
   F32_LOGIT_TOL (bf16 reported beside it);
4d. free it, and serve full-width jamba-1.5-large cut to its first five
   layers (every layer kind of its pattern: Mamba with a dense and with an
   MoE FFN, and the attention layer; 48.1 GB of bf16 weights; the leaves
   its init sets flat get seeded noise, MAMBA_FLAT_NOISE) the same way (16
   requests of 512 prompt tokens, 32 new tokens), every prefill's selective
   scan through K5, with exact launch counts of all six kernels; then (a)
   one served Mamba layer at the prefill shape through the kernels vs the
   plain versions, in bf16 and f32; (c) the first request's prefill + 8
   teacher-forced decode steps at depth 5 in bf16, reported only; and,
   with the bf16 model freed, (b) the same at depth 2 in f32 (weights drawn
   in f32 from the same seed) within F32_LOGIT_TOL, with the routing's
   top-k agreement;
4e. free it, and serve full-width, full-depth gemma3-4b (head dim 256;
   2048-slot caches, 16 requests of 1536 prompt tokens, longer than its
   window of 1024, so K1 masks by window and the local layers' rings wrap;
   32 new tokens) the same way, with exact launch counts and K1 and K2 at
   D 256 by kernel name; then the first request's prefill + 8 teacher-
   forced decode steps at full depth in f32, kernels vs plain within
   F32_LOGIT_TOL and as graph replays within GRAPH_F32_TOL (bf16 reported);
4f. free it, and serve full-width, full-depth gemma2-27b (54.45 GB; the
   standard set, 32 new tokens; softcaps 50 and 30) the same way; the first
   request through the kernels and the plain versions in bf16 at full
   depth, reported; and, with the bf16 model freed, the f32 gate at 4
   layers (weights drawn in f32 from the same seed);
4g-4i. free it, and serve ROADMAP M10's three sets the same way (the
   standard set, 32 new tokens), each with its launches read from the
   config (chameleon's QK-norm: 4 L + 1 K3 launches a forward): full-width,
   full-depth musicgen-large (6.5 GB; head dim 64, G 1), chameleon-34b
   (68.7 GB; QK-norm), and dbrx-132b at full width cut to its first
   DBRX_LAYERS layers (54.6 GB; K4 at its shape, K1 / K2 at G 6) with
   deepseek's gate (a) on its first MoE layer; the first request through
   the kernels and the plain versions in bf16 at the served depth,
   reported; and, with the bf16 model freed, the f32 gate at full width and
   M10_GATE_LAYERS layers (weights drawn in f32 from the same seed) within
   F32_LOGIT_TOL, for musicgen-large and chameleon-34b with seeded frontend
   embeddings (the served engines run text only), which must move every
   step's f32 logits by more than FRONTEND_MIN_DIFF;
5. free it, and train smollm-360m (the training path: ``lm.loss_fn``,
   ``training.step``, AdamW) through K1 with its log-sum-exp, the flash
   backward K1b, K3 and its backward K3b: (a) K1's lse against
   ``ref.flash_attention_lse_ref`` and (b) K1b against
   ``ref.flash_attention_bwd_ref`` and against torch autograd through
   ``ref.mha_ref`` (relative to each gradient's max |.|, BWD_TOL), at the
   CPU tests' edge cases (q_offset, window + softcap, ragged Sq / Sk, G =
   8, head dims 8 to 256; at D 64, the wgmma instance's, also window +
   softcap + q_offset under GQA and Sq, Sk off its 64-row tiles at G = 8;
   at D 128 and 256, the wgmma instances whose warpgroups split D, the
   CPU tests' VJP cases, window + softcap + q_offset under GQA and Sq, Sk
   off its tiles at G = 8) in f32 and bf16 and in bf16 at the training
   shapes (4, 2048, 15/5, 64) and phase (k)'s: gemma3-4b's global and
   local (window 1024) layers at D 256, gemma2-27b's with softcap 50 and
   chameleon-34b's at G 8 at D 128, musicgen-large's at G 1 on the wgmma
   pair, phase (l)'s deepseek-moe-16b at G 1 at D 128, and dbrx-132b's
   G 6 at D 128; each K1b run twice into NaN-filled memory with
   bitwise-equal results;
   (c) K3b against ``ref.rmsnorm_bwd_ref`` at (8192, 960), every served
   (rows, D) and phase (k)'s training rows (d 2560, 4608, 8192 and QK-norm's
   rows of 128), twice, bitwise equal, and on two streams at once, bitwise
   equal to one call at a time; (d)-(f') smollm-360m at full width and
   depth through ``train_checks``, the checks every training arch of this
   phase passes: (d) one f32 train step (batch 2 x 1024), kernels vs plain,
   its launches exact, the loss within F32_LOSS_RTOL and every gradient
   leaf within F32_GRAD_TOL of its max |.|, and one f32 step as a CUDA
   graph replay against an eager step from the seed's state, the loss and
   every param and moment leaf within GRAPH_TRAIN_F32_TOL of its max |.|;
   (e) TRAIN_STEPS bf16 steps at batch 4 x 2048 on ``SyntheticLM`` (the
   schedule launch.train gives 20 steps: peak lr 3e-4 after 10 warmup
   steps), eagerly and then through ``training/compiled.py``'s
   ``CompiledTrainStep`` (the step captured as a CUDA graph) from a fresh
   state of the same seed: the exact launches of every step
   (``train_launches_per_step``: 2 x 32 K1, 32 K1b, 2 x 64 + 1 K3, 65 K3b;
   per-period remat runs each period's forward again), one capture and
   TRAIN_STEPS - 1 replays (the capturing call's own replay counted, as
   serving counts them), the replays' losses those of the eager run, the
   loss falling by more than 0.1, step ms, tokens/s and peak memory; (f)
   one eager step and (f') one replayed step under torch.profiler, each of
   which must name K1's ``flash_fwd_mma``, K1b's instances of its dtype and
   head dim (``flash_attention.bwd_instances``: the wgmma pair here) and no
   other K1b instance, K3's ``rmsnorm_rows`` and K3b's
   ``rmsnorm_bwd_fused`` and neither kernel of the previous K3b (a session
   that names no kernel fails), with the device ms a step of each of those
   kernels; wall / busy / idle, host ops, kernels, median step, tokens/s,
   peak memory of the two, and the replay at most COMPILED_TICK_HOST_OPS
   host ops; (j) the compiled bf16
   step under ``runtime/supervisor.py``'s ``Supervisor`` for SUP_STEPS steps, a
   checkpoint every SUP_CKPT_EVERY, a node failure injected before step
   SUP_FAIL_AT, in a temporary directory removed at the end: one restart,
   each step's last loss equal bit for bit to (e')'s, still one capture,
   every leaf's data_ptr unchanged, the restored step-SUP_CKPT_EVERY
   checkpoint equal bit for bit to the live state at that step, as a new
   tree and copied into the live tensors (``restore_into``, the restart's
   path: its time and the device memory it adds), its manifest listing
   each leaf under its live dtype (the bf16 params as bfloat16), and the
   blocking snapshot, write and restore times; (g) K1
   with its lse, K1b (also in TFLOP/s) and K3b timed with L2 flushed
   beside their bounds, plain versions and SDPA's / ``F.rms_norm``'s
   backward, K3b also beside its previous design
   (``rmsnorm.previous_bwd``), and K3B_CALLS K3b calls under
   torch.profiler, which must show its one kernel, at most once a call,
   and nothing else (no memset); and K3 at the training rows beside
   ``F.rms_norm``; K1b at phase (k)'s and (l)'s training shapes (at D 128
   / 256 with its rate and its multiples of the bound and of SDPA, and
   the previous design there, ``flash_attention.previous_wide_bwd``,
   timed before and after it) beside its bound, plain version and SDPA's
   backward, and gemma3-4b's in f32, and
   K1's forward with its lse (``flash_fwd_mma``, as the train step
   launches it) at the same shapes beside its bound, plain version and
   SDPA's forward; (h)
   K2, K4, K5 and K6 refuse an input that requires grad (ROADMAP R11),
   and K1b one at a head dim without an instance (96) before any launch;
   (i) ``python -m repro_torch.launch.train --arch smollm-360m --steps 20
   --ckpt-dir <tmp> --fail-at 7`` in a child process: one restart, one
   capture, its loss falling; (k) the dense archs of DENSE_TRAIN (gemma3-4b and
   musicgen-large cut to 6 layers, gemma2-27b and chameleon-34b to 4) at
   full width through ``train_checks``, as smollm-360m in
   (d)-(f'): the f32 steps at DENSE_GATE_LAYERS layers, DENSE_TRAIN_STEPS
   bf16 steps at 4 x 2048 on one batch eagerly and then compiled (the loss
   falling), frontend archs with seeded embeddings, and one replayed step
   under torch.profiler (the tensor-core K1b, ``flash_bwd_*_sm90`` at D
   128 / 256, and no other K1b instance and never the previous wide
   pair; K1b's ms a step); then ``python -m
   repro_torch.launch.train --arch gemma3-4b`` (DENSE_CLI_ARGS, no
   checkpoints; full depth) in a child process: one capture, every step's
   K1b launches, its loss falling; (l) K4b, the grouped matmul's backward
   (``csrc/moe_gmm_bwd.cu``: the gated dgrad, the dgrad and the wgrad; in
   bf16 on aligned operands the wgmma kernels ``gmm_dgrad_sm90`` and
   ``gmm_wgrad_sm90``, whose ptxas report is a gate in phase 2: the entry
   register count, no spill, no wgmma serialisation), against its plain
   versions relative to each result's max |.| (K4B_TOL) at deepseek-moe-16b's
   training shape K4B_SHAPE in bf16 and f32, at a shape ragged against
   every tile on the wgmma instances and at one with C off 16 rows and D, F
   off 8 (the element-wise instance), silu and gelu, each launch twice and
   bitwise equal; each kernel and a whole MoE layer's backward timed with
   L2 flushed beside its bound, plain version, ``torch.bmm`` on the same
   (transposed) views and the previous design (``moe_gmm.previous_bwd``, timed
   before and after it); then deepseek-moe-16b
   at full width, MOE_TRAIN_LAYERS of 28 layers, through
   ``train_checks`` as the dense archs in (k) (the f32 gates at
   MOE_GATE_LAYERS, bf16 steps eager and compiled with K4's and K4b's exact
   launches, replays equal to eager, the loss falling, a replayed step's
   profile naming ``gmm_mma`` and K4b's two wgmma kernels and none of
   K4B_PREVIOUS); and ``python -m
   repro_torch.launch.train`` with MOE_CLI_ARGS in a child process (f32,
   one capture, exact K4 / K4b / K1b launches);
6. the paper's measurement layer (``core/``): (a) Table I, the hyperfine
   protocol (TABLE1_MICRO warm-up and measured calls) on the microbench
   (``configs/microbench.py``), baseline / usdt (tape-mode tracepoints) /
   uprobes (``inject_probes`` in callback mode) eagerly and baseline /
   usdt as CUDA graph replays (the uprobes arm's capture must be
   refused), then the three arms on full-width, full-depth qwen2-0.5b's
   loss forward at TABLE1_MODEL_TOKENS; (b) Fig. 2, their user / system
   CPU seconds; (c) qwen2-0.5b's compiled prefill and decode tick with
   tracing off and with the tape, the eager step off and in callback mode:
   logits bit-equal across the arms, the tape's logits point equal to the
   mean of the step's logits, callback mode refused inside a capture, the
   disabled step's launches, dispatched ops (``sdfg.extract``) and kernels
   (profile, where it saw the card) equal to the step's with ``tp.point``
   replaced by a bare no-op, the tape's cost on the replays,
   and device time by named scope; (d) smollm-360m's compiled train step
   with its tape: train.loss, lm.loss and train.grad_norm equal to the
   step's metrics at every call; (e) uprobes attached to
   ``ops.attention``, ``ops.decode_attention`` and ``ops.rmsnorm`` over an
   eager prefill and tick: one ``:ret`` a launch, each the first element
   of that call's output; (f) ``sdfg.extract`` / ``roofline.analyze_step``
   of the prefill, the tick and the train step by region and component,
   and each measured compiled step's model-FLOP share (``model_flops`` /
   (seconds x 989e12)) and roofline share (bound / seconds), none over
   SHARE_MAX; (g) R13: 12 requests over the prompt lengths R13_LENGTHS,
   each twice in a row, through the eager engine, the compiled engine with
   its prefill graphs capped at R13_CAP and without the cap: every
   request's tokens equal, the cap's evictions, and the reserved memory
   after each length, which must not grow past its value at the cap with
   the cap and must grow past it without (the control);
7. profile-guided dispatch (``dispatch/``) between the kernel tier and the
   plain tier on the card, every dispatched set with DISPATCH_MIN_SAMPLES
   (a compiled step's third call is its first plain replay), its held and
   peak memory printed: (a) full-width, full-depth qwen2-0.5b in bf16 (8
   slots, 1024-slot caches, 8 requests of 512 prompt tokens, 32 new
   tokens, greedy, compiled) undispatched, static kernel, static plain,
   roofline and profiled: the static kernel run's tokens and exact launch
   counts those of the undispatched run, the static plain run launching
   no kernel, roofline choosing the kernels for both surfaces, the
   profiled run exploring
   each tier DISPATCH_MIN_SAMPLES times per surface and then choosing the
   tier whose minimum sample so far is lower, every decision measured and
   logged; reported: the roofline estimates beside both tiers' replay
   medians, the dispatcher's cost a tick (static kernel against
   undispatched) and the tiers' bf16 token agreement (ROADMAP R10); (e)
   ``launch.serve --dispatch profiled`` (the same set) with
   ``--profile-out``, then with ``--profile-in`` of that store and of a
   store stamped ``tpu_v5e``: no exploration, every TPU entry aged out,
   the card's store stamped ``h100_sxm``; (b) qwen2-0.5b at full width and
   DISPATCH_GATE_LAYERS layers in f32: a profiled engine, switching tiers
   partway through requests, gives every request the undispatched tokens;
   (c) rwkv6-7b at full width and DISPATCH_RWKV_LAYERS layers in f32 (phase
   4c's noise on its flat leaves; prompts of 256, a multiple of its chunk):
   roofline and profiled engines give the undispatched tokens (pricing
   must not advance the recurrent state); (d) ``python -m
   repro_torch.launch.train --arch smollm-360m --dispatch profiled`` at
   full width, 4 x 2048, DISPATCH_TRAIN_STEPS steps, a checkpoint every
   DISPATCH_CKPT_EVERY, a failure before step DISPATCH_FAIL_AT, in a child
   process: both tiers dispatched, one restart, the kernel tier's losses
   up to the first plain step equal bit for bit to phase 5 (e')'s compiled
   run's; reported: each tier's step ms (its ``--profile-out`` store) and
   the stragglers;
8. the trace and metrics plane on the card (ROADMAP M11): (a)
   ``launch.serve`` of qwen2-0.5b (full width and depth, bf16, compiled, the
   SERVE set, ``--dispatch static --dispatch-backend kernel``) untraced and
   then with ``--trace-out``, ``--trace-dir`` (TRACE_ROTATE events a
   segment), ``--metrics-port 0 --ready-file`` (one scrape of ``/metrics``
   during ``--metrics-linger-s``), ``--trace-overhead-budget-pct 5`` and
   ``--torch-profile`` (backend ``torch``, TRACE_PERIOD_S): the same tokens
   and launch counts; every device slice of every window bound to a host
   span (the share bound by a ``span=`` annotation reported); K1's slices
   under ``prefill`` spans, K2's under ``decode_tick`` spans, K1's, K2's
   and K3's each under its ``dispatch`` event; a replayed tick's bound
   device time within TRACE_TICK_TOL of phase 4's ``profile_step`` busy
   time; the compacted ``--trace-dir`` holds the session's events, no drops
   on the host tracks; ``python -m repro_torch.trace report`` (and
   ``--tree``, device rows under their spans), ``export --format chrome``
   and ``diff`` on both; the scrape has ``repro_serve_queue_depth`` and
   the ``repro_device_*`` series; (b) ``launch.train`` of smollm-360m (4 x
   2048, TRACE_TRAIN_STEPS steps, a checkpoint every TRACE_CKPT_EVERY, a
   failure before TRACE_FAIL_AT, ``--trace-dir``, ``--trace-out``,
   ``--torch-profile``): the stream rotated at every checkpoint after step 0
   and at the end, the restart a span, K1's, K1b's, K3's and K3b's slices
   under ``step`` spans, each step's launches phase 5 (e)'s, the warmup
   steps' losses bit-equal phase 5 (e')'s compiled run's, the median step
   beside phase 5 (j)'s supervised run (checkpoints in flight there too); (c) ``tools/trace_record_cost.py`` on the card's
   host, and a profiler window opened from another thread around a K3
   launch under a ``span=`` range on this one (reported: what it saw);
9. ROADMAP M12's serving tier on the card, each process started with
   ``python -m`` and stopped at the end: (a) a fleet daemon
   (``repro_torch.fleet serve``, port 0, a ready file); (b) the router
   (``repro_torch.router``) over 2 real replicas of full-width qwen2-0.5b
   (compiled, bf16, ``--dispatch profiled --fleet --trace-dir``, 8 slots,
   1024-slot caches); (c) TIER_ALONE requests one at a time over the
   prompt lengths TIER_LENGTHS (TIER_MAX_NEW new tokens, greedy), each
   reply equal token for token to an in-process compiled Engine's on the
   same prompt served alone; (d) ``router.loadgen`` with TIER_LOAD of those
   prompts at concurrency TIER_CONC: each answered once with TIER_MAX_NEW
   tokens (the share equal to the alone replies printed, not gated); (e)
   each replica's ``/healthz``: K1, K2 and K3 launched, the kernel and
   plain tiers on the card, no static fallback and no plain route but the
   dispatcher's explored calls (the plain share printed), stamped
   ``h100_sxm``, and the fleet's one bucket (SHA, ``h100_sxm``) holding
   their pushed profiles, every entry stamped ``h100_sxm`` (each prefill
   length's and the decode step's minimum per tier printed); (f) a third
   replica started with ``--fleet`` pulls an exact match, explores fewer
   times than either cold replica (its dispatch events) and routes nothing
   to plain; (g) SIGKILL of the replica the router sent most to during
   TIER_KILL_LOAD requests: every one answered once, the replica restarted
   on a new pid, the restart time, and every replica's plain routes
   explored calls only;
   (h) ``python -m repro_torch.trace stitch`` of the router's trace
   directory (its replicas discovered from its manifest) and ``hops``:
   every routed request one tree rooted at the run, front door request ->
   route -> replica rpc -> engine request -> prefill, with TIER_MAX_NEW - 1
   of the replica's decode ticks while it held its slot (spans of two
   processes nested to within the stitcher's skew estimate, which on one
   host is its error); its hops (differences of the front door's and the
   replica's durations, so they add up to its front-door latency by
   construction) adding up to no more than the latency the client
   measured, and its service hop no shorter than the replica's engine
   interval in the trace (prefill start to the request's exit); printed,
   not gated: how many requests' hops come within TIER_HOP_TOL
   of their front-door span in the stitched trace, which also holds the
   reply's send, and of the client's latency; (i) the same
   load on warm replicas through the router and on one replica directly
   (direct, router, router, direct): tokens/s, p50 / p99 ms, the front
   door's own hop, the hop means, the restart time and the phase's
   seconds, each line with the card's name and power limit;
10. ROADMAP M12's ``tune/`` (``tune_phase``): (a) ptxas' registers and
   spills of every ``gmm_mma<MT>`` instance (MT 9 and 10 new), each Hopper
   space's points with their shared memory, threads, instance and
   feasibility (a default that is infeasible fails the run), the split
   pass's shared memory as the space prices it beside the card's, and MT 9
   / 10 against the plain version (C 129, 144, 160, no epilogue and silu);
   (b) ``launch.serve --arch deepseek-moe-16b`` (phase 4b's set, full width
   and depth, compiled, ``--dispatch profiled --tune sweep --fleet DIR``,
   in this process): a real sweep of the five spaces, every kernel point
   held against its plain version first, each point's time, the default's
   and the winner (any failed point fails the run); (c) K2 at its 8 and K4
   at its 6 served shapes of ``PERF.md`` §6, default beside winner (L2
   flushed), with the plan each ran, the winner held against the default;
   (d) the same set in a fresh process with ``--tune cached`` (0 sweep
   points, the sweep run's configs, an exact fleet pull, 0 explore
   dispatches), a third run in this process (token for token the fresh
   one's), the shares equal to the sweep run's and the untuned 4b run's
   tokens (and, as a control, the untuned 4b run's share of a
   ``--dispatch static`` run without tuning), the f32 gate at
   MOE_GATE_LAYERS layers under the winners, and a step captured under
   the winners refused under the defaults; (e) ``python -m
   repro_torch.launch.train --arch smollm-360m --steps 4 --dispatch
   profiled --tune cached --fleet DIR`` (winners applied, the fleet pulled
   exactly and pushed);
11. ROADMAP M13 and M11's last module (``mesh_phase``): (e)
   MESH_DRYRUN_CELLS run as ``python -m repro_torch.launch.dryrun``
   children on the host from the start of phase 10 (device-free; they run
   while the card works), and (d)'s two training children start after
   (a), beside (b), (c) and (f); (a) K2's
   stats mode (``return_stats=True``: the combine writes each row's f32
   (acc, m, l)) against ``ref.decode_attention_ref(return_stats=True)`` at
   its 8 served shapes, timed with L2 flushed beside the normal call, and
   an f32 cache with a row without a live slot, which must give (0, -1e30,
   0) and combine to exactly 0; (b) a cache split into 1, 2 and 4
   sequence shards, K2's stats of each combined by ``ops.combine_partials``
   (the mesh path's arithmetic), against one K2 call, in bf16 and f32, a
   row without any live slot exactly 0, and
   ``ops.decode_attention_seq_sharded`` on a 1 x 1 ``nccl`` mesh; (c)
   qwen2-0.5b (24 layers) and deepseek-moe-16b (4 layers) at full width in
   f32, a prefill and 8 teacher-forced decode steps with
   ``decode_split_kv`` on that mesh against the same without, within
   F32_LOGIT_TOL, with exactly 8 stats launches an attention layer; (d)
   ``launch.train --arch smollm-360m --steps 6 --ckpt-every 0`` with and
   without ``--mesh 1x1`` in child processes (losses equal bit for bit,
   every training kernel launched), ``Supervisor.resize`` from the mesh to
   none and back after steps 2 and 4 (losses equal the uninterrupted run
   bit for bit) and a checkpoint restored with ``shardings`` onto the mesh;
   (f) ``graphanalysis.captured_kernels`` on qwen2-0.5b's compiled prefill
   and decode tick: each port kernel's count in a replay equals its count
   in the eager call's SDFG; then (e)'s records: each cell's status,
   per-device FLOPs, bytes, collective bytes by op, bottleneck and
   roofline fraction (priced from ``hw/specs.py``, not measured); a
   ``FAIL``, a missing ``fake`` backend or a cell over
   MESH_DRYRUN_TIMEOUT_S fails the run;
12. print the script's run time, the per-kernel JSON line (launches from the
   nine compiled serving runs, K1b's and K3b's from phase 5 (e), the wide
   K1b's (bf16 D 128 / 256) from phases 5 (k) and (l), phase 7's, phase
   8's, phase 9's replicas' and
   phase 10's runs, and K2's stats mode's from phase 11 (c)), the card
   line, and last the ``{"ok": true, "device": ...}`` line.

``--record PATH`` also writes the full record (every check, the serving
run, the profiles) there as JSON.  ``tools/serving_tier.py`` runs phase 9
alone, ``tools/mesh_phase.py`` phase 11.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# The end-to-end check runs the served weights in f32 through the kernels
# and through the plain versions: each kernel is within ~1e-6 of its plain
# version in f32, so 24 layers stay far inside 1e-3 on logits of order 5,
# while a wrong kernel moves them by far more.  In bf16 the rounding of 24
# layers alone moves the logits by ~0.1, so the bf16 path is only held to
# land no further from the f32 path than twice the plain bf16 path does
# (+0.02).
F32_LOGIT_TOL = 1e-3
ARCH = "qwen2-0.5b"
SERVE = dict(max_batch=8, max_seq=1024, requests=16, prompt_len=512, max_new=64)
MOE_ARCH = "deepseek-moe-16b"
MOE_SERVE = dict(max_batch=8, max_seq=1024, requests=16, prompt_len=512, max_new=32)
MOE_GATE_LAYERS = 4  # gate (b): full width, layer 0 dense + 3 MoE layers, in f32
RWKV_ARCH = "rwkv6-7b"
RWKV_SERVE = dict(max_batch=8, max_seq=1024, requests=16, prompt_len=512, max_new=32)
# Leaves rwkv6-7b's init sets flat, and the seeded noise phase 4c puts there:
# "uniform" draws from [0, 1) (token-shift interpolation weights), a number
# is a normal std.  With the init's zeros the token-shift mix returns x for
# every target and the decay is constant in time, so a fault that moves the
# decay along the sequence would reach neither K6's inputs nor the gate.
RWKV_FLAT_NOISE = {"mu_base": "uniform", "mu": "uniform", "mu_k": "uniform", "mu_r": "uniform",
                   "mix_w2": 0.02, "decay_w2": 0.05}
JAMBA_ARCH = "jamba-1.5-large"
# 72 layers are 796 GB in bf16; the first five (mamba/dense, mamba/moe,
# mamba/dense, mamba/moe, ga/dense) run every layer kind of the pattern and
# hold 48.1 GB of the card's 80
JAMBA_LAYERS = 5
JAMBA_SERVE = dict(max_batch=8, max_seq=1024, requests=16, prompt_len=512, max_new=32)
JAMBA_GATE_LAYERS = 2  # gate (b): mamba/dense + mamba/moe in f32, 48.7 GB
# Leaves a Mamba mixer's init sets flat, and the std of the seeded noise
# phase 4d adds to them (the three norms' scales: dt_norm, b_norm, c_norm).
# At init A_log is the same row log(1..N) for every channel and D is all
# ones, so a fault that indexes A or D with the wrong channel changes
# nothing.  A = -exp(A_log) stays negative, so every decay stays in (0, 1).
MAMBA_FLAT_NOISE = {"A_log": 0.5, "D": 0.5, "conv_b": 0.1, "dt_norm": 0.3, "b_norm": 0.3,
                    "c_norm": 0.3}
GEMMA3_ARCH = "gemma3-4b"
# prompts longer than the 1024-token window: K1 masks by window in every
# local layer's prefill, and each local layer's 1024-slot ring holds the
# prompt's last 1024 positions and wraps in decode (K2 at D 256 on a ring)
GEMMA3_SERVE = dict(max_batch=8, max_seq=2048, requests=16, prompt_len=1536, max_new=32)
GEMMA2_ARCH = "gemma2-27b"
# 46 layers, 54.45 GB in bf16: one card holds it at full depth.  Its window
# of 4096 never masks at these lengths (gemma3 carries the window); its
# softcaps (50 on attention, 30 on the final logits) act in every layer
GEMMA2_SERVE = dict(max_batch=8, max_seq=1024, requests=16, prompt_len=512, max_new=32)
GEMMA2_GATE_LAYERS = 4  # the f32 gate: 2 periods of (swa, ga) at full width, 13.8 GB
# ROADMAP M10's three sets, each the standard set.  musicgen-large (48
# layers, 6.5 GB in bf16; MHA at head dim 64, the audio frontend stub) and
# chameleon-34b (48 layers, 68.7 GB; QK-norm, the vlm frontend stub) at
# full depth; dbrx-132b (40 layers, 263 GB) at full width cut to its first
# DBRX_LAYERS layers, 54.6 GB
MUSICGEN_ARCH, CHAMELEON_ARCH, DBRX_ARCH = "musicgen-large", "chameleon-34b", "dbrx-132b"
DBRX_LAYERS = 8
M10_SERVE = dict(max_batch=8, max_seq=1024, requests=16, prompt_len=512, max_new=32)
# each set's f32 gate at full width: its first layers, drawn in f32 from the
# same seed once the bf16 model is freed (chameleon's 4 are 15.6 GB in f32)
M10_GATE_LAYERS = {MUSICGEN_ARCH: 4, CHAMELEON_ARCH: 4, DBRX_ARCH: 2}
# the frontend's share of the f32 gate: with seeded embeddings each of the 9
# steps' logits must lie further than this from the same step's without
# them (the projection's std 0.02 x sqrt(d) output dwarfs the token
# embeddings' d**-0.5, so the logits move by O(1) where they are used)
FRONTEND_MIN_DIFF = 0.1
SFU_EXP_PER_CLOCK = 16  # ex2 results per clock per SM on Hopper (sm_90)
# A replayed decode tick dispatches two copies into its static buffers and
# one graph launch; an eager one dispatches 1852-4098 ops on these models.
COMPILED_TICK_HOST_OPS = 20
# Graph replays run the same kernels on the same inputs as eager calls, in
# the same order, so their f32 logits should agree exactly.
GRAPH_F32_TOL = 1e-5
GRAPH_LAUNCHES = 256  # K3 launches captured in one graph to time a launch inside it
PROFILER_SESSIONS = 3  # sessions a profile may open before one sees the card's kernels
# serving launches no backward kernel, and not K2's stats mode (the split-KV
# decode across the devices of a mesh; phase 11)
NOT_SERVED = {"flash_attention_bwd": 0, "rmsnorm_bwd": 0, "decode_attention_stats": 0,
              "moe_gmm_bwd": 0}
TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 20  # phase 5 (e): 20 bf16 steps of 8192 tokens
# the schedule launch.train gives a run of TRAIN_STEPS steps: peak 3e-4 after
# max(10, steps // 10) warmup steps, cosine to 0.1 x peak at the last step
TRAIN_LR, TRAIN_WARMUP = 3e-4, 10
F32_GATE_BATCH, F32_GATE_SEQ = 2, 1024  # phase 5 (d): the f32 train step, kernels vs plain
# K1b against its plain version, each gradient relative to its max |.|: in
# f32 both sum the same f32 products in other orders (~1e-6 seen); in bf16
# the kernel's inputs out and lse come from the bf16 forward, whose P is
# rounded to bf16 (R10), ~3e-3 seen.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The f32 train step at full width and depth through the kernels and through
# the plain versions: each kernel is within ~1e-6 of its plain version in
# f32, and 32 layers of forward and backward keep the loss within 1e-4 of
# itself and each gradient leaf within 1e-3 of its max |.|, where a wrong
# kernel (or a gradient that skipped one) moves them by O(1).
F32_LOSS_RTOL, F32_GRAD_TOL = 1e-4, 1e-3
# A replayed f32 train step runs the eager step's kernels on the same inputs
# in the same order (PR 20's f32 serving replays matched eager exactly): its
# loss and every updated param and moment leaf within 1e-6 of its max |.|.
GRAPH_TRAIN_F32_TOL = 1e-6
# phase 5 (j): the supervised compiled run, a checkpoint every 8 steps and a
# node failure injected before step 11 (the restart restores step 8)
SUP_STEPS, SUP_CKPT_EVERY, SUP_FAIL_AT = 12, 8, 11
CLI_FAIL_AT = 7  # phase 5 (i): --fail-at of the driver's run (restores step 0)
CLI_TIMEOUT_S = 300  # phase 5 (i): python -m repro_torch.launch.train on the card
K3B_CALLS = 10  # phase 5 (g): K3b calls under torch.profiler, one kernel each
K3B_OVERLAP_ROUNDS = 8  # phase 5 (c): K3b calls on each of two streams at once
# phase 5 (k): the dense archs K1b's head dims 256 and 128 bring to the
# card, each trained at full width in bf16 with f32 moments on SyntheticLM
# batches of (layers (None: full depth), batch) x DENSE_TRAIN_SEQ.
# gemma2-27b and chameleon-34b are cut to 4 of 46 / 48 layers (gemma2: two
# periods of (swa, ga)): whole, their bf16 params and grads and f32
# moments, 12 bytes a parameter, take 326 and 412 GB.  gemma3-4b and
# musicgen-large are cut to 6 of 34 / 48 (gemma3: one period of its 5:1
# pattern, local and global layers) to hold the whole run under its time
# limit; (k4)'s launch.train
# child still trains gemma3-4b whole
DENSE_TRAIN = {GEMMA3_ARCH: (6, 4), MUSICGEN_ARCH: (6, 4), GEMMA2_ARCH: (4, 4),
               CHAMELEON_ARCH: (4, 4)}
DENSE_TRAIN_SEQ = 2048
# (b), (c), (g): K1b and K3b at 4 x 2048 tokens of each arch's heads and widths
DENSE_KERNEL_BATCH = 4
# each arch's bf16 run: DENSE_TRAIN_STEPS steps eagerly, then the same steps
# compiled from a fresh state of the same seed (an eager call, a capture,
# replays), all on SyntheticLM batch 0, so that the loss falls by the
# steps' own gradients (over a few different batches a random-init model's
# loss moves by their spread as much); DENSE_TRAIN_LR at the first update,
# cosine to 0.1 x it
DENSE_TRAIN_STEPS, DENSE_TRAIN_LR = 5, 1e-4
# its f32 gates at full width and DENSE_GATE_LAYERS layers: gemma3-4b's
# pattern cut to one period of (swa, ga), one local and one global layer
DENSE_GATE_LAYERS = 2
# the training driver's child run: gemma3-4b at full width and depth with
# no checkpoints (a copy of its state is 39 GB), on SyntheticLM batches 0-5;
# launch.train's warmup of 10 steps takes the lr from 1e-4 to 6e-4
DENSE_CLI_ARCH = GEMMA3_ARCH
DENSE_CLI_ARGS = ("--steps", "6", "--batch", "4", "--seq", "2048", "--lr", "1e-3",
                  "--ckpt-every", "0")
# phase 5 (l): deepseek-moe-16b, the arch K4b brings to the card, trained at
# full width cut to its first MOE_TRAIN_LAYERS of 28 layers (the dense layer
# and three MoE layers, ~2.27 B parameters, ~27 GB at 12 bytes a parameter;
# whole it would take ~197 GB) at MOE_TRAIN_BATCH x DENSE_TRAIN_SEQ tokens,
# the dense archs' way (train_checks); its f32 gates at the dense layer and
# one MoE layer
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_GATE_LAYERS = 4, 4, 2
# K4b against its plain version: (E, C, D, F) of the slice's MoE layers (4 x
# 2048 tokens in groups of 2048: capacity 240 a group, 960 rows an expert);
# one shape ragged against every tile (192 / 128 rows, 128 columns) but on
# the wgmma instances (D, F multiples of 8); one with C off 16 rows, D and
# F off 8 (the element-wise bf16 instance)
K4B_SHAPE = (64, 960, 2048, 1408)
K4B_RAGGED_VEC = (3, 75, 264, 136)
K4B_RAGGED = (3, 75, 196, 100)
# each K4b gradient relative to its max |.|: in f32 kernel and plain version
# sum the same f32 products (up to 2 x 1408 a element) in other orders
# (~1e-6 expected); in bf16 both round the same f32 value once, so a
# difference is one bf16 step (2^-8 of the element) where the two sums
# straddle a rounding boundary
K4B_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the wgmma kernels of (a) and (b) and of (c); and the previous design's, whose
# kernels (any instance) must not run in a bf16 step at the slice's shape
K4B_KERNELS = ("gmm_dgrad_sm90", "gmm_wgrad_sm90")
K4B_PREVIOUS = ("gmm_dgrad_gated", "gmm_dgrad", "gmm_wgrad")
# launch.train's child run of the MoE arch at its smoke size (f32,
# 8 experts of 32 at d 64: the f32 and ragged-capacity instances)
MOE_CLI_ARGS = ("--arch", MOE_ARCH, "--reduced", "--steps", "6", "--ckpt-every", "0")
# a named scope of the model (core/scopes.py), as torch.profiler names its range
SCOPE_NAME = re.compile(r"^(embed|final_norm|(head|tail)\d+|pos\d+_[a-z]+_[a-z_]+|mixer_[a-z]+"
                        r"|ffn_[a-z_]+)$")
# phase 6: the paper's measurement layer on the card
TABLE1_MICRO = (50, 500)  # (a) warm-up and measured calls a microbench arm (hyperfine)
TABLE1_ROUNDS = 2  # (a) every arm timed twice, in turn: drift between arms shows
TABLE1_MODEL = (5, 30)  # (a) the same for a model arm
TABLE1_MODEL_TOKENS = (8, 128)  # (a) the model arms' loss forward: full-width, full-depth qwen2
TAPE_STEP_RUNS = {"prefill": (5, 50), "decode_tick": (10, 150)}  # (c) a compiled step's arms
TAPE_TRAIN_REPLAYS = 6  # (d) replays of the compiled train step with its tape
# (g) R13: prompt lengths in the order served, each twice in a row (so each
# is captured), the longest first so that the eager calls' and captures'
# largest activations come before the cap is reached; and the cap
R13_LENGTHS = (512, 64, 384, 128, 256, 192)
R13_CAP = 4
SHARE_MAX = 1.05  # (f) no model-FLOP or roofline share of a measured step may read over this
# phase 7: profile-guided dispatch (dispatch/) between the kernel and plain tiers
DISPATCH_SERVE = dict(max_batch=8, max_seq=1024, requests=8, prompt_len=512, max_new=32)
# a compiled step's first call runs eagerly and its second captures: its
# third is the first plain replay, so a tier is warm after 3 samples
DISPATCH_MIN_SAMPLES = 3
DISPATCH_GATE_LAYERS = 4  # (b) qwen2-0.5b at full width in f32
DISPATCH_GATE_SERVE = dict(max_batch=8, max_seq=1024, requests=8, prompt_len=512, max_new=16)
DISPATCH_RWKV_LAYERS = 4  # (c) rwkv6-7b at full width in f32; prompts a multiple of its chunk
DISPATCH_RWKV_SERVE = dict(max_batch=4, max_seq=512, requests=4, prompt_len=256, max_new=32)
# (d) launch.train --dispatch profiled: a checkpoint every 4 steps, a
# failure before step 7 (restores step 4)
DISPATCH_TRAIN_STEPS, DISPATCH_CKPT_EVERY, DISPATCH_FAIL_AT = 8, 4, 7
# phase 8: the trace and metrics plane.  A 0.6 s window period opens windows
# of 0.3 s of profiling (the budget's first on-fraction is 0.5; time paused
# around a CUDA graph capture does not count), which in the qwen2 set spans
# the prefill replays, the eager tick and ~20 replayed ticks; the budget
# then spaces windows to hold their cost under TRACE_BUDGET_PCT of the wall.
TRACE_PERIOD_S, TRACE_BUDGET_PCT, TRACE_ROTATE, TRACE_LINGER_S = 0.6, 5.0, 4096, 3.0
TRACE_TICK_TOL = 0.10  # a replayed tick's bound device ms against profile_step's busy ms
# (b) launch.train: a checkpoint every 4 steps, a failure before step 7
# (restores step 4); launch.train's lr is the same for 12 and 20 steps
# through the warmup, so steps 0-10 are phase 5 (e')'s steps
TRACE_TRAIN_STEPS, TRACE_CKPT_EVERY, TRACE_FAIL_AT = 12, 4, 7
# phase 9: the serving tier.  Full-width qwen2-0.5b replicas (compiled, bf16,
# --dispatch profiled) with the engine shape of the in-process reference;
# a few fixed prompt lengths (each a captured prefill graph per tier)
TIER_LENGTHS, TIER_MAX_NEW, TIER_BATCH, TIER_SEQ = (64, 128, 256, 512), 32, 8, 1024
TIER_ALONE, TIER_LOAD, TIER_CONC, TIER_KILL_LOAD = 8, 16, 8, 32
TIER_HOP_TOL = 0.05  # each routed request's hops against its front-door span
# an interval measured inside another (the front door's in the client's,
# the engine's in the replica's service) may pass it by the hops'
# rounding (1 us each) only
TIER_CLOCK_SLACK_MS = 0.05


def closed_form_tol(chunk: int) -> float:
    """The chunked closed form's own f32 rounding relative to max |out|: a
    pairwise decay is exp of a difference of two in-chunk cumsums of log w,
    which reach chunk x 88 in magnitude when w nears the 1e-38 clip, and so
    carries ~2**-23 x chunk x 88 of relative error where the serial
    recurrence carries none (1.3e-3 at chunk 128)."""
    return max(TOL["float32"], 2.0**-23 * chunk * 88)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(smi_line: str) -> dict:
    """Data-sheet peaks (dense) of the card nvidia-smi names."""
    if "PCIe" in smi_line:  # H100 PCIe
        return {"bytes_per_s": 2.0e12, "bfloat16": 756e12, "float32": 51e12}
    return {"bytes_per_s": 3.35e12, "bfloat16": 989e12, "float32": 67e12}  # H100 SXM


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", type=Path, default=None,
                    help="also write the full record of the run here, as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.events import EventLog
    from repro_torch.kernels import _build, launch_counts, ops, ref, reset_launches, uncounted
    from repro_torch.kernels import decode_attention as k2
    from repro_torch.kernels import flash_attention as k1
    from repro_torch.kernels import mamba_scan as k5
    from repro_torch.kernels import moe_gmm as k4
    from repro_torch.kernels import rmsnorm as k3
    from repro_torch.kernels import rwkv6_scan as k6
    from repro_torch.models import lm
    from repro_torch.nn import core as nn_core
    from repro_torch.nn import ffn as ffn_mod
    from repro_torch.nn import mamba as mamba_mod
    from repro_torch.serving.compiled import Graphs
    from repro_torch.serving.engine import Engine, ServeConfig

    t_start = time.time()
    phase_s: dict[str, float] = {}
    dev = torch.device("cuda")

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = card_peaks(smi)
    # the special-function units' exponential rate at the card's top clock
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    peaks["exp_per_s"] = SFU_EXP_PER_CLOCK * n_sm * max_sm_mhz * 1e6
    print(f"{n_sm} SMs, max SM clock {max_sm_mhz:.0f} MHz: {peaks['exp_per_s']:.4g} "
          "exponentials/s on the SFUs", flush=True)
    from repro_torch.hw.specs import default_chip

    spec = default_chip()
    props = torch.cuda.get_device_properties(0)
    print(f"the card against hw/specs.py's {spec.name} (data sheet): memory "
          f"{props.total_memory / 1e9:.2f} GB against {spec.hbm_bytes / 1e9:.0f} GB, SMs {n_sm} "
          f"against {spec.sm_count}, max SM clock {max_sm_mhz:.0f} MHz, bf16 / f32 peaks "
          f"{spec.peak_flops_bf16:.3g} / {spec.peak_flops_f32:.3g} FLOP/s, HBM "
          f"{spec.hbm_bw:.3g} B/s", flush=True)

    phase_s["2"] = time.time() - t_start  # when each phase began
    # -- 2. build ---------------------------------------------------------
    t0 = time.time()
    paths = _build.build()
    k1._entry()
    k1._bwd_entry()
    k1._sm90_entry()
    k2._entry()
    k4._entry()
    k4._bwd_entry()
    k5._entry()
    k6._entry()
    k3._entry()
    torch.cuda.synchronize()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    ptxas = {}
    for name, path in paths.items():  # ptxas -v: one report per template instance
        ptxas[name] = ptxas_instances(path.with_suffix(".log").read_text())
        regs = [r for _, r, _ in ptxas[name]]
        spills = sum(n > 0 for _, _, n in ptxas[name])
        print(f"  {name}: {len(regs)} instances, max {max(regs, default=0)} registers, "
              f"{spills} with spills ({path.with_suffix('.log').name})", flush=True)
    for name in ("rmsnorm", "mamba_scan", "flash_attention_bwd", "flash_attention_bwd_sm90"):
        for fn_name, regs, spill in ptxas[name]:
            print(f"    {fn_name[:72]}: {regs} registers, {spill} bytes spilled", flush=True)
        if any(spill for *_, spill in ptxas[name]):
            fail(f"an instance of {name} spills registers")
    # the wgmma K1b at each head dim of its source (64; 128 and 256, whose
    # warpgroups split D): shared memory (all dynamic), blocks an SM, rings
    sm90_cfgs = {D_: k1.sm90_config(k1._sm90_entry()[0], 0, D_) for D_ in k1.BWD_SM90_HEAD_DIMS}
    for D_, cfg_ in sm90_cfgs.items():
        print(f"  flash_attention_bwd_sm90 configuration at D {D_}: {json.dumps(cfg_)}",
              flush=True)
    # setmaxnreg's exchange balances only if ptxas gave every instance the
    # entry count the source assumes (another would leave it waiting)
    def sm90_entry_regs(fn_name: str) -> int:
        m = re.search(r"flash_bwd_(dq|dkdv)_(wgmma|sm90)I(?:Li(\d+)E)?", fn_name)
        D_ = 64 if m.group(2) == "wgmma" else int(m.group(3))
        return sm90_cfgs[D_]["entry_regs_" + m.group(1)]

    sm90_regs = {fn_name: (regs, sm90_entry_regs(fn_name))
                 for fn_name, regs, _ in ptxas["flash_attention_bwd_sm90"]}
    if len(sm90_regs) != 12 or any(got != want for got, want in sm90_regs.values()):
        fail(f"flash_attention_bwd_sm90: ptxas registers (got, entry count) {sm90_regs}: "
             "twelve instances (4 at D 64, 4 each at D 128 and 256), each at its entry "
             "count, expected")
    # K4b: its wgmma instances at setmaxnreg's entry count, without spill
    # and without wgmma serialisation (the host side refuses a build off
    # the entry count, and sm90_config checks the source's tiles, stages and
    # shared memory against plan.py's mirror); the first design's instances
    # reported (its gated bf16 and f32 instances spill a few bytes)
    k4b_cfg = k4.sm90_config(0)
    print(f"  moe_gmm_bwd wgmma configuration: {json.dumps(k4b_cfg)}", flush=True)
    k4b_sm90 = {}  # instance: (registers, its entry count, spilled bytes)
    for fn_name, regs, spill in ptxas["moe_gmm_bwd"]:
        print(f"    {fn_name[:72]}: {regs} registers, {spill} bytes spilled", flush=True)
        if "_sm90" in fn_name:
            gated = re.search(r"gmm_dgrad_sm90ILi[12]E", fn_name) is not None
            k4b_sm90[fn_name] = (regs, k4b_cfg["entry_regs_" + ("gated" if gated else "store")],
                                 spill)
    k4b_serial = [line.strip() for line in
                  paths["moe_gmm_bwd"].with_suffix(".log").read_text().splitlines()
                  if "Performance Loss" in line]
    if (len(k4b_sm90) != 4 or k4b_serial
            or any(r != want or n for r, want, n in k4b_sm90.values())):
        fail(f"moe_gmm_bwd: the wgmma instances' (registers, entry count, spilled bytes) "
             f"{k4b_sm90} and serialisation {k4b_serial}: four instances (gated silu / gelu, "
             "the store, the wgrad), each at its entry count, none spilled or serialised, "
             "expected")
    # wgmma serialisation ptxas reports: printed (the D-64 pair has it), and
    # none allowed in the D-128 / 256 instances
    serialised = []
    for line in paths["flash_attention_bwd_sm90"].with_suffix(".log").read_text().splitlines():
        if "Performance Loss" in line:
            fn = re.search(r"flash_bwd_\w+?E(?:Ev|v)", line)
            print(f"    ptxas: {line.strip()[:120]} ... {fn.group(0) if fn else line[-120:]}",
                  flush=True)
            serialised.append(fn.group(0) if fn else line)
    if any("_sm90I" in n for n in serialised):
        fail(f"flash_attention_bwd_sm90: ptxas serialises the wgmmas of {serialised}")
    print(f"  flash_attention_bwd_sm90: wgmma serialisation in {len(serialised)} instances, "
          f"none at D 128 / 256", flush=True)
    if any(regs > 128 for _, regs, _ in ptxas["mamba_scan"]):
        fail("an instance of mamba_scan takes more than 128 registers (4 blocks an SM)")
    # K1 and K2 per instance, and what the card made of their four D-256
    # instances (gemma3-4b's head dim; the split pass at gemma3's served
    # ranges): registers, spilled bytes, static and dynamic shared memory,
    # blocks an SM.  None of the four may spill.
    d256 = {}
    for name in ("flash_attention", "decode_attention"):
        for fn_name, regs, spill in ptxas[name]:
            print(f"    {fn_name[:72]}: {regs} registers, {spill} bytes spilled", flush=True)
            if "Li256E" in fn_name:  # a template instance at D 256
                d256[fn_name] = {"ptxas_registers": regs, "ptxas_spill_bytes": spill}
    g3 = get_config(GEMMA3_ARCH)
    g3_chunk = k2.split_plan(GEMMA3_SERVE["max_batch"], g3.n_kv_heads, GEMMA3_SERVE["max_seq"],
                             n_sm)[1]
    d256_info = {"flash_fwd_mma<256>": k1.instance_info(torch.bfloat16, 256),
                 "flash_fwd_simt<float, 256>": k1.instance_info(torch.float32, 256),
                 "decode_split_mma<256>": k2.instance_info(torch.bfloat16, 256, g3_chunk),
                 "decode_split_kernel<float, 256>": k2.instance_info(torch.float32, 256, g3_chunk)}
    for name, info in d256_info.items():
        print(f"  {name}: {json.dumps(info)}", flush=True)
    if (len(d256) != 4 or any(v["ptxas_spill_bytes"] for v in d256.values())
            or any(v["spilled_bytes"] for v in d256_info.values())):
        fail(f"the D-256 instances of K1 and K2: ptxas {d256}, the card {d256_info}: four "
             "instances without spills expected")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB of L2

    def time_ms(fn, iters: int = 20) -> float:
        """Mean device time of ``fn`` per call, L2 flushed before each call.

        A sleep kernel holds the device while the host queues every call, so
        the events bracket device work only, not the host's launch gaps.
        """
        for _ in range(3):
            fn()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # ~25 ms of GPU clock cycles, longer than the queueing
        for s, e in evs:
            flush_buf.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters

    def bound_ms(n_bytes: float, n_flops: float, peak_flops: float,
                 n_exps: float = 0.0) -> tuple[float, str]:
        """The larger of bytes over the memory rate and operations over
        their peak: FLOPs, and exponentials on the special-function units."""
        t_bytes = n_bytes / peaks["bytes_per_s"]
        t_ops = max(n_flops / peak_flops, n_exps / peaks["exp_per_s"])
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts)

    records: dict[str, dict] = {}
    checks: list[dict] = []

    def hold(kernel: str, case: str, got, want, dtype_name: str, fatal: bool = True) -> float:
        """Max |got - want|; a disagreement fails the run at once, or, with
        ``fatal=False``, is recorded in ``checks`` for the caller to fail on."""
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[dtype_name]
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        ok = ok and bool(torch.isfinite(got.float()).all())
        checks.append({"kernel": kernel, "case": case, "max_abs_err": err, "tol": tol, "ok": ok})
        print(f"  {kernel} {case}: max_abs_err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok and fatal:
            fail(f"{kernel} {case} disagrees with its plain version")
        return err

    def timed(kernel_fn, plain_fn, library_fn, n_bytes, n_flops, peak, shape,
              n_exps: float = 0.0) -> dict:
        """Times of kernel, plain version and library call (None: there is
        no single PyTorch call for the function) beside the bound."""
        b, by = bound_ms(n_bytes, n_flops, peak, n_exps)
        return {"ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn), "bound_ms": b,
                "bound_by": by, "library_ms": time_ms(library_fn) if library_fn else None,
                "shape": shape}

    def fmt_ms(t) -> str:
        return "none" if t is None else f"{t:.4f} ms"

    phase_s["3"] = time.time() - t_start
    # -- 3. kernels against their plain versions ---------------------------
    print("kernels vs plain:", flush=True)
    # K1: the CPU tests' sweep, q_offset, and the prefill shape
    sweep = [(2, 64, 64, 4, 4, 16, None, None), (2, 64, 64, 4, 2, 16, None, None),
             (1, 96, 96, 4, 1, 32, None, None), (2, 64, 64, 4, 2, 16, 16, None),
             (2, 64, 64, 4, 2, 16, None, 30.0), (2, 64, 64, 4, 2, 16, 16, 50.0),
             (1, 40, 40, 2, 2, 8, None, None)]
    err1 = 0.0
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for B, Sq, Sk, Hq, Hkv, D, w, cap in sweep:
            q, k, v = randn(B, Sq, Hq, D, dtype=dt), randn(B, Sk, Hkv, D, dtype=dt), \
                randn(B, Sk, Hkv, D, dtype=dt)
            got = k1.flash_attention(q, k, v, window=w, softcap=cap)
            want = ref.mha_ref(q, k, v, window=w, softcap=cap)
            err1 = max(err1, hold("flash_attention", f"{dn} {B}x{Sq}x{Hq}/{Hkv}x{D} w={w} cap={cap}",
                                  got, want, dn))
    q, k, v = randn(2, 16, 4, 16), randn(2, 80, 2, 16), randn(2, 80, 2, 16)
    err1 = max(err1, hold("flash_attention", "float32 q_offset=64",
                          k1.flash_attention(q, k, v, q_offset=64),
                          ref.mha_ref(q, k, v, q_offset=64), "float32"))
    cfg = get_config(ARCH)
    Hq, Hkv, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, SERVE["prompt_len"]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        q, k, v = randn(1, S, Hq, D, dtype=dt), randn(1, S, Hkv, D, dtype=dt), \
            randn(1, S, Hkv, D, dtype=dt)
        err1 = max(err1, hold("flash_attention", f"{dn} serving 1x{S}x{Hq}/{Hkv}x{D}",
                              k1.flash_attention(q, k, v), ref.mha_ref(q, k, v), dn))
    # K1 in bf16 on the tensor cores: q_offset with Sq < Sk, ragged Sq = Sk
    # = 200 at D 64 and 128 with G = 8, and G = 8 with a window that starts
    # inside a tile and a softcap at D 128 (the D = 16 and 32 cases are in
    # the sweep above)
    # (drawn from a fork of the generator, so later phases draw what they did
    # before these cases existed)
    gen_state = gen.get_state()
    k1_edges = [(2, 16, 80, 4, 2, 64, None, None, 64), (1, 100, 300, 16, 2, 128, 37, 30.0, 200),
                (1, 200, 200, 8, 1, 64, None, None, 0), (1, 200, 200, 8, 1, 128, None, None, 0),
                (1, S, S, 64, 8, 128, 100, 30.0, 0)]
    for B_, Sq_, Sk_, Hq_, Hkv_, D_, w, cap, qo in k1_edges:
        qe, ke, ve = (randn(B_, n, h, D_, dtype=torch.bfloat16)
                      for n, h in ((Sq_, Hq_), (Sk_, Hkv_), (Sk_, Hkv_)))
        err1 = max(err1, hold("flash_attention", f"bfloat16 {B_}x{Sq_}x{Sk_}x{Hq_}/{Hkv_}x{D_} "
                              f"w={w} cap={cap} q_offset={qo}",
                              k1.flash_attention(qe, ke, ve, window=w, softcap=cap, q_offset=qo),
                              ref.mha_ref(qe, ke, ve, window=w, softcap=cap, q_offset=qo),
                              "bfloat16"))
    del qe, ke, ve
    gen.set_state(gen_state)
    # timing at the serving shape (bf16, causal; and the f32 instance)
    q32, k32_, v32 = (t.float() for t in (q, k, v))
    k1_f32 = timed(lambda: k1.flash_attention(q32, k32_, v32), lambda: ref.mha_ref(q32, k32_, v32),
                   (lambda qs=q32.transpose(1, 2).contiguous(), ks_=k32_.transpose(1, 2).contiguous(),
                    vs_=v32.transpose(1, 2).contiguous(): F.scaled_dot_product_attention(
                        qs, ks_, vs_, is_causal=True, enable_gqa=True)),
                   nbytes(q32, k32_, v32, q32), 4 * D * Hq * (S * (S + 1) // 2), peaks["float32"],
                   f"B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} f32 causal ({k1.instance(torch.float32, D)})")
    del q32, k32_, v32
    qs, ks_, vs_ = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = S * (S + 1) // 2
    b1, by1 = bound_ms(nbytes(q, k, v, q), 4 * D * Hq * pairs, peaks["bfloat16"])
    records["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:115",
        "max_abs_err": err1,
        "ms": time_ms(lambda: k1.flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: ref.mha_ref(q, k, v)),
        "bound_ms": b1, "bound_by": by1,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks_, vs_, is_causal=True, enable_gqa=True)),
        "shape": f"B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal "
                 f"({k1.instance(torch.bfloat16, D)})",
        "float32": k1_f32,
    }

    # K2: the CPU tests' sweep, a ring buffer, and the decode shape
    err2 = 0.0
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for w, cap in ((None, None), (8, None), (None, 30.0)):
            B_, S_ = 2, 40
            q, kc, vc = randn(B_, 4, 16, dtype=dt), randn(B_, S_, 2, 16, dtype=dt), \
                randn(B_, S_, 2, 16, dtype=dt)
            pos = torch.arange(S_, dtype=torch.int32, device=dev)[None].repeat(B_, 1)
            cur = torch.tensor([S_ - 1, 17], dtype=torch.int32, device=dev)
            err2 = max(err2, hold("decode_attention", f"{dn} w={w} cap={cap}",
                                  k2.decode_attention(q, kc, vc, pos, cur, window=w, softcap=cap),
                                  ref.decode_attention_ref(q, kc, vc, pos, cur, window=w,
                                                           softcap=cap), dn))
    q, kc, vc = randn(1, 2, 8), randn(1, 8, 1, 8), randn(1, 8, 1, 8)
    pos = torch.tensor([[16, 17, 10, 11, 12, 13, 14, 15]], dtype=torch.int32, device=dev)
    cur = torch.tensor([17], dtype=torch.int32, device=dev)
    err2 = max(err2, hold("decode_attention", "float32 ring window=6",
                          k2.decode_attention(q, kc, vc, pos, cur, window=6),
                          ref.decode_attention_ref(q, kc, vc, pos, cur, window=6), "float32"))
    B, Sc = SERVE["max_batch"], SERVE["max_seq"]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        q, kc, vc = randn(B, Hq, D, dtype=dt), randn(B, Sc, Hkv, D, dtype=dt), \
            randn(B, Sc, Hkv, D, dtype=dt)
        pos = torch.arange(Sc, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        cur = torch.full((B,), Sc - 1, dtype=torch.int32, device=dev)
        err2 = max(err2, hold("decode_attention", f"{dn} serving {B}x{Sc}x{Hq}/{Hkv}x{D}",
                              k2.decode_attention(q, kc, vc, pos, cur),
                              ref.decode_attention_ref(q, kc, vc, pos, cur), dn))
    # K2 in bf16 at the served shapes' edges, each also held against the
    # split-KV plain version at the kernel's own split: the first tick after
    # a 512-token prompt (513 of 1024 slots live), S = 1000 (the last range
    # and its last tile ragged), G = 1, 7, 8 and 16, and a 256-slot ring
    # with a window that starts inside a tile
    n_sm_card = torch.cuda.get_device_properties(0).multi_processor_count
    gen_state = gen.get_state()

    def ring_pos(B_, size, curs):
        """pos_ids of a ring of ``size`` slots holding positions cur - size + 1 .. cur."""
        s_ = torch.arange(size, dtype=torch.int32, device=dev)[None]
        base = torch.tensor(curs, dtype=torch.int32, device=dev)[:, None] - size + 1
        return base + torch.remainder(s_ - base, size)

    k2_edges = [("half-empty", 8, 1024, 14, 2, 64, [512] * 8, None, None),
                ("S=1000", 8, 1000, 16, 16, 128, [999] * 8, None, None),
                ("G=1", 8, 1024, 16, 16, 128, list(range(1016, 1024)), None, 30.0),
                ("G=7", 8, 1024, 14, 2, 64, [1023, 700, 513, 100, 31, 32, 0, 1023], None, None),
                ("G=8", 8, 1024, 64, 8, 128, [1023, 900, 600, 513, 300, 64, 5, 1023], None, None),
                ("G=16", 4, 1024, 32, 2, 128, [1023, 513, 77, 1000], None, None),
                ("ring window", 8, 256, 64, 8, 128, [700, 300, 255, 1000, 256, 511, 999, 257],
                 100, None)]
    for label, B_, S_, Hq_, Hkv_, D_, curs, w, cap in k2_edges:
        qe, kce, vce = randn(B_, Hq_, D_, dtype=torch.bfloat16), \
            randn(B_, S_, Hkv_, D_, dtype=torch.bfloat16), randn(B_, S_, Hkv_, D_, dtype=torch.bfloat16)
        if label == "ring window":
            pose = ring_pos(B_, S_, curs)
        else:
            pose = torch.arange(S_, dtype=torch.int32, device=dev)[None].repeat(B_, 1)
        cure = torch.tensor(curs, dtype=torch.int32, device=dev)
        got = k2.decode_attention(qe, kce, vce, pose, cure, window=w, softcap=cap)
        n_split, chunk = k2.split_plan(B_, Hkv_, S_, n_sm_card)
        case = f"bfloat16 {label} {B_}x{S_}x{Hq_}/{Hkv_}x{D_} w={w} cap={cap}"
        err2 = max(err2, hold("decode_attention", case, got,
                              ref.decode_attention_ref(qe, kce, vce, pose, cure, window=w,
                                                       softcap=cap), "bfloat16"))
        err2 = max(err2, hold("decode_attention", f"{case} vs split ref {n_split}x{chunk}", got,
                              ref.decode_attention_split_ref(qe, kce, vce, pose, cure,
                                                             n_split=n_split, chunk=chunk,
                                                             window=w, softcap=cap), "bfloat16"))
    # a row with no live slot gives exactly 0 (the Pallas kernel's result;
    # the plain whole-cache version gives the mean of V there)
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        qe, kce, vce = randn(2, 16, 128, dtype=dt), randn(2, 1024, 2, 128, dtype=dt), \
            randn(2, 1024, 2, 128, dtype=dt)
        pose = torch.arange(1024, dtype=torch.int32, device=dev)[None].repeat(2, 1)
        pose[0] = -1
        cure = torch.tensor([600, 600], dtype=torch.int32, device=dev)
        got = k2.decode_attention(qe, kce, vce, pose, cure)
        dead_ok = bool((got[0] == 0).all())
        checks.append({"kernel": "decode_attention", "case": f"{dn} row without a live slot is 0",
                       "max_abs_err": float(got[0].float().abs().max()), "tol": 0.0, "ok": dead_ok})
        print(f"  decode_attention {dn} row without a live slot: max |out| "
              f"{float(got[0].float().abs().max()):.3e} {'ok' if dead_ok else 'FAIL'}", flush=True)
        if not dead_ok:
            fail(f"decode_attention {dn}: a row without a live slot is not 0")
        hold("decode_attention", f"{dn} live row beside a dead one", got[1:],
             ref.decode_attention_ref(qe, kce, vce, pose, cure)[1:], dn)
    del qe, kce, vce, pose, cure, got
    gen.set_state(gen_state)
    live = (pos >= 0) & (pos <= cur[:, None])
    n_live = int(live.sum())
    qs = q[:, :, None]
    ks_, vs_ = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = live[:, None, None, :]
    kv_bytes = 2 * n_live * Hkv * D * kc.element_size()
    b2, by2 = bound_ms(kv_bytes + nbytes(q, q, pos, cur), 4 * D * Hq * n_live, peaks["bfloat16"])
    records["decode_attention"] = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:91",
        "max_abs_err": err2,
        "ms": time_ms(lambda: k2.decode_attention(q, kc, vc, pos, cur)),
        "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, kc, vc, pos, cur)),
        "bound_ms": b2, "bound_by": by2,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks_, vs_, attn_mask=mask, enable_gqa=True)),
        "shape": f"B={B} S={Sc} Hq={Hq} Hkv={Hkv} D={D} bf16, {n_live} live slots "
                 f"({' + '.join(k2.instances(torch.bfloat16, D))}, split "
                 f"{k2.split_plan(B, Hkv, Sc, n_sm_card)})",
    }

    # K3: every served shape, 8 decode rows and 512 prefill rows of each
    # model's norm widths (qwen2 d 896, deepseek d 2048, rwkv6-7b d 4096,
    # jamba d 8192 and its Mamba norms' dt_rank 512 and d_state 16, gemma2
    # d 4608; gemma3's d 2560 at 8 and 1536 rows), an odd
    # shape, a D off 16 bytes and a view off a 16-byte boundary (both
    # element-wise), in f32 and bf16; every check runs twice into NaN-filled
    # memory (norm_twice).  Timed in bf16 at every served shape, beside the
    # card's launch floor.  Drawn from a fork of the generator, so later
    # phases draw what they would without these cases.
    err3 = 0.0
    dm = cfg.d_model
    jfull = get_config(JAMBA_ARCH)
    jDI, jN, _, jR = mamba_mod._dims(jfull)  # 16384, 16, d_conv, dt_rank 512
    norm_widths = {ARCH: (dm,), MOE_ARCH: (get_config(MOE_ARCH).d_model,),
                   RWKV_ARCH: (get_config(RWKV_ARCH).d_model,), JAMBA_ARCH: (jfull.d_model, jR, jN)}
    served_norms = [(r, d) for ds in norm_widths.values() for d in ds for r in (B, S)]
    # the gemmas' rows: gemma3-4b's d 2560 at its 1536-token prefill, gemma2-27b's d 4608
    served_norms += [(B, g3.d_model), (GEMMA3_SERVE["prompt_len"], g3.d_model),
                     (B, get_config(GEMMA2_ARCH).d_model), (S, get_config(GEMMA2_ARCH).d_model)]
    # the M10 sets' new rows (musicgen-large's d 2048 and chameleon-34b's d
    # 8192 are deepseek's and jamba's widths, above): chameleon's QK-norm
    # over rows of head_dim 128, n_heads / n_kv_heads rows a token at the
    # 512-token prefill and the 8-row tick, and dbrx-132b's d 6144.  Held
    # with the rest and timed after them from a fork of the generator, so
    # every later phase draws what it did before they existed.
    ch, db = get_config(CHAMELEON_ARCH), get_config(DBRX_ARCH)
    m10_norms = [(t * h, ch.head_dim) for t in (S, B) for h in (ch.n_heads, ch.n_kv_heads)]
    m10_norms += [(B, db.d_model), (S, db.d_model)]

    def norm_twice(x, s):
        """K3 twice on the same inputs, each time into the block the caching
        allocator last freed, filled with NaN just before (so an element the
        kernel leaves unwritten shows); the two results must be the same
        bytes."""
        outs = []
        for _ in range(2):
            torch.full_like(x, float("nan"))
            outs.append(k3.rmsnorm(x, s))
        if not torch.equal(outs[0].view(torch.uint8), outs[1].view(torch.uint8)):
            fail(f"rmsnorm {tuple(x.shape)} {x.dtype}: two runs differ")
        return outs[0]

    def norm_case(x) -> str:
        """The plan a K3 launch takes, and whether it loads 16 bytes a lane."""
        p = k3.norm_plan(x.numel() // x.shape[-1], x.shape[-1], x.element_size(), n_sm)
        vec = x.data_ptr() % 16 == 0 and x.shape[-1] * x.element_size() % 16 == 0
        return (f"[{p.lanes} lanes x {p.chunks} chunks a row, {p.threads} threads, {p.grid} "
                f"blocks, {'16-byte' if vec else 'element-wise'}]")

    gen_state = gen.get_state()
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for shape in (*served_norms, *m10_norms, (3, 5, 96), (4, 100), "view"):
            if shape == "view":  # qwen2's decode rows, 2 (bf16) or 4 (f32) bytes past the start
                buf = randn(B * dm + 1, dtype=dt)
                x, shape = buf[1:].view(B, dm), f"({B}, {dm}) at +{buf.element_size()} bytes"
            else:
                x = randn(*shape, dtype=dt)
            s = randn(x.shape[-1]) * 0.1
            err3 = max(err3, hold("rmsnorm", f"{dn} {shape} {norm_case(x)}", norm_twice(x, s),
                                  ref.rmsnorm_ref(x, s), dn))
    del buf
    gen.set_state(gen_state)
    floor_ms = time_ms(lambda: k3.launch_floor(dev))
    print(f"  launch floor (an empty kernel of one block, through the same route): "
          f"{floor_ms:.4f} ms", flush=True)

    def time_norm(shape) -> dict:
        x = randn(*shape, dtype=torch.bfloat16)
        s = randn(shape[-1]) * 0.1
        t = timed(
            lambda: k3.rmsnorm(x, s), lambda: ref.rmsnorm_ref(x, s),
            lambda w=(1.0 + s).to(torch.bfloat16), n=shape[-1]: F.rms_norm(
                x, (n,), weight=w, eps=1e-6),
            nbytes(x, x, s), 4 * x.numel(), peaks["float32"], f"{shape} bf16 {norm_case(x)}")
        # the same bytes moved with no arithmetic: one PyTorch copy of x
        t["copy_ms"] = time_ms(lambda y=torch.empty_like(x): y.copy_(x))
        print(f"  rmsnorm {shape} bf16: kernel {t['ms']:.4f} ms ({t['ms'] - floor_ms:.4f} above "
              f"the floor), F.rms_norm {t['library_ms']:.4f}, copy {t['copy_ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.6f} ({t['bound_by']}) "
              f"{norm_case(x)}", flush=True)
        return t

    times3 = {shape: time_norm(shape) for shape in served_norms}
    gen_state = gen.get_state()
    times3.update({shape: time_norm(shape) for shape in m10_norms})
    gen.set_state(gen_state)
    records["rmsnorm"] = {
        "name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:27", "max_abs_err": err3,
        **times3[(B, dm)], "floor_ms": floor_ms,
        "served": {str(shape): t for shape, t in times3.items()},
    }

    # K1, K2 at deepseek-moe-16b's shapes: head dim 128, one query row per
    # KV head (MHA)
    mcfg = get_config(MOE_ARCH)
    mHq, mHkv, mD = mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim
    mS, mB, mSc, dm2 = (MOE_SERVE["prompt_len"], MOE_SERVE["max_batch"], MOE_SERVE["max_seq"],
                        mcfg.d_model)
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        q, k, v = (randn(1, mS, h, mD, dtype=dt) for h in (mHq, mHkv, mHkv))
        err1 = max(err1, hold("flash_attention", f"{dn} {MOE_ARCH} 1x{mS}x{mHq}/{mHkv}x{mD}",
                              k1.flash_attention(q, k, v), ref.mha_ref(q, k, v), dn))
        qd, kc, vc = randn(mB, mHq, mD, dtype=dt), randn(mB, mSc, mHkv, mD, dtype=dt), \
            randn(mB, mSc, mHkv, mD, dtype=dt)
        pos = torch.arange(mSc, dtype=torch.int32, device=dev)[None].repeat(mB, 1)
        cur = torch.full((mB,), mSc - 1, dtype=torch.int32, device=dev)
        err2 = max(err2, hold("decode_attention", f"{dn} {MOE_ARCH} {mB}x{mSc}x{mHq}/{mHkv}x{mD}",
                              k2.decode_attention(qd, kc, vc, pos, cur),
                              ref.decode_attention_ref(qd, kc, vc, pos, cur), dn))
    # timings in bf16 (the last dtype above)
    moe_shape_times = {
        "flash_attention": timed(
            lambda: k1.flash_attention(q, k, v), lambda: ref.mha_ref(q, k, v),
            (lambda qs=q.transpose(1, 2).contiguous(), ks_=k.transpose(1, 2).contiguous(),
             vs_=v.transpose(1, 2).contiguous(): F.scaled_dot_product_attention(
                 qs, ks_, vs_, is_causal=True)),
            nbytes(q, k, v, q), 4 * mD * mHq * (mS * (mS + 1) // 2), peaks["bfloat16"],
            f"B=1 S={mS} Hq={mHq} Hkv={mHkv} D={mD} bf16 causal"),
        "decode_attention": timed(
            lambda: k2.decode_attention(qd, kc, vc, pos, cur),
            lambda: ref.decode_attention_ref(qd, kc, vc, pos, cur),
            (lambda qs=qd[:, :, None], ks_=kc.transpose(1, 2).contiguous(),
             vs_=vc.transpose(1, 2).contiguous(): F.scaled_dot_product_attention(qs, ks_, vs_)),
            nbytes(qd, kc, vc, qd, pos, cur), 4 * mD * mHq * mB * mSc, peaks["bfloat16"],
            f"B={mB} S={mSc} Hq={mHq} Hkv={mHkv} D={mD} bf16, all {mB * mSc} slots live"),
    }

    def gmm_twice(x, w, epi=None):
        """K4 twice on the same inputs, each time into the block the caching
        allocator last freed, filled with NaN just before (so a tile the
        kernel leaves unwritten shows); the two results must be the same
        bytes (a race in the cp.async ring shows as a difference)."""
        outs = []
        for _ in range(2):
            torch.full((x.shape[0], x.shape[1], w.shape[2]), float("nan"), dtype=x.dtype,
                       device=dev)
            outs.append(k4.gmm(x, w, epilogue=epi))
        if not torch.equal(outs[0].view(torch.uint8), outs[1].view(torch.uint8)):
            fail(f"moe_gmm {tuple(x.shape)}@{tuple(w.shape)} epilogue={epi}: two runs differ")
        return outs[0]

    def gmm_instance(x, w) -> str:
        return k4.instance(x.dtype, x.shape[2], w.shape[2],
                           x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)

    # K4: the CPU tests' shapes and epilogues, then deepseek-moe-16b's three
    # grouped matmuls per MoE layer at the prefill and decode capacities;
    # every K4 check runs twice (gmm_twice)
    err4 = 0.0
    m = mcfg.moe
    caps = {"prefill": ffn_mod._capacity(mS, m), "decode": ffn_mod._capacity(mB, m)}  # 64, 8
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for E_, C_, D_, F_ in ((4, 16, 32, 24), (2, 20, 24, 12), (8, 8, 8, 8)):
            x, w = randn(E_, C_, D_, dtype=dt), randn(E_, D_, F_, dtype=dt)
            for epi in (None, "silu", "gelu"):
                err4 = max(err4, hold("moe_gmm", f"{dn} {(E_, C_, D_, F_)} epilogue={epi} "
                                      f"[{gmm_instance(x, w)}]", gmm_twice(x, w, epi),
                                      ref.gmm_ref(x, w, epilogue=epi), dn))
        for phase, C_ in caps.items():
            for D_, F_, epi in ((dm2, m.d_expert, "silu"), (dm2, m.d_expert, None),
                                (m.d_expert, dm2, None)):
                x = randn(m.n_experts, C_, D_, dtype=dt)
                w = (randn(m.n_experts, D_, F_) * 0.02).to(dt)
                err4 = max(err4, hold("moe_gmm", f"{dn} {phase} ({m.n_experts},{C_},{D_})@"
                                      f"({m.n_experts},{D_},{F_}) epilogue={epi} "
                                      f"[{gmm_instance(x, w)}]", gmm_twice(x, w, epi),
                                      ref.gmm_ref(x, w, epilogue=epi), dn))
    # K4 bf16 on gmm_mma: every row-tile count the plan chooses (1-8, and 2
    # and 3 row blocks past 128 rows) at 16 experts of 8192 x 1536, each
    # epilogue; a D tail and an F tail (against the 64-deep stages and the
    # 256-wide F tiles); a view off a 16-byte boundary, which must take the
    # WMMA instance; and that instance's time at a ragged F.  Drawn from a
    # fork of the generator, so later phases draw what they did before.
    gen_state = gen.get_state()
    bf = torch.bfloat16
    sweep_c = (1, 8, 15, 16, 17, 33, 64, 80, 96, 112, 128, 129, 300)
    if {k4.tile_plan(16, C_, 1536).row_tiles for C_ in sweep_c} != set(
            range(1, k4.MAX_ROW_TILES + 1)):
        fail("the K4 sweep misses a row-tile count of gmm_mma")
    for D_, F_, cs in ((8192, 1536, sweep_c), (8200, 1536, (80,)), (8192, 1416, (80,))):
        w = (randn(16, D_, F_) * 0.02).to(bf)
        for C_ in cs:
            x = randn(16, C_, D_, dtype=bf)
            for epi in (None, "silu", "gelu"):
                err4 = max(err4, hold("moe_gmm", f"bfloat16 (16,{C_},{D_})@(16,{D_},{F_}) "
                                      f"epilogue={epi} [{gmm_instance(x, w)}, row tiles "
                                      f"{k4.tile_plan(16, C_, F_).row_tiles}]",
                                      gmm_twice(x, w, epi), ref.gmm_ref(x, w, epilogue=epi),
                                      "bfloat16"))
            if gmm_instance(x, w) != "gmm_mma":
                fail(f"moe_gmm {tuple(x.shape)}@{tuple(w.shape)} took {gmm_instance(x, w)}")
    buf = randn(16 * 80 * 8192 + 1, dtype=bf)
    x = buf[1:].view(16, 80, 8192)  # 2 bytes past an allocation's start
    prof = profile_step(lambda: k4.gmm(x, w))
    names = [n for n in prof["kernel_names"] if "gmm_" in n]
    print(f"  moe_gmm on an unaligned view: the profile saw {[n[:60] for n in names]}",
          flush=True)
    if gmm_instance(x, w) != "gmm_bf16_kernel" or not names or any(
            "gmm_bf16_kernel" not in n for n in names):
        fail(f"moe_gmm on an unaligned view ran {names}, expected gmm_bf16_kernel only (the "
             f"profile saw {len(prof['kernel_names'])} kernels in all)")
    err4 = max(err4, hold("moe_gmm", f"bfloat16 {tuple(x.shape)}@{tuple(w.shape)} x at +2 "
                          f"bytes [{gmm_instance(x, w)}]", gmm_twice(x, w),
                          ref.gmm_ref(x, w), "bfloat16"))
    del buf
    x, w = randn(16, 80, 8192, dtype=bf), (randn(16, 8192, 1412) * 0.02).to(bf)
    k4_times = {"wmma ragged": timed(
        lambda: k4.gmm(x, w), lambda: ref.gmm_ref(x, w), lambda: torch.bmm(x, w),
        nbytes(x, w) + 16 * 80 * 1412 * 2, 2 * 16 * 80 * 8192 * 1412, peaks["bfloat16"],
        f"(16,80,8192)@(16,8192,1412) bf16 ({gmm_instance(x, w)})")}
    gen.set_state(gen_state)
    for phase, C_ in caps.items():  # the w1 / w3 product, bf16, no epilogue
        x = randn(m.n_experts, C_, dm2, dtype=torch.bfloat16)
        w = (randn(m.n_experts, dm2, m.d_expert) * 0.02).to(torch.bfloat16)
        k4_times[phase] = timed(
            lambda: k4.gmm(x, w), lambda: ref.gmm_ref(x, w), lambda: torch.bmm(x, w),
            nbytes(x, w) + m.n_experts * C_ * m.d_expert * 2,
            2 * m.n_experts * C_ * dm2 * m.d_expert, peaks["bfloat16"],
            f"({m.n_experts},{C_},{dm2})@({m.n_experts},{dm2},{m.d_expert}) bf16 ({phase})")
    del x, w
    records["moe_gmm"] = {
        "name": "moe_gmm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:54", "max_abs_err": err4,
        **k4_times["prefill"], "decode": k4_times["decode"],
        "wmma ragged": k4_times["wmma ragged"],
    }
    # K6: the CPU tests' sweep, a ragged V tile (V = 40 = 16 + 16 + 8, V != K),
    # strong and weak decays, rwkv6-7b's prefill shape (chunk 128) at batch 1
    # and 8; every case starts from a non-zero state.  Each is held against
    # the serial oracle and the chunked closed form, relative to max |out|
    # and max |state|.
    rcfg = get_config(RWKV_ARCH)
    rK = rcfg.rwkv.head_dim
    rH, rS, rL = rcfg.d_model // rK, RWKV_SERVE["prompt_len"], rcfg.rwkv.chunk

    def rwkv_inputs(B, T, H, K, V, dt, decay="mixed"):
        """r, k with std K**-0.5, v normal, w by decay law (f32), u, state."""
        r, k = (randn(B, T, H, K) * K**-0.5 for _ in range(2))
        if decay == "strong":  # 10**U(-37.5, -30): down to the chunked form's clip
            w = 10.0 ** (torch.rand(B, T, H, K, generator=gen, device=dev) * 7.5 - 37.5)
        elif decay == "weak":
            w = 1.0 - torch.rand(B, T, H, K, generator=gen, device=dev) * 1e-3
        else:
            w = torch.exp(-torch.exp(randn(B, T, H, K) * 0.5))
        return (r.to(dt), k.to(dt), randn(B, T, H, V, dtype=dt), w, (randn(H, K) * 0.5).to(dt),
                randn(B, H, K, V) * 0.1)

    def hold_rel(case, got, want, tol, kernel="rwkv6_scan", fatal=True) -> float:
        """Holds max |got - want| / max |want| of out and of the state to
        ``tol`` (a non-finite value fails too); returns max |got - want|.
        With ``fatal=False`` a disagreement is only recorded in ``checks``."""
        diffs = [float((g.float() - w_.float()).abs().max()) for g, w_ in zip(got, want)]
        rel = max(d / float(w_.float().abs().max()) for d, w_ in zip(diffs, want))
        ok = rel <= tol and all(bool(torch.isfinite(g.float()).all()) for g in got)
        checks.append({"kernel": kernel, "case": case, "max_abs_err": max(diffs),
                       "max_rel_err": rel, "tol": tol, "ok": ok})
        print(f"  {kernel} {case}: max_rel_err {rel:.3e} (tol {tol:.1e}), max_abs_err "
              f"{max(diffs):.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok and fatal:
            fail(f"{kernel} {case} disagrees with its plain version")
        return max(diffs)

    def scan_twice(x, chunk, cold=False):
        """K6 twice on the same inputs, each time into the blocks the caching
        allocator last freed, filled with NaN just before (so an output the
        kernel leaves unwritten shows); the two results must be the same
        bytes (a race in the cp.async ring shows as a difference).  With
        ``cold``, L2 is flushed before each run, so the ring's stages come
        from device memory and a stage read before it lands shows."""
        r_, v_, s_ = x[0], x[2], x[5]
        outs = []
        for _ in range(2):
            nan_o = torch.full((*r_.shape[:3], v_.shape[3]), float("nan"), dtype=r_.dtype,
                               device=dev)
            nan_s = torch.full_like(s_, float("nan"))
            del nan_o, nan_s
            if cold:
                flush_buf.zero_()
            outs.append(k6.rwkv6_scan(*x, chunk=chunk))
        for a, b_ in zip(*outs):
            if not torch.equal(a.view(torch.uint8), b_.view(torch.uint8)):
                fail(f"rwkv6_scan {tuple(r_.shape)} V={v_.shape[3]} {r_.dtype}: two runs differ")
        return outs[0]

    def scan_case(x) -> str:
        """The plan a K6 launch takes, and whether its ring is filled by
        16-byte cp.async copies or element by element."""
        r_, v_ = x[0], x[2]
        B_, _, H_, K_ = r_.shape
        p = k6.scan_plan(B_, H_, K_, v_.shape[3], n_sm, r_.element_size())
        vec = (all(t.data_ptr() % 16 == 0 for t in x[:4])
               and v_.shape[3] * r_.element_size() % 16 == 0)
        return (f"[{p.vb} columns a block, {p.grid[0] * p.grid[1]} blocks, "
                f"{'cp.async' if vec else 'element-wise'}]")

    err6 = 0.0

    def hold_k6(cases) -> None:
        nonlocal err6
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).removeprefix("torch.")
            for (B_, T_, H_, K_, V_), L_, decay in cases:
                x = rwkv_inputs(B_, T_, H_, K_, V_, dt, decay)
                got = scan_twice(x, L_)
                case = f"{dn} {(B_, T_, H_, K_, V_)} chunk {L_} {decay} decays {scan_case(x)}"
                err6 = max(err6, hold_rel(f"{case} vs serial", got, ref.rwkv6_scan_ref(*x),
                                          TOL[dn]))
                if V_ == K_:  # the chunked form assumes V == K
                    tol = (closed_form_tol(L_) if decay == "strong" and dt == torch.float32
                           else TOL[dn])
                    err6 = max(err6, hold_rel(f"{case} vs chunked", got,
                                              ref.rwkv6_scan_chunked(*x, chunk=L_), tol))

    hold_k6([((2, 64, 3, 8, 8), 16, "mixed"), ((1, 32, 2, 16, 16), 32, "mixed"),
             ((2, 48, 1, 8, 8), 16, "mixed"), ((1, 64, 4, 64, 40), 32, "mixed"),
             ((1, 64, 4, 16, 16), 32, "strong"), ((1, 64, 4, 16, 16), 32, "weak"),
             ((1, rS, rH, rK, rK), rL, "mixed"), ((1, rS, rH, rK, rK), rL, "strong"),
             ((8, 128, rH, rK, rK), rL, "mixed")])
    # the plan's edges under the tiling: V ragged against the 64-column tile
    # (V 40 above is against the 16-column one), T past the 32-step stages
    # and shorter than the ring, T one stage at batch 8 (whole-head blocks in
    # two waves, whose first stage is read soon after it is issued: a ring
    # wait one stage short shows here and at no batch-1 shape), one head (4
    # blocks), V = 6 (rows of 12 or 24 bytes: element-wise), the served shape
    # with r off a 16-byte boundary (element-wise), and the served shape with
    # L2 flushed before each run.  Drawn from a fork of the generator, so
    # later phases draw what they did before.
    gen_state = gen.get_state()
    hold_k6([((4, 40, 32, 64, 72), 40, "mixed"), ((1, 50, 4, 64, 64), 50, "mixed"),
             ((2, 5, 3, 16, 16), 5, "mixed"), ((8, 32, rH, rK, rK), 32, "mixed"),
             ((1, 64, 1, 64, 64), 64, "mixed"), ((2, 40, 2, 8, 6), 40, "mixed")])
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        x = list(rwkv_inputs(1, 64, rH, rK, rK, dt))
        buf = torch.empty(x[0].numel() + 1, dtype=dt, device=dev)
        x[0] = buf[1:].view(x[0].shape).copy_(x[0])
        case = f"{dn} (1, 64, {rH}, {rK}, {rK}) r at +{x[0].element_size()} bytes {scan_case(x)}"
        err6 = max(err6, hold_rel(f"{case} vs serial", scan_twice(x, 64),
                                  ref.rwkv6_scan_ref(*x), TOL[dn]))
        del buf
        x = rwkv_inputs(1, rS, rH, rK, rK, dt)
        err6 = max(err6, hold_rel(f"{dn} {(1, rS, rH, rK, rK)} L2 flushed before each run "
                                  f"{scan_case(x)} vs serial", scan_twice(x, rL, cold=True),
                                  ref.rwkv6_scan_ref(*x), TOL[dn]))
    gen.set_state(gen_state)
    k6_times = {}
    for B_, T_ in ((1, rS), (8, 128)):  # the served prefill, and batch 8
        x = rwkv_inputs(B_, T_, rH, rK, rK, torch.bfloat16)
        out_bytes = B_ * T_ * rH * rK * 2 + x[5].numel() * 4
        k6_times[B_] = timed(lambda: k6.rwkv6_scan(*x, chunk=rL),
                             lambda: ref.rwkv6_scan_chunked(*x, chunk=rL), None,
                             nbytes(*x) + out_bytes, 4 * B_ * T_ * rH * rK * rK, peaks["float32"],
                             f"B={B_} T={T_} H={rH} K=V={rK} r/k/v/u bf16, w/state f32, "
                             f"chunk {rL}")
    del x
    records["rwkv6_scan"] = {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:80", "max_abs_err": err6,
        **k6_times[1], "batch8": k6_times[8],
    }
    # K5: the CPU tests' shapes (a ragged channel tile at DI = 40 = 32 + 8),
    # strong and weak decays, and jamba-1.5-large's prefill shape (chunk 256)
    # at batch 1 and 8; every case starts from a non-zero state.  Each is held
    # against the serial oracle and the chunked form, relative to max |y| and
    # max |state|, and runs twice into NaN-filled memory (mamba_twice).
    jS, jL = JAMBA_SERVE["prompt_len"], jfull.mamba.chunk

    def mamba_inputs(B, T, DI, N, dt_, decay="mixed"):
        """x, dt, A, Bm, C, D, state; the laws of tests/test_torch_kernels.py:
        "strong" puts every decay exp(dt A) below e^-40, "weak" dt below 1e-3."""
        def unif(*shape):
            return torch.rand(shape, generator=gen, device=dev)
        if decay == "strong":
            dt, A = 2 + 3 * unif(B, T, DI), -torch.exp(3 + unif(DI, N))
        else:
            dt = unif(B, T, DI) * 1e-3 if decay == "weak" else F.softplus(randn(B, T, DI))
            A = -torch.exp(randn(DI, N) * 0.3)
        return (randn(B, T, DI, dtype=dt_), dt.to(dt_), A, randn(B, T, N, dtype=dt_),
                randn(B, T, N, dtype=dt_), randn(DI), randn(B, DI, N) * 0.1)

    def mamba_twice(x, chunk, cold=False):
        """K5 twice on the same inputs, each time into the blocks the caching
        allocator last freed, filled with NaN just before (so an output the
        kernel leaves unwritten shows); the two results must be the same
        bytes (a race in the cp.async ring shows as a difference).  With
        ``cold``, L2 is flushed before each run, so the ring's stages come
        from device memory and a stage read before it lands shows."""
        outs = []
        for _ in range(2):
            nan_y, nan_s = torch.full_like(x[0], float("nan")), torch.full_like(x[6], float("nan"))
            del nan_y, nan_s
            if cold:
                flush_buf.zero_()
            outs.append(k5.mamba_scan(*x, chunk=chunk))
        for a, b_ in zip(*outs):
            if not torch.equal(a.view(torch.uint8), b_.view(torch.uint8)):
                fail(f"mamba_scan {tuple(x[0].shape)} N={x[2].shape[1]} {x[0].dtype}: "
                     "two runs differ")
        return outs[0]

    def mamba_case(x) -> str:
        """The plan a K5 launch takes, and whether its ring is filled by
        16-byte cp.async copies or element by element."""
        B_, _, DI_ = x[0].shape
        N_ = x[2].shape[1]
        p = k5.mamba_plan(B_, DI_, N_, x[0].element_size(), n_sm)
        vec = (all(t.data_ptr() % 16 == 0 for t in (x[0], x[1], x[3], x[4]))
               and DI_ * x[0].element_size() % 16 == 0 and N_ * x[0].element_size() % 16 == 0)
        return (f"[{p.channels} channels x {p.steps}-step stages a block, "
                f"{p.grid[0] * p.grid[1]} blocks, {p.waves} wave(s), "
                f"{'cp.async' if vec else 'element-wise'}]")

    err5 = 0.0

    def hold_k5(cases, dt, cold=False) -> None:
        nonlocal err5
        dn = str(dt).removeprefix("torch.")
        for (B_, T_, DI_, N_), L_, decay in cases:
            x = mamba_inputs(B_, T_, DI_, N_, dt, decay)
            got = mamba_twice(x, L_, cold)
            case = (f"{dn} {(B_, T_, DI_, N_)} chunk {L_} {decay} decays"
                    f"{' L2 flushed before each run' if cold else ''} {mamba_case(x)}")
            forms = [("serial", ref.mamba_scan_ref(*x))]
            if not cold:
                forms.append(("chunked", ref.mamba_scan_chunked(*x, chunk=L_)))
            for form, want in forms:
                err5 = max(err5, hold_rel(f"{case} vs {form}", got, want, TOL[dn], "mamba_scan"))

    k5_cases = [((2, 64, 12, 4), 16, "mixed"), ((1, 32, 8, 8), 32, "mixed"),
                ((2, 64, 40, 16), 32, "mixed"), ((1, 64, 12, 8), 16, "strong"),
                ((1, 64, 12, 8), 16, "weak"), ((1, jS, jDI, jN), jL, "mixed"),
                ((1, jS, jDI, jN), jL, "strong"), ((1, jS, jDI, jN), jL, "weak"),
                ((8, jS, jDI, jN), jL, "mixed")]
    for dt in (torch.float32, torch.bfloat16):
        hold_k5(k5_cases, dt)
    # the plan's edges: T = 50 (past the 4-step group and the 16- to 64-step
    # stage), DI ragged against the 32- and 64-channel tiles (1000 = 31 x 32
    # + 8, 200 = 3 x 64 + 8), T of exactly one ring stage at batch 8 (a ring
    # wait one stage short shows there and at no batch-1 shape in K6), and
    # the served shape with L2 flushed before each run.  Drawn from a fork of
    # the generator, so later phases draw what they did before.
    gen_state = gen.get_state()
    for dt in (torch.float32, torch.bfloat16):
        one = k5.mamba_plan(8, jDI, jN, torch.finfo(dt).bits // 8, n_sm).steps
        hold_k5([((2, 50, 40, 16), 50, "mixed"), ((1, 50, 64, 8), 50, "mixed"),
                 ((1, 64, 1000, 16), 64, "mixed"), ((2, 64, 200, 8), 64, "mixed"),
                 ((8, one, jDI, jN), one, "mixed")], dt)
        hold_k5([((1, jS, jDI, jN), jL, "mixed")], dt, cold=True)
    gen.set_state(gen_state)
    k5_times = {}
    for B_ in (1, 8):  # the served prefill, and batch 8
        x = mamba_inputs(B_, jS, jDI, jN, torch.bfloat16)
        n_el = B_ * jS * jDI * jN
        # per state element and step: dt·A, the decay product, (dt x)·B, the
        # sum, C·h and its sum (5 FLOPs) and one exponential; per channel
        # and step dt·x and D·x + y (3 FLOPs)
        n_bytes, n_flops = nbytes(*x, x[0], x[6]), 5 * n_el + 3 * B_ * jS * jDI
        k5_times[B_] = timed(lambda: k5.mamba_scan(*x, chunk=jL),
                             lambda: ref.mamba_scan_chunked(*x, chunk=jL), None, n_bytes, n_flops,
                             peaks["float32"], f"B={B_} T={jS} DI={jDI} N={jN} x/dt/B/C bf16, "
                             f"A/D/state f32, chunk {jL}", n_exps=n_el)
        k5_times[B_]["bound_parts_ms"] = {"bytes": 1e3 * n_bytes / peaks["bytes_per_s"],
                                          "flops": 1e3 * n_flops / peaks["float32"],
                                          "exponentials": 1e3 * n_el / peaks["exp_per_s"]}
        print(f"  mamba_scan bound parts at B={B_}: {json.dumps(k5_times[B_]['bound_parts_ms'])}",
              flush=True)
    del x
    records["mamba_scan"] = {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:65", "max_abs_err": err5,
        **k5_times[1], "batch8": k5_times[8],
    }

    # K1, K2, K4 at jamba-1.5-large's shapes: head dim 128 with 8 query
    # heads per KV head, d 8192, and 16 experts of 8192 x 24576 at the
    # prefill and decode capacities
    jHq, jHkv, jD = jfull.n_heads, jfull.n_kv_heads, jfull.head_dim
    jB, jSc, jdm = JAMBA_SERVE["max_batch"], JAMBA_SERVE["max_seq"], jfull.d_model
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        q, k, v = (randn(1, jS, h, jD, dtype=dt) for h in (jHq, jHkv, jHkv))
        err1 = max(err1, hold("flash_attention", f"{dn} {JAMBA_ARCH} 1x{jS}x{jHq}/{jHkv}x{jD}",
                              k1.flash_attention(q, k, v), ref.mha_ref(q, k, v), dn))
        qd, kc, vc = randn(jB, jHq, jD, dtype=dt), randn(jB, jSc, jHkv, jD, dtype=dt), \
            randn(jB, jSc, jHkv, jD, dtype=dt)
        pos = torch.arange(jSc, dtype=torch.int32, device=dev)[None].repeat(jB, 1)
        cur = torch.full((jB,), jSc - 1, dtype=torch.int32, device=dev)
        err2 = max(err2, hold("decode_attention", f"{dn} {JAMBA_ARCH} {jB}x{jSc}x{jHq}/{jHkv}x{jD}",
                              k2.decode_attention(qd, kc, vc, pos, cur),
                              ref.decode_attention_ref(qd, kc, vc, pos, cur), dn))
    jamba_shape_times = {  # bf16, the last dtype above
        "flash_attention": timed(
            lambda: k1.flash_attention(q, k, v), lambda: ref.mha_ref(q, k, v),
            (lambda qs=q.transpose(1, 2).contiguous(), ks_=k.transpose(1, 2).contiguous(),
             vs_=v.transpose(1, 2).contiguous(): F.scaled_dot_product_attention(
                 qs, ks_, vs_, is_causal=True, enable_gqa=True)),
            nbytes(q, k, v, q), 4 * jD * jHq * (jS * (jS + 1) // 2), peaks["bfloat16"],
            f"B=1 S={jS} Hq={jHq} Hkv={jHkv} D={jD} bf16 causal"),
        "decode_attention": timed(
            lambda: k2.decode_attention(qd, kc, vc, pos, cur),
            lambda: ref.decode_attention_ref(qd, kc, vc, pos, cur),
            (lambda qs=qd[:, :, None], ks_=kc.transpose(1, 2).contiguous(),
             vs_=vc.transpose(1, 2).contiguous(): F.scaled_dot_product_attention(
                 qs, ks_, vs_, enable_gqa=True)),
            nbytes(qd, kc, vc, qd, pos, cur), 4 * jD * jHq * jB * jSc, peaks["bfloat16"],
            f"B={jB} S={jSc} Hq={jHq} Hkv={jHkv} D={jD} bf16, all {jB * jSc} slots live"),
    }
    del q, k, v, qd, kc, vc
    jm = jfull.moe
    jcaps = {"prefill": ffn_mod._capacity(jS, jm), "decode": ffn_mod._capacity(jB, jm)}  # 80, 8
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for D_, F_, epi in ((jdm, jm.d_expert, "silu"), (jm.d_expert, jdm, None)):
            x = randn(jm.n_experts, jcaps["prefill"], D_, dtype=dt)
            w = (randn(jm.n_experts, D_, F_) * 0.02).to(dt)
            err4 = max(err4, hold("moe_gmm", f"{dn} {JAMBA_ARCH} prefill ({jm.n_experts},"
                                  f"{jcaps['prefill']},{D_})@({jm.n_experts},{D_},{F_}) "
                                  f"epilogue={epi} [{gmm_instance(x, w)}]", gmm_twice(x, w, epi),
                                  ref.gmm_ref(x, w, epilogue=epi), dn))
            del x, w
    w = (randn(jm.n_experts, jdm, jm.d_expert) * 0.02).to(torch.bfloat16)
    for phase, C_ in jcaps.items():  # the w1 / w3 product, bf16, no epilogue
        x = randn(jm.n_experts, C_, jdm, dtype=torch.bfloat16)
        jamba_shape_times[f"moe_gmm {phase}"] = timed(
            lambda: k4.gmm(x, w), lambda: ref.gmm_ref(x, w), lambda: torch.bmm(x, w),
            nbytes(x, w) + jm.n_experts * C_ * jm.d_expert * 2,
            2 * jm.n_experts * C_ * jdm * jm.d_expert, peaks["bfloat16"],
            f"({jm.n_experts},{C_},{jdm})@({jm.n_experts},{jdm},{jm.d_expert}) bf16 ({phase})")
    del x, w
    torch.cuda.empty_cache()

    # K1 and K2 at head dim 256 (gemma3-4b) and at gemma2-27b's shapes, in
    # f32 and bf16: the CPU tests' D-256 cases (GQA 2, a window that starts
    # inside a tile, a softcap, the queries as the last 40 of 100 keys with
    # both; a wrapped 40-slot ring with window 8 and a softcap), then each
    # model's served shapes: gemma3's prefill (1, 1536, 8/4, 256) with its
    # local layers' window of 1024 and without it (its global layers),
    # gemma2's (1, 512, 32/16, 128) with softcap 50 (its window of 4096
    # never masks at 512); gemma3's decode tick at a global layer's 2048
    # slots, at a local layer's wrapped 1024-slot ring with window 1024 and
    # with window 1000 (starting inside a tile), gemma2's at 1024 slots with
    # softcap 50.  The decode rows stand where the serve sets' ticks stand
    # (prompt_len + 16 + row), so every row has a live slot (R9).  Each
    # served shape is timed in bf16 with L2 flushed, beside its bound, the
    # plain version and SDPA (which has no softcap: at gemma2's shapes it
    # is timed without one, as sdpa_without_softcap_ms).  Drawn from a fork of the
    # generator, so later phases draw what they did before.
    g2 = get_config(GEMMA2_ARCH)
    gen_state = gen.get_state()
    g3S, g2S = GEMMA3_SERVE["prompt_len"], GEMMA2_SERVE["prompt_len"]
    k1_gemma = [("D-256 GQA", 1, 64, 64, 4, 2, 256, None, None, 0),
                ("D-256 window", 1, 64, 64, 4, 2, 256, 24, None, 0),
                ("D-256 softcap", 1, 64, 64, 4, 2, 256, None, 50.0, 0),
                ("D-256 q_offset", 1, 40, 100, 4, 2, 256, 37, 30.0, 60),
                (f"{GEMMA3_ARCH} local", 1, g3S, g3S, g3.n_heads, g3.n_kv_heads, g3.head_dim,
                 g3.sliding_window, None, 0),
                (f"{GEMMA3_ARCH} global", 1, g3S, g3S, g3.n_heads, g3.n_kv_heads, g3.head_dim,
                 None, None, 0),
                (GEMMA2_ARCH, 1, g2S, g2S, g2.n_heads, g2.n_kv_heads, g2.head_dim, None,
                 g2.attn_logit_softcap, 0)]
    k2_gemma = [("D-256 ring window", 2, 40, 4, 2, 256, 8, 30.0, [57, 70], True),
                (f"{GEMMA3_ARCH} global", GEMMA3_SERVE["max_batch"], GEMMA3_SERVE["max_seq"],
                 g3.n_heads, g3.n_kv_heads, g3.head_dim, None, None, None, False),
                (f"{GEMMA3_ARCH} local", GEMMA3_SERVE["max_batch"], g3.sliding_window,
                 g3.n_heads, g3.n_kv_heads, g3.head_dim, g3.sliding_window, None, None, True),
                (f"{GEMMA3_ARCH} local window 1000", GEMMA3_SERVE["max_batch"], g3.sliding_window,
                 g3.n_heads, g3.n_kv_heads, g3.head_dim, 1000, None, None, True),
                (GEMMA2_ARCH, GEMMA2_SERVE["max_batch"], GEMMA2_SERVE["max_seq"], g2.n_heads,
                 g2.n_kv_heads, g2.head_dim, None, g2.attn_logit_softcap, None, False)]
    gemma_times = {}
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for label, B_, Sq_, Sk_, Hq_, Hkv_, D_, w, cap, qo in k1_gemma:
            qe, ke, ve = (randn(B_, n, h, D_, dtype=dt)
                          for n, h in ((Sq_, Hq_), (Sk_, Hkv_), (Sk_, Hkv_)))
            kw = dict(window=w, softcap=cap, q_offset=qo)
            err1 = max(err1, hold("flash_attention", f"{dn} {label} {B_}x{Sq_}x{Sk_}x{Hq_}/{Hkv_}"
                                  f"x{D_} w={w} cap={cap} q_offset={qo}",
                                  k1.flash_attention(qe, ke, ve, **kw),
                                  ref.mha_ref(qe, ke, ve, **kw), dn))
            if dt != torch.bfloat16 or label.startswith("D-256"):
                continue
            qi, ki = torch.arange(Sq_, device=dev)[:, None] + qo, torch.arange(Sk_, device=dev)
            mask = (ki <= qi) & ((ki > qi - w) if w else True)
            pairs_ = int(mask.sum()) * B_
            shape = (f"B={B_} S={Sq_} Hq={Hq_} Hkv={Hkv_} D={D_} bf16 causal w={w} cap={cap} "
                     f"({k1.instance(dt, D_)})")
            gemma_times[f"flash_attention {label}"] = timed(
                lambda: k1.flash_attention(qe, ke, ve, **kw), lambda: ref.mha_ref(qe, ke, ve, **kw),
                (lambda qs=qe.transpose(1, 2).contiguous(), ks_=ke.transpose(1, 2).contiguous(),
                 vs_=ve.transpose(1, 2).contiguous(), m_=mask if w else None: (
                     F.scaled_dot_product_attention(qs, ks_, vs_, attn_mask=m_, enable_gqa=True)
                     if w else F.scaled_dot_product_attention(qs, ks_, vs_, is_causal=True,
                                                              enable_gqa=True))),
                nbytes(qe, ke, ve, qe), 4 * D_ * Hq_ * pairs_, peaks["bfloat16"], shape)
            if cap:  # no PyTorch call applies a softcap: SDPA without it, a yardstick only
                t = gemma_times[f"flash_attention {label}"]
                t["sdpa_without_softcap_ms"], t["library_ms"] = t["library_ms"], None
        for label, B_, S_, Hq_, Hkv_, D_, w, cap, curs, ring in k2_gemma:
            if curs is None:  # a serve set's tick: prompt_len + 16 + row
                curs = [(g3S if D_ == 256 else g2S) + 16 + i for i in range(B_)]
            qe, kce, vce = randn(B_, Hq_, D_, dtype=dt), randn(B_, S_, Hkv_, D_, dtype=dt), \
                randn(B_, S_, Hkv_, D_, dtype=dt)
            pose = (ring_pos(B_, S_, curs) if ring else
                    torch.arange(S_, dtype=torch.int32, device=dev)[None].repeat(B_, 1))
            cure = torch.tensor(curs, dtype=torch.int32, device=dev)
            kw = dict(window=w, softcap=cap)
            got = k2.decode_attention(qe, kce, vce, pose, cure, **kw)
            n_split, chunk = k2.split_plan(B_, Hkv_, S_, n_sm_card)
            case = f"{dn} {label} {B_}x{S_}x{Hq_}/{Hkv_}x{D_} w={w} cap={cap}"
            err2 = max(err2, hold("decode_attention", case, got,
                                  ref.decode_attention_ref(qe, kce, vce, pose, cure, **kw), dn))
            err2 = max(err2, hold("decode_attention", f"{case} vs split ref {n_split}x{chunk}",
                                  got, ref.decode_attention_split_ref(
                                      qe, kce, vce, pose, cure, n_split=n_split, chunk=chunk,
                                      **kw), dn))
            if dt != torch.bfloat16 or label.startswith("D-256") or w == 1000:
                continue
            live_ = (pose >= 0) & (pose <= cure[:, None])
            if w:
                live_ &= pose > cure[:, None] - w
            n_live_ = int(live_.sum())
            gemma_times[f"decode_attention {label}"] = timed(
                lambda: k2.decode_attention(qe, kce, vce, pose, cure, **kw),
                lambda: ref.decode_attention_ref(qe, kce, vce, pose, cure, **kw),
                (lambda qs=qe[:, :, None], ks_=kce.transpose(1, 2).contiguous(),
                 vs_=vce.transpose(1, 2).contiguous(), m_=live_[:, None, None, :]:
                 F.scaled_dot_product_attention(qs, ks_, vs_, attn_mask=m_, enable_gqa=True)),
                2 * n_live_ * Hkv_ * D_ * kce.element_size() + nbytes(qe, qe, pose, cure),
                4 * D_ * Hq_ * n_live_, peaks["bfloat16"],
                f"B={B_} S={S_} Hq={Hq_} Hkv={Hkv_} D={D_} bf16 w={w} cap={cap}, {n_live_} live "
                f"slots ({' + '.join(k2.instances(dt, D_))}, split {(n_split, chunk)})")
            if cap:
                t = gemma_times[f"decode_attention {label}"]
                t["sdpa_without_softcap_ms"], t["library_ms"] = t["library_ms"], None
    del qe, ke, ve, kce, vce, pose, cure, got
    gen.set_state(gen_state)
    torch.cuda.empty_cache()

    # K1 and K2 at the M10 sets' new shapes, in f32 and bf16: musicgen-large's
    # head dim 64 with one query head per KV head (G 1) and dbrx-132b's head
    # dim 128 with 6 (G 6) (chameleon-34b's 64 / 8 x 128 are jamba's, above):
    # the 512-token prefill, and the tick at 1024 slots where the serve sets'
    # ticks stand (prompt_len + 16 + row live slots), also against the
    # split-KV plain version at the kernel's own split.  Then K4 at dbrx's
    # grouped matmuls, 16 experts of 6144 x 10752 at the prefill and decode
    # capacities (w1 with silu, and w2 back), twice into NaN-filled memory,
    # on gmm_mma in bf16.  Each timed in bf16 with L2 flushed beside its
    # bound, the plain version and SDPA (with a bool mask at the tick) or
    # torch.bmm (the w1 / w3 product).  Drawn from a fork of the generator,
    # so later phases draw what they did before.
    mg = get_config(MUSICGEN_ARCH)
    gen_state = gen.get_state()
    m10_times: dict[str, dict] = {MUSICGEN_ARCH: {}, DBRX_ARCH: {}}
    mS_, mB_, mSc_ = M10_SERVE["prompt_len"], M10_SERVE["max_batch"], M10_SERVE["max_seq"]
    for arch_, c_ in ((MUSICGEN_ARCH, mg), (DBRX_ARCH, db)):
        Hq_, Hkv_, D_ = c_.n_heads, c_.n_kv_heads, c_.head_dim
        curs = [mS_ + 16 + i for i in range(mB_)]
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).removeprefix("torch.")
            q, k, v = (randn(1, mS_, h, D_, dtype=dt) for h in (Hq_, Hkv_, Hkv_))
            err1 = max(err1, hold("flash_attention", f"{dn} {arch_} 1x{mS_}x{Hq_}/{Hkv_}x{D_}",
                                  k1.flash_attention(q, k, v), ref.mha_ref(q, k, v), dn))
            qd, kc, vc = randn(mB_, Hq_, D_, dtype=dt), randn(mB_, mSc_, Hkv_, D_, dtype=dt), \
                randn(mB_, mSc_, Hkv_, D_, dtype=dt)
            pos = torch.arange(mSc_, dtype=torch.int32, device=dev)[None].repeat(mB_, 1)
            cur = torch.tensor(curs, dtype=torch.int32, device=dev)
            got = k2.decode_attention(qd, kc, vc, pos, cur)
            n_split, chunk = k2.split_plan(mB_, Hkv_, mSc_, n_sm_card)
            case = f"{dn} {arch_} {mB_}x{mSc_}x{Hq_}/{Hkv_}x{D_}"
            err2 = max(err2, hold("decode_attention", case, got,
                                  ref.decode_attention_ref(qd, kc, vc, pos, cur), dn))
            err2 = max(err2, hold("decode_attention", f"{case} vs split ref {n_split}x{chunk}",
                                  got, ref.decode_attention_split_ref(
                                      qd, kc, vc, pos, cur, n_split=n_split, chunk=chunk), dn))
        live_ = (pos >= 0) & (pos <= cur[:, None])  # bf16, the last dtype above
        n_live_ = int(live_.sum())
        m10_times[arch_]["flash_attention"] = timed(
            lambda: k1.flash_attention(q, k, v), lambda: ref.mha_ref(q, k, v),
            (lambda qs=q.transpose(1, 2).contiguous(), ks_=k.transpose(1, 2).contiguous(),
             vs_=v.transpose(1, 2).contiguous(): F.scaled_dot_product_attention(
                 qs, ks_, vs_, is_causal=True, enable_gqa=True)),
            nbytes(q, k, v, q), 4 * D_ * Hq_ * (mS_ * (mS_ + 1) // 2), peaks["bfloat16"],
            f"B=1 S={mS_} Hq={Hq_} Hkv={Hkv_} D={D_} bf16 causal ({k1.instance(dt, D_)})")
        m10_times[arch_]["decode_attention"] = timed(
            lambda: k2.decode_attention(qd, kc, vc, pos, cur),
            lambda: ref.decode_attention_ref(qd, kc, vc, pos, cur),
            (lambda qs=qd[:, :, None], ks_=kc.transpose(1, 2).contiguous(),
             vs_=vc.transpose(1, 2).contiguous(), m_=live_[:, None, None, :]:
             F.scaled_dot_product_attention(qs, ks_, vs_, attn_mask=m_, enable_gqa=True)),
            2 * n_live_ * Hkv_ * D_ * kc.element_size() + nbytes(qd, qd, pos, cur),
            4 * D_ * Hq_ * n_live_, peaks["bfloat16"],
            f"B={mB_} S={mSc_} Hq={Hq_} Hkv={Hkv_} D={D_} bf16, {n_live_} live slots "
            f"({' + '.join(k2.instances(dt, D_))}, split {k2.split_plan(mB_, Hkv_, mSc_, n_sm_card)})")
        del q, k, v, qd, kc, vc, got
    dbm = db.moe
    dcaps = {"prefill": ffn_mod._capacity(mS_, dbm), "decode": ffn_mod._capacity(mB_, dbm)}
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for D_, F_, epi in ((db.d_model, dbm.d_expert, "silu"), (dbm.d_expert, db.d_model, None)):
            w = (randn(dbm.n_experts, D_, F_) * 0.02).to(dt)
            for phase, C_ in dcaps.items():
                x = randn(dbm.n_experts, C_, D_, dtype=dt)
                err4 = max(err4, hold("moe_gmm", f"{dn} {DBRX_ARCH} {phase} ({dbm.n_experts},{C_},"
                                      f"{D_})@({dbm.n_experts},{D_},{F_}) epilogue={epi} "
                                      f"[{gmm_instance(x, w)}]", gmm_twice(x, w, epi),
                                      ref.gmm_ref(x, w, epilogue=epi), dn))
                if dt == torch.bfloat16 and gmm_instance(x, w) != "gmm_mma":
                    fail(f"moe_gmm {DBRX_ARCH} {phase} took {gmm_instance(x, w)}, not gmm_mma")
            del x, w
    w = (randn(dbm.n_experts, db.d_model, dbm.d_expert) * 0.02).to(torch.bfloat16)
    for phase, C_ in dcaps.items():  # the w1 / w3 product, bf16, no epilogue
        x = randn(dbm.n_experts, C_, db.d_model, dtype=torch.bfloat16)
        m10_times[DBRX_ARCH][f"moe_gmm {phase}"] = timed(
            lambda: k4.gmm(x, w), lambda: ref.gmm_ref(x, w), lambda: torch.bmm(x, w),
            nbytes(x, w) + dbm.n_experts * C_ * dbm.d_expert * 2,
            2 * dbm.n_experts * C_ * db.d_model * dbm.d_expert, peaks["bfloat16"],
            f"({dbm.n_experts},{C_},{db.d_model})@({dbm.n_experts},{db.d_model},{dbm.d_expert}) "
            f"bf16 ({phase}, {gmm_instance(x, w)})")
    del x, w
    gen.set_state(gen_state)
    torch.cuda.empty_cache()
    for name in ("flash_attention", "decode_attention"):
        records[name]["max_abs_err"] = {"flash_attention": err1, "decode_attention": err2}[name]
        records[name][MOE_ARCH] = moe_shape_times[name]
    records["moe_gmm"]["max_abs_err"] = err4
    for name in ("flash_attention", "decode_attention", "moe_gmm"):
        records[name][JAMBA_ARCH] = {k: v for k, v in jamba_shape_times.items()
                                     if k.split()[0] == name}
        for arch_, times_ in m10_times.items():
            if any(k.split()[0] == name for k in times_):
                records[name][arch_] = {k: v for k, v in times_.items() if k.split()[0] == name}
    for name in ("flash_attention", "decode_attention"):
        records[name]["gemma"] = {k.split(" ", 1)[1]: v for k, v in gemma_times.items()
                                  if k.split()[0] == name}
        records[name]["d256_instances"] = {k: v for k, v in d256_info.items()
                                           if k.startswith(name.split("_")[0])}
    for r in records.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {fmt_ms(r['library_ms'])}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}) at {r['shape']}", flush=True)
    others = [(f"{name} at {MOE_ARCH}'s shape", t) for name, t in moe_shape_times.items()]
    others += [(f"moe_gmm decode at {MOE_ARCH}'s shape", k4_times["decode"]),
               ("moe_gmm WMMA instance at a ragged F", k4_times["wmma ragged"]),
               ("rwkv6_scan at batch 8", k6_times[8]), ("mamba_scan at batch 8", k5_times[8])]
    others += [(f"{name} at {JAMBA_ARCH}'s shape", t) for name, t in jamba_shape_times.items()]
    others += [(f"{name} at the served shape", t) for name, t in gemma_times.items()]
    others += [(f"{name} at {arch_}'s shape", t) for arch_, times_ in m10_times.items()
               for name, t in times_.items()]
    for name, t in others:
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {fmt_ms(t['library_ms'])}, bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}) at {t['shape']}", flush=True)

    def queued_ms(fn, n: int) -> float:
        """Device time per call of ``n`` calls of ``fn`` issued back to back
        behind a sleep kernel long enough that the host has queued them all
        before the first runs."""
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000_000)  # ~0.5 s of GPU clock cycles
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    # K3 inside a CUDA graph: GRAPH_LAUNCHES launches at qwen2's decode rows
    # (8, 896) bf16 captured once and one replay timed, per launch, beside
    # the same launches issued eagerly back to back and the empty kernel
    # both ways; the replay's output must be the eager call's bytes.  This
    # comes after phase 3's one profile (K4 on an unaligned view): on some of
    # the card's machines that profile saw no kernel at all when a graph
    # capture, or another profiler session, came before it in the process.
    x = randn(B, dm, dtype=torch.bfloat16)
    s = randn(dm) * 0.1
    want = k3.rmsnorm(x, s)
    side = torch.cuda.Stream()
    in_graph = {}
    for name, fn in (("rmsnorm", lambda: k3.rmsnorm(x, s)),
                     ("launch_floor", lambda: k3.launch_floor(dev))):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm on the capture stream
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with uncounted(), torch.cuda.graph(g, stream=side):
            outs = [fn() for _ in range(GRAPH_LAUNCHES)]
        in_graph[name] = {"graph_ms_per_launch": time_ms(g.replay) / GRAPH_LAUNCHES,
                          "eager_queued_ms_per_launch": queued_ms(fn, GRAPH_LAUNCHES)}
        g.replay()
        torch.cuda.synchronize()
        if name == "rmsnorm" and not all(torch.equal(o.view(torch.uint8), want.view(torch.uint8))
                                         for o in outs):
            fail("rmsnorm replayed in a CUDA graph differs from its eager call")
        del g, outs
    print(f"  rmsnorm ({B}, {dm}) bf16 and the empty kernel, {GRAPH_LAUNCHES} launches in one "
          f"CUDA graph against the same launches issued eagerly, ms per launch: "
          f"{json.dumps(in_graph)} (one launch between events: kernel "
          f"{times3[(B, dm)]['ms']:.4f}, floor {floor_ms:.4f})", flush=True)
    records["rmsnorm"]["in_graph"] = in_graph

    def init_model(c) -> tuple[dict, dict]:
        """Seeded random weights drawn on the card, with the draw's time, the
        memory already held before it and the peak."""
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        t0 = time.time()
        p = lm.init_params(c, SEED, device=dev)
        torch.cuda.synchronize()
        rec = {"seconds": time.time() - t0, "held_before_gb": held,
               "params_b": sum(t.numel() for t in _leaves(p)) / 1e9,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "weights_gb": sum(t.numel() * t.element_size() for t in _leaves(p)) / 1e9}
        print(f"init {c.name}: {json.dumps(rec)}", flush=True)
        return p, rec

    def serve_run(c, p, spec: dict, compiled: bool = True) -> tuple:
        """Serve ``spec["requests"]`` random prompts (drawn from SEED) through
        the port's Engine (compiled, its default, or ``compiled=False``),
        with the launch counts reset just before; fails unless every
        request is delivered in full.  Returns (engine, prompts, each
        request's tokens, the run's record)."""
        log = EventLog()
        eng = Engine(c, p, ServeConfig(max_batch=spec["max_batch"], max_seq=spec["max_seq"],
                                       seed=SEED), log=log, compiled=compiled)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, c.vocab_size, spec["prompt_len"]).tolist()
                   for _ in range(spec["requests"])]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        rids = [eng.submit(pr, max_new=spec["max_new"]) for pr in prompts]
        results = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.time() - t0
        outs = [results.get(rid, []) for rid in rids]
        gen_tokens = sum(len(v) for v in results.values())
        prefill_ms = [1e3 * d for d in log.durations("prefill")]
        tick_ms = [1e3 * d for d in log.durations("decode_tick")]
        # compiled: the first of each runs eagerly, the second captures
        first_two = {"prefill_ms": prefill_ms[:2], "decode_tick_ms": tick_ms[:2]}
        rec = {
            "arch": c.name, "compiled": compiled, **spec, "generated_tokens": gen_tokens,
            "wall_s": wall, "tokens_per_s": gen_tokens / wall,
            "mean_prefill_ms": float(np.mean(prefill_ms)),
            "median_prefill_ms": float(np.median(prefill_ms)),
            "mean_decode_tick_ms": float(np.mean(tick_ms)),
            "median_decode_tick_ms": float(np.median(tick_ms)), "decode_ticks": len(tick_ms),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "kernels": launch_counts(),
            "graphs": eng.compiled_counts(), "first_two": first_two,
        }
        print(f"serve: {json.dumps(rec)}", flush=True)
        if len(results) != len(rids) or any(len(v) != spec["max_new"] for v in outs):
            fail(f"{c.name}: serving did not deliver every request in full")
        return eng, prompts, outs, rec

    def serve_both(c, p, spec: dict) -> tuple:
        """The serve set through ``Engine(compiled=False)``, freed, then
        through the default compiled engine (whose CUDA graphs the card
        replays), in one call.  Returns the compiled run's (engine, prompts,
        tokens, record) and the eager run's (tokens, record)."""
        eager_eng, _, eager_outs, eager_rec = serve_run(c, p, spec, compiled=False)
        del eager_eng
        gc.collect()
        torch.cuda.empty_cache()
        return (*serve_run(c, p, spec), eager_outs, eager_rec)

    def check_compiled(c, spec: dict, rec: dict, outs: list, eager_rec: dict,
                       eager_outs: list) -> dict:
        """The compiled run against the eager one: the same launches, the
        replays the warm-up order makes (the first decode tick and the first
        prefill of the one prompt length run eagerly, the second of each
        captures and replays, every later one replays), and every request's
        tokens."""
        ticks, n_req = rec["decode_ticks"], spec["requests"]
        if eager_rec["kernels"] != rec["kernels"]:
            fail(f"{c.name}: launch counts compiled {rec['kernels']} against eager "
                 f"{eager_rec['kernels']}")
        want = {"decode": {"calls": ticks, "captures": 1, "replays": ticks - 1},
                "prefill": {spec["prompt_len"]: {"calls": n_req, "captures": 1,
                                                 "replays": n_req - 1}},
                "prefill_evictions": 0}
        if rec["graphs"] != want:
            fail(f"{c.name}: compiled steps {rec['graphs']}, expected {want}")
        same = sum(a == b for a, b in zip(outs, eager_outs))
        summary = {
            "requests_with_equal_tokens": same, "requests": n_req,
            "decode_replays": ticks - 1, "prefill_replays": n_req - 1,
            "first_two_compiled": rec["first_two"],
            **{f"{k}_{run}": r[k] for run, r in (("eager", eager_rec), ("compiled", rec))
               for k in ("tokens_per_s", "wall_s", "median_decode_tick_ms",
                         "median_prefill_ms", "peak_mem_gb")},
        }
        print(f"{c.name} compiled vs eager serve set: {json.dumps(summary)}", flush=True)
        if same != n_req:
            bad = next(i for i, (a, b) in enumerate(zip(outs, eager_outs)) if a != b)
            fail(f"{c.name}: the compiled engine's tokens differ from the eager engine's in "
                 f"{n_req - same} of {n_req} requests (first: request {bad}, "
                 f"{outs[bad][:8]} against {eager_outs[bad][:8]})")
        return {**summary, "eager_serve": eager_rec}

    def step_breakdown(c, eng, spec: dict, prompt: list) -> dict:
        """Where a decode tick (every slot, cache position prompt_len + 8) and
        a prefill spend their time, eagerly and as replays of the compiled
        engine's graphs: device busy time from torch.profiler, wall time
        from a run without the profiler.  The kernel-name checks run on the
        eager steps, and on the replays where the profiler names their
        kernels; a replayed tick may dispatch at most COMPILED_TICK_HOST_OPS
        host ops."""
        B = spec["max_batch"]
        row = torch.tensor([prompt])
        tok, pos = torch.zeros(B, dtype=torch.long), torch.full((B,), spec["prompt_len"] + 8,
                                                                dtype=torch.int32)
        steps = {
            "decode_tick": lambda: lm.decode_step(
                eng.params, c, torch.zeros(B, dtype=torch.long, device=dev),
                torch.full((B,), spec["prompt_len"] + 8, dtype=torch.int32, device=dev),
                eng.caches),
            "prefill": lambda: lm.prefill(eng.params, c, torch.tensor([prompt], device=dev),
                                          max_seq=spec["max_seq"]),
            "decode_tick_compiled": lambda: eng.decode(tok, pos),
            "prefill_compiled": lambda: eng.prefill(row),
        }
        out = {name: profile_step(fn) for name, fn in steps.items()}
        compiled = {"prefill": out["prefill_compiled"], "decode_tick": out["decode_tick_compiled"]}
        named = all(b["kernel_names"] for b in compiled.values())
        print(f"{c.name} kernels named inside graph replays: {named}", flush=True)
        for label, group in (("", {k: out[k] for k in ("prefill", "decode_tick")}),
                             (" (compiled)", compiled if named else None)):
            if group is None:
                continue
            if any(c.layer_spec(i).mixer in ("ga", "swa") for i in range(c.n_layers)):
                check_attention_kernels(c, group, label)
            if any(c.layer_spec(i).ffn == "moe" for i in range(c.n_layers)):
                check_gmm_kernels(c, group, label)
            if any(c.layer_spec(i).mixer == "rwkv" for i in range(c.n_layers)):
                check_scan_kernels(c, group, label)
            if any(c.layer_spec(i).mixer == "mamba" for i in range(c.n_layers)):
                check_mamba_kernels(c, group, label)
            check_norm_kernels(c, group, label)
        if out["decode_tick_compiled"]["host_ops"] > COMPILED_TICK_HOST_OPS:
            fail(f"{c.name}: a compiled decode tick dispatched "
                 f"{out['decode_tick_compiled']['host_ops']} host ops, more than "
                 f"{COMPILED_TICK_HOST_OPS}")
        return out

    def check_norm_kernels(c, steps: dict, label: str = "") -> None:
        """Every profiled step ran K3's CUDA kernel, and no other RMSNorm
        kernel (the Triton kernel it replaced was ``_rmsnorm_kernel``)."""
        seen = {name: [n[:70] for n in b["kernel_names"] if "rmsnorm" in n.lower()]
                for name, b in steps.items()}
        print(f"{c.name}{label} RMSNorm kernels: {json.dumps(seen)}", flush=True)
        for name, found in seen.items():
            if not found or any("rmsnorm_rows<" not in n for n in found):
                fail(f"{c.name}: the {name} ran {found}, expected rmsnorm_rows only")

    def check_mamba_kernels(c, steps: dict, label: str = "") -> None:
        """The served bf16 prefill ran K5's ring kernel with 16-byte cp.async
        copies, and no other K5 kernel."""
        names = [n for n in steps["prefill"]["kernel_names"] if "mamba" in n]
        print(f"{c.name}{label} selective-scan kernels: {json.dumps([n[:90] for n in names])}",
              flush=True)
        want = re.compile(
            r"mamba_scan_ring<__nv_bfloat16,\s*(\(int\))?16,\s*((\(bool\))?1|true)>")
        if not names or any(want.search(n) is None for n in names):
            fail(f"{c.name}: the prefill ran {names}, expected mamba_scan_ring"
                 "<__nv_bfloat16, 16, true> only")

    def check_scan_kernels(c, steps: dict, label: str = "") -> None:
        """The served bf16 prefill ran K6's tiled kernel with its ring filled
        by cp.async, and no other K6 kernel."""
        names = [n for n in steps["prefill"]["kernel_names"] if "rwkv6" in n]
        print(f"{c.name}{label} WKV-scan kernels: {json.dumps([n[:90] for n in names])}", flush=True)
        want = re.compile(r"rwkv6_scan_tiled<__nv_bfloat16,\s*(\(int\))?64,\s*((\(bool\))?1|true)>")
        if not names or any(want.search(n) is None for n in names):
            fail(f"{c.name}: the prefill ran {names}, expected rwkv6_scan_tiled"
                 "<__nv_bfloat16, 64, true> only")

    def check_gmm_kernels(c, steps: dict, label: str = "") -> None:
        """The served bf16 prefill and tick ran K4's gmm_mma instance, and
        neither the WMMA nor the SIMT one."""
        seen = {name: [n[:60] for n in b["kernel_names"] if "gmm_" in n]
                for name, b in steps.items()}
        print(f"{c.name}{label} grouped-matmul kernels: {json.dumps(seen)}", flush=True)
        for name, found in seen.items():
            if not any("gmm_mma" in n for n in found) or any(
                    "gmm_bf16_kernel" in n or "gmm_f32_kernel" in n for n in found):
                fail(f"{c.name}: the {name} ran {found}, expected gmm_mma only")

    def check_attention_kernels(c, steps: dict, label: str = "") -> None:
        """The served bf16 prefill ran K1's tensor-core instance at the
        model's head dim (by name: ``flash_fwd_mma<D>``) and not the SIMT
        one; the decode tick ran both passes of K2's instance
        (``decode_split_mma<D>`` and the combine)."""
        dt, D = getattr(torch, c.activation_dtype), c.head_dim

        def named(kernel: str):  # the kernel, and at head dim D if it is a tensor-core one
            return re.compile(rf"{kernel}<\s*(\(int\))?{D}\s*>" if kernel.endswith("_mma")
                              else kernel)

        names = steps["prefill"]["kernel_names"]
        want, other = k1.instance(dt, D), "flash_fwd_simt"
        seen = {"prefill": [n[:80] for n in names if "flash_fwd" in n],
                "decode_tick": [n[:80] for n in steps["decode_tick"]["kernel_names"]
                                if "decode_" in n]}
        print(f"{c.name}{label} attention kernels: {json.dumps(seen)}", flush=True)
        if not any(named(want).search(n) for n in names) or (
                want != other and any(other in n for n in names)):
            fail(f"{c.name}: the prefill ran {seen['prefill']}, expected {want} at D {D} only")
        for part in k2.instances(dt, D):
            if not any(named(part).search(n) for n in steps["decode_tick"]["kernel_names"]):
                fail(f"{c.name}: the decode tick ran {seen['decode_tick']}, missing {part} "
                     f"at D {D}")

    def fe_parts(fe, n_prompt: int, steps: int = 8) -> tuple:
        """Frontend embeddings (1, n_prompt + steps, d) or None, split into
        the prefill's (1, n_prompt, d) and each decode step's (1, 1, d), as
        extra arguments (none without embeddings)."""
        if fe is None:
            return (), [()] * steps
        return (fe[:, :n_prompt],), [(fe[:, n_prompt + i:n_prompt + i + 1],) for i in range(steps)]

    def teacher_forced(p, c, impl, prompt, outs, max_seq, steps=8, fe=None):
        """Logits (steps + 1, 1, V) of a prefill of ``prompt`` and ``steps``
        decode steps fed the served tokens ``outs`` (and with ``fe``, each
        position's frontend embedding)."""
        fp, fd = fe_parts(fe, len(prompt), steps)
        with ops.impl_scope(impl):
            lg, caches = lm.prefill(p, c, torch.tensor([prompt], device=dev), *fp,
                                    max_seq=max_seq)
            out = [lg]
            for i in range(steps):
                lg, caches = lm.decode_step(
                    p, c, torch.tensor([outs[i]], device=dev),
                    torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev), caches, *fd[i])
                out.append(lg)
        return torch.stack(out)

    def teacher_forced_graphs(p, c, prompt, outs, max_seq, steps=8, fe=None):
        """The same as replays of CUDA graphs (``serving/compiled.py``, the
        engine's steps): the prefill's second call (captured, then replayed)
        and ``steps`` decode steps, each one a replay (the decode step's
        eager first call advances a copy of the caches); frontend
        embeddings, if any, are graph inputs beside the tokens.  Returns the
        logits and the steps' calls, captures and replays."""
        fp, fd = fe_parts(fe, len(prompt), steps)
        graphs = Graphs(dev)
        row = torch.tensor([prompt])
        pre = graphs.step(lambda t, *f: lm.prefill(p, c, t, *f, max_seq=max_seq))
        pre(row, *fp)
        lg, pool_caches = pre(row, *fp)
        caches = _map(torch.clone, pool_caches)  # out of the pool, as the engine's slot copy
        out = [lg.clone()]
        state = {"caches": _map(torch.clone, caches)}
        dec = graphs.step(lambda t, pos, *f: lm.decode_step(p, c, t, pos, state["caches"], *f)[0])
        for i in range(steps):
            tok, at = torch.tensor([outs[i]]), torch.tensor([len(prompt) + i], dtype=torch.int32)
            if i == 0:
                dec(tok, at, *fd[i])  # eager, on the copy
                state["caches"] = caches
            out.append(dec(tok, at, *fd[i]).clone())
        return torch.stack(out), {"prefill": pre.counts(), "decode": dec.counts()}

    def dense_counts(c, spec: dict, n_ticks: int) -> dict:
        """The launches of an attention model's serve set, read from the
        config: K1 a layer and prefill, K2 a layer and tick, K3
        ``norms_per_forward(c)`` a forward (norm1 and norm2, the post-block
        norms, QK-norm's two, the final norm), K4 three a MoE layer and
        forward (w1 with its activation, w3, w2)."""
        forwards = spec["requests"] + n_ticks
        n_moe = sum(c.layer_spec(i).ffn == "moe" for i in range(c.n_layers))
        return {"flash_attention": c.n_layers * spec["requests"],
                "decode_attention": c.n_layers * n_ticks,
                "rmsnorm": norms_per_forward(c) * forwards, "moe_gmm": 3 * n_moe * forwards,
                "rwkv6_scan": 0, "mamba_scan": 0, **NOT_SERVED}

    def serve_set(c, p, spec: dict) -> tuple:
        """An attention model's serve set (the gemmas, the M10 sets), eager
        then compiled, with the exact launch counts (``dense_counts``),
        equal tokens and the replay counts, added to the records, and its
        step breakdown (K1 and K2 at the model's head dim by name, K4's
        instance for an MoE model).
        Returns (engine, prompts, tokens, serve record, compiled vs eager,
        breakdown)."""
        eng, prompts, outs, rec, eager_outs, eager_rec = serve_both(c, p, spec)
        want = dense_counts(c, spec, rec["decode_ticks"])
        if rec["kernels"] != want:
            fail(f"{c.name}: launch counts {rec['kernels']}, expected {want} "
                 f"({spec['requests']} prefills, {rec['decode_ticks']} ticks)")
        vs_eager = check_compiled(c, spec, rec, outs, eager_rec, eager_outs)
        for name in records:
            records[name]["launches"] += rec["kernels"][name]
        add_norm_launches(norm_launches, c, spec, rec["decode_ticks"])
        steps = step_breakdown(c, eng, spec, prompts[0])
        for name, b in steps.items():
            print(f"{c.name} {name}: {json.dumps(b)}", flush=True)
        return eng, prompts, outs, rec, vs_eager, steps

    def logit_gate(c32, p32, prompt: list, outs: list, max_seq: int,
                   bf16: tuple | None = None, fe=None) -> dict:
        """The prefill of ``prompt`` + 8 decode steps teacher-forced with the
        served tokens ``outs``, in f32 through the kernels and through the
        plain versions (within F32_LOGIT_TOL) and through the kernels as
        CUDA graph replays (within GRAPH_F32_TOL of the eager steps); with
        ``bf16`` = (config, params), the same through the kernels and the
        plain versions in bf16: the kernels' path may land no further from
        the f32 path than twice the plain bf16 path does (+0.02), and the
        engine's first token must be the argmax of the bf16 prefill.  With
        frontend embeddings ``fe`` (1, len(prompt) + 8, d), every f32 run
        takes them, and the kernels' run without them must lie further than
        FRONTEND_MIN_DIFF from it at every step."""
        runs = {"kernel_f32": teacher_forced(p32, c32, "kernel", prompt, outs, max_seq, fe=fe),
                "plain_f32": teacher_forced(p32, c32, "plain", prompt, outs, max_seq, fe=fe)}
        if fe is not None:
            runs["kernel_f32_without_frontend"] = teacher_forced(p32, c32, "kernel", prompt, outs,
                                                                 max_seq)
        graph_f32, graph_counts = teacher_forced_graphs(p32, c32, prompt, outs, max_seq, fe=fe)
        if bf16 is not None:
            for label, impl in (("kernel", "kernel"), ("plain", "plain")):
                runs[label] = teacher_forced(bf16[1], bf16[0], impl, prompt, outs, max_seq)
        for name, lg in [*runs.items(), ("graph_f32", graph_f32)]:
            if (lg.shape != (9, 1, c32.vocab_size) or lg.dtype != torch.float32
                    or not bool(torch.isfinite(lg).all())):
                fail(f"{c32.name} {name} logits {tuple(lg.shape)} not finite or misshapen")
        k32, f32 = runs["kernel_f32"], runs["plain_f32"]
        gate = {"kernel_vs_plain_f32": float((k32 - f32).abs().max()),
                "graph_vs_eager_f32": float((graph_f32 - k32).abs().max()),
                "max_abs_logit": float(f32.abs().max()),
                "argmax_kernel_eq_plain_f32": int((k32.argmax(-1) == f32.argmax(-1)).sum()),
                "steps": 9, "layers": c32.n_layers, "graphs": graph_counts,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if fe is not None:
            # the smallest, over the 9 steps, of a step's max |difference|
            gate["frontend_min_step_diff"] = float(
                (k32 - runs["kernel_f32_without_frontend"]).abs().amax(dim=(1, 2)).min())
        if bf16 is not None:
            kl, pl = runs["kernel"], runs["plain"]
            gate.update({"kernel_vs_plain_bf16": float((kl - pl).abs().max()),
                         "kernel_bf16_vs_f32": float((kl - f32).abs().max()),
                         "plain_bf16_vs_f32": float((pl - f32).abs().max()),
                         "argmax_kernel_bf16_eq_f32": int((kl.argmax(-1) == f32.argmax(-1)).sum()),
                         "argmax_plain_bf16_eq_f32": int((pl.argmax(-1) == f32.argmax(-1)).sum()),
                         "first_token_is_prefill_argmax": int(torch.argmax(kl[0, 0])) == outs[0]})
        print(f"{c32.name} logits, full width, {c32.n_layers} layers, prefill + 8 teacher-forced "
              f"decode steps{' with frontend embeddings' if fe is not None else ''}, kernels vs "
              f"plain: {json.dumps(gate)} (tol {F32_LOGIT_TOL} on kernel_vs_plain_f32, "
              f"{GRAPH_F32_TOL} on graph_vs_eager_f32)", flush=True)
        if fe is not None and not gate["frontend_min_step_diff"] > FRONTEND_MIN_DIFF:
            fail(f"{c32.name}: the frontend embeddings moved a step's f32 logits by only "
                 f"{gate['frontend_min_step_diff']:.3e} (<= {FRONTEND_MIN_DIFF}): not used")
        if graph_counts != {"prefill": {"calls": 2, "captures": 1, "replays": 1},
                            "decode": {"calls": 9, "captures": 1, "replays": 8}}:
            fail(f"{c32.name}: the f32 graph comparison ran {graph_counts}, expected every "
                 "step replayed")
        if gate["kernel_vs_plain_f32"] > F32_LOGIT_TOL:
            fail(f"{c32.name}: f32 logits through the kernels disagree with the plain versions")
        if gate["graph_vs_eager_f32"] > GRAPH_F32_TOL:
            fail(f"{c32.name}: f32 logits from CUDA graph replays disagree with the eager steps")
        if bf16 is not None and gate["kernel_bf16_vs_f32"] > 2 * gate["plain_bf16_vs_f32"] + 0.02:
            fail(f"{c32.name}: bf16 logits through the kernels are further from the f32 path "
                 "than the plain bf16 path's rounding explains")
        if bf16 is not None and not gate["first_token_is_prefill_argmax"]:
            fail(f"{c32.name}: the engine's first token is not the argmax of its prefill logits")
        return gate

    phase_s["4"] = time.time() - t_start
    # -- 4. serve full-width qwen2-0.5b through the port's Engine ----------
    params, _ = init_model(cfg)
    eng, prompts, outs, serve, eager_outs, eager_serve = serve_both(cfg, params, SERVE)
    counts, n_ticks = serve["kernels"], serve["decode_ticks"]
    n_layers = cfg.n_layers
    if counts["flash_attention"] != n_layers * SERVE["requests"]:
        fail(f"flash_attention launched {counts['flash_attention']} times, "
             f"expected {n_layers} x {SERVE['requests']}")
    if counts["decode_attention"] != n_layers * n_ticks:
        fail(f"decode_attention launched {counts['decode_attention']} times, "
             f"expected {n_layers} x {n_ticks} ticks")
    forwards = SERVE["requests"] + n_ticks  # 2 norms per layer + the final one
    if counts["rmsnorm"] != norms_per_forward(cfg) * forwards:
        fail(f"rmsnorm launched {counts['rmsnorm']} times, expected "
             f"{norms_per_forward(cfg)} x {forwards} forwards")
    if any(counts[name] for name in NOT_SERVED):
        fail(f"serving launched a backward kernel or K2's stats mode: {counts}")
    compiled_vs_eager = {ARCH: check_compiled(cfg, SERVE, serve, outs, eager_serve, eager_outs)}
    for name in records:
        records[name]["launches"] = counts[name]
    norm_launches = add_norm_launches({}, cfg, SERVE, n_ticks)

    breakdown = step_breakdown(cfg, eng, SERVE, prompts[0])
    for name, b in breakdown.items():
        print(f"{name}: {json.dumps(b)}", flush=True)

    # on the card the f32 logits come from a bf16 x bf16 -> f32 product
    h = randn(SERVE["max_batch"], cfg.d_model, dtype=torch.bfloat16)
    table = eng.params["embed"]["table"]
    hold("unembed (plain op)", "bf16 x bf16 -> f32 logits", nn_core.unembed({"table": table}, h),
         h.float() @ table.float().t(), "float32")

    # the first request through the kernels and through the plain versions,
    # with the served weights in f32 and in bf16
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32")
    agree = logit_gate(cfg32, _map(lambda t: t.float(), eng.params), prompts[0], outs[0],
                       SERVE["max_seq"], bf16=(cfg, eng.params))

    phase_s["4b"] = time.time() - t_start
    # -- 4b. serve full-width, full-depth deepseek-moe-16b --------------------
    del eng, params, table
    gc.collect()
    torch.cuda.empty_cache()
    mparams, moe_init = init_model(mcfg)
    meng, mprompts, mouts, moe_serve, eager_outs, eager_serve = serve_both(mcfg, mparams,
                                                                          MOE_SERVE)
    mcounts, n_ticks = moe_serve["kernels"], moe_serve["decode_ticks"]
    n_layers = mcfg.n_layers
    n_moe = sum(mcfg.layer_spec(i).ffn == "moe" for i in range(n_layers))  # 27
    forwards = MOE_SERVE["requests"] + n_ticks
    want_counts = {"moe_gmm": 3 * n_moe * forwards,  # w1 (+ silu), w3, w2 per MoE layer
                   "flash_attention": n_layers * MOE_SERVE["requests"],
                   "decode_attention": n_layers * n_ticks,
                   "rmsnorm": norms_per_forward(mcfg) * forwards, "rwkv6_scan": 0,
                   "mamba_scan": 0, **NOT_SERVED}
    if mcounts != want_counts:
        fail(f"{MOE_ARCH}: launch counts {mcounts}, expected {want_counts} "
             f"({forwards} forwards, {n_ticks} ticks)")
    compiled_vs_eager[MOE_ARCH] = check_compiled(mcfg, MOE_SERVE, moe_serve, mouts, eager_serve,
                                                 eager_outs)
    for name in records:
        records[name]["launches"] += mcounts[name]
    add_norm_launches(norm_launches, mcfg, MOE_SERVE, n_ticks)

    moe_breakdown = step_breakdown(mcfg, meng, MOE_SERVE, mprompts[0])
    for name, b in moe_breakdown.items():
        print(f"{MOE_ARCH} {name}: {json.dumps(b)}", flush=True)
    meng.caches = None  # the engine's caches are not needed past here

    # gate (a): one served MoE layer (period 0, model layer 1) through the
    # kernels and through the plain versions, at the prefill and decode token
    # counts.  The router is plain PyTorch on both sides, so the routing is
    # the same by construction and the comparison holds K4 in context.
    # Gates (a) and (b) both run before either fails the run, so a fault
    # shows in both.
    def moe_layer_gate(c, layer: dict, token_shapes) -> tuple[dict, list]:
        """One served MoE layer's params ``layer`` through the kernels and
        through the plain versions at each (batch, tokens) of
        ``token_shapes``, in bf16 and in f32 (the same weights cast), each
        output held relative to its max |y|, with 3 K4 launches and equal
        aux losses each.  Returns the errors and the failures, for the
        caller to fail on after its other gates."""
        gate, failures = {}, []
        c32 = dataclasses.replace(c, param_dtype="float32", activation_dtype="float32")
        for dt, c_, p_ in ((torch.bfloat16, c, layer),
                           (torch.float32, c32, _map(lambda t: t.float(), layer))):
            dn = str(dt).removeprefix("torch.")
            for shape in token_shapes:
                x = randn(*shape, c.d_model, dtype=dt)
                before = launch_counts()["moe_gmm"]
                with ops.impl_scope("kernel"):
                    yk, aux_k = ffn_mod.moe_apply(p_, x, c_)
                n_k4 = launch_counts()["moe_gmm"] - before
                with ops.impl_scope("plain"):
                    yp, aux_p = ffn_mod.moe_apply(p_, x, c_)
                # held relative to the layer's output scale (max |y| ~ 0.1
                # here, far under the kernels' unit-scale tolerances)
                scale = yp.float().abs().max().clamp(min=1e-30)
                case = f"{dn} x {tuple(x.shape)}, diff / max|y| (max|y| {float(scale):.3e})"
                gate[case] = hold(f"{c.name} MoE layer (gate a)", case, yk.float() / scale,
                                  yp.float() / scale, dn, fatal=False)
                if not checks[-1]["ok"]:
                    failures.append(f"gate (a) {case}: max_abs_err {gate[case]:.3e}")
                if n_k4 != 3 or launch_counts()["moe_gmm"] != before + 3:
                    fail(f"{c.name} gate (a) {case}: {n_k4} moe_gmm launches through the "
                         "kernels, expected 3")
                if any(float(aux_k[n]) != float(aux_p[n]) for n in aux_k):
                    fail(f"{c.name} gate (a) {case}: the routing's aux losses differ between "
                         "the two runs")
        return gate, failures

    layer = _map(lambda t: t[0], mparams["blocks"]["pos0"]["ffn"])
    mcfg32 = dataclasses.replace(mcfg, param_dtype="float32", activation_dtype="float32")
    gate_a, gate_failures = moe_layer_gate(mcfg, layer, ((1, mS), (mB, 1)))
    del layer

    # gates (b) and (c): the first request's prefill + 8 teacher-forced
    # decode steps through the kernels and through the plain versions, with
    # the top-k picks of every MoE call recorded on both sides
    picks: list = []
    real_moe_apply = ffn_mod.moe_apply

    def recording_moe_apply(p, x, cfg, **kw):
        probs = nn_core.linear(p["router"], x).float().softmax(-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :cfg.moe.top_k]
        picks.append(top.sort(-1)[0].reshape(-1, cfg.moe.top_k))
        return real_moe_apply(p, x, cfg, **kw)

    def moe_run(p, c, impl, prompt, outs, max_seq):
        picks.clear()
        ffn_mod.moe_apply = recording_moe_apply
        try:
            lg = teacher_forced(p, c, impl, prompt, outs, max_seq)
        finally:
            ffn_mod.moe_apply = real_moe_apply
        return lg, torch.cat(picks)

    def compare(kernel_run, plain_run, n_layers_run, c) -> dict:
        (lk, pk), (lp, pp) = kernel_run, plain_run
        for lg in (lk, lp):
            if lg.shape != (9, 1, c.vocab_size) or not bool(torch.isfinite(lg).all()):
                fail(f"{c.name} logits {tuple(lg.shape)} not finite or misshapen")
        same = (pk == pp).all(-1)
        return {"max_abs_diff": float((lk - lp).abs().max()),
                "max_abs_logit": float(lp.abs().max()),
                "argmax_equal_steps": int((lk.argmax(-1) == lp.argmax(-1)).sum()), "steps": 9,
                "topk_agreement": float(same.float().mean()),
                "topk_flipped_tokens": int((~same).sum()), "routed_tokens": int(same.numel()),
                "layers": n_layers_run}

    cfg4 = dataclasses.replace(mcfg32, n_layers=MOE_GATE_LAYERS)
    params4 = {k: v for k, v in mparams.items() if k != "blocks"}
    params4["blocks"] = _map(lambda t: t[:cfg4.n_periods], mparams["blocks"])
    params4 = _map(lambda t: t.float(), params4)
    mreq = (mprompts[0], mouts[0], MOE_SERVE["max_seq"])
    gate_b = compare(moe_run(params4, cfg4, "kernel", *mreq),
                     moe_run(params4, cfg4, "plain", *mreq), MOE_GATE_LAYERS, mcfg)
    del params4
    print(f"{MOE_ARCH} f32 gate (b), full width, {MOE_GATE_LAYERS} layers, prefill + 8 "
          f"teacher-forced decode steps, kernels vs plain: {json.dumps(gate_b)} "
          f"(tol {F32_LOGIT_TOL} on max_abs_diff)", flush=True)
    if gate_b["max_abs_diff"] > F32_LOGIT_TOL:
        gate_failures.append(
            f"gate (b): f32 logits through the kernels disagree with the plain versions "
            f"({gate_b['topk_flipped_tokens']} of {gate_b['routed_tokens']} routed tokens "
            "picked other experts)")
    if gate_failures:
        fail(f"{MOE_ARCH}: " + "; ".join(gate_failures))
    gate_c = compare(moe_run(mparams, mcfg, "kernel", *mreq),
                     moe_run(mparams, mcfg, "plain", *mreq), mcfg.n_layers, mcfg)
    print(f"{MOE_ARCH} bf16 (c), full depth, kernels vs plain (reported, no bound): "
          f"{json.dumps(gate_c)}", flush=True)

    phase_s["4c"] = time.time() - t_start
    # -- 4c. serve full-width, full-depth rwkv6-7b ---------------------------
    del meng, mparams
    picks.clear()
    gc.collect()
    torch.cuda.empty_cache()
    rparams, rwkv_init = init_model(rcfg)
    seed_rwkv_noise(rparams, gen)
    reng, rprompts, routs, rwkv_serve, eager_outs, eager_serve = serve_both(rcfg, rparams,
                                                                           RWKV_SERVE)
    rcounts, n_ticks = rwkv_serve["kernels"], rwkv_serve["decode_ticks"]
    forwards = RWKV_SERVE["requests"] + n_ticks
    want_counts = {"rwkv6_scan": rcfg.n_layers * RWKV_SERVE["requests"],  # one per layer, prefill
                   "rmsnorm": norms_per_forward(rcfg) * forwards,
                   "flash_attention": 0, "decode_attention": 0, "moe_gmm": 0, "mamba_scan": 0,
                   **NOT_SERVED}
    if rcounts != want_counts:
        fail(f"{RWKV_ARCH}: launch counts {rcounts}, expected {want_counts} "
             f"({forwards} forwards, {n_ticks} ticks)")
    compiled_vs_eager[RWKV_ARCH] = check_compiled(rcfg, RWKV_SERVE, rwkv_serve, routs,
                                                  eager_serve, eager_outs)
    for name in records:
        records[name]["launches"] += rcounts[name]
    add_norm_launches(norm_launches, rcfg, RWKV_SERVE, n_ticks)
    rwkv_breakdown = step_breakdown(rcfg, reng, RWKV_SERVE, rprompts[0])
    for name, b in rwkv_breakdown.items():
        print(f"{RWKV_ARCH} {name}: {json.dumps(b)}", flush=True)
    del reng

    # the first request's prefill + 8 teacher-forced decode steps through the
    # kernels and through the plain versions at full depth, in bf16 (reported)
    # and with the served weights in f32 (gated); the f32 copy (30.3 GB) fits
    # beside the bf16 weights once deepseek-moe-16b is gone
    rlog = {label: teacher_forced(rparams, rcfg, impl, rprompts[0], routs[0],
                                  RWKV_SERVE["max_seq"])
            for label, impl in (("kernel", "kernel"), ("plain", "plain"))}
    rcfg32 = dataclasses.replace(rcfg, param_dtype="float32", activation_dtype="float32")
    rparams32 = _map(lambda t: t.float(), rparams)
    del rparams
    for label, impl in (("kernel_f32", "kernel"), ("plain_f32", "plain")):
        rlog[label] = teacher_forced(rparams32, rcfg32, impl, rprompts[0], routs[0],
                                     RWKV_SERVE["max_seq"])
    rwkv_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del rparams32
    for name, lg in rlog.items():
        if lg.shape != (9, 1, rcfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            fail(f"{RWKV_ARCH} {name} logits {tuple(lg.shape)} not finite or misshapen")
    kl, pl, k32, f32 = (rlog[n] for n in ("kernel", "plain", "kernel_f32", "plain_f32"))
    rwkv_gate = {
        "kernel_vs_plain_f32": float((k32 - f32).abs().max()),
        "max_abs_logit": float(f32.abs().max()),
        "argmax_kernel_eq_plain_f32": int((k32.argmax(-1) == f32.argmax(-1)).sum()),
        "kernel_vs_plain_bf16": float((kl - pl).abs().max()),
        "kernel_bf16_vs_f32": float((kl - f32).abs().max()),
        "plain_bf16_vs_f32": float((pl - f32).abs().max()),
        "argmax_kernel_bf16_eq_f32": int((kl.argmax(-1) == f32.argmax(-1)).sum()),
        "steps": 9, "layers": rcfg.n_layers, "peak_mem_gb": rwkv_peak_gb,
    }
    print(f"{RWKV_ARCH} logits, full width and depth, prefill + 8 teacher-forced decode "
          f"steps, kernels vs plain: {json.dumps(rwkv_gate)} (tol {F32_LOGIT_TOL} on "
          f"kernel_vs_plain_f32; bf16 reported)", flush=True)
    if rwkv_gate["kernel_vs_plain_f32"] > F32_LOGIT_TOL:
        fail(f"{RWKV_ARCH}: f32 logits through the kernels disagree with the plain versions")
    if int(torch.argmax(kl[0, 0])) != routs[0][0]:
        fail(f"{RWKV_ARCH}: the engine's first token is not the argmax of its prefill logits")
    del rlog, kl, pl, k32, f32

    phase_s["4d"] = time.time() - t_start
    # -- 4d. serve full-width jamba-1.5-large, cut to its first five layers --
    gc.collect()
    torch.cuda.empty_cache()
    jcfg = dataclasses.replace(jfull, n_layers=JAMBA_LAYERS)
    jparams, jamba_init = init_model(jcfg)
    seed_mamba_noise(jparams, gen)
    jeng, jprompts, jouts, jamba_serve, eager_outs, eager_serve = serve_both(jcfg, jparams,
                                                                            JAMBA_SERVE)
    jcounts, n_ticks = jamba_serve["kernels"], jamba_serve["decode_ticks"]
    specs = [jcfg.layer_spec(i) for i in range(jcfg.n_layers)]
    n_mamba = sum(sp.mixer == "mamba" for sp in specs)  # 4
    n_attn = sum(sp.mixer in ("ga", "swa") for sp in specs)  # 1
    n_moe = sum(sp.ffn == "moe" for sp in specs)  # 2
    forwards = JAMBA_SERVE["requests"] + n_ticks
    want_counts = {"mamba_scan": n_mamba * JAMBA_SERVE["requests"],  # one per Mamba layer, prefill
                   "flash_attention": n_attn * JAMBA_SERVE["requests"],
                   "decode_attention": n_attn * n_ticks,
                   "moe_gmm": 3 * n_moe * forwards,
                   # norm1 and norm2 of every layer, dt / B / C norms of every
                   # Mamba layer, the final norm
                   "rmsnorm": norms_per_forward(jcfg) * forwards,
                   "rwkv6_scan": 0, **NOT_SERVED}
    if jcounts != want_counts:
        fail(f"{JAMBA_ARCH}: launch counts {jcounts}, expected {want_counts} "
             f"({forwards} forwards, {n_ticks} ticks)")
    compiled_vs_eager[JAMBA_ARCH] = check_compiled(jcfg, JAMBA_SERVE, jamba_serve, jouts,
                                                   eager_serve, eager_outs)
    for name in records:
        records[name]["launches"] += jcounts[name]
    add_norm_launches(norm_launches, jcfg, JAMBA_SERVE, n_ticks)
    jamba_breakdown = step_breakdown(jcfg, jeng, JAMBA_SERVE, jprompts[0])
    for name, b in jamba_breakdown.items():
        print(f"{JAMBA_ARCH} {name}: {json.dumps(b)}", flush=True)
    jeng.caches = None

    # gate (a): one served Mamba layer (layer 0) at the prefill shape through
    # the kernels (one K5, three K3 launches) and through the plain versions,
    # y and the final SSM state relative to their max |.|, in bf16 (the
    # served weights) and in f32 (the same weights cast)
    gate_failures = []
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", activation_dtype="float32")
    layer0 = jparams["tail0"]["mixer"]
    gate_a_mamba = {}
    for dt, c, p_ in ((torch.bfloat16, jcfg, layer0),
                      (torch.float32, jcfg32, _map(lambda t: t.float(), layer0))):
        dn = str(dt).removeprefix("torch.")
        x = randn(1, jS, jdm, dtype=dt)
        runs = {}
        for impl in ("kernel", "plain"):
            before = launch_counts()
            cache = mamba_mod.init_cache(c, 1, dt, dev)
            with ops.impl_scope(impl):
                y, cache = mamba_mod.mamba_apply(p_, x, c, cache=cache)
            runs[impl] = (y, cache["ssm"])
            launched = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
            if launched != ({"mamba_scan": 1, "rmsnorm": 3} if impl == "kernel" else {}):
                fail(f"gate (a) {dn}: launches {launched} through the {impl} route")
        case = f"{dn} layer 0, x (1, {jS}, {jdm}), y and final state"
        gate_a_mamba[case] = hold_rel(case, runs["kernel"], runs["plain"], TOL[dn],
                                      f"{JAMBA_ARCH} Mamba layer (gate a)", fatal=False)
        gate_a_mamba[case + " max_rel_err"] = checks[-1]["max_rel_err"]
        if not checks[-1]["ok"]:
            gate_failures.append(f"gate (a) {case}: max_rel_err {checks[-1]['max_rel_err']:.3e}")
    del layer0, p_, x, y, cache, runs

    # (c): the first request's prefill + 8 teacher-forced decode steps at
    # depth 5 in bf16, kernels vs plain, reported only
    jreq = (jprompts[0], jouts[0], JAMBA_SERVE["max_seq"])
    run_k = moe_run(jparams, jcfg, "kernel", *jreq)
    if int(torch.argmax(run_k[0][0, 0])) != jouts[0][0]:
        fail(f"{JAMBA_ARCH}: the engine's first token is not the argmax of its prefill logits")
    gate_c_jamba = compare(run_k, moe_run(jparams, jcfg, "plain", *jreq), jcfg.n_layers, jcfg)
    gate_c_jamba["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{JAMBA_ARCH} bf16 (c), full width, {jcfg.n_layers} layers, kernels vs plain "
          f"(reported, no bound): {json.dumps(gate_c_jamba)}", flush=True)
    del jeng, jparams, run_k

    # gate (b): the same at depth 2 in f32, with the bf16 model freed (an f32
    # copy of five layers, 96 GB, does not fit): weights drawn in f32 from
    # the same seed, noise seeded as above
    picks.clear()
    gc.collect()
    torch.cuda.empty_cache()
    jcfg2 = dataclasses.replace(jcfg32, n_layers=JAMBA_GATE_LAYERS)
    jparams2, jamba_init2 = init_model(jcfg2)
    seed_mamba_noise(jparams2, gen)
    torch.cuda.reset_peak_memory_stats()
    gate_b_jamba = compare(moe_run(jparams2, jcfg2, "kernel", *jreq),
                           moe_run(jparams2, jcfg2, "plain", *jreq), JAMBA_GATE_LAYERS, jcfg2)
    gate_b_jamba["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del jparams2
    picks.clear()
    print(f"{JAMBA_ARCH} f32 gate (b), full width, {JAMBA_GATE_LAYERS} layers, prefill + 8 "
          f"teacher-forced decode steps, kernels vs plain: {json.dumps(gate_b_jamba)} "
          f"(tol {F32_LOGIT_TOL} on max_abs_diff)", flush=True)
    if gate_b_jamba["max_abs_diff"] > F32_LOGIT_TOL:
        gate_failures.append(
            f"gate (b): f32 logits through the kernels disagree with the plain versions "
            f"({gate_b_jamba['topk_flipped_tokens']} of {gate_b_jamba['routed_tokens']} routed "
            "tokens picked other experts)")
    if gate_failures:
        fail(f"{JAMBA_ARCH}: " + "; ".join(gate_failures))

    phase_s["4e"] = time.time() - t_start
    # -- 4e. serve full-width, full-depth gemma3-4b: K1 and K2 at head dim 256 --
    # 34 layers (5 periods of swa x 5 + ga, and 4 swa layers unscanned), bf16
    # 7.8 GB.  Prompts of 1536 tokens against the 1024-token window: K1 masks
    # by window in the 29 local layers' prefill, whose 1024-slot rings then
    # wrap in decode; the 5 global layers' caches hold 2048 slots.  The f32
    # gate runs at full depth (the served weights cast, 15.5 GB beside the
    # bf16 ones).
    gc.collect()
    torch.cuda.empty_cache()
    g3params, g3_init = init_model(g3)
    g3eng, g3prompts, g3outs, g3_serve, g3_vs_eager, g3_breakdown = serve_set(
        g3, g3params, GEMMA3_SERVE)
    compiled_vs_eager[GEMMA3_ARCH] = g3_vs_eager
    g3eng.caches = None
    del g3eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g3cfg32 = dataclasses.replace(g3, param_dtype="float32", activation_dtype="float32")
    g3_gate = logit_gate(g3cfg32, _map(lambda t: t.float(), g3params), g3prompts[0], g3outs[0],
                         GEMMA3_SERVE["max_seq"], bf16=(g3, g3params))
    del g3params

    phase_s["4f"] = time.time() - t_start
    # -- 4f. serve full-width, full-depth gemma2-27b: softcaps at D 128 --------
    # 46 layers, 54.45 GB in bf16, the standard set (1024-slot caches, 16
    # prompts of 512 tokens): the attention softcap of 50 in K1 and K2 in
    # every layer and the final softcap of 30; the window of 4096 never
    # masks at these lengths.  Then, reported only, the first request
    # through the kernels and the plain versions in bf16 at full depth; and,
    # with the bf16 model freed, the f32 gate at full width and 4 layers
    # (weights drawn in f32 from the same seed).
    gc.collect()
    torch.cuda.empty_cache()
    g2params, g2_init = init_model(g2)
    g2eng, g2prompts, g2outs, g2_serve, g2_vs_eager, g2_breakdown = serve_set(
        g2, g2params, GEMMA2_SERVE)
    compiled_vs_eager[GEMMA2_ARCH] = g2_vs_eager
    g2eng.caches = None
    del g2eng
    gc.collect()
    torch.cuda.empty_cache()
    g2req = (g2prompts[0], g2outs[0], GEMMA2_SERVE["max_seq"])
    g2_bf16 = {impl: teacher_forced(g2params, g2, impl, *g2req) for impl in ("kernel", "plain")}
    for name, lg in g2_bf16.items():
        if lg.shape != (9, 1, g2.vocab_size) or not bool(torch.isfinite(lg).all()):
            fail(f"{GEMMA2_ARCH} bf16 {name} logits {tuple(lg.shape)} not finite or misshapen")
    if int(torch.argmax(g2_bf16["kernel"][0, 0])) != g2outs[0][0]:
        fail(f"{GEMMA2_ARCH}: the engine's first token is not the argmax of its prefill logits")
    g2_gate_bf16 = {"kernel_vs_plain_bf16": float((g2_bf16["kernel"] - g2_bf16["plain"]).abs().max()),
                    "max_abs_logit": float(g2_bf16["plain"].abs().max()),
                    "argmax_equal_steps": int((g2_bf16["kernel"].argmax(-1)
                                               == g2_bf16["plain"].argmax(-1)).sum()),
                    "steps": 9, "layers": g2.n_layers,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{GEMMA2_ARCH} bf16, full width and depth, kernels vs plain (reported, no bound): "
          f"{json.dumps(g2_gate_bf16)}", flush=True)
    del g2params, g2_bf16
    gc.collect()
    torch.cuda.empty_cache()
    g2cfg4 = dataclasses.replace(g2, param_dtype="float32", activation_dtype="float32",
                                 n_layers=GEMMA2_GATE_LAYERS)
    g2params4, g2_init4 = init_model(g2cfg4)
    torch.cuda.reset_peak_memory_stats()
    g2_gate = logit_gate(g2cfg4, g2params4, *g2req)
    del g2params4

    phase_s["4g-4i"] = time.time() - t_start
    # -- 4g-4i. ROADMAP M10: musicgen-large, chameleon-34b, dbrx-132b -------
    # Each the standard set (8 slots, 1024-slot caches, 16 prompts of 512
    # tokens, 32 new tokens) through serve_set: eager then compiled, the
    # launches read from the config (chameleon's QK-norm: 4L + 1 K3 a
    # forward), the step breakdown.  dbrx-132b also gets deepseek's gate (a)
    # on its first MoE layer.  Then the first request through the kernels and
    # the plain versions in bf16 at the served depth, reported (with the
    # routing's top-k agreement for dbrx); and, with the bf16 model freed,
    # the f32 gate at full width and M10_GATE_LAYERS layers (weights drawn in
    # f32 from the same seed), for the two frontend archs with seeded
    # frontend embeddings (the only run of the frontend on the card), which
    # must move every step's logits.  The random draws come from a fork of
    # the generator, so later phases draw what they did before.
    gen_state = gen.get_state()
    fe_gen = torch.Generator(device=dev).manual_seed(SEED)
    m10 = {}
    for arch_, c_ in ((MUSICGEN_ARCH, mg), (CHAMELEON_ARCH, ch),
                      (DBRX_ARCH, dataclasses.replace(db, n_layers=DBRX_LAYERS))):
        gc.collect()
        torch.cuda.empty_cache()
        p_, init_ = init_model(c_)
        eng_, prompts_, outs_, serve_, vs_eager_, breakdown_ = serve_set(c_, p_, M10_SERVE)
        compiled_vs_eager[arch_] = vs_eager_
        eng_.caches = None
        del eng_
        gc.collect()
        torch.cuda.empty_cache()
        rec_ = {"layers": c_.n_layers, "init": init_, "serve": serve_, "breakdown": breakdown_}
        gate_failures = []
        if c_.moe is not None:
            layer = _map(lambda t: t[0], p_["blocks"]["pos0"]["ffn"])
            rec_["gate_a"], gate_failures = moe_layer_gate(c_, layer, ((1, mS_), (mB_, 1)))
            del layer
        req = (prompts_[0], outs_[0], M10_SERVE["max_seq"])
        torch.cuda.reset_peak_memory_stats()
        if c_.moe is not None:
            run_k = moe_run(p_, c_, "kernel", *req)
            bf16_ = compare(run_k, moe_run(p_, c_, "plain", *req), c_.n_layers, c_)
            first = run_k[0]
            del run_k
        else:
            first, plain_ = (teacher_forced(p_, c_, impl, *req) for impl in ("kernel", "plain"))
            for name, lg in (("kernel", first), ("plain", plain_)):
                if lg.shape != (9, 1, c_.vocab_size) or not bool(torch.isfinite(lg).all()):
                    fail(f"{arch_} bf16 {name} logits {tuple(lg.shape)} not finite or misshapen")
            bf16_ = {"max_abs_diff": float((first - plain_).abs().max()),
                     "max_abs_logit": float(plain_.abs().max()),
                     "argmax_equal_steps": int((first.argmax(-1) == plain_.argmax(-1)).sum()),
                     "steps": 9, "layers": c_.n_layers}
            del plain_
        bf16_["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"{arch_} bf16, full width, {c_.n_layers} layers, prefill + 8 teacher-forced "
              f"decode steps, kernels vs plain (reported, no bound): {json.dumps(bf16_)}",
              flush=True)
        if int(torch.argmax(first[0, 0])) != outs_[0][0]:
            fail(f"{arch_}: the engine's first token is not the argmax of its prefill logits")
        rec_["bf16"] = bf16_
        del p_, first
        picks.clear()
        gc.collect()
        torch.cuda.empty_cache()
        c32 = dataclasses.replace(c_, param_dtype="float32", activation_dtype="float32",
                                  n_layers=M10_GATE_LAYERS[arch_])
        p32, rec_["gate_f32_init"] = init_model(c32)
        torch.cuda.reset_peak_memory_stats()
        if c_.moe is not None:
            gate_ = compare(moe_run(p32, c32, "kernel", *req), moe_run(p32, c32, "plain", *req),
                            c32.n_layers, c32)
            gate_["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            picks.clear()
            print(f"{arch_} f32 gate (b), full width, {c32.n_layers} layers, prefill + 8 "
                  f"teacher-forced decode steps, kernels vs plain: {json.dumps(gate_)} "
                  f"(tol {F32_LOGIT_TOL} on max_abs_diff)", flush=True)
            if gate_["max_abs_diff"] > F32_LOGIT_TOL:
                gate_failures.append(
                    f"gate (b): f32 logits through the kernels disagree with the plain versions "
                    f"({gate_['topk_flipped_tokens']} of {gate_['routed_tokens']} routed tokens "
                    "picked other experts)")
        else:
            fe = None
            if c_.frontend != "text":
                fe = torch.randn((1, M10_SERVE["prompt_len"] + 8, c_.d_model), generator=fe_gen,
                                 device=dev)
            gate_ = logit_gate(c32, p32, *req, fe=fe)
            del fe
        del p32
        if gate_failures:
            fail(f"{arch_}: " + "; ".join(gate_failures))
        rec_["gate_f32"] = gate_
        m10[arch_] = rec_
    gen.set_state(gen_state)

    records["rmsnorm"]["launches_by_shape"] = {str(k): n for k, n in norm_launches.items()}
    print(f"rmsnorm launches by (rows, D), all nine serving runs: "
          f"{json.dumps(records['rmsnorm']['launches_by_shape'])}", flush=True)
    if sum(norm_launches.values()) != records["rmsnorm"]["launches"]:
        fail("rmsnorm launches by shape do not add up to its launch count")

    phase_s["5"] = time.time() - t_start
    # -- 5. training: smollm-360m through K1 (with its lse), K1b, K3, K3b -----
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.checkpoint import AsyncCheckpointer, restore, restore_into
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.runtime.supervisor import FailureInjector, Supervisor, SupervisorConfig
    from repro_torch.training import optim
    from repro_torch.training import step as step_mod
    from repro_torch.training.compiled import CompiledTrainStep

    tcfg = get_config(TRAIN_ARCH)
    tB, tS, tL = TRAIN_BATCH, TRAIN_SEQ, tcfg.n_layers
    tHq, tHkv, tD, tdm = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim, tcfg.d_model
    print("training kernels vs plain:", flush=True)

    # (a) K1's lse and (b) K1b, at the CPU tests' edge cases (q_offset,
    # window + softcap, ragged Sq / Sk, G = 8, head dims 8 to 128) in f32 and
    # bf16, smollm's heads at S = 256 in both, and its training shape in bf16;
    # K1b also against torch autograd through ref.mha_ref, and run twice with
    # bitwise-equal results (no atomics)
    k1b_cases = [(2, 40, 64, 4, 2, 16, None, None, 24), (2, 64, 64, 4, 2, 16, 16, 50.0, 0),
                 (1, 96, 96, 4, 1, 32, None, 30.0, 0), (1, 200, 200, 8, 1, 64, None, None, 0),
                 (1, 100, 300, 16, 2, 128, 37, 30.0, 200), (1, 40, 40, 2, 2, 8, None, None, 0),
                 (2, 256, 256, tHq, tHkv, tD, None, None, 0),
                 # the wgmma instance's features at D 64: window + softcap +
                 # q_offset with GQA, and Sq, Sk off its 64-row tiles at G = 8
                 (2, 136, 264, 15, 5, 64, 48, 30.0, 128), (1, 200, 330, 8, 1, 64, 100, None, 130)]
    # the wide pair's head dims 128 and 256: the CPU tests' VJP cases there
    # (window 16 with softcap 50, softcap 30, q_offset 24), a window starting
    # inside a tile with a softcap under GQA, Sq, Sk off its 64- and 32-row
    # tiles at G = 8
    k1b_cases += [c for D_ in (128, 256) for c in (
        (2, 40, 40, 4, 2, D_, 16, 50.0, 0), (2, 40, 40, 4, 2, D_, None, 30.0, 0),
        (2, 40, 64, 4, 2, D_, None, None, 24), (2, 136, 264, 8, 4, D_, 48, 30.0, 128),
        (1, 333, 333, 8, 1, D_, None, None, 0))]
    # the training shapes of phase (k): gemma3-4b's global and local (window
    # 1024) layers at D 256, gemma2-27b's at D 128 with softcap 50,
    # chameleon-34b's at D 128 with G 8, and musicgen-large's at D 64 with G 1
    # (the wgmma pair); phase (l)'s deepseek-moe-16b at D 128 with G 1
    g3t, g2t, cht, mgt, dst = (get_config(a) for a in (GEMMA3_ARCH, GEMMA2_ARCH, CHAMELEON_ARCH,
                                                        MUSICGEN_ARCH, MOE_ARCH))
    dB, dS = DENSE_KERNEL_BATCH, DENSE_TRAIN_SEQ
    dense_shapes = {
        f"{GEMMA3_ARCH} global": (dB, dS, dS, g3t.n_heads, g3t.n_kv_heads, g3t.head_dim, None,
                                  None, 0),
        f"{GEMMA3_ARCH} local": (dB, dS, dS, g3t.n_heads, g3t.n_kv_heads, g3t.head_dim,
                                 g3t.sliding_window, None, 0),
        GEMMA2_ARCH: (dB, dS, dS, g2t.n_heads, g2t.n_kv_heads, g2t.head_dim, None,
                      g2t.attn_logit_softcap, 0),
        CHAMELEON_ARCH: (dB, dS, dS, cht.n_heads, cht.n_kv_heads, cht.head_dim, None, None, 0),
        MUSICGEN_ARCH: (dB, dS, dS, mgt.n_heads, mgt.n_kv_heads, mgt.head_dim, None, None, 0),
        MOE_ARCH: (dB, dS, dS, dst.n_heads, dst.n_kv_heads, dst.head_dim, None, None, 0)}
    # dbrx-132b's head layout (G 6 at D 128), checked in bf16 only
    dbt = get_config(DBRX_ARCH)
    dbrx_heads = (1, dS, dS, dbt.n_heads, dbt.n_kv_heads, dbt.head_dim, None, None, 0)
    err_lse = err_b = err_wide = 0.0

    def k1b_twice(q, k, v, out, lse, do, label, **kw):
        """K1b twice on the same inputs, each time into the blocks the caching
        allocator last freed, filled with NaN just before (a gradient element
        the kernels leave unwritten shows; fails if a gradient lands
        elsewhere); the two results must be the same bytes (no atomics, no
        race in the rings)."""
        outs = []
        for _ in range(2):
            nan = [torch.full_like(t, float("nan")) for t in (q, k, v)]
            ptrs = {t.data_ptr() for t in nan}
            del nan
            outs.append(k1.flash_attention_bwd(q, k, v, out, lse, do, **kw))
            if not {g.data_ptr() for g in outs[-1]} <= ptrs:
                fail(f"flash_attention_bwd {label}: a gradient did not land in the NaN-filled "
                     f"blocks")
        if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(*outs)):
            fail(f"flash_attention_bwd {label}: two runs differ")
        return outs[0]

    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        train_shape = ([(tB, tS, tS, tHq, tHkv, tD, None, None, 0), *dense_shapes.values(),
                        dbrx_heads] if dt == torch.bfloat16 else [])
        for B_, Sq_, Sk_, Hq_, Hkv_, D_, w, cap, qo in k1b_cases + train_shape:
            q, k, v, do = (randn(B_, n, h, D_, dtype=dt)
                           for n, h in ((Sq_, Hq_), (Sk_, Hkv_), (Sk_, Hkv_), (Sq_, Hq_)))
            kw = dict(window=w, softcap=cap, q_offset=qo)
            label = f"{dn} {B_}x{Sq_}x{Sk_}x{Hq_}/{Hkv_}x{D_} w={w} cap={cap} q_offset={qo}"
            out, lse = k1.flash_attention(q, k, v, return_lse=True, **kw)
            out_p, lse_p = ref.flash_attention_lse_ref(q, k, v, **kw)
            hold("flash_attention", f"{label} out, lse written", out, out_p, dn)
            err_lse = max(err_lse, hold("flash_attention lse", label, lse, lse_p, dn))
            got = k1b_twice(q, k, v, out, lse, do, label, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
            pair = k1.bwd_instances(dt, D_)[0]
            err = hold_rel(f"{label} dq dk dv vs ref.flash_attention_bwd_ref ({pair})", got,
                           want, BWD_TOL[dn], kernel="flash_attention_bwd")
            if pair == "flash_bwd_dq_sm90":
                err_wide = max(err_wide, err)
            else:
                err_b = max(err_b, err)
            leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(ref.mha_ref(*leaves, **kw), leaves, do.float())
            hold_rel(f"{label} dq dk dv vs autograd through ref.mha_ref", got, auto,
                     BWD_TOL[dn], kernel="flash_attention_bwd")
            del q, k, v, do, out, lse, out_p, lse_p, got, want, leaves, auto

    # (c) K3b at smollm's training rows, at every served (rows, D) and at
    # phase (k)'s training rows (gemma3-4b's d 2560, gemma2-27b's 4608,
    # chameleon-34b's 8192 and its QK-norm's rows of 128, G 8 query rows and
    # one key row a token), f32 and bf16, twice with bitwise-equal results
    err3b = 0.0
    dT = DENSE_KERNEL_BATCH * DENSE_TRAIN_SEQ
    dense_norms = [(dT, g3t.d_model), (dT, g2t.d_model), (dT, cht.d_model),
                   (dT * cht.n_heads, cht.head_dim), (dT * cht.n_kv_heads, cht.head_dim)]
    for shape in [(tB * tS, tdm), *served_norms, *dense_norms]:
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).removeprefix("torch.")
            x, s_, dy = randn(*shape, dtype=dt), randn(shape[-1]) * 0.1, randn(*shape, dtype=dt)
            got = k3.rmsnorm_bwd(x, s_, dy)
            if not all(torch.equal(a, b) for a, b in zip(got, k3.rmsnorm_bwd(x, s_, dy))):
                fail(f"rmsnorm_bwd {shape} {dn}: two runs differ")
            err3b = max(err3b, hold_rel(f"{dn} {shape} dx, dscale", got,
                                        ref.rmsnorm_bwd_ref(x, s_, dy), TOL[dn],
                                        kernel="rmsnorm_bwd"))
    # K3b on two streams at once, each held back by a spin until the host
    # has queued all its launches: each stream's launches take tickets from
    # counters of their own, so they give the bits of one launch at a time
    args3b = [(randn(tB * tS, tdm, dtype=torch.bfloat16), randn(tdm) * 0.1,
               randn(tB * tS, tdm, dtype=torch.bfloat16)) for _ in range(2)]
    alone = [k3.rmsnorm_bwd(*a) for a in args3b]
    streams = [torch.cuda.Stream() for _ in args3b]
    torch.cuda.synchronize()
    together: list[list] = [[] for _ in args3b]
    for st in streams:
        with torch.cuda.stream(st):
            torch.cuda._sleep(50_000_000)
    for _ in range(K3B_OVERLAP_ROUNDS):
        for st, a, outs in zip(streams, args3b, together):
            with torch.cuda.stream(st):
                outs.append(k3.rmsnorm_bwd(*a))
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for outs, want in zip(together, alone) for got in outs
               for u, v in zip(got, want))
    print(f"  rmsnorm_bwd on two streams at once, {K3B_OVERLAP_ROUNDS} calls each: "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} one call at a time", flush=True)
    if not same:
        fail("rmsnorm_bwd on two streams at once differs from one call at a time")
    del x, s_, dy, got, args3b, alone, together

    # (d)-(f') smollm-360m at full width and depth through train_checks: the
    # f32 step at 2 x 1024 kernels vs plain and as a replay vs eager, then
    # TRAIN_STEPS bf16 steps on SyntheticLM eagerly and compiled (the
    # schedule launch.train gives 20 steps), an eager step and a replay
    # under torch.profiler
    cfg32 = dataclasses.replace(tcfg, param_dtype="float32", activation_dtype="float32")
    tcfg_train = step_mod.TrainConfig(opt=optim.AdamWConfig(
        peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
    data = SyntheticLM(DataConfig(tcfg.vocab_size, tS, tB, seed=SEED))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
               for i in range(TRAIN_STEPS)]
    b32 = [{k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(DataConfig(
        tcfg.vocab_size, F32_GATE_SEQ, F32_GATE_BATCH, seed=SEED)).batch(i).items()}
        for i in range(2)]
    smollm = train_checks(dev, smi, TRAIN_ARCH, tcfg, cfg32, tcfg_train, b32, lambda: batches,
                          fall_by=0.1, profiled=("eager", "compiled"), reps=3)
    del b32
    want_step = smollm["launches_per_step"]
    train_launches = smollm["eager"]["launches"]
    f32_gate, graph_train_f32 = smollm["f32_gate"], smollm["graph_f32"]
    train_rec, compiled_rec = smollm["eager"], smollm["compiled"]
    train_profile, compiled_profile = smollm["profile"]["eager"], smollm["profile"]["compiled"]
    train_vs = {
        mode: {"wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
               "device_idle_share": prof["device_idle_share"], "host_ops": prof["host_ops"],
               "device_kernels": prof["device_kernels"], "median_step_ms": rec["median_step_ms"],
               "tokens_per_s": rec["tokens_per_s"], "peak_mem_gb": rec["peak_mem_gb"]}
        for mode, prof, rec in (("eager", train_profile, train_rec),
                                ("compiled", compiled_profile, compiled_rec))}
    print(f"{TRAIN_ARCH} train step eager vs compiled, {smi}: {json.dumps(train_vs)}", flush=True)

    # (j) the supervised run: the compiled bf16 step under Supervisor for
    # the first SUP_STEPS of (e')'s steps, a checkpoint every SUP_CKPT_EVERY, a node failure
    # injected before step SUP_FAIL_AT; the restart copies the newest
    # checkpoint into the live tensors and the graph replays on
    sup_dir = Path(tempfile.mkdtemp(prefix="repro_torch_ckpt_"))
    try:
        jstate = step_mod.init_train_state(tcfg, tcfg_train, SEED, dev)
        jstep = CompiledTrainStep(tcfg, tcfg_train, jstate)
        ptrs = [t.data_ptr() for t in _leaves(jstate)]
        order, at_ckpt = [], []

        def batch_fn(i: int) -> dict:
            order.append(i)
            if i == SUP_CKPT_EVERY and not at_ckpt:  # the live state at the checkpoint
                at_ckpt.extend(t.detach().clone() for t in _leaves(jstate))
            return batches[i]

        sup_log = EventLog()
        reset_launches()
        t0 = time.perf_counter()
        out = Supervisor(SupervisorConfig(ckpt_dir=str(sup_dir), ckpt_every=SUP_CKPT_EVERY,
                                          max_steps=SUP_STEPS), jstep, batch_fn, jstate,
                         log=sup_log, failures=FailureInjector((SUP_FAIL_AT,))).run()
        sup_wall = time.perf_counter() - t0
        last_loss = dict(zip(order, (mm["loss"] for mm in out["metrics"])))
        sup_losses = [last_loss[i] for i in range(SUP_STEPS)]
        calls = SUP_STEPS + SUP_FAIL_AT - SUP_CKPT_EVERY
        sup_launches = launch_counts()
        t0 = time.perf_counter()
        restored = restore(str(sup_dir), SUP_CKPT_EVERY, jstate)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        manifest = json.loads((sup_dir / f"step_{SUP_CKPT_EVERY:08d}" / "manifest.json")
                              .read_text())
        # every leaf under its live dtype: the bf16 params as "bfloat16" (the
        # norm scales are f32), the moments f32, the step counter int32
        listed = {leaf["key"]: leaf["dtype"] for leaf in manifest["leaves"]}
        live = {n[1:]: str(t.dtype).removeprefix("torch.") for n, t in _named_leaves(jstate)}
        bf16_params = sum(k.startswith("params/") and d == "bfloat16" for k, d in listed.items())
        restored_equal = all(same_bits(a, b_) for a, b_ in zip(_leaves(restored), at_ckpt))
        del restored
        ptrs_unchanged = ptrs == [t.data_ptr() for t in _leaves(jstate)]
        step_counter = int(jstate["opt"]["step"])
        # the restart's own path: the checkpoint copied from the host into the
        # live tensors, with no second copy of the state on the card
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        restore_into(str(sup_dir), SUP_CKPT_EVERY, jstate)
        torch.cuda.synchronize()
        restore_into_s = time.perf_counter() - t0
        restore_into_extra_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        restored_into_equal = all(same_bits(a, b_) for a, b_ in zip(_leaves(jstate), at_ckpt))
        ptrs_unchanged = ptrs_unchanged and ptrs == [t.data_ptr() for t in _leaves(jstate)]
        del at_ckpt
        for d in sup_dir.iterdir():
            shutil.rmtree(d)
        # the checkpointer alone: the blocking snapshot, then the write
        ck = AsyncCheckpointer(str(sup_dir), keep=1)
        t0 = time.perf_counter()
        ck.save(SUP_STEPS, jstate)
        snapshot_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ck.wait()
        write_s = time.perf_counter() - t0
        ckpt_gb = sum(f.stat().st_size for f in sup_dir.rglob("*") if f.is_file()) / 1e9
        supervised = {
            "steps": out["steps"], "restarts": out["restarts"], "stragglers": out["stragglers"],
            "metrics": len(out["metrics"]), "step_order": order, "losses": sup_losses,
            "losses_equal_compiled_run": sup_losses == compiled_rec["losses"][:SUP_STEPS],
            "counts": jstep.counts(),
            "launches": sup_launches, "data_ptrs_unchanged": ptrs_unchanged,
            "step_counter": step_counter, "restored_step_equal": restored_equal,
            "restored_into_equal": restored_into_equal,
            "manifest_dtypes_live": listed == live, "manifest_bf16_params": bf16_params,
            "manifest_leaves": len(listed), "wall_s": sup_wall,
            "checkpoint_spans_s": sup_log.durations("checkpoint"),
            "median_step_span_ms": 1e3 * statistics.median(sup_log.durations("step")),
            "restart_span_s": sup_log.durations("restart"),
            "snapshot_ms": snapshot_ms, "write_s": write_s, "restore_s": restore_s,
            "restore_into_s": restore_into_s, "restore_into_extra_gb": restore_into_extra_gb,
            "checkpoint_gb": ckpt_gb, "trace": out["trace"]}
    finally:
        shutil.rmtree(sup_dir, ignore_errors=True)
    print(f"{TRAIN_ARCH} supervised compiled run, {smi}: {json.dumps(supervised)}", flush=True)
    want_calls = {"calls": calls, "captures": 1, "replays": calls - 1}
    sup_failures = [what for what, ok in (
        ("restarts != 1", supervised["restarts"] == 1),
        (f"steps != {SUP_STEPS}", supervised["steps"] == SUP_STEPS),
        ("a step's last loss differs from the uninterrupted compiled run's",
         supervised["losses_equal_compiled_run"]),
        (f"counts {supervised['counts']} != {want_calls}", supervised["counts"] == want_calls),
        ("launches are not the calls' exact launches",
         sup_launches == {k: v * calls for k, v in want_step.items()}),
        ("a leaf's data_ptr moved", supervised["data_ptrs_unchanged"]),
        (f"step counter {supervised['step_counter']} != {SUP_STEPS}",
         supervised["step_counter"] == SUP_STEPS),
        (f"the step-{SUP_CKPT_EVERY} checkpoint differs from the live state there",
         restored_equal),
        (f"the step-{SUP_CKPT_EVERY} checkpoint copied into the live tensors differs from "
         "the live state there", restored_into_equal),
        ("the manifest's dtypes are not the live leaves'", listed == live and bf16_params > 0))
        if not ok]
    if sup_failures:
        fail(f"{TRAIN_ARCH} supervised run: " + "; ".join(sup_failures))
    del jstate, jstep, batches
    gc.collect()
    torch.cuda.empty_cache()

    # (g) K1 with its lse, K1b and K3b at the training shape, L2 flushed,
    # beside their bounds, plain versions and one PyTorch call each
    q, k, v, do = (randn(tB, tS, h, tD, dtype=torch.bfloat16) for h in (tHq, tHkv, tHkv, tHq))
    out, lse = k1.flash_attention(q, k, v, return_lse=True)
    pairs = tB * tHq * (tS * (tS + 1) // 2)  # causal (query, key) pairs
    qs, ks_, vs_, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.clone().requires_grad_() for t in (qs, ks_, vs_))

    def sdpa(grad: bool):
        if not grad:
            with torch.no_grad():
                return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, (qg, kg, vg), dos)

    shape1 = f"B={tB} S={tS} Hq={tHq} Hkv={tHkv} D={tD} bf16 causal"
    k1_lse = timed(lambda: k1.flash_attention(q, k, v, return_lse=True),
                   lambda: ref.flash_attention_lse_ref(q, k, v), lambda: sdpa(False),
                   nbytes(q, k, v, out, lse), 4 * tD * pairs, peaks["bfloat16"],
                   f"{shape1} ({k1.instance(torch.bfloat16, tD)}, lse written)")
    k1_lse["without_lse_ms"] = time_ms(lambda: k1.flash_attention(q, k, v))
    k1b = timed(lambda: k1.flash_attention_bwd(q, k, v, out, lse, do),
                lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do), None,
                nbytes(q, k, v, out, lse, do, q, k, v), 10 * tD * pairs, peaks["bfloat16"],
                f"{shape1} ({' + '.join(k1.bwd_instances(torch.bfloat16, tD))})")
    k1b["library_ms"] = time_ms(lambda: sdpa(True)) - k1_lse["library_ms"]
    k1b["library"] = "scaled_dot_product_attention forward + backward, less its forward"
    # the f32 instance (the CUDA cores), which the f32 gate (d) runs
    q, k, v, do, out, lse = (t.float() for t in (q, k, v, do, out, lse))
    qg, kg, vg, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.requires_grad_() for t in (qg, kg, vg))
    k1b["float32"] = timed(lambda: k1.flash_attention_bwd(q, k, v, out, lse, do),
                           lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do), None,
                           nbytes(q, k, v, out, lse, do, q, k, v), 10 * tD * pairs,
                           peaks["float32"], f"B={tB} S={tS} Hq={tHq} Hkv={tHkv} D={tD} f32 "
                           f"causal ({' + '.join(k1.bwd_instances(torch.float32, tD))})")
    k1b["float32"]["library_ms"] = time_ms(lambda: sdpa(True)) - time_ms(lambda: sdpa(False))
    x, s_, dy = (randn(tB * tS, tdm, dtype=torch.bfloat16), randn(tdm) * 0.1,
                 randn(tB * tS, tdm, dtype=torch.bfloat16))
    xg, wg = x.clone().requires_grad_(), (1.0 + s_).to(torch.bfloat16).requires_grad_()

    def rms_norm_lib(grad: bool):
        if not grad:
            with torch.no_grad():
                return F.rms_norm(xg, (tdm,), wg, 1e-6)
        return torch.autograd.grad(F.rms_norm(xg, (tdm,), wg, 1e-6), (xg, wg), dy)

    k3b_plan = k3.bwd_plan(tB * tS, tdm, 2, _build.sm_count(0))
    k3b = timed(lambda: k3.rmsnorm_bwd(x, s_, dy), lambda: ref.rmsnorm_bwd_ref(x, s_, dy),
                None, nbytes(x, s_, dy, x, s_), 0.0, peaks["bfloat16"],
                f"({tB * tS}, {tdm}) bf16 (rmsnorm_bwd_fused<__nv_bfloat16, {k3b_plan.chunks}>, "
                f"{k3b_plan.grid} blocks, {k3b_plan.lanes} lanes a row)")
    k3b["library_ms"] = time_ms(lambda: rms_norm_lib(True)) - time_ms(lambda: rms_norm_lib(False))
    k3b["library"] = "F.rms_norm forward + backward, less its forward"
    # the previous design in the same call: a memset, rmsnorm_bwd_rows, rmsnorm_bwd_dscale
    k3b["previous_ms"] = time_ms(lambda: k3.previous_bwd(x, s_, dy))
    # each K3b call launches its one kernel and nothing else (no memset)
    k3b_prof = profile_step(lambda: [k3.rmsnorm_bwd(x, s_, dy) for _ in range(K3B_CALLS)])
    names = k3b["kernels_a_call"] = k3b_prof["kernel_names"]
    print(f"  rmsnorm_bwd, {K3B_CALLS} calls' kernels: {json.dumps(names)} "
          f"({k3b_prof['device_kernels']} launches)", flush=True)
    # The profiler may drop events, never add them, so this holds no more
    # than one kernel a call: a memset or any second kernel would show here
    # by name.  A session that named no kernel passes it; then the count of
    # launches rests on kernels.LAUNCHES, which (e) holds to exactly 65 a
    # step, and on (c), which holds every call's outputs.
    if not names:
        print("  rmsnorm_bwd: the profiler named no kernel; LAUNCHES and (c) hold the count",
              flush=True)
    elif (len(names) != 1 or "::rmsnorm_bwd_fused<" not in names[0]
          or k3b_prof["device_kernels"] > K3B_CALLS):
        fail(f"rmsnorm_bwd: {K3B_CALLS} calls ran {names} ({k3b_prof['device_kernels']} "
             "launches), expected rmsnorm_bwd_fused alone, at most once a call")
    # K3 itself at the training rows: x read and out written once
    k3_train = timed(lambda: k3.rmsnorm(x, s_), lambda: ref.rmsnorm_ref(x, s_),
                     lambda: rms_norm_lib(False), nbytes(x, s_, x), 0.0, peaks["bfloat16"],
                     f"({tB * tS}, {tdm}) bf16")
    k3_train["library"] = "F.rms_norm forward"
    # K1b's rate: on the bound's count (5 products, 10 D flops a causal
    # pair) and on the 7 products the two passes do
    k1b["tflops"] = 10 * tD * pairs / (k1b["ms"] * 1e-3) / 1e12
    k1b["tflops_7_products"] = 14 * tD * pairs / (k1b["ms"] * 1e-3) / 1e12
    k1b["library_tflops"] = 10 * tD * pairs / (k1b["library_ms"] * 1e-3) / 1e12
    print(f"  flash_attention without lse: kernel {k1_lse['without_lse_ms']:.4f} ms at {shape1}",
          flush=True)
    for name, t in (("flash_attention with lse", k1_lse), ("flash_attention_bwd", k1b),
                    ("flash_attention_bwd f32", k1b["float32"]), ("rmsnorm_bwd", k3b),
                    ("rmsnorm", k3_train)):
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"{fmt_ms(t['library_ms'])}, bound {t['bound_ms']:.5f} ms ({t['bound_by']}) at "
              f"{t['shape']}", flush=True)
    print(f"  rmsnorm_bwd previous design (memset + rmsnorm_bwd_rows + rmsnorm_bwd_dscale): "
          f"{k3b['previous_ms']:.4f} ms at {k3b['shape']}", flush=True)
    print(f"  flash_attention_bwd: {k1b['tflops']:.1f} TFLOP/s on the bound's count (10 D "
          f"flops a causal pair), {k1b['tflops_7_products']:.1f} on the 7 products done; "
          f"SDPA's backward {k1b['library_tflops']:.1f}", flush=True)
    del q, k, v, do, out, lse, qs, ks_, vs_, dos, qg, kg, vg, x, s_, dy, xg, wg

    # (g) K1b at phase (k)'s training shapes, L2 flushed, beside its bound,
    # its plain version, SDPA's forward + backward less its forward (at
    # gemma3-4b's local layers with a boolean mask; SDPA has no softcap, so
    # at gemma2-27b's shape it is timed without one, sdpa_without_softcap_ms);
    # gemma3-4b's global shape also in f32 (the CUDA-core pair the f32 gates
    # run)
    def live_pairs(Sq_, Sk_, w, qo) -> int:
        pos = qo + np.arange(Sq_)
        lo = np.maximum(0, pos - w + 1) if w is not None else 0
        return int(np.maximum(0, np.minimum(pos, Sk_ - 1) - lo + 1).sum())

    def sdpa_ms(qs_, ks_, vs_, dos_, mask) -> tuple[float, float]:
        """SDPA's forward, and its backward (forward + backward less the
        forward), at one shape."""
        qg_, kg_, vg_ = (t.clone().requires_grad_() for t in (qs_, ks_, vs_))
        kw_ = dict(attn_mask=mask, is_causal=mask is None, enable_gqa=True)

        def fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qg_, kg_, vg_, **kw_)

        def both():
            o = F.scaled_dot_product_attention(qg_, kg_, vg_, **kw_)
            return torch.autograd.grad(o, (qg_, kg_, vg_), dos_)

        fwd_ms = time_ms(fwd)
        return fwd_ms, time_ms(both) - fwd_ms

    # K1's forward (flash_fwd_mma with its lse, as the train step launches
    # it) at the same shapes, beside its bound, plain version and SDPA's
    # forward
    dense_k1b: dict[str, dict] = {}
    dense_k1f: dict[str, dict] = {}
    for label, (B_, Sq_, Sk_, Hq_, Hkv_, D_, w, cap, qo) in dense_shapes.items():
        q, k, v, do = (randn(B_, n, h, D_, dtype=torch.bfloat16)
                       for n, h in ((Sq_, Hq_), (Sk_, Hkv_), (Sk_, Hkv_), (Sq_, Hq_)))
        kw = dict(window=w, softcap=cap, q_offset=qo)
        out, lse = k1.flash_attention(q, k, v, return_lse=True, **kw)
        n_flops = 10 * D_ * B_ * Hq_ * live_pairs(Sq_, Sk_, w, qo)
        b_ms, b_by = bound_ms(nbytes(q, k, v, out, lse, do, q, k, v), n_flops, peaks["bfloat16"])
        row = {"ms": time_ms(lambda: k1.flash_attention_bwd(q, k, v, out, lse, do, **kw)),
               "plain_ms": time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                                       **kw), iters=3),
               "bound_ms": b_ms, "bound_by": b_by,
               "shape": f"{B_}x{Sq_}x{Hq_}/{Hkv_}x{D_} bf16 causal window={w} softcap={cap} "
                        f"({' + '.join(k1.bwd_instances(torch.bfloat16, D_))})"}
        if D_ in k1.BWD_WIDE_HEAD_DIMS:  # the previous design at D 128 / 256, then again
            row["previous_ms"] = time_ms(lambda: k1.previous_wide_bwd(q, k, v, out, lse, do,
                                                                      **kw), iters=10)
            row["ms_after_previous"] = time_ms(
                lambda: k1.flash_attention_bwd(q, k, v, out, lse, do, **kw), iters=10)
            row["previous"] = " + ".join(k1.PREVIOUS_WIDE_INSTANCES) + " (mma.sync)"
            row["x_previous"] = row["previous_ms"] / row["ms"]
        qs, ks_, vs_, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
        mask = None
        if w is not None:
            pos = torch.arange(Sq_, device=dev)[:, None] + qo
            key = torch.arange(Sk_, device=dev)[None, :]
            mask = (key <= pos) & (key > pos - w)
        lib_f, lib = sdpa_ms(qs, ks_, vs_, dos, mask)
        row["library_ms"] = None if cap else lib
        if cap:
            row["sdpa_without_softcap_ms"] = lib
        f_ms, f_by = bound_ms(nbytes(q, k, v, out, lse),
                              4 * D_ * B_ * Hq_ * live_pairs(Sq_, Sk_, w, qo), peaks["bfloat16"])
        fwd = {"ms": time_ms(lambda: k1.flash_attention(q, k, v, return_lse=True, **kw)),
               "plain_ms": time_ms(lambda: ref.flash_attention_lse_ref(q, k, v, **kw), iters=3),
               "bound_ms": f_ms, "bound_by": f_by, "library_ms": None if cap else lib_f,
               "shape": f"{B_}x{Sq_}x{Hq_}/{Hkv_}x{D_} bf16 causal window={w} softcap={cap} "
                        f"({k1.instance(torch.bfloat16, D_)}, lse written)"}
        if cap:
            fwd["sdpa_without_softcap_ms"] = lib_f
        fwd["x_bound"] = fwd["ms"] / f_ms
        fwd["x_sdpa"] = fwd["ms"] / lib_f
        dense_k1f[label] = fwd
        print(f"  flash_attention forward at {label}, {smi}: {json.dumps(fwd)}", flush=True)
        row["tflops"] = n_flops / (row["ms"] * 1e-3) / 1e12
        row["x_bound"] = row["ms"] / b_ms
        row["x_sdpa"] = row["ms"] / lib
        if label == f"{GEMMA3_ARCH} global":
            q, k, v, do, out, lse = (t.float() for t in (q, k, v, do, out, lse))
            qs, ks_, vs_, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
            b32_ms, b32_by = bound_ms(nbytes(q, k, v, out, lse, do, q, k, v), n_flops,
                                      peaks["float32"])
            row["float32"] = {
                "ms": time_ms(lambda: k1.flash_attention_bwd(q, k, v, out, lse, do, **kw), iters=3),
                "plain_ms": time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                                        **kw), iters=3),
                "bound_ms": b32_ms, "bound_by": b32_by,
                "library_ms": sdpa_ms(qs, ks_, vs_, dos, None)[1],
                "shape": f"{B_}x{Sq_}x{Hq_}/{Hkv_}x{D_} f32 causal "
                         f"({' + '.join(k1.bwd_instances(torch.float32, D_))})"}
        dense_k1b[label] = row
        print(f"  flash_attention_bwd at {label}: {json.dumps(row)}", flush=True)
        del q, k, v, do, out, lse, qs, ks_, vs_, dos, mask
    gc.collect()
    torch.cuda.empty_cache()

    # (h) R11: the forward-only kernels refuse an input that requires grad
    def refuses(name, fn) -> None:
        try:
            fn()
        except RuntimeError as e:
            if "ROADMAP R11" not in str(e):
                fail(f"{name}: raised {e!r}, not the R11 guard")
            return
        fail(f"{name} accepted an input that requires grad")

    rg = lambda *shape: randn(*shape).requires_grad_()  # noqa: E731
    pos8 = torch.arange(8, dtype=torch.int32, device=dev)[None]
    cur8 = torch.full((1,), 7, dtype=torch.int32, device=dev)
    refuses("decode_attention", lambda: k2.decode_attention(rg(1, 4, 16), randn(1, 8, 2, 16),
                                                            randn(1, 8, 2, 16), pos8, cur8))
    refuses("moe_gmm", lambda: k4.gmm(rg(2, 8, 16), randn(2, 16, 8)))
    refuses("mamba_scan", lambda: k5.mamba_scan(rg(1, 8, 16), randn(1, 8, 16), randn(16, 8),
                                                randn(1, 8, 8), randn(1, 8, 8), randn(16),
                                                randn(1, 16, 8)))
    refuses("rwkv6_scan", lambda: k6.rwkv6_scan(rg(1, 8, 2, 16), randn(1, 8, 2, 16),
                                                randn(1, 8, 2, 16), randn(1, 8, 2, 16),
                                                randn(2, 16), randn(1, 2, 16, 16)))
    print("  R11 guard: decode_attention, moe_gmm, mamba_scan and rwkv6_scan refuse an input "
          "that requires grad: ok", flush=True)
    # K1b at a head dim without an instance (96) refuses before any launch
    q = randn(1, 64, 8, 96, dtype=torch.bfloat16)
    kv = randn(1, 64, 4, 96, dtype=torch.bfloat16)
    lse = torch.zeros((1, 8, 64), dtype=torch.float32, device=dev)
    before = launch_counts()["flash_attention_bwd"]
    try:
        k1.flash_attention_bwd(q, kv, kv, q, lse, q)
    except NotImplementedError as e:
        if ("no backward kernel at head dim 96" not in str(e)
                or launch_counts()["flash_attention_bwd"] != before):
            fail(f"flash_attention_bwd at D 96: raised {e!r} after "
                 f"{launch_counts()['flash_attention_bwd'] - before} launches")
    else:
        fail("flash_attention_bwd at D 96 ran, with no backward instance there")
    print("  flash_attention_bwd at D 96 (no instance) refuses before any launch: ok",
          flush=True)
    del q, kv, lse

    # (i) the training driver, as a user runs it, on the card, with a node
    # failure injected before step CLI_FAIL_AT (it restarts from step 0)
    cli_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    cli_args = ["--arch", TRAIN_ARCH, "--steps", "20", "--ckpt-dir", cli_dir, "--fail-at",
                str(CLI_FAIL_AT)]
    try:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *cli_args],
                              cwd=ROOT, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                              timeout=CLI_TIMEOUT_S)
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    if proc.returncode != 0:
        fail(f"repro_torch.launch.train exited {proc.returncode}: {proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"repro_torch.launch.train {' '.join(cli_args)}: {json.dumps(cli)}", flush=True)
    if not cli["last_loss"] < cli["first_loss"]:
        fail("repro_torch.launch.train: the loss did not fall")
    if cli["restarts"] != 1 or cli["compiled"]["captures"] != 1:
        fail(f"repro_torch.launch.train: restarts {cli['restarts']}, compiled "
             f"{cli['compiled']}, expected 1 restart and 1 capture")

    # (k) the dense archs through the training path
    phase_s["5 (k)"] = time.time() - t_start
    gc.collect()
    torch.cuda.empty_cache()
    dense = dense_train_phase(dev, smi)

    records["flash_attention"]["with_lse"] = k1_lse
    records["flash_attention"]["dense_train_forward"] = dense_k1f
    records["flash_attention"]["train_launches"] = train_launches["flash_attention"]
    records["flash_attention"]["lse_max_abs_err"] = err_lse
    records["rmsnorm"]["train_launches"] = train_launches["rmsnorm"]
    records["rmsnorm"]["train"] = k3_train
    records["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_vjp.py:108", "max_abs_err": err_b,
        "launches": (train_launches["flash_attention_bwd"]
                     + dense["launches"]["flash_attention_bwd"]),
        **k1b, MUSICGEN_ARCH: dense_k1b[MUSICGEN_ARCH],
    }
    # K1b at bf16 D 128 / 256 (flash_bwd_dq_sm90 + flash_bwd_dkdv_sm90): its
    # launches from phase (k) here, phase (l)'s deepseek-moe-16b added below
    records["flash_attention_bwd_wide"] = {
        "name": "flash_attention_bwd_wide", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_vjp.py:108", "max_abs_err": err_wide,
        "launches": dense["launches"]["flash_attention_bwd_wide"],
        **dense_k1b[f"{GEMMA3_ARCH} global"],
        "shapes": {k_: v_ for k_, v_ in dense_k1b.items() if k_ != MUSICGEN_ARCH},
    }
    records["rmsnorm_bwd"] = {
        "name": "rmsnorm_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/nn/core.py:178", "max_abs_err": err3b,
        "launches": train_launches["rmsnorm_bwd"], **k3b,
    }
    # (l) the MoE arch through the training path: K4b
    phase_s["5 (l)"] = time.time() - t_start
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = moe_train_phase(dev, smi, records, {"time_ms": time_ms, "bound_ms": bound_ms,
                                                    "peaks": peaks})
    records["flash_attention_bwd_wide"]["launches"] += moe_train["k1b_launches"]
    training = {"f32_gate": f32_gate, "train": train_rec, "profile": train_profile,
                "compiled": compiled_rec, "compiled_profile": compiled_profile,
                "eager_vs_compiled": train_vs, "graph_f32": graph_train_f32,
                "supervised": supervised, "cli": cli, "dense": dense, "moe": moe_train}

    phase_s["6"] = time.time() - t_start
    # -- 6. the paper's measurement layer ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    measurement = measurement_phase(dev, smi)

    phase_s["7"] = time.time() - t_start
    # -- 7. profile-guided dispatch ------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    dispatch = dispatch_phase(dev, smi, records, compiled_rec["losses"])

    phase_s["8"] = time.time() - t_start
    # -- 8. the trace and metrics plane ---------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    tracing = trace_phase(dev, smi, records, breakdown["decode_tick_compiled"], training)

    phase_s["9"] = time.time() - t_start
    # -- 9. the serving tier: fleet, router, replicas, stitch ----------------
    gc.collect()
    torch.cuda.empty_cache()
    tier = serving_tier_phase(dev, smi, records)

    phase_s["10"] = time.time() - t_start
    # phase 11 (e)'s dry-run cells run on the host from now on (device-free;
    # phase 10 times its kernels with CUDA events, and holds its serve runs by
    # their tokens)
    dryrun_cells = start_dryrun_cells()
    # -- 10. tune/: the Hopper design space, swept on the card ----------------
    gc.collect()
    torch.cuda.empty_cache()
    tuning = tune_phase(dev, smi, records, {
        "time_ms": time_ms, "hold": hold, "bound_ms": bound_ms, "peaks": peaks,
        "logit_gate": logit_gate, "mcfg": mcfg, "mprompts": mprompts, "mouts": mouts})

    phase_s["11"] = time.time() - t_start
    # -- 11. the mesh and the dry-run ------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    meshing = mesh_phase(dev, smi, records, {
        "time_ms": time_ms, "hold": hold, "bound_ms": bound_ms, "peaks": peaks,
        "dryrun_cells": dryrun_cells})

    phase_s["12"] = time.time() - t_start
    # -- 12. report ---------------------------------------------------------
    full = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "kernels": list(records.values()), "checks": checks, "serve": serve,
            "serving_logits": agree, "breakdown": breakdown,
            "compiled_vs_eager": compiled_vs_eager, TRAIN_ARCH: training,
            MOE_ARCH: {"init": moe_init, "serve": moe_serve, "breakdown": moe_breakdown,
                       "gate_a_max_abs_err": gate_a, "gate_b_f32": gate_b,
                       "gate_c_bf16": gate_c},
            RWKV_ARCH: {"init": rwkv_init, "serve": rwkv_serve, "breakdown": rwkv_breakdown,
                        "logits": rwkv_gate},
            JAMBA_ARCH: {"layers": JAMBA_LAYERS, "init": jamba_init, "serve": jamba_serve,
                         "breakdown": jamba_breakdown, "gate_a": gate_a_mamba,
                         "gate_b_f32": gate_b_jamba, "gate_b_init": jamba_init2,
                         "gate_c_bf16": gate_c_jamba},
            GEMMA3_ARCH: {"init": g3_init, "serve": g3_serve, "breakdown": g3_breakdown,
                          "logits": g3_gate},
            GEMMA2_ARCH: {"init": g2_init, "serve": g2_serve, "breakdown": g2_breakdown,
                          "bf16_full_depth": g2_gate_bf16, "gate_f32": g2_gate,
                          "gate_f32_init": g2_init4},
            **m10,
            "measurement": measurement, "dispatch": dispatch, "tracing": tracing,
            "serving_tier": tier, "tune": tuning, "mesh": meshing,
            "seconds": time.time() - t_start, "phase_s": phase_s}
    print(f"chip_smoke: {full['seconds']:.1f} s; phases began at (s): {json.dumps(phase_s)}",
          flush=True)
    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(full, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "floor_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in records.values()]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def train_launches_per_step(c) -> dict[str, int]:
    """The kernel launches of one train step of the dense config ``c`` (one
    microbatch): the layers inside the stacked periods run their forward
    twice under per-period remat (again in the backward; once with remat
    "everything"), the unscanned head / tail layers and the final norm
    once; one K1b for each attention layer and one K3b for each K3 launch
    of a forward (norm_launches_per_forward); three K4 for each MoE layer's
    forward run, and for each MoE layer's backward one K4 (the recomputed
    pre-activation) and K4B_LAUNCHES_PER_LAYER K4b."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm

    again = 1 if c.remat_policy == "everything" else 2
    unscanned = {int(re.sub(r"\D", "", name)) for name, _ in lm._unscanned_layers(c)}
    fwd_attn = fwd_norm = n_attn = fwd_moe = n_moe = 0
    for i in range(c.n_layers):
        sp = c.layer_spec(i)
        attn = sp.mixer in ("ga", "swa")
        moe = sp.ffn == "moe"
        norms = (1 + (sp.ffn != "none")) * (2 if c.post_block_norms else 1)
        norms += 2 * (attn and c.qk_norm)
        runs = 1 if i in unscanned else again
        n_attn += attn
        fwd_attn += runs * attn
        fwd_norm += runs * norms
        n_moe += moe
        fwd_moe += runs * moe
    out = dict.fromkeys(LAUNCHES, 0)
    out.update({"flash_attention": fwd_attn, "flash_attention_bwd": n_attn,
                "rmsnorm": fwd_norm + 1, "rmsnorm_bwd": norms_per_forward(c),
                "moe_gmm": 3 * fwd_moe + n_moe, "moe_gmm_bwd": K4B_LAUNCHES_PER_LAYER * n_moe})
    return out


# a MoE layer's backward: K4b's gated dgrad, one dgrad for dx and a wgrad
# for each of w1, w3, w2
K4B_LAUNCHES_PER_LAYER = 5


def train_checks(dev, smi: str, arch: str, cfg, cfg32, tcfg, b32: list[dict], bf16_batches,
                 *, fall_by: float, profiled: tuple[str, ...] = ("compiled",),
                 reps: int = 1) -> dict:
    """One config through the training path on the card, at full width:
    (1) the f32 step at ``cfg32`` on ``b32[0]`` through the kernels and
    through the plain versions, its launches exact, the loss within
    F32_LOSS_RTOL and every gradient leaf within F32_GRAD_TOL of its max
    |.|; (2) f32 at ``cfg32``: a CUDA graph replay on ``b32[1]`` against an
    eager step from the seed's state, the loss and every param and moment
    leaf within GRAPH_TRAIN_F32_TOL; (3) the bf16 steps at ``cfg`` over
    ``bf16_batches()``, eagerly and then through ``CompiledTrainStep`` from
    a fresh state of the same seed (an eager call, one capture, replays):
    each step's launches exact (``train_launches_per_step``), the replays'
    losses the eager run's, the loss falling by more than ``fall_by``; (4)
    a step of each mode in ``profiled`` under torch.profiler (its wall time
    the median of ``reps``): K1's, K1b's, K3's and K3b's instances of bf16
    at this head dim and no other K1b instance, no CUDA-core K1 and not the
    previous K3b (a session that names no kernel fails), and for a MoE
    config K4's ``gmm_mma`` and K4b's three kernels and no other K4
    instance, a replay at most
    COMPILED_TICK_HOST_OPS host ops.  A frontend arch's batches carry
    ``frontend_embed``.  Returns the record, with each mode's launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as k1
    from repro_torch.kernels import launch_counts, ops, reset_launches
    from repro_torch.models import lm
    from repro_torch.training import step as step_mod
    from repro_torch.training.compiled import CompiledTrainStep

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    def rel_diff(pairs) -> tuple[float, str]:
        return max((float((a.float() - b.float()).abs().max())
                    / max(float(b.float().abs().max()), 1e-30), n) for n, a, b in pairs)

    def ran(w: str, name: str) -> bool:
        return f"::{w}<" in name or f"::{w}(" in name

    D = cfg.head_dim
    rec: dict = {"layers": cfg.n_layers, "head_dim": D, "gate_layers": cfg32.n_layers,
                 "peak_lr": tcfg.opt.peak_lr, "remat_policy": cfg.remat_policy}
    # (1) the f32 step, kernels vs plain
    want32 = train_launches_per_step(cfg32)
    p32 = lm.init_params(cfg32, SEED, device=dev)
    for t in _leaves(p32):
        t.requires_grad_()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for impl in ("auto", "plain"):
        reset_launches()
        with ops.impl_scope(impl):
            loss, _ = lm.loss_fn(p32, cfg32, b32[0]["tokens"], b32[0]["labels"],
                                 b32[0].get("frontend_embed"))
            grads = torch.autograd.grad(loss, list(_leaves(p32)))
        torch.cuda.synchronize()
        runs[impl] = (float(loss.detach()), grads, launch_counts())
    del loss, grads
    names = [n for n, _ in _named_leaves(p32)]
    worst = rel_diff(zip(names, runs["auto"][1], runs["plain"][1]))
    finite = all(bool(torch.isfinite(g).all()) for g in runs["auto"][1])
    gate = {"loss_kernel": runs["auto"][0], "loss_plain": runs["plain"][0],
            "loss_rel_diff": abs(runs["auto"][0] - runs["plain"][0]) / abs(runs["plain"][0]),
            "worst_leaf_rel_diff": worst[0], "worst_leaf": worst[1], "leaves": len(names),
            "grads_finite": finite, "launches": runs["auto"][2],
            "batch": b32[0]["tokens"].shape[0], "seq": b32[0]["tokens"].shape[1],
            "layers": cfg32.n_layers, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{arch} f32 train step, full width, {cfg32.n_layers} layers, kernels vs plain: "
          f"{json.dumps(gate)} (tol {F32_LOSS_RTOL} on loss_rel_diff, {F32_GRAD_TOL} on "
          "worst_leaf_rel_diff)", flush=True)
    if runs["auto"][2] != want32 or any(runs["plain"][2].values()):
        fail(f"{arch} f32 train step launches: kernels {runs['auto'][2]}, plain "
             f"{runs['plain'][2]}, expected {want32} and none")
    if not finite or gate["loss_rel_diff"] > F32_LOSS_RTOL or worst[0] > F32_GRAD_TOL:
        fail(f"{arch}: the f32 train step through the kernels disagrees with the plain versions")
    rec["f32_gate"] = gate
    del p32, runs
    free()

    # (2) one eager step from the seed's state, its result kept on the host;
    # then the seed's state restored in place from a host copy of its params
    # (zero moments and step), the step compiled (its eager call and its
    # capture on another batch), the state restored again and the same step
    # replayed.  The eager step runs first: beside the captured step's memory
    # pool, an eager step's or a second state's memory does not fit the card
    # at the larger archs
    s32 = step_mod.init_train_state(cfg32, tcfg, SEED, dev)
    seed_params = [t.detach().cpu() for t in _leaves(s32["params"])]

    def reseed() -> None:
        with torch.no_grad():
            for a, h in zip(_leaves(s32["params"]), seed_params):
                a.copy_(h)
            for t in _leaves(s32["opt"]):
                t.zero_()

    loss_eager = float(step_mod.make_train_step(cfg32, tcfg)(s32, b32[1])[1]["loss"])
    on_host = [t.detach().cpu() for t in _leaves(s32)]
    reseed()
    free()
    g32 = CompiledTrainStep(cfg32, tcfg, s32)
    for _ in range(2):
        g32(s32, b32[0])
    reseed()
    loss_graph = float(g32(s32, b32[1])[1]["loss"])
    counts32 = g32.counts()
    del g32  # its memory pool: the comparison needs the room
    free()
    leaves32 = [(n, t.detach()) for n, t in _named_leaves(s32)]
    worst32 = rel_diff((n, h.to(dev), t) for (n, t), h in zip(leaves32, on_host)
                       if t.is_floating_point())
    steps_equal = all(torch.equal(h.to(dev), t) for (_, t), h in zip(leaves32, on_host)
                      if not t.is_floating_point())
    rec["graph_f32"] = {"loss_graph": loss_graph, "loss_eager": loss_eager,
                        "loss_rel_diff": abs(loss_graph - loss_eager) / abs(loss_eager),
                        "worst_leaf_rel_diff": worst32[0], "worst_leaf": worst32[1],
                        "steps_equal": steps_equal, "counts": counts32}
    print(f"{arch} f32 train step, a CUDA graph replay vs eager: "
          f"{json.dumps(rec['graph_f32'])} (tol {GRAPH_TRAIN_F32_TOL} on loss_rel_diff and "
          "worst_leaf_rel_diff)", flush=True)
    if (rec["graph_f32"]["loss_rel_diff"] > GRAPH_TRAIN_F32_TOL
            or worst32[0] > GRAPH_TRAIN_F32_TOL or not steps_equal
            or counts32 != {"calls": 3, "captures": 1, "replays": 2}):
        fail(f"{arch}: the replayed f32 train step disagrees with the eager step")
    del s32, on_host, leaves32, seed_params
    free()

    # (3) the bf16 steps, eager then compiled, and (4) their profiles
    want = train_launches_per_step(cfg)
    bwd = k1.bwd_instances(torch.bfloat16, D)
    want_names = [k1.instance(torch.bfloat16, D), *bwd, "rmsnorm_rows", "rmsnorm_bwd_fused"]
    other_bwd = {n for d in k1.BWD_HEAD_DIMS for dt in (torch.bfloat16, torch.float32)
                 for n in k1.bwd_instances(dt, d)} - set(bwd)
    other_names = ["flash_fwd_simt", *sorted(other_bwd), *k1.PREVIOUS_WIDE_INSTANCES,
                   "rmsnorm_bwd_rows", "rmsnorm_bwd_dscale"]
    k4b_names = list(K4B_KERNELS) if cfg.moe is not None else []
    if cfg.moe is not None:  # K4's and K4b's tensor-core instances, not K4's others
        want_names += ["gmm_mma", *k4b_names]  # nor K4b's first design, any instance
        other_names += ["gmm_bf16_kernel", "gmm_f32_kernel", *K4B_PREVIOUS]
    bts = bf16_batches()
    B, S = bts[0]["tokens"].shape
    rec.update(batch=B, seq=S, steps=len(bts), launches_per_step=want, profile={})
    failures = []
    for mode in ("eager", "compiled"):
        free()
        torch.cuda.reset_peak_memory_stats()
        state = step_mod.init_train_state(cfg, tcfg, SEED, dev)
        step = (step_mod.make_train_step(cfg, tcfg) if mode == "eager"
                else CompiledTrainStep(cfg, tcfg, state))
        losses, step_ms = [], []
        total = dict.fromkeys(want, 0)
        for bt in bts:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, bt)[1]  # (the new state is state, updated in place)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            got = launch_counts()
            if got != want:
                fail(f"{arch} {mode} train step {len(losses)}: launches {got}, expected {want}")
            for name, n in got.items():
                total[name] += n
        med = float(np.median(step_ms))
        rec[mode] = {"losses": losses, "first_loss": losses[0], "last_loss": losses[-1],
                     "step_ms": step_ms, "median_step_ms": med,
                     "tokens_per_s": B * S / (med / 1e3),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches_per_step": want, "launches": total}
        if mode == "compiled":
            rec[mode]["counts"] = step.counts()
            if rec[mode]["counts"] != {"calls": len(bts), "captures": 1,
                                       "replays": len(bts) - 1}:
                failures.append(f"compiled counts {rec[mode]['counts']}")
        print(f"{arch} bf16 {mode}, {cfg.n_layers} layers, {B} x {S}, {smi}: "
              f"{json.dumps(rec[mode])}", flush=True)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0] - fall_by:
            failures.append(f"the {mode} loss did not fall by more than {fall_by}: {losses}")
        if mode in profiled:
            prof = profile_step(lambda: step(state, bts[0]), reps=reps, top=12)
            names = prof["kernel_names"]
            prof["kernels_ran"] = {w: any(ran(w, n) for n in names)
                                   for w in want_names + other_names}
            prof["port_kernels"] = {w: [sum(ms for n, ms, _ in prof["all_kernels"] if ran(w, n)),
                                        sum(c for n, _, c in prof["all_kernels"] if ran(w, n))]
                                    for w in want_names}
            prof["k1b_ms"] = sum(prof["port_kernels"][w][0] for w in bwd)
            if k4b_names:
                prof["k4b_ms"] = sum(prof["port_kernels"][w][0] for w in k4b_names)
            rec["profile"][mode] = prof
            print(f"{arch} bf16 {mode} step under torch.profiler, {smi}: "
                  f"{json.dumps({k: v for k, v in prof.items() if k != 'all_kernels'})}",
                  flush=True)
            if not names:
                failures.append(f"the profiled {mode} step named no kernel")
            elif (not all(prof["kernels_ran"][w] for w in want_names)
                    or any(prof["kernels_ran"][w] for w in other_names)):
                failures.append(f"the profiled {mode} step ran {prof['kernels_ran']}, expected "
                                f"{want_names} and none of {other_names}")
            if mode == "compiled" and prof["host_ops"] > COMPILED_TICK_HOST_OPS:
                failures.append(f"a replayed step dispatched {prof['host_ops']} host ops (at "
                                f"most {COMPILED_TICK_HOST_OPS})")
        del state, step, m
    free()
    rec["losses_equal_eager"] = rec["compiled"]["losses"] == rec["eager"]["losses"]
    if not rec["losses_equal_eager"]:
        failures.append("the replays' losses are not the eager run's")
    if failures:
        fail(f"{arch} bf16 train: " + "; ".join(failures))
    return rec


def dense_train_phase(dev, smi: str) -> dict:
    """Phase 5 (k): DENSE_TRAIN's archs through ``train_checks`` and the
    training driver (see the module docstring); returns its record, with
    ``launches``, the K1b launches of the bf16 runs and the driver's child
    run by record of the kernel line (``flash_attention_bwd_wide``: bf16 D
    128 / 256; ``flash_attention_bwd``: musicgen-large's wgmma pair)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as k1
    from repro_torch.training import optim
    from repro_torch.training import step as step_mod

    S, N = DENSE_TRAIN_SEQ, DENSE_TRAIN_STEPS
    tcfg = step_mod.TrainConfig(opt=optim.AdamWConfig(peak_lr=DENSE_TRAIN_LR, warmup_steps=1,
                                                      total_steps=N))
    out: dict = {"archs": {}}
    launches = {"flash_attention_bwd_wide": 0, "flash_attention_bwd": 0}

    for arch, (layers, B) in DENSE_TRAIN.items():
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        cut = dict(n_layers=DENSE_GATE_LAYERS, param_dtype="float32", activation_dtype="float32")
        if arch == GEMMA3_ARCH:
            cut["layer_pattern"] = (LayerSpec("swa"), LayerSpec("ga"))
        cfg32 = dataclasses.replace(full, **cut)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def batches(batch: int, seq: int, n: int, dtype, full=full, gen=gen) -> list[dict]:
            """SyntheticLM batches 0 .. n - 1, with seeded frontend
            embeddings for a frontend arch."""
            data = SyntheticLM(DataConfig(full.vocab_size, seq, batch, seed=SEED))
            got = []
            for i in range(n):
                bt = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
                if full.frontend != "text":
                    bt["frontend_embed"] = torch.randn((batch, seq, full.d_model), generator=gen,
                                                       device=dev).to(dtype)
                got.append(bt)
            return got

        b32 = batches(F32_GATE_BATCH, F32_GATE_SEQ, 2, torch.float32)
        rec = train_checks(dev, smi, arch, cfg, cfg32, tcfg, b32,
                           lambda B=B, batches=batches: batches(B, S, 1, torch.bfloat16) * N,
                           fall_by=0.0)
        wide = cfg.head_dim in k1.BWD_WIDE_HEAD_DIMS
        launches["flash_attention_bwd_wide" if wide else "flash_attention_bwd"] += sum(
            rec[mode]["launches"]["flash_attention_bwd"] for mode in ("eager", "compiled"))
        out["archs"][arch] = rec
        del b32
        gc.collect()
        torch.cuda.empty_cache()

    # (k4) the training driver, as a user runs it, on gemma3-4b
    cli_args = ["--arch", DENSE_CLI_ARCH, *DENSE_CLI_ARGS]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *cli_args],
                          cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=CLI_TIMEOUT_S)
    if proc.returncode != 0:
        fail(f"repro_torch.launch.train {' '.join(cli_args)} exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"5 (k) repro_torch.launch.train {' '.join(cli_args)}: {json.dumps(cli)}", flush=True)
    n_steps = int(DENSE_CLI_ARGS[DENSE_CLI_ARGS.index("--steps") + 1])
    n_attn = sum(get_config(DENSE_CLI_ARCH).layer_spec(i).mixer in ("ga", "swa")
                 for i in range(get_config(DENSE_CLI_ARCH).n_layers))
    if (cli["compiled"] != {"calls": n_steps, "captures": 1, "replays": n_steps - 1}
            or cli["kernels"]["flash_attention_bwd"] != n_steps * n_attn
            or not cli["last_loss"] < cli["first_loss"]):
        fail(f"repro_torch.launch.train --arch {DENSE_CLI_ARCH}: compiled {cli['compiled']}, "
             f"K1b launches {cli['kernels']['flash_attention_bwd']} (expected "
             f"{n_steps * n_attn}), losses {cli['first_loss']} -> {cli['last_loss']}")
    out["cli"] = cli
    launches["flash_attention_bwd_wide"] += cli["kernels"]["flash_attention_bwd"]
    out["launches"] = launches
    return out


def moe_train_phase(dev, smi: str, records: dict, kit: dict) -> dict:
    """Phase 5 (l): K4b, the grouped matmul's backward, and the MoE arch it
    brings to training on the card (see the module docstring).  ``kit``
    holds main()'s ``time_ms``, ``bound_ms`` and ``peaks`` (and
    ``kernels_only``: stop after K4b's checks and timing).  Adds the
    ``moe_gmm_bwd`` kernel record to ``records`` (not with ``kernels_only``)
    and returns the phase's record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import launch_counts, ref, reset_launches
    from repro_torch.kernels import moe_gmm as k4
    from repro_torch.training import optim
    from repro_torch.training import step as step_mod

    time_ms, bound_ms, peaks = kit["time_ms"], kit["bound_ms"], kit["peaks"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    out: dict = {"checks": [], "timing": {}}

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def inputs(E, C, D, F, dtype, act):
        """The experts' input, weights and output grad, the forward's saved
        a3, h and the recomputed pre-activation a1, all from K4."""
        x = randn(E, C, D, dtype=dtype)
        w1, w3 = (randn(E, D, F, dtype=dtype, scale=D ** -0.5) for _ in range(2))
        w2 = randn(E, F, D, dtype=dtype, scale=F ** -0.5)
        _, a3, h = ref.moe_ffn_fwd(x, w1, w3, w2, act, gmm=k4.gmm)
        return {"x": x, "w1": w1, "w3": w3, "w2": w2, "a1": k4.gmm(x, w1), "a3": a3, "h": h,
                "dy": randn(E, C, D, dtype=dtype)}

    def kernels(t, act):
        """K4b's five launches of one MoE layer, then ops.gmm's one-pair dgrad."""
        da1, da3 = k4.gated_dgrad(t["dy"], t["w2"], t["a1"], t["a3"], act)
        return {"da1": da1, "da3": da3, "dx": k4.dgrad(da1, t["w1"], da3, t["w3"]),
                "dw1": k4.wgrad(t["x"], da1), "dw3": k4.wgrad(t["x"], da3),
                "dw2": k4.wgrad(t["h"], t["dy"]), "dx1": k4.dgrad(da1, t["w1"])}

    def plains(t, act):
        da1, da3 = ref.gmm_gated_dgrad_ref(t["dy"], t["w2"], t["a1"], t["a3"], act)
        return {"da1": da1, "da3": da3, "dx": ref.gmm_dgrad_ref(da1, t["w1"], da3, t["w3"]),
                "dw1": ref.gmm_wgrad_ref(t["x"], da1), "dw3": ref.gmm_wgrad_ref(t["x"], da3),
                "dw2": ref.gmm_wgrad_ref(t["h"], t["dy"]), "dx1": ref.gmm_dgrad_ref(da1, t["w1"])}

    # (1) K4b against its plain version, each result relative to its max
    # |.|, at the slice's shape in both dtypes and at the two ragged shapes
    # (each epilogue); each launch twice, bitwise equal
    worst = 0.0
    cases = [(K4B_SHAPE, torch.bfloat16, "silu"), (K4B_SHAPE, torch.float32, "silu")]
    cases += [(shape, dt, act) for shape in (K4B_RAGGED_VEC, K4B_RAGGED)
              for dt in (torch.bfloat16, torch.float32) for act in ("silu", "gelu")]
    for shape, dt, act in cases:
        t = inputs(*shape, dt, act)
        got, again = kernels(t, act), kernels(t, act)
        want = plains(t, act)
        E, C, D, F = shape
        aligned = all(v.data_ptr() % 16 == 0 for v in t.values())
        row = {"shape": list(shape), "dtype": str(dt).split(".")[1], "act": act,
               "instance": k4.bwd_instance(dt, D, F, aligned), "rel_err": {}}
        for name, g in got.items():
            scale = max(float(want[name].float().abs().max()), 1e-30)
            row["rel_err"][name] = float((g.float() - want[name].float()).abs().max()) / scale
        row["bitwise_rerun"] = all(same_bits(got[n], again[n]) for n in got)
        row["finite"] = all(bool(torch.isfinite(g).all()) for g in got.values())
        tol = K4B_TOL[row["dtype"]]
        row["ok"] = (row["bitwise_rerun"] and row["finite"]
                     and max(row["rel_err"].values()) <= tol)
        out["checks"].append(row)
        print(f"  moe_gmm_bwd {shape} {row['dtype']} {act} ({row['instance']}): "
              f"{json.dumps(row['rel_err'])} (tol {tol} of max |.|), bitwise rerun "
              f"{row['bitwise_rerun']} {'ok' if row['ok'] else 'FAIL'}", flush=True)
        if not row["ok"]:
            fail(f"moe_gmm_bwd at {shape} {row['dtype']} {act} disagrees with its plain version")
        worst = max(worst, max(row["rel_err"].values()))
        del t, got, again, want
    out["max_rel_err"] = worst

    # (2) each kernel at the slice's shape in bf16, L2 flushed, beside its
    # plain version, torch.bmm on the same (transposed) views, its bound,
    # and the previous design (moe_gmm.previous_bwd), timed before and after it
    E, C, D, F = K4B_SHAPE
    t = inputs(E, C, D, F, torch.bfloat16, "silu")
    da1, da3 = k4.gated_dgrad(t["dy"], t["w2"], t["a1"], t["a3"], "silu")
    g13, w13 = torch.cat([da1, da3], -1), torch.cat([t["w1"], t["w3"]], -1)
    es = 2  # bytes a bf16 element
    prod = 2.0 * E * C * D * F
    gated_args = (t["dy"], t["w2"], t["a1"], t["a3"])
    timing = {
        "gated_dgrad (a)": (
            lambda: k4.gated_dgrad(*gated_args, "silu"),
            lambda: ref.gmm_gated_dgrad_ref(*gated_args, "silu"),
            lambda: torch.bmm(t["dy"], t["w2"].mT), es * (E * C * D + E * F * D + 4 * E * C * F),
            prod, lambda: k4.previous_bwd("gated_dgrad", *gated_args, act="silu")),
        "dgrad (b)": (
            lambda: k4.dgrad(da1, t["w1"], da3, t["w3"]),
            lambda: ref.gmm_dgrad_ref(da1, t["w1"], da3, t["w3"]),
            lambda: torch.bmm(g13, w13.mT), es * (2 * E * C * F + 2 * E * D * F + E * C * D),
            2 * prod, lambda: k4.previous_bwd("dgrad", da1, t["w1"], da3, t["w3"])),
        "wgrad (c)": (
            lambda: k4.wgrad(t["x"], da1), lambda: ref.gmm_wgrad_ref(t["x"], da1),
            lambda: torch.bmm(t["x"].mT, da1), es * (E * C * D + E * C * F + E * D * F), prod,
            lambda: k4.previous_bwd("wgrad", t["x"], da1)),
        # the backward's one K4 launch: the pre-activation a1 = x w1, recomputed
        "recompute a1 (K4)": (
            lambda: k4.gmm(t["x"], t["w1"]), lambda: ref.gmm_ref(t["x"], t["w1"]),
            lambda: torch.bmm(t["x"], t["w1"]), es * (E * C * D + E * D * F + E * C * F), prod,
            None),
    }
    for name, (kern, plain, lib, n_bytes, n_flops, previous) in timing.items():
        b, by = bound_ms(n_bytes, n_flops, peaks["bfloat16"])
        before = time_ms(previous) if previous else None
        row = {"ms": time_ms(kern), "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
               "bound_ms": b, "bound_by": by, "gb": n_bytes / 1e9, "gflop": n_flops / 1e9}
        row["tflops"] = n_flops / row["ms"] / 1e9
        row["x_bound"] = row["ms"] / b
        row["x_library"] = row["ms"] / row["library_ms"]
        if previous:  # the previous design, timed before and after the kernel
            row["previous_ms"] = [before, time_ms(previous)]
            row["previous_tflops"] = n_flops / min(row["previous_ms"]) / 1e9
            row["speedup_vs_previous"] = min(row["previous_ms"]) / row["ms"]
        out["timing"][name] = row
        print(f"  moe_gmm_bwd {name} at {K4B_SHAPE}, bf16, L2 flushed, {smi}: "
              f"{json.dumps(row)}", flush=True)
    # the whole backward of one MoE layer: its five launches against the
    # plain version and the library's five products (dh, dx over the
    # concatenated pairs, dw1, dw3, dw2; no epilogue)
    def kernels_whole():
        a, b = k4.gated_dgrad(t["dy"], t["w2"], t["a1"], t["a3"], "silu")
        return (k4.dgrad(a, t["w1"], b, t["w3"]), k4.wgrad(t["x"], a), k4.wgrad(t["x"], b),
                k4.wgrad(t["h"], t["dy"]))

    def library_whole():
        torch.bmm(t["dy"], t["w2"].mT)
        return (torch.bmm(g13, w13.mT), torch.bmm(t["x"].mT, da1), torch.bmm(t["x"].mT, da3),
                torch.bmm(t["h"].mT, t["dy"]))

    def previous_whole():
        a, b = k4.previous_bwd("gated_dgrad", *gated_args, act="silu")
        return (k4.previous_bwd("dgrad", a, t["w1"], b, t["w3"]),
                k4.previous_bwd("wgrad", t["x"], a), k4.previous_bwd("wgrad", t["x"], b),
                k4.previous_bwd("wgrad", t["h"], t["dy"]))

    n_bytes = es * (2 * E * C * D + 3 * E * D * F + 3 * E * C * F + 3 * E * D * F + E * C * D)
    b, by = bound_ms(n_bytes, 6 * prod, peaks["bfloat16"])
    before = time_ms(previous_whole)
    whole = {"ms": time_ms(kernels_whole),
             "plain_ms": time_ms(lambda: ref.moe_ffn_bwd_ref(t["x"], t["w1"], t["w3"], t["w2"],
                                                             t["a1"], t["a3"], t["h"], t["dy"])),
             "library_ms": time_ms(library_whole), "bound_ms": b, "bound_by": by,
             "sum_of_kernel_bounds_ms": sum(out["timing"][k]["bound_ms"] for k in (
                 "gated_dgrad (a)", "dgrad (b)", "wgrad (c)", "wgrad (c)", "wgrad (c)"))}
    whole["previous_ms"] = [before, time_ms(previous_whole)]
    whole["speedup_vs_previous"] = min(whole["previous_ms"]) / whole["ms"]
    out["timing"]["layer backward"] = whole
    print(f"  moe_gmm_bwd, one MoE layer's backward (5 launches) at {K4B_SHAPE}, bf16, L2 "
          f"flushed, {smi}: {json.dumps(whole)}", flush=True)
    del t, da1, da3, g13, w13, gated_args
    gc.collect()
    torch.cuda.empty_cache()
    if kit.get("kernels_only"):  # tools/moe_train_phase.py --kernels-only
        return out

    # (3) + (4) deepseek-moe-16b through the training path (train_checks):
    # the f32 gates at MOE_GATE_LAYERS layers (batch F32_GATE_BATCH x
    # F32_GATE_SEQ), the bf16 steps at MOE_TRAIN_LAYERS layers eager and
    # compiled on SyntheticLM batch 0, a replayed step's profile
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    cfg32 = dataclasses.replace(full, n_layers=MOE_GATE_LAYERS, param_dtype="float32",
                                activation_dtype="float32")
    N = DENSE_TRAIN_STEPS
    tcfg = step_mod.TrainConfig(opt=optim.AdamWConfig(peak_lr=DENSE_TRAIN_LR, warmup_steps=1,
                                                      total_steps=N))

    def batches(batch: int, seq: int, n: int) -> list[dict]:
        data = SyntheticLM(DataConfig(full.vocab_size, seq, batch, seed=SEED))
        return [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
                for i in range(n)]

    b32 = batches(F32_GATE_BATCH, F32_GATE_SEQ, 2)
    rec = train_checks(dev, smi, f"5 (l) {MOE_ARCH}", cfg, cfg32, tcfg, b32,
                       lambda: batches(MOE_TRAIN_BATCH, DENSE_TRAIN_SEQ, 1) * N, fall_by=0.0)
    out["train"] = rec
    # its K1b launches (bf16 D 128: the wgmma pair whose warpgroups split D)
    out["k1b_launches"] = sum(rec[mode]["launches"]["flash_attention_bwd"]
                              for mode in ("eager", "compiled"))
    del b32
    gc.collect()
    torch.cuda.empty_cache()

    # (5) launch.train, as a user runs it, on the MoE arch's smoke config
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *MOE_CLI_ARGS],
                          cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=CLI_TIMEOUT_S)
    if proc.returncode != 0:
        fail(f"repro_torch.launch.train {' '.join(MOE_CLI_ARGS)} exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"5 (l) repro_torch.launch.train {' '.join(MOE_CLI_ARGS)}: {json.dumps(cli)}",
          flush=True)
    from repro_torch.configs import reduced

    small = reduced(full)
    n_steps = int(MOE_CLI_ARGS[MOE_CLI_ARGS.index("--steps") + 1])
    want = train_launches_per_step(small)
    exact = ("moe_gmm", "moe_gmm_bwd", "flash_attention_bwd")
    if (cli["compiled"] != {"calls": n_steps, "captures": 1, "replays": n_steps - 1}
            or any(cli["kernels"][k] != n_steps * want[k] for k in exact)
            or not cli["kernels"]["moe_gmm_bwd"]
            or not all(math.isfinite(cli[k]) for k in ("first_loss", "last_loss"))):
        fail(f"repro_torch.launch.train {' '.join(MOE_CLI_ARGS)}: compiled {cli['compiled']}, "
             f"kernels {cli['kernels']} (expected {n_steps} x {want} of {exact}), losses "
             f"{cli['first_loss']} -> {cli['last_loss']}")
    out["cli"] = cli

    launches = sum(rec[mode]["launches"]["moe_gmm_bwd"] for mode in ("eager", "compiled"))
    launches += cli["kernels"]["moe_gmm_bwd"]
    records["moe_gmm_bwd"] = {
        "name": "moe_gmm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm_bwd.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:54", "launches": launches,
        "max_abs_err": worst, "ms": whole["ms"], "plain_ms": whole["plain_ms"],
        "bound_ms": whole["bound_ms"], "bound_by": whole["bound_by"],
        "library_ms": whole["library_ms"], "shape": list(K4B_SHAPE),
        "kernels": out["timing"]}
    out["launches"] = launches
    return out


def measurement_phase(dev, smi: str) -> dict:
    """Phase 6: the paper's measurement layer on the card (see the module
    docstring); returns its record."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, microbench
    from repro_torch.core import overhead, roofline, sdfg, uprobes
    from repro_torch.core import tracepoints as tp
    from repro_torch.core.events import EventLog
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.hw.specs import default_chip
    from repro_torch.kernels import launch_counts, ops, reset_launches
    from repro_torch.models import lm
    from repro_torch.serving.compiled import Graphs
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.training import optim
    from repro_torch.training import step as step_mod
    from repro_torch.training.compiled import CompiledTrainStep

    chip = default_chip()
    rec: dict = {}
    cfg = get_config(ARCH)

    # -- (a) Table I: baseline / usdt / uprobes on the microbench (eager, and
    # baseline and usdt as CUDA graph replays), then on qwen2's loss forward
    print(f"6 (a) Table I, hyperfine protocol, {smi}:", flush=True)
    micro = overhead.bench_microbench(*TABLE1_MICRO, device=dev, rounds=TABLE1_ROUNDS)
    eager_rows = [r for r in micro if "_graph" not in r.label]
    graph_rows = [r for r in micro if "_graph" in r.label]
    print(f"microbench (Newton sqrt of 1..{microbench.N_VALUES} x {microbench.N_REPEAT}, "
          f"{microbench.NEWTON_ITERS} iterations), eager:\n{overhead.table(eager_rows)}", flush=True)
    print(f"microbench as CUDA graph replays:\n"
          f"{overhead.table(graph_rows, baseline='baseline_graph')}", flush=True)
    x = microbench.make_inputs(dev)
    probed = uprobes.inject_probes(microbench.approx_sqrt_workload,
                                   uprobes.by_primitive("clamp_min"), log=EventLog())
    probed_step = Graphs(dev).step(probed)
    probed_step(x)  # eager: allowed
    try:
        probed_step(x)  # the capture
    except RuntimeError as e:
        refusal = str(e)
    else:
        fail("the uprobes arm of the microbench was captured into a CUDA graph")
    if "CUDA graph capture" not in refusal:
        fail(f"the uprobes arm's capture raised {refusal!r}, not the capture refusal")
    print(f"microbench uprobes arm as a CUDA graph: refused ({refusal})", flush=True)
    params = lm.init_params(cfg, SEED, device=dev)
    mB, mS = TABLE1_MODEL_TOKENS
    model = overhead.bench_model_step(cfg, params, batch=mB, seq=mS, warmup=TABLE1_MODEL[0],
                                      runs=TABLE1_MODEL[1], device=dev, rounds=TABLE1_ROUNDS)
    print(f"{ARCH} loss forward, full width and depth, tokens ({mB}, {mS}):\n"
          f"{overhead.table(model)}", flush=True)
    rec["table1"] = {"microbench": [r.row() for r in micro],
                     "microbench_uprobes_graph": refusal, "model": [r.row() for r in model],
                     "overhead_vs_baseline": {
                         "microbench": _overheads(eager_rows),
                         "microbench_graph": _overheads(graph_rows, "baseline_graph"),
                         "model": _overheads(model)}}
    print("table I overhead vs baseline: "
          f"{json.dumps(rec['table1']['overhead_vs_baseline'])}", flush=True)

    # -- (b) Fig. 2: the user / system split of (a)
    print(f"6 (b) Fig 2, user / system CPU seconds over the measured calls, {smi}:\n"
          f"microbench:\n{overhead.fig2_table(micro)}\n{ARCH} loss forward:\n"
          f"{overhead.fig2_table(model)}", flush=True)
    # the arms' own mean times are in (a); each round's arms against that
    # round's baseline are in its overhead_vs_baseline
    rec["fig2"] = {"microbench": overhead.breakdown_fig2(micro),
                   "model": overhead.breakdown_fig2(model)}

    # -- (c) tracepoints on the served step: the compiled prefill and decode
    # tick with tracing disabled and with the tape, the eager step disabled
    # and in callback mode; the tick runs against the caches of a batch-8
    # prefill of 512 tokens, at position 520
    print("6 (c) tracepoints on qwen2-0.5b's compiled prefill and decode tick:", flush=True)
    rng = np.random.default_rng(SEED)
    B, P, MS = SERVE["max_batch"], SERVE["prompt_len"], SERVE["max_seq"]
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, P)))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, B))
    pos = torch.full((B,), P + 8, dtype=torch.int32)
    with torch.no_grad():
        caches = lm.prefill(params, cfg, torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, P))).to(dev), max_seq=MS)[1]
    fns = {"prefill": lambda t: lm.prefill(params, cfg, t, max_seq=MS)[0],
           "decode_tick": lambda t, p: lm.decode_step(params, cfg, t, p, caches)[0]}
    inputs = {"prefill": (prompt,), "decode_tick": (tok, pos)}
    point_name = {"prefill": "lm.prefill_logits", "decode_tick": "lm.decode_logits"}
    graphs = Graphs(dev)
    traced, times, kernels_vs_noop = {}, {}, {}
    reset_launches()
    for name, fn in fns.items():
        dev_in = [t.to(dev) for t in inputs[name]]
        plain = graphs.step(fn)
        taped = graphs.step(tp.collect(fn))
        for _ in range(3):  # eager, captured + replayed, replayed
            lg_off = plain(*inputs[name]).clone()
        with tp.enable("tape"):
            for _ in range(2):  # the eager call and the capture see the points
                taped(*inputs[name])
        lg_tape, tape = taped(*inputs[name])  # a replay, outside enable()
        lg_tape = lg_tape.clone()
        tape = {k: (float(v), n) for k, (v, n) in tape.items()}
        with torch.no_grad():
            lg_eager = fn(*dev_in)
            log = EventLog()
            with tp.enable("callback", log=log):
                lg_cb = fn(*dev_in)
        events = [(e.name, e.payload) for e in log.events("probe")]
        want_mean = float(torch.mean(lg_tape, dtype=torch.float32))
        # callback mode inside a capture: refused, naming it
        cb_step = graphs.step(fn)
        with tp.enable("callback", log=EventLog()):
            cb_step(*inputs[name])  # the eager call: allowed
            try:
                cb_step(*inputs[name])
            except RuntimeError as e:
                cb_refusal = str(e)
            else:
                cb_refusal = None
        del cb_step
        torch.cuda.synchronize()
        # the disabled step against the same step with tp.point replaced by a
        # bare no-op: its launches of the port's kernels, the aten ops it
        # dispatched with their shapes (so the cuBLAS and at::native kernels
        # behind them; sdfg.extract, which sees no profiler), and the kernels
        # the profiler names, where both sessions saw the card
        def launches_of(call) -> dict:
            before = launch_counts()
            call()
            return {k: v - before[k] for k, v in launch_counts().items()}

        def ops_of(call) -> list:
            return [(n.primitive, n.kernel, n.flops, n.bytes) for n in sdfg.extract(call).nodes]

        with torch.no_grad():
            off_prof = profile_step(lambda: fn(*dev_in))
            off_launches = launches_of(lambda: fn(*dev_in))
            off_ops = ops_of(lambda: fn(*dev_in))
            real_point = tp.point
            tp.point = lambda *a, **k: None
            try:
                noop_prof = profile_step(lambda: fn(*dev_in))
                noop_launches = launches_of(lambda: fn(*dev_in))
                noop_ops = ops_of(lambda: fn(*dev_in))
            finally:
                tp.point = real_point
        off_k = {k: n for k, _, n in off_prof["all_kernels"]}
        noop_k = {k: n for k, _, n in noop_prof["all_kernels"]}
        profiled = bool(off_k and noop_k)
        kernels_vs_noop[name] = {
            "kernels_compared": profiled, "kernels_equal": off_k == noop_k if profiled else None,
            "kernels": sum(off_k.values()), "ops_equal": off_ops == noop_ops,
            "ops": len(off_ops), "launches_equal": off_launches == noop_launches,
            "launches": off_launches}
        if not profiled:
            print(f"{ARCH} {name}: a profile named no kernel (disabled {len(off_k)}, no-op "
                  f"{len(noop_k)} names), so the kernel names were not compared; the "
                  "dispatched ops and LAUNCHES were", flush=True)
        # the tape's cost on the compiled step
        warm, runs = TAPE_STEP_RUNS[name]
        arms = overhead.run_arms([("baseline", lambda s=plain: s(*inputs[name])),
                                  ("usdt", lambda s=taped: s(*inputs[name]))],
                                 warmup=warm, runs=runs, rounds=TABLE1_ROUNDS)
        times[name] = arms
        print(f"{ARCH} compiled {name}, replays with tracing off (baseline) and with the "
              f"tape (usdt), {smi}:\n{overhead.table(arms)}", flush=True)
        traced[name] = {
            "logits_bit_equal": {"tape_vs_off": torch.equal(lg_tape, lg_off),
                                 "eager_vs_off": torch.equal(lg_eager, lg_off),
                                 "callback_vs_off": torch.equal(lg_cb, lg_off)},
            "tape": tape, "tape_point_equals_mean_of_logits":
                tape[point_name[name]][0] == want_mean,
            "callback_events": [n for n, _ in events],
            "callback_logits_event_equal": torch.equal(
                dict(events)[point_name[name]], lg_cb.cpu()),
            "callback_in_capture_refused": cb_refusal,
            "disabled_vs_noop_point": kernels_vs_noop[name],
            "by_scope_ms": off_prof["by_scope"], "profile_wall_ms": off_prof["wall_ms"],
            "device_busy_ms": off_prof["device_busy_ms"],
            "compiled_ms": {a.label: a.row() for a in arms},
            "tape_overhead": _overheads(arms)}
        print(f"{ARCH} {name} tracepoints: {json.dumps(traced[name])}", flush=True)
        t = traced[name]
        if not all(t["logits_bit_equal"].values()):
            fail(f"{ARCH} {name}: logits differ across the tracing arms: {t['logits_bit_equal']}")
        if not t["tape_point_equals_mean_of_logits"] or set(tape) != {
                "lm.embed_out", "lm.stack_out", point_name[name]}:
            fail(f"{ARCH} {name}: the tape {tape} does not hold the step's own logits' mean "
                 f"{want_mean}")
        if t["callback_events"] != ["lm.embed_out", "lm.stack_out", point_name[name]] or \
                not t["callback_logits_event_equal"]:
            fail(f"{ARCH} {name}: callback events {t['callback_events']}")
        if cb_refusal is None or "CUDA graph capture" not in cb_refusal:
            fail(f"{ARCH} {name}: callback mode inside a capture was not refused ({cb_refusal})")
        kv = kernels_vs_noop[name]
        if not (kv["launches_equal"] and kv["ops_equal"] and kv["kernels_equal"] is not False):
            fail(f"{ARCH} {name}: with tracing disabled the step ran other kernels than with "
                 f"the points removed: {kernels_vs_noop[name]}")
        if not off_prof["by_scope"]:
            fail(f"{ARCH} {name}: the profile names no scope")
        del plain, taped
    launches_c = launch_counts()
    print(f"6 (c) launches of the instrumented qwen2 steps: {json.dumps(launches_c)}", flush=True)
    for k in ("flash_attention", "decode_attention", "rmsnorm"):
        if launches_c[k] == 0:
            fail(f"6 (c): the instrumented serving path launched no {k}")
    rec["tracepoints"] = traced

    # -- (d) the compiled train step with its tape
    print("6 (d) smollm-360m's compiled train step with its tape:", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = get_config(TRAIN_ARCH)
    tcfg_train = step_mod.TrainConfig(opt=optim.AdamWConfig(
        peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(tcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)).batch(0).items()}
    state = step_mod.init_train_state(tcfg, tcfg_train, SEED, dev)
    cstep = CompiledTrainStep(tcfg, tcfg_train, state)
    reset_launches()
    train_tape, replay_ms = [], []
    for i in range(2 + TAPE_TRAIN_REPLAYS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < 2:  # the eager call and the capture see the points
            with tp.enable("tape"):
                _, m = cstep(state, batch)
        else:
            _, m = cstep(state, batch)
        torch.cuda.synchronize()
        if i >= 2:
            replay_ms.append(1e3 * (time.perf_counter() - t0))
        tape = cstep.tape
        train_tape.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                           **{k: v.item() for k, (v, _) in tape.items()}})
    launches_d = launch_counts()
    train_rec = {"calls": train_tape, "counts": cstep.counts(), "replay_ms": replay_ms,
                 "median_replay_ms": float(np.median(replay_ms)), "launches": launches_d}
    print(f"{TRAIN_ARCH} compiled train step with tape, {smi}: {json.dumps(train_rec)}",
          flush=True)
    if any(c["train.loss"] != c["loss"] or c["lm.loss"] != c["loss"]
           or c["train.grad_norm"] != c["grad_norm"] for c in train_tape):
        fail(f"{TRAIN_ARCH}: the compiled step's tape differs from its metrics")
    if cstep.counts()["captures"] != 1:
        fail(f"{TRAIN_ARCH}: the compiled step with its tape ran {cstep.counts()}")
    for k in ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd"):
        if launches_d[k] == 0:
            fail(f"6 (d): the compiled train step launched no {k}")
    rec["train_tape"] = train_rec

    # -- (e) uprobes on the kernels' ops entries over one eager prefill and tick
    print("6 (e) uprobes attached to ops.attention, ops.decode_attention, ops.rmsnorm:",
          flush=True)
    names = {"attention": "flash_attention", "decode_attention": "decode_attention",
             "rmsnorm": "rmsnorm"}
    originals = {n: getattr(ops, n) for n in names}
    firsts: dict[str, list] = {n: [] for n in names}

    def recording(n):
        def call(*a, **k):
            out = originals[n](*a, **k)
            firsts[n].append(out.reshape(-1)[0].float().item())
            return out
        return call

    log = EventLog()
    reset_launches()
    try:
        for n in names:
            setattr(ops, n, recording(n))
        with uprobes.ProbeRegistry(log) as reg, torch.no_grad():
            for n in names:
                reg.attach(ops, n)
            _, c1 = lm.prefill(params, cfg, prompt.to(dev), max_seq=MS)
            lm.decode_step(params, cfg, tok[:1].to(dev), torch.full((1,), P, dtype=torch.int32,
                                                                    device=dev), c1)
    finally:
        for n, f in originals.items():
            setattr(ops, n, f)
    launches_e = launch_counts()
    rets = {n: [e.payload for e in log.events("probe")
                if e.name == f"repro_torch.kernels.ops.{n}:ret"] for n in names}
    probes = {n: {"ret_events": len(rets[n]), "launches": launches_e[k],
                  "ret_equal_first_element": rets[n] == firsts[n]} for n, k in names.items()}
    print(f"uprobes: {json.dumps(probes)}", flush=True)
    for n, p in probes.items():
        if p["ret_events"] != p["launches"] or not p["launches"] or \
                not p["ret_equal_first_element"]:
            fail(f"uprobes on ops.{n}: {p}")
    rec["uprobes"] = probes
    del c1

    # -- (f) roofline and SDFG of qwen2's prefill and tick and smollm's step;
    # model-FLOP and roofline shares of the measured compiled steps
    print(f"6 (f) roofline and SDFG on {chip.name} ({smi}):", flush=True)
    train_fn = step_mod.make_train_step(tcfg, tcfg_train)
    measured = {**{n: min(r.median_ms for r in times[n] if r.label.startswith("baseline"))
                   for n in ("prefill", "decode_tick")},
                "train_step": train_rec["median_replay_ms"]}
    shapes = {"prefill": roofline.ShapeConfig("prefill", P, 1, "prefill"),
              "decode_tick": roofline.ShapeConfig("decode", P + 9, B, "decode"),
              "train_step": roofline.ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")}
    runs = {"prefill": lambda: fns["prefill"](prompt.to(dev)),
            "decode_tick": lambda: fns["decode_tick"](tok.to(dev), pos.to(dev)),
            "train_step": lambda: train_fn(state, batch)}
    analyses = {}
    for name, fn in runs.items():
        with torch.no_grad() if name != "train_step" else contextlib.nullcontext():
            a = roofline.analyze_step(fn, chip=chip)
        g = a.pop("sdfg")
        c, p_ = (tcfg, state["params"]) if name == "train_step" else (cfg, params)
        mf = roofline.model_flops(c, shapes[name], p_)
        t_s = measured[name] / 1e3
        regions = sorted(g.regions().values(), key=lambda r: -(r.flops + r.bytes))
        a.update({
            "measured_compiled_ms": measured[name], "model_flops": mf,
            "model_flop_share": mf / (t_s * chip.peak_flops_bf16),
            "roofline_share": a["step_time_bound_s"] / t_s,
            "regions": [{"name": r.name, "flops": r.flops, "bytes": r.bytes, "nodes": r.nodes,
                         "match": r.match(chip)} for r in regions[:12]],
            "n_regions": len(regions),
            "kernel_nodes_by_name": _count(n.primitive for n in g.nodes if n.kernel)})
        analyses[name] = a
        print(f"{name}: {json.dumps(a)}", flush=True)
        if a["model_flop_share"] > SHARE_MAX or a["roofline_share"] > SHARE_MAX:
            fail(f"6 (f) {name}: model-FLOP share {a['model_flop_share']:.3f}, roofline share "
                 f"{a['roofline_share']:.3f}: over {SHARE_MAX}")
        if not a["kernel_nodes"]:
            fail(f"6 (f) {name}: the SDFG holds no kernel launch")
        del g
    rec["roofline"] = analyses
    del cstep, state, batch, train_fn, runs
    gc.collect()
    torch.cuda.empty_cache()

    # -- (g) R13: 12 requests over 6 prompt lengths, each twice in a row, with
    # the cap at R13_CAP, against the eager engine; then the same with no cap
    # (every length kept), for contrast.  All 12 prefills come before the
    # first decode tick (12 slots), so the memory read after each is theirs.
    print(f"6 (g) R13: {ARCH}, prompt lengths {R13_LENGTHS} twice each, cap {R13_CAP}:",
          flush=True)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in R13_LENGTHS for _ in (0, 1)]
    r13: dict = {}
    for label, compiled, cap in (("eager", False, R13_CAP), ("capped", True, R13_CAP),
                                 ("uncapped", True, len(R13_LENGTHS))):
        gc.collect()
        torch.cuda.empty_cache()
        eng = Engine(cfg, params, ServeConfig(max_batch=len(prompts), max_seq=MS, seed=SEED),
                     compiled=compiled, max_prefill_graphs=cap)
        base = torch.cuda.memory_reserved()
        after: list = []
        inner = eng.prefill

        def prefill(tokens, _inner=inner, _after=after):
            out = _inner(tokens)
            _after.append((tokens.shape[1], (torch.cuda.memory_reserved() - base) / 2**20))
            return out

        eng.prefill = prefill
        rids = [eng.submit(pr, max_new=8) for pr in prompts]
        res = eng.run_to_completion()
        toks_out = [res[r] for r in rids]
        # the memory after each length's second call (its capture)
        per_length = [mb for i, (n, mb) in enumerate(after) if i % 2 == 1]
        r13[label] = {"tokens": toks_out, "reserved_mib_after_each_prefill": after,
                      "reserved_mib_after_each_length": per_length,
                      "graphs": eng.compiled_counts()}
        del eng, inner, prefill
    same = sum(a == b for a, b in zip(r13["capped"]["tokens"], r13["eager"]["tokens"]))
    same_u = sum(a == b for a, b in zip(r13["uncapped"]["tokens"], r13["eager"]["tokens"]))
    cap_mb = r13["capped"]["reserved_mib_after_each_length"]
    unc_mb = r13["uncapped"]["reserved_mib_after_each_length"]
    summary = {"requests": len(prompts), "equal_tokens_capped": same,
               "equal_tokens_uncapped": same_u,
               "capped_reserved_mib_after_each_length": cap_mb,
               "uncapped_reserved_mib_after_each_length": unc_mb,
               "capped_growth_after_cap_mib": max(cap_mb[R13_CAP:]) - cap_mb[R13_CAP - 1],
               "uncapped_growth_after_cap_mib": max(unc_mb[R13_CAP:]) - unc_mb[R13_CAP - 1],
               "capped_graphs": r13["capped"]["graphs"],
               "uncapped_kept": list(r13["uncapped"]["graphs"]["prefill"])}
    print(f"R13, {smi}: {json.dumps(summary)}", flush=True)
    kept = list(r13["capped"]["graphs"]["prefill"])
    evicted = r13["capped"]["graphs"]["prefill_evictions"]
    if same != len(prompts) or same_u != len(prompts):
        fail(f"R13: the compiled engines' tokens differ from the eager engine's ({summary})")
    if kept != list(R13_LENGTHS[-R13_CAP:]) or evicted != len(R13_LENGTHS) - R13_CAP:
        fail(f"R13: kept {kept}, evicted {evicted}")
    if summary["capped_growth_after_cap_mib"] > 0:
        fail(f"R13: reserved memory grew after the cap was reached: {cap_mb}")
    if summary["uncapped_growth_after_cap_mib"] <= 0:
        fail(f"R13: without the cap reserved memory did not grow after the {R13_CAP}th length "
             f"either ({unc_mb}), so the capped reading cannot tell eviction from no growth")
    rec["r13"] = {**summary, "runs": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                                      for k, v in r13.items()}}
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return rec

def dispatch_phase(dev, smi: str, records: dict, compiled_losses: list) -> dict:
    """Phase 7: profile-guided dispatch on the card (see the module
    docstring); adds its runs' launches to ``records`` and returns its
    record.  ``compiled_losses`` are phase 5 (e')'s compiled run's losses,
    step by step (launch.train's schedule is the same for 8 and 20 steps
    until step 10: warmup)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.events import EventLog
    from repro_torch.dispatch import DispatchConfig, Dispatcher, ProfileStore, host_registry
    from repro_torch.kernels import LAUNCHES, launch_counts, reset_launches
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.trace.session import load_profile_store

    rec: dict = {}
    reg = host_registry(device=dev)
    if reg.names() != ["kernel", "plain"]:
        fail(f"host_registry on {dev}: {reg.names()}, expected ['kernel', 'plain']")
    # phase 7's launches, added to the kernel line (the wide K1b's record is
    # launched only in phases 5 (k) and (l): its launches count as
    # flash_attention_bwd)
    stray = {name: 0 for name in records if name in LAUNCHES}

    def memory(label: str) -> dict:
        line = {"held_gb": torch.cuda.memory_allocated() / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"7 {label} memory: {json.dumps(line)}", flush=True)
        return line

    def ms(xs) -> "float | None":
        return 1e3 * float(np.median(xs)) if len(xs) else None

    def run(label, c, p, spec, policy=None, backend="kernel"):
        """One serve set through the compiled engine, undispatched (policy
        None) or under a dispatcher over the card's tiers, with the launch
        counts reset just before; every request delivered in full, every
        decision measured and logged."""
        log = EventLog()
        disp = None if policy is None else Dispatcher(
            DispatchConfig(policy=policy, static_backend=backend,
                           min_samples=DISPATCH_MIN_SAMPLES), registry=reg, log=log)
        eng = Engine(c, p, ServeConfig(max_batch=spec["max_batch"], max_seq=spec["max_seq"],
                                       seed=SEED), log=log, dispatcher=disp)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, c.vocab_size, spec["prompt_len"]).tolist()
                   for _ in range(spec["requests"])]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        rids = [eng.submit(pr, max_new=spec["max_new"]) for pr in prompts]
        res = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.time() - t0
        outs = [res.get(r, []) for r in rids]
        if any(len(o) != spec["max_new"] for o in outs):
            fail(f"7 {label}: serving did not deliver every request in full")
        ticks, prefills = log.durations("decode_tick"), log.durations("prefill")
        r = {"policy": policy or "off", "arch": c.name, "layers": c.n_layers,
             "dtype": c.activation_dtype, **spec, "wall_s": wall,
             "tokens_per_s": sum(map(len, outs)) / wall,
             # the first two of each step run eagerly / capture
             "median_tick_ms": ms(ticks[2:]), "median_prefill_ms": ms(prefills[2:]),
             "kernels": launch_counts(), "graphs": eng.compiled_counts(),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        for name in stray:
            stray[name] += r["kernels"][name]
        if disp is not None:
            r["static_backend"] = backend if policy == "static" else None
            r["dispatch"] = disp.summary()
            r["dispatch_events"] = len(log.events(kind="dispatch"))
            if (r["dispatch_events"] != r["dispatch"]["decisions"]
                    or any(d.measured_s is None for d in disp.decisions)):
                fail(f"7 {label}: {r['dispatch_events']} dispatch events for "
                     f"{r['dispatch']['decisions']} decisions, or a decision without measured_s")
            r["decision_ms"] = {op: {b: ms([d.measured_s for d in disp.decisions
                                            if d.op == op and d.backend == b][2:])
                                     for b in reg.names()}
                                for op in ("serve_prefill", "serve_decode")}
        print(f"7 {label}: {json.dumps(r)}", flush=True)
        return eng, disp, outs, r

    def check_profiled(label, disp) -> dict:
        """Each tier explored DISPATCH_MIN_SAMPLES times per surface, and
        every later decision the tier whose minimum sample so far is lower."""
        seen: dict = {}
        for d in disp.decisions:
            samples = seen.setdefault(d.op, {b: [] for b in reg.names()})
            if d.source == "measured":
                best = min(samples, key=lambda b: min(samples[b], default=float("inf")))
                if any(len(v) < DISPATCH_MIN_SAMPLES for v in samples.values()):
                    fail(f"7 {label}: {d.op} measured before every tier was warm")
                if d.backend != best:
                    fail(f"7 {label}: {d.op} chose {d.backend}, the minimum samples were "
                         f"{ {b: min(v) for b, v in samples.items()} }")
            elif d.source != "explore":
                fail(f"7 {label}: a decision from {d.source!r}")
            samples[d.backend].append(d.measured_s)
        explored = {op: {b: sum(1 for d in disp.decisions if d.op == op and d.backend == b
                                and d.source == "explore") for b in reg.names()}
                    for op in seen}
        if any(n < DISPATCH_MIN_SAMPLES for v in explored.values() for n in v.values()):
            fail(f"7 {label}: explored {explored}, each tier at least {DISPATCH_MIN_SAMPLES}")
        return {"explored": explored,
                "min_sample_ms": {op: {b: 1e3 * min(v) for b, v in s.items()}
                                  for op, s in seen.items()},
                "settled_on": {op: disp.decisions[max(i for i, d in enumerate(disp.decisions)
                                                      if d.op == op)].backend for op in seen}}

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ARCH)

    # -- (a) qwen2-0.5b, full width and depth, bf16, five ways ---------------
    print(f"7 (a) {ARCH} under dispatch, {smi}:", flush=True)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, SEED, device=dev)
    rec["a_memory_after_init"] = memory("(a) init")
    runs = {}
    for label, policy, backend in (("off", None, "kernel"), ("static_kernel", "static", "kernel"),
                                   ("static_plain", "static", "plain"),
                                   ("roofline", "roofline", "kernel"),
                                   ("profiled", "profiled", "kernel")):
        eng, disp, outs, r = run(f"(a) {label}", cfg, params, DISPATCH_SERVE, policy, backend)
        if policy == "roofline":
            r["estimates_ms"] = {op: {b: 1e3 * s for b, s in est.items()}
                                 for (op, _), est in eng._est_cache.items()}
        if policy == "profiled":
            r["profiled"] = check_profiled("(a) profiled", disp)
        runs[label] = (outs, r)
        del eng, disp
        gc.collect()
    rec["a_memory"] = memory("(a) sets")
    off, sk, sp = runs["off"], runs["static_kernel"], runs["static_plain"]
    if sk[0] != off[0]:
        fail("7 (a): the static kernel run's tokens differ from the undispatched run's")
    if sk[1]["kernels"] != off[1]["kernels"]:
        fail(f"7 (a): static kernel launches {sk[1]['kernels']}, undispatched "
             f"{off[1]['kernels']}")
    if any(sp[1]["kernels"].values()):
        fail(f"7 (a): the static plain run launched {sp[1]['kernels']}")
    roof = runs["roofline"][1]
    if any(set(v) != {"kernel"} for v in roof["dispatch"]["by_op"].values()):
        fail(f"7 (a): roofline chose {roof['dispatch']['by_op']}, the kernels expected")
    n_tok = sum(map(len, off[0]))
    agree = {"requests_equal": sum(a == b for a, b in zip(sk[0], sp[0])),
             "requests": len(sk[0]),
             "tokens_equal": sum(x == y for a, b in zip(sk[0], sp[0]) for x, y in zip(a, b)),
             "tokens": n_tok,
             "first_divergence": [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                                  for a, b in zip(sk[0], sp[0])]}
    tiers = {"replay_ms": {"kernel": sk[1]["decision_ms"], "plain": sp[1]["decision_ms"]},
             "roofline_estimates_ms": roof["estimates_ms"],
             "roofline_choices": roof["dispatch"]["by_op"],
             "profiled": runs["profiled"][1]["profiled"],
             "profiled_choices": runs["profiled"][1]["dispatch"]["by_op"]}
    cost = {"undispatched_tick_ms": off[1]["median_tick_ms"],
            "static_kernel_tick_ms": sk[1]["median_tick_ms"],
            "dispatcher_ms": sk[1]["median_tick_ms"] - off[1]["median_tick_ms"],
            "dispatcher_share": sk[1]["median_tick_ms"] / off[1]["median_tick_ms"] - 1,
            "undispatched_prefill_ms": off[1]["median_prefill_ms"],
            "static_kernel_prefill_ms": sk[1]["median_prefill_ms"]}
    print(f"7 (a) {ARCH} tiers, {smi}: {json.dumps(tiers)}", flush=True)
    print(f"7 (a) {ARCH} dispatcher cost a step (median replays, static kernel vs "
          f"undispatched): {json.dumps(cost)}", flush=True)
    print(f"7 (a) {ARCH} bf16 tokens, static kernel vs static plain (ROADMAP R10; reported): "
          f"{json.dumps(agree)}", flush=True)
    rec["a"] = {"runs": {k: v[1] for k, v in runs.items()}, "tiers": tiers, "cost": cost,
                "bf16_token_agreement": agree}

    # -- (e) warm start through the serve driver ----------------------------
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_profiles_"))
    try:
        argv = ["--arch", ARCH, "--seed", str(SEED), "--dispatch", "profiled",
                *(f"--{k.replace('_', '-')}={DISPATCH_SERVE[k]}" for k in
                  ("requests", "prompt_len", "max_new", "max_batch", "max_seq"))]
        store_path, tpu_path = tmp / "card.json", tmp / "tpu_v5e.json"
        cold = serve_cli.main(argv + ["--profile-out", str(store_path)])
        tpu = ProfileStore()
        tpu.set_stamp(git_sha="0000000", chip="tpu_v5e")
        for backend in ("pallas", "chunked", "ref"):
            tpu.record("serve_prefill", backend, "int32[1,512]", 5e-3)
            tpu.record("serve_decode", backend, "int32[8]", 3e-3)
        tpu_path.write_text(tpu.to_json())
        warm = serve_cli.main(argv + ["--profile-in", str(store_path),
                                      "--profile-in", str(tpu_path)])
        card_store = load_profile_store(str(store_path))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in stray:
        stray[name] += cold["kernels"][name] + warm["kernels"][name]
    stamps = sorted({(e.git_sha, e.chip) for e in card_store._entries.values()})
    warm_rec = {"cold_explore": cold["dispatch"]["explore_dispatches"],
                "warm_explore": warm["dispatch"]["explore_dispatches"],
                "tpu_entries": len(tpu), "profile_aged_out": warm["profile_aged_out"],
                "card_store_entries": len(card_store), "card_store_stamps": stamps,
                "cold_tokens_per_s": cold["tokens_per_s"], "warm_tokens_per_s": warm["tokens_per_s"],
                "cold_by_op": cold["dispatch"]["by_op"], "warm_by_op": warm["dispatch"]["by_op"]}
    print(f"7 (e) warm start through launch.serve: {json.dumps(warm_rec)}", flush=True)
    if warm_rec["cold_explore"] == 0 or warm_rec["warm_explore"] != 0:
        fail(f"7 (e): explore dispatches cold {warm_rec['cold_explore']}, warm "
             f"{warm_rec['warm_explore']}; expected > 0 and 0")
    if warm_rec["profile_aged_out"] != len(tpu) or any(c != "h100_sxm" for _, c in stamps):
        fail(f"7 (e): aged out {warm_rec['profile_aged_out']} of the TPU store's {len(tpu)} "
             f"entries; the card's store is stamped {stamps}")
    rec["e"] = {**warm_rec, "memory": memory("(e) warm start")}
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the f32 gate: switching tiers partway through requests ---------
    c32 = dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32",
                              n_layers=DISPATCH_GATE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    p32 = lm.init_params(c32, SEED, device=dev)
    _, _, base, base_r = run("(b) f32 off", c32, p32, DISPATCH_GATE_SERVE)
    _, disp, got, prof_r = run("(b) f32 profiled", c32, p32, DISPATCH_GATE_SERVE, "profiled")
    switched = {op: set(v) for op, v in prof_r["dispatch"]["by_op"].items()}
    gate_b = {"requests": len(base), "requests_equal": sum(a == b for a, b in zip(base, got)),
              "by_op": prof_r["dispatch"]["by_op"], "profiled": check_profiled("(b)", disp),
              "memory": memory("(b) f32 gate")}
    print(f"7 (b) {ARCH} f32 gate at {DISPATCH_GATE_LAYERS} layers, profiled vs undispatched: "
          f"{json.dumps(gate_b)}", flush=True)
    if gate_b["requests_equal"] != len(base):
        fail("7 (b): the profiled engine's f32 tokens differ from the undispatched engine's")
    if any(v != {"kernel", "plain"} for v in switched.values()):
        fail(f"7 (b): the profiled engine did not switch tiers ({switched})")
    rec["b"] = {**gate_b, "runs": {"off": base_r, "profiled": prof_r}}
    del p32, disp
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) recurrent state: rwkv6-7b at full width, 4 layers, f32 ---------
    rc = dataclasses.replace(get_config(RWKV_ARCH), param_dtype="float32",
                             activation_dtype="float32", n_layers=DISPATCH_RWKV_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    rp = lm.init_params(rc, SEED, device=dev)
    seed_rwkv_noise(rp, torch.Generator(device=dev).manual_seed(SEED))
    rwkv_runs = {}
    for policy in (None, "roofline", "profiled"):
        _, disp, outs, r = run(f"(c) {RWKV_ARCH} f32 {policy or 'off'}", rc, rp,
                               DISPATCH_RWKV_SERVE, policy)
        rwkv_runs[policy or "off"] = (outs, r)
        del disp
    gate_c = {pol: sum(a == b for a, b in zip(outs, rwkv_runs["off"][0]))
              for pol, (outs, _) in rwkv_runs.items()}
    gate_c_rec = {"requests": DISPATCH_RWKV_SERVE["requests"], "requests_equal": gate_c,
                  "profiled_by_op": rwkv_runs["profiled"][1]["dispatch"]["by_op"],
                  "rwkv6_scan_launches": {k: v[1]["kernels"]["rwkv6_scan"]
                                          for k, v in rwkv_runs.items()},
                  "memory": memory("(c) rwkv6-7b")}
    print(f"7 (c) {RWKV_ARCH} f32, {DISPATCH_RWKV_LAYERS} layers, dispatched vs undispatched "
          f"tokens: {json.dumps(gate_c_rec)}", flush=True)
    if any(n != DISPATCH_RWKV_SERVE["requests"] for n in gate_c.values()):
        fail(f"7 (c): {RWKV_ARCH}'s dispatched tokens differ from the undispatched run's "
             f"({gate_c}): pricing or a tier switch moved the recurrent state")
    rec["c"] = {**gate_c_rec, "runs": {k: v[1] for k, v in rwkv_runs.items()}}
    del rp
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) training through launch.train --dispatch profiled --------------
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    store_path = Path(ckpt_dir) / "train_profiles.json"
    cli_args = ["--arch", TRAIN_ARCH, "--steps", str(DISPATCH_TRAIN_STEPS), "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir", ckpt_dir,
                "--ckpt-every", str(DISPATCH_CKPT_EVERY), "--fail-at", str(DISPATCH_FAIL_AT),
                "--dispatch", "profiled", "--profile-out", str(store_path)]
    try:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *cli_args],
                              cwd=ROOT, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                              timeout=CLI_TIMEOUT_S)
        if proc.returncode != 0:
            fail(f"7 (d) repro_torch.launch.train exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        store = load_profile_store(str(store_path))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in stray:
        stray[name] += cli["kernels"][name]
    sig = f"int32[{TRAIN_BATCH},{TRAIN_SEQ}];int32[{TRAIN_BATCH},{TRAIN_SEQ}]"
    tier_ms = {}
    for b in reg.names():
        e = store.entry("train_step", b, sig)
        tier_ms[b] = None if e is None else {"samples": e.count, "min_ms": 1e3 * e.min_s,
                                             "mean_ms": 1e3 * e.mean_s}
    first_plain = cli["step_backends"].index("plain") if "plain" in cli["step_backends"] \
        else len(cli["step_backends"])
    kernel_steps = list(range(first_plain))
    train_rec = {"args": " ".join(cli_args[:-2]), "restarts": cli["restarts"],
                 "stragglers": cli["stragglers"], "by_op": cli["dispatch"]["by_op"],
                 "by_source": cli["dispatch"]["by_source"], "step_backends": cli["step_backends"],
                 "compiled": cli["compiled"], "tier_step_ms": tier_ms, "step_ms": cli["step_ms"],
                 "losses": cli["losses"], "kernel_steps_before_first_plain": kernel_steps,
                 "losses_equal_compiled_run": all(
                     cli["losses"][i] == compiled_losses[i] for i in kernel_steps),
                 "kernels": cli["kernels"]}
    print(f"7 (d) repro_torch.launch.train {train_rec['args']}, {smi}: {json.dumps(train_rec)}",
          flush=True)
    if set(cli["dispatch"]["by_op"].get("train_step", {})) != {"kernel", "plain"}:
        fail(f"7 (d): train_step dispatched to {cli['dispatch']['by_op']}, both tiers expected")
    if cli["restarts"] != 1:
        fail(f"7 (d): {cli['restarts']} restarts, expected 1")
    if not kernel_steps or not train_rec["losses_equal_compiled_run"]:
        fail(f"7 (d): the kernel tier's losses {[cli['losses'][i] for i in kernel_steps]} "
             f"against phase 5 (e')'s {compiled_losses[:len(kernel_steps)]}")
    rec["d"] = train_rec

    for name in stray:
        records[name]["launches"] += stray[name]
    rec["launches"] = stray
    return rec


def trace_phase(dev, smi: str, records: dict, tick_profile: dict, training: dict) -> dict:
    """Phase 8: the trace and metrics plane on the card (see the module
    docstring).  ``tick_profile`` is phase 4's ``profile_step`` of a replayed
    qwen2 tick, ``training`` phase 5's record (its compiled run's losses,
    the supervised run's step spans, a step's launches); adds the runs'
    launches to ``records`` and returns the phase's record."""
    import threading
    import urllib.request

    import torch

    from repro_torch.kernels import LAUNCHES, uncounted
    from repro_torch.kernels import rmsnorm as k3
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.trace import liveprof
    from repro_torch.trace.cli import main as trace_cli
    from repro_torch.trace.device import NoDeviceRows, load_window
    from repro_torch.trace.session import Session
    from repro_torch.trace.stream import MANIFEST_NAME, load_stream
    from repro_torch.utils.ready import wait_for_ready_file
    sys.path.insert(0, str(ROOT / "tools"))
    from trace_record_cost import record_cost

    work = Path(tempfile.mkdtemp(prefix="repro_torch_trace_"))
    rec: dict = {}
    stray = {name: 0 for name in records if name in LAUNCHES}
    compiled_rec = training["compiled"]

    def cli(*argv) -> str:
        """``python -m repro_torch.trace *argv``, in this process (a child
        would spend seconds importing torch for each)."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = trace_cli(list(argv))
        if rc != 0:
            fail(f"8: python -m repro_torch.trace {' '.join(argv)} exited {rc}")
        return out.getvalue()

    def lineage(spans: dict, sid: int) -> list:
        """The spans from ``sid`` up to its root, innermost first."""
        out = []
        while sid in spans and len(out) < 64:
            out.append(spans[sid])
            sid = spans[sid].parent
        return out

    def device_tree(sess) -> tuple[dict, list]:
        spans = {s.span: s for s in sess.spans() if s.span}
        return spans, [e for e in sess.events if e.kind == "device"]

    def bound(dev_evs: list, label: str) -> dict:
        """Every slice bound to a host span; the share bound by annotation."""
        modes = _count(e.payload.get("align") for e in dev_evs)
        unbound = [e.name for e in dev_evs if not e.parent or e.payload.get("align") == "none"]
        if not dev_evs or unbound:
            fail(f"8 {label}: {len(dev_evs)} device slices, unbound: {unbound[:8]}")
        return {"slices": len(dev_evs), "align": modes,
                "span_share": modes.get("span", 0) / len(dev_evs)}

    def under(spans: dict, dev_evs: list, pattern: str, unit: str, label: str,
              dispatched: bool = False) -> int:
        """The slices named ``pattern`` each sit under a ``unit`` span (and,
        with ``dispatched``, right under a dispatch event)."""
        got = [e for e in dev_evs if re.search(pattern, e.name)]
        for e in got:
            chain = lineage(spans, e.parent)
            if unit not in [s.name for s in chain] or (
                    dispatched and (not chain or chain[0].track != "dispatch")):
                fail(f"8 {label}: {e.name[:60]} bound under {[s.name for s in chain]}, "
                     f"expected a {unit} span" + (" through a dispatch" if dispatched else ""))
        if not got:
            fail(f"8 {label}: no {pattern} slice in any window")
        return len(got)

    try:
        # -- (a) qwen2-0.5b served, traced -----------------------------------
        base = ["--arch", ARCH, "--requests", str(SERVE["requests"]),
                "--prompt-len", str(SERVE["prompt_len"]), "--max-new", str(SERVE["max_new"]),
                "--max-batch", str(SERVE["max_batch"]), "--max-seq", str(SERVE["max_seq"]),
                "--dispatch", "static", "--dispatch-backend", "kernel"]
        with contextlib.redirect_stdout(io.StringIO()):  # the drivers' long JSON lines
            plain, plain_out = serve_cli.run(base)
        gc.collect()
        torch.cuda.empty_cache()
        scraped: dict = {}

        def scrape() -> None:
            url = wait_for_ready_file(str(work / "ready"), timeout_s=300)
            deadline = time.time() + 300
            while time.time() < deadline:
                with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
                    text = r.read().decode()
                if f"repro_requests_total {SERVE['requests']}" in text:
                    scraped["text"] = text
                    return
                time.sleep(0.2)

        scraper = threading.Thread(target=scrape, daemon=True)
        scraper.start()
        with contextlib.redirect_stdout(io.StringIO()):
            traced, traced_out = serve_cli.run(base + [
                "--trace-out", str(work / "serve.json"), "--trace-dir", str(work / "serve_dir"),
                "--trace-rotate", str(TRACE_ROTATE), "--metrics-port", "0",
                "--ready-file", str(work / "ready"), "--metrics-linger-s", str(TRACE_LINGER_S),
                "--trace-overhead-budget-pct", str(TRACE_BUDGET_PCT),
                "--torch-profile", str(work / "serve_prof"), "--torch-profile-backend", "torch",
                "--torch-profile-period-s", str(TRACE_PERIOD_S)])
        scraper.join(timeout=60)
        gc.collect()
        torch.cuda.empty_cache()
        for r in (plain, traced):
            for name in stray:
                stray[name] += r["kernels"][name]
        if traced_out != plain_out or traced["kernels"] != plain["kernels"]:
            fail(f"8 (a): traced run's launches {traced['kernels']} / tokens against the "
                 f"untraced {plain['kernels']}, equal requests "
                 f"{sum(traced_out[k] == plain_out.get(k) for k in traced_out)}")
        sess = Session.load(traced["trace_out"])
        spans, dev_evs = device_tree(sess)
        a = {"tokens_per_s": {"untraced": plain["tokens_per_s"], "traced": traced["tokens_per_s"]},
             "wall_s": {"untraced": plain["wall_s"], "traced": traced["wall_s"]},
             "requests_equal": len(traced_out), "launches_equal": True,
             "bound": bound(dev_evs, "(a)"),
             "k1_under_prefill": under(spans, dev_evs, r"flash_fwd_mma", "prefill", "(a)", True),
             "k2_under_decode_tick": under(spans, dev_evs, r"decode_split_mma|decode_combine",
                                           "decode_tick", "(a)", True),
             "k3_under_dispatch": under(spans, dev_evs, r"rmsnorm_rows", "serve_run", "(a)",
                                        True),
             "trace_controller": traced["trace_controller"],
             "device_capture": {k: v for k, v in traced["device_capture"].items()
                                if k != "window_log"},
             "windows": traced["device_capture"]["window_log"]}
        # a replayed tick: its kernels came from one cudaGraphLaunch
        ticks: dict = {}
        for e in dev_evs:
            tick = next((s for s in lineage(spans, e.parent) if s.name == "decode_tick"), None)
            if tick is not None:
                row = ticks.setdefault(tick.span, [0.0, False])
                row[0] += 1e3 * e.payload["dur_s"]
                row[1] |= "GraphLaunch" in (e.payload.get("args") or {}).get("launch", "")
        replayed = sorted(ms for ms, graph in ticks.values() if graph)
        busy = tick_profile["device_busy_ms"]
        if not replayed or busy is None:
            fail(f"8 (a): no replayed tick in any window ({len(ticks)} ticks), or no "
                 f"profile_step busy time ({busy})")
        tick_ms = replayed[len(replayed) // 2]
        a["replayed_tick"] = {"ticks": len(replayed), "median_bound_ms": tick_ms,
                              "profile_step_busy_ms": busy, "ratio": tick_ms / busy}
        if abs(tick_ms / busy - 1) > TRACE_TICK_TOL:
            fail(f"8 (a): a replayed tick's bound device time {tick_ms:.3f} ms against "
                 f"profile_step's {busy:.3f} ms busy")
        compact = load_stream(traced["trace_dir"])
        keys = {(e.t, e.kind, e.name, e.span) for e in compact.events}
        missing = [e for e in sess.events if (e.t, e.kind, e.name, e.span) not in keys]
        drops = {k: v for k, v in (sess.collector_stats or {}).get("dropped_by_track", {}).items()
                 if v}
        host_drops = {k: v for k, v in drops.items() if not k.startswith("device")}
        a["compact"] = {"session_events": len(sess.events), "stream_events": len(compact.events),
                        "missing": len(missing), "drops": drops,
                        "device_ring_dropped": drops.get("device", 0),
                        "segments": compact.meta["stream"]["segments"]}
        if missing or host_drops or compact.meta["stream"]["segments"] < 2:
            fail(f"8 (a): compact vs session: {a['compact']}")
        for target in (traced["trace_out"], traced["trace_dir"]):
            cli("report", target)
            cli("export", target, "--format", "chrome", "-o", str(work / "chrome.json"))
        cli("diff", traced["trace_out"], traced["trace_dir"])
        tree = json.loads(cli("report", traced["trace_out"], "--tree", "--json"))
        dev_rows = [r for r in tree if r["track"].startswith("device:")]
        a["tree_device_rows"] = [(r["depth"], r["name"][:40], r["count"]) for r in dev_rows[:12]]
        if not dev_rows or min(r["depth"] for r in dev_rows) < 2:
            fail(f"8 (a): report --tree device rows {a['tree_device_rows']}")
        text = scraped.get("text", "")
        series = {k: k in text for k in ("repro_serve_queue_depth", "repro_device_ms_bucket",
                                         "repro_device_capture_windows",
                                         "repro_device_capture_overhead_pct")}
        a["scrape"] = series
        if not all(series.values()):
            fail(f"8 (a): the /metrics scrape lacks {[k for k, v in series.items() if not v]}")
        print(f"8 (a) {ARCH} traced serve set, {smi}: {json.dumps(a)}", flush=True)
        rec["a"] = a

        # -- (b) smollm-360m trained, traced ----------------------------------
        targs = ["--arch", TRAIN_ARCH, "--steps", str(TRACE_TRAIN_STEPS),
                 "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                 "--ckpt-every", str(TRACE_CKPT_EVERY), "--fail-at", str(TRACE_FAIL_AT)]
        flags = ["--ckpt-dir", str(work / "ckpt"), "--trace-out", str(work / "train.json"),
                 "--trace-dir", str(work / "train_dir"), "--trace-rotate", "1000000",
                 "--torch-profile", str(work / "train_prof"),
                 "--torch-profile-period-s", str(TRACE_PERIOD_S)]
        with contextlib.redirect_stdout(io.StringIO()):
            tr = train_cli.main(targs + flags)
        shutil.rmtree(work / "ckpt", ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        for name in stray:
            stray[name] += tr["kernels"][name]
        # untraced: phase 5's runs of the same step (the per-step launches of
        # (e), the supervised run (j), checkpoints in flight as here)
        calls = tr["compiled"]["calls"]
        want = {k: v * calls for k, v in training["train"]["launches_per_step"].items()}
        tsess = Session.load(tr["trace_out"])
        tspans, tdev = device_tree(tsess)
        manifest = json.loads((work / "train_dir" / MANIFEST_NAME).read_text())
        ends = []
        for seg in manifest["segments"]:
            last = (work / "train_dir" / seg["name"]).read_text().splitlines()[-1]
            ends.append(tuple(json.loads(last)[k] for k in ("kind", "name")))
        n_ckpt = sum(s.name == "checkpoint" for s in tspans.values())
        warm = min(TRAIN_WARMUP + 1, len(tr["losses"]))
        step_ms = {"traced": 1e3 * statistics.median(
                       s.dur for s in tspans.values() if s.name == "step" and not s.truncated),
                   "untraced": training["supervised"]["median_step_span_ms"]}
        b = {"args": " ".join(targs + flags), "restarts": tr["restarts"],
             "median_step_span_ms": step_ms,
             "tokens_per_s_at_the_median_step": {k: TRAIN_BATCH * TRAIN_SEQ / (v / 1e3)
                                                 for k, v in step_ms.items()},
             "driver_tokens_per_s": tr["tokens_per_s"], "wall_s": tr["wall_s"],
             "launches_equal_untraced": tr["kernels"] == want,
             "segments": len(manifest["segments"]),
             "device_ring_dropped": (tsess.collector_stats or {}).get(
                 "dropped_by_track", {}).get("device", 0),
             "rotations_at_checkpoints": ends.count(("exit", "checkpoint")),
             "checkpoints": n_ckpt, "restart_spans": sum(s.name == "restart"
                                                         for s in tspans.values()),
             "bound": bound(tdev, "(b)"),
             **{f"{k}_under_step": under(tspans, tdev, pat, "step", "(b)")
                for k, pat in (("k1", r"flash_fwd_mma"), ("k1b", r"flash_bwd_(dq|dkdv)_wgmma"),
                               ("k3", r"rmsnorm_rows"), ("k3b", r"rmsnorm_bwd_fused"))},
             "losses_equal_compiled_run": tr["losses"][:warm] == compiled_rec["losses"][:warm],
             "steps_compared": warm,
             "trace_controller": tr.get("trace_controller"),
             "device_capture": {k: v for k, v in tr["device_capture"].items()
                                if k != "window_log"},
             "windows": tr["device_capture"]["window_log"]}
        print(f"8 (b) {TRAIN_ARCH} traced train, {smi}: {json.dumps(b)}", flush=True)
        if b["rotations_at_checkpoints"] != n_ckpt - 1 or tr["restarts"] != 1 \
                or not b["restart_spans"]:
            fail(f"8 (b): {b['rotations_at_checkpoints']} rotations at {n_ckpt} checkpoints "
                 f"(all but step 0's expected), {tr['restarts']} restarts, "
                 f"{b['restart_spans']} restart spans")
        if not b["launches_equal_untraced"]:
            fail(f"8 (b): traced launches {tr['kernels']} against {calls} untraced steps' {want}")
        if not b["losses_equal_compiled_run"]:
            fail(f"8 (b): losses {tr['losses'][:warm]} against phase 5 (e')'s "
                 f"{compiled_rec['losses'][:warm]}")
        rec["b"] = b

        # -- (c) the record path's cost; a window opened from another thread --
        cost = record_cost(events=20_000, rounds=3)
        x = torch.randn(SERVE["max_batch"], 896, device=dev, dtype=torch.bfloat16)
        scale = torch.randn(896, device=dev)
        k3.rmsnorm(x, scale)  # built and loaded before the window
        ready, done = threading.Event(), threading.Event()
        path = work / "thread" / "window.trace.json"
        path.parent.mkdir()

        def window() -> None:
            from torch.profiler import ProfilerActivity, profile
            p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            p.start()
            ready.set()
            done.wait(60)
            torch.cuda.synchronize()
            p.stop()
            p.export_chrome_trace(str(path))

        other = threading.Thread(target=window)
        other.start()
        ready.wait(60)
        liveprof.set_annotations(True)
        try:
            with uncounted(), liveprof.device_annotation(987654321):
                k3.rmsnorm(x, scale)
            torch.cuda.synchronize()
        finally:
            liveprof.set_annotations(False)
            done.set()
            other.join(60)
        try:
            win = load_window(str(path))
            seen = {"device_rows": len(win.slices), "span_ranges": len(win.ranges),
                    "bound_to_span": sum(s.span_hint == 987654321 for s in win.slices)}
        except NoDeviceRows as exc:
            seen = {"device_rows": 0, "launches": exc.launches}
        c = {"record_cost": cost, "window_from_another_thread": seen}
        print(f"8 (c) trace record path and a window from another thread, {smi}: "
              f"{json.dumps(c)}", flush=True)
        rec["c"] = c
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name in stray:
        records[name]["launches"] += stray[name]
    rec["launches"] = stray
    return rec


def _overheads(rows, baseline: str = "baseline") -> dict:
    """Each row's mean-time overhead against its own round's baseline row
    (labels ``x`` in the first round, ``x#2`` in the second, ...)."""
    base = {r.label.partition("#")[2]: r for r in rows if r.label.partition("#")[0] == baseline}
    return {r.label: r.overhead_vs(base[r.label.partition("#")[2]]) for r in rows}


def _count(items) -> dict:
    out: dict = {}
    for it in items:
        out[it] = out.get(it, 0) + 1
    return out


def profile_step(fn, reps: int = 3, top: int = 8) -> dict:
    """Wall time of ``fn`` (median of ``reps``, no profiler) beside the device
    time torch.profiler attributes to its kernels, the top kernels by it,
    the number of PyTorch ops the host dispatched and the number of kernels
    the card ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))

    def dev_us(e) -> float:
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # On some of the card's machines a session comes back without any of the
    # card's activity (PERF.md §6, PR 20): it says nothing of which kernels
    # ran, so it is opened again, up to PROFILER_SESSIONS times.
    for session in range(1, PROFILER_SESSIONS + 1):
        if session > 1:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the model's named scopes (core/scopes.py): each a record_function
        # range on the host, whose device time is that of the kernels
        # launched inside it; their ranges on the device are no kernels
        by_scope: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CPU and SCOPE_NAME.match(e.name):
                row = by_scope.setdefault(e.name, [0.0, 0])
                row[0] += e.device_time_total / 1e3
                row[1] += 1
        # kernel rows only: an aten op's row repeats the device time of its kernels
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.key not in by_scope), key=dev_us, reverse=True)
        if rows:
            break
    # PyTorch ops the host dispatched (outermost aten calls only)
    host_ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                   and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    wall_ms = sorted(walls)[len(walls) // 2]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms > 0 else None,
        "device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else None,
        "host_ops": host_ops,
        "device_kernels": sum(e.count for e in rows), "profiler_sessions": session,
        "top_kernels": [(e.key[:90], dev_us(e) / 1e3, e.count) for e in rows[:top]],
        "all_kernels": [(e.key, dev_us(e) / 1e3, e.count) for e in rows],
        "kernel_names": sorted({e.key for e in rows}),
        # device ms and ranges of each named scope, inclusive of the scopes
        # inside it (empty for a graph replay, which runs no Python)
        "by_scope": {k: (v[0], v[1]) for k, v in sorted(by_scope.items(),
                                                        key=lambda kv: -kv[1][0])},
    }


def norm_launches_per_forward(c) -> list[tuple[int, int, int]]:
    """The RMSNorm launches of one forward, read from the config, as (rows
    per token, D, launches): norm1 and norm2 of every layer with an FFN
    (norm1 alone without one), norm1_post and norm2_post with post-block
    norms, and the final norm at d_model; QK-norm's q_norm (n_heads rows a
    token) and k_norm (n_kv_heads rows a token) at head_dim in every
    attention layer; a Mamba layer's dt / B / C norms at dt_rank and
    d_state."""
    specs = [c.layer_spec(i) for i in range(c.n_layers)]
    per_layer = sum(1 + (sp.ffn != "none") for sp in specs) * (2 if c.post_block_norms else 1)
    out = [(1, c.d_model, per_layer + 1)]
    n_attn = sum(sp.mixer in ("ga", "swa") for sp in specs)
    if c.qk_norm and n_attn:
        out += [(c.n_heads, c.head_dim, n_attn), (c.n_kv_heads, c.head_dim, n_attn)]
    n_mamba = sum(sp.mixer == "mamba" for sp in specs)
    if n_mamba:
        from repro_torch.nn import mamba as mamba_mod

        _, N, _, R = mamba_mod._dims(c)
        out += [(1, R, n_mamba), (1, N, 2 * n_mamba)]
    return out


def norms_per_forward(c) -> int:
    """K3 launches of one forward of ``c`` (``norm_launches_per_forward``)."""
    return sum(n for *_, n in norm_launches_per_forward(c))


def add_norm_launches(into: dict, c, spec: dict, n_ticks: int) -> dict:
    """Adds a serving run's RMSNorm launches by (rows, D) to ``into``: each
    of ``norm_launches_per_forward(c)`` for each of the requests' prefills
    (prompt_len tokens) and each decode tick (max_batch tokens)."""
    for tokens, n in ((spec["prompt_len"], spec["requests"]), (spec["max_batch"], n_ticks)):
        for mult, d, per in norm_launches_per_forward(c):
            key = (tokens * mult, d)
            into[key] = into.get(key, 0) + per * n
    return into


def ptxas_instances(log_text: str) -> list[tuple[str, int, int]]:
    """(mangled name, registers, bytes of spill stores) of each kernel that
    ``nvcc -Xptxas=-v`` reported."""
    out = []
    for part in log_text.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out.append((part.split("'")[0], int(regs.group(1)) if regs else 0,
                    int(spill.group(1)) if spill else 0))
    return out


def seed_rwkv_noise(params, gen) -> None:
    """Overwrites the flat-init leaves of an RWKV6 model's stacked blocks
    (mixer and ffn) with RWKV_FLAT_NOISE's seeded draws, in place."""
    import torch

    for sub in params["blocks"]["pos0"].values():
        for name, law in RWKV_FLAT_NOISE.items():
            if name in sub:
                t = sub[name]
                t.copy_(torch.rand(t.shape, generator=gen, device=t.device) if law == "uniform"
                        else torch.randn(t.shape, generator=gen, device=t.device) * law)


def seed_mamba_noise(params, gen) -> None:
    """Adds MAMBA_FLAT_NOISE's seeded noise, in place, to the flat-init
    leaves of every Mamba mixer in ``params``."""
    import torch

    if "A_log" in params:
        for name, std in MAMBA_FLAT_NOISE.items():
            t = params[name]["scale"] if isinstance(params[name], dict) else params[name]
            t.add_((torch.randn(t.shape, generator=gen, device=t.device) * std).to(t.dtype))
        return
    for sub in params.values():
        if isinstance(sub, dict):
            seed_mamba_noise(sub, gen)


# phase 11: the mesh and the dry-run (ROADMAP M13, M11's hloanalysis counterpart)
MESH_K2_BATCH = 8  # (a) K2's stats mode at its 8 served shapes of PERF.md §6
MESH_SHARDS = (1, 2, 4)  # (b) sequence shards of one cache, combined as the mesh path does
MESH_TRAIN_ARGS = ("--arch", "smollm-360m", "--steps", "6", "--ckpt-every", "0")  # (d)
MESH_RESIZE_STEPS = (2, 4, 6)  # (d) on the 1 x 1 mesh, off it, back on it: steps run by then
# (e) dry-run cells, device-free, each in a child process started with the phase
MESH_DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", False), ("qwen2-0.5b", "decode_32k", False),
                     ("qwen2-0.5b", "long_500k", False), ("qwen2-0.5b", "train_4k", True),
                     ("deepseek-moe-16b", "decode_32k", False))
MESH_DRYRUN_TIMEOUT_S = 600


def start_dryrun_cells() -> dict:
    """Phase 11 (e)'s dry-run cells as child processes (device-free, on the
    host): {(arch, shape, multi-pod): (process, its stderr file)}.  Fails if
    torch's ``fake`` process group backend is missing."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    except ImportError as e:
        fail(f"11 (e): torch's fake process group backend is missing ({e}); the dry-run needs it")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p_ for p_ in (str(ROOT / "src"), os.environ.get("PYTHONPATH", "")) if p_)}
    cells = {}
    cell_dir = Path(tempfile.mkdtemp(prefix="repro_torch_dryrun_"))
    atexit.register(shutil.rmtree, cell_dir, True)
    for i, (arch, shape, multi) in enumerate(MESH_DRYRUN_CELLS):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape]
        with open(cell_dir / f"{i}.err", "wb") as err_f:  # DTensor's warnings: not into a pipe
            proc = subprocess.Popen(cmd + (["--multi-pod"] if multi else []),
                                    stdout=subprocess.PIPE, stderr=err_f, text=True, env=env,
                                    cwd=ROOT)
        atexit.register(proc.kill)  # also when a check fails the run
        cells[(arch, shape, multi)] = (proc, cell_dir / f"{i}.err")
    return cells


def mesh_phase(dev, smi: str, records: dict, kit: dict) -> dict:
    """Phase 11: ROADMAP M13 and M11's last module on the card (see the
    module docstring): (a) K2's stats mode against its plain version; (b)
    1, 2 and 4 sequence shards combined as the mesh path does, and
    ``decode_attention_seq_sharded`` on a 1 x 1 ``nccl`` mesh; (c) qwen2-0.5b
    and deepseek-moe-16b teacher-forced with ``decode_split_kv`` on that
    mesh; (d) ``launch.train --mesh 1x1``, ``Supervisor.resize`` and a
    restore onto the mesh; (e) dry-run cells in child processes, started
    first; (f) the captured-graph inventory.  ``kit`` holds main's time_ms,
    hold, bound_ms and peaks.  Adds K2's stats mode to ``records``."""
    import functools

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.core import graphanalysis, sdfg
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.constrain import mesh_scope
    from repro_torch.kernels import launch_counts, ops, ref, reset_launches
    from repro_torch.kernels import decode_attention as k2
    from repro_torch.launch.mesh import destroy_mesh, make_local_mesh
    from repro_torch.models import lm
    from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig
    from repro_torch.serving.compiled import Graphs
    from repro_torch.training.step import (TrainConfig, init_train_state, make_train_step,
                                           on_mesh, train_state_axes)
    from repro_torch.training.optim import leaves

    t0 = time.time()
    time_ms, hold, bound_ms, peaks = kit["time_ms"], kit["hold"], kit["bound_ms"], kit["peaks"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rec: dict = {}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p_ for p_ in (str(ROOT / "src"), os.environ.get("PYTHONPATH", "")) if p_)}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # -- (e): the dry-run cells run on the host while the card works (main
    # starts them with phase 10; alone, the phase starts them now) ---------------
    cells = kit.get("dryrun_cells") or start_dryrun_cells()

    # -- (a) K2's stats mode against its plain version ---------------------------
    k2_shapes = [("qwen2-0.5b", 14, 2, 64, 1024, None, None),
                 ("deepseek-moe-16b", 16, 16, 128, 1024, None, None),
                 ("jamba-1.5-large", 64, 8, 128, 1024, None, None),
                 ("musicgen-large", 32, 32, 64, 1024, None, None),
                 ("dbrx-132b", 48, 8, 128, 1024, None, None),
                 ("gemma3-4b global", 8, 4, 256, 2048, None, None),
                 ("gemma3-4b local", 8, 4, 256, 1024, 1024, None),
                 ("gemma2-27b", 32, 16, 128, 1024, None, 50.0)]
    rows, err_a = [], 0.0
    B = MESH_K2_BATCH

    def stats_vs_plain(name, got, want, dtype_name, live):
        """m, l relative to the plain l, and acc relative to its max |.|, on
        the rows with a live slot."""
        (a_, m_, l_), (a_r, m_r, l_r) = got, want
        sel = live[:, None, None]
        e = hold("decode_attention_stats", f"{name} m", torch.where(sel, m_, 0),
                 torch.where(sel, m_r, 0), dtype_name)
        e = max(e, hold("decode_attention_stats", f"{name} l / plain l",
                        torch.where(sel, l_ / l_r, 1), torch.ones_like(l_), dtype_name))
        scale = a_r.abs().amax().clamp(min=1e-30)
        return max(e, hold("decode_attention_stats", f"{name} acc / max |acc|",
                           torch.where(sel[..., None], a_, 0) / scale,
                           torch.where(sel[..., None], a_r, 0) / scale, dtype_name))

    for name, Hq, Hkv, D, S, window, softcap in k2_shapes:
        q, kc, vc = randn(B, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
        cur = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        kw = dict(window=window, softcap=softcap)
        got = k2.decode_attention(q, kc, vc, pos, cur, return_stats=True, **kw)
        want = ref.decode_attention_ref(q, kc, vc, pos, cur, return_stats=True, **kw)
        live = torch.ones(B, dtype=torch.bool, device=dev)
        err_a = max(err_a, stats_vs_plain(f"{name} {B}x{S}x{Hq}/{Hkv}x{D}", got, want, "bfloat16",
                                          live))
        stats_fn = lambda: k2.decode_attention(q, kc, vc, pos, cur, return_stats=True, **kw)  # noqa: E731
        plain_fn = lambda: ref.decode_attention_ref(q, kc, vc, pos, cur, return_stats=True, **kw)  # noqa: E731
        out_fn = lambda: k2.decode_attention(q, kc, vc, pos, cur, **kw)  # noqa: E731
        n_bytes = 2 * B * S * Hkv * D * 2 + q.numel() * 2 + 4 * B * (S + 1) + 4 * B * Hq * (D + 2)
        b_, by_ = bound_ms(n_bytes, 4 * D * B * Hq * (min(S, window) if window else S),
                           peaks["bfloat16"])
        row = {"arch": name, "shape": f"{B}x{S}x{Hq}/{Hkv}x{D}" + (
            f" window {window}" if window else "") + (f" softcap {softcap}" if softcap else ""),
            "ms": time_ms(stats_fn), "decode_ms": time_ms(out_fn), "plain_ms": time_ms(plain_fn),
            "bound_ms": b_, "bound_by": by_}
        rows.append(row)
        print(f"11 (a) decode_attention stats {name} {row['shape']} bf16, {smi}: stats "
              f"{row['ms']:.4f} ms, the normal call {row['decode_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {b_:.5f} ({by_})", flush=True)
    # f32, and a row with no live slot: (0, -1e30, 0) exactly, and 0 out of a combine
    q, kc, vc = randn(3, 14, 64, dtype=torch.float32), randn(3, 512, 2, 64, dtype=torch.float32), \
        randn(3, 512, 2, 64, dtype=torch.float32)
    pos = torch.arange(512, dtype=torch.int32, device=dev).expand(3, 512).contiguous()
    pos[1] = -1  # row 1: no live slot
    cur = torch.tensor([511, 511, 300], dtype=torch.int32, device=dev)
    got = k2.decode_attention(q, kc, vc, pos, cur, return_stats=True)
    want = ref.decode_attention_ref(q, kc, vc, pos, cur, return_stats=True)
    live = torch.tensor([True, False, True], device=dev)
    err_a = max(err_a, stats_vs_plain("3x512x14/2x64 f32, row 1 without a live slot", got, want,
                                      "float32", live))
    dead = (float(got[0][1].abs().max()), float(got[1][1].max()), float(got[2][1].abs().max()))
    combined = ops.combine_partials(*(t[None] for t in got), lambda t: t.amax(0, keepdim=True),
                                    lambda t: t.sum(0), q.dtype)
    print(f"11 (a) the row without a live slot: |acc| {dead[0]}, m {dead[1]}, l {dead[2]}; "
          f"combined out {float(combined[1].abs().max())}", flush=True)
    if not (dead[0] == 0 and dead[2] == 0 and dead[1] <= -1e29):
        fail(f"11 (a): a row without a live slot gave stats {dead}, (0, -1e30, 0) expected")
    if not (bool(torch.isfinite(combined).all()) and float(combined[1].abs().max()) == 0.0):
        fail("11 (a): the combine of a row without a live slot is not exactly 0")
    rec["a"] = {"rows": rows, "max_abs_err": err_a, "dead_row": dead}

    # (d)'s two training children start now, beside (b), (c) and (f) (no
    # timing of this phase runs after (a)); (d) reads them
    def train_child(extra: tuple) -> tuple:
        log_f = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                                 *MESH_TRAIN_ARGS, *extra], stdout=subprocess.PIPE,
                                stderr=log_f, text=True, env=env, cwd=ROOT)
        atexit.register(proc.kill)
        return proc, log_f, extra

    children = [train_child(()), train_child(("--mesh", "1x1"))]

    def train_record(child: tuple) -> dict:
        proc, log_f, extra = child
        try:
            out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            fail(f"11 (d): launch.train {' '.join(extra)} took over {CLI_TIMEOUT_S} s")
        if proc.returncode != 0:
            log_f.seek(0)
            print(out[-3000:], log_f.read()[-5000:], file=sys.stderr, flush=True)
            fail(f"11 (d): launch.train {' '.join(extra)} exited {proc.returncode}")
        return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])

    # -- (b) shards combined as the mesh path combines them ------------------------
    mesh = make_local_mesh("cuda")  # an nccl group of this process alone
    rec["b"] = []
    for name, Hq, Hkv, D, S, window, softcap in k2_shapes[:2]:
        for dtype, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
            q, kc, vc = randn(B, Hq, D, dtype=dtype), randn(B, S, Hkv, D, dtype=dtype), \
                randn(B, S, Hkv, D, dtype=dtype)
            pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
            pos[3, S // 2:] = -1  # row 3: its second half empty, so whole shards hold no live slot
            pos[5] = -1  # row 5: no live slot at all
            cur = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
            one = k2.decode_attention(q, kc, vc, pos, cur)
            for n in MESH_SHARDS:
                w_ = S // n
                parts = [k2.decode_attention(q, kc[:, i * w_:(i + 1) * w_].contiguous(),
                                             vc[:, i * w_:(i + 1) * w_].contiguous(),
                                             pos[:, i * w_:(i + 1) * w_].contiguous(), cur,
                                             return_stats=True) for i in range(n)]
                out = ops.combine_partials(*(torch.stack(t) for t in zip(*parts)),
                                           lambda t: t.amax(0, keepdim=True),
                                           lambda t: t.sum(0), dtype)
                e = hold("decode_attention_stats", f"{name} {dname} {n} shards combined vs one "
                         "K2 call", out, one, dname)
                rec["b"].append({"arch": name, "dtype": dname, "shards": n, "max_abs_err": e,
                                 "dead_row_max": float(out[5].abs().max())})
                if float(out[5].abs().max()) != 0.0 or not bool(torch.isfinite(out).all()):
                    fail(f"11 (b): {n} shards: the row without a live slot is not exactly 0")
            with mesh_scope(mesh):
                got = ops.decode_attention_seq_sharded(q, kc, vc, pos, cur, seq_axes=("model",))
            e = hold("decode_attention_stats", f"{name} {dname} decode_attention_seq_sharded on "
                     "a 1 x 1 nccl mesh vs one K2 call", got, one, dname)
            rec["b"].append({"arch": name, "dtype": dname, "mesh": "1x1", "max_abs_err": e})
    del q, kc, vc, pos, cur, one, parts, out, got

    # -- (c) teacher-forced decode with decode_split_kv on the mesh ------------------
    def forced(params, cfg, prompt, outs, steps=8):
        """Logits of the prefill and ``steps`` decode steps fed ``outs`` (or,
        where ``outs`` is empty, the argmax of each step, appended to it)."""
        lg, caches = lm.prefill(params, cfg, torch.tensor([prompt], device=dev), max_seq=1024)
        out = [lg]
        for i in range(steps):
            if len(outs) <= i:
                outs.append(int(lg.argmax(-1)))
            lg, caches = lm.decode_step(params, cfg, torch.tensor([outs[i]], device=dev),
                                        torch.tensor([len(prompt) + i], dtype=torch.int32,
                                                     device=dev), caches)
            out.append(lg)
        return torch.stack(out)

    rec["c"] = {}
    stats_launches = 0
    for arch, layers in ((ARCH, None), (MOE_ARCH, MOE_GATE_LAYERS)):
        c32 = dataclasses.replace(get_config(arch), param_dtype="float32",
                                  activation_dtype="float32")
        if layers:
            c32 = dataclasses.replace(c32, n_layers=layers)
        p32 = lm.init_params(c32, SEED, dev)
        prompt = torch.randint(0, c32.vocab_size, (256,), generator=torch.Generator().manual_seed(
            SEED)).tolist()
        with torch.no_grad():
            outs: list = []
            base = forced(p32, c32, prompt, outs)
            split = dataclasses.replace(c32, decode_split_kv=True, decode_seq_axes=("model",))
            reset_launches()
            with mesh_scope(mesh):
                got = forced(p32, split, prompt, outs)
            counts = launch_counts()
        n_attn = sum(c32.layer_spec(i).mixer in ("ga", "swa") for i in range(c32.n_layers))
        diff = float((got - base).abs().max())
        row = {"layers": c32.n_layers, "max_abs_diff": diff, "kernels": counts,
               "argmax_equal": int((got.argmax(-1) == base.argmax(-1)).sum()), "steps": 9}
        rec["c"][arch] = row
        print(f"11 (c) {arch} f32, full width, {c32.n_layers} layers, prefill + 8 decode steps "
              f"with decode_split_kv on a 1 x 1 mesh vs without: {json.dumps(row)} (tol "
              f"{F32_LOGIT_TOL})", flush=True)
        if diff > F32_LOGIT_TOL or not bool(torch.isfinite(got).all()):
            fail(f"11 (c) {arch}: the split-KV decode's logits disagree with the plain decode's")
        if counts["decode_attention_stats"] != 8 * n_attn or counts["decode_attention"] != 0:
            fail(f"11 (c) {arch}: K2's stats mode launched {counts['decode_attention_stats']} "
                 f"times ({8 * n_attn} expected), K2's normal call {counts['decode_attention']}")
        stats_launches += counts["decode_attention_stats"]
        del p32, base, got
        gc.collect()
        torch.cuda.empty_cache()

    # -- (d) training on the 1 x 1 mesh ------------------------------------------------
    plain_run, mesh_run = (train_record(c) for c in children)
    rec["d"] = {"plain": plain_run, "mesh_1x1": mesh_run}
    print(f"11 (d) launch.train {' '.join(MESH_TRAIN_ARGS)}, {smi}: losses without a mesh "
          f"{plain_run['losses']}, with --mesh 1x1 {mesh_run['losses']}; kernels "
          f"{json.dumps(mesh_run['kernels'])}, compiled {mesh_run['compiled']}", flush=True)
    if mesh_run["losses"] != plain_run["losses"] or mesh_run["mesh"] != "1x1":
        fail("11 (d): --mesh 1x1 losses differ from the run without a mesh")
    if any(mesh_run["kernels"][k] == 0 for k in ("flash_attention", "flash_attention_bwd",
                                                  "rmsnorm", "rmsnorm_bwd")):
        fail(f"11 (d): a training kernel ran no time on the mesh: {mesh_run['kernels']}")
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 128, 8, seed=SEED))

    def batch_fn(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}

    step = make_train_step(cfg, tcfg)
    work = Path(tempfile.mkdtemp(prefix="repro_torch_mesh_"))
    atexit.register(shutil.rmtree, work, True)
    whole = Supervisor(SupervisorConfig(ckpt_dir=str(work / "whole"), ckpt_every=0,
                                        max_steps=MESH_RESIZE_STEPS[-1]),
                       step, batch_fn, init_train_state(cfg, tcfg, SEED, dev))
    want = [m["loss"] for m in whole.run()["metrics"]]
    del whole
    move = functools.partial(shd.reshard, tree_axes=train_state_axes(cfg), rules=shd.PARAM_RULES)
    state, shardings = move(init_train_state(cfg, tcfg, SEED, dev), mesh=mesh)
    sup = Supervisor(SupervisorConfig(ckpt_dir=str(work / "moved"), ckpt_every=0,
                                      max_steps=MESH_RESIZE_STEPS[0]),
                     on_mesh(step, mesh), batch_fn, state, state_shardings=shardings)
    reset_launches()
    got = [m["loss"] for m in sup.run()["metrics"]]
    for target, steps in ((None, MESH_RESIZE_STEPS[1]), (mesh, MESH_RESIZE_STEPS[2])):
        sup.resize(target, lambda tree, new_mesh: move(tree, mesh=new_mesh))
        sup.cfg.max_steps = steps
        got += [m["loss"] for m in sup.run()["metrics"]]
    resize_counts = launch_counts()
    on_card = isinstance(sup.state["params"]["embed"]["table"], DTensor)
    print(f"11 (d) Supervisor.resize 1x1 -> none -> 1x1 after steps {MESH_RESIZE_STEPS[:2]}, "
          f"{smi}: losses {got}, the uninterrupted run's {want}; kernels "
          f"{json.dumps(resize_counts)}", flush=True)
    if got != want or not on_card:
        fail("11 (d): the resized run's losses differ from the uninterrupted run's")
    ckpt = work / "ckpt"
    save(str(ckpt), 1, sup.state)
    back = restore(str(ckpt), 1, sup.state,
                   shardings=shd.tree_shardings(train_state_axes(cfg), sup.state,
                                                shd.PARAM_RULES, mesh))
    equal = all(torch.equal(a.full_tensor(), b.full_tensor())
                for a, b in zip(leaves(back), leaves(sup.state)))
    print(f"11 (d) a checkpoint restored with shardings onto the 1 x 1 mesh: "
          f"{len(leaves(back))} leaves, all DTensors "
          f"{all(isinstance(t, DTensor) for t in leaves(back))}, equal {equal}", flush=True)
    if not equal:
        fail("11 (d): the checkpoint restored onto the mesh differs from the saved state")
    rec["d"].update({"resize_losses": got, "uninterrupted_losses": want,
                     "resize_kernels": resize_counts, "restore_equal": equal})
    del sup, state, back
    gc.collect()
    torch.cuda.empty_cache()

    # -- (f) the captured-graph inventory ---------------------------------------------
    cfg = get_config(ARCH)
    params = lm.init_params(cfg, SEED, dev)
    graphs = Graphs(dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    prefill_fn = lambda t: lm.prefill(params, cfg, t, max_seq=1024)  # noqa: E731
    rec["f"] = {}
    with torch.no_grad():
        eager = sdfg.extract(prefill_fn, tokens)
        pre = graphs.step(prefill_fn)
        pre(tokens)
        _, caches = pre(tokens)
        caches = _map(torch.clone, caches)
        scratch = _map(torch.clone, caches)
        tok = torch.tensor([7], device=dev)
        at = torch.tensor([512], dtype=torch.int32, device=dev)
        eager_tick = sdfg.extract(lambda t, p_: lm.decode_step(params, cfg, t, p_, scratch)[0],
                                  tok, at)
        state = {"caches": scratch}
        tick = graphs.step(lambda t, p_: lm.decode_step(params, cfg, t, p_, state["caches"])[0])
        tick(tok, at)
        state["caches"] = caches
        tick(tok, at)
        for name, step_, graph in (("prefill", pre, eager), ("decode_tick", tick, eager_tick)):
            inv = graphanalysis.captured_kernels(step_, graph)
            rec["f"][name] = inv
            print(f"11 (f) {ARCH} compiled {name}: {inv['n_kernels']} kernels a replay "
                  f"(the last of {inv['replays_seen']} in one profiler session), the "
                  f"port's {json.dumps(inv['port_kernels'])}, the eager SDFG's kernel nodes "
                  f"{json.dumps(inv['sdfg_kernels'])}, equal {inv['equal']}; top "
                  f"{json.dumps(inv['kernels'][:6])}", flush=True)
            if not inv["equal"] or not inv["port_kernels"]:
                fail(f"11 (f): {name}: a replay's port kernels differ from the eager SDFG's")
    del params, graphs, pre, tick, caches, scratch, state
    destroy_mesh()
    gc.collect()
    torch.cuda.empty_cache()

    # -- (e) the dry-run cells ------------------------------------------------------
    rec["e"] = []
    for (arch, shape, multi), (proc, err_path) in cells.items():
        try:
            out, _ = proc.communicate(timeout=MESH_DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p_, _ in cells.values():
                p_.kill()
            fail(f"11 (e): the dry-run cell {arch} {shape} took over {MESH_DRYRUN_TIMEOUT_S} s")
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if not lines:
            print(err_path.read_text(errors="replace")[-3000:], file=sys.stderr, flush=True)
            fail(f"11 (e): the dry-run cell {arch} {shape} printed no record")
        r = json.loads(lines[-1])
        rec["e"].append(r)
        keep = ("arch", "shape", "mesh", "status", "reason", "hlo_flops_per_dev",
                "hlo_bytes_per_dev", "collective_bytes_per_dev", "collective_breakdown",
                "bottleneck", "roofline_fraction", "replicated_ops", "seconds")
        print(f"11 (e) dryrun {json.dumps({k: r.get(k) for k in keep})} (priced from hw/specs.py's "
              "H100 figures, not measured)", flush=True)
        if r["status"] not in ("ok", "skip") or (r["status"] == "skip") != (shape == "long_500k"):
            fail(f"11 (e): dry-run cell {arch} {shape}: {r.get('status')} {r.get('error', '')}")
    records["decode_attention_stats"] = {
        "name": "decode_attention_stats", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:91", "launches": stats_launches,
        "max_abs_err": err_a, "library_ms": None,
        **{k: rows[1][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "shape": rows[1]["shape"], "served_shapes": rows}
    rec["seconds"] = time.time() - t0
    print(f"11 mesh and dry-run phase: {rec['seconds']:.1f} s", flush=True)
    return rec


def tune_phase(dev, smi: str, records: dict, kit: dict) -> dict:
    """Phase 10: ROADMAP M12's ``tune/`` on the card (see the module
    docstring): (a) the spaces with ptxas' report of K4's row-tile
    instances and MT 9 / 10 against the plain version; (b) a real sweep of
    every space, each kernel point held against its plain version; (c) K2's
    and K4's served shapes re-timed, default beside winner; (d) the tuned
    deepseek-moe-16b serve set through the fleet, a fresh process warm from
    it, an f32 gate under the winners and a capture refused under another
    tag; (e) ``launch.train --tune cached --fleet``.  ``kit`` holds main's
    time_ms, hold, bound_ms, peaks, logit_gate and phase 4b's config,
    prompts and tokens.  Adds the serving runs' launches to ``records``."""
    import torch

    from repro_torch.dispatch.profiles import decode_config
    from repro_torch.fleet import FleetClient
    from repro_torch.hw.specs import default_chip
    from repro_torch.kernels import decode_attention as k2
    from repro_torch.kernels import ops, plan, ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import lm
    from repro_torch.serving.compiled import Graphs
    from repro_torch.trace.session import Session, git_sha
    from repro_torch.tune import default_spaces
    from repro_torch.tune.explore import card_ptxas
    from repro_torch.tune.space import NOT_SWEPT, space_report

    t0 = time.time()
    time_ms, hold, bound_ms, peaks = kit["time_ms"], kit["hold"], kit["bound_ms"], kit["peaks"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    rec: dict = {}
    ops.clear_tuned_configs()

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # -- (a) the spaces -----------------------------------------------------
    ptxas = card_ptxas()
    print(f"10 (a) gmm_mma ptxas by row tiles (the most registers and spilled bytes over the "
          f"three epilogues): {json.dumps({k: ptxas[k] for k in sorted(ptxas)})}", flush=True)
    rows = space_report(ptxas=ptxas)
    for r in rows:
        print(f"10 (a) space {r['space']}: {r['feasible']} feasible of "
              f"{len(r['points'])} points, {r['pruned']} pruned, {r['sweep']} swept, default "
              f"{r['default']}; {json.dumps(r['points'])}", flush=True)
    print(f"10 (a) not swept: {json.dumps(NOT_SWEPT)}", flush=True)
    spaces = default_spaces()
    if any(not s.feasible(s.defaults, ptxas=ptxas) for s in spaces.values()):
        fail("10 (a): a space's shipped default is infeasible on the card")
    # the split pass's shared memory, as the space prices it and as the card has it
    dec = spaces["decode_attention/kernel"]
    chunk = plan.split_plan(dec.workload["B"], dec.workload["Hkv"], dec.workload["S"], n_sm)[1]
    info = k2.instance_info(torch.bfloat16, dec.workload["D"], chunk)
    rec["a"] = {"ptxas": ptxas, "spaces": rows, "decode_smem_card": info,
                "decode_smem_space": dec.plan(dec.defaults).smem_bytes}
    print(f"10 (a) decode_split_mma<128> at chunk {chunk}: the card {json.dumps(info)}, the "
          f"space {rec['a']['decode_smem_space']} bytes", flush=True)
    # the new instances, MT 9 and 10, against the plain version (no epilogue and silu)
    for C_ in (129, 144, 160):
        x, w = randn(16, C_, 1536), randn(16, 1536, 1024)
        for epi in (None, "silu"):
            with ops.tuned_scope({"moe_gmm": {"kernel": {"max_row_tiles": 10}}}):
                got = ops.gmm(x, w, epilogue=epi, impl="kernel")
            mt = plan.tile_plan(16, C_, 1024, 10).row_tiles
            hold("moe_gmm", f"bf16 (16,{C_},1536)@(16,1536,1024) epilogue={epi} "
                 f"[gmm_mma<{mt}>, max_row_tiles 10]", got, ref.gmm_ref(x, w, epilogue=epi),
                 "bfloat16")
    del x, w, got

    # -- (b) a real sweep of every space: launch.serve --tune sweep ------------
    # (d)'s first run, in this process: deepseek-moe-16b's serve set at full
    # width and depth, compiled, --dispatch profiled, its sweep into a fleet
    out_dir = Path(tempfile.mkdtemp(prefix="repro_torch_tune_"))
    atexit.register(shutil.rmtree, out_dir, True)  # also when a check fails the run
    fleet = out_dir / "fleet"
    fleet.mkdir()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p_ for p_ in (str(ROOT / "src"), os.environ.get("PYTHONPATH", "")) if p_)}
    argv = ["--arch", MOE_ARCH, "--seed", str(SEED), "--dispatch", "profiled",
            "--fleet", str(fleet),
            *(f"--{k.replace('_', '-')}={MOE_SERVE[k]}" for k in
              ("requests", "prompt_len", "max_new", "max_batch", "max_seq"))]

    def tokens(results: dict) -> list:
        return [results[k] for k in sorted(results)]

    def serve_here(extra: list) -> tuple[dict, list]:
        try:
            r, results = serve_cli.run(argv + extra)
        finally:
            ops.clear_tuned_configs()
            gc.collect()
            torch.cuda.empty_cache()
        return r, tokens(results)

    session = out_dir / "sweep_session.json"
    swept, swept_toks = serve_here(["--tune", "sweep", "--trace-out", str(session)])
    events = [e.payload for e in Session.load(str(session)).events if e.kind == "tune"]
    pulled = FleetClient(str(fleet)).pull(git_sha(), default_chip().name)["store"]
    summary = swept["tune"]
    for p in events:
        if p.get("winner"):
            continue
        if p.get("pruned"):
            print(f"10 (b) {p['op']}/{p['backend']} {p['config']}: pruned (predicted "
                  f"{p['predicted_s'] * 1e3:.4f} ms, bound {p['bound_s'] * 1e3:.4f})", flush=True)
            continue
        e = pulled.entry(p["op"], p["backend"], p["sig"], p["config"]) if pulled else None
        print(f"10 (b) {p['op']}/{p['backend']} {p['config']}: "
              + ("FAILED " + json.dumps(p) if p.get("failed") or e is None else
                 f"min {e.min_s * 1e3:.4f} ms, mean {e.mean_s * 1e3:.4f} ms over {e.count}"
                 + (f", rel_err {p['rel_err']:.3e}" if "rel_err" in p else "")), flush=True)
    table = {op: {tier: decode_config(c) for tier, c in impls.items()}
             for op, impls in summary["configs"].items()}
    for key, win in sorted(summary["winners"].items()):
        print(f"10 (b) {key} winner, {smi}: {win['config']} {win['best_s'] * 1e3:.4f} ms against "
              f"the default {spaces[key].default_config} "
              f"{win.get('default_s', float('nan')) * 1e3:.4f} ms "
              f"({win.get('speedup', float('nan')):.3f}x)", flush=True)
    rec["b"] = {"summary": summary, "events": events}
    if summary.get("failed", 0) or summary["sweep_points"] == 0 or len(summary["winners"]) != 5:
        fail(f"10 (b): {summary.get('failed')} failed points, {summary['sweep_points']} "
             f"measured, winners {sorted(summary['winners'])}")

    # -- (c) the served shapes of K2 and K4 under the installed winners --------
    k2_shapes = [("qwen2-0.5b", 14, 2, 64, 1024, None, None),
                 ("deepseek-moe-16b", 16, 16, 128, 1024, None, None),
                 ("jamba-1.5-large", 64, 8, 128, 1024, None, None),
                 ("musicgen-large", 32, 32, 64, 1024, None, None),
                 ("dbrx-132b", 48, 8, 128, 1024, None, None),
                 ("gemma3-4b global", 8, 4, 256, 2048, None, None),
                 ("gemma3-4b local", 8, 4, 256, 1024, 1024, None),
                 ("gemma2-27b", 32, 16, 128, 1024, None, 50.0)]
    waves = table.get("decode_attention", {}).get("kernel", {}).get("waves", plan.WAVES)
    k2_rows = []
    for name, Hq, Hkv, D, S, window, softcap in k2_shapes:
        B = 8
        q, kc, vc = randn(B, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
        cur = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        kw = dict(window=window, softcap=softcap)
        fn = lambda: ops.decode_attention(q, kc, vc, pos, cur, impl="kernel", **kw)  # noqa: E731
        row = {"shape": f"{B}x{S}x{Hq}/{Hkv}x{D}" + (f" window {window}" if window else "")
               + (f" softcap {softcap}" if softcap else ""), "arch": name}
        b_, by_ = bound_ms(2 * B * S * Hkv * D * 2 + 2 * q.numel() * 2 + 4 * B * (S + 1),
                           4 * D * B * Hq * (min(S, window) if window else S), peaks["bfloat16"])
        row.update(bound_ms=b_, bound_by=by_)
        default_out = fn()
        for label, w_ in (("default", plan.WAVES), ("winner", waves)):
            with ops.tuned_scope({"decode_attention": {"kernel": {"waves": w_}}}):
                row[f"{label}_ms"] = time_ms(fn)
                row[f"{label}_plan"] = {"waves": w_, "n_split_chunk":
                                        plan.split_plan(B, Hkv, S, n_sm, w_)}
                if label == "winner":
                    hold("decode_attention", f"{row['shape']} waves {w_} vs waves "
                         f"{plan.WAVES}", fn(), default_out, "bfloat16")
        k2_rows.append(row)
        print(f"10 (c) decode_attention {name} {row['shape']} bf16, {smi}: default "
              f"{row['default_ms']:.4f} ms {row['default_plan']}, winner {row['winner_ms']:.4f} ms "
              f"{row['winner_plan']}, bound {b_:.5f} ({by_})", flush=True)
    del q, kc, vc, pos, cur, default_out
    k4_shapes = [("deepseek-moe-16b prefill", 64, 64, 2048, 1408),
                 ("deepseek-moe-16b decode", 64, 8, 2048, 1408),
                 ("jamba-1.5-large prefill", 16, 80, 8192, 24576),
                 ("jamba-1.5-large decode", 16, 8, 8192, 24576),
                 ("dbrx-132b prefill", 16, 160, 6144, 10752),
                 ("dbrx-132b decode", 16, 8, 6144, 10752)]
    cap = table.get("moe_gmm", {}).get("kernel", {}).get("max_row_tiles", plan.MAX_ROW_TILES)
    k4_rows = []
    for name, E, C_, D_, F_ in k4_shapes:
        x, w = randn(E, C_, D_), randn(E, D_, F_)
        fn = lambda: ops.gmm(x, w, impl="kernel")  # noqa: E731
        b_, by_ = bound_ms(2 * (x.numel() + w.numel() + E * C_ * F_), 2 * E * C_ * D_ * F_,
                           peaks["bfloat16"])
        row = {"shape": f"({E},{C_},{D_})@({E},{D_},{F_})", "arch": name, "bound_ms": b_,
               "bound_by": by_}
        default_out = fn()
        for label, c_ in (("default", plan.MAX_ROW_TILES), ("winner", cap)):
            with ops.tuned_scope({"moe_gmm": {"kernel": {"max_row_tiles": c_}}}):
                row[f"{label}_ms"] = time_ms(fn)
                tp = plan.tile_plan(E, C_, F_, c_)
                row[f"{label}_plan"] = {"max_row_tiles": c_, "row_tiles": tp.row_tiles,
                                        "row_blocks": tp.row_blocks}
                if label == "winner":
                    got = fn()
                    row["winner_equals_default_bitwise"] = bool(torch.equal(got, default_out))
                    hold("moe_gmm", f"{row['shape']} max_row_tiles {c_} vs "
                         f"{plan.MAX_ROW_TILES}", got, default_out, "bfloat16")
        k4_rows.append(row)
        print(f"10 (c) moe_gmm {name} {row['shape']} bf16, {smi}: default {row['default_ms']:.4f} "
              f"ms {row['default_plan']}, winner {row['winner_ms']:.4f} ms {row['winner_plan']}, "
              f"bound {b_:.4f} ({by_}), bitwise {row['winner_equals_default_bitwise']}",
              flush=True)
        del x, w, default_out
    rec["c"] = {"decode_attention": k2_rows, "moe_gmm": k4_rows}
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) a fresh process warm from the fleet, a third run, the f32 gate ------
    snippet = ("import json, sys\nfrom repro_torch.launch import serve\n"
               "rec, res = serve.run(sys.argv[2:])\n"
               "open(sys.argv[1], 'w').write(json.dumps({'rec': rec, 'tokens': "
               "[res[k] for k in sorted(res)]}))\n")
    proc = subprocess.run([sys.executable, "-c", snippet, str(out_dir / "cached.json"), *argv,
                           "--tune", "cached"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"10 (d): the fresh launch.serve --tune cached exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    child = json.loads((out_dir / "cached.json").read_text())
    cached, cached_toks = child["rec"], child["tokens"]
    again, again_toks = serve_here(["--tune", "cached"])
    # control: the dispatched engine on the kernel tier without tuning, whose
    # tokens against the untuned 4b run tell the winners' share of a change
    # from the dispatch path's
    control, control_toks = serve_here(["--tune", "off", "--dispatch", "static"])
    # the f32 gate at MOE_GATE_LAYERS layers under the winners
    c32 = dataclasses.replace(kit["mcfg"], n_layers=MOE_GATE_LAYERS, param_dtype="float32",
                              activation_dtype="float32")
    p32 = lm.init_params(c32, SEED, device=dev)
    with ops.tuned_scope(table):
        gate = kit["logit_gate"](c32, p32, kit["mprompts"][0], kit["mouts"][0],
                                 MOE_SERVE["max_seq"])
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    # a step captured under the winners refuses a call under the defaults
    x, w = randn(16, 160, 256), randn(16, 256, 512)
    step = Graphs(dev).step(lambda a, b: ops.gmm(a, b, impl="kernel"))
    with ops.tuned_scope(table):
        step(x, w)
        step(x, w)  # the capture, then its replay
    try:
        step(x, w)
        refused = False
    except RuntimeError as exc:
        refused = "tuned configs" in str(exc)
    # (e) the training driver, warm from the same fleet
    targs = ["--arch", TRAIN_ARCH, "--steps", "4", "--ckpt-every", "0", "--dispatch",
             "profiled", "--tune", "cached", "--fleet", str(fleet)]
    tproc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *targs],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=CLI_TIMEOUT_S)
    if tproc.returncode != 0:
        fail(f"10 (e): launch.train {' '.join(targs)} exited {tproc.returncode}: "
             f"{tproc.stderr[-3000:]}")
    train_rec = json.loads(tproc.stdout.strip().splitlines()[-1])
    shutil.rmtree(out_dir, ignore_errors=True)
    for run in (swept, cached, again, control):
        for name in records:
            records[name]["launches"] += run["kernels"].get(name, 0)

    def share(a: list, b: list) -> str:
        return f"{sum(x == y for x, y in zip(a, b))} of {len(b)}"

    d = {"sweep": {k: swept[k] for k in ("tune", "fleet", "tokens_per_s", "dispatch")},
         "cached_fresh_process": {k: cached[k] for k in ("tune", "fleet", "tokens_per_s",
                                                          "dispatch")},
         "cached_again": {k: again[k] for k in ("tune", "tokens_per_s", "dispatch")},
         "requests_equal_cached_runs": share(cached_toks, again_toks),
         "requests_equal_sweep_run_vs_cached": share(swept_toks, cached_toks),
         "requests_equal_untuned_4b_vs_cached": share(kit["mouts"], cached_toks),
         "requests_equal_untuned_4b_vs_static_kernel_untuned": share(kit["mouts"],
                                                                     control_toks),
         "f32_gate": gate, "capture_refused_under_other_tag": refused}
    print(f"10 (d) {MOE_ARCH} tuned serve set through the fleet, {smi}: {json.dumps(d)}",
          flush=True)
    rec["d"] = d
    ct, st_ = cached["tune"], swept["tune"]
    if st_["sweep_points"] == 0 or st_.get("failed", 0) or not swept["fleet"]["push"].get(
            "pushed_samples"):
        fail(f"10 (d): the sweep run measured {st_['sweep_points']} points, failed "
             f"{st_.get('failed')}, pushed {swept['fleet'].get('push')}")
    if (ct["sweep_points"] != 0 or ct["configs"] != st_["configs"]
            or cached["fleet"]["pull"]["match"] != "exact"
            or cached["dispatch"]["explore_dispatches"] != 0):
        fail(f"10 (d): the fresh process warm from the fleet: tune {ct}, pull "
             f"{cached['fleet']['pull']}, explored {cached['dispatch']['explore_dispatches']}; "
             f"expected 0 points, the sweep run's configs {st_['configs']}, an exact pull, "
             "no exploration")
    if cached_toks != again_toks:
        fail(f"10 (d): the two warm tuned runs gave different tokens "
             f"({d['requests_equal_cached_runs']} requests equal)")
    if not refused:
        fail("10 (d): a step captured under the winners replayed under the defaults")
    tr = {k: train_rec[k] for k in ("tune", "fleet", "losses", "step_ms", "kernels")}
    print(f"10 (e) repro_torch.launch.train {' '.join(targs)}, {smi}: {json.dumps(tr)}",
          flush=True)
    rec["e"] = tr
    if (train_rec["tune"]["applied"] < 1 or train_rec["tune"]["sweep_points"] != 0
            or not train_rec["fleet"]["push"].get("pushed_samples")
            or train_rec["fleet"]["pull"]["match"] != "exact"):
        fail(f"10 (e): launch.train's tune {train_rec['tune']}, fleet {train_rec['fleet']}")
    for name in records:
        records[name]["launches"] += train_rec["kernels"].get(name, 0)
    records["moe_gmm"]["tuned"] = k4_rows
    records["decode_attention"]["tuned"] = k2_rows
    rec["seconds"] = time.time() - t0
    print(f"10 tune phase: {rec['seconds']:.1f} s", flush=True)
    return rec


def serving_tier_phase(dev, smi: str, records: dict) -> dict:
    """Phase 9: ROADMAP M12's serving tier on the card (see the module
    docstring): the fleet daemon, the router over two real replicas, a
    warm-started third replica, a SIGKILL and the stitched trace.  Adds the
    replicas' launches to ``records`` and returns the phase's record."""
    import signal
    import threading
    import urllib.request

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dispatch.profiles import parse_profile_key
    from repro_torch.fleet import FleetClient
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.router import loadgen
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.trace.stitch import HOPS, chain_report, hop_rows, hop_summary
    from repro_torch.trace.stream import load_any
    from repro_torch.utils.ready import read_ready_info, wait_for_ready_file

    t0 = time.time()
    work = Path(tempfile.mkdtemp(prefix="repro_torch_tier_"))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p_ for p_ in (str(ROOT / "src"), os.environ.get("PYTHONPATH", "")) if p_)}
    procs: dict[str, subprocess.Popen] = {}
    rec: dict = {}
    launches = {name: 0 for name in ("flash_attention", "decode_attention", "rmsnorm")}
    max_new = TIER_MAX_NEW

    def spawn(name: str, argv: list) -> subprocess.Popen:
        log_f = open(work / f"{name}.log", "wb")
        procs[name] = subprocess.Popen([sys.executable, "-m", *argv], stdout=log_f,
                                       stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        log_f.close()
        return procs[name]

    def stop(name: str, sig=signal.SIGTERM, timeout: float = 120.0) -> int:
        proc = procs.pop(name)
        if proc.poll() is None:
            proc.send_signal(sig)
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        return proc.returncode

    def logs() -> str:
        tails = []
        for f in sorted(list(work.glob("*.log")) + list(work.glob("work/*.log"))):
            tails.append(f"--- {f.name}:\n" + f.read_text(errors="replace")[-3000:])
        return "\n".join(tails)

    def check(ok: bool, msg: str) -> None:
        if not ok:
            print(logs(), file=sys.stderr, flush=True)
            fail(f"9 {msg}")

    def get(url: str) -> dict:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return json.loads(resp.read())

    def post(url: str, spec: dict) -> dict:
        req = urllib.request.Request(f"{url}/v1/generate", data=json.dumps(spec).encode(),
                                     method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    client: dict[str, float] = {}  # trace id -> the latency this client measured (ms)

    def post_timed(url: str, spec: dict) -> dict:
        t = time.perf_counter()
        reply = post(url, spec)
        client[reply["trace"]] = (time.perf_counter() - t) * 1e3
        return reply

    def load(url: str, specs: list) -> dict:
        report = loadgen.run(url, specs, concurrency=TIER_CONC, timeout_s=300,
                             keep_tokens=True)
        client.update({t: ms for t, ms in zip(report["traces"], report["client_ms"]) if t})
        return report

    def plain_routes(h: dict) -> dict:
        """Per op: (plain routes, of them settled rather than explored,
        plain share of the op's routes)."""
        d = h["dispatch"]
        return {op: (n.get("plain", 0),
                     n.get("plain", 0) - d["explore_by_op"].get(op, {}).get("plain", 0),
                     n.get("plain", 0) / sum(n.values())) for op, n in d["by_op"].items()}

    def check_plain(name: str, h: dict, where: str) -> dict:
        routes = plain_routes(h)
        check(all(settled == 0 for _, settled, _ in routes.values()),
              f"{where}: replica {name} settled calls on the plain tier on the card "
              f"(op: plain routes, settled, share): {routes}")
        return routes

    def rate(report: dict) -> dict:
        return {"requests": report["completed"],
                "tokens_per_s": report["completed"] * max_new / report["wall_s"],
                "p50_ms": report["latency_ms"]["p50"], "p99_ms": report["latency_ms"]["p99"],
                "wall_s": report["wall_s"]}

    alone_specs = loadgen.build_specs(TIER_ALONE, list(TIER_LENGTHS), max_new, seed=SEED)
    try:
        # the reference: an in-process compiled Engine on the card, each
        # prompt served alone, the replicas' arch, seed, max_batch and max_seq
        cfg = get_config(ARCH)
        params = lm.init_params(cfg, SEED, device=dev)
        eng = Engine(cfg, params, ServeConfig(max_batch=TIER_BATCH, max_seq=TIER_SEQ, seed=SEED))
        alone_ref = []
        for spec in alone_specs:
            rid = eng.submit(spec["prompt"], max_new=max_new)
            alone_ref.append(eng.run_to_completion()[rid])
        torch.cuda.synchronize()
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()

        # (a) the fleet daemon
        fleet_ready = work / "fleet.ready"
        spawn("fleet", ["repro_torch.fleet", "serve", "--root", str(work / "fleet"),
                        "--port", "0", "--ready-file", str(fleet_ready)])
        wait_for_ready_file(str(fleet_ready), 60, proc=procs["fleet"])
        fleet_url = read_ready_info(str(fleet_ready))["url"]
        check(get(f"{fleet_url}/healthz")["ok"], "(a): the fleet daemon is not healthy")

        # (b) the router over two real replicas
        t_b = time.time()
        router_ready, trace_dir = work / "router.ready", work / "trace"
        engine_flags = ["--arch", ARCH, "--max-batch", str(TIER_BATCH), "--max-seq", str(TIER_SEQ),
                        "--dispatch", "profiled", "--fleet", fleet_url, "--seed", str(SEED)]
        spawn("router", ["repro_torch.router", "--replicas", "2", "--port", "0",
                         "--ready-file", str(router_ready), "--workdir", str(work / "work"),
                         "--trace-dir", str(trace_dir), "--startup-timeout-s", "300",
                         "--forward-timeout-s", "300", "--request-timeout-s", "120",
                         *engine_flags])
        try:
            wait_for_ready_file(str(router_ready), 300, proc=procs["router"])
        except (RuntimeError, TimeoutError) as exc:
            check(False, f"(b): the router did not come up: {exc}")
        url = read_ready_info(str(router_ready))["url"]
        rec["b_startup_s"] = time.time() - t_b

        def replicas() -> dict:
            return get(f"{url}/healthz")["replicas"]

        # (c) alone: one request at a time, each reply the in-process engine's
        alone = [post_timed(url, spec) for spec in alone_specs]
        equal = [a["tokens"] == r for a, r in zip(alone, alone_ref)]
        rec["c"] = {"requests": len(alone), "equal": sum(equal),
                    "routed_to": [a["routed_to"] for a in alone],
                    "prompt_lens": [len(sp["prompt"]) for sp in alone_specs]}
        print(f"9 (c) {ARCH} alone through the router vs an in-process compiled Engine, "
              f"{smi}: {json.dumps(rec['c'])}", flush=True)
        check(all(equal), f"(c): {len(equal) - sum(equal)} of {len(equal)} replies differ from "
                          "the in-process engine's")

        # (d) loaded: TIER_LOAD requests over the same prompts at TIER_CONC
        load_specs = [alone_specs[i % len(alone_specs)] for i in range(TIER_LOAD)]
        rep = load(url, load_specs)
        same = sum(t == alone_ref[i % len(alone_ref)] for i, t in enumerate(rep["tokens"]))
        rec["d"] = {k: rep[k] for k in ("submitted", "completed", "outcomes", "duplicates",
                                         "lost", "by_replica", "latency_ms", "hop_ms", "wall_s")}
        rec["d"]["equal_to_alone"] = same / len(load_specs)
        print(f"9 (d) {TIER_LOAD} requests at concurrency {TIER_CONC} through the router, "
              f"{smi}: {json.dumps(rec['d'])}", flush=True)
        check(rep["completed"] == rep["submitted"] == TIER_LOAD and rep["duplicates"] == 0
              and rep["lost"] == 0, f"(d): {rep['outcomes']}, {rep['duplicates']} duplicates")
        check(all(t is not None and len(t) == max_new for t in rep["tokens"]),
              f"(d): a reply without {max_new} tokens")
        # for (i), on warm replicas: the same load through the router and on
        # the replica the router sent most to, driven directly, in turns
        # (direct, router, router, direct)
        served = get(f"{url}/healthz")["router"]["replicas"]
        busiest = replicas()[max(served, key=lambda n: served[n]["completed"])]["url"]
        turns: dict = {"direct": [], "router": []}
        for way in ("direct", "router", "router", "direct"):
            r_ = load(busiest if way == "direct" else url, load_specs)
            check(r_["completed"] == TIER_LOAD and r_["duplicates"] == 0,
                  f"(i): a {way} run: {r_['outcomes']}")
            turns[way].append(r_)

        # (e) kernels and stamps: each replica's /healthz, and the fleet
        health = {}
        deadline = time.time() + 60
        while True:  # the replicas push when idle, at most every 2 s
            status = replicas()
            health = {n: get(f"{r['url']}/healthz") for n, r in status.items()}
            if all(h.get("fleet_pushed_samples", 0) > 0 for h in health.values()):
                break
            check(time.time() < deadline, f"(e): the replicas pushed no profiles: "
                                          f"{ {n: h.get('fleet_pushed_samples') for n, h in health.items()} }")
            time.sleep(0.5)
        rec["e"] = {}
        for n, h in health.items():
            k = h["kernels"]
            row = {"chip": h["chip"], "git_sha": h["git_sha"], "device": h["device"],
                   "tiers": h["tiers"], "kernels": {x: k[x] for x in launches},
                   "by_op": h["dispatch"]["by_op"], "by_source": h["dispatch"]["by_source"],
                   "explore_by_op": h["dispatch"]["explore_by_op"],
                   "plain_routes_settled_share": plain_routes(h),
                   "explore_events": h["explore_events"],
                   "fleet_pushed_samples": h["fleet_pushed_samples"],
                   "fleet_pull": h["fleet"]["pull"]["match"]}
            rec["e"][n] = row
            print(f"9 (e) replica {n}, {smi}: {json.dumps(row)}", flush=True)
            check(all(k[x] > 0 for x in launches), f"(e): replica {n} launched {k}")
            check(h["tiers"] == ["kernel", "plain"] and h["device"].startswith("cuda")
                  and "static-fallback" not in h["dispatch"]["by_source"],
                  f"(e): replica {n} routes {h['tiers']} on {h['device']}: "
                  f"{h['dispatch']['by_source']}")
            check(h["chip"] == "h100_sxm" and status[n]["chip"] == "h100_sxm",
                  f"(e): replica {n} stamps {h['chip']}")
            check_plain(n, h, "(e)")
        sha = next(iter(health.values()))["git_sha"]
        buckets = FleetClient(fleet_url).ls()
        pulled = FleetClient(fleet_url).pull(sha, "h100_sxm")
        entries = pulled["store"]._entries if pulled["store"] else {}
        chips = {e.chip for e in entries.values()}
        mins: dict = {}  # op -> token signature -> tier -> [samples, minimum ms]
        for key, e in sorted(entries.items()):
            op, tier, sig, _ = parse_profile_key(key)
            mins.setdefault(op, {}).setdefault(sig, {})[tier] = [e.count, e.min_s * 1e3]
        rec["e_fleet"] = {"buckets": [(b["git_sha"], b["chip"], b["samples"], b["pushes"])
                                      for b in buckets], "match": pulled["match"],
                          "entries": len(entries), "entry_chips": sorted(chips),
                          "samples_min_ms": mins}
        print(f"9 (e) fleet: {json.dumps(rec['e_fleet'])}", flush=True)
        check(pulled["match"] == "exact" and chips == {"h100_sxm"}
              and [b["chip"] for b in buckets] == ["h100_sxm"],
              f"(e): the fleet holds {rec['e_fleet']}")

        # (f) a third replica, started with --fleet, warm-starts
        warm_ready = work / "warm.ready"
        t_f = time.time()
        spawn("warm", ["repro_torch.router.replica", "--name", "w", "--port", "0",
                       "--ready-file", str(warm_ready), *engine_flags])
        try:
            wait_for_ready_file(str(warm_ready), 300, proc=procs["warm"])
        except (RuntimeError, TimeoutError) as exc:
            check(False, f"(f): the warm replica did not come up: {exc}")
        winfo = read_ready_info(str(warm_ready))
        warm_startup = time.time() - t_f
        warm_tokens = [post(winfo["url"], spec)["tokens"] for spec in alone_specs]
        wh = get(f"{winfo['url']}/healthz")
        for x in launches:
            launches[x] += wh["kernels"][x]
        rec["f"] = {"pull": winfo["fleet"]["pull"], "startup_s": warm_startup,
                    "explore_events": wh["explore_events"],
                    "cold_explore_events": {n: h["explore_events"] for n, h in health.items()},
                    "by_source": wh["dispatch"]["by_source"], "chip": wh["chip"],
                    "plain_routes_settled_share": plain_routes(wh),
                    "equal_to_alone": sum(t == r for t, r in zip(warm_tokens, alone_ref))}
        print(f"9 (f) warm-started replica, {smi}: {json.dumps(rec['f'])}", flush=True)
        stop("warm")
        check(winfo["fleet"]["pull"]["match"] == "exact" and wh["chip"] == "h100_sxm"
              and wh["explore_events"] < min(h["explore_events"] for h in health.values()),
              f"(f): the warm replica explored {wh['explore_events']} times, the cold ones "
              f"{rec['f']['cold_explore_events']}")
        check_plain("w", wh, "(f)")

        # (g) SIGKILL a replica during a second load: the one the router
        # has sent the most requests (its live costs may route all to one)
        served = get(f"{url}/healthz")["router"]["replicas"]
        vname = max(served, key=lambda n: served[n]["completed"])
        victim = replicas()[vname]
        before = served[vname]["completed"]
        kill_specs = [alone_specs[(3 * i) % len(alone_specs)] for i in range(TIER_KILL_LOAD)]
        result: dict = {}
        drive = threading.Thread(target=lambda: result.update(load(url, kill_specs)),
                                 daemon=True)
        last = get(f"{victim['url']}/healthz")
        drive.start()
        deadline = time.time() + 120
        while get(f"{url}/healthz")["router"]["replicas"][vname]["completed"] < before + 2:
            check(time.time() < deadline and drive.is_alive(), f"(g): {vname} served nothing")
            last = get(f"{victim['url']}/healthz")
            time.sleep(0.05)
        os.kill(victim["pid"], signal.SIGKILL)
        t_kill = time.time()
        for x in launches:  # the victim's counts as last read
            launches[x] += last["kernels"][x]
        restart_s = None
        while time.time() - t_kill < 300:
            rv = replicas()[vname]
            if rv["state"] == "up" and rv["restarts"] >= 1 and rv["pid"] != victim["pid"]:
                restart_s = time.time() - t_kill
                break
            time.sleep(0.1)
        drive.join(timeout=300)
        check(restart_s is not None, f"(g): {vname} was not restarted: {replicas()[vname]}")
        check(not drive.is_alive() and result.get("completed") == TIER_KILL_LOAD
              and result["duplicates"] == 0 and result["lost"] == 0
              and all(t is not None and len(t) == max_new for t in result["tokens"]),
              f"(g): {result.get('outcomes')}, {result.get('duplicates')} duplicates")
        rec["g"] = {"outcomes": result["outcomes"], "completed": result["completed"],
                    "duplicates": result["duplicates"], "lost": result["lost"],
                    "victim": vname, "restart_s": restart_s,
                    "restarted_chip": replicas()[vname]["chip"]}
        print(f"9 (g) SIGKILL of {vname} during {TIER_KILL_LOAD} requests, {smi}: "
              f"{json.dumps(rec['g'])}", flush=True)
        check(rec["g"]["restarted_chip"] == "h100_sxm", f"(g): the restarted {vname}'s stamp")
        rec["g"]["plain_routes_settled_share"] = {}
        for n, r in replicas().items():
            h = get(f"{r['url']}/healthz")
            for x in launches:
                launches[x] += h["kernels"][x]
            rec["g"]["plain_routes_settled_share"][n] = check_plain(n, h, "(g)")
        print(f"9 (g) plain routes after the restart (op: routes, settled, share): "
              f"{json.dumps(rec['g']['plain_routes_settled_share'])}", flush=True)
        routed = get(f"{url}/healthz")["requests"]
        rc = stop("router")
        check(rc == 0, f"(h): the router exited {rc}")

        # (h) stitch and hops over the front door's discovered inputs
        stitched = work / "stitched.json"
        out = subprocess.run([sys.executable, "-m", "repro_torch.trace", "stitch", str(trace_dir),
                              "-o", str(stitched), "--json"], capture_output=True, text=True,
                             env=env, cwd=ROOT, timeout=300)
        check(out.returncode == 0, f"(h): trace stitch exited {out.returncode}: {out.stderr}")
        hops_out = subprocess.run([sys.executable, "-m", "repro_torch.trace", "hops",
                                   str(stitched), "--json"], capture_output=True, text=True,
                                  env=env, cwd=ROOT, timeout=300)
        check(hops_out.returncode == 0, f"(h): trace hops exited {hops_out.returncode}")
        hops_doc = json.loads(hops_out.stdout)
        sess = load_any(str(stitched))
        spans = {sp.span: sp for sp in sess.spans() if sp.span}
        kids: dict = {}
        for sp in spans.values():
            kids.setdefault(sp.parent, []).append(sp)
        roots = {sp.span for sp in spans.values() if sp.name == "router_run"}
        ranges = [tuple(i["span_ids"]) for i in sess.meta["stitch"]["inputs"]]
        # the processes share the host's clock, so the skew the stitcher
        # estimated for an input (from the handshakes' asymmetric delays)
        # is its error: spans of two inputs nest to within it
        skew_err = [abs(i["skew_s"]) for i in sess.meta["stitch"]["inputs"]]

        def origin(sid: int) -> int:  # the stitched input a span id came from
            return next(i for i, (lo, hi) in enumerate(ranges) if lo <= sid <= hi)

        ticks: dict = {}
        for sp in spans.values():
            if sp.name == "decode_tick":
                ticks.setdefault(origin(sp.span), []).append(sp)
        # each front-door request's hops, from its outcome event
        hops_of = {e.parent: e.payload for e in sess.events
                   if e.kind == "route" and e.name == "outcome" and isinstance(e.payload, dict)
                   and isinstance(e.payload.get("hops"), dict)}
        trees = 0
        broken: dict = {}  # why a request is not a tree -> count
        # the hops against measurements they are not made of: the hops' sum
        # against the front-door span's duration in the trace and against
        # the client's latency (the front door's interval lies inside the
        # client's), the service hop against the replica's engine interval
        # in the trace (all ms)
        timing: list[dict] = []
        for sp in spans.values():
            if sp.name != "request" or sp.parent not in roots:
                continue  # front door requests only (the run root is their parent)
            served = None  # the attempt whose replica served it: rpc, request, prefill
            for route in (c for c in kids.get(sp.span, []) if c.name == "route"):
                for rpc in (c for c in kids.get(route.span, []) if c.name == "rpc"):
                    if isinstance(rpc.payload, dict) and rpc.payload.get("torn"):
                        continue  # an attempt on the killed replica
                    for ereq in (c for c in kids.get(rpc.span, []) if c.name == "request"):
                        pre = [c for c in kids.get(ereq.span, []) if c.name == "prefill"]
                        if pre:
                            served = (rpc, ereq, pre[0])
            why = None
            if served is None:
                why = "no attempt with an engine request and prefill"
            elif sp.span not in hops_of:
                why = "no hops"
            else:
                rpc, ereq, pre = served
                eps = skew_err[origin(rpc.span)]
                # the replica's batched decode ticks while the request held its slot
                n_ticks = sum(1 for t in ticks.get(origin(ereq.span), [])
                              if t.t0 >= pre.t1 and t.t1 <= ereq.t1)
                if not (sp.t0 - eps <= rpc.t0 and rpc.t1 <= sp.t1 + eps):
                    why = "replica rpc outside the front door's span"
                elif not (rpc.t0 <= ereq.t0 <= pre.t0 and ereq.t1 <= rpc.t1):
                    why = "engine request outside the rpc"
                elif n_ticks != max_new - 1:
                    why = f"{n_ticks} decode ticks"
            if why is not None:
                broken[why] = broken.get(why, 0) + 1
                continue
            trees += 1
            hops = hops_of[sp.span]["hops"]
            timing.append({"sum_ms": sum(float(hops[h]) for h in HOPS),
                           "span_ms": (sp.t1 - sp.t0) * 1e3,
                           "client_ms": client.get((sp.payload or {}).get("trace")),
                           "service_ms": float(hops["service"]),
                           "engine_ms": (ereq.t1 - pre.t0) * 1e3})
        chain = chain_report(sess)
        rows = hop_rows(sess)
        summary = hop_summary(rows)
        off_span = [t for t in timing if abs(t["sum_ms"] - t["span_ms"]) > TIER_HOP_TOL * t["span_ms"]]
        no_client = [t for t in timing if t["client_ms"] is None]
        over_client = [t for t in timing if t["client_ms"] is not None
                       and t["sum_ms"] > t["client_ms"] + TIER_CLOCK_SLACK_MS]
        # the replica stamps a request's service from before its prefill to
        # after its engine exit: the engine's interval lies inside it
        off_engine = [t for t in timing
                      if t["engine_ms"] > t["service_ms"] + TIER_CLOCK_SLACK_MS]

        def spread(xs: list) -> dict:
            xs = sorted(xs)
            return {"min": xs[0], "p50": xs[len(xs) // 2], "max": xs[-1]} if xs else {}

        rec["h"] = {"routed": routed, "rooted_trees": trees, "broken": broken, "chain": {
            k: chain[k] for k in ("completed", "chained", "orphaned_remote")},
            "inputs": [(i["origin"], i["events"], i["skew_s"], i["torn_spans"])
                       for i in sess.meta["stitch"]["inputs"]],
            "hop_rows": len(rows), "hops_cli_requests": hops_doc["summary"]["requests"],
            "hops_cli_within_5pct_of_latency": hops_doc["summary"]["within_5pct"],
            "sum_within_tol_of_span": len(timing) - len(off_span),
            "sum_within_client": len(timing) - len(no_client) - len(over_client),
            "engine_within_service": len(timing) - len(off_engine),
            "span_minus_sum_ms": spread([t["span_ms"] - t["sum_ms"] for t in timing]),
            "client_minus_sum_ms": spread([t["client_ms"] - t["sum_ms"] for t in timing
                                           if t["client_ms"] is not None]),
            "client_sum_within_tol": sum(
                1 for t in timing if t["client_ms"] is not None
                and abs(t["client_ms"] - t["sum_ms"]) <= TIER_HOP_TOL * t["client_ms"]),
            "service_minus_engine_ms": spread([t["service_ms"] - t["engine_ms"]
                                               for t in timing])}
        print(f"9 (h) stitch and hops: {json.dumps(rec['h'])}", flush=True)
        check(trees == routed and not broken
              and chain["chained"] == chain["completed"] == routed,
              f"(h): {trees} rooted trees, broken {broken}, chain {chain}, {routed} routed")
        check(len(rows) == routed and hops_doc["summary"]["requests"] == routed,
              f"(h): {len(rows)} hop rows, the hops CLI {hops_doc['summary']['requests']}, "
              f"{routed} routed")
        # the hops add up to the front door's latency by construction (they
        # are differences of its and the replica's durations): the hops CLI
        # must give every request's row so
        check(hops_doc["summary"]["within_5pct"] == routed,
              f"(h): the hops CLI finds {hops_doc['summary']['within_5pct']} of {routed} "
              "requests' hops within 5 % of their latency")
        check(not no_client and not over_client,
              f"(h): {len(no_client)} requests without a client latency, {len(over_client)} "
              f"whose hops add up to more than the client's latency: {over_client[:3]}")
        check(not off_engine, f"(h): {len(off_engine)} of {len(timing)} service hops shorter "
                              f"than the engine's interval: {off_engine[:3]}")

        # (i) what to print
        hop_means = {h: summary["hops"][h]["mean"] for h in HOPS}
        warm_hops = {h: statistics.mean(r_["hop_ms"][h]["mean"] for r_ in turns["router"])
                     for h in HOPS}
        rec["i"] = {"router_2_replicas": [rate(r_) for r_ in turns["router"]],
                    "one_replica_direct": [rate(r_) for r_ in turns["direct"]],
                    "router_by_replica": [r_["by_replica"] for r_ in turns["router"]],
                    "frontdoor_hop_ms": warm_hops["frontdoor_queue"],
                    "route_ms_mean": statistics.mean(r_["route_ms"]["mean"]
                                                     for r_ in turns["router"]),
                    "hop_means_ms_warm_router": warm_hops, "hop_means_ms_stitched": hop_means,
                    "restart_s": restart_s, "seconds": time.time() - t0}
        print(f"9 (i) {ARCH} {TIER_LOAD} requests at concurrency {TIER_CONC}, warm, router with 2 "
              f"replicas vs one replica directly (direct, router, router, direct), {smi}: "
              f"{json.dumps({k: rec['i'][k] for k in ('router_2_replicas', 'one_replica_direct', 'router_by_replica')})}",
              flush=True)
        print(f"9 (i) front door's own hop {warm_hops['frontdoor_queue']:.4f} ms (route "
              f"{rec['i']['route_ms_mean']:.4f} ms), hop means (ms) of the warm router runs "
              f"{json.dumps(warm_hops)}, of every stitched request {json.dumps(hop_means)}, "
              f"restart {restart_s:.2f} s, phase {rec['i']['seconds']:.1f} s, {smi}", flush=True)
    finally:
        for name in list(procs):
            stop(name, timeout=30)
        shutil.rmtree(work, ignore_errors=True)
    for name, n in launches.items():
        if name in records and name in LAUNCHES:
            records[name]["launches"] += n
    rec["launches"] = launches
    return rec


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def same_bits(a, b) -> bool:
    """``a`` and ``b`` hold the same bits (the same dtype, shape and words)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        words = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(words), b.view(words))
    return torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
