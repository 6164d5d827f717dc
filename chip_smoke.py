#!/usr/bin/env python3
"""Chip check of the PyTorch/H100 port: build, hold, serve, report.

    python3 chip_smoke.py [--record PATH]

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin`` or on PATH); runs
from the repository root (it imports ``src/repro_torch``).  Phases, any
failure of which exits non-zero:

1. print the card (``nvidia-smi`` name and power limit); TF32 off;
2. build the CUDA kernels (one ``nvcc`` per source, in parallel), printing
   the build time and ptxas' report (per instance for K3, K5 and both K1b
   sources, none of whose instances may spill, nor K5's take more than 128
   registers, nor the wgmma K1b's differ from the entry count its
   setmaxnreg exchange assumes; the wgmma K1b's shared memory, blocks an
   SM and any wgmma serialisation ptxas reports; K1 and K2 per instance,
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
   rings) and at gemma2-27b's shapes with softcap 50; every K3, K4, K5 and K6
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
5. free it, and train smollm-360m (the training path: ``lm.loss_fn``,
   ``training.step``, AdamW) through K1 with its log-sum-exp, the flash
   backward K1b, K3 and its backward K3b: (a) K1's lse against
   ``ref.flash_attention_lse_ref`` and (b) K1b against
   ``ref.flash_attention_bwd_ref`` and against torch autograd through
   ``ref.mha_ref`` (relative to each gradient's max |.|, BWD_TOL), at the
   CPU tests' edge cases (q_offset, window + softcap, ragged Sq / Sk, G =
   8, head dims 8 to 128; at D 64, the wgmma instance's, also window +
   softcap + q_offset under GQA and Sq, Sk off its 64-row tiles at G = 8)
   in f32 and bf16 and at the training shape (4, 2048, 15/5, 64) in bf16,
   each K1b run twice with bitwise-equal results;
   (c) K3b against ``ref.rmsnorm_bwd_ref`` at (8192, 960) and every served
   (rows, D), twice, bitwise equal, and on two streams at once, bitwise
   equal to one call at a time; (d) one f32 train step at full width
   and depth (batch 2 x 1024), kernels vs plain: the loss within
   F32_LOSS_RTOL and every gradient leaf within F32_GRAD_TOL of its max
   |.|; (e) TRAIN_STEPS bf16 steps at batch 4 x 2048 on ``SyntheticLM``,
   the loss falling by more than 0.1, with the exact launches of every step
   (2 x 32 K1, 32 K1b, 2 x 64 + 1 K3, 65 K3b: per-period remat runs each
   period's forward again), step ms, tokens/s and peak memory (the
   schedule launch.train gives 20 steps: peak lr 3e-4 after 10 warmup
   steps); (f) one
   step under torch.profiler, which must show K1's ``flash_fwd_mma``, K1b's
   wgmma pair (``flash_attention.bwd_instances``) and neither mma.sync K1b
   kernel, K3's ``rmsnorm_rows`` and K3b's ``rmsnorm_bwd_fused`` and neither
   kernel of the previous K3b, and the device ms a step of each of those
   kernels; (e') the same 20 steps through ``training/compiled.py``'s
   ``CompiledTrainStep`` (the step captured as a CUDA graph) from a fresh
   state of the same seed: one capture, TRAIN_STEPS - 1 replays (the
   capturing call's own replay counted, as serving counts them), each
   step's exact launches, the loss falling by more than 0.1, and the loss
   sequence beside (e)'s with their max |difference|; and one f32 step at
   2 x 1024 as a replay against an eager step from equal states, the loss
   and every param and moment leaf within GRAPH_TRAIN_F32_TOL of its max
   |.|; (f') one replayed step under torch.profiler beside (f)'s eager one
   (wall / busy / idle, host ops, kernels, median step, tokens/s, peak
   memory): at most COMPILED_TICK_HOST_OPS host ops; (j) the compiled bf16
   step under ``runtime/supervisor.py``'s ``Supervisor`` for 20 steps, a
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
   ``F.rms_norm``; (h) K2, K4, K5 and K6 refuse an input that requires grad
   (ROADMAP R11), and K1b one at head dim 256 (K1b-D256) before any
   launch; (i) ``python -m repro_torch.launch.train --arch
   smollm-360m --steps 20 --ckpt-dir <tmp> --fail-at 7`` in a child
   process: one restart, one capture, its loss falling;
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
7. print the script's run time, the per-kernel JSON line (launches from the
   six compiled serving runs; K1b's and K3b's from phase 5 (e)), the card
   line, and last the ``{"ok": true, "device": ...}`` line.

``--record PATH`` also writes the full record (every check, the serving
run, the profiles) there as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
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
SFU_EXP_PER_CLOCK = 16  # ex2 results per clock per SM on Hopper (sm_90)
# A replayed decode tick dispatches two copies into its static buffers and
# one graph launch; an eager one dispatches 1852-4098 ops on these models.
COMPILED_TICK_HOST_OPS = 20
# Graph replays run the same kernels on the same inputs as eager calls, in
# the same order, so their f32 logits should agree exactly.
GRAPH_F32_TOL = 1e-5
GRAPH_LAUNCHES = 256  # K3 launches captured in one graph to time a launch inside it
PROFILER_SESSIONS = 3  # sessions a profile may open before one sees the card's kernels
# serving launches no backward kernel
NO_BACKWARD = {"flash_attention_bwd": 0, "rmsnorm_bwd": 0}
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
SUP_CKPT_EVERY, SUP_FAIL_AT = 8, 11
CLI_FAIL_AT = 7  # phase 5 (i): --fail-at of the driver's run (restores step 0)
CLI_TIMEOUT_S = 300  # phase 5 (i): python -m repro_torch.launch.train on the card
K3B_CALLS = 10  # phase 5 (g): K3b calls under torch.profiler, one kernel each
K3B_OVERLAP_ROUNDS = 8  # phase 5 (c): K3b calls on each of two streams at once
# a named scope of the model (core/scopes.py), as torch.profiler names its range
SCOPE_NAME = re.compile(r"^(embed|final_norm|(head|tail)\d+|pos\d+_[a-z]+_[a-z_]+|mixer_[a-z]+"
                        r"|ffn_[a-z_]+)$")
# phase 6: the paper's measurement layer on the card
TABLE1_MICRO = (100, 1000)  # (a) warm-up and measured calls a microbench arm (hyperfine)
TABLE1_ROUNDS = 2  # (a) every arm timed twice, in turn: drift between arms shows
TABLE1_MODEL = (10, 60)  # (a) the same for a model arm
TABLE1_MODEL_TOKENS = (8, 128)  # (a) the model arms' loss forward: full-width, full-depth qwen2
TAPE_STEP_RUNS = {"prefill": (10, 100), "decode_tick": (20, 300)}  # (c) a compiled step's arms
TAPE_TRAIN_REPLAYS = 6  # (d) replays of the compiled train step with its tape
# (g) R13: prompt lengths in the order served, each twice in a row (so each
# is captured), the longest first so that the eager calls' and captures'
# largest activations come before the cap is reached; and the cap
R13_LENGTHS = (512, 64, 384, 128, 256, 192)
R13_CAP = 4
SHARE_MAX = 1.05  # (f) no model-FLOP or roofline share of a measured step may read over this


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

    # -- 2. build ---------------------------------------------------------
    t0 = time.time()
    paths = _build.build()
    k1._entry()
    k1._bwd_entry()
    k1._sm90_entry()
    k2._entry()
    k4._entry()
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
    # the wgmma K1b: its shared memory (all dynamic) and blocks an SM, and
    # any wgmma serialisation ptxas reports
    sm90_cfg = k1.sm90_config(k1._sm90_entry()[0], 0)
    print(f"  flash_attention_bwd_sm90 configuration: {json.dumps(sm90_cfg)}", flush=True)
    # setmaxnreg's exchange balances only if ptxas gave every instance the
    # entry count the source assumes (another would leave it waiting)
    sm90_regs = {fn_name: (regs, sm90_cfg["entry_regs_" + ("dq" if "dq_wgmma" in fn_name
                                                          else "dkdv")])
                 for fn_name, regs, _ in ptxas["flash_attention_bwd_sm90"]}
    if len(sm90_regs) != 4 or any(got != want for got, want in sm90_regs.values()):
        fail(f"flash_attention_bwd_sm90: ptxas registers (got, entry count) {sm90_regs}: "
             "four instances, each at its entry count, expected")
    for line in paths["flash_attention_bwd_sm90"].with_suffix(".log").read_text().splitlines():
        if "Performance Loss" in line:
            print(f"    ptxas: {line.strip()[:200]}", flush=True)
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
        torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU clock cycles
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
        for shape in (*served_norms, (3, 5, 96), (4, 100), "view"):
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
    times3 = {}
    for shape in served_norms:
        x = randn(*shape, dtype=torch.bfloat16)
        s = randn(shape[-1]) * 0.1
        times3[shape] = timed(
            lambda: k3.rmsnorm(x, s), lambda: ref.rmsnorm_ref(x, s),
            lambda w=(1.0 + s).to(torch.bfloat16), n=shape[-1]: F.rms_norm(
                x, (n,), weight=w, eps=1e-6),
            nbytes(x, x, s), 4 * x.numel(), peaks["float32"], f"{shape} bf16 {norm_case(x)}")
        t = times3[shape]
        # the same bytes moved with no arithmetic: one PyTorch copy of x
        t["copy_ms"] = time_ms(lambda y=torch.empty_like(x): y.copy_(x))
        print(f"  rmsnorm {shape} bf16: kernel {t['ms']:.4f} ms ({t['ms'] - floor_ms:.4f} above "
              f"the floor), F.rms_norm {t['library_ms']:.4f}, copy {t['copy_ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.6f} ({t['bound_by']}) "
              f"{norm_case(x)}", flush=True)
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
    for name in ("flash_attention", "decode_attention"):
        records[name]["max_abs_err"] = {"flash_attention": err1, "decode_attention": err2}[name]
        records[name][MOE_ARCH] = moe_shape_times[name]
    records["moe_gmm"]["max_abs_err"] = err4
    for name in ("flash_attention", "decode_attention", "moe_gmm"):
        records[name][JAMBA_ARCH] = {k: v for k, v in jamba_shape_times.items()
                                     if k.split()[0] == name}
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

    def teacher_forced(p, c, impl, prompt, outs, max_seq, steps=8):
        """Logits (steps + 1, 1, V) of a prefill of ``prompt`` and ``steps``
        decode steps fed the served tokens ``outs``."""
        with ops.impl_scope(impl):
            lg, caches = lm.prefill(p, c, torch.tensor([prompt], device=dev), max_seq=max_seq)
            out = [lg]
            for i in range(steps):
                lg, caches = lm.decode_step(
                    p, c, torch.tensor([outs[i]], device=dev),
                    torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev), caches)
                out.append(lg)
        return torch.stack(out)

    def teacher_forced_graphs(p, c, prompt, outs, max_seq, steps=8):
        """The same as replays of CUDA graphs (``serving/compiled.py``, the
        engine's steps): the prefill's second call (captured, then replayed)
        and ``steps`` decode steps, each one a replay (the decode step's
        eager first call advances a copy of the caches).  Returns the logits
        and the steps' calls, captures and replays."""
        graphs = Graphs(dev)
        row = torch.tensor([prompt])
        pre = graphs.step(lambda t: lm.prefill(p, c, t, max_seq=max_seq))
        pre(row)
        lg, pool_caches = pre(row)
        caches = _map(torch.clone, pool_caches)  # out of the pool, as the engine's slot copy
        out = [lg.clone()]
        state = {"caches": _map(torch.clone, caches)}
        dec = graphs.step(lambda t, pos: lm.decode_step(p, c, t, pos, state["caches"])[0])
        for i in range(steps):
            tok, at = torch.tensor([outs[i]]), torch.tensor([len(prompt) + i], dtype=torch.int32)
            if i == 0:
                dec(tok, at)  # eager, on the copy
                state["caches"] = caches
            out.append(dec(tok, at).clone())
        return torch.stack(out), {"prefill": pre.counts(), "decode": dec.counts()}

    def dense_counts(c, spec: dict, n_ticks: int) -> dict:
        """The launches of a dense attention model's serve set: K1 a layer
        and prefill, K2 a layer and tick, K3 for norm1 and norm2 (and the
        two post-block norms) of every layer and the final norm a forward."""
        norms = (4 if c.post_block_norms else 2) * c.n_layers + 1
        return {"flash_attention": c.n_layers * spec["requests"],
                "decode_attention": c.n_layers * n_ticks,
                "rmsnorm": norms * (spec["requests"] + n_ticks), "moe_gmm": 0, "rwkv6_scan": 0,
                "mamba_scan": 0, **NO_BACKWARD}

    def serve_gemma(c, p, spec: dict) -> tuple:
        """A gemma's serve set, eager then compiled, with the exact launch
        counts, equal tokens and the replay counts, added to the records,
        and its step breakdown (K1 and K2 at the model's head dim by name).
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
                   bf16: tuple | None = None) -> dict:
        """The prefill of ``prompt`` + 8 decode steps teacher-forced with the
        served tokens ``outs``, in f32 through the kernels and through the
        plain versions (within F32_LOGIT_TOL) and through the kernels as
        CUDA graph replays (within GRAPH_F32_TOL of the eager steps); with
        ``bf16`` = (config, params), the same through the kernels and the
        plain versions in bf16: the kernels' path may land no further from
        the f32 path than twice the plain bf16 path does (+0.02), and the
        engine's first token must be the argmax of the bf16 prefill."""
        runs = {"kernel_f32": teacher_forced(p32, c32, "kernel", prompt, outs, max_seq),
                "plain_f32": teacher_forced(p32, c32, "plain", prompt, outs, max_seq)}
        graph_f32, graph_counts = teacher_forced_graphs(p32, c32, prompt, outs, max_seq)
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
        if bf16 is not None:
            kl, pl = runs["kernel"], runs["plain"]
            gate.update({"kernel_vs_plain_bf16": float((kl - pl).abs().max()),
                         "kernel_bf16_vs_f32": float((kl - f32).abs().max()),
                         "plain_bf16_vs_f32": float((pl - f32).abs().max()),
                         "argmax_kernel_bf16_eq_f32": int((kl.argmax(-1) == f32.argmax(-1)).sum()),
                         "argmax_plain_bf16_eq_f32": int((pl.argmax(-1) == f32.argmax(-1)).sum()),
                         "first_token_is_prefill_argmax": int(torch.argmax(kl[0, 0])) == outs[0]})
        print(f"{c32.name} logits, full width, {c32.n_layers} layers, prefill + 8 teacher-forced "
              f"decode steps, kernels vs plain: {json.dumps(gate)} (tol {F32_LOGIT_TOL} on "
              f"kernel_vs_plain_f32, {GRAPH_F32_TOL} on graph_vs_eager_f32)", flush=True)
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
    if counts["rmsnorm"] != (2 * n_layers + 1) * forwards:
        fail(f"rmsnorm launched {counts['rmsnorm']} times, expected "
             f"{2 * n_layers + 1} x {forwards} forwards")
    if any(counts[name] for name in NO_BACKWARD):
        fail(f"serving launched a backward kernel: {counts}")
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
                   "rmsnorm": (2 * n_layers + 1) * forwards, "rwkv6_scan": 0, "mamba_scan": 0,
                   **NO_BACKWARD}
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
    gate_failures = []
    layer = _map(lambda t: t[0], mparams["blocks"]["pos0"]["ffn"])
    mcfg32 = dataclasses.replace(mcfg, param_dtype="float32", activation_dtype="float32")
    gate_a = {}
    for dt, c, p_ in ((torch.bfloat16, mcfg, layer),
                      (torch.float32, mcfg32, _map(lambda t: t.float(), layer))):
        dn = str(dt).removeprefix("torch.")
        for shape in ((1, mS), (mB, 1)):
            x = randn(*shape, dm2, dtype=dt)
            before = launch_counts()["moe_gmm"]
            with ops.impl_scope("kernel"):
                yk, aux_k = ffn_mod.moe_apply(p_, x, c)
            n_k4 = launch_counts()["moe_gmm"] - before
            with ops.impl_scope("plain"):
                yp, aux_p = ffn_mod.moe_apply(p_, x, c)
            # held relative to the layer's output scale (max |y| ~ 0.1 here,
            # far under the kernels' unit-scale tolerances)
            scale = yp.float().abs().max().clamp(min=1e-30)
            case = f"{dn} x {tuple(x.shape)}, diff / max|y| (max|y| {float(scale):.3e})"
            gate_a[case] = hold(f"{MOE_ARCH} MoE layer (gate a)", case, yk.float() / scale,
                                yp.float() / scale, dn, fatal=False)
            if not checks[-1]["ok"]:
                gate_failures.append(f"gate (a) {case}: max_abs_err {gate_a[case]:.3e}")
            if n_k4 != 3 or launch_counts()["moe_gmm"] != before + 3:
                fail(f"gate (a) {case}: {n_k4} moe_gmm launches through the kernels, expected 3")
            if any(float(aux_k[n]) != float(aux_p[n]) for n in aux_k):
                fail(f"gate (a) {case}: the routing's aux losses differ between the two runs")
    del layer, p_, x, yk, yp

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

    # -- 4c. serve full-width, full-depth rwkv6-7b ---------------------------
    del meng, mparams
    picks.clear()
    gc.collect()
    torch.cuda.empty_cache()
    rparams, rwkv_init = init_model(rcfg)
    for sub in rparams["blocks"]["pos0"].values():  # mixer and ffn
        for name, law in RWKV_FLAT_NOISE.items():
            if name in sub:
                t = sub[name]
                noise = (torch.rand(t.shape, generator=gen, device=dev) if law == "uniform"
                         else torch.randn(t.shape, generator=gen, device=dev) * law)
                t.copy_(noise)
    del sub, t, noise  # the loop's names would keep the channel mix's 8.6 GB alive
    reng, rprompts, routs, rwkv_serve, eager_outs, eager_serve = serve_both(rcfg, rparams,
                                                                           RWKV_SERVE)
    rcounts, n_ticks = rwkv_serve["kernels"], rwkv_serve["decode_ticks"]
    forwards = RWKV_SERVE["requests"] + n_ticks
    want_counts = {"rwkv6_scan": rcfg.n_layers * RWKV_SERVE["requests"],  # one per layer, prefill
                   "rmsnorm": (2 * rcfg.n_layers + 1) * forwards,
                   "flash_attention": 0, "decode_attention": 0, "moe_gmm": 0, "mamba_scan": 0,
                   **NO_BACKWARD}
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
                   "rmsnorm": (2 * jcfg.n_layers + 3 * n_mamba + 1) * forwards,
                   "rwkv6_scan": 0, **NO_BACKWARD}
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
    g3eng, g3prompts, g3outs, g3_serve, g3_vs_eager, g3_breakdown = serve_gemma(
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
    g2eng, g2prompts, g2outs, g2_serve, g2_vs_eager, g2_breakdown = serve_gemma(
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

    records["rmsnorm"]["launches_by_shape"] = {str(k): n for k, n in norm_launches.items()}
    print(f"rmsnorm launches by (rows, D), all six serving runs: "
          f"{json.dumps(records['rmsnorm']['launches_by_shape'])}", flush=True)
    if sum(norm_launches.values()) != records["rmsnorm"]["launches"]:
        fail("rmsnorm launches by shape do not add up to its launch count")

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
    err_lse = err_b = 0.0
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        train_shape = [(tB, tS, tS, tHq, tHkv, tD, None, None, 0)] if dt == torch.bfloat16 else []
        for B_, Sq_, Sk_, Hq_, Hkv_, D_, w, cap, qo in k1b_cases + train_shape:
            q, k, v, do = (randn(B_, n, h, D_, dtype=dt)
                           for n, h in ((Sq_, Hq_), (Sk_, Hkv_), (Sk_, Hkv_), (Sq_, Hq_)))
            kw = dict(window=w, softcap=cap, q_offset=qo)
            label = f"{dn} {B_}x{Sq_}x{Sk_}x{Hq_}/{Hkv_}x{D_} w={w} cap={cap} q_offset={qo}"
            out, lse = k1.flash_attention(q, k, v, return_lse=True, **kw)
            out_p, lse_p = ref.flash_attention_lse_ref(q, k, v, **kw)
            hold("flash_attention", f"{label} out, lse written", out, out_p, dn)
            err_lse = max(err_lse, hold("flash_attention lse", label, lse, lse_p, dn))
            got = k1.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            if not all(torch.equal(a, b) for a, b in
                       zip(got, k1.flash_attention_bwd(q, k, v, out, lse, do, **kw))):
                fail(f"flash_attention_bwd {label}: two runs differ")
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
            err_b = max(err_b, hold_rel(f"{label} dq dk dv vs ref.flash_attention_bwd_ref", got,
                                        want, BWD_TOL[dn], kernel="flash_attention_bwd"))
            leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(ref.mha_ref(*leaves, **kw), leaves, do.float())
            hold_rel(f"{label} dq dk dv vs autograd through ref.mha_ref", got, auto,
                     BWD_TOL[dn], kernel="flash_attention_bwd")
            del q, k, v, do, out, lse, out_p, lse_p, got, want, leaves, auto

    # (c) K3b at smollm's training rows and at every served (rows, D), f32
    # and bf16, twice with bitwise-equal results
    err3b = 0.0
    for shape in [(tB * tS, tdm), *served_norms]:
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

    # launches of one train step with per-period remat ("nothing"): every
    # period's forward runs again in the backward
    want_step = {name: 0 for name in launch_counts()}
    want_step.update({"flash_attention": 2 * tL, "flash_attention_bwd": tL,
                      "rmsnorm": 2 * 2 * tL + 1, "rmsnorm_bwd": 2 * tL + 1})

    # (d) one f32 train step at full width and depth, one set of weights,
    # through the kernels (impl auto) and through the plain versions: the
    # loss and every gradient leaf
    cfg32 = dataclasses.replace(tcfg, param_dtype="float32", activation_dtype="float32")
    p32 = lm.init_params(cfg32, SEED, device=dev)
    for t in _leaves(p32):
        t.requires_grad_()
    b = SyntheticLM(DataConfig(tcfg.vocab_size, F32_GATE_SEQ, F32_GATE_BATCH, seed=SEED)).batch(0)
    toks, labels = (torch.from_numpy(b[k]).to(dev) for k in ("tokens", "labels"))
    names = [n for n, _ in _named_leaves(p32)]
    torch.cuda.reset_peak_memory_stats()
    f32_runs = {}
    for impl in ("auto", "plain"):
        reset_launches()
        with ops.impl_scope(impl):
            loss, _ = lm.loss_fn(p32, cfg32, toks, labels)
            grads = torch.autograd.grad(loss, list(_leaves(p32)))
        torch.cuda.synchronize()
        f32_runs[impl] = (float(loss.detach()), grads, launch_counts())
    if f32_runs["auto"][2] != want_step or any(f32_runs["plain"][2].values()):
        fail(f"f32 train step launches: kernels {f32_runs['auto'][2]}, plain "
             f"{f32_runs['plain'][2]}, expected {want_step} and none")
    worst = max(((float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30), n)
                 for n, gk, gp in zip(names, f32_runs["auto"][1], f32_runs["plain"][1])))
    finite = all(bool(torch.isfinite(g).all()) for g in f32_runs["auto"][1])
    f32_gate = {"loss_kernel": f32_runs["auto"][0], "loss_plain": f32_runs["plain"][0],
                "loss_rel_diff": abs(f32_runs["auto"][0] - f32_runs["plain"][0])
                / abs(f32_runs["plain"][0]),
                "worst_leaf_rel_diff": worst[0], "worst_leaf": worst[1], "leaves": len(names),
                "grads_finite": finite, "batch": F32_GATE_BATCH, "seq": F32_GATE_SEQ,
                "layers": tL, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{TRAIN_ARCH} f32 train step, full width and depth, kernels vs plain: "
          f"{json.dumps(f32_gate)} (tol {F32_LOSS_RTOL} on loss_rel_diff, {F32_GRAD_TOL} on "
          "worst_leaf_rel_diff)", flush=True)
    if not finite or f32_gate["loss_rel_diff"] > F32_LOSS_RTOL or worst[0] > F32_GRAD_TOL:
        fail(f"{TRAIN_ARCH}: the f32 train step through the kernels disagrees with the plain "
             "versions")
    del p32, f32_runs, grads, loss
    gc.collect()
    torch.cuda.empty_cache()

    # (e) TRAIN_STEPS bf16 steps at full width and depth on SyntheticLM, the
    # launch counts reset before each step and held after it
    tcfg_train = step_mod.TrainConfig(opt=optim.AdamWConfig(
        peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
    data = SyntheticLM(DataConfig(tcfg.vocab_size, tS, tB, seed=SEED))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
               for i in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    state = step_mod.init_train_state(tcfg, tcfg_train, SEED, dev)
    train_step = step_mod.make_train_step(tcfg, tcfg_train)
    losses, step_ms = [], []
    train_launches = dict.fromkeys(want_step, 0)
    for bt in batches:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, bt)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        got = launch_counts()
        if got != want_step:
            fail(f"{TRAIN_ARCH} train step {len(losses)}: launches {got}, expected {want_step}")
        for name, n in got.items():
            train_launches[name] += n
    med_ms = float(np.median(step_ms))
    train_rec = {"steps": TRAIN_STEPS, "batch": tB, "seq": tS, "peak_lr": TRAIN_LR,
                 "remat_policy": tcfg.remat_policy, "losses": losses,
                 "first_loss": losses[0], "last_loss": losses[-1], "step_ms": step_ms,
                 "median_step_ms": med_ms, "tokens_per_s": tB * tS / (med_ms / 1e3),
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "launches_per_step": want_step, "launches": train_launches}
    print(f"{TRAIN_ARCH} train: {json.dumps(train_rec)}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] - 0.1:
        fail(f"{TRAIN_ARCH}: the loss did not fall by more than 0.1 in {TRAIN_STEPS} steps")

    def port_kernels(profile: dict) -> dict:
        """Device ms a step and launches of the port's training kernels."""
        return {w: [sum(ms for n, ms, _ in profile["all_kernels"] if f"::{w}" in n),
                    sum(c for n, _, c in profile["all_kernels"] if f"::{w}" in n)]
                for w in ("flash_fwd_mma", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma",
                          "rmsnorm_rows", "rmsnorm_bwd_fused")}

    # (f) one train step under torch.profiler
    train_profile = profile_step(lambda: train_step(state, batches[0]), top=12)
    print(f"{TRAIN_ARCH} train step profile: {json.dumps(train_profile)}", flush=True)
    step_kernels = port_kernels(train_profile)
    print(f"{TRAIN_ARCH} train step, device ms and launches of the port's kernels: "
          f"{json.dumps(step_kernels)}", flush=True)
    # the bf16 step ran the tensor-core instances of K1 and K1b and the K3 /
    # K3b kernels, and no CUDA-core instance of K1 or K1b nor the previous
    # K3b's kernels (a session that saw no kernel at all names none)
    names = train_profile["kernel_names"]
    want_names = [k1.instance(torch.bfloat16, tD), *k1.bwd_instances(torch.bfloat16, tD),
                  "rmsnorm_rows", "rmsnorm_bwd_fused"]
    other_names = ["flash_fwd_simt", *k1.bwd_instances(torch.float32, tD),
                   *k1.bwd_instances(torch.bfloat16, 32),  # the mma.sync pair, D 16 / 32 now
                   "rmsnorm_bwd_rows", "rmsnorm_bwd_dscale"]  # the previous K3b
    ran = {w: any(f"::{w}<" in n or f"::{w}(" in n for n in names)
           for w in want_names + other_names}
    print(f"{TRAIN_ARCH} train step attention and norm kernels: {json.dumps(ran)}", flush=True)
    if names and (not all(ran[w] for w in want_names) or any(ran[w] for w in other_names)):
        fail(f"{TRAIN_ARCH} train step ran {ran}, expected {want_names} and none of "
             f"{other_names}")
    del state, train_step, m
    gc.collect()
    torch.cuda.empty_cache()

    # (e') the same TRAIN_STEPS bf16 steps through the compiled step (the
    # step captured as a CUDA graph), from a fresh state of the same seed:
    # the first step eager, the second captured, the rest replays, each
    # step's launches exact (a replay adds what its capture counted)
    torch.cuda.reset_peak_memory_stats()
    cstate = step_mod.init_train_state(tcfg, tcfg_train, SEED, dev)
    cstep = CompiledTrainStep(tcfg, tcfg_train, cstate)
    closses, cstep_ms = [], []
    for bt in batches:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = cstep(cstate, bt)
        closses.append(float(m["loss"]))
        torch.cuda.synchronize()
        cstep_ms.append(1e3 * (time.perf_counter() - t0))
        got = launch_counts()
        if got != want_step:
            fail(f"{TRAIN_ARCH} compiled train step {len(closses)}: launches {got}, expected "
                 f"{want_step}")
    cmed = float(np.median(cstep_ms))
    compiled_rec = {"steps": TRAIN_STEPS, "counts": cstep.counts(), "losses": closses,
                    "first_loss": closses[0], "last_loss": closses[-1],
                    "max_abs_loss_diff_vs_eager": max(abs(a - b) for a, b in zip(closses, losses)),
                    "step_ms": cstep_ms, "median_step_ms": cmed,
                    "tokens_per_s": tB * tS / (cmed / 1e3),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{TRAIN_ARCH} compiled train: {json.dumps(compiled_rec)}", flush=True)
    want_counts = {"calls": TRAIN_STEPS, "captures": 1, "replays": TRAIN_STEPS - 1}
    if compiled_rec["counts"] != want_counts:
        fail(f"{TRAIN_ARCH} compiled train step counts {compiled_rec['counts']}, expected "
             f"{want_counts}")
    if not all(np.isfinite(closses)) or not closses[-1] < closses[0] - 0.1:
        fail(f"{TRAIN_ARCH}: the compiled run's loss did not fall by more than 0.1")

    # (f') one replayed step under torch.profiler, beside (f)'s eager step
    compiled_profile = profile_step(lambda: cstep(cstate, batches[0]), top=12)
    print(f"{TRAIN_ARCH} compiled train step profile (a replay): "
          f"{json.dumps(compiled_profile)}", flush=True)
    print(f"{TRAIN_ARCH} compiled train step, device ms and launches of the port's kernels: "
          f"{json.dumps(port_kernels(compiled_profile))}", flush=True)
    train_vs = {
        mode: {"wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
               "device_idle_share": prof["device_idle_share"], "host_ops": prof["host_ops"],
               "device_kernels": prof["device_kernels"], "median_step_ms": rec["median_step_ms"],
               "tokens_per_s": rec["tokens_per_s"], "peak_mem_gb": rec["peak_mem_gb"]}
        for mode, prof, rec in (("eager", train_profile, train_rec),
                                ("compiled", compiled_profile, compiled_rec))}
    print(f"{TRAIN_ARCH} train step eager vs compiled, {smi}: {json.dumps(train_vs)}", flush=True)
    if compiled_profile["host_ops"] > COMPILED_TICK_HOST_OPS:
        fail(f"{TRAIN_ARCH}: a replayed train step dispatched {compiled_profile['host_ops']} "
             f"host ops (at most {COMPILED_TICK_HOST_OPS})")
    del cstate, cstep, m
    gc.collect()
    torch.cuda.empty_cache()

    # (e') f32 at (d)'s 2 x 1024: one replay against one eager step from
    # equal states (the compiled state made equal after its eager call and
    # its capture)
    b32 = [{k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(DataConfig(
        tcfg.vocab_size, F32_GATE_SEQ, F32_GATE_BATCH, seed=SEED)).batch(i).items()}
        for i in range(2)]
    s_graph = step_mod.init_train_state(cfg32, tcfg_train, SEED, dev)
    graph32 = CompiledTrainStep(cfg32, tcfg_train, s_graph)
    for _ in range(2):
        graph32(s_graph, b32[0])
    s_eager = step_mod.init_train_state(cfg32, tcfg_train, SEED, dev)
    with torch.no_grad():
        for a, b_ in zip(_leaves(s_graph), _leaves(s_eager)):
            a.copy_(b_)
    loss_graph = float(graph32(s_graph, b32[1])[1]["loss"])
    loss_eager = float(step_mod.make_train_step(cfg32, tcfg_train)(s_eager, b32[1])[1]["loss"])
    worst32 = max((float((a - b_).abs().max()) / max(float(b_.abs().max()), 1e-30), n)
                  for (n, a), b_ in zip(_named_leaves(_map(torch.Tensor.detach, s_graph)),
                                        _leaves(_map(torch.Tensor.detach, s_eager)))
                  if a.is_floating_point())
    graph_train_f32 = {"loss_graph": loss_graph, "loss_eager": loss_eager,
                       "loss_rel_diff": abs(loss_graph - loss_eager) / abs(loss_eager),
                       "worst_leaf_rel_diff": worst32[0], "worst_leaf": worst32[1],
                       "steps_equal": int(s_graph["opt"]["step"]) == int(s_eager["opt"]["step"]),
                       "counts": graph32.counts(), "batch": F32_GATE_BATCH, "seq": F32_GATE_SEQ}
    print(f"{TRAIN_ARCH} f32 train step, a CUDA graph replay vs eager from equal states: "
          f"{json.dumps(graph_train_f32)} (tol {GRAPH_TRAIN_F32_TOL} on loss_rel_diff and "
          "worst_leaf_rel_diff)", flush=True)
    if (graph_train_f32["loss_rel_diff"] > GRAPH_TRAIN_F32_TOL
            or worst32[0] > GRAPH_TRAIN_F32_TOL or not graph_train_f32["steps_equal"]
            or graph32.counts() != {"calls": 3, "captures": 1, "replays": 2}):
        fail(f"{TRAIN_ARCH}: the replayed f32 train step disagrees with the eager step")
    del s_graph, s_eager, graph32, b32
    gc.collect()
    torch.cuda.empty_cache()

    # (j) the supervised run: the compiled bf16 step under Supervisor for
    # TRAIN_STEPS steps, a checkpoint every SUP_CKPT_EVERY, a node failure
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
                                          max_steps=TRAIN_STEPS), jstep, batch_fn, jstate,
                         log=sup_log, failures=FailureInjector((SUP_FAIL_AT,))).run()
        sup_wall = time.perf_counter() - t0
        last_loss = dict(zip(order, (mm["loss"] for mm in out["metrics"])))
        sup_losses = [last_loss[i] for i in range(TRAIN_STEPS)]
        calls = TRAIN_STEPS + SUP_FAIL_AT - SUP_CKPT_EVERY
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
        ck.save(TRAIN_STEPS, jstate)
        snapshot_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ck.wait()
        write_s = time.perf_counter() - t0
        ckpt_gb = sum(f.stat().st_size for f in sup_dir.rglob("*") if f.is_file()) / 1e9
        supervised = {
            "steps": out["steps"], "restarts": out["restarts"], "stragglers": out["stragglers"],
            "metrics": len(out["metrics"]), "step_order": order, "losses": sup_losses,
            "losses_equal_compiled_run": sup_losses == closses, "counts": jstep.counts(),
            "launches": sup_launches, "data_ptrs_unchanged": ptrs_unchanged,
            "step_counter": step_counter, "restored_step_equal": restored_equal,
            "restored_into_equal": restored_into_equal,
            "manifest_dtypes_live": listed == live, "manifest_bf16_params": bf16_params,
            "manifest_leaves": len(listed), "wall_s": sup_wall,
            "checkpoint_spans_s": sup_log.durations("checkpoint"),
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
        (f"steps != {TRAIN_STEPS}", supervised["steps"] == TRAIN_STEPS),
        ("a step's last loss differs from the uninterrupted compiled run's",
         supervised["losses_equal_compiled_run"]),
        (f"counts {supervised['counts']} != {want_calls}", supervised["counts"] == want_calls),
        ("launches are not the calls' exact launches",
         sup_launches == {k: v * calls for k, v in want_step.items()}),
        ("a leaf's data_ptr moved", supervised["data_ptrs_unchanged"]),
        (f"step counter {supervised['step_counter']} != {TRAIN_STEPS}",
         supervised["step_counter"] == TRAIN_STEPS),
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
    # K1b has no D-256 instance: the wrapper refuses before any launch,
    # naming its ROADMAP item
    q, k, v = (randn(1, 64, h, 256, dtype=torch.bfloat16) for h in (8, 4, 4))
    out, lse = k1.flash_attention(q, k, v, return_lse=True)
    before = launch_counts()["flash_attention_bwd"]
    try:
        k1.flash_attention_bwd(q, k, v, out, lse, out)
    except NotImplementedError as e:
        if "K1b-D256" not in str(e) or launch_counts()["flash_attention_bwd"] != before:
            fail(f"flash_attention_bwd at D 256: raised {e!r} after "
                 f"{launch_counts()['flash_attention_bwd'] - before} launches")
    else:
        fail("flash_attention_bwd at D 256 ran, with no backward instance there")
    print("  flash_attention_bwd at D 256 refuses before any launch, naming K1b-D256: ok",
          flush=True)
    del q, k, v, out, lse

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

    records["flash_attention"]["with_lse"] = k1_lse
    records["flash_attention"]["train_launches"] = train_launches["flash_attention"]
    records["flash_attention"]["lse_max_abs_err"] = err_lse
    records["rmsnorm"]["train_launches"] = train_launches["rmsnorm"]
    records["rmsnorm"]["train"] = k3_train
    records["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_vjp.py:108", "max_abs_err": err_b,
        "launches": train_launches["flash_attention_bwd"], **k1b,
    }
    records["rmsnorm_bwd"] = {
        "name": "rmsnorm_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/nn/core.py:178", "max_abs_err": err3b,
        "launches": train_launches["rmsnorm_bwd"], **k3b,
    }
    training = {"f32_gate": f32_gate, "train": train_rec, "profile": train_profile,
                "compiled": compiled_rec, "compiled_profile": compiled_profile,
                "eager_vs_compiled": train_vs, "graph_f32": graph_train_f32,
                "supervised": supervised, "cli": cli}

    # -- 6. the paper's measurement layer ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    measurement = measurement_phase(dev, smi)

    # -- 7. report ----------------------------------------------------------
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
            "measurement": measurement, "seconds": time.time() - t_start}
    print(f"chip_smoke: {full['seconds']:.1f} s", flush=True)
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


def add_norm_launches(into: dict, c, spec: dict, n_ticks: int) -> dict:
    """Adds a serving run's RMSNorm launches by (rows, D) to ``into``: norm1
    and norm2 of every layer (and norm1_post and norm2_post with post-block
    norms) and the final norm at d_model, and a Mamba
    layer's dt / B / C norms at dt_rank and d_state, for each of the
    requests' prefills (prompt_len rows) and each decode tick (max_batch
    rows)."""
    n_mamba = sum(c.layer_spec(i).mixer == "mamba" for i in range(c.n_layers))
    widths = {c.d_model: (4 if c.post_block_norms else 2) * c.n_layers + 1}
    if n_mamba:
        from repro_torch.nn import mamba as mamba_mod

        _, N, _, R = mamba_mod._dims(c)
        widths[R] = widths.get(R, 0) + n_mamba
        widths[N] = widths.get(N, 0) + 2 * n_mamba
    for rows, n in ((spec["prompt_len"], spec["requests"]), (spec["max_batch"], n_ticks)):
        for d, per in widths.items():
            into[(rows, d)] = into.get((rows, d), 0) + per * n
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
