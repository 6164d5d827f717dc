#!/usr/bin/env python3
"""Design variants of K1b's wgmma instances (bf16, head dim 64, 128 or 256), timed on one card.

    python3 tools/k1b_variants.py [--head-dim {64,128,256}] [--check] [--out PATH] [--sass PATH]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu`` once per
design choice of the head dim's instances (``-D`` of the source's
``K1B_*`` macros: at D 64 consumer warpgroups a block and ring stages; at
D 128 ring stages, item buffers and whether a step issues the next tile's
scores first; at D 256, where only rings of 2 stages fit 227 KB, the
committed build; plus, by text substitutions that must match, dq's S / dP
with A from registers at D 64, a design not committed, and three
diagnostics, whose outputs are wrong by construction: no exponentials, no
products, no ring loads), prints each build's ptxas report (registers,
spills, wgmma serialisation) and runs no build whose configuration query
refuses it (an entry register count that would leave setmaxnreg
waiting).  Holds each design against ``ref.flash_attention_bwd_ref``
(each gradient relative to its max |.|, 2e-2) at the head dim's CHECKS,
every run twice with bitwise-equal results, with the persistent plan and
with one block per item.  Then times at the head dim's training shapes
(D 64: smollm-360m; D 128: gemma2-27b with softcap 50, chameleon-34b at
G 8, deepseek-moe-16b at G 1; D 256: gemma3-4b's global and local layers;
all bf16 causal at 4 x 2048), two turns in opposite orders, L2 flushed
before each call: SDPA's backward (forward + backward less the forward;
gemma2-27b's without its softcap), the previous design (D 64: the
mma.sync instance ``flash_bwd_dq_mma`` + ``flash_bwd_dkdv_mma``; D 128 /
256: the previous wide mma.sync pair, the kernels of
``flash_attention.previous_wide_bwd``, both through
``flash_attention_bwd.cu``'s C entry) and each build with the persistent
plan (``bwd_plan``'s longest first, and the two orders by KV head of
``PLAN_ORDERS`` here, each checked to give the same bytes) and with one
block per item, beside the bound (5 products at 989 TFLOP/s); and each
build's two passes apart under torch.profiler.  ``--check`` builds and
checks the committed configuration only; ``--sass`` writes the committed
build's SASS and counts its wgmma, barrier and exponential instructions.
Needs one CUDA card and ``nvcc``; the variant builds go to
``build/k1b_variants/``.
"""
from __future__ import annotations

import argparse
import ctypes
import heapq
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# the training shapes by head dim: (B, Sq, Sk, Hq, Hkv, window, softcap)
TRAIN = {
    64: {"smollm-360m": (4, 2048, 2048, 15, 5, None, None)},
    128: {"gemma2-27b": (4, 2048, 2048, 32, 16, None, 50.0),
          "chameleon-34b": (4, 2048, 2048, 64, 8, None, None),
          "deepseek-moe-16b": (4, 2048, 2048, 16, 16, None, None)},
    256: {"gemma3-4b global": (4, 2048, 2048, 8, 4, None, None),
          "gemma3-4b local": (4, 2048, 2048, 8, 4, 1024, None)},
}
# (B, Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset): ragged tiles,
# window + softcap + q_offset, G = 8, Sq < 64, a row without a live key
CHECKS = [
    (1, 64, 64, 1, 1, True, None, None, 0),
    (2, 256, 256, 15, 5, True, None, None, 0),
    (1, 200, 200, 8, 1, True, None, None, 0),
    (2, 136, 264, 15, 5, True, 48, 30.0, 128),
    (1, 100, 300, 16, 2, True, 37, 30.0, 200),
    (1, 333, 333, 8, 1, False, None, None, 0),
    (1, 5, 9, 2, 1, True, None, None, 4),
    (1, 8, 4, 2, 2, False, 2, None, 3),
]
# at D 128 / 256 also the CPU tests' VJP cases (window 16 with softcap 50,
# softcap 30, q_offset 24) and G 6 (dbrx-132b's heads)
WIDE_CHECKS = [
    (2, 40, 40, 4, 2, True, 16, 50.0, 0), (2, 40, 40, 4, 2, True, None, 30.0, 0),
    (2, 40, 64, 4, 2, True, None, None, 24), (1, 256, 256, 48, 8, True, None, None, 0),
]
# the ring loads of each pass, replaced by a bare arrival in "no ring loads"
DQ_RING_LOAD = """          mbar_expect_tx(&sm.full[stage], 2 * kTileBytes);
          tma_tile(sm.ring[stage][0], &tm_k, &sm.full[stage], hk, kr.start + t * kT, b);
          tma_tile(sm.ring[stage][1], &tm_v, &sm.full[stage], hk, kr.start + t * kT, b);
"""
DKDV_RING_LOAD = """            mbar_expect_tx(&sm.full[stage], 2 * kTileBytes + kStatBytes);
            tma_tile(sm.ring[stage][0], &tm_q, &sm.full[stage], h, i0, b);
            tma_tile(sm.ring[stage][1], &tm_do, &sm.full[stage], h, i0, b);
            bulk_copy(sm.stat[stage], st + (i0 / kT) * kStat, kStatBytes, &sm.full[stage]);
"""
# dq's S = Q K^T and dP = dO V^T with A from registers: Q and dO loaded once
# an item into A fragments (ldmatrix from the swizzled tiles) in place of
# their shared-memory descriptors
DQ_RS_HELPERS = """// d = A B, A in registers, B's tile K-major (S = Q K^T from Q's fragments)
__device__ __forceinline__ void mma64_rk(float (&d)[32], const uint32_t (&a)[4][4], uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(d, a[kk], b + kk * kKStep, kk > 0);
}
// this warp's 16 rows of a 64 x 64 tile in TMA's 128-byte swizzle as the A
// fragments of 4 k16 steps (ldmatrix.x4: lanes 0-15 address rows 0-15 of
// the step's low 8 columns, lanes 16-31 its high 8)
__device__ __forceinline__ void tile_frags(uint32_t (&f)[4][4], const bf16* tile, int warp,
                                           int lane) {
  const int row = warp * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(f[kk], smem_addr(tile + row * 64 + (((2 * kk + (lane >> 4)) ^ (row & 7)) * 8)));
}
"""
WALK_HEADER = "// ---------------------------------------------------------------------------\n" \
    "// the walk of an item"
DQ_RS = [
    (WALK_HEADER, DQ_RS_HELPERS + "\n" + WALK_HEADER),
    ("uint64_t q_desc, uint64_t do_desc",
     "const uint32_t (&q_desc)[4][4], const uint32_t (&do_desc)[4][4]"),
    ("mma64(s, q_desc, tile_desc(kv[0]));", "mma64_rk(s, q_desc, tile_desc(kv[0]));"),
    ("mma64(dp, do_desc, tile_desc(kv[1]));", "mma64_rk(dp, do_desc, tile_desc(kv[1]));"),
    ("const uint64_t q_desc = tile_desc(qs), do_desc = tile_desc(dos);",
     "uint32_t q_desc[4][4], do_desc[4][4];\n"
     "      tile_frags(q_desc, qs, warp, lane);\n"
     "      tile_frags(do_desc, dos, warp, lane);"),
]
# the wide passes' ring loads, replaced by a bare arrival in "no ring loads"
WIDE_DQ_RING_LOAD = """          mbar_expect_tx(&sm.full[stage], 2 * kWideBytes);
          for (int p = 0; p < kP; ++p) {
            tma_box(sm.ring[stage][0][p], &tm_k, &sm.full[stage], 64 * p, hk, kr.start + t * kT, b);
            tma_box(sm.ring[stage][1][p], &tm_v, &sm.full[stage], 64 * p, hk, kr.start + t * kT, b);
          }
"""
WIDE_DKDV_RING_LOAD = """            mbar_expect_tx(&sm.full[stage], 2 * kWideBytes + kStatBytes);
            for (int p = 0; p < kP; ++p) {
              tma_box(sm.ring[stage][0][p], &tm_q, &sm.full[stage], 64 * p, h, i0, b);
              tma_box(sm.ring[stage][1][p], &tm_do, &sm.full[stage], 64 * p, h, i0, b);
            }
            bulk_copy(sm.stat[stage], st + (i0 / kT) * kStat, kStatBytes, &sm.full[stage]);
"""
NO_EXP = ("no exponentials", ({}, [("return ex2(s * a.scale_log2 - lse2);",
                                     "return s * a.scale_log2 - lse2;")]))
NO_PRODUCTS = ("no products", ({}, [("int lo = 0, hi = kr.n;", "int lo = 0, hi = 0;"),
                                    ("int lo = 0, hi = qr.n;", "int lo = 0, hi = 0;")]))
# name: (-D flags, text substitutions), by head dim; the first is the
# committed configuration
VARIANTS = {
    64: dict([
        ("committed (2 + 2 warpgroups, 4 stages)", ({}, [])),
        ("1 + 1 warpgroups, 2 blocks an SM", ({"K1B_DQ_WG": 1, "K1B_DKDV_WG": 1}, [])),
        ("3 stages", ({"K1B_STAGES": 3}, [])),
        ("5 stages", ({"K1B_STAGES": 5}, [])),
        ("dq S / dP with A from registers", ({}, DQ_RS)),
        NO_EXP, NO_PRODUCTS,
        ("no ring loads", ({}, [(DQ_RING_LOAD, "          mbar_expect_tx(&sm.full[stage], 0);\n"),
                                (DKDV_RING_LOAD,
                                 "            mbar_expect_tx(&sm.full[stage], 0);\n")])),
    ]),
    128: dict([
        ("committed (2 warpgroups split D, stages 4 / 3, 2 item buffers, lookahead)", ({}, [])),
        ("dq 3 stages", ({"K1B_W128_DQ_STAGES": 3}, [])),
        ("one item buffer", ({"K1B_W128_DQ_BUFS": 1, "K1B_W128_DKDV_BUFS": 1}, [])),
        ("one item buffer, 5 / 4 stages",
         ({"K1B_W128_DQ_BUFS": 1, "K1B_W128_DKDV_BUFS": 1, "K1B_W128_DQ_STAGES": 5,
           "K1B_W128_DKDV_STAGES": 4}, [])),
        ("dk / dv one item buffer, 4 stages",
         ({"K1B_W128_DKDV_BUFS": 1, "K1B_W128_DKDV_STAGES": 4}, [])),
        ("no lookahead (the D-256 step), stages 4 / 3",
         ({"K1B_W128_AHEAD": 0}, [])),
        ("no lookahead, 2 stages, one item buffer (the D-256 design)",
         ({"K1B_W128_AHEAD": 0, "K1B_W128_DQ_STAGES": 2, "K1B_W128_DKDV_STAGES": 2,
           "K1B_W128_DQ_BUFS": 1, "K1B_W128_DKDV_BUFS": 1}, [])),
        NO_EXP, NO_PRODUCTS,
        ("no ring loads", ({}, [(WIDE_DQ_RING_LOAD,
                                 "          mbar_expect_tx(&sm.full[stage], 0);\n"),
                                (WIDE_DKDV_RING_LOAD,
                                 "            mbar_expect_tx(&sm.full[stage], 0);\n")])),
    ]),
    256: dict([
        ("committed (2 warpgroups split D, 2 stages, 1 item buffer, no lookahead)", ({}, [])),
        NO_EXP, NO_PRODUCTS,
        ("no ring loads", ({}, [(WIDE_DQ_RING_LOAD,
                                 "          mbar_expect_tx(&sm.full[stage], 0);\n"),
                                (WIDE_DKDV_RING_LOAD,
                                 "            mbar_expect_tx(&sm.full[stage], 0);\n")])),
    ]),
}
# diagnostics, not designs: their outputs are wrong by construction
DIAGNOSTIC = ("no exponentials", "no products", "no ring loads")
# persistent plans by KV head, timed beside bwd_plan's longest first: they
# keep a block on few KV heads at a time, whose Q / dO (dk / dv) or K / V
# (dq) tiles then stay in L2
PLAN_ORDERS = ("by_head", "head_major")
BWD_TOL = 2e-2
SDPA_NOTE = "scaled_dot_product_attention forward + backward, less its forward"


def plan_by_kv_head(order: str, pass_: str, B: int, Sq: int, Sk: int, Hq: int, Hkv: int, *,
                    wg: int, slots: int, causal: bool = True, window=None,
                    q_offset: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """A persistent plan of a wgmma K1b pass as ``flash_attention.bwd_plan``
    gives it (offsets, items), in an ``order`` of PLAN_ORDERS: ``"by_head"``,
    bwd_plan's lists, each block then running its items by (batch, KV head),
    longest first within one; ``"head_major"``, the items by (batch, KV
    head), longest first within one, each onto the least loaded block (the
    bound of any list schedule: the mean plus one item).  Needs ``src`` on
    the path."""
    from repro_torch.kernels import flash_attention as k1

    if order not in PLAN_ORDERS:
        raise ValueError(f"plan_by_kv_head: order {order!r} is not one of {PLAN_ORDERS}")
    kw = dict(wg=wg, causal=causal, window=window, q_offset=q_offset)
    cost = k1.bwd_costs(pass_, B, Sq, Sk, Hq, Hkv, **kw)
    n_tiles = len(cost) // (B * (Hq if pass_ == "dq" else Hkv))
    group = np.arange(len(cost)) // (n_tiles * (Hq // Hkv if pass_ == "dq" else 1))
    if order == "by_head":
        offsets, items = k1.bwd_plan(pass_, B, Sq, Sk, Hq, Hkv, slots=slots, **kw)
        lists = [sorted(items[a:b].tolist(), key=lambda x: (group[x], -cost[x], x))
                 for a, b in zip(offsets[:-1], offsets[1:])]
    else:
        heap = [(0, i) for i in range(min(len(cost), slots))]
        lists = [[] for _ in heap]
        for item in np.lexsort((-cost, group)):
            load, i = heapq.heappop(heap)
            lists[i].append(int(item))
            heapq.heappush(heap, (load + int(cost[item]), i))
        offsets = np.cumsum([0] + [len(x) for x in lists]).astype(np.int32)
    return offsets, np.array([x for lst in lists for x in lst], dtype=np.int32)


def ptxas_report(log: str) -> list[dict]:
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'")[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        smem = re.search(r"(\d+) bytes smem", part)
        out.append({"kernel": name, "registers": int(regs.group(1)) if regs else 0,
                    "spill_bytes": int(spill.group(1)) if spill else 0,
                    "static_smem": int(smem.group(1)) if smem else 0,
                    "warnings": re.findall(r"warning[^\n]*", part)})
    return out


def build_variants(head_dim: int, names: list[str], out: Path) -> dict[str, tuple[Path, str]]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        defines, edits = VARIANTS[head_dim][name]
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"k1b_variants: substitution no longer matches: {old[:60]!r}")
            src = src.replace(old, new)  # every occurrence
        cu = out / f"d{head_dim}_v{i}.cu"
        cu.write_text(src)
        flags = [f"-D{k}={v}" for k, v in defines.items()]
        lib = out / f"d{head_dim}_v{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-o",
               str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k1b_variants: {name}: nvcc exit {proc.returncode}\n{log}")
        built[name] = (lib, log)
    return built


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--head-dim", type=int, choices=sorted(VARIANTS), default=64,
                    help="the head dim whose wgmma instances are built and timed")
    ap.add_argument("--check", action="store_true",
                    help="build and check the committed configuration only; no timing")
    ap.add_argument("--out", type=Path, default=None, help="write the record here as JSON")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write the committed build's SASS (cuobjdump) here")
    args = ap.parse_args()
    D = args.head_dim
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1b_variants: torch.cuda.is_available() is False: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as k1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; head dim {D}", flush=True)
    dev = torch.device("cuda")
    record: dict = {"card": smi, "head_dim": D, "variants": {}}
    own = f"_sm90ILi{D}E" if D != 64 else "_wgmmaI"  # this head dim's kernels, mangled

    t0 = time.time()
    _build.build(["flash_attention", "flash_attention_bwd"])
    names = list(VARIANTS[D])[:1] if args.check else list(VARIANTS[D])
    built = build_variants(D, names, ROOT / "build" / "k1b_variants")
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    if args.sass is not None:  # the committed build's machine code, for reading
        sass = subprocess.run([str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
                               str(built[names[0]][0])], capture_output=True, text=True).stdout
        args.sass.parent.mkdir(parents=True, exist_ok=True)
        args.sass.write_text(sass)
        for kernel in sass.split("Function : ")[1:]:
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", kernel)
            count = {op: sum(o.startswith(op) for o in ops)
                     for op in ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "MUFU.EX2",
                                "SYNCS", "BAR", "LDS", "STS", "STL", "LDL")}
            print(f"  sass {kernel.split()[0][:90]}: {len(ops)} instructions, {count}",
                  flush=True)
    libs = {}
    for name, (path, log) in built.items():
        rep = [r for r in ptxas_report(log) if own in r["kernel"]]
        if args.check:
            print(log, flush=True)
        serialised = []
        for line in log.splitlines():
            if "Performance" in line or "setmaxnreg" in line or "warning" in line:
                fn = re.search(r"flash_bwd_\w+?E(?:Ev|v)", line)
                print(f"  {name}: ptxas: {line.strip()[:120]} ... "
                      f"{fn.group(0) if fn else line[-100:]}", flush=True)
                if "Performance" in line and fn and own in fn.group(0):
                    serialised.append(fn.group(0))
        for r in rep:
            print(f"  {name}: {r['kernel'][:70]}: {r['registers']} registers, "
                  f"{r['spill_bytes']} bytes spilled, {r['static_smem']} bytes static smem; "
                  f"{r['warnings']}", flush=True)
        record["variants"][name] = {"ptxas": rep, "spills": any(r["spill_bytes"] for r in rep),
                                    "wgmma_serialised": serialised}
        lib, fn = k1.sm90_library(ctypes.CDLL(str(path)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        try:  # refuses a build whose entry registers would leave setmaxnreg waiting
            cfg = k1.sm90_config(lib, 0, D)
        except RuntimeError as e:
            print(f"  {name}: skipped ({e})", flush=True)
            continue
        libs[name] = (lib, fn)
        record["variants"][name]["config"] = cfg
        print(f"  {name}: {json.dumps(cfg)}", flush=True)
    if not libs:
        raise SystemExit("k1b_variants: no build can run")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def run(lib_fn, q, k, v, out, lse, do, persistent=True, **kw):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        k1.sm90_bwd(*lib_fn, q, k, v, out, lse, do, dq, dk, dv, scale=1 / math.sqrt(D),
                    persistent=persistent, **kw)
        return dq, dk, dv

    def run_planned(lib_fn, plans, q, k, v, out, lse, do, *, causal, window, softcap, q_offset):
        """sm90_bwd's launch with the given (plan tensor, blocks) of each pass."""
        lib, fn = lib_fn
        B, Sq, Hq, _ = q.shape
        _, Sk, Hkv, _ = k.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stat = torch.empty((B, Hq, -(-Sq // k1.BWD_TILE), 2 * k1.BWD_TILE), dtype=torch.float32,
                           device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stat.data_ptr(),
                 plans[0][0].data_ptr(), plans[0][1], plans[1][0].data_ptr(), plans[1][1],
                 B, Sq, Sk, Hq, Hkv, D, int(causal), -1 if window is None else int(window),
                 float(softcap or 0.0), 1 / math.sqrt(D), int(q_offset),
                 torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "flash_attention_bwd (a plan by KV head)")
        return dq, dk, dv

    def twice(lib_fn, q, k, v, out, lse, do, **kw):
        """Two runs, each into the blocks the allocator last freed, filled
        with NaN just before (an element left unwritten shows); whether they
        are the same bytes.  Raises if a gradient did not land there."""
        outs = []
        for _ in range(2):
            nan = [torch.full_like(t, float("nan")) for t in (q, k, v)]
            ptrs = {t.data_ptr() for t in nan}
            del nan
            outs.append(run(lib_fn, q, k, v, out, lse, do, **kw))
            if not {g.data_ptr() for g in outs[-1]} <= ptrs:
                raise SystemExit("k1b_variants: a gradient did not land in the NaN-filled blocks")
        torch.cuda.synchronize()
        return outs[0], all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                            for a, b in zip(*outs))

    # -- checks --------------------------------------------------------------
    checks = CHECKS + (WIDE_CHECKS if D != 64 else []) + [
        (B, Sq, Sk, Hq, Hkv, True, w, cap, 0) for B, Sq, Sk, Hq, Hkv, w, cap in TRAIN[D].values()]
    worst = 0.0
    for case in checks:
        B, Sq, Sk, Hq, Hkv, causal, window, cap, qo = case
        q, k, v, do = randn(B, Sq, Hq, D), randn(B, Sk, Hkv, D), randn(B, Sk, Hkv, D), \
            randn(B, Sq, Hq, D)
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo)
        out, lse = k1.flash_attention(q, k, v, return_lse=True, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        for name, lib_fn in libs.items():
            if name in DIAGNOSTIC:
                continue
            for persistent in (True, False):
                got, same = twice(lib_fn, q, k, v, out, lse, do, persistent=persistent, **kw)
                rel = max(float((g.float() - w.float()).abs().max())
                          / max(float(w.float().abs().max()), 1e-30) for g, w in zip(got, want))
                finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
                ok = same and finite and rel <= BWD_TOL
                worst = max(worst, rel)
                print(f"  check {name} {'persistent' if persistent else 'per item'} {case}: "
                      f"max_rel_err {rel:.3e} rerun_equal {same} {'ok' if ok else 'FAIL'}",
                      flush=True)
                record["variants"][name].setdefault("checks", []).append(
                    {"case": case, "persistent": persistent, "max_rel_err": rel, "ok": ok})
                if not ok:
                    raise SystemExit(f"k1b_variants: {name} {case} disagrees")
        del q, k, v, do, out, lse, want
    record["worst_rel_err"] = worst
    if args.check:
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(record, indent=1))
        print(json.dumps({"ok": True, "worst_rel_err": worst}), flush=True)
        return

    # -- timing at the training shapes ----------------------------------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        for s_, e in evs:
            flush.zero_()
            s_.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s_.elapsed_time(e) for s_, e in evs) / iters

    old_lib, old_fn = k1._bwd_entry()
    record["timing"] = {}
    for label, (B, Sq, Sk, Hq, Hkv, window, cap) in TRAIN[D].items():
        q, k, v, do = randn(B, Sq, Hq, D), randn(B, Sk, Hkv, D), randn(B, Sk, Hkv, D), \
            randn(B, Sq, Hq, D)
        kw = dict(causal=True, window=window, softcap=cap, q_offset=0)
        out, lse = k1.flash_attention(q, k, v, return_lse=True, **kw)
        qg, kg, vg = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        dos = do.transpose(1, 2).contiguous()
        mask = None
        if window is not None:
            pos = torch.arange(Sq, device=dev)[:, None]
            key = torch.arange(Sk, device=dev)[None, :]
            mask = (key <= pos) & (key > pos - window)
        sdpa_kw = dict(attn_mask=mask, is_causal=mask is None, enable_gqa=True)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)
            torch.autograd.grad(o, (qg, kg, vg), dos)

        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)

        def old():  # the previous design, through flash_attention_bwd.cu's C entry
            err = old_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), do.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
                         grads[2].data_ptr(), delta.data_ptr(), 1, B, Sq, Sk, Hq, Hkv, D, 1,
                         -1 if window is None else window, float(cap or 0.0), 1 / math.sqrt(D),
                         0, torch.cuda.current_stream().cuda_stream)
            _build.check(old_lib, err, "flash_attention_bwd (previous design)")

        old()
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        old_rel = max(float((g.float() - w.float()).abs().max()) / float(w.float().abs().max())
                      for g, w in zip(grads, want))
        previous = "mma.sync (flash_bwd_*_mma)" if D == 64 else "previous wide (flash_bwd_*_wide)"
        print(f"  check {previous} at {label}: max_rel_err {old_rel:.3e}", flush=True)
        del want
        pos = np.arange(Sq)
        lo = np.maximum(0, pos - window + 1) if window is not None else 0
        pairs = B * Hq * int((np.minimum(pos, Sk - 1) - lo + 1).sum())
        flops5 = 10 * D * pairs  # the bound's count: 5 products of 2 D flops a live pair
        times: dict[str, list] = {}
        # each build with the persistent plan longest first and by KV head
        # (the same bytes as longest first), and with one block per item
        runs = [("sdpa", None), (previous, old)]
        n_sm = _build.sm_count(0)
        for name, lib_fn in libs.items():
            cfg = record["variants"][name]["config"]
            runs.append((f"{name} persistent longest",
                         lambda lf=lib_fn: run(lf, q, k, v, out, lse, do, **kw)))
            base = run(lib_fn, q, k, v, out, lse, do, **kw)
            for o in PLAN_ORDERS:
                plans = []
                for p in ("dq", "dkdv"):
                    offsets, items = plan_by_kv_head(
                        o, p, B, Sq, Sk, Hq, Hkv, wg=cfg[f"item_tiles_{p}"],
                        slots=n_sm * cfg[f"blocks_per_sm_{p}"], window=window)
                    plans.append((torch.from_numpy(np.concatenate([offsets, items])).to(dev),
                                  len(offsets) - 1))
                got = run_planned(lib_fn, plans, q, k, v, out, lse, do, **kw)
                same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                           for a, b in zip(got, base))
                if name not in DIAGNOSTIC and not same:
                    raise SystemExit(f"k1b_variants: {name} by {o} differs from longest first")
                runs.append((f"{name} persistent {o}",
                             lambda lf=lib_fn, pl=plans: run_planned(lf, pl, q, k, v, out, lse,
                                                                     do, **kw)))
            runs.append((f"{name} per item",
                         lambda lf=lib_fn: run(lf, q, k, v, out, lse, do, persistent=False,
                                               **kw)))
            del base, got
        for turn in (runs, runs[::-1]):
            for name, fn in turn:
                if name == "sdpa":
                    t = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd)
                else:
                    t = time_ms(fn)
                times.setdefault(name, []).append(t)
        rec = {"shape": f"B={B} S={Sq} Hq={Hq} Hkv={Hkv} D={D} bf16 causal window={window} "
                        f"softcap={cap}", "card": smi, "bound_ms": 1e3 * flops5 / 989e12,
               "sdpa_library": SDPA_NOTE + (" (without the softcap)" if cap else ""),
               "ms": times}
        print(f"timing at {label} ({rec['shape']}), L2 flushed, two turns, on {smi}; bound "
              f"{rec['bound_ms']:.4f} ms (5 products at 989 TFLOP/s):", flush=True)
        for name, ts in times.items():
            mean = sum(ts) / len(ts)
            print(f"  {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms, "
                  f"{mean / rec['bound_ms']:.2f}x the bound, "
                  f"{flops5 / (mean * 1e-3) / 1e12:.1f} TFLOP/s on the bound's count",
                  flush=True)
        # the two passes apart: device time by kernel name under torch.profiler
        split = {}
        for name, lib_fn in libs.items():
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    run(lib_fn, q, k, v, out, lse, do, **kw)
                torch.cuda.synchronize()
            split[name] = {re.search(r"flash_bwd_\w+?(?=<|\(|$)", e.key).group(0):
                           e.device_time_total / 10 / 1e3
                           for e in prof.key_averages() if "flash_bwd_d" in e.key}
            print(f"  {name} persistent, ms a call by kernel: {json.dumps(split[name])}",
                  flush=True)
        rec["split_ms"] = split
        record["timing"][label] = rec
        del q, k, v, do, out, lse, qg, kg, vg, dos, grads, delta
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": True, "head_dim": D, "ms": {
        label: {n: sum(t) / len(t) for n, t in r["ms"].items()}
        for label, r in record["timing"].items()}}), flush=True)


if __name__ == "__main__":
    main()
