#!/usr/bin/env python3
"""Design variants of K3b (the RMSNorm backward), checked and timed on one card.

    python3 tools/k3b_variants.py [--check] [--out PATH]

Builds ``src/repro_torch/kernels/csrc/rmsnorm.cu`` once per design choice,
each by text substitutions that must match, with the launch (the grid
and the rows of partials, from ``rmsnorm.bwd_plan``) to match: joiners of
dscale (1 is the last block summing every row), prefetch depth, a ring of
bulk-copy stages (mbarrier waits, ``cp.async.bulk``) in place of register
prefetch, a cluster join through distributed shared memory, two blocks an
SM, a fence in every thread, dx stored evict-first, plain loads without
the L2 256-byte hint; and five diagnostics, whose outputs are wrong by
construction: no dx stores; no dscale join; the join up to the ticket
only; the join without its fence; the rows' loads only.  Prints each
build's ptxas report for the K3b kernel.  Holds each design against
``ref.rmsnorm_bwd_ref`` (relative to each output's max |.|, 2e-2 in bf16
and 1e-4 in f32) at CHECKS, every run twice with identical bits.  Then
times at smollm-360m's (8192, 960) bf16, L2 flushed before each call (a
64 MB write, as chip_smoke.py does), two turns in opposite order: the
committed wrapper, the previous design (``rmsnorm.previous_bwd``: a memset
of dscale, ``rmsnorm_bwd_rows`` and ``rmsnorm_bwd_dscale``), its memset
alone and a build of it whose entry launches ``rmsnorm_bwd_rows`` only,
``F.rms_norm``'s backward (forward + backward less the forward), and each
build; then the kernels that one call of the committed wrapper and of the
previous design launch, by name and device time under torch.profiler;
then a few of them again with L2 emptied by a 64 MB read instead.
Each build takes tickets from counters of its own.
``--check`` builds and checks every design, no timing.  Needs one CUDA
card and ``nvcc``; the variant builds go to ``build/k3b_variants/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN = (8192, 960)  # smollm-360m's rows (4 x 2048 tokens) and d_model
# (rows, D): the training shape, the served widths at 8 and 512 rows, and
# ragged row counts against the grid and the row groups
CHECKS = [TRAIN, *[(r, d) for d in (16, 512, 896, 2048, 4096, 8192) for r in (8, 512)],
          (1, 960), (7, 960), (133, 960), (8191, 960), (133, 2048), (7, 8192)]
TOL = {"bfloat16": 2e-2, "float32": 1e-4}

ROW_HEAD = """  auto row = [&](const uint32_t (&xw)[kC][4], const uint32_t (&gw)[kC][4], int s) {
    float ss = 0.f, sgx = 0.f;
"""
DX_STORE = ("      *reinterpret_cast<uint4*>(dr + c * E) = make_uint4(o[0], o[1], o[2], o[3]);"
            "  // dx\n")
DX_STORE_CS = DX_STORE.replace("*reinterpret_cast<uint4*>(dr + c * E) = ",
                               "__stcs(reinterpret_cast<uint4*>(dr + c * E), ")
DX_STORE_CS = DX_STORE_CS.replace("]);", "]));")
JOIN_HEAD = "  // the block's row of dscale partials: its groups', in group order\n"
KEEP_DSC = """  {  // the partials kept alive, not joined
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i)
#pragma unroll
      for (int j = 0; j < E; ++j) t += dsc[i][j];
    if (t == 1234.5f) dscale[0] = t;
    return;
  }
"""
FENCE_ONE = """  __syncthreads();
  if (tid == 0) {
    __threadfence();
    ticket = atomicAdd(&count[0], 1u);
  }
"""
FENCE_ALL = """  __threadfence();
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(&count[0], 1u);
"""
JOINERS_GO = "  if (ticket < gridDim.x - J) return;\n"
LOAD_ROW = """      const uint4 a = ok ? ld_row(x + at + c * E) : make_uint4(0, 0, 0, 0);
      const uint4 d = ok ? ld_row(dy + at + c * E) : make_uint4(0, 0, 0, 0);
"""
LOAD_PLAIN = LOAD_ROW.replace("ld_row(x + ", "*reinterpret_cast<const uint4*>(x + ").replace(
    "ld_row(dy + ", "*reinterpret_cast<const uint4*>(dy + ")
JOINERS = "constexpr int kJoiners = 32;"
AHEAD = "  constexpr int kAhead = 1;\n"
BOUNDS = "__launch_bounds__(kBwdThreads, 1)"
SMEM = "  const int smem = kBwdThreads / L * D * 4;  // the groups' rows of dscale partials\n"
K3B_HEAD = "constexpr int kBwdThreads = 256;"

# register prefetch (from the load lambda to the block's join) -> a ring of
# shared-memory stages a row group, filled by 1-D bulk copies that the
# group's first lane issues, one mbarrier a stage
PREFETCH = ("  // step s's chunks of x and dy (zeros past the group's rows or the row)\n", JOIN_HEAD)
RING_HELPERS = """constexpr int kRingSmem = 220 << 10;  // a block's dynamic shared memory, at most
// the stages of a group's ring: kRingStages, fewer where the shared memory
// left by the groups' partials is short (0: none fits)
__host__ __device__ inline int ring_stages(int D, int G, int esize) {
  const int fit = (kRingSmem - G * D * 4) / (G * (2 * D * esize + 8));
  return fit < kRingStages ? fit : kRingStages;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
      " selp.u32 %0, 1, 0, p;\\n}\\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const unsigned long long t0 = global_ns();
  for (uint32_t n = 1; !mbar_try_wait(addr, parity); ++n)
    if (n % 1024 == 0 && global_ns() - t0 > kHangNs) __trap();
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
"""
RING = """  // the group's ring: `stages` stages of one row of x and one of dy, then
  // one mbarrier a stage
  const int stages = ring_stages(D, G, sizeof(T));
  const size_t row_bytes = static_cast<size_t>(D) * sizeof(T);
  unsigned char* ring = smem + static_cast<size_t>(G) * D * 4;
  T* mine = reinterpret_cast<T*>(ring + static_cast<size_t>(g) * stages * 2 * row_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + static_cast<size_t>(G) * stages * 2 *
                                               row_bytes) + g * stages;
  for (int i = tid; i < G * stages; i += kBwdThreads) {
    mbar_init(full - g * stages + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int s) {  // the group's first lane fills step s's stage
    if (li != 0 || s >= steps || s * G + g >= n) return;
    T* st = mine + static_cast<size_t>(s % stages) * 2 * D;
    const size_t at = static_cast<size_t>(start + s * G + g) * D;
    mbar_expect_tx(&full[s % stages], static_cast<uint32_t>(2 * row_bytes));
    bulk_copy(st, x + at, static_cast<uint32_t>(row_bytes), &full[s % stages]);
    bulk_copy(st + D, dy + at, static_cast<uint32_t>(row_bytes), &full[s % stages]);
  };
  for (int s = 0; s < stages; ++s) issue(s);
  uint32_t xw[kC][4], gw[kC][4];
  for (int s = 0; s < steps; ++s) {
    // step s - 1's stage is free: every lane of the group has passed that
    // row's sums (its shuffles, or for L > 32 its barrier)
    if (s > 0) issue(s - 1 + stages);
    const bool live = s * G + g < n;
    if (live) mbar_wait(&full[s % stages], (s / stages) & 1);
    const T* st = mine + static_cast<size_t>(s % stages) * 2 * D;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = li + i * L;
      const bool ok = live && c < C;
      const uint4 a = ok ? *reinterpret_cast<const uint4*>(st + c * E) : make_uint4(0, 0, 0, 0);
      const uint4 d = ok ? *reinterpret_cast<const uint4*>(st + D + c * E) : make_uint4(0, 0, 0, 0);
      xw[i][0] = a.x, xw[i][1] = a.y, xw[i][2] = a.z, xw[i][3] = a.w;
      gw[i][0] = d.x, gw[i][1] = d.y, gw[i][2] = d.z, gw[i][3] = d.w;
    }
    row(xw, gw, s);
  }

""" + JOIN_HEAD
RING_SMEM = """  const int G = kBwdThreads / L, stages = ring_stages(D, G, sizeof(T));
  if (stages < 1) return cudaErrorInvalidValue;
  const int smem = G * D * 4 + G * stages * (2 * D * static_cast<int>(sizeof(T)) + 8);
"""


def ring(stages: int) -> list:
    return [(K3B_HEAD, f"constexpr int kRingStages = {stages};\n" + RING_HELPERS + K3B_HEAD),
            (PREFETCH, RING), (SMEM, RING_SMEM)]


# the block's row of partials -> a cluster's rows, summed over its ranks in
# order through distributed shared memory into one row
BLOCK_ROW = ("  float4* part = reinterpret_cast<float4*>(partial);\n",
             "  const int n_part = gridDim.x;  // rows of partials\n")
CLUSTER_ROW = """  float4* part = reinterpret_cast<float4*>(partial);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  float4* own = join + G * D4;
  for (int d = tid; d < D4; d += kBwdThreads) {
    float4 s = join[d];
    for (int h = 1; h < G; ++h) add4(s, join[h * D4 + d]);
    own[d] = s;
  }
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int share = (D4 + kCluster - 1) / kCluster;
  for (int d = rank * share + tid; d < min(D4, (rank + 1) * share); d += kBwdThreads) {
    float4 s = *cluster.map_shared_rank(own + d, 0);
    for (int k = 1; k < kCluster; ++k) add4(s, *cluster.map_shared_rank(own + d, k));
    part[static_cast<size_t>(b / kCluster) * D4 + d] = s;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
  const int n_part = gridDim.x / kCluster;  // rows of partials
"""


def cluster(n: int) -> list:
    return [("#include <cstdint>\n", "#include <cstdint>\n\n#include <cooperative_groups.h>\n"),
            (K3B_HEAD, f"constexpr int kCluster = {n};\n" + K3B_HEAD),
            (BOUNDS, BOUNDS + " __cluster_dims__(kCluster, 1, 1)"), (BLOCK_ROW, CLUSTER_ROW),
            (SMEM, SMEM.replace("kBwdThreads / L * D", "(kBwdThreads / L + 1) * D"))]


# name: (text substitutions, launch options); the first is the committed
# source.  A substitution (old, new) replaces old, which must occur once; a
# pair old = (first, last) replaces the text from first through last.
VARIANTS = {
    "committed (register prefetch, 32 joiners, L2 256-byte hint, one fence)": ([], {}),
    "1 joiner (the last block sums every row)": ([(JOINERS, JOINERS.replace("32", "1"))], {}),
    "4 joiners": ([(JOINERS, JOINERS.replace("32", "4"))], {}),
    "16 joiners": ([(JOINERS, JOINERS.replace("32", "16"))], {}),
    "prefetch 2 rows ahead": ([(AHEAD, "  constexpr int kAhead = kC == 8 ? 1 : 2;  // f32 at 8 "
                                       "chunks a lane: no room for more\n")], {}),
    "a fence in every thread": ([(FENCE_ONE, FENCE_ALL)], {}),
    "dx stored with evict-first (st.global.cs)": ([(DX_STORE, DX_STORE_CS)], {}),
    "plain loads (no L2 256-byte prefetch hint)": ([(LOAD_ROW, LOAD_PLAIN)], {}),
    "bulk-copy ring, 4 stages": (ring(4), {}),
    "bulk-copy ring, 2 stages": (ring(2), {}),
    "cluster join of 2": (cluster(2), {"cluster": 2}),
    "cluster join of 4": (cluster(4), {"cluster": 4}),
    "2 blocks an SM": ([(BOUNDS, BOUNDS.replace(", 1)", ", 2)"))], {"blocks_per_sm": 2}),
    "no dx stores": ([(DX_STORE, "      if ((o[0] ^ o[1] ^ o[2] ^ o[3]) == 0x7fc17fc1u) "
                                 "dr[c * E] = T();  // no dx stores\n")], {}),
    "no dscale join": ([(JOIN_HEAD, KEEP_DSC + JOIN_HEAD)], {}),
    "the join up to the ticket only": ([(JOINERS_GO, "  return;\n")], {}),
    "the join without its fence": ([(FENCE_ONE, FENCE_ONE.replace("    __threadfence();\n",
                                                                   ""))], {}),
    "rows' loads only": ([(ROW_HEAD, ROW_HEAD.replace(
        "    float ss = 0.f, sgx = 0.f;\n",
        "    for (int i = 0; i < kC; ++i)\n      for (int w = 0; w < 4; ++w) sink ^= xw[i][w] ^ "
        "gw[i][w];\n    return;\n    float ss = 0.f, sgx = 0.f;\n").replace(
        "  auto row", "  uint32_t sink = 0u;\n  auto row")),
        (JOIN_HEAD, "  if (sink == 0x9e3779b9u) dscale[0] = 0.f;\n  return;\n" + JOIN_HEAD)], {}),
}
# diagnostics, not designs: their outputs are wrong by construction
DIAGNOSTIC = ("no dx stores", "no dscale join", "the join up to the ticket only",
              "the join without its fence", "rows' loads only")
# the previous design with its second kernel's launch dropped: rmsnorm_bwd_rows alone
V1_DSCALE = """  rmsnorm_bwd_dscale<<<(D + 127) / 128, 128, 0, st>>>(partial, dscale, grid, D);
  return cudaGetLastError();"""
BUILDS = {**VARIANTS, "previous design, rmsnorm_bwd_rows only": (
    [(V1_DSCALE, "  return cudaSuccess;")], {})}
LIB_NOTE = "F.rms_norm forward + backward, less its forward"
# timed again with L2 emptied by a read instead of a write
READ_FLUSH = ("previous design (memset + rmsnorm_bwd_rows + rmsnorm_bwd_dscale)",
              "committed wrapper (rmsnorm.rmsnorm_bwd)", "no dx stores", "no dscale join",
              "the join up to the ticket only", "the join without its fence", "rows' loads only")


def substitute(src: str, edits: list) -> str:
    """``src`` with each edit applied; an edit's text must occur once."""
    for old, new in edits:
        if isinstance(old, tuple):
            first, last = old
            if src.count(first) != 1 or src.count(last) != 1:
                raise SystemExit(f"k3b_variants: region no longer matches: {first[:60]!r}")
            i, j = src.index(first), src.index(last) + len(last)
            src = src[:i] + new + src[j:]
        else:
            if src.count(old) != 1:
                raise SystemExit(f"k3b_variants: substitution no longer matches: {old[:60]!r}")
            src = src.replace(old, new)
    return src


def ptxas_report(log: str, kernel: str) -> list[dict]:
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'")[0]
        if kernel not in name:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out.append({"kernel": name, "registers": int(regs.group(1)) if regs else 0,
                    "spill_bytes": int(spill.group(1)) if spill else 0})
    return out


def build_all(names: list[str], out: Path) -> dict[str, tuple[Path, str]]:
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "rmsnorm.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        cu = out / f"v{i}.cu"
        cu.write_text(substitute(text, BUILDS[name][0]))
        lib = out / f"v{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k3b_variants: {name}: nvcc exit {proc.returncode}\n{log}")
        built[name] = (lib, log)
    return built


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="build and check every design; no timing")
    ap.add_argument("--out", type=Path, default=None, help="write the record here as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3b_variants: torch.cuda.is_available() is False: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import rmsnorm as k3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    n_sm = _build.sm_count(0)
    record: dict = {"card": smi, "variants": {}}

    t0 = time.time()
    _build.build(["rmsnorm"])
    names = [n for n in BUILDS if not (args.check and n in DIAGNOSTIC)]
    built = build_all(names, ROOT / "build" / "k3b_variants")
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    entries = {}
    for name, (path, log) in built.items():
        rep = ptxas_report(log, "rmsnorm_bwd_fused" if name in VARIANTS else "rmsnorm_bwd_rows")
        for line in log.splitlines():
            if "error" in line or "warning" in line and "declared but never" not in line:
                print(f"  {name}: {line.strip()}", flush=True)
        for r in rep:
            print(f"  {name}: {r['kernel'][:70]}: {r['registers']} registers, "
                  f"{r['spill_bytes']} bytes spilled", flush=True)
        record["variants"][name] = {"ptxas": rep, "spills": any(r["spill_bytes"] for r in rep)}
        lib = ctypes.CDLL(str(path))
        fn = lib.rmsnorm_bwd if name in VARIANTS else lib.rmsnorm_bwd_v1
        n_ptr, n_int = (7, 6) if name in VARIANTS else (6, 5)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float,
                                                                            ctypes.c_void_p]
        entries[name] = fn
    # each build's ticket counters: a diagnostic may leave its own off 0
    count = {name: torch.zeros(2, dtype=torch.int32, device=dev) for name in VARIANTS}

    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(rows, D, dtype):
        x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
        s = torch.randn(D, generator=gen, device=dev) * 0.1
        dy = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
        return x, s, dy

    def plan(name, rows, D, itemsize):
        """(lanes, chunks, grid, rows of partials) of build ``name``'s launch."""
        opts = BUILDS[name][1]
        p = k3.bwd_plan(rows, D, itemsize, opts.get("blocks_per_sm", 1) * n_sm)
        n = opts.get("cluster", 1)
        grid = max(n, p.grid // n * n)
        return p.lanes, p.chunks, grid, grid // n

    def outputs(name, x):
        """dx, dscale (NaN-filled) and the scratch of build ``name``'s launch."""
        rows, D = x.shape
        n_part = plan(name, rows, D, x.element_size())[3]
        return (torch.full_like(x, float("nan")), torch.full((D,), float("nan"), device=dev),
                torch.empty((n_part, D), dtype=torch.float32, device=dev))

    def run(name, x, s, dy, out=None):
        """One call of build ``name``'s new entry with the launch it was
        built for, into ``out`` (dx, dscale, scratch) or new NaN-filled
        outputs."""
        rows, D = x.shape
        lanes, chunks, grid, _ = plan(name, rows, D, x.element_size())
        dx, dscale, partial = out or outputs(name, x)
        err = entries[name](x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                            partial.data_ptr(), dscale.data_ptr(), count[name].data_ptr(),
                            _build.DTYPE_CODES[x.dtype], rows, D, lanes, chunks, grid, 1e-6,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at {tuple(x.shape)}")
        return dx, dscale

    # -- checks --------------------------------------------------------------
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for rows, D in CHECKS:
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).removeprefix("torch.")
            x, s, dy = inputs(rows, D, dt)
            want = ref.rmsnorm_bwd_ref(x, s, dy)
            for name in VARIANTS:
                if name in DIAGNOSTIC:
                    continue
                got, again = run(name, x, s, dy), run(name, x, s, dy)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                rel = max(float((g.float() - w.float()).abs().max())
                          / max(float(w.float().abs().max()), 1e-30) for g, w in zip(got, want))
                ok = same and rel <= TOL[dn] and all(bool(torch.isfinite(g).all()) for g in got)
                worst[dn] = max(worst[dn], rel)
                record["variants"][name].setdefault("checks", []).append(
                    {"rows": rows, "D": D, "dtype": dn, "max_rel_err": rel, "rerun_equal": same,
                     "ok": ok})
                if not ok:
                    print(f"  check {name} ({rows}, {D}) {dn}: max_rel_err {rel:.3e} rerun_equal "
                          f"{same} FAIL", flush=True)
                    raise SystemExit(f"k3b_variants: {name} ({rows}, {D}) {dn} disagrees")
    for name in VARIANTS:
        if name not in DIAGNOSTIC:
            n = len(record["variants"][name]["checks"])
            print(f"  check {name}: {n} cases ok, reruns bitwise equal", flush=True)
    print(f"  worst max_rel_err: {json.dumps(worst)}", flush=True)
    record["worst_rel_err"] = worst
    if args.check:
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(record, indent=1))
        print(json.dumps({"ok": True, "worst_rel_err": worst}), flush=True)
        return

    # -- timing at the training shape -----------------------------------------
    rows, D = TRAIN
    x, s, dy = inputs(rows, D, torch.bfloat16)
    xg, wg = x.clone().requires_grad_(), (1.0 + s).to(torch.bfloat16).requires_grad_()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters: int = 50, clear=flush.zero_) -> float:
        for _ in range(3):
            fn()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        for a, b in evs:
            clear()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in evs) / iters

    def lib_fwd():
        with torch.no_grad():
            F.rms_norm(xg, (D,), wg, 1e-6)

    def lib_fwd_bwd():
        torch.autograd.grad(F.rms_norm(xg, (D,), wg, 1e-6), (xg, wg), dy)

    v1_warps, v1_grid = k3.previous_bwd_launch(rows, D, n_sm)
    v1_dx, v1_partial = torch.empty_like(x), torch.empty((v1_grid, D), device=dev)
    v1_dscale = torch.zeros(D, device=dev)

    def v1_rows_only():
        err = entries["previous design, rmsnorm_bwd_rows only"](
            x.data_ptr(), s.data_ptr(), dy.data_ptr(), v1_dx.data_ptr(), v1_partial.data_ptr(),
            v1_dscale.data_ptr(), 1, rows, D, v1_warps, v1_grid, 1e-6,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rmsnorm_bwd_v1 rows only: CUDA error {err}")

    runs = [("F.rms_norm backward", None),
            ("previous design (memset + rmsnorm_bwd_rows + rmsnorm_bwd_dscale)",
             lambda: k3.previous_bwd(x, s, dy)),
            ("previous design: its memset of dscale alone",
             lambda: torch.zeros(D, dtype=torch.float32, device=dev)),
            ("previous design: rmsnorm_bwd_rows alone", v1_rows_only),
            ("committed wrapper (rmsnorm.rmsnorm_bwd)", lambda: k3.rmsnorm_bwd(x, s, dy))]
    runs += [(name, lambda name=name, out=outputs(name, x): run(name, x, s, dy, out))
             for name in VARIANTS]
    times: dict[str, list[float]] = {}
    for turn in (runs, runs[::-1]):
        for name, fn in turn:
            t = time_ms(lib_fwd_bwd) - time_ms(lib_fwd) if fn is None else time_ms(fn)
            times.setdefault(name, []).append(t)
    n_bytes = 3 * rows * D * 2 + 2 * D * 4  # x, dy read and dx written once; scale, dscale
    bound = 1e3 * n_bytes / 3.35e12
    record["timing"] = {"shape": f"({rows}, {D}) bf16", "card": smi, "bound_ms": bound,
                        "library": LIB_NOTE, "ms": times}
    print(f"timing at ({rows}, {D}) bf16, L2 flushed, two turns, on {smi}; bound {bound:.5f} ms "
          f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s):", flush=True)
    for name, ts in times.items():
        mean = sum(ts) / len(ts)
        print(f"  {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms, {bound / mean:.0%} of the "
              f"bound's rate, {n_bytes / (mean * 1e-3) / 1e12:.2f} TB/s", flush=True)
    # the kernels one call launches, by name and device time
    split = {}
    for label, fn in (("committed wrapper", lambda: k3.rmsnorm_bwd(x, s, dy)),
                      ("previous design", lambda: k3.previous_bwd(x, s, dy))):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    acc_events=True) as prof:
            for _ in range(10):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        split[label] = {e.key[:100]: e.device_time_total / 10 / 1e3 for e in prof.key_averages()
                        if e.device_time_total > 0 and "unsigned char" not in e.key}
        print(f"  {label}, kernels a call (ms, torch.profiler, flush excluded): "
              f"{json.dumps(split[label])}", flush=True)
    record["timing"]["kernels"] = split
    # the same with L2 emptied by reading 64 MB instead of writing it: the
    # zero_ flush leaves L2 full of dirty lines, which the timed call then
    # writes back to device memory beside its own traffic
    flush_f32 = flush.view(torch.float32)
    reread: dict[str, list[float]] = {}
    picked = [r for r in runs if r[1] is not None and r[0] in READ_FLUSH]
    for turn in (picked, picked[::-1]):
        for name, fn in turn:
            reread.setdefault(name, []).append(time_ms(fn, clear=lambda: flush_f32.sum()))
    record["timing"]["read_flush_ms"] = reread
    print("  with L2 emptied by a 64 MB read instead of a write:", flush=True)
    for name, ts in reread.items():
        print(f"    {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": True, "ms": {n: sum(t) / len(t) for n, t in times.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
