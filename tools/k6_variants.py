#!/usr/bin/env python3
"""Design variants of K6's kernel (``rwkv6_scan_tiled``), timed on one card.

    python3 tools/k6_variants.py [--out PATH] [--scaling]

Builds copies of ``src/repro_torch/kernels/csrc/rwkv6_scan.cu``, each with
one design choice changed by text substitutions on the source (a
substitution that no longer matches fails the run), holds each against the
serial oracle ``ref.rwkv6_scan_ref`` in f32 and bf16 at a shape ragged
against every tile (V = 72 past 16-column tiles, T = 50 past the stages),
and times each at rwkv6-7b's two timed K6 shapes, (1, 512, 64, 64) and
(8, 128, 64, 64), r / k / v in bf16, w, u and the state in f32: device
time per call, L2 flushed before each call, in turns (the committed kernel
first and again last).  The launch takes the columns per block from
``scan_plan``, as the wrapper does (or from ``COLUMNS``).  Five variants
are diagnostics, not designs, each with a part of the work taken out
(their outputs are wrong by construction): ``no column sums``, ``no state
update``, ``no ring loads`` (the ring is never filled), ``no shuffles``
(the column sums are not exchanged) and ``no output`` (no stores; the
shuffles are kept, and with them all that feeds them).  ``--scaling``
instead times the committed kernel on the same work spread over more warps
(B x T = 512 at B = 1, 2, 4, 8) and reads the SM clock.  Needs one CUDA
card and ``nvcc``; the copies build into ``build/k6_variants/``.
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
SHAPES = {"prefill (1, 512, 64, 64)": (1, 512), "batch 8 (8, 128, 64, 64)": (8, 128)}
H, K = 64, 64
CHECK = (1, 50, 3, 64, 72)  # B, T, H, K, V

FACTORED = '''      float p = 0.f;  // this thread's rows of Σ_k r_k u_k k_k
#pragma unroll
      for (int j = 0; j < kKT; ++j) p = fmaf(rr[j] * kk[j], uk[j], p);
#pragma unroll
      for (int i = 0; i < kVT; ++i) acc[u * kVT + i] = p * vv[i];
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int i = 0; i < kVT; ++i) acc[u * kVT + i] = fmaf(rr[j], s[j][i], acc[u * kVT + i]);
'''
# the bonus inside every element: r (S + u k v), 4 FP operations per element
UNFACTORED = '''#pragma unroll
      for (int i = 0; i < kVT; ++i) acc[u * kVT + i] = 0.f;
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int i = 0; i < kVT; ++i)
          acc[u * kVT + i] = fmaf(rr[j], fmaf(uk[j], kk[j] * vv[i], s[j][i]), acc[u * kVT + i]);
'''

NOT_PIPELINED = '''      column_sums(sl, tt, acc);
      reduce_store(acc, t0 + tt);
    }
  }
'''
# each group's column sums computed before the previous group's are reduced,
# so that the reduction's shuffle chain can overlap independent arithmetic
PIPELINED = (NOT_PIPELINED, '''      column_sums(sl, tt, acc);
      reduce_store(prev, t_prev);
#pragma unroll
      for (int i = 0; i < kN; ++i) prev[i] = acc[i];
      t_prev = t0 + tt;
    }
  }
  reduce_store(prev, t_prev);
''')
PIPELINE_STATE = ("  for (int st = 0; st < n_st; ++st) {\n    cp_async_wait",
                  "  float prev[kN] = {};\n  int t_prev = T_;  // nothing to store yet\n"
                  "  for (int st = 0; st < n_st; ++st) {\n    cp_async_wait")
GROUPS_UNROLLED = ("#pragma unroll 1\n    for (int tt = 0; tt < n; tt += kU) {",
                   "#pragma unroll 2\n    for (int tt = 0; tt < n; tt += kU) {")

# (not pipelined) each group writes its column partial sums to shared
# memory; after the stage's groups, one barrier, and the block reduces them
# (the same adjacent-pair tree as the butterfly) and stores the outputs
SHUFFLES = ("    // reduce-scatter over kg", "  };\n\n  for (int st = 0; st < n_st; ++st) {")
PARTIALS = '''    float* part = reinterpret_cast<float*>(smem + kStages * slot_bytes);
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int i = 0; i < kVT; ++i)
        part[(((t0 + u) % kSteps) * vb + c0 + i) * G + kg] = acc[u * kVT + i];
  };

  for (int st = 0; st < n_st; ++st) {'''
STAGE_END = ("      reduce_store(acc, t0 + tt);\n    }\n",
             '''      reduce_store(acc, t0 + tt);
    }
    __syncthreads();
    const float* part = reinterpret_cast<const float*>(smem + kStages * slot_bytes);
    for (int i = tid; i < n * vb; i += nth) {
      const int c = i % vb;
      if (v0 + c < V)
        out[vbase + static_cast<size_t>(t0 + i / vb) * vrow + v0 + c] =
            from_f32<T>(tree_sum<G>(part + i * G));
    }
''')
TREE_SUM = ("// One slot of the ring:",
            '''// x[0] + ... + x[N - 1] as adjacent pairs, then pairs of pairs, ...
template <int N>
__device__ __forceinline__ float tree_sum(const float* x) {
  if constexpr (N == 1) return x[0];
  else return tree_sum<N / 2>(x) + tree_sum<N / 2>(x + N / 2);
}

// One slot of the ring:''')
SMEM = "vb * static_cast<int>(sizeof(T)));"  # the end of the launch's shared-memory size
PARTIALS_SMEM = (SMEM, SMEM[:-1] + " + kSteps * vb * (K / kKT) * 4;")


# the ring filled by bulk copies: one lane of the first warp a time step,
# four copies (the step's rows of r, k, w and v's columns inside V) counted
# on an mbarrier per slot, which every thread waits on; past T and past V by
# plain stores
BULK_HELPERS = ("// One slot of the ring:",
                """__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\\n" ::"r"(bar), "r"(arrivals) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile("{\\n.reg .pred done;\\nWAIT:\\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\\n"
               "@!done bra WAIT;\\n}\\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One slot of the ring:""")
BULK_FILL = """      if (tid >= 32) return;
      const int vbytes = min(vb, V - v0) * static_cast<int>(sizeof(T));
      const uint32_t bar = smem_addr(bars + st % kStages);
      if (tid == 0) {
        const int nt = min(kSteps, T_ - t0);
        mbar_arrive_expect(bar, nt * (2 * K * static_cast<int>(sizeof(T)) + K * 4 + vbytes));
      }
      __syncwarp();
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      for (int tt = tid; tt < kSteps; tt += 32) {
        const int t = t0 + tt;
        int c = 0;  // v's first column filled by plain stores
        if (t < T_) {
          const size_t off = kbase + static_cast<size_t>(t) * krow;
          bulk_copy(smem_addr(rs + tt * K), r + off, K * sizeof(T), bar);
          bulk_copy(smem_addr(ks + tt * K), k + off, K * sizeof(T), bar);
          bulk_copy(smem_addr(ws + tt * K), w + off, K * 4, bar);
          bulk_copy(smem_addr(vs + tt * vb), v + vbase + static_cast<size_t>(t) * vrow + v0,
                    vbytes, bar);
          c = vbytes / static_cast<int>(sizeof(T));
        } else {
          for (int j = 0; j < K; ++j) {
            rs[tt * K + j] = ks[tt * K + j] = from_f32<T>(0.f);
            ws[tt * K + j] = 1.f;
          }
        }
        for (; c < vb; ++c) vs[tt * vb + c] = from_f32<T>(0.f);
      }
"""
PROLOGUE = "    if (st < n_st) issue(st);\n"
REFILL = "    if (st + kStages - 1 < n_st) issue(st + kStages - 1);\n"
BULK_EDITS = [
    BULK_HELPERS,
    ("  // stage st (steps st * kSteps ..) into ring slot st % kStages\n",
     "  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + kStages * slot_bytes);\n"
     "  // stage st (steps st * kSteps ..) into ring slot st % kStages\n"),
    ("  const int n_st = (T_ + kSteps - 1) / kSteps;\n",
     "  if constexpr (kVec) {\n    if (tid == 0)\n"
     "      for (int i = 0; i < kStages; ++i) mbar_init(smem_addr(bars + i), 1);\n"
     "    __syncthreads();\n  }\n  const int n_st = (T_ + kSteps - 1) / kSteps;\n"),
    ("    cp_async_wait<kStages - 2>();  // this thread's copies of stage st have landed\n",
     "    if constexpr (kVec) mbar_wait(smem_addr(bars + st % kStages), (st / kStages) & 1);\n"),
    (SMEM, SMEM[:-1] + " + kStages * 8;"),
]


def bulk_ring(src: str) -> str:
    i = src.index("      constexpr int kPer = 16 / sizeof(T);")
    j = src.index("    } else {\n      for (int i = tid; i < kSteps * K; i += nth) {", i)
    return variant_source(src[:i] + BULK_FILL + src[j:], BULK_EDITS)


def partials(src: str) -> str:
    i, j = src.index(SHUFFLES[0]), src.index(SHUFFLES[1])
    return src[:i] + PARTIALS + src[j + len(SHUFFLES[1]):]


def steps_reduced(n: int) -> tuple[str, str]:
    return ("constexpr int kU = 8;", f"constexpr int kU = {n};")


NARROW = [("constexpr int kVT = 4;", "constexpr int kVT = 2;"),
          ("constexpr int kMaxThreads = 256;", "constexpr int kMaxThreads = 512;")]
STAGES_16_4 = [("constexpr int kSteps = 32;", "constexpr int kSteps = 16;"),
               ("constexpr int kStages = 3;", "constexpr int kStages = 4;")]
VARIANTS = {
    "committed": [],
    "pipelined": [PIPELINED, PIPELINE_STATE],
    "two groups an iteration": [GROUPS_UNROLLED],
    "1 step a reduction": [steps_reduced(1)],
    "2 steps a reduction": [steps_reduced(2)],
    "4 steps a reduction": [steps_reduced(4)],
    "4 x 2 tiles": NARROW,
    "8 x 4 tiles": [("constexpr int kKT = 4;", "constexpr int kKT = 8;")],
    "16-step stages, 4 deep": STAGES_16_4,
    "16-step stages, 4 deep, pipelined (the previous commit)": STAGES_16_4 + [PIPELINED,
                                                                        PIPELINE_STATE],
    "32-step stages, 2 deep": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "32-step stages, 4 deep": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "bonus not factored": [(FACTORED, UNFACTORED)],
    "bulk-copy ring": [bulk_ring],
    "partial sums in shared memory": [partials, STAGE_END, PARTIALS_SMEM, TREE_SUM],
    "at most 2 blocks an SM": [(SMEM, SMEM[:-1] + " + 40960;")],
    "32 columns a block": [],
    "3 blocks an SM (register cap)": [("__launch_bounds__(kMaxThreads)",
                                        "__launch_bounds__(kMaxThreads, 3)")],
    "no column sums": [("      reduce_store(acc, t0 + tt);\n", "")],
    "no state update": [("s[j][i] = fmaf(ww[j], s[j][i], kk[j] * vv[i]);", "(void)ww[j];")],
    "no ring loads": [(PROLOGUE, ""), (REFILL, "")],
    "no shuffles": [("__shfl_xor_sync(0xffffffffu, send, 1 << L)", "send"),
                    ("acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1 << l);",
                     "acc[i] += acc[i];")],
    "no output": [("&& vc < V)\n        out[", "&& vc < -V)\n        out[")],
}
COLUMNS = {"32 columns a block": 32}  # columns per block in place of scan_plan's
DIAGNOSTIC = ("no column sums", "no state update", "no ring loads", "no shuffles", "no output")


def variant_source(src: str, edits) -> str:
    for edit in edits:
        if callable(edit):
            src = edit(src)
            continue
        old, new = edit
        if old not in src:
            raise SystemExit(f"k6_variants: substitution no longer matches: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(out: Path) -> dict[str, ctypes.CDLL]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = (_build.CSRC / "rwkv6_scan.cu").read_text()
    sources = {name: variant_source(src, edits) for name, edits in VARIANTS.items()}
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out / f"v{i}.so"), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out / f"v{i}.so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k6_variants: {name} did not build\n{log[-4000:]}")
        regs = sorted({int(n) for n in re.findall(r"Used (\d+) registers", log)})
        print(f"  {name}: registers per instance {regs}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.rwkv6_scan_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.rwkv6_scan_fwd.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the results here, as JSON")
    ap.add_argument("--scaling", action="store_true",
                    help="only time the committed kernel at B x T = 512 for B = 1, 2, 4, 8 "
                         "(the same work over more warps)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k6_variants: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import rwkv6_scan as k6

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.time()
    libs = build(ROOT / "build" / "k6_variants")
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(B, T, H_, K_, V_, dt):
        r, k = (randn(B, T, H_, K_) * K_**-0.5 for _ in range(2))
        w = torch.exp(-torch.exp(randn(B, T, H_, K_) * 0.5))
        return (r.to(dt), k.to(dt), randn(B, T, H_, V_).to(dt), w, randn(H_, K_) * 0.5,
                randn(B, H_, K_, V_) * 0.1)

    def runner(lib, x, name=None):
        r, k, v, w, u, s0 = x
        B, T, H_, K_ = r.shape
        V_ = v.shape[-1]
        out = torch.full((B, T, H_, V_), float("nan"), dtype=r.dtype, device=dev)
        s_out = torch.full_like(s0, float("nan"))
        vb = COLUMNS.get(name) or k6.scan_plan(B, H_, K_, V_, n_sm, r.element_size()).vb

        def go():
            err = lib.rwkv6_scan_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                                     u.data_ptr(), s0.data_ptr(), out.data_ptr(),
                                     s_out.data_ptr(), _build.DTYPE_CODES[r.dtype],
                                     _build.DTYPE_CODES[u.dtype], B, T, H_, K_, V_, vb,
                                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(lib.repro_cuda_error_string(err).decode())
            return out, s_out
        return go

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        for s, e in evs:
            flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters

    record = {"card": card, "check": {}, "ms": {}}
    if args.scaling:
        # the SM clock under load: torch.cuda._sleep spins for a number of
        # SM clocks, timed here by events
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        torch.cuda._sleep(100_000_000)
        ev[1].record()
        torch.cuda.synchronize()
        record["sm_mhz"] = 1e8 / ev[0].elapsed_time(ev[1]) / 1e3
        print(f"SM clock under torch.cuda._sleep: {record['sm_mhz']:.0f} MHz", flush=True)
        for B in (1, 2, 4, 8):
            x = inputs(B, 512 // B, H, K, K, torch.bfloat16)
            t = time_ms(runner(libs["committed"], x, "committed"))
            record["ms"][f"({B}, {512 // B}, 64, 64)"] = t
            print(f"committed at ({B}, {512 // B}, 64, 64): {t:.4f} ms", flush=True)
        libs = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = inputs(*CHECK, dt)
        want = ref.rwkv6_scan_ref(*x)
        for name, lib in libs.items():
            got = runner(lib, x, name)()
            rel = max(float((g.float() - w_.float()).abs().max() / w_.float().abs().max())
                      for g, w_ in zip(got, want))
            ok = rel <= tol
            record["check"][f"{name} {dt}"] = rel
            print(f"  {name} {dt}: max_rel_err {rel:.3e} at {CHECK} (tol {tol:.0e}, "
                  f"{'ok' if ok else 'wrong'})", flush=True)
            if not ok and name not in DIAGNOSTIC:
                raise SystemExit(f"k6_variants: {name} disagrees with the serial oracle")
    for label, (B, T) in (SHAPES.items() if libs else ()):
        x = inputs(B, T, H, K, K, torch.bfloat16)
        n_bytes = sum(t.numel() * t.element_size() for t in x) + B * T * H * K * 2 + \
            x[5].numel() * 4
        row = {name: time_ms(runner(lib, x, name)) for name, lib in libs.items()}
        row["committed again"] = time_ms(runner(libs["committed"], x))
        row["bound"] = 1e3 * max(n_bytes / 3.35e12, 4 * B * T * H * K * K / 67e12)
        record["ms"][label] = row
        print(f"{label}:", flush=True)
        for name, t in row.items():
            print(f"  {name}: {t:.4f} ms", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
