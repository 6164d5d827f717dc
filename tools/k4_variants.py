#!/usr/bin/env python3
"""Design variants of K4's bf16 kernel (``gmm_mma``), timed on one card.

    python3 tools/k4_variants.py [--out PATH]

Builds copies of ``src/repro_torch/kernels/csrc/moe_gmm.cu``, each with one
design choice changed by text substitutions on the source (a substitution
that no longer matches fails the run), holds each against the plain version
at a ragged shape, and times each at the four served K4 shapes beside the
kernel as committed and ``torch.bmm``: device time per call, L2 flushed
before each call, in turns (``torch.bmm``, the variants, ``torch.bmm``).
Two variants are diagnostics, not designs: ``no mma`` drops the products
(its output is wrong by construction) and ``no x reads`` zero-fills the x
tiles instead of reading them.  Needs one CUDA card and ``nvcc``; the
copies build into ``build/k4_variants/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {  # (E, C, D, F): the w1 / w3 products of the served paths
    "jamba prefill": (16, 80, 8192, 24576), "jamba decode": (16, 8, 8192, 24576),
    "deepseek prefill": (64, 64, 2048, 1408), "deepseek decode": (64, 8, 2048, 1408),
}
CHECK = (16, 80, 8200, 1416)  # ragged against the 64-deep stages and every F tile width

PIPELINED = "    pipelined<(kMmaBK / 16) * kPer>("
PIPELINED_END = "        });\n  }\n\n  // c0, c1"
# each mma right behind the ldmatrix of its A fragment
UNPIPELINED = '''#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        ldmatrix_x4_trans(b[q], smem_addr(ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kWRow +
                                          warp * WN + q * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(xs + (mt * 16 + (lane & 15)) * kXRow + kk + (lane >> 4) * 8));
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          mma_bf16(acc[mt][2 * q], a, b[q][0], b[q][1]);
          mma_bf16(acc[mt][2 * q + 1], a, b[q][2], b[q][3]);
        }
      }
    }
  }

  // c0, c1'''


def narrow(bn: int, min_blocks: int) -> list[tuple[str, str]]:
    """BN columns a block in warps of 16 columns, min_blocks blocks per SM."""
    return [("constexpr int kMmaBN = 256;", f"constexpr int kMmaBN = {bn};"),
            ("constexpr int kMmaWN = 32;", "constexpr int kMmaWN = 16;"),
            ("__launch_bounds__(kMmaThreads)", f"__launch_bounds__(kMmaThreads, {min_blocks})")]


def unpipelined(src: str) -> str:
    i, j = src.index(PIPELINED), src.index(PIPELINED_END)
    return src[:i] + UNPIPELINED + src[j + len(PIPELINED_END):]


# after unpipelined: skip the row tiles wholly past C with a (warp-uniform)
# branch, which cuts each 16-deep step into basic blocks
BREAK_PAST_C = ("        uint32_t a[4];\n        ldmatrix_x4(a,",
                "        if (mt * 16 >= rows) break;\n        uint32_t a[4];\n        ldmatrix_x4(a,")


VARIANTS = {
    "committed": [],
    "3 stages": [("constexpr int kMmaStages = 4;", "constexpr int kMmaStages = 3;")],
    "BN 128, 2 blocks/SM": narrow(128, 2),
    "BN 64, 4 blocks/SM": narrow(64, 4),
    "not pipelined": [unpipelined],
    "not pipelined, break past C": [unpipelined, BREAK_PAST_C],
    "BN 128, 2 blocks/SM, not pipelined": narrow(128, 2) + [unpipelined],
    "BN 128, 2 blocks/SM, not pipelined, break past C": narrow(128, 2) + [unpipelined, BREAK_PAST_C],
    "no mma": [("          mma_bf16(acc[f - NQ][2 * q], r, b[q][0], b[q][1]);\n"
                "              mma_bf16(acc[f - NQ][2 * q + 1], r, b[q][2], b[q][3]);",
                "          (void)r;")],
    "no x reads": [("const bool ok = r < rows && k0 + c < D;", "const bool ok = false;")],
}
DIAGNOSTIC = ("no mma", "no x reads")


def variant_source(src: str, edits) -> str:
    for edit in edits:
        if callable(edit):
            src = edit(src)
            continue
        old, new = edit
        if old not in src:
            raise SystemExit(f"k4_variants: substitution no longer matches: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(out: Path) -> dict[str, ctypes.CDLL]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = (_build.CSRC / "moe_gmm.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(variant_source(src, edits))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out / f"v{i}.so"), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out / f"v{i}.so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k4_variants: {name} did not build\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.moe_gmm_mma_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.moe_gmm_mma_fwd.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the results here, as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import moe_gmm as k4
    from repro_torch.kernels import ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.time()
    libs = build(ROOT / "build" / "k4_variants")
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(E, C, D, F):
        x = torch.randn((E, C, D), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((E, D, F), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        return x, w

    def runner(lib, x, w, out):
        E, C, D = x.shape
        p = k4.tile_plan(E, C, w.shape[2])

        def go():
            err = lib.moe_gmm_mma_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), 0, E, C, D,
                                      w.shape[2], p.row_tiles, p.row_blocks,
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(lib.repro_cuda_error_string(err).decode())
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
    x, w = operands(*CHECK)
    want = ref.gmm_ref(x, w).float()
    for name, lib in libs.items():
        out = torch.empty(CHECK[0], CHECK[1], CHECK[3], dtype=torch.bfloat16, device=dev)
        runner(lib, x, w, out)()
        err = float((out.float() - want).abs().max())
        ok = bool(torch.allclose(out.float(), want, atol=2e-2, rtol=2e-2))
        record["check"][name] = err
        print(f"  {name}: max_abs_err {err:.3e} at {CHECK} ({'ok' if ok else 'wrong'})", flush=True)
        if not ok and name not in DIAGNOSTIC:
            raise SystemExit(f"k4_variants: {name} disagrees with the plain version")
    for label, (E, C, D, F) in SHAPES.items():
        x, w = operands(E, C, D, F)
        out = torch.empty(E, C, F, dtype=torch.bfloat16, device=dev)
        row = {"torch.bmm": time_ms(lambda: torch.bmm(x, w))}
        for name, lib in libs.items():
            row[name] = time_ms(runner(lib, x, w, out))
        row["torch.bmm again"] = time_ms(lambda: torch.bmm(x, w))
        row["bound"] = 2 * (x.numel() + w.numel() + out.numel()) / 3.35e12 * 1e3
        record["ms"][f"{label} {(E, C, D, F)}"] = row
        print(f"{label} ({E},{C},{D})@({E},{D},{F}):", flush=True)
        for name, t in row.items():
            print(f"  {name}: {t:.4f} ms", flush=True)
        del x, w, out
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
