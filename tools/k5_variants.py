#!/usr/bin/env python3
"""Design variants of K5's kernel (``mamba_scan_ring``), timed on one card.

    python3 tools/k5_variants.py [--out PATH]

Builds copies of ``src/repro_torch/kernels/csrc/mamba_scan.cu``, each with
one design choice changed by text substitutions on the source (a
substitution that no longer matches fails the run), holds each against the
serial oracle ``ref.mamba_scan_ref`` in f32 and bf16 at a shape ragged
against every tile (DI = 72 past 32- and 64-channel tiles, T = 70 past the
4- and 8-step groups and the 16- to 64-step stages), and times each at jamba's
served prefill (1, 512, 16384, 16) and at batch 8, x / dt / B / C in bf16,
A, D and the state in f32: device time per call, L2 flushed before each
call, in turns (the committed kernel first and again last).  ``4 values a
lane`` is the layout first designed (4 lanes a channel at N = 16), kept as a
variant so that the choice can be measured again.  Two variants
are diagnostics, not designs, each with a part of the work taken out
(their outputs are wrong by construction): ``no exponentials`` (every
decay 1) and ``no shuffles`` (the C·h sums are not exchanged between a
channel's lanes).  Needs one CUDA card and ``nvcc``; the copies build into
``build/k5_variants/``.
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
SHAPES = {"prefill (1, 512, 16384, 16)": 1, "batch 8 (8, 512, 16384, 16)": 8}
T, DI, N = 512, 16384, 16
CHECK = (2, 70, 72, 16)  # B, T, DI, N

SMEM = "  static constexpr int kSmem = kStages * kSlot + kCvt;"
VARIANTS = {
    "committed": [],
    "1 step a group": [("constexpr int kS = 8;", "constexpr int kS = 1;")],
    "4 steps a group": [("constexpr int kS = 8;", "constexpr int kS = 4;")],
    # the layout first designed: 4 state values a lane, so 4 lanes a channel at N = 16
    "4 values a lane": [("constexpr int kMaxVPL = 8;", "constexpr int kMaxVPL = 4;")],
    "3-stage ring": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # 40 KB more shared memory a block (64 KB in bf16): 3 fit an SM's 227 KB, not 4
    "3 blocks an SM": [(SMEM, SMEM[:-1] + " + 40960;")],
    "no exponentials": [('  float y;\n  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
                         "  return y;", "  return 1.f;")],
    "no shuffles": [("__shfl_xor_sync(0xffffffffu, send, 1 << L)", "send"),
                    ("acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1 << l);",
                     "acc[i] += acc[i];")],
}
DIAGNOSTIC = ("no exponentials", "no shuffles")
VALUES = {"4 values a lane": 4}  # state values a lane, where a variant changes mamba_plan's


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"k5_variants: substitution no longer matches: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(out: Path) -> dict[str, ctypes.CDLL]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = (_build.CSRC / "mamba_scan.cu").read_text()
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
            raise SystemExit(f"k5_variants: {name} did not build\n{log[-4000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"  {name}: registers per instance {regs}, spill stores {spills}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.mamba_scan_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.mamba_scan_fwd.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the results here, as JSON")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("k5_variants: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import mamba_scan as k5

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.time()
    libs = build(ROOT / "build" / "k5_variants")
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(B, T_, DI_, N_, dt):
        """x, dt, A, Bm, C, D, state: chip_smoke.py's "mixed" law."""
        return (randn(B, T_, DI_).to(dt), F.softplus(randn(B, T_, DI_)).to(dt),
                -torch.exp(randn(DI_, N_) * 0.3), randn(B, T_, N_).to(dt),
                randn(B, T_, N_).to(dt), randn(DI_), randn(B, DI_, N_) * 0.1)

    def runner(name, x):
        B, T_, DI_ = x[0].shape
        N_ = x[2].shape[1]
        y = torch.full_like(x[0], float("nan"))
        s_out = torch.full_like(x[6], float("nan"))
        p = k5.mamba_plan(B, DI_, N_, x[0].element_size(), n_sm)
        ct, steps = p.channels, p.steps
        if name in VALUES:  # the tile the variant's source fixes, as mamba_plan derives it
            ct = k5.THREADS // (N_ // min(N_, VALUES[name]))
            steps = k5.STAGE_BYTES // (ct * x[0].element_size())
        lib = libs[name]

        def go():
            err = lib.mamba_scan_fwd(*(t.data_ptr() for t in x), y.data_ptr(), s_out.data_ptr(),
                                     _build.DTYPE_CODES[x[0].dtype], B, T_, DI_, N_, ct, steps,
                                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(lib.repro_cuda_error_string(err).decode())
            return y, s_out
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
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = inputs(*CHECK, dt)
        want = ref.mamba_scan_ref(*x)
        for name in libs:
            got = runner(name, x)()
            rel = max(float((g.float() - w_.float()).abs().max() / w_.float().abs().max())
                      for g, w_ in zip(got, want))
            ok = rel <= tol
            record["check"][f"{name} {dt}"] = rel
            print(f"  {name} {dt}: max_rel_err {rel:.3e} at {CHECK} (tol {tol:.0e}, "
                  f"{'ok' if ok else 'wrong'})", flush=True)
            if not ok and name not in DIAGNOSTIC:
                raise SystemExit(f"k5_variants: {name} disagrees with the serial oracle")
    for label, B in SHAPES.items():
        x = inputs(B, T, DI, N, torch.bfloat16)
        n_el = B * T * DI * N
        n_bytes = sum(t.numel() * t.element_size() for t in x) + x[0].numel() * 2 + \
            x[6].numel() * 4
        exp_per_s = 16 * n_sm * 1.98e9  # the SFUs at the card's 1980 MHz top SM clock
        row = {name: time_ms(runner(name, x)) for name in libs}
        row["committed again"] = time_ms(runner("committed", x))
        row["bound"] = 1e3 * max(n_bytes / 3.35e12, n_el / exp_per_s)
        record["ms"][label] = row
        print(f"{label}:", flush=True)
        for name, t in row.items():
            print(f"  {name}: {t:.4f} ms", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
