#!/usr/bin/env python3
"""K1b's CUDA-core pair in bf16 at head dim 128, beside the wide pair that replaced it, on one card.

    python3 tools/k1b_cuda_core_bf16.py [--out PATH]

Builds a copy of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` in
which the C entry routes bf16 at D 128 to the CUDA-core pair
(``flash_bwd_dq`` + ``flash_bwd_dkdv``), as the port did before the wide
pair (a text substitution that must match), holds it against
``ref.flash_attention_bwd_ref`` (each gradient relative to its max |.|,
2e-2) at a small shape with window, softcap and q_offset, and times it
beside the committed wrapper (``flash_attention.flash_attention_bwd``, the
wide pair) at gemma2-27b's and chameleon-34b's training shapes, L2 flushed
before each call.  Needs one CUDA card and ``nvcc``; the copy builds into
``build/k1b_cuda_core_bf16/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDE = "        case 128: return launch_wide<128>(BWD_ARGS);\n"
CUDA_CORES = "        case 128: return launch<__nv_bfloat16, 128>(BWD_ARGS);\n"
# (B, Sq, Sk, Hq, Hkv, window, softcap, q_offset) at D 128, causal
CHECK = (1, 100, 300, 16, 2, 37, 30.0, 200)
SHAPES = {"gemma2-27b, softcap 50": (4, 2048, 2048, 32, 16, None, 50.0, 0),
          "chameleon-34b, G 8": (4, 2048, 2048, 64, 8, None, None, 0)}
TOL = 2e-2


def build(out: Path) -> Path:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    if WIDE not in src:
        raise SystemExit(f"k1b_cuda_core_bf16: substitution no longer matches: {WIDE.strip()!r}")
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "cuda_core_bf16.cu", out / "cuda_core_bf16.so"
    cu.write_text(src.replace(WIDE, CUDA_CORES))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"k1b_cuda_core_bf16: nvcc exit {proc.returncode}\n{proc.stderr}")
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="write the record here as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1b_cuda_core_bf16: torch.cuda.is_available() is False: needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as k1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib = ctypes.CDLL(str(build(ROOT / "build" / "k1b_cuda_core_bf16")))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, Sq, Sk, Hq, Hkv, window, softcap, q_offset):
        q, k, v, do = (torch.randn((B, n, h, 128), generator=gen, device=dev).to(torch.bfloat16)
                       for n, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv), (Sq, Hq)))
        kw = dict(window=window, softcap=softcap, q_offset=q_offset)
        out, lse = k1.flash_attention(q, k, v, return_lse=True, **kw)
        return (q, k, v, out, lse, do), kw

    def cuda_cores(q, k, v, out, lse, do, *, window, softcap, q_offset):
        B, Sq, Hq, D = q.shape
        _, Sk, Hkv, _ = k.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 _build.DTYPE_CODES[torch.bfloat16], B, Sq, Sk, Hq, Hkv, D, 1,
                 -1 if window is None else window, float(softcap or 0.0), 1 / math.sqrt(D),
                 q_offset, torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "flash_attention_bwd (CUDA-core pair, bf16 D 128)")
        return dq, dk, dv

    def rel_err(got, want) -> float:
        return max(float((g.float() - w.float()).abs().max()) / float(w.float().abs().max())
                   for g, w in zip(got, want))

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn_, iters: int) -> float:
        fn_()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        torch.cuda.synchronize()
        for s, e in evs:
            flush.zero_()
            s.record()
            fn_()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters

    t, kw = inputs(*CHECK)
    err = rel_err(cuda_cores(*t, **kw), ref.flash_attention_bwd_ref(*t, **kw))
    record = {"card": smi, "check": {"shape": CHECK, "max_rel_err": err, "tol": TOL},
              "shapes": {}}
    print(f"check at {CHECK}: max_rel_err {err:.3e} (tol {TOL})", flush=True)
    if not err <= TOL:
        raise SystemExit("k1b_cuda_core_bf16: the CUDA-core pair disagrees with its plain version")
    for label, shape in SHAPES.items():
        t, kw = inputs(*shape)
        err = rel_err(cuda_cores(*t, **kw), k1.flash_attention_bwd(*t, **kw))
        row = {"shape": shape, "max_rel_err_vs_wide": err,
               "cuda_core_ms": time_ms(lambda: cuda_cores(*t, **kw), 3),
               "wide_ms": time_ms(lambda: k1.flash_attention_bwd(*t, **kw), 10)}
        row["cuda_core_over_wide"] = row["cuda_core_ms"] / row["wide_ms"]
        record["shapes"][label] = row
        print(f"{label}, bf16 D 128, L2 flushed, {smi}: {json.dumps(row)}", flush=True)
        if not err <= TOL:
            raise SystemExit(f"k1b_cuda_core_bf16: at {label} the two pairs disagree ({err:.3e})")
        del t
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
