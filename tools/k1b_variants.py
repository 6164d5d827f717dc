#!/usr/bin/env python3
"""Design variants of K1b's wgmma instance (bf16, head dim 64), timed on one card.

    python3 tools/k1b_variants.py [--check] [--out PATH] [--sass PATH]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu`` once per
design choice (consumer warpgroups a block and ring stages: the source's
``K1B_*`` macros, set by ``-D``; dq's S / dP with A from registers, a
design not committed, and three diagnostics, whose outputs are wrong by
construction, by text substitutions that must match: no exponentials, no
products, no ring loads), prints each build's ptxas report (registers,
spills, wgmma serialisation) and runs no build whose configuration query
refuses it (an entry register count that would leave setmaxnreg
waiting).  Holds each design against
``ref.flash_attention_bwd_ref`` (each gradient relative to its max |.|,
2e-2) at CHECKS, every run twice with bitwise-equal results, with the
persistent plan and with one block per item.  Then times at the training
shape (smollm-360m, (4, 2048, 15/5, 64) bf16 causal), two turns in
opposite orders, L2 flushed before each call: SDPA's backward (forward +
backward less the forward), the mma.sync instance of the previous design
(``flash_bwd_dq_mma`` + ``flash_bwd_dkdv_mma``, reached through
``flash_attention_bwd.cu``'s C entry at D 64), and each build with both
plans; and each build's two passes apart under torch.profiler.
``--check`` builds and checks the committed configuration only; ``--sass``
writes the committed build's SASS and counts its wgmma, barrier and
exponential instructions.  Needs one CUDA card and ``nvcc``; the variant
builds go to ``build/k1b_variants/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN = (4, 2048, 2048, 15, 5)  # B, Sq, Sk, Hq, Hkv at head dim 64
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
    (*TRAIN, True, None, None, 0),
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
# name: (-D flags, text substitutions); the first is the committed configuration
VARIANTS = {
    "committed (2 + 2 warpgroups, 4 stages)": ({}, []),
    "1 + 1 warpgroups, 2 blocks an SM": ({"K1B_DQ_WG": 1, "K1B_DKDV_WG": 1}, []),
    "3 stages": ({"K1B_STAGES": 3}, []),
    "5 stages": ({"K1B_STAGES": 5}, []),
    "dq S / dP with A from registers": ({}, DQ_RS),
    "no exponentials": ({}, [("return ex2(s * a.scale_log2 - lse2);",
                              "return s * a.scale_log2 - lse2;")]),
    "no products": ({}, [("int lo = 0, hi = kr.n;", "int lo = 0, hi = 0;"),
                         ("int lo = 0, hi = qr.n;", "int lo = 0, hi = 0;")]),
    "no ring loads": ({}, [(DQ_RING_LOAD, "          mbar_expect_tx(&sm.full[stage], 0);\n"),
                           (DKDV_RING_LOAD, "            mbar_expect_tx(&sm.full[stage], 0);\n")]),
}
# diagnostics, not designs: their outputs are wrong by construction
DIAGNOSTIC = ("no exponentials", "no products", "no ring loads")
BWD_TOL = 2e-2
SDPA_NOTE = "scaled_dot_product_attention forward + backward, less its forward"


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


def build_variants(names: list[str], out: Path) -> dict[str, tuple[Path, str]]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        defines, edits = VARIANTS[name]
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"k1b_variants: substitution no longer matches: {old[:60]!r}")
            src = src.replace(old, new)  # every occurrence
        cu = out / f"v{i}.cu"
        cu.write_text(src)
        flags = [f"-D{k}={v}" for k, v in defines.items()]
        lib = out / f"v{i}.so"
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
    ap.add_argument("--check", action="store_true",
                    help="build and check the committed configuration only; no timing")
    ap.add_argument("--out", type=Path, default=None, help="write the record here as JSON")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write the committed build's SASS (cuobjdump) here")
    args = ap.parse_args()
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
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    record: dict = {"card": smi, "variants": {}}

    t0 = time.time()
    _build.build(["flash_attention", "flash_attention_bwd"])
    names = list(VARIANTS)[:1] if args.check else list(VARIANTS)
    built = build_variants(names, ROOT / "build" / "k1b_variants")
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
                                "SYNCS", "BAR", "LDS", "STL", "LDL")}
            print(f"  sass {kernel.split()[0][:90]}: {len(ops)} instructions, {count}",
                  flush=True)
    libs = {}
    for name, (path, log) in built.items():
        rep = ptxas_report(log)
        if args.check:
            print(log, flush=True)
        for line in log.splitlines():
            if "Performance" in line or "setmaxnreg" in line or "warning" in line:
                print(f"  {name}: ptxas: {line.strip()}", flush=True)
        for r in rep:
            print(f"  {name}: {r['kernel'][:60]}: {r['registers']} registers, "
                  f"{r['spill_bytes']} bytes spilled, {r['static_smem']} bytes static smem; "
                  f"{r['warnings']}", flush=True)
        record["variants"][name] = {"ptxas": rep,
                                    "spills": any(r["spill_bytes"] for r in rep)}
        lib, fn = k1.sm90_library(ctypes.CDLL(str(path)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        try:  # refuses a build whose entry registers would leave setmaxnreg waiting
            cfg = k1.sm90_config(lib, 0)
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
        k1.sm90_bwd(*lib_fn, q, k, v, out, lse, do, dq, dk, dv, scale=1 / 8.0,
                    persistent=persistent, **kw)
        return dq, dk, dv

    # -- checks --------------------------------------------------------------
    worst = 0.0
    for case in CHECKS:
        B, Sq, Sk, Hq, Hkv, causal, window, cap, qo = case
        q, k, v, do = randn(B, Sq, Hq, 64), randn(B, Sk, Hkv, 64), randn(B, Sk, Hkv, 64), \
            randn(B, Sq, Hq, 64)
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo)
        out, lse = k1.flash_attention(q, k, v, return_lse=True, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        for name, lib_fn in libs.items():
            if name in DIAGNOSTIC:
                continue
            for persistent in (True, False):
                got = run(lib_fn, q, k, v, out, lse, do, persistent=persistent, **kw)
                again = run(lib_fn, q, k, v, out, lse, do, persistent=persistent, **kw)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
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

    # -- timing at the training shape -----------------------------------------
    B, Sq, Sk, Hq, Hkv = TRAIN
    q, k, v, do = randn(B, Sq, Hq, 64), randn(B, Sk, Hkv, 64), randn(B, Sk, Hkv, 64), \
        randn(B, Sq, Hq, 64)
    out, lse = k1.flash_attention(q, k, v, return_lse=True)
    qg, kg, vg = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters: int = 30) -> float:
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

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        torch.autograd.grad(o, (qg, kg, vg), dos)

    old_lib, old_fn = k1._bwd_entry()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def old():
        err = old_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     do.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
                     grads[2].data_ptr(), delta.data_ptr(), 1, B, Sq, Sk, Hq, Hkv, 64, 1, -1,
                     0.0, 1 / 8.0, 0, torch.cuda.current_stream().cuda_stream)
        _build.check(old_lib, err, "flash_attention_bwd (mma.sync)")

    old()
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    old_rel = max(float((g.float() - w.float()).abs().max()) / float(w.float().abs().max())
                  for g, w in zip(grads, want))
    print(f"  check mma.sync instance at the training shape: max_rel_err {old_rel:.3e}",
          flush=True)
    del want
    pairs = B * Hq * (Sq * (Sq + 1) // 2)
    flops5 = 10 * 64 * pairs  # the bound's count: 5 products of 2 D flops a live pair
    times: dict[str, float] = {}
    runs = [("sdpa", None)] + [("mma.sync (flash_bwd_*_mma)", old)] + [
        (f"{name} {'persistent' if p else 'per item'}",
         (lambda lf=lib_fn, p=p: run(lf, q, k, v, out, lse, do, persistent=p, causal=True,
                                     window=None, softcap=None, q_offset=0)))
        for name, lib_fn in libs.items() for p in (True, False)]
    for turn in (runs, runs[::-1]):
        for name, fn in turn:
            if name == "sdpa":
                t = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd)
            else:
                t = time_ms(fn)
            times.setdefault(name, []).append(t)
    record["timing"] = {
        "shape": "B=4 S=2048 Hq=15 Hkv=5 D=64 bf16 causal", "card": smi,
        "bound_ms": 1e3 * flops5 / 989e12, "sdpa_library": SDPA_NOTE,
        "ms": {n: ts for n, ts in times.items()},
    }
    print(f"timing at (4, 2048, 15/5, 64) bf16 causal, L2 flushed, two turns, on {smi}; bound "
          f"{record['timing']['bound_ms']:.4f} ms (5 products at 989 TFLOP/s):", flush=True)
    for name, ts in times.items():
        mean = sum(ts) / len(ts)
        print(f"  {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms, "
              f"{flops5 / (mean * 1e-3) / 1e12:.1f} TFLOP/s on the bound's count, "
              f"{1.4 * flops5 / (mean * 1e-3) / 1e12:.1f} on the 7 products done", flush=True)
    # the two passes apart: device time by kernel name under torch.profiler
    split = {}
    for name, lib_fn in libs.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run(lib_fn, q, k, v, out, lse, do, causal=True, window=None, softcap=None,
                    q_offset=0)
            torch.cuda.synchronize()
        split[name] = {re.search(r"flash_bwd_\w+", e.key).group(0):
                       e.device_time_total / 10 / 1e3
                       for e in prof.key_averages() if "wgmma" in e.key}
        print(f"  {name} persistent, ms a call by kernel: {json.dumps(split[name])}", flush=True)
    record["timing"]["split_ms"] = split
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": True, "ms": {n: sum(t) / len(t) for n, t in times.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
