"""Phase 11 of ``chip_smoke.py`` alone on the card: K2's stats mode, the
shard combine, the split-KV decode and training on a 1 x 1 mesh, the
dry-run cells and the captured-graph inventory (ROADMAP M13).

    python3 tools/mesh_phase.py [--record PATH]

It builds the kernels first, then runs ``chip_smoke.mesh_phase`` with
``chip_smoke``'s tolerances, its L2-flushed timing and the card's bounds,
and prints the phase's kernel record.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/mesh_phase.py needs a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.build()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    peaks = cs.card_peaks(smi)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        for s, e in evs:
            flush_buf.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters

    def bound_ms(n_bytes, n_flops, peak_flops):
        t_bytes, t_ops = n_bytes / peaks["bytes_per_s"], n_flops / peak_flops
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def hold(kernel, case, got, want, dtype_name, fatal=True):
        err = float((got.float() - want.float()).abs().max())
        tol = cs.TOL[dtype_name]
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        ok = ok and bool(torch.isfinite(got.float()).all())
        print(f"  {kernel} {case}: max_abs_err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok and fatal:
            cs.fail(f"{kernel} {case} disagrees with its plain version")
        return err

    records: dict = {}
    rec = cs.mesh_phase(dev, smi, records, {"time_ms": time_ms, "hold": hold,
                                            "bound_ms": bound_ms, "peaks": peaks})
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "served_shapes"}
                                  for r in records.values()]}), flush=True)
    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(rec, indent=1, default=str))


if __name__ == "__main__":
    main()
