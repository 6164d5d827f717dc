"""Phase 5 (l) of ``chip_smoke.py`` alone on the card: K4b (the grouped
matmul's backward) against its plain version and timed, deepseek-moe-16b
trained at full width (its f32 gates, bf16 steps eager and compiled, a
replayed step's profile) and ``launch.train --arch deepseek-moe-16b
--reduced``.

    python3 tools/moe_train_phase.py [--record PATH] [--kernels-only]

It builds the kernels first (printing ptxas' report of K4b's instances),
then runs ``chip_smoke.moe_train_phase`` with ``chip_smoke``'s L2-flushed
timing and the card's bounds, and prints the phase's kernel record.
``--kernels-only`` stops after K4b's checks and timing.  Needs one card.
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
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after K4b's checks and timing")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/moe_train_phase.py needs a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    paths = _build.build()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for fn_name, regs, spill in cs.ptxas_instances(
            paths["moe_gmm_bwd"].with_suffix(".log").read_text()):
        print(f"  {fn_name[:80]}: {regs} registers, {spill} bytes spilled", flush=True)
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

    records: dict = {}
    rec = cs.moe_train_phase(dev, smi, records, {"time_ms": time_ms, "bound_ms": bound_ms,
                                                 "peaks": peaks,
                                                 "kernels_only": args.kernels_only})
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(rec, indent=1, default=str))


if __name__ == "__main__":
    main()
