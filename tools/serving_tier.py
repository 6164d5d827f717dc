"""Phase 9 of ``chip_smoke.py`` alone on the card (the fleet daemon, the
router over two real replicas, a warm-started replica, a SIGKILL and the
stitched trace), and the compiled prefill's times per dispatch tier.

    python3 tools/serving_tier.py [--prefill-tiers] [--keep-going] [--record PATH]

It builds the kernels first (the replicas then load them, not compile
them).  ``--prefill-tiers`` first times each tier's captured prefill graph
at the phase's prompt lengths, REPS replays a tier in turns, with the
host's clock (the call and ``torch.cuda.synchronize``) and with CUDA events
around it, once on a quiet host and once while eight Python threads take
the GIL in turns, as a replica's HTTP handlers and trace writer do: min /
p50 / max ms per tier and clock.  ``--keep-going`` prints a failed check of the phase
and goes on, so that one run shows every number.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 30


def prefill_tiers(dev, smi: str) -> dict:
    """Per prompt length, tier, host load and clock: min / p50 / max ms of
    the compiled prefill's replay."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.dispatch import host_registry
    from repro_torch.dispatch.dispatcher import with_impl
    from repro_torch.models import lm
    from repro_torch.serving.compiled import Graphs

    cfg = get_config(cs.ARCH)
    params = lm.init_params(cfg, cs.SEED, device=dev)
    graphs = Graphs(dev)
    tiers = host_registry(device=dev).available(dev)
    gen = torch.Generator().manual_seed(cs.SEED)
    busy = threading.Event()
    work = {"spans": [{"t": i * 0.5, "name": f"span{i}", "payload": list(range(20))}
                      for i in range(200)]}

    def burn() -> None:  # Python work that takes the GIL in turns
        while busy.is_set():
            json.dumps(work)

    def stats(xs: list) -> dict:
        return {"min": min(xs), "p50": statistics.median(xs), "max": max(xs)}

    out: dict = {}
    for length in cs.TIER_LENGTHS:
        tokens = torch.randint(0, cfg.vocab_size, (1, length), generator=gen)
        steps = {t.name: graphs.step(with_impl(t.impl, lambda x: lm.prefill(
            params, cfg, x, max_seq=cs.TIER_SEQ))) for t in tiers}
        for step in steps.values():  # eager, then captured and replayed
            step(tokens)
            step(tokens)
        torch.cuda.synchronize()
        row: dict = {}
        for load in ("quiet", "busy"):
            threads = []
            if load == "busy":
                busy.set()
                threads = [threading.Thread(target=burn, daemon=True) for _ in range(8)]
                for t in threads:
                    t.start()
            got = {name: {"host": [], "events": []} for name in steps}
            for _ in range(REPS):
                for name, step in steps.items():
                    start, end = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                    t0 = time.perf_counter()
                    start.record()
                    step(tokens)
                    end.record()
                    torch.cuda.synchronize()
                    got[name]["host"].append((time.perf_counter() - t0) * 1e3)
                    got[name]["events"].append(start.elapsed_time(end))
            busy.clear()
            for t in threads:
                t.join()
            row[load] = {name: {clock: stats(xs) for clock, xs in v.items()}
                         for name, v in got.items()}
        out[length] = row
        print(f"prefill replay ms at {length} tokens, {cs.ARCH}, {REPS} replays a tier, "
              f"{smi}: {json.dumps(row)}", flush=True)
        del steps
    del params, graphs
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prefill-tiers", action="store_true",
                    help="time each tier's compiled prefill at the phase's prompt lengths")
    ap.add_argument("--keep-going", action="store_true",
                    help="print a failed check of the phase and go on")
    ap.add_argument("--record", type=Path, default=None, help="write the record here as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("serving_tier: torch.cuda.is_available() is False: this needs a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as k2
    from repro_torch.kernels import flash_attention as k1
    from repro_torch.kernels import rmsnorm as k3

    t0 = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    _build.build()
    k1._entry()
    k2._entry()
    k3._entry()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    failed: list[str] = []
    if args.keep_going:
        def note(msg: str) -> None:
            failed.append(msg)
            print(f"serving_tier: FAILED {msg}", flush=True)

        cs.fail = note
    rec: dict = {"card": smi}
    if args.prefill_tiers:
        rec["prefill_tiers"] = prefill_tiers(dev, smi)
    rec["serving_tier"] = cs.serving_tier_phase(dev, smi, {})
    rec["failed"] = failed
    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(rec, indent=1, default=str))
    print(f"serving_tier: {time.time() - t0:.1f} s, {len(failed)} failed checks", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
