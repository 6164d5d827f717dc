#!/usr/bin/env python3
"""Design variants of K4b's wgmma instances (bf16), timed on one card.

    python3 tools/k4b_variants.py [--check] [--out PATH]

Builds ``src/repro_torch/kernels/csrc/moe_gmm_bwd.cu`` once per design
choice of its wgmma instances (``-D`` of the source's ``K4B_*`` macros:
the consumer warpgroups, 64 output rows each, and the ring stages of the
gated and of the store instances; by text substitutions that must match,
the gated instance's a1 / a3 loads in one burst instead of one box after
each k-tile), plus two diagnostics by substitutions, whose outputs are
wrong by construction: the gated epilogue without its activation (da1 =
dh a3, da3 = dh a1) and without its a1 / a3 loads.  Prints each build's ptxas report (registers,
spills, wgmma serialisation).  Holds each design against the plain
versions (``ref.gmm_gated_dgrad_ref``, ``gmm_dgrad_ref``,
``gmm_wgrad_ref``; each result relative to its max |.|, 1e-2) at CHECKS,
every launch twice with bitwise-equal results.  Then times, at
deepseek-moe-16b's MoE layer (``chip_smoke.K4B_SHAPE``, bf16, L2 flushed
before each call, two turns in opposite orders): the previous design
(``moe_gmm.previous_bwd``), ``torch.bmm`` on the same views, and each
build's (a) gated dgrad, (b) dgrad and (c) wgrad, and (a)'s product alone
through the store instance (the dgrad entry on dy and w2: (a) without its
gated epilogue).  ``--check`` builds and checks the committed design only.
Needs one CUDA card and ``nvcc``; the variant builds go to
``build/k4b_variants/``.
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
# each design: the source's macros (unset ones keep their defaults)
DESIGNS = {
    "committed": {},
    "gated 2 warpgroups, 4 stages": {"K4B_GATED_WG": 2, "K4B_GATED_STAGES": 4},
    "store 3 stages": {"K4B_STORE_STAGES": 3},
    "store 2 warpgroups": {"K4B_STORE_WG": 2},
}
ACT = """      act_and_grad<ACT>(x1.x, y0, g0);
      act_and_grad<ACT>(x1.y, y1, g1);"""
EXPECT = "mbar_expect_tx(&sm.epi_full, kEpiBoxes * kPanelBytes);"
EPI_BOX = """          tma_box3(sm.out[x][w][p], &maps.in[x], &sm.epi_full, at.n0 + 64 * p, at.m0 + 64 * w,
                   at.e);"""
FIRST_BOX = """
              epi_box(epi_sent++);"""
SPREAD = """            } else if (epi_sent > 0 && epi_sent < kEpiBoxes) {
              epi_box(epi_sent++);
            }"""
# substitutions of each variant that is not one of the source's macros:
# designs (checked and timed) and diagnostics (only (a) timed, nothing checked)
EDITS = {
    "gated a1 / a3 in one burst": [
        (SPREAD, "            }"),
        (EXPECT + FIRST_BOX, EXPECT + "\n              while (epi_sent < kEpiBoxes) "
                                      "epi_box(epi_sent++);")],
}
DIAGNOSTICS = {
    "gated without the activation": [(ACT, "      y0 = x1.x, g0 = 1.f, y1 = x1.y, g1 = 1.f;")],
    "gated without a1 / a3 loads": [(EXPECT, "mbar_expect_tx(&sm.epi_full, 0);"),
                                    (EPI_BOX, "          (void)x, (void)w, (void)p;")],
}
# (E, C, D, F): the slice's shape, ragged against every tile, and smaller
CHECKS = [(64, 960, 2048, 1408), (3, 75, 264, 136), (2, 300, 520, 392), (1, 64, 64, 64)]
TOL = 1e-2


def build(out: Path, names: list[str]) -> dict[str, tuple[Path, str]]:
    """One library a variant, all nvcc runs at once; (library, ptxas log)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "moe_gmm_bwd.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        src, defines = text, DESIGNS.get(name, {})
        for old, new in EDITS.get(name, []) + DIAGNOSTICS.get(name, []):
            if old not in src:
                raise SystemExit(f"k4b_variants: substitution no longer matches: {old[:60]!r}")
            src = src.replace(old, new)
        cu, lib = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *[f"-D{k}={v}" for k, v in defines.items()],
               "-I", str(_build.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k4b_variants: {name}: nvcc exit {proc.returncode}\n{log}")
        built[name] = (lib, log)
    return built


def ptxas_report(log: str) -> dict[str, dict]:
    """Each wgmma instance's registers and spilled bytes, and whether ptxas
    serialised its wgmmas."""
    import chip_smoke as cs

    serial = [line for line in log.splitlines() if "Performance Loss" in line]
    out = {}
    for fn, regs, spill in cs.ptxas_instances(log):
        m = re.search(r"gmm_(dgrad|wgrad)_sm90(?:ILi(\d)E)?", fn)
        if m:
            name = f"gmm_{m.group(1)}_sm90" + (f"<{m.group(2)}>" if m.group(2) else "")
            out[name] = {"registers": regs, "spill_bytes": spill,
                         "serialised": any(fn in s for s in serial)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="build and check the committed design only; no timing")
    ap.add_argument("--out", type=Path, default=None, help="write the record here as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k4b_variants: torch.cuda.is_available() is False: needs a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import moe_gmm as k4
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    names = ["committed"] if args.check else [*DESIGNS, *EDITS, *DIAGNOSTICS]
    t0 = time.time()
    built = build(ROOT / "build" / "k4b_variants", names)
    print(f"built {len(built)} variants in {time.time() - t0:.1f} s", flush=True)
    record: dict = {"card": smi, "shape": list(cs.K4B_SHAPE), "variants": {}}
    libs = {}
    for name, (path, log) in built.items():
        lib = ctypes.CDLL(str(path))
        fns = {}
        for kind, (entry, ptrs, ints) in k4._BWD_ENTRIES.items():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[kind] = fn
        libs[name] = fns
        rep = ptxas_report(log)
        record["variants"][name] = {"ptxas": rep}
        print(f"{name}: {json.dumps(rep)}", flush=True)
    err_lib = k4._bwd_entry()[0]

    def check(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what}: CUDA error {err} "
                               f"({err_lib.repro_cuda_error_string(err).decode()})")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(36)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def inputs(E, C, D, F, act):
        x = randn(E, C, D)
        w1, w3 = randn(E, D, F, scale=D ** -0.5), randn(E, D, F, scale=D ** -0.5)
        w2 = randn(E, F, D, scale=F ** -0.5)
        _, a3, h = ref.moe_ffn_fwd(x, w1, w3, w2, act, gmm=k4.gmm)
        return {"x": x, "w1": w1, "w3": w3, "w2": w2, "a1": k4.gmm(x, w1), "a3": a3, "h": h,
                "dy": randn(E, C, D)}

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def gated(f, t, act, da1, da3):
        E, C, D = t["dy"].shape
        F = t["w2"].shape[1]
        check(f["gated"](t["dy"].data_ptr(), t["w2"].data_ptr(), t["a1"].data_ptr(),
                         t["a3"].data_ptr(), da1.data_ptr(), da3.data_ptr(), 1,
                         k4.EPILOGUE_CODES[act], E, C, D, F, stream()), "(a)")

    def dgrad(f, g, w, g2, w2, out):
        E, C, F = g.shape
        check(f["dgrad"](g.data_ptr(), w.data_ptr(), None if g2 is None else g2.data_ptr(),
                         None if w2 is None else w2.data_ptr(), out.data_ptr(), 1, E, C,
                         w.shape[1], F, stream()), "(b)")

    def wgrad(f, a, b, out):
        E, C, P = a.shape
        check(f["wgrad"](a.data_ptr(), b.data_ptr(), out.data_ptr(), 1, E, C, P, b.shape[2],
                         stream()), "(c)")

    def run(f, t, act):
        da1, da3 = torch.empty_like(t["a1"]), torch.empty_like(t["a3"])
        gated(f, t, act, da1, da3)
        dx, dw1, dw2 = torch.empty_like(t["x"]), torch.empty_like(t["w1"]), torch.empty_like(t["w2"])
        dgrad(f, da1, t["w1"], da3, t["w3"], dx)
        wgrad(f, t["x"], da1, dw1)
        wgrad(f, t["h"], t["dy"], dw2)
        return {"da1": da1, "da3": da3, "dx": dx, "dw1": dw1, "dw2": dw2}

    def plain(t, act):
        da1, da3 = ref.gmm_gated_dgrad_ref(t["dy"], t["w2"], t["a1"], t["a3"], act)
        return {"da1": da1, "da3": da3, "dx": ref.gmm_dgrad_ref(da1, t["w1"], da3, t["w3"]),
                "dw1": ref.gmm_wgrad_ref(t["x"], da1), "dw2": ref.gmm_wgrad_ref(t["h"], t["dy"])}

    failed = []
    for shape in CHECKS:
        for act in ("silu", "gelu") if shape != cs.K4B_SHAPE else ("silu",):
            t = inputs(*shape, act)
            want = plain(t, act)
            for name in (n for n in names if n not in DIAGNOSTICS):
                got, again = run(libs[name], t, act), run(libs[name], t, act)
                torch.cuda.synchronize()
                rel = max(float((got[k].float() - want[k].float()).abs().max())
                          / max(float(want[k].float().abs().max()), 1e-30) for k in got)
                bits = all(torch.equal(got[k], again[k]) for k in got)
                ok = rel <= TOL and bits
                record["variants"][name].setdefault("checks", []).append(
                    {"shape": list(shape), "act": act, "rel_err": rel, "bitwise_rerun": bits})
                print(f"  {name} {shape} {act}: rel err {rel:.3e}, bitwise rerun {bits} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failed.append((name, shape, act))
            del t, want
    if failed:
        raise SystemExit(f"k4b_variants: {failed} disagree with the plain versions")
    if not args.check:
        time_variants(record, libs, names, inputs, gated, dgrad, wgrad, cs, k4, torch, dev)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))


def time_variants(record, libs, names, inputs, gated, dgrad, wgrad, cs, k4, torch, dev) -> None:
    """Each build's kernels at K4B_SHAPE beside the previous design and
    torch.bmm, two turns in opposite orders, L2 flushed before each call."""
    E, C, D, F = cs.K4B_SHAPE
    t = inputs(E, C, D, F, "silu")
    da1, da3 = k4.gated_dgrad(t["dy"], t["w2"], t["a1"], t["a3"], "silu")
    o1, o3, dx, dw = (torch.empty_like(da1), torch.empty_like(da3), torch.empty_like(t["x"]),
                      torch.empty_like(t["w1"]))
    g13, w13 = torch.cat([da1, da3], -1), torch.cat([t["w1"], t["w3"]], -1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        torch.cuda.synchronize()
        for s, e in evs:
            flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters

    prod = 2.0 * E * C * D * F
    kernels = {  # name: (flops, the previous design, torch.bmm, a build's call)
        "gated_dgrad (a)": (prod, lambda: k4.previous_bwd("gated_dgrad", t["dy"], t["w2"],
                                                          t["a1"], t["a3"]),
                            lambda: torch.bmm(t["dy"], t["w2"].mT),
                            lambda f: gated(f, t, "silu", o1, o3)),
        "(a)'s product, store epilogue": (prod, None, None,
                                          lambda f: dgrad(f, t["dy"], t["w2"], None, None, o1)),
        "dgrad (b)": (2 * prod, lambda: k4.previous_bwd("dgrad", da1, t["w1"], da3, t["w3"]),
                      lambda: torch.bmm(g13, w13.mT),
                      lambda f: dgrad(f, da1, t["w1"], da3, t["w3"], dx)),
        "wgrad (c)": (prod, lambda: k4.previous_bwd("wgrad", t["x"], da1),
                      lambda: torch.bmm(t["x"].mT, da1), lambda f: wgrad(f, t["x"], da1, dw)),
    }
    record["timing"] = {}
    for kernel, (flops, previous, library, call) in kernels.items():
        arms = {}
        if previous is not None:
            arms["previous design"] = previous
            arms["torch.bmm"] = library
        for name in names:
            if name in DIAGNOSTICS and kernel != "gated_dgrad (a)":
                continue
            arms[name] = (lambda f: lambda: call(f))(libs[name])
        order = list(arms)
        ms: dict[str, list[float]] = {a: [] for a in order}
        for turn in (order, order[::-1]):
            for arm in turn:
                ms[arm].append(time_ms(arms[arm]))
        row = {a: {"ms": v, "tflops": flops / min(v) / 1e9} for a, v in ms.items()}
        record["timing"][kernel] = row
        print(f"{kernel} at {cs.K4B_SHAPE}, bf16, L2 flushed, {record['card']}: "
              f"{json.dumps(row)}", flush=True)


if __name__ == "__main__":
    main()
