"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step once on
meta-device DTensors and price it per device: the counterpart of
``repro/launch/dryrun.py``.

The JAX dry-run lowers and compiles each cell on 256 / 512 placeholder
devices and prices the per-device HLO.  Here the production mesh
(``launch/mesh.py``: 16 x 16 ``(data, model)``, or 2 x 16 x 16 with
``pod``) lives over a ``fake`` process group in this one process; the
cell's params, train state, caches and batch are ``meta`` tensors
distributed by the JAX package's rules (``distributed/sharding.py``,
``rules_for_shape``), and the step (train, prefill or decode) runs once,
eagerly, on them.  DTensor's sharding propagation inserts the collectives
that XLA inserts there; ``core/roofline.py``'s ``analyze_sharded`` prices
what one rank ran (``core/graphanalysis.py``).  The step runs the plain
PyTorch versions of the kernels (``ops.impl_scope("plain")``): the dry-run
launches no kernel and touches no device, as the JAX one compiles without
running.  Every op that DTensor could not shard was run on replicated
operands, and the record lists it (``replicated_ops``).

Each record keeps the JAX record's keys (``xla_cost_flops_per_dev`` is
None: there is no XLA; ``flop_counter_flops_per_dev`` stands beside it),
``lower_s`` is the time to build and distribute the cell's state and
``compile_s`` None, and ``run_s`` the priced run.  ``roofline_fraction`` is
the model FLOPs' ideal time at the card's bf16 peak (``hw/specs.py``) over
the bound step time.  Every term is priced from ``hw/specs.py``'s H100
figures, not measured.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE] [--workers N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Optional

import torch

from repro_torch.configs import SHAPES, get_config, list_archs, supports_shape
from repro_torch.core.roofline import analyze_sharded, model_flops
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.constrain import mesh_scope
from repro_torch.hw.specs import default_chip
from repro_torch.kernels import ops
from repro_torch.launch import inputs as inputs_mod
from repro_torch.launch.mesh import destroy_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.training.step import (TrainConfig, abstract_train_state, make_train_step,
                                       train_state_axes)
from repro_torch.utils.tree import tree_size_bytes


def _v_it1(cfg):
    return dataclasses.replace(cfg, fused_attention_vjp=True,
                               pad_heads_to=16 if cfg.n_heads % 16 else 0,
                               activation_constraints=True)


def _v_it2(cfg):
    return dataclasses.replace(_v_it1(cfg), loss_table_replicated=True)


def _v_it3(cfg):
    # fewer / bigger CE chunks: the (replicated-on-data) unembed table is
    # re-read once per chunk
    return dataclasses.replace(_v_it2(cfg), loss_chunk=8192)


def _v_it6(cfg):
    return dataclasses.replace(_v_it3(cfg), chunk_scan_remat=True)


# the JAX package's ladder of semantics-preserving variants
VARIANTS = {
    "baseline": lambda cfg: cfg,
    "it1_flashvjp_padheads": _v_it1,
    "it2_losstable": _v_it2,
    "it3_losschunks": _v_it3,
    "it4_splitkv": _v_it3,  # + decode_split_kv, applied per cell below
    "it5_decode_ws": _v_it3,  # + the weight-stationary decode layout
    "it6_ssm_remat": _v_it6,
    "optimized": _v_it3,
}
# variants that enable the split-KV decode combine (decode cells whose rules
# shard the cache's sequence)
_SPLIT_KV_VARIANTS = {"it4_splitkv", "it5_decode_ws", "optimized"}
# variants that use the weight-stationary decode layout (decode cells only)
_WS_DECODE_VARIANTS = {"it5_decode_ws", "optimized"}


def optimized(cfg):
    return _v_it3(cfg)


class SkipCell(Exception):
    pass


def _ws_pays(cfg) -> bool:
    """Weight-stationary decode pays where the per-token weight gathers
    dominate: huge-param archs or attention-free ones (the JAX gate)."""
    if not cfg.uses_attention:
        return True
    return tree_size_bytes(lm.abstract_params(cfg)) > 300e9


def lower_cell(arch: str, shape_name: str, mesh, *, extra_rules: Optional[dict] = None,
               opt: bool = False, variant: Optional[str] = None):
    """Build one cell's step and its DTensor arguments on ``mesh``.

    Returns (step_fn, step_kind, args, argument_bytes, act_rules)."""
    cfg = get_config(arch)
    if variant:
        cfg = VARIANTS[variant](cfg)
    elif opt:
        cfg = optimized(cfg)
    shape = SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    if not ok:
        raise SkipCell(why)
    mshape = shd.mesh_shape(mesh)
    weight_stationary = ((opt or variant in _WS_DECODE_VARIANTS) and shape.kind == "decode"
                         and shape.global_batch >= mshape.get("data", 1) and _ws_pays(cfg))
    rules = shd.rules_for_shape(shape.kind, global_batch=shape.global_batch,
                                seq_len=shape.seq_len, mesh=mesh, n_kv_heads=cfg.n_kv_heads,
                                weight_stationary=weight_stationary)
    if extra_rules:
        rules = rules.with_overrides(**extra_rules)
    wants_split = weight_stationary and (opt or variant in _SPLIT_KV_VARIANTS)
    cache_seq = rules.act.get("cache_seq")
    if wants_split and shape.kind == "decode" and cache_seq:
        cfg = dataclasses.replace(cfg, decode_split_kv=True,
                                  decode_seq_axes=shd.axes_tuple(cache_seq),
                                  decode_batch_axes=shd.axes_tuple(rules.act.get("batch")))
    batch_abs = inputs_mod.input_specs(cfg, shape)

    def dist(tree, axes, rule_set):
        specs = shd.tree_specs(axes, tree, rule_set, mesh)
        return (shd.distribute(tree, axes, rule_set, mesh),
                shd.shard_bytes_per_device(tree, specs, mesh))

    if shape.kind == "train":
        tcfg = TrainConfig()
        step = make_train_step(cfg, tcfg)
        state, state_b = dist(abstract_train_state(cfg, tcfg), train_state_axes(cfg), rules.param)
        batch_axes = {k: "batch,seq" for k in ("tokens", "labels")}
        if "frontend_embed" in batch_abs:
            batch_axes["frontend_embed"] = "batch,seq,embed"
        batch, batch_b = dist(batch_abs, batch_axes, rules.act)
        return step, "train_step", (state, batch), state_b + batch_b, rules.act

    params, params_b = dist(lm.abstract_params(cfg), lm.param_axes(cfg), rules.param)
    if shape.kind == "prefill":
        batch_axes = {"tokens": "batch,seq"}
        if "frontend_embed" in batch_abs:
            batch_axes["frontend_embed"] = "batch,seq,embed"
        batch, batch_b = dist(batch_abs, batch_axes, rules.act)

        @torch.no_grad()
        def prefill_step(params, batch):
            return lm.prefill(params, cfg, batch["tokens"], batch.get("frontend_embed"))

        return prefill_step, "prefill_step", (params, batch), params_b + batch_b, rules.act

    caches, caches_b = dist(inputs_mod.abstract_decode_caches(cfg, shape), lm.cache_axes(cfg),
                            rules.act)
    batch_axes = {"tokens": "batch", "cur_pos": "batch"}
    if "frontend_embed" in batch_abs:
        batch_axes["frontend_embed"] = "batch,seq,embed"
    batch, batch_b = dist(batch_abs, batch_axes, rules.act)

    @torch.no_grad()
    def serve_step(params, batch, caches):
        return lm.decode_step(params, cfg, batch["tokens"], batch["cur_pos"], caches,
                              batch.get("frontend_embed"))

    return (serve_step, "serve_step", (params, batch, caches), params_b + batch_b + caches_b,
            rules.act)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, opt: bool = False,
             variant: Optional[str] = None) -> dict[str, Any]:
    """Build, run and price one cell.  Returns its record."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec: dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, mesh.shape)),
        "n_devices": mesh.size(),
        "variant": variant or ("optimized" if opt else "baseline"),
    }
    try:
        with ops.impl_scope("plain"), implicit_replication():
            fn, kind, args, arg_bytes, act_rules = lower_cell(arch, shape_name, mesh, opt=opt,
                                                              variant=variant)
            rec["step"] = kind
            t1 = time.time()
            rec["lower_s"] = round(t1 - t0, 1)
            rec["compile_s"] = None
            with mesh_scope(mesh, act_rules):
                rec.update(analyze_sharded(fn, args, mesh, argument_bytes=arg_bytes))
            rec["run_s"] = round(time.time() - t1, 1)
        cfg = get_config(arch)
        n_dev = mesh.size()
        mf = model_flops(cfg, SHAPES[shape_name], lm.abstract_params(cfg))
        rec["model_flops_global"] = mf
        priced_global = rec["hlo_flops_per_dev"] * n_dev
        rec["useful_flops_ratio"] = round(mf / priced_global, 4) if priced_global else None
        t_ideal = mf / (n_dev * default_chip().peak_flops_bf16)
        rec["t_model_ideal_s"] = t_ideal
        bound = rec["step_time_bound_s"]
        rec["roofline_fraction"] = round(t_ideal / bound, 4) if bound else None
        rec["status"] = "ok"
    except SkipCell as e:
        rec["status"] = "skip"
        rec["reason"] = str(e)
    finally:
        destroy_mesh()
    rec["seconds"] = round(time.time() - t0, 1)
    return rec


def _cell_in_child(arch: str, shape: str, args: argparse.Namespace) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape]
    if args.multi_pod:
        cmd.append("--multi-pod")
    if args.opt:
        cmd.append("--opt")
    if args.variant:
        cmd += ["--variant", args.variant]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ))


def _child_record(arch: str, shape: str, proc: subprocess.Popen) -> dict:
    out, err = proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if lines:
        return json.loads(lines[-1])
    return {"arch": arch, "shape": shape, "status": "FAIL",
            "error": f"child exited {proc.returncode} without a record", "trace": err[-2000:]}


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", action="store_true", help="run the optimized variant")
    ap.add_argument("--variant", default=None, choices=list(VARIANTS),
                    help="a specific variant of the ladder")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells run at once, each in a child process (default 1: in this one)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s) for a in archs for s in shapes]
    n_fail = 0
    running: list = []

    def emit(rec: dict) -> None:
        nonlocal n_fail
        n_fail += rec.get("status") == "FAIL"
        print(json.dumps(rec, default=str), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")

    for arch, shape in cells:
        if args.workers > 1 and len(cells) > 1:
            running.append((arch, shape, _cell_in_child(arch, shape, args)))
            if len(running) >= args.workers:
                emit(_child_record(*running.pop(0)))
            continue
        try:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod, opt=args.opt,
                           variant=args.variant)
        except Exception as e:  # a failure here is a bug in the system
            rec = {"arch": arch, "shape": shape, "status": "FAIL",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc(limit=-12)}
        emit(rec)
    while running:
        emit(_child_record(*running.pop(0)))
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
