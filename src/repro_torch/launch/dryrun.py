"""Dry run: trace every (architecture x input shape) on ``meta`` tensors
against one H100 and print its memory, FLOPs and roofline terms.

The reference lowers and compiles each step on 512 fake CPU devices and
parses the partitioned HLO.  The port has no HLO: it runs the step once on
``meta`` tensors (shapes and dtypes, no storage and no device), with the
kernels' meta branches standing where the card launches them, and counts
what was dispatched (``analysis.trace_step``).  So the dry run needs no
card and runs the same wherever it runs, full-size configs included
(kimi-k2's 1T params take no memory on ``meta``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out experiments/dryrun_torch

Each record has the reference's keys where they mean something (``arch``,
``shape``, ``mesh``, ``status``: ``ok``, ``skip`` with the reference's
``skip_reason``, or ``fail``; ``n_chips``, ``roofline``), and in place of
lowering and compiling: ``t_trace_s``, ``memory`` (the exact argument bytes
of params, optimizer state, batch and cache, and the peak of live storages
the trace saw), ``bytes_per_device`` (that peak) and ``step_summary``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional, Union

from repro_torch.configs import (ASSIGNED, SHAPES, InputShape, get_config,
                                 get_shape, shape_applicable)
from repro_torch.launch import analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step

# the reference's per-arch winners of its perf hillclimb, applied by
# --optimized, less those that select a form the port keeps out (KEPT_OUT):
# grok-1's expert-parallel shard_map and zamba2's chunked XLA scan
OPTIMIZED_PRESETS = {
    "rwkv6-3b": {"scan_chunked": True, "scan_chunk": 64},
    "grok-1-314b": {"moe.capacity_factor": 1.0, "moe_exact_serving": False},
    "tinyllama-1.1b": {"attn_chunk": 2048},
    # capacity fix: 1T params cannot hold f32 AdamW moments in HBM
    "kimi-k2-1t-a32b": {"opt_moment_dtype": "bfloat16"},
}

# overrides that select a form of the reference the port keeps out:
# (key, value, family or None for any) -> the form
KEPT_OUT = {
    ("moe.ep_mode", "shard_map", None):
        "models/moe.py: moe_shard_map (experts sharded over a mesh)",
    ("scan_chunked", True, "hybrid"):
        "models/ssm.py: ssd_chunked (#8's prefill is the chunked SSD form)",
}


def parse_overrides(items):
    """--set key=value pairs -> cfg.replace kwargs (moe.* handled)."""
    out = {}
    for it in items or []:
        k, v = it.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        out[k] = v
    return out


def apply_overrides(cfg, overrides: dict):
    moe_kw = {k[4:]: v for k, v in overrides.items() if k.startswith("moe.")}
    top_kw = {k: v for k, v in overrides.items() if "." not in k}
    if moe_kw and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    if top_kw:
        cfg = cfg.replace(**top_kw)
    return cfg


def refuse_kept_out(cfg, overrides: dict) -> None:
    """Raise where an override selects a form the port keeps out."""
    for (key, value, family), form in KEPT_OUT.items():
        if overrides.get(key) == value and family in (None, cfg.family):
            raise ValueError(f"{key}={value} selects the reference's {form}, "
                             "which the port keeps out (one card)")


def run_one(arch: str, shape: Union[str, InputShape], remat: str = "block",
            overrides: Optional[dict] = None) -> dict:
    """Trace one (arch, shape) on meta and return its record.  ``shape`` is
    a name of ``SHAPES`` or an ``InputShape``."""
    cfg = get_config(arch)
    if overrides:
        refuse_kept_out(cfg, overrides)
        cfg = apply_overrides(cfg, overrides)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    mesh = make_production_mesh()
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh.name,
           "status": "skip"}
    if not ok:
        rec["skip_reason"] = why
        return rec
    if shape.kind == "train" and remat:
        cfg = cfg.replace(remat=remat)

    t0 = time.perf_counter()
    fn, kwargs = build_step(cfg, shape)
    summ, _ = analysis.trace_step(fn, kwargs)
    t_trace = time.perf_counter() - t0
    mf = analysis.model_flops(cfg, shape)
    rl = analysis.roofline(summ, mesh.n_chips, mf, mesh.hw)
    memory = {f"{name}_bytes": analysis.storage_bytes(kwargs.get(name))
              for name in ("params", "opt_state", "batch", "cache")}
    memory.update(argument_bytes=summ.param_bytes, peak_bytes=summ.peak_bytes,
                  hbm_bytes=mesh.hw.hbm_bytes,
                  fits=summ.peak_bytes <= mesh.hw.hbm_bytes)
    print(f"[{arch} x {shape.name} x {mesh.name}] memory: arguments "
          f"{summ.param_bytes:.4e} B (params {memory['params_bytes']:.4e}, "
          f"opt_state {memory['opt_state_bytes']:.4e}), peak "
          f"{summ.peak_bytes:.4e} B of {mesh.hw.hbm_bytes:.4e} "
          f"({'fits' if memory['fits'] else 'does not fit'})")
    print(f"[{arch} x {shape.name}] roofline per chip: "
          f"compute={rl.compute_s:.4e}s memory={rl.memory_s:.4e}s "
          f"collective={rl.collective_s:.4e}s dominant={rl.dominant} "
          f"useful_ratio={rl.useful_ratio:.3f}")
    rec.update(status="ok", t_trace_s=t_trace, memory=memory,
               bytes_per_device=summ.peak_bytes,
               step_summary=summ.as_dict(), roofline=rl.as_dict(),
               n_chips=mesh.n_chips)
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--remat", default="block")
    p.add_argument("--set", action="append", dest="overrides", default=[],
                   help="config override key=value (moe.* reaches MoEConfig)")
    p.add_argument("--tag", default="", help="artifact filename suffix")
    p.add_argument("--optimized", action="store_true",
                   help="apply the per-arch OPTIMIZED_PRESETS overrides")
    args = p.parse_args(argv)
    overrides = parse_overrides(args.overrides)

    os.makedirs(args.out, exist_ok=True)
    archs = [c.name for c in ASSIGNED] if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    mesh = make_production_mesh().name

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}_{shape}_{mesh}"
            if args.tag:
                tag += f"_{args.tag}"
            ov = dict(overrides)
            if args.optimized:
                ov = {**OPTIMIZED_PRESETS.get(arch, {}), **ov}
                tag += "_opt"
            try:
                rec = run_one(arch, shape, remat=args.remat, overrides=ov)
            except Exception:  # noqa: BLE001 - a failed combo is recorded
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "fail",
                       "error": traceback.format_exc()[-2000:]}
                n_fail += 1
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=2)
            print(f"-> {tag}: {rec['status']}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run combos failed")


if __name__ == "__main__":
    main()
