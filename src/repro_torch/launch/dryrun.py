"""One-card dry run: walk every (arch × shape) cell on the meta device.

The counterpart of ``repro.launch.dryrun`` for one card (a ``(1, 1)``
mesh). Each cell builds its parameters, its AdamW state (the
reference's diet above 20 B parameters), its caches and its inputs on
the meta device — shapes, dtypes and strides, no data, no device memory
and no GPU — and runs the cell's step once under
:func:`repro_torch.analysis.op_costs.compute_costs`: the train step
(``accumulate_gradients`` + ``update``, ``runtime.train_loop.
make_train_step``), prefill's ``apply`` keeping the last position's
logits, or ``decode_step``. The artifact under ``artifacts/dryrun/1x1/``
keeps the reference's keys: the walk's FLOPs, traffic and collective
bytes under ``parsed``, the walk's seconds as ``compile_seconds`` and an
empty ``cost_analysis`` (there is no compiled module), and under
``memory_analysis`` the arguments' bytes (every input leaf's, exactly),
the outputs' and ``temp_size_in_bytes``, the walk's peak of live bytes
that the step allocated. ``fits`` holds arguments + temp against one
80 GB card, and ``roofline`` the H100 roofline (its memory term from
``analysis.memory_model``, as the reference's tables take it).

``--mesh single|multi`` (a walk over the production meshes, 16×16 and
2×16×16 of ``launch/mesh.py::make_production_mesh``) is refused, naming
the next slice: the port's mesh step runs every shard's work from one
controller, so a walk of it on a 16×16 mesh would repeat each op for
256 shards; it needs a walk of one device's share.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    python -m repro_torch.launch.dryrun --all    # every cell, a subprocess each
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback
from typing import Any, Dict, Optional

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import (
    build_report, compute_costs, hbm_traffic_bytes, model_flops,
    param_counts,
)
from repro_torch.configs import ShapeConfig, shapes_for_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.models import LMModel
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import make_train_step

ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun"
)
MESH_NAME = "1x1"
#: one card's memory, as the data sheet gives it (H100 80GB HBM3)
CARD_BYTES = 80e9
TRAIN_MICROBATCHES = 8
# Per-arch overrides: activation-heavy configs trade collective volume
# (more ZeRO weight gathers) for peak HBM.
ARCH_MICROBATCHES = {
    "qwen3-moe-235b-a22b": 16,
    "llava-next-34b": 16,
}


def microbatches_for(arch: str, mesh=None, global_batch: int = 256) -> int:
    mb = ARCH_MICROBATCHES.get(arch, TRAIN_MICROBATCHES)
    if mesh is not None:
        dp = 1
        for a in ("pod", "data"):
            if a in mesh.axis_names:
                dp *= mesh.shape[a]
        # per-µbatch batch must stay divisible by the DP shard count
        mb = min(mb, max(1, global_batch // dp))
    return mb


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of this cell (on ``device``,
    empty: the meta device holds no data)."""
    b, n = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act_dtype = getattr(torch, cfg.dtype)
    if shape.kind in ("train", "prefill"):
        if cfg.uses_embeddings_input:
            return {
                "embeddings": torch.empty((b, n, cfg.d_model),
                                          dtype=act_dtype, device=device),
                "targets": torch.empty((b, n), dtype=i32, device=device),
            }
        return {
            "inputs": torch.empty((b, n), dtype=i32, device=device),
            "targets": torch.empty((b, n), dtype=i32, device=device),
        }
    # decode: one new token against a seq_len-deep cache
    if cfg.uses_embeddings_input:
        return {"embeddings": torch.empty((b, 1, cfg.d_model),
                                          dtype=act_dtype, device=device)}
    return {"tokens": torch.empty((b, 1), dtype=i32, device=device)}


def optimizer_config(cfg: ModelConfig) -> adamw.AdamWConfig:
    """≥20B configs use the production memory diet: factored second
    moment (Adafactor-style), bf16 momentum, bf16 grad accumulation —
    the dense AdamW f32 state of a 235B model fits no card."""
    big = param_counts(cfg)["total"] > 2e10
    return adamw.AdamWConfig(
        factored_second_moment=big,
        momentum_dtype="bfloat16" if big else "float32",
        accum_dtype="bfloat16" if big else "float32",
    )


def leaf_bytes(tree: Any) -> int:
    """Every tensor leaf's bytes (numel × element size), summed."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def step_for(model: LMModel, shape: ShapeConfig, *,
             microbatches: Optional[int] = None):
    """``(fn, args)``: the cell's step and its arguments, built on the
    model's device by its own constructors."""
    cfg = model.cfg
    params = model.init()
    batch = input_specs(cfg, shape, model.device)
    if shape.kind == "train":
        opt_cfg = optimizer_config(cfg)
        opt_state = adamw.init(params, opt_cfg)
        num_mb = microbatches or microbatches_for(
            cfg.name, None, shape.global_batch)
        return (make_train_step(model, opt_cfg, num_microbatches=num_mb),
                (params, opt_state, batch))
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            logits, _ = model.apply(params, batch)
            # serving prefill emits the last position's logits only; the
            # stack compute for earlier positions stays live through the
            # causal attention dependencies.
            return logits[:, -1:, :]

        return prefill_step, (params, batch)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    cache_index = torch.zeros((shape.global_batch,), dtype=torch.int32,
                              device=model.device)
    return model.decode_step, (params, cache, batch, cache_index)


def lower_cell(arch: str, shape: ShapeConfig, *,
               cfg: Optional[ModelConfig] = None,
               microbatches: Optional[int] = None) -> Dict[str, Any]:
    """Walk one cell on the meta device; ``cfg`` (default the arch's
    shipped config) and ``microbatches`` override the cell's."""
    cfg = cfg or get_config(arch)
    model = LMModel(cfg, device="meta")
    num_mb = (microbatches or microbatches_for(arch, None, shape.global_batch)
              if shape.kind == "train" else 1)
    fn, args = step_for(model, shape, microbatches=num_mb)
    costs = compute_costs(fn, *args)
    arg_bytes = leaf_bytes(args)
    temp = costs.peak_live_bytes
    flops = model_flops(cfg, shape)
    analytic = hbm_traffic_bytes(
        cfg, shape, chips=1, model_shards=1, num_microbatches=num_mb,
        opt_factored=(shape.kind == "train"
                      and optimizer_config(cfg).factored_second_moment))
    report = build_report(
        arch=arch, shape=shape.name, mesh_name=MESH_NAME, chips=1,
        parsed_flops=costs.flops, parsed_traffic_bytes=costs.traffic_bytes,
        parsed_collective_bytes=costs.collective_bytes, model_flops=flops,
        peak_memory_bytes=arg_bytes + temp,
        analytic_traffic_bytes=analytic["total"])
    return {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": MESH_NAME,
        "chips": 1,
        "compile_seconds": costs.seconds,
        "cost_analysis": {},
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": costs.output_bytes,
            "temp_size_in_bytes": temp,
        },
        "fits": {
            "bytes": arg_bytes + temp,
            "card_bytes": CARD_BYTES,
            "fits": arg_bytes + temp <= CARD_BYTES,
        },
        "parsed": {
            "flops_per_chip": costs.flops,
            "traffic_bytes_per_chip": costs.traffic_bytes,
            "collective_bytes_per_chip": costs.collective_bytes,
            "num_collectives": len(costs.collective_ops),
        },
        "model_flops": flops,
        "params": param_counts(cfg)["total"],
        "microbatches": num_mb,
        "kernel_launches": costs.launches,
        "num_ops": costs.num_ops,
        "roofline": report.to_dict(),
    }


def run_cell(arch: str, shape_name: str, out_dir: str) -> str:
    shape = next(s for s in shapes_for_arch(arch) if s.name == shape_name)
    artifact = lower_cell(arch, shape)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    mem = artifact["memory_analysis"]
    roof = artifact["roofline"]
    print(
        f"[dryrun] {MESH_NAME}/{arch}/{shape_name}: "
        f"{artifact['params'] / 1e9:.3f} B params, walk "
        f"{artifact['compile_seconds']:.1f}s, {artifact['num_ops']} ops, "
        f"flops {artifact['parsed']['flops_per_chip']:.3e}, args "
        f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB, temp "
        f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB "
        f"({'fits' if artifact['fits']['fits'] else 'does not fit'} one "
        f"card), {roof['dominant']}-bound "
        f"{roof['bound_time_s'] * 1e3:.1f} ms"
    )
    return path


def all_cells():
    for arch in ARCH_NAMES:
        for shape in shapes_for_arch(arch):
            yield arch, shape.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh", default=None, choices=("single", "multi"),
                    help="the production meshes: refused, the next slice")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        from repro_torch.distributed.sharding import A5B

        raise SystemExit(f"--mesh {args.mesh}: a dry run over a production "
                         f"mesh is {A5B}")
    out = args.out or os.path.normpath(os.path.join(ARTIFACT_DIR, MESH_NAME))

    if args.all:
        failures = []
        for arch, shape_name in all_cells():
            done = os.path.join(out, f"{arch}__{shape_name}.json")
            if os.path.exists(done):
                print(f"[dryrun] skip (exists): {done}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--out", out]
            r = subprocess.run(cmd, capture_output=False)
            if r.returncode != 0:
                failures.append((arch, shape_name))
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("[dryrun] ALL CELLS PASSED")
        return

    assert args.arch and args.shape, "--arch/--shape or --all required"
    try:
        run_cell(args.arch, args.shape, out)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
