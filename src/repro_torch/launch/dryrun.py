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

``--mesh single|multi`` walks the production meshes of
``launch/mesh.py::make_production_mesh`` (16×16 = 256 cards over
``("data", "model")``, 2×16×16 = 512 over ``("pod", "data", "model")``),
built on the meta device, under the reference's rules profile
(``"serve"`` for an MoE's prefill and decode, else ``"train"``). The
port's mesh program runs every shard's work from one controller, so a
walk of the whole mesh would repeat each op for every shard; the walk
is of **one device's share** instead (``Mesh.share``): the same
program handed a mesh whose rows hold one row of one device, its
parameters, AdamW state and cache the shards that device holds
(``distributed/sharding.py::share_tree`` / ``shard_cache``: one tensor
a leaf), the batch logical and cut by the program to its row, each
model-axis leaf keeping its logical shard index, and every collective
priced — the operand bytes XLA's parser would count on that device,
under the reference's type names and the axes it runs over — and
replaced by a stand-in of its output. Where the layout is even every
device's share costs the same, so the walk of coordinate 0 (``--coord``
another) stands for every card: FLOPs, traffic, collective bytes and
temp are per card, ``argument_size_in_bytes`` the shards' bytes (the
reference's per-device ``memory_analysis``), ``fits`` one 80 GB card,
and the roofline's terms are over the mesh's cards. A prefill step
takes the last position alone through the vocabulary-sharded head
(the reference's ``logits_sharding``); nothing gathers the logits.
Every number is **predicted** from the H100 80GB HBM3 data sheet: the
collective term divides by NVLink's 450 GB/s, a lower bound where an
axis of 16 spans more than one 8-card node (``collective_bytes_by_axis``
keeps the bytes by axis for a model of the links).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape decode_32k \
        --mesh single [--coord 0,0]
    python -m repro_torch.launch.dryrun --all [--mesh multi]   # a subprocess a cell
"""

from __future__ import annotations

import argparse
import json
import math
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
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
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


def rules_profile(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """The reference's rules profile of a cell: MoE inference cells use
    the serving layout (2-D experts, resident weights), the rest the
    training one (ZeRO over 'data')."""
    return ("serve" if shape.kind in ("prefill", "decode")
            and cfg.family == "moe" else "train")


def production_mesh(mesh_name: str, device="meta"):
    """The 16×16 (``single``) or 2×16×16 (``multi``) mesh, every
    position ``device``."""
    return make_production_mesh(multi_pod=(mesh_name == "multi"),
                                devices=[device] * 512)


def share_step_for(model: LMModel, shape: ShapeConfig, mesh, share, *,
                   microbatches: int):
    """``(fn, args, arg_bytes)``: the cell's step over ``mesh`` run as
    device ``share.coord``'s share (``share`` its ``Mesh.share``), its
    arguments — the parameters', AdamW state's and cache's shards on the
    share's device, the batch logical — and the bytes that device holds
    of them (the reference's per-device ``argument_size_in_bytes``)."""
    cfg = model.cfg
    params = model.init()
    sp = shd.share_tree(params, shd.param_shardings(params, mesh), share)
    del params
    batch = input_specs(cfg, shape, model.device)
    # the leaves the step reads (jit prunes an unused argument: a
    # prefill's targets), each by batch_pspec
    read = {k: v for k, v in batch.items()
            if shape.kind != "prefill" or k != "targets"}
    arg_bytes = (shd.share_bytes(sp)
                 + shd.share_bytes(shd.share_batch(read, share)))
    if shape.kind == "train":
        opt_cfg = optimizer_config(cfg)
        opt_state = adamw.init(sp, opt_cfg)
        arg_bytes += shd.share_bytes([opt_state.step, opt_state.mu,
                                      opt_state.nu])
        return (make_train_step(model, opt_cfg, mesh=share,
                                num_microbatches=microbatches),
                (sp, opt_state, batch), arg_bytes)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            _, logits, _, _ = model._mesh_forward(params, batch, share,
                                                  last_only=True)
            return logits

        return prefill_step, (sp, batch), arg_bytes
    cache = model.shard_cache(
        model.init_cache(shape.global_batch, shape.seq_len), share)
    cache_index = torch.zeros((shape.global_batch,), dtype=torch.int32,
                              device=model.device)
    # cache_index lies as the batch does (the reference leaves its
    # sharding to XLA, which splits it with the batch where it can)
    arg_bytes += shd.share_bytes(cache) + shd.share_bytes(
        shd.share_batch({"cache_index": cache_index}, share))

    def decode_step(params, cache, batch, cache_index):
        return model.decode_step(params, cache, batch, cache_index,
                                 mesh=share)

    return decode_step, (sp, cache, batch, cache_index), arg_bytes


def share_argument_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         coord=None) -> int:
    """The bytes device ``coord`` (default the origin) of ``mesh`` holds
    of the cell's arguments — the reference's per-device
    ``argument_size_in_bytes`` —, reckoned on the meta device from the
    specs without walking the step."""
    prev = shd.get_rules_profile()
    shd.set_rules_profile(rules_profile(cfg, shape))
    try:
        model = LMModel(cfg, device="meta")
        return share_step_for(
            model, shape, mesh, mesh.share(coord or (), device="meta"),
            microbatches=1)[2]
    finally:
        shd.set_rules_profile(prev)


def lower_cell(arch: str, shape: ShapeConfig, *, mesh=None,
               mesh_name: Optional[str] = None, coord=None,
               cfg: Optional[ModelConfig] = None,
               microbatches: Optional[int] = None) -> Dict[str, Any]:
    """Walk one cell on the meta device; ``cfg`` (default the arch's
    shipped config) and ``microbatches`` override the cell's. With
    ``mesh`` (a mesh of meta devices, e.g. :func:`production_mesh`)
    the walk is of device ``coord``'s share (default the origin) under
    the cell's :func:`rules_profile`."""
    cfg = cfg or get_config(arch)
    model = LMModel(cfg, device="meta")
    num_mb = (microbatches or microbatches_for(arch, mesh, shape.global_batch)
              if shape.kind == "train" else 1)
    prev = shd.get_rules_profile()
    extra: Dict[str, Any] = {}
    try:
        if mesh is None:
            chips, shards, name = 1, 1, MESH_NAME
            fn, args = step_for(model, shape, microbatches=num_mb)
            arg_bytes = leaf_bytes(args)
        else:
            shd.set_rules_profile(rules_profile(cfg, shape))
            share = mesh.share(coord or (), device="meta")
            chips = math.prod(mesh.shape.values())
            shards = mesh.shape.get("model", 1)
            name = mesh_name or "x".join(str(v) for v in mesh.shape.values())
            fn, args, arg_bytes = share_step_for(model, shape, mesh, share,
                                                 microbatches=num_mb)
            extra = dict(rules_profile=rules_profile(cfg, shape),
                         coord=share.coord, mesh_shape=dict(mesh.shape))
        costs = compute_costs(fn, *args)
    finally:
        shd.set_rules_profile(prev)
    if mesh is not None:
        extra["collective_bytes_by_axis"] = costs.collective_bytes_by_axis
    temp = costs.peak_live_bytes
    flops = model_flops(cfg, shape)
    analytic = hbm_traffic_bytes(
        cfg, shape, chips=chips, model_shards=shards, num_microbatches=num_mb,
        opt_factored=(shape.kind == "train"
                      and optimizer_config(cfg).factored_second_moment))
    report = build_report(
        arch=arch, shape=shape.name, mesh_name=name, chips=chips,
        parsed_flops=costs.flops, parsed_traffic_bytes=costs.traffic_bytes,
        parsed_collective_bytes=costs.collective_bytes, model_flops=flops,
        peak_memory_bytes=arg_bytes + temp,
        analytic_traffic_bytes=analytic["total"])
    return {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": name,
        "chips": chips,
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
        **extra,
        "kernel_launches": costs.launches,
        "num_ops": costs.num_ops,
        "roofline": report.to_dict(),
    }


def run_cell(arch: str, shape_name: str, out_dir: str,
             mesh_name: Optional[str] = None, coord=None) -> str:
    shape = next(s for s in shapes_for_arch(arch) if s.name == shape_name)
    if mesh_name is None:
        artifact = lower_cell(arch, shape)
    else:
        artifact = lower_cell(arch, shape, mesh=production_mesh(mesh_name),
                              mesh_name=mesh_name, coord=coord)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    mem = artifact["memory_analysis"]
    roof = artifact["roofline"]
    coll = sum(artifact["parsed"]["collective_bytes_per_chip"].values())
    print(
        f"[dryrun] {artifact['mesh']}/{arch}/{shape_name}: "
        f"{artifact['params'] / 1e9:.3f} B params, walk "
        f"{artifact['compile_seconds']:.1f}s, {artifact['num_ops']} ops, "
        f"flops/chip {artifact['parsed']['flops_per_chip']:.3e}, coll "
        f"{coll / 1e9:.3f} GB/chip, args "
        f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB, temp "
        f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB "
        f"per chip ({'fits' if artifact['fits']['fits'] else 'does not fit'}"
        f" one card), {roof['dominant']}-bound "
        f"{roof['bound_time_s'] * 1e3:.1f} ms"
    )
    return path


def all_cells():
    for arch in ARCH_NAMES:
        for shape in shapes_for_arch(arch):
            yield arch, shape.name


def _coord(text: Optional[str]):
    return None if not text else tuple(int(c) for c in text.split(","))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh", default=None, choices=("single", "multi"),
                    help="walk one device's share of a production mesh "
                    "(16x16 or 2x16x16) instead of one card")
    ap.add_argument("--coord", default=None,
                    help="the share's coordinate, one index per mesh axis "
                    "(default the origin), e.g. 3,5")
    args = ap.parse_args(argv)
    name = args.mesh or MESH_NAME
    out = args.out or os.path.normpath(os.path.join(ARTIFACT_DIR, name))

    if args.all:
        failures = []
        for arch, shape_name in all_cells():
            done = os.path.join(out, f"{arch}__{shape_name}.json")
            if os.path.exists(done):
                print(f"[dryrun] skip (exists): {done}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--out", out]
            if args.mesh:
                cmd += ["--mesh", args.mesh]
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
        run_cell(args.arch, args.shape, out, args.mesh, _coord(args.coord))
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
