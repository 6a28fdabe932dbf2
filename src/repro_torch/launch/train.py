"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains the arch's shipped config (``--smoke``: its reduced widths) on
the synthetic zipf corpus through :class:`repro_torch.runtime.TrainLoop`
— AdamW with a warmup-cosine schedule, microbatch accumulation,
checkpoints with auto-resume — on one device: ``cuda`` unless
``--device`` names another (``--device cpu`` for a smoke run on the
CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --smoke --device cpu --steps 20 --seq-len 64 --global-batch 4

Over a ``(data, model)`` mesh: ``--mesh DxM``, or ``--model-axis M``
(D = devices // M, the reference's ``make_host_mesh``; a host with more
than one device trains on such a mesh by default, as the reference's
launcher does), its devices the host's or ``--simulate-devices N``
entries of ``--device`` (``cuda:0`` × 4 simulates four on one card,
``cpu`` × 4 on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --smoke --device cpu --mesh 2x2 --simulate-devices 4

``--mesh PxDxM`` trains over a ``(pod, data, model)`` mesh: the batch
splits over the P·D data rows (pod major), ZeRO over 'data' alone.

The reference sets ``LIBTPU_INIT_ARGS`` (XLA's latency-hiding scheduler,
async collectives) before JAX starts; the port's single controller runs
a mesh's rows one after another, so it has no counterpart.
``--grad-compression``
carries the int8 error-feedback state in the optimizer, as the
reference's launcher does. A config with ``impl="pallas"`` is refused
by its first step: the CUDA kernels have no backward.
"""

from __future__ import annotations

import argparse
from typing import Optional


def make_loop(cfg, *, steps: int, seq_len: int, global_batch: int,
              lr: float, checkpoint_dir: Optional[str] = None,
              microbatches: int = 1, grad_compression: bool = False,
              device=None, corpus: Optional[int] = None, mesh=None,
              **train_kw):
    """The launcher's :class:`TrainLoop` for ``cfg``: a zipf corpus of
    ``corpus`` tokens (default the reference launcher's size for the
    run's shapes), warmup over the first tenth of ``steps``;
    ``train_kw`` go to :class:`TrainConfig` (``log_every``,
    ``checkpoint_every``, ...); ``mesh`` trains over that mesh."""
    from repro_torch.data import TokenDataset
    from repro_torch.models import LMModel
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.runtime import TrainConfig, TrainLoop

    model = LMModel(cfg, device=device)
    if corpus is None:
        corpus = min(2_000_000, 200 * seq_len * max(global_batch, 8))
    ds = TokenDataset(cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, source="zipf",
                      corpus_tokens=corpus)
    tc = TrainConfig(
        total_steps=steps,
        checkpoint_dir=checkpoint_dir,
        num_microbatches=microbatches,
        optimizer=AdamWConfig(
            learning_rate=warmup_cosine(lr, steps // 10, steps),
            grad_compression=grad_compression,
        ),
        **train_kw,
    )
    return TrainLoop(model, tc, ds, mesh=mesh)


def train_mesh(args):
    """The run's mesh: ``--mesh DxM`` or ``PxDxM``, else
    ``--model-axis M`` over the devices (the host's of ``--device``'s
    type, or ``--simulate-devices`` entries of it) when there is more
    than one; None on one device."""
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh

    device = resolve_device(args.device)
    if args.mesh is not None:
        return serve._mesh(args, device, pod=True)
    devices = serve.mesh_devices(args, device)
    if len(devices) == 1 and args.model_axis == 1:
        return None
    try:
        return make_host_mesh(args.model_axis, devices)
    except ValueError as exc:
        raise SystemExit(f"--model-axis {args.model_axis}: {exc}") from exc


def main(argv=None):
    from repro_torch.configs.registry import (
        ARCH_NAMES, get_config, get_smoke_config,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the mesh's model axis M (D = devices // M)")
    ap.add_argument("--mesh", default=None, metavar="[Px]DxM",
                    help="train over a (data, model) mesh, e.g. 2x2, or a "
                         "(pod, data, model) mesh, e.g. 2x2x2")
    ap.add_argument("--simulate-devices", type=int, default=None,
                    metavar="N", help="the mesh's devices are N entries of "
                    "the one --device (simulates N devices)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)
    mesh = train_mesh(args)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    loop = make_loop(
        cfg, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, lr=args.lr,
        checkpoint_dir=args.checkpoint_dir, microbatches=args.microbatches,
        grad_compression=args.grad_compression, device=args.device,
        mesh=mesh,
    )
    result = loop.run()
    hist = result["history"]
    span = (f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}"
            if hist else "no step logged")
    where = (f"{loop.model.device}" if mesh is None else
             f"a {'x'.join(map(str, mesh.shape.values()))} mesh of "
             f"{', '.join(map(str, mesh.physical_devices))}")
    print(f"[train] {cfg.name} on {where}: "
          f"{result['final_step']} steps, "
          f"median {result['median_step_time']*1e3:.1f} ms/step, {span}, "
          f"stragglers flagged: {len(result['stragglers'])}")
    return result


if __name__ == "__main__":
    main()
