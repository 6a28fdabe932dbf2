"""Quickstart: Energon dynamic sparse attention, on the port.

The counterpart of the reference's ``examples/quickstart.py``, on the
same numpy inputs (seed 0; B 1, H 4, n 256, d 64): the paper's
mechanism directly — quantize → multi-round filter → sparse attention —
then the same thing through a config, then the kernel pipeline.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

It runs on ``cuda`` unless given ``--device cpu`` (where the kernels'
plain versions stand in). The CUDA kernels take bfloat16, so on the card
step 4 runs on the bfloat16 inputs.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (
    EnergonConfig,
    MPMRFConfig,
    energon_attention,
    mpmrf_row_select,
)
from repro_torch.core import filtering as flt
from repro_torch.core import sparse_attention as spa
from repro_torch.device import resolve_device


def inputs(B: int = 1, H: int = 4, n: int = 256, d: int = 64):
    """The reference's peaked q/k (keys near a few "important"
    directions, as trained models' are) and random v, from seed 0."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, d))
    q = (centers[rng.integers(0, 8, size=n)]
         + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    k = (centers[rng.integers(0, 8, size=n)]
         + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    v = rng.normal(size=(B, H, n, d)).astype(np.float32)
    q = np.repeat(q[None, None], H, axis=1)
    k = np.repeat(k[None, None], H, axis=1)
    return q, k, v


def run(device=None, log=print) -> Dict[str, object]:
    """The four steps; returns their results."""
    dev = resolve_device(device)
    q, k, v = (torch.from_numpy(x).to(dev) for x in inputs())
    B, H, n, d = q.shape
    valid = flt.causal_valid_mask(n, n, device=dev).expand(B, H, n, n)

    # 1) paper-faithful MP-MRF (Alg. 2): 2-bit round → 4-bit round → keep
    res = mpmrf_row_select(q, k, MPMRFConfig(round_bits=(2, 4)), valid)
    kept = float(res.keep_mask.sum() / valid.sum())
    log(f"MP-MRF kept {kept * 100:.1f}% of query-key pairs "
        f"({1 / kept:.1f}x pruning)")

    # 2) sparse attention on the survivors vs dense attention
    dense = spa.dense_attention(q, k, v, valid)
    sparse = spa.masked_sparse_attention(q, k, v, res.keep_mask)
    rmse = float((dense - sparse).pow(2).mean().sqrt())
    rms = float(dense.pow(2).mean().sqrt())
    log(f"attention output relative RMSE: {rmse / rms:.4f}")

    # 3) one call, config-driven (what the models use)
    out = energon_attention(
        q, k, v, EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0,
                               min_prune_layer=0), causal=True)
    finite = bool(torch.isfinite(out).all())
    log(f"block-sparse path output: {tuple(out.shape)}, finite={finite}")

    # 4) the kernel pipeline (B9 → selection → B10)
    from repro_torch.kernels import ops

    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    qf, kf, vf = (x.reshape(B * H, n, d).to(dt) for x in (q, k, v))
    out_kernel = ops.energon_block_attention(qf, kf, vf, 2, 64, 64, True)
    kfinite = bool(torch.isfinite(out_kernel).all())
    log(f"kernel pipeline output: {tuple(out_kernel.shape)}, "
        f"finite={kfinite}")
    return dict(kept=kept, rel_rmse=rmse / rms, block_out=out,
                kernel_out=out_kernel)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
