"""End-to-end training example, on the port: train a ~100M-param LM with
Energon dynamic sparse attention on the synthetic corpus, with
checkpointing and fault tolerance active. The counterpart of the
reference's ``examples/train_lm.py``, with its two configs.

    PYTHONPATH=src python -m repro_torch.train_lm            # full (~100M)
    PYTHONPATH=src python -m repro_torch.train_lm --small    # CI-sized

The full model: 12L, d_model=768, 12 heads — GPT-2-base-class, matching
the paper's Task-B backbone — in f32 with ``remat="dots"`` and
``mpmrf_row`` from layer 2, trained on 8 × 512 tokens a step. It runs on
``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Any, Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import EnergonConfig


def config(small: bool) -> ModelConfig:
    if small:
        return ModelConfig(
            name="train-lm-small", family="dense", num_layers=2,
            d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
            d_ff=256, vocab_size=256, dtype="float32", remat="none",
            energon=EnergonConfig(impl="mpmrf_row", min_prune_layer=1),
        )
    # ~100M params: 12 × (4·768² + 3·768·3072) + embeddings
    return ModelConfig(
        name="train-lm-100m", family="dense", num_layers=12,
        d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=32768, dtype="float32", remat="dots",
        energon=EnergonConfig(impl="mpmrf_row", min_prune_layer=2),
    )


def run(small: bool = False, steps: int = 300,
        checkpoint_dir: Optional[str] = None, device=None,
        corpus_tokens: int = 500_000) -> Dict[str, Any]:
    """Train the example's model; returns :meth:`TrainLoop.run`'s result
    with ``n_params``, ``batch``, ``seq``, ``seconds`` and ``tok_s``."""
    from repro_torch.data import TokenDataset
    from repro_torch.models import LMModel
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import TrainConfig, TrainLoop

    cfg = config(small)
    batch, seq = (8, 128) if small else (8, 512)
    if small:
        steps = min(steps, 60)
    model = LMModel(cfg, device=device)
    n_params = sum(math.prod(s)
                   for _, s in tree_leaves(model.param_shapes()))
    print(f"[train_lm] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{steps} steps of {batch}x{seq} on {model.device}")

    ds = TokenDataset(cfg.vocab_size, seq_len=seq, global_batch=batch,
                      seed=0, corpus_tokens=corpus_tokens)
    loop = TrainLoop(
        model,
        TrainConfig(
            total_steps=steps, log_every=10,
            checkpoint_every=max(steps // 3, 50),
            checkpoint_dir=checkpoint_dir,
            optimizer=AdamWConfig(
                learning_rate=warmup_cosine(3e-4, steps // 10, steps)
            ),
        ),
        ds,
    )
    t0 = time.perf_counter()
    result = loop.run()
    dt = time.perf_counter() - t0
    hist = result["history"]
    tok_s = steps * batch * seq / dt
    span = (f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}"
            if hist else "no step logged")
    print(f"[train_lm] {span} in {dt:.0f}s ({tok_s:.0f} tok/s, "
          f"median step {result['median_step_time']*1e3:.0f}ms, "
          f"stragglers={len(result['stragglers'])})")
    return dict(result, n_params=n_params, batch=batch, seq=seq,
                seconds=dt, tok_s=tok_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)
    return run(args.small, args.steps, args.checkpoint_dir, args.device)


if __name__ == "__main__":
    main()
