"""LMModel — the dense-family serve surface (port of
``repro.models.model.LMModel``): weight init, paged-cache management,
chunked prefill and one-token decode over the shared page pool.

Parameters are a plain dict with the reference pytree's layout and
names, blocks stacked on a leading ``[L]`` axis — so a reference
checkpoint converts leaf by leaf (:mod:`repro_torch.convert`). The page
pool is updated in place; ``prefill`` / ``decode_step`` return it for
parity with the reference's functional signatures. Other families and
the unpaged cache wait for later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.runtime import paged_cache as pgc

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class LMModel:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} waits for a later slice of the port"
            )
        if (cfg.norm != "rmsnorm" or cfg.tie_embeddings
                or cfg.activation != "swiglu"):
            raise NotImplementedError(
                "this slice ports the rmsnorm/SwiGLU, untied-head dense "
                "family"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights with the reference's truncated-normal stds,
        drawn from a seeded ``torch.Generator`` on the model's device
        (the numbers differ from ``jax.random``'s; tests carry reference
        weights across with :mod:`repro_torch.convert` instead)."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        gen = torch.Generator(device=dev).manual_seed(seed)
        d, f, n_l = cfg.d_model, cfg.d_ff, cfg.num_layers

        def tn(shape, std):
            return L.trunc_normal(shape, std, gen, dev, dt)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        def stacked(make):
            first = make()
            out = _stack_like(first, n_l)
            _assign_layer(out, first, 0)
            for i in range(1, n_l):
                _assign_layer(out, make(), i)
            return out

        def block():
            return {
                "norm_attn": {"scale": ones(d)},
                "attn": attn_lib.init_attention(
                    gen, dev, d, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim, use_qk_norm=cfg.use_qk_norm, dtype=dt,
                ),
                "norm_mlp": {"scale": ones(d)},
                "mlp": {"w_up": tn((d, f), d ** -0.5),
                        "w_down": tn((f, d), f ** -0.5),
                        "w_gate": tn((d, f), d ** -0.5)},
            }

        return {
            "embed": {"table": tn((cfg.vocab_size, d), 1.0)},
            "final_norm": {"scale": ones(d)},
            "lm_head": {"w": tn((d, cfg.vocab_size), d ** -0.5)},
            "blocks": stacked(block),
        }

    # ------------------------------------------------------------------
    # paged cache
    # ------------------------------------------------------------------

    def layer_windows(self) -> Optional[List[int]]:
        """Per-layer sliding windows (0 ⇒ global); None ⇒ all global."""
        cfg = self.cfg
        if cfg.sliding_window <= 0 or cfg.global_every <= 0:
            return None
        return [0 if (i + 1) % cfg.global_every == 0 else cfg.sliding_window
                for i in range(cfg.num_layers)]

    def decode_cache_len(self, max_len: int) -> int:
        """Cache rows for a requested ``max_len``: whole decode key
        blocks, at least two (the block dispatch needs n_kb > 1)."""
        e = self.cfg.energon
        if e.uses_decode_block:
            bk = e.decode_key_block
            return max(-(-max_len // bk), 2) * bk
        return max_len

    @property
    def supports_paged(self) -> bool:
        e = self.cfg.energon
        return e.decode_key_block > 0 and e.impl in (
            "mpmrf_row", "mpmrf_block", "pallas"
        )

    def init_paged_cache(
        self, num_pages: int, max_len: Optional[int] = None
    ) -> Dict[str, torch.Tensor]:
        """Per-layer page pools stacked ``[L, ...]``, no batch axis; the
        filter planes exist only when the crossover gate engages at the
        slots' logical capacity ``max_len``."""
        cfg = self.cfg
        if not self.supports_paged:
            raise ValueError(
                f"paged cache unsupported for impl={cfg.energon.impl!r}"
            )
        ps = cfg.energon.decode_key_block
        gate_len = max_len if max_len is not None else num_pages * ps
        one = attn_lib.init_paged_kv_cache(
            num_pages, cfg.num_kv_heads, ps, cfg.head_dim, self.dtype,
            self.device,
            filter_planes=cfg.energon.filter_cache_engages(gate_len),
        )
        return {
            k: torch.zeros((cfg.num_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=self.device)
            for k, v in one.items()
        }

    def reset_pages(self, cache, page_mask: torch.Tensor):
        """Zero the rows, codes and scales of the masked physical pages
        (``page_mask`` bool ``[num_pages]``), in place: a reused page must
        not quantize a new occupant's rows against stale ones."""
        ps = self.cfg.energon.decode_key_block
        pages = torch.nonzero(page_mask.to(self.device)).reshape(-1)
        for key in ("k", "v", "k_codes"):
            if key in cache:
                t = cache[key]
                t.view(*t.shape[:-2], -1, ps, t.shape[-1])[:, :, pages] = 0
        if "k_scale" in cache:
            cache["k_scale"][:, :, pages] = 0
        return cache

    def clone_pages(self, cache, src_pages, dst_pages):
        """Copy-on-write: duplicate whole pages (rows, codes, scale)."""
        return pgc.clone_page_rows(
            cache, self.cfg.energon.decode_key_block, src_pages, dst_pages
        )

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = L.embed_tokens(params["embed"], tokens).to(self.dtype)
        return x * (self.cfg.d_model ** 0.5)

    def _logits_out(self, params, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(params["final_norm"], x)
        return L.lm_logits(params["lm_head"], x)

    def _serve_block_step(self, layer_params, x, attn_call):
        """Pre-norm attention + residual, then the MLP half."""
        cfg = self.cfg
        h = attn_call(
            layer_params["attn"],
            L.rmsnorm(layer_params["norm_attn"], x),
        )
        x = x + h
        h_in = L.rmsnorm(layer_params["norm_mlp"], x)
        return x + L.apply_mlp(layer_params["mlp"], h_in, cfg.activation)

    def _attn_kwargs(self, layer_idx: int, window) -> Dict[str, Any]:
        cfg = self.cfg
        return dict(
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            rope_theta=cfg.rope_theta, use_qk_norm=cfg.use_qk_norm,
            window=window, layer_index=layer_idx,
        )

    @staticmethod
    def _block_table(inputs) -> torch.Tensor:
        bt = inputs.get("block_table")
        if bt is None:
            raise NotImplementedError(
                "the unpaged cache waits for a later slice of the port; "
                "pass inputs['block_table']"
            )
        return bt

    @torch.no_grad()
    def prefill(self, params, cache, inputs: Dict[str, torch.Tensor],
                cache_index: torch.Tensor):
        """Chunked prefill of ``inputs['tokens'] [B, C]`` at
        ``inputs['positions'] [B, C]`` (default ``cache_index + arange``;
        positions ≥ the logical rows are padding sentinels) through
        ``inputs['block_table']``. Returns ``(logits [B, C, V] f32,
        cache)``."""
        cfg = self.cfg
        x = self._embed(params, inputs["tokens"])
        chunk = x.shape[1]
        positions = inputs.get("positions")
        if positions is None:
            positions = cache_index[:, None] + torch.arange(
                chunk, device=x.device
            )[None, :]
        positions = positions.to(torch.int32)
        block_table = self._block_table(inputs)
        write = attn_lib.paged_write_plan(
            positions, block_table, cfg.energon.decode_key_block,
            cache["k"].shape[-2],
        )

        def step_fn(layer_params, x, kv_cache, window, layer_idx):
            def attn(p, xn):
                return attn_lib.paged_prefill_attention_block(
                    p, xn, kv_cache, positions, block_table, write,
                    cfg.energon, **self._attn_kwargs(layer_idx, window),
                )
            return self._serve_block_step(layer_params, x, attn)

        x = tfm.apply_stack_decode(
            params["blocks"], x, cache, self.layer_windows(), step_fn,
            prefix_layers=cfg.energon.min_prune_layer,
        )
        return self._logits_out(params, x), cache

    @torch.no_grad()
    def decode_step(self, params, cache, inputs: Dict[str, torch.Tensor],
                    cache_index: torch.Tensor):
        """One-token decode: ``inputs['tokens'] [B, 1]``, optional
        ``inputs['active'] [B]`` (inactive slots' appends are dropped),
        ``inputs['block_table']``; ``cache_index [B]`` current lengths.
        Returns ``(logits [B, 1, V] f32, cache)``."""
        cfg = self.cfg
        x = self._embed(params, inputs["tokens"])
        active = inputs.get("active")
        block_table = self._block_table(inputs)
        cache_index = cache_index.to(torch.int32)
        write = attn_lib.paged_write_plan(
            cache_index[:, None], block_table, cfg.energon.decode_key_block,
            cache["k"].shape[-2], write_mask=active,
        )

        def step_fn(layer_params, x, kv_cache, window, layer_idx):
            def attn(p, xn):
                return attn_lib.paged_decode_attention_block(
                    p, xn, kv_cache, cache_index, block_table, write,
                    cfg.energon, **self._attn_kwargs(layer_idx, window),
                )
            return self._serve_block_step(layer_params, x, attn)

        x = tfm.apply_stack_decode(
            params["blocks"], x, cache, self.layer_windows(), step_fn,
            prefix_layers=cfg.energon.min_prune_layer,
        )
        return self._logits_out(params, x), cache


def _stack_like(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stack_like(v, n) for k, v in tree.items()}
    return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype,
                       device=tree.device)


def _assign_layer(out, layer, i: int) -> None:
    if isinstance(out, dict):
        for k in out:
            _assign_layer(out[k], layer[k], i)
    else:
        out[i].copy_(layer)
