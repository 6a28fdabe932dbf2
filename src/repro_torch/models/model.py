"""LMModel — the dense and MoE families' surface (port of
``repro.models.model.LMModel``): weight init, whole-sequence logits and
loss (``apply`` / ``loss``, forward only), cache management, chunked
prefill and one-token decode over the shared page pool (with
``inputs['block_table']``) or the contiguous per-slot cache (without).
An MoE model's blocks hold ``"moe"`` (router f32, experts in the model
dtype) in place of ``"mlp"``; its auxiliary loss joins ``apply`` and
``loss``.

Parameters are a plain dict with the reference pytree's layout and
names, blocks stacked on a leading ``[L]`` axis — so a reference
checkpoint converts leaf by leaf (:mod:`repro_torch.convert`). Caches
are updated in place; ``prefill`` / ``decode_step`` return them for
parity with the reference's functional signatures. The other families
(ssm, hybrid, vlm, audio) wait for later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tfm
from repro_torch.runtime import paged_cache as pgc

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class LMModel:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} waits for a later slice of the port"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]

    def _moe_cfg(self) -> Optional[moe_lib.MoEConfig]:
        cfg = self.cfg
        if cfg.family != "moe":
            return None
        return moe_lib.MoEConfig(
            num_experts=cfg.num_experts,
            experts_per_token=cfg.experts_per_token,
            d_model=cfg.d_model,
            d_ff=cfg.d_ff,
            activation=cfg.activation,
            capacity_factor=cfg.capacity_factor,
            quantized_weight_gather=cfg.moe_quantized_gather,
        )

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights with the reference's truncated-normal stds,
        drawn from a seeded ``torch.Generator`` on the model's device
        (the numbers differ from ``jax.random``'s; tests carry reference
        weights across with :mod:`repro_torch.convert` instead)."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        # the meta device (``param_shapes``) draws nothing
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        d, f, n_l = cfg.d_model, cfg.d_ff, cfg.num_layers

        def tn(shape, std):
            return L.trunc_normal(shape, std, gen, dev, dt)

        def stacked(make):
            first = make()
            out = _stack_like(first, n_l)
            _assign_layer(out, first, 0)
            del first        # one layer's draws alive at a time
            for i in range(1, n_l):
                _assign_layer(out, make(), i)
            return out

        def norm():
            return L.init_norm(cfg.norm, d, dt, dev)

        def mlp():
            out = {"w_up": tn((d, f), d ** -0.5),
                   "w_down": tn((f, d), f ** -0.5)}
            if cfg.activation in L.GATED_ACTIVATIONS:
                out["w_gate"] = tn((d, f), d ** -0.5)
            return out

        moe_cfg = self._moe_cfg()

        def block():
            out = {
                "norm_attn": norm(),
                "attn": attn_lib.init_attention(
                    gen, dev, d, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim, use_qk_norm=cfg.use_qk_norm, dtype=dt,
                ),
                "norm_mlp": norm(),
            }
            if moe_cfg is not None:     # the router in f32
                out["moe"] = moe_lib.init_moe(moe_cfg, gen, dev, dt)
            else:
                out["mlp"] = mlp()
            return out

        params = {
            "embed": {"table": tn((cfg.vocab_size, d), 1.0)},
            "final_norm": norm(),
        }
        if not cfg.tie_embeddings:       # a tied head reads embed.table
            params["lm_head"] = {"w": tn((d, cfg.vocab_size), d ** -0.5)}
        params["blocks"] = stacked(block)
        return params

    def param_shapes(self) -> Dict[str, Any]:
        """:meth:`init`'s tree with each leaf's shape, built on the meta
        device (nothing is allocated)."""
        return _tree_map(lambda a: tuple(a.shape), self._meta_params())

    def param_dtypes(self) -> Dict[str, Any]:
        """:meth:`init`'s tree with each leaf's dtype: the model dtype,
        but an MoE router's float32."""
        return _tree_map(lambda a: a.dtype, self._meta_params())

    def _meta_params(self) -> Dict[str, Any]:
        return LMModel(self.cfg, device="meta").init()

    # ------------------------------------------------------------------
    # forward (scoring)
    # ------------------------------------------------------------------

    def _tfm_block_fn(self):
        cfg, moe_cfg = self.cfg, self._moe_cfg()

        def block_fn(layer_params, x, window, layer_idx):
            return tfm.apply_block(
                layer_params, x, cfg.energon,
                activation=cfg.activation, norm=cfg.norm, moe_cfg=moe_cfg,
                **self._attn_kwargs(layer_idx, window),
            )

        return block_fn

    @torch.no_grad()
    def apply(self, params, batch: Dict[str, torch.Tensor]):
        """Whole-sequence logits of ``batch['inputs'] [B, n]`` (int
        tokens). Returns ``(logits [B, n, V] f32, aux)``; ``aux`` is the
        reference's auxiliary loss — the MoE layers' load-balancing
        losses summed in layer order, exactly 0 for the dense family.
        Forward only:
        the sparse layers run the kernels, which have no backward here
        (``kernels.ops.energon_block_attention`` is the differentiable
        pipeline)."""
        cfg = self.cfg
        x = self._embed(params, batch["inputs"])
        x, aux = tfm.apply_stack(
            params["blocks"], x, self.layer_windows(), self._tfm_block_fn(),
            prefix_layers=cfg.energon.min_prune_layer,
        )
        return self._logits_out(params, x), aux

    @torch.no_grad()
    def loss(self, params, batch: Dict[str, torch.Tensor]):
        """Mean cross-entropy of ``batch['targets'] [B, n]`` under
        :meth:`apply`'s logits (optional ``batch['mask']``). Returns
        ``(loss, metrics)`` with ``loss`` / ``ce`` / ``aux`` / ``tokens``."""
        logits, aux = self.apply(params, batch)
        ce, n_tokens = L.softmax_cross_entropy(
            logits, batch["targets"], batch.get("mask")
        )
        total = ce + aux
        return total, {"loss": total, "ce": ce, "aux": aux,
                       "tokens": n_tokens}

    # ------------------------------------------------------------------
    # serving caches
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

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Contiguous per-slot caches stacked ``[L, B, KV, rows, hd]``
        (rows = :meth:`decode_cache_len`); the filter planes exist only
        when the crossover gate engages at that length."""
        cfg = self.cfg
        rows = self.decode_cache_len(max_len)
        filter_block = (cfg.energon.decode_key_block
                        if cfg.energon.filter_cache_engages(rows) else 0)
        one = attn_lib.init_kv_cache(
            batch, cfg.num_kv_heads, rows, cfg.head_dim, self.dtype,
            "meta", filter_block=filter_block,
        )
        scratch = attn_lib.contiguous_scratch(cfg.head_dim)
        return {
            k: attn_lib.stacked_leaf(cfg.num_layers, v.shape, v.dtype,
                                     self.device, scratch.get(k, 0))
            for k, v in one.items()
        }

    def reset_decode_slots(self, cache, reset_mask: torch.Tensor):
        """Zero, in place, the K/V rows, codes and scales of the masked
        slots (``reset_mask`` bool ``[B]``) of a contiguous cache: a block
        mixing a new prompt's rows with its previous occupant's stale ones
        would quantize the real rows against an inflated absmax. Only
        ``impl="dense"``, which never quantizes, keeps the stale rows
        (positional writes overwrite them before they are read)."""
        if self.cfg.energon.impl == "dense":
            return cache
        slots = torch.nonzero(reset_mask.to(self.device)).reshape(-1)
        for key in ("k", "v", "k_codes", "k_scale"):
            if key in cache:
                cache[key][:, slots] = 0
        return cache

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
            "meta",
            filter_planes=cfg.energon.filter_cache_engages(gate_len),
        )
        scratch = attn_lib.paged_scratch(ps, cfg.head_dim)
        return {
            k: attn_lib.stacked_leaf(cfg.num_layers, v.shape, v.dtype,
                                     self.device, scratch[k])
            for k, v in one.items()
        }

    def reset_pages(self, cache, page_mask: torch.Tensor):
        """Zero the rows, codes and scales of the masked physical pages
        (``page_mask`` bool ``[num_pages]``), in place — on every shard of
        a head-sharded pool: a reused page must not quantize a new
        occupant's rows against stale ones."""
        ps = self.cfg.energon.decode_key_block
        for part in pgc.pool_shards(cache) or [cache]:
            pages = torch.nonzero(page_mask.to(part["k"].device)).reshape(-1)
            for key in ("k", "v", "k_codes"):
                if key in part:
                    t = part[key]
                    t.view(*t.shape[:-2], -1, ps, t.shape[-1])[:, :, pages] = 0
            if "k_scale" in part:
                part["k_scale"][:, :, pages] = 0
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
        x = L.apply_norm(self.cfg.norm, params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return L.tied_lm_logits(params["embed"], x)
        return L.lm_logits(params["lm_head"], x)

    def _attn_kwargs(self, layer_idx: int, window) -> Dict[str, Any]:
        """A layer's attention arguments. A global layer of a windowed
        model (window 0) passes no window, so the fused kernels take it
        (the reference passes its scanned 0 and routes the layer to the
        XLA paths; their survivor tables are the same)."""
        cfg = self.cfg
        return dict(
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            rope_theta=cfg.rope_theta, use_qk_norm=cfg.use_qk_norm,
            window=window or None, layer_index=layer_idx,
        )

    def _write_plan(self, cache, positions, block_table, active=None):
        """The call's fixed-shape cache write plan (the same for every
        layer; on a head-sharded pool, one shard's heads, the same for
        every shard)."""
        cfg = self.cfg
        leaf = cache["k"]
        if isinstance(leaf, tuple):
            leaf = leaf[0]
        rows = leaf.shape[-2]
        if block_table is None:
            return attn_lib.cache_write_plan(positions, rows,
                                             cfg.num_kv_heads)
        return attn_lib.paged_write_plan(
            positions, block_table, cfg.energon.decode_key_block, rows,
            leaf.shape[-3], write_mask=active,
        )

    @torch.no_grad()
    def prefill(self, params, cache, inputs: Dict[str, torch.Tensor],
                cache_index: torch.Tensor, telemetry: bool = False):
        """Chunked prefill of ``inputs['tokens'] [B, C]`` at
        ``inputs['positions'] [B, C]`` (default ``cache_index + arange``;
        positions ≥ the cache rows are padding sentinels), through
        ``inputs['block_table']`` into the page pool when given, else
        into the contiguous cache. Returns ``(logits [B, C, V] f32,
        cache)``; with ``telemetry``, ``(logits, cache, stats)`` where
        stats is int32 ``[L, B, 4]`` per-layer selection counts
        (:func:`repro_torch.core.filtering.selection_stats`; zeros for
        the dense prefix layers). Logits and cache are the same bits
        either way."""
        cfg, moe_cfg = self.cfg, self._moe_cfg()
        x = self._embed(params, inputs["tokens"])
        chunk = x.shape[1]
        positions = inputs.get("positions")
        if positions is None:
            positions = cache_index[:, None] + torch.arange(
                chunk, device=x.device
            )[None, :]
        positions = positions.to(torch.int32)
        block_table = inputs.get("block_table")
        write = self._write_plan(cache, positions, block_table)
        if block_table is None:
            block, where = attn_lib.prefill_attention_block, ()
        else:
            block = attn_lib.paged_prefill_attention_block
            where = (block_table,)

        def step_fn(layer_params, x, kv_cache, window, layer_idx):
            def attn(p, xn):
                return block(
                    p, xn, kv_cache, positions, *where, write, cfg.energon,
                    **self._attn_kwargs(layer_idx, window),
                    telemetry=telemetry,
                )
            return tfm.block_step(layer_params, x, attn,
                                  activation=cfg.activation, norm=cfg.norm,
                                  telemetry=telemetry, moe_cfg=moe_cfg)

        return self._serve_out(params, cache, tfm.apply_stack_decode(
            params["blocks"], x, cache, self.layer_windows(), step_fn,
            prefix_layers=cfg.energon.min_prune_layer, telemetry=telemetry,
        ), telemetry)

    def _serve_out(self, params, cache, out, telemetry: bool):
        """``(logits, cache)`` of a serve step's stack output, or with
        ``telemetry`` ``(logits, cache, stats)``."""
        if telemetry:
            x, stats = out
            return self._logits_out(params, x), cache, stats
        return self._logits_out(params, out), cache

    @torch.no_grad()
    def decode_step(self, params, cache, inputs: Dict[str, torch.Tensor],
                    cache_index: torch.Tensor, telemetry: bool = False):
        """One-token decode: ``inputs['tokens'] [B, 1]``; ``cache_index
        [B]`` current lengths. With ``inputs['block_table']`` the page
        pool is read and optional ``inputs['active'] [B]`` drops inactive
        slots' appends; without it the contiguous cache is written
        positionally, as in the reference (an index ≥ the cache rows
        writes nothing — the engine's idle-slot sentinel). Returns
        ``(logits [B, 1, V] f32, cache)``; with ``telemetry`` also the
        int32 ``[L, B, 4]`` stats, as :meth:`prefill`."""
        cfg, moe_cfg = self.cfg, self._moe_cfg()
        x = self._embed(params, inputs["tokens"])
        block_table = inputs.get("block_table")
        cache_index = cache_index.to(torch.int32)
        write = self._write_plan(cache, cache_index[:, None], block_table,
                                 inputs.get("active"))
        if block_table is None:
            block, where = attn_lib.decode_attention_block, ()
        else:
            block = attn_lib.paged_decode_attention_block
            where = (block_table,)

        def step_fn(layer_params, x, kv_cache, window, layer_idx):
            def attn(p, xn):
                return block(
                    p, xn, kv_cache, cache_index, *where, write, cfg.energon,
                    **self._attn_kwargs(layer_idx, window),
                    telemetry=telemetry,
                )
            return tfm.block_step(layer_params, x, attn,
                                  activation=cfg.activation, norm=cfg.norm,
                                  telemetry=telemetry, moe_cfg=moe_cfg)

        return self._serve_out(params, cache, tfm.apply_stack_decode(
            params["blocks"], x, cache, self.layer_windows(), step_fn,
            prefix_layers=cfg.energon.min_prune_layer, telemetry=telemetry,
        ), telemetry)


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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
