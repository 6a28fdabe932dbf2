"""LMModel — one config-driven surface for every family of the
reference (port of ``repro.models.model.LMModel``): weight init,
whole-sequence logits and loss (``apply`` / ``loss``, differentiable
in the params, rematerialized per ``cfg.remat``), cache management,
chunked prefill and one-token decode.

Families:
  dense / moe / vlm / audio — the decoder transformer stack, served over
      the shared page pool (with ``inputs['block_table']``) or the
      contiguous per-slot cache (without). An MoE model's blocks hold
      ``"moe"`` (router f32, experts in the model dtype) in place of
      ``"mlp"``; its auxiliary loss joins ``apply`` and ``loss``. vlm /
      audio read ``embeddings [B, n, d_model]`` in place of tokens where
      given (the modality frontend is a stub,
      :mod:`repro_torch.models.multimodal`), cast to the model dtype
      without the token path's √d_model scale.
  ssm    — xLSTM: groups of (m × mLSTM + s × sLSTM), ``mlstm``
      ``[groups, m]`` and ``slstm`` ``[groups]``.
  hybrid — zamba2: groups of (period − 1 Mamba2 layers, the one shared
      attention block, one Mamba2 layer), then the tail Mamba2 layers:
      ``mamba_pre`` ``[groups, period − 1]``, ``mamba_post`` ``[groups]``,
      ``mamba_tail`` ``[tail]``, ``shared`` one unstacked block. The
      shared block runs at layer index 10**9, so it is sparse.

The recurrent families (ssm, hybrid) have no chunked prefill
(:attr:`LMModel.supports_prefill`) and no page pool: the serving loop
admits their prompts token by token through ``decode_step`` under an
``active`` mask, and their recurrent state advances only on the active
slots.

Parameters are a plain dict with the reference pytree's layout and
names, stacked layers on leading axes — so a reference checkpoint
converts leaf by leaf (:mod:`repro_torch.convert`). Caches are updated
in place, every leaf allocated once (the graphed steps replay over
them); ``prefill`` / ``decode_step`` return them for parity with the
reference's functional signatures.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.runtime import paged_cache as pgc

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
#: the families that run the decoder transformer stack
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "audio")
#: the shared attention block's layer index (sparse, never windowed)
SHARED_LAYER = 10**9


class LMModel:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family not in TRANSFORMER_FAMILIES + ("ssm", "hybrid"):
            raise ValueError(f"unknown family {cfg.family}")
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

        def stacked(make, n=n_l):
            first = make()
            out = _stack_like(first, n)
            _assign_layer(out, first, 0)
            del first        # one layer's draws alive at a time
            for i in range(1, n):
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
        if cfg.family in TRANSFORMER_FAMILIES:
            params["blocks"] = stacked(block)
        elif cfg.family == "ssm":
            m_per, groups = self._xlstm_layout()

            def cell(init):
                return lambda: {"norm": norm(), "cell": init(
                    gen, dev, d, cfg.num_heads, dt)}

            params["mlstm"] = stacked(
                lambda: stacked(cell(ssm_lib.init_mlstm), m_per), groups)
            params["slstm"] = stacked(cell(ssm_lib.init_slstm), groups)
        else:
            period, groups, tail = self._hybrid_layout()

            def mamba():
                return {"norm": norm(), "cell": ssm_lib.init_mamba2(
                    gen, dev, d, cfg.ssm_state, cfg.ssm_head_dim,
                    dtype=dt)}

            params["mamba_pre"] = stacked(
                lambda: stacked(mamba, period - 1), groups)
            params["mamba_post"] = stacked(mamba, groups)
            if tail:
                params["mamba_tail"] = stacked(mamba, tail)
            params["shared"] = block()
        return params

    def _xlstm_layout(self):
        """(mLSTM layers a group, groups) of the ssm family."""
        m_per, s_per = self.cfg.xlstm_group
        return m_per, self.cfg.num_layers // (m_per + s_per)

    def _hybrid_layout(self):
        """(period, groups, tail layers) of the hybrid family."""
        period = self.cfg.hybrid_attn_every
        groups = self.cfg.num_layers // period
        return period, groups, self.cfg.num_layers - groups * period

    def param_shapes(self) -> Dict[str, Any]:
        """:meth:`init`'s tree with each leaf's shape, built on the meta
        device (nothing is allocated)."""
        return _tree_map(lambda a: tuple(a.shape), self._meta_params())

    def param_dtypes(self) -> Dict[str, Any]:
        """:meth:`init`'s tree with each leaf's dtype: the model dtype,
        but an MoE router's and a Mamba2 cell's ``a_log`` / ``dt_bias`` /
        ``d_skip`` float32."""
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

    def apply(self, params, batch: Dict[str, torch.Tensor], mesh=None):
        """Whole-sequence logits of ``batch['inputs'] [B, n]`` (int
        tokens; a vlm / audio model reads ``batch['embeddings'] [B, n,
        d_model]`` instead where given). Returns ``(logits [B, n, V]
        f32, aux)``; ``aux`` is the reference's auxiliary loss — the MoE
        layers' load-balancing losses summed in layer order, exactly 0
        for every other family.

        Differentiable in ``params`` (and ``embeddings``): each layer
        runs under ``cfg.remat`` (:func:`transformer.remat_fn`; the
        recurrent families checkpoint their blocks whenever remat is not
        ``"none"``, as the reference does). The CUDA kernels have no
        backward, as the reference's Pallas kernels have none: under
        grad the direct ``impl="pallas"`` route raises, and the chunked
        route takes the torch scan
        (:func:`repro_torch.core.energon_attention.energon_attention`).

        With ``mesh`` ``params`` is a sharded tree
        (:func:`~repro_torch.distributed.sharding.shard_tree`) and the
        call runs over the mesh (:meth:`_mesh_forward`); the logits come
        back gathered on the mesh's first device."""
        if mesh is not None:
            rows, logits, aux, _ = self._mesh_forward(params, batch, mesh)
            dev = mesh.first_device
            whole = [torch.cat([s.to(dev) for s in lg], dim=-1)
                     if isinstance(lg, tuple) else lg.to(dev)
                     for lg in logits]
            return torch.cat(whole, dim=0), aux
        cfg = self.cfg
        x = self._embed_in(params, batch, "inputs")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in TRANSFORMER_FAMILIES:
            x, aux = tfm.apply_stack(
                params["blocks"], x, self.layer_windows(),
                self._tfm_block_fn(), remat=cfg.remat,
                prefix_layers=cfg.energon.min_prune_layer,
            )
        elif cfg.family == "ssm":
            x = self._apply_xlstm(params, x)
        else:
            x = self._apply_hybrid(params, x)
        return self._logits_out(params, x), aux

    def _block_remat(self, fn):
        """A recurrent family's block under its checkpoint: the whole
        block recomputed whenever ``cfg.remat`` is not ``"none"``."""
        return tfm.remat_fn(fn, "none" if self.cfg.remat == "none"
                            else "full")

    def _apply_xlstm(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg

        def residual(seq):
            def block(p, x):
                return x + seq(p["cell"], L.apply_norm(cfg.norm, p["norm"],
                                                       x), cfg.num_heads)
            return self._block_remat(block)

        mlstm_block = residual(ssm_lib.mlstm_seq)
        slstm_block = residual(ssm_lib.slstm_seq)
        for group, sp in zip(tfm.unstack(params["mlstm"]),
                             tfm.unstack(params["slstm"])):
            for mp in tfm.unstack(group):
                x = mlstm_block(mp, x)
            x = slstm_block(sp, x)
        return x

    def _mamba_layers(self, params):
        """Each Mamba2 layer's parameters in the hybrid's layer order,
        with None where the shared attention block runs."""
        period, groups, tail = self._hybrid_layout()
        pre, post = (tfm.unstack(params[k]) for k in ("mamba_pre",
                                                      "mamba_post"))
        for g in range(groups):
            for j, p in enumerate(tfm.unstack(pre[g])):
                yield ("mamba_pre", g, j), p
            yield ("shared_attn", g), None
            yield ("mamba_post", g), post[g]
        if tail:
            for t, p in enumerate(tfm.unstack(params["mamba_tail"])):
                yield ("mamba_tail", t), p

    def _apply_hybrid(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        block_fn = self._tfm_block_fn()
        # the shared block's weights are shared: every group's call
        # reads the same leaves, and their gradients add up there
        shared_block = self._block_remat(
            lambda p, x: block_fn(p, x, None, SHARED_LAYER)[0])
        mamba_block = self._block_remat(
            lambda p, x: x + ssm_lib.mamba2_seq(
                p["cell"], L.apply_norm(cfg.norm, p["norm"], x),
                cfg.ssm_state, cfg.ssm_head_dim))
        for _, p in self._mamba_layers(params):
            x = (shared_block(params["shared"], x) if p is None
                 else mamba_block(p, x))
        return x

    def loss(self, params, batch: Dict[str, torch.Tensor], mesh=None):
        """Mean cross-entropy of ``batch['targets'] [B, n]`` under
        :meth:`apply`'s logits (optional ``batch['mask']``). Returns
        ``(loss, metrics)`` with ``loss`` / ``ce`` / ``aux`` / ``tokens``.

        With ``mesh`` (``params`` sharded): each data row's summed token
        losses over 'model''s vocab shards, added over the rows in f32
        and divided by the whole batch's count — the global mean, not a
        mean of the rows' means — plus the aux loss (an MoE layer's, the
        mean over the rows where its experts run per row)."""
        if mesh is not None:
            return self._mesh_loss(params, batch, mesh)
        logits, aux = self.apply(params, batch)
        ce, n_tokens = L.softmax_cross_entropy(
            logits, batch["targets"], batch.get("mask")
        )
        total = ce + aux
        return total, {"loss": total, "ce": ce, "aux": aux,
                       "tokens": n_tokens}

    # ------------------------------------------------------------------
    # training over a (data, model) or (pod, data, model) mesh
    # ------------------------------------------------------------------

    def _mesh_loss(self, params, batch, mesh):
        rows, logits, aux, split = self._mesh_forward(params, batch, mesh)
        dev = mesh.first_device
        targets = split(batch["targets"])
        masks = (split(batch["mask"]) if batch.get("mask") is not None
                 else [None] * len(rows))
        sums = []
        for lg, tg, mk in zip(logits, targets, masks):
            nll = L.token_nll(lg, tg)
            sums.append((nll if mk is None else nll * mk.float()).sum())
        mask = batch.get("mask")
        count = (float(batch["targets"].numel()) if mask is None
                 else torch.as_tensor(mask).float().sum().to(dev))
        total = torch.clamp(torch.as_tensor(count, dtype=torch.float32,
                                            device=dev), min=1.0)
        ce = col.all_reduce(sums, dev, axes=mesh.data_axes,
                            share=col.share_of(mesh, mesh.data_axes)) / total
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": total}

    def _mesh_forward(self, params, batch, mesh, last_only: bool = False):
        """The stack over ``mesh`` for a sharded ``params``: the batch
        splits over the data rows (pod × data, pod major:
        :func:`~repro_torch.distributed.sharding.batch_rows`; row r's
        rows on ``mesh.rows[r][0]``), every
        layer reads its weights through ``row_views`` (the ZeRO gather
        over 'data', and the model-axis shards the tensor-parallel
        layers split over), and the rows run one after another. Returns
        ``(rows, logits per row — an M-tuple of vocab shards where the
        head is vocab-sharded —, aux on the first device, split)``:
        ``split(t)`` cuts a batch tensor into the rows' parts.
        ``last_only`` takes the last position alone through the head (a
        serving prefill's logits). A share (``Mesh.share``) runs its own
        row and model shard: the batch stays logical, it cuts its rows."""
        cfg = self.cfg
        key = "embeddings" if (cfg.uses_embeddings_input
                               and "embeddings" in batch) else "inputs"
        rows, n_rows, split, _ = self._mesh_rows(batch[key].shape[0], mesh)
        if key == "embeddings":
            x_rows = [e.to(self.dtype) for e in split(batch[key])]
        else:
            embed = shd.row_views({"embed": params["embed"]}, mesh, rows)
            x_rows = [self._embed(e, tok)
                      for e, tok in zip(embed, split(batch[key]))]
        aux = torch.zeros((), dtype=torch.float32, device=mesh.first_device)
        if cfg.family in TRANSFORMER_FAMILIES:
            fn = tfm.remat_fn(self._mesh_block_fn(
                mesh, rows, n_rows, batch[key].numel() // (
                    cfg.d_model if key == "embeddings" else 1)), cfg.remat)
            windows = self.layer_windows()
            prefix = cfg.energon.min_prune_layer
            for i, layer in enumerate(tfm.unstack(params["blocks"])):
                window = None if windows is None else windows[i]
                x_rows, a = fn(layer, x_rows, window,
                               0 if i < prefix else prefix)
                if a is not None:
                    aux = aux + a
        elif cfg.family == "ssm":
            x_rows = self._mesh_xlstm(params, x_rows, mesh, rows)
        else:
            x_rows = self._mesh_hybrid(params, x_rows, mesh, rows)
        head = {"final_norm": params["final_norm"],
                "head": params["embed"] if cfg.tie_embeddings
                else params["lm_head"]}
        logits = []
        for view, x in zip(shd.row_views(head, mesh, rows), x_rows):
            if last_only:
                x = x[:, -1:]
            x = L.apply_norm(cfg.norm, view["final_norm"], x)
            logits.append(L.tied_lm_logits(view["head"], x)
                          if cfg.tie_embeddings
                          else L.lm_logits(view["head"], x))
        return rows, logits, aux, split

    def _mesh_rows(self, batch_size: int, mesh):
        """``(rows, n_rows, split, slots)`` of a mesh call over a logical
        batch of ``batch_size``: the batch splits over the ``n_rows``
        data rows (:func:`~repro_torch.distributed.sharding.batch_rows`);
        ``rows`` index ``mesh.rows`` — every row, or a share's one —,
        ``slots`` say which slice of the batch each of them takes, and
        ``split(t)`` gives each its slice of a logical batch tensor on
        its first device (a share cuts its own)."""
        n_rows = shd.batch_rows(batch_size, mesh)
        per = batch_size // n_rows
        if mesh.coord is None:
            rows = list(range(n_rows))
            slots = rows
        else:
            rows = [0]
            slots = [mesh.share_row if n_rows > 1 else 0]

        def split(t):
            t = torch.as_tensor(t)
            return [t[s * per:(s + 1) * per].to(mesh.rows[r][0])
                    for r, s in zip(rows, slots)]

        return rows, n_rows, split, slots

    def _mesh_moe(self, layer_moe, h_in, mesh, rows, n_rows: int,
                  tokens: int):
        """The MoE FFN of one layer over the rows' ``h_in``: ``(outs,
        aux)``. Under the ``"serve"`` profile for at most
        ``moe.SERVE_2D_TOKENS`` tokens — ``tokens``, the logical batch's,
        however the rows split it — the 2-D expert layer over every row's
        tokens (:func:`moe.apply_moe_serve_2d` on the experts' 2-D
        shards); else, where the experts divide over 'model', each row
        expert-parallel with its own capacity (:func:`moe.moe_rows`,
        int8 ZeRO gathers under ``quantized_weight_gather``); else the
        reference's single-device MoE over every row's tokens at once
        (its capacity the whole batch's, as GSPMD computes it)."""
        moe_cfg = self._moe_cfg()
        dev = h_in[0].device
        per = h_in[0].shape[0]

        def whole():
            if n_rows == 1:
                return h_in[0]
            return col.all_gather(
                h_in, 0, [dev], axes=mesh.data_axes,
                share=col.share_of(mesh, mesh.data_axes))[0]

        def back(out):
            return [out[i * per:(i + 1) * per].to(h.device)
                    for i, h in enumerate(h_in)]

        if shd.expert_shards(moe_cfg.num_experts, mesh) > 1:
            if (shd.get_rules_profile() == "serve"
                    and tokens <= moe_lib.SERVE_2D_TOKENS):
                router = shd.row_views({"router": layer_moe["router"]},
                                       mesh, rows[:1])[0]["router"]
                params = dict(layer_moe, router=router)
                out, met = moe_lib.apply_moe_serve_2d(params, whole(),
                                                      moe_cfg, mesh)
                return back(out), met["moe_aux_loss"]
            experts = shd.row_views(
                layer_moe, mesh, rows,
                quantized=moe_cfg.quantized_weight_gather)
            outs, met = moe_lib.moe_rows(experts, h_in, moe_cfg, mesh, rows)
            return outs, met["moe_aux_loss"]
        view = shd.row_views(layer_moe, mesh, rows[:1])[0]
        out, met = moe_lib.apply_moe(view, whole(), moe_cfg)
        return back(out), met["moe_aux_loss"]

    def _mesh_block_fn(self, mesh, rows, n_rows: int = 1, tokens: int = 0):
        """One decoder layer over the rows: ``(layer shards, x_rows,
        window, layer_idx) -> (x_rows, aux)``. Attention and the MLP run
        per row with the model axis splitting heads and columns; an MoE
        layer whose experts divide over 'model' runs per row with the
        row's capacity (:func:`moe.moe_rows`, int8 ZeRO gathers under
        ``quantized_weight_gather``), any other the reference's
        single-device MoE over every row's tokens at once (its capacity
        the whole batch's, as GSPMD computes it). Query heads that do not
        divide 'model' split over it as GSPMD splits them
        (:func:`~repro_torch.distributed.sharding.uneven_head_views`)."""
        cfg, moe_cfg = self.cfg, self._moe_cfg()

        def block_fn(layer, x_rows, window, layer_idx):
            kw = self._attn_kwargs(layer_idx, window)
            views = shd.row_views(
                {k: layer[k] for k in ("norm_attn", "attn", "norm_mlp")},
                mesh, rows)
            xs, h_in = [], []
            for r, view, x in zip(rows, views, x_rows):
                attn = shd.uneven_head_views(view["attn"], mesh, r,
                                             cfg.num_heads)
                x = x + attn_lib.attention_block(
                    attn, L.apply_norm(cfg.norm, view["norm_attn"], x),
                    cfg.energon, **kw)
                xs.append(x)
                h_in.append(L.apply_norm(cfg.norm, view["norm_mlp"], x))
            aux = None
            if moe_cfg is None:
                mlp = shd.row_views(layer["mlp"], mesh, rows)
                outs = [L.apply_mlp(v, h, cfg.activation)
                        for v, h in zip(mlp, h_in)]
            else:
                outs, aux = self._mesh_moe(layer["moe"], h_in, mesh, rows,
                                           n_rows, tokens)
            return [x + o for x, o in zip(xs, outs)], aux

        return block_fn

    def _mesh_cell_block(self, seq, mesh, rows):
        """A recurrent residual block over the rows, ``(layer shards,
        x_rows) -> x_rows``: the cell's weights gathered whole onto each
        row (over 'data' and 'model'), ``x + seq(cell, norm(x))`` run
        batch-parallel on the row's first device (the reference's
        ``slstm_seq`` shard_map; mLSTM and Mamba2 alike)."""
        cfg = self.cfg

        def block(p, x_rows):
            views = shd.row_views(p, mesh, rows, whole=True)
            return [x + seq(v["cell"], L.apply_norm(cfg.norm, v["norm"], x))
                    for v, x in zip(views, x_rows)]

        return self._block_remat(block)

    def _mesh_xlstm(self, params, x_rows, mesh, rows):
        h = self.cfg.num_heads
        mlstm = self._mesh_cell_block(
            lambda c, x: ssm_lib.mlstm_seq(c, x, h), mesh, rows)
        slstm = self._mesh_cell_block(
            lambda c, x: ssm_lib.slstm_seq(c, x, h), mesh, rows)
        for group, sp in zip(tfm.unstack(params["mlstm"]),
                             tfm.unstack(params["slstm"])):
            for mp in tfm.unstack(group):
                x_rows = mlstm(mp, x_rows)
            x_rows = slstm(sp, x_rows)
        return x_rows

    def _mesh_hybrid(self, params, x_rows, mesh, rows):
        cfg = self.cfg
        block_fn = self._mesh_block_fn(mesh, rows)
        shared = self._block_remat(
            lambda p, xr: block_fn(p, xr, None, SHARED_LAYER)[0])
        mamba = self._mesh_cell_block(
            lambda c, x: ssm_lib.mamba2_seq(c, x, cfg.ssm_state,
                                            cfg.ssm_head_dim), mesh, rows)
        for _, p in self._mamba_layers(params):
            x_rows = (shared(params["shared"], x_rows) if p is None
                      else mamba(p, x_rows))
        return x_rows

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
    def supports_prefill(self) -> bool:
        """True when the family has a multi-token chunked-prefill path.
        The recurrent families (ssm, hybrid) carry sequential state and
        admit prompts token by token in the serving loop."""
        return self.cfg.family in TRANSFORMER_FAMILIES

    @property
    def supports_paged(self) -> bool:
        """True when the family can serve from the shared page pool: a
        positional KV cache (an attention family: recurrent state is
        O(1) per slot), a positive ``decode_key_block`` (pages are decode
        key blocks) and a non-dense impl."""
        e = self.cfg.energon
        return self.supports_prefill and e.decode_key_block > 0 and (
            e.impl in ("mpmrf_row", "mpmrf_block", "pallas"))

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """The decode cache of ``batch`` slots, each leaf allocated once
        by :func:`attention.stacked_leaf`. An attention family's
        contiguous per-slot K/V caches are stacked ``[L, B, KV, rows,
        hd]`` (rows = :meth:`decode_cache_len`), the filter planes only
        where the crossover gate engages at that length. The ssm family's
        recurrent states are stacked ``[groups, m]`` (``mlstm``) and
        ``[groups]`` (``slstm``); the hybrid's ``[groups, period − 1]``
        (``mamba_pre``), ``[groups]`` (``mamba_post``, and
        ``shared_attn``: one contiguous K/V cache a group, gated as the
        dense one) and ``[tail]`` (``mamba_tail``)."""
        cfg = self.cfg
        rows = self.decode_cache_len(max_len)

        def stack(n, tree, scratch=None):
            lead = n if isinstance(n, tuple) else (n,)
            return {k: attn_lib.stacked_leaf(
                lead[0], lead[1:] + tuple(v.shape), v.dtype, self.device,
                (scratch or {}).get(k, 0)) for k, v in tree.items()}

        def attn_cache(n):
            filter_block = (cfg.energon.decode_key_block
                            if cfg.energon.filter_cache_engages(rows) else 0)
            one = attn_lib.init_kv_cache(
                batch, cfg.num_kv_heads, rows, cfg.head_dim, self.dtype,
                "meta", filter_block=filter_block,
            )
            return stack(n, one, attn_lib.contiguous_scratch(cfg.head_dim))

        if cfg.family in TRANSFORMER_FAMILIES:
            return attn_cache(cfg.num_layers)
        d, dt = cfg.d_model, self.dtype
        if cfg.family == "ssm":
            m_per, groups = self._xlstm_layout()
            return {
                "mlstm": stack((groups, m_per), ssm_lib.mlstm_init_state(
                    batch, d, cfg.num_heads, dt, "meta")),
                "slstm": stack(groups, ssm_lib.slstm_init_state(
                    batch, d, device="meta")),
            }
        period, groups, tail = self._hybrid_layout()
        state = ssm_lib.mamba2_init_state(
            batch, d, cfg.ssm_state, cfg.ssm_head_dim, dtype=dt,
            device="meta")
        cache = {
            "mamba_pre": stack((groups, period - 1), state),
            "mamba_post": stack(groups, state),
            "shared_attn": attn_cache(groups),
        }
        if tail:
            cache["mamba_tail"] = stack(tail, state)
        return cache

    #: the batch axis of each recurrent-state cache key's leaves (their
    #: leading axes are the stacked layer-group axes)
    _STATE_BATCH_AXES = {
        "mlstm": 2, "slstm": 1,
        "mamba_pre": 2, "mamba_post": 1, "mamba_tail": 1,
    }
    #: the attention serve-cache keys (K/V rows and the filter planes)
    _ATTN_CACHE_KEYS = ("k", "v", "k_codes", "k_scale")

    def reset_decode_slots(self, cache, reset_mask: torch.Tensor):
        """Zero, in place, the decode state of the masked slots
        (``reset_mask`` bool ``[B]``): recurrent states accumulate, and a
        freshly admitted slot must not inherit its previous occupant's.
        The K/V rows, codes and scales of the masked slots are zeroed
        too: a block mixing a new prompt's rows with its previous
        occupant's stale ones would quantize the real rows against an
        inflated absmax. Only ``impl="dense"``, which never quantizes,
        keeps the stale rows (positional writes overwrite them before
        they are read). The reset slots are the mask's True ones."""
        mask = reset_mask.to(self.device)
        for key, ax in self._STATE_BATCH_AXES.items():
            for leaf in cache.get(key, {}).values():
                _zero_slots(leaf, mask, ax)
        if self.cfg.energon.impl == "dense":
            return cache
        attn = cache.get("shared_attn", cache)
        for key in self._ATTN_CACHE_KEYS:
            if key in attn:
                _zero_slots(attn[key], mask, 1)
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
                f"paged cache unsupported for family={cfg.family!r} / "
                f"impl={cfg.energon.impl!r}"
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

    def _embed_in(self, params, inputs: Dict[str, torch.Tensor],
                  tokens: str) -> torch.Tensor:
        """The stack's input: ``inputs['embeddings']`` cast to the model
        dtype (unscaled) where the family reads embeddings and they are
        given, else the scaled embedding of ``inputs[tokens]``."""
        if self.cfg.uses_embeddings_input and "embeddings" in inputs:
            return inputs["embeddings"].to(self.dtype)
        return self._embed(params, inputs[tokens])

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
        either way. A vlm / audio model reads ``inputs['embeddings'] [B,
        C, d_model]`` in place of the tokens where given. The recurrent
        families have no chunked prefill (:attr:`supports_prefill`)."""
        cfg, moe_cfg = self.cfg, self._moe_cfg()
        if not self.supports_prefill:
            raise NotImplementedError(
                f"chunked prefill not supported for family {cfg.family!r}")
        x = self._embed_in(params, inputs, "tokens")
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
                    cache_index: torch.Tensor, telemetry: bool = False,
                    mesh=None):
        """One-token decode: ``inputs['tokens'] [B, 1]`` (a vlm / audio
        model reads ``inputs['embeddings'] [B, 1, d_model]`` instead
        where given); ``cache_index [B]`` current lengths. With
        ``inputs['block_table']`` the page pool is read and optional
        ``inputs['active'] [B]`` drops inactive slots' appends; without
        it the contiguous cache is written positionally, as in the
        reference (an index ≥ the cache rows writes nothing — the
        engine's idle-slot sentinel). A recurrent family's state
        advances, in place, only on the ``active`` slots (every slot
        without it); the hybrid's shared block decodes over its
        contiguous cache. Returns ``(logits [B, 1, V] f32, cache)``; with
        ``telemetry`` also the int32 ``[L, B, 4]`` stats, as
        :meth:`prefill` — ``[0, B, 4]`` for a recurrent family, as the
        reference reports (its attention, if any, lives inside the group
        scans).

        With ``mesh`` — ``params`` laid out by ``param_shardings``
        (:func:`~repro_torch.distributed.sharding.shard_tree`), ``cache``
        by ``cache_shardings`` (:meth:`shard_cache`), ``inputs`` and
        ``cache_index`` logical — the step runs over the mesh as the
        reference's decode under an active mesh: :meth:`_mesh_decode`.
        It returns ``(logits, cache)`` with the logits as the mesh holds
        them, each data row's (vocab shards where the head splits the
        vocabulary): :meth:`mesh_logits` assembles them. No
        ``telemetry`` there."""
        if mesh is not None:
            if telemetry:
                raise ValueError("decode_step over a mesh has no telemetry")
            return self._mesh_decode(params, cache, inputs, cache_index,
                                     mesh), cache
        cfg, moe_cfg = self.cfg, self._moe_cfg()
        x = self._embed_in(params, inputs, "tokens")
        cache_index = cache_index.to(torch.int32)
        if cfg.family == "ssm":
            x = self._decode_xlstm(params, cache, x, inputs.get("active"))
        elif cfg.family == "hybrid":
            x = self._decode_hybrid(params, cache, x, cache_index,
                                    inputs.get("active"))
        if cfg.family not in TRANSFORMER_FAMILIES:
            if telemetry:
                x = (x, torch.zeros((0, x.shape[0], 4), dtype=torch.int32,
                                    device=x.device))
            return self._serve_out(params, cache, x, telemetry)
        block_table = inputs.get("block_table")
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

    def _decode_xlstm(self, params, cache, x: torch.Tensor,
                      active: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        m_per, groups = self._xlstm_layout()
        for g in range(groups):
            for j in range(m_per + 1):      # m_per mLSTM layers, 1 sLSTM
                key = "mlstm" if j < m_per else "slstm"
                step = ssm_lib.mlstm_step if j < m_per else ssm_lib.slstm_step
                p = tfm.layer_slice(params[key], g)
                st = tfm.layer_slice(cache[key], g)
                if j < m_per:
                    p, st = tfm.layer_slice(p, j), tfm.layer_slice(st, j)
                h, new = step(p["cell"], L.apply_norm(cfg.norm, p["norm"], x),
                              st, cfg.num_heads)
                x = x + h
                _advance_state(st, new, active)
        return x

    def _decode_hybrid(self, params, cache, x: torch.Tensor,
                       cache_index: torch.Tensor,
                       active: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        shared = cache["shared_attn"]
        write = attn_lib.cache_write_plan(
            cache_index[:, None], shared["k"].shape[-2], cfg.num_kv_heads)

        def attn(kv_cache):
            return lambda p, xn: attn_lib.decode_attention_block(
                p, xn, kv_cache, cache_index, write, cfg.energon,
                **self._attn_kwargs(SHARED_LAYER, None))

        for where, p in self._mamba_layers(params):
            st = cache[where[0]]
            for i in where[1:]:
                st = tfm.layer_slice(st, i)
            if p is None:      # the shared block over group g's cache
                x = tfm.block_step(params["shared"], x, attn(st),
                                   activation=cfg.activation, norm=cfg.norm)
                continue
            h, new = ssm_lib.mamba2_step(
                p["cell"], L.apply_norm(cfg.norm, p["norm"], x), st,
                cfg.ssm_state, cfg.ssm_head_dim)
            x = x + h
            _advance_state(st, new, active)
        return x


    # ------------------------------------------------------------------
    # decode over a mesh
    # ------------------------------------------------------------------

    def shard_cache(self, cache, mesh):
        """:meth:`init_cache`'s cache laid out by ``cache_shardings`` over
        ``mesh`` — a share: the shards its device holds —, each shard a
        cache leaf with the write scratch after each layer."""
        return shd.shard_cache(cache, mesh,
                               attn_lib.contiguous_scratch(self.cfg.head_dim))

    @staticmethod
    def mesh_logits(logits, device=None) -> torch.Tensor:
        """:meth:`decode_step` ``(mesh=)``'s logits as one ``[B, 1, V]``
        tensor on ``device`` (default the first row's): each row's vocab
        shards concatenated, the rows after one another."""
        first = logits[0][0] if isinstance(logits[0], tuple) else logits[0]
        device = first.device if device is None else device
        return torch.cat([torch.cat([t.to(device) for t in lg], dim=-1)
                          if isinstance(lg, tuple) else lg.to(device)
                          for lg in logits], dim=0)

    def _mesh_decode(self, params, cache, inputs, cache_index, mesh):
        """One-token decode over ``mesh``, the reference's decode under an
        active mesh: the batch over the data rows where they divide it
        (else one row decodes it, as each replicated row would), every
        layer's weights through ``row_views`` (the ZeRO gather over
        'data' under the ``"train"`` profile; the heads, MLP columns and
        vocabulary over 'model'), each row's attention over the cache
        pieces it holds (:func:`attention.mesh_decode_attention_block`),
        an MoE layer by :meth:`_mesh_moe` (the 2-D experts under
        ``"serve"``). A recurrent family's state goes by ``cache_pspec``'s
        first-DP-dim rule, each cell's weights gathered whole per row as
        in training (:func:`_state_layer`). Returns each row's logits."""
        cfg = self.cfg
        key = "embeddings" if (cfg.uses_embeddings_input
                               and "embeddings" in inputs) else "tokens"
        batch = inputs[key].shape[0]
        rows, n_rows, split, slots = self._mesh_rows(batch, mesh)
        if key == "embeddings":
            x_rows = [e.to(self.dtype) for e in split(inputs[key])]
        else:
            embed = shd.row_views({"embed": params["embed"]}, mesh, rows)
            x_rows = [self._embed(e, tok)
                      for e, tok in zip(embed, split(inputs[key]))]
        ci = [c.to(torch.int32) for c in split(cache_index)]
        run = dict(mesh=mesh, rows=rows, n_rows=n_rows, tokens=batch, ci=ci,
                   per=batch // n_rows, slots=slots)
        if cfg.family in TRANSFORMER_FAMILIES:
            windows = self.layer_windows()
            prefix = cfg.energon.min_prune_layer
            for i, layer in enumerate(tfm.unstack(params["blocks"])):
                kw = self._attn_kwargs(0 if i < prefix else prefix,
                                       None if windows is None
                                       else windows[i])
                x_rows = self._mesh_decode_layer(layer, x_rows, cache, (i,),
                                                 kw, run)
        elif cfg.family == "ssm":
            x_rows = self._mesh_decode_xlstm(params, cache, x_rows, run)
        else:
            x_rows = self._mesh_decode_hybrid(params, cache, x_rows, run)
        head = {"final_norm": params["final_norm"],
                "head": params["embed"] if cfg.tie_embeddings
                else params["lm_head"]}
        logits = []
        for view, x in zip(shd.row_views(head, mesh, rows), x_rows):
            x = L.apply_norm(cfg.norm, view["final_norm"], x)
            logits.append(L.tied_lm_logits(view["head"], x)
                          if cfg.tie_embeddings
                          else L.lm_logits(view["head"], x))
        return logits

    def _mesh_decode_layer(self, layer, x_rows, cache, idx, kw, run):
        """One decoder layer's decode over the rows: attention over each
        row's pieces of ``cache`` (the stacked K/V leaves' layer
        ``idx``), then the MLP or the MoE."""
        cfg, mesh, rows = self.cfg, run["mesh"], run["rows"]
        lay = shd.CacheLayout(cache["k"])
        names = [n for n in ("k", "v", "k_codes") if n in cache]
        views = shd.row_views(
            {k: layer[k] for k in ("norm_attn", "attn", "norm_mlp")},
            mesh, rows)
        xs, h_in = [], []
        for r, view, x, ci in zip(rows, views, x_rows, run["ci"]):
            pieces = {jk: {n: cache[n].shards[key][idx] for n in names}
                      for jk, key in lay.row_keys(r).items()}
            k_scale = (shd.row_shard(cache["k_scale"], r)[idx]
                       if "k_scale" in cache else None)
            x = x + attn_lib.mesh_decode_attention_block(
                view["attn"], L.apply_norm(cfg.norm, view["norm_attn"], x),
                pieces, lay, k_scale, ci, cfg.energon, **kw)
            xs.append(x)
            h_in.append(L.apply_norm(cfg.norm, view["norm_mlp"], x))
        if "moe" in layer:
            outs, _ = self._mesh_moe(layer["moe"], h_in, mesh, rows,
                                     run["n_rows"], run["tokens"])
        else:
            mlp = shd.row_views(layer["mlp"], mesh, rows)
            outs = [L.apply_mlp(v, h, cfg.activation)
                    for v, h in zip(mlp, h_in)]
        return [x + o for x, o in zip(xs, outs)]

    def _mesh_cell_step(self, p, states, step, x_rows, idx, run):
        """One recurrent layer's decode over the rows: the cell's weights
        gathered whole onto each row, its state ``states`` (the cache's
        leaves of this kind) at layer ``idx`` read by
        :func:`_state_layer`, advanced in place and handed back."""
        cfg, mesh = self.cfg, run["mesh"]
        views = shd.row_views(p, mesh, run["rows"], whole=True)
        out = []
        for r, slot, v, x in zip(run["rows"], run["slots"], views, x_rows):
            st, backs = {}, []
            for name, leaf in states.items():
                st[name], back = _state_layer(leaf, idx, mesh, r, slot,
                                              run["per"])
                if back is not None:
                    backs.append((name, back))
            h, new = step(v["cell"], L.apply_norm(cfg.norm, v["norm"], x),
                          st)
            _advance_state(st, new, None)
            for name, back in backs:
                back(st[name])
            out.append(x + h)
        return out

    def _mesh_decode_xlstm(self, params, cache, x_rows, run):
        cfg = self.cfg
        m_per, groups = self._xlstm_layout()
        for g in range(groups):
            for j in range(m_per + 1):      # m_per mLSTM layers, 1 sLSTM
                key = "mlstm" if j < m_per else "slstm"
                fn = ssm_lib.mlstm_step if j < m_per else ssm_lib.slstm_step
                idx = (g, j) if j < m_per else (g,)
                x_rows = self._mesh_cell_step(
                    _layer_of(params[key], idx), cache[key],
                    lambda c, x, st, fn=fn: fn(c, x, st, cfg.num_heads),
                    x_rows, idx, run)
        return x_rows

    def _mesh_decode_hybrid(self, params, cache, x_rows, run):
        cfg = self.cfg
        kw = self._attn_kwargs(SHARED_LAYER, None)

        def mamba(c, x, st):
            return ssm_lib.mamba2_step(c, x, st, cfg.ssm_state,
                                       cfg.ssm_head_dim)

        for where, p in self._mamba_layers(params):
            if p is None:      # the shared block over group g's cache
                x_rows = self._mesh_decode_layer(
                    params["shared"], x_rows, cache["shared_attn"],
                    where[1:], kw, run)
            else:
                x_rows = self._mesh_cell_step(p, cache[where[0]], mamba,
                                              x_rows, where[1:], run)
        return x_rows


def _layer_of(tree, idx):
    """Layer ``idx`` (lead indices) of a sharded stacked tree: each
    :class:`ShardedLeaf` shard indexed (views), the spec and shape less
    the lead dims (never sharded: ``logical_axes_for`` maps them to
    None)."""
    if isinstance(tree, dict):
        return {k: _layer_of(v, idx) for k, v in tree.items()}
    n = len(idx)
    return shd.ShardedLeaf(tree.spec[n:], tree.shape[n:], tree.mesh,
                           {k: t[idx] for k, t in tree.shards.items()})


def _state_layer(leaf, idx, mesh, row: int, slot: int, per: int):
    """Data row ``row``'s view of one layer ``idx`` (its stacked lead
    indices) of a recurrent-state :class:`ShardedLeaf` laid out by
    ``cache_pspec`` (its first dim the data axes divide): ``(state
    [per, …], write_back)``, the rows ``slot · per …`` of the layer's
    batch. Where the layout splits the layer axis, the batch (as the rows
    do) or nothing, the state is a view into the shard that holds it
    (``write_back`` None: in-place writes land); where it splits a state
    dim, the parts are all-gathered over the data axes and
    ``write_back(new)`` hands each part its slice. A share reads the
    shards it holds, and a stand-in (priced) of a layer another device
    holds."""
    d = leaf.data_dim()
    lead = len(idx)
    axes = shd._entry_axes(leaf.spec[d]) if d is not None else ()
    n = math.prod(mesh.shape[a] for a in axes)
    part = leaf.shape[d] // n if d is not None else 0

    def key_of(k):
        at = {}
        for a in reversed(axes):
            k, at[a] = divmod(k, mesh.shape[a])
        return leaf.key(**at)

    def rows_of(t):
        return t.narrow(0, slot * per, per)

    if d is None:
        return rows_of(next(iter(leaf.shards.values()))[idx]), None
    if d < lead:                                   # the layer axis
        k, local = divmod(idx[d], part)
        key = key_of(k)
        idx_l = idx[:d] + (local,) + idx[d + 1:]
        if key in leaf.shards:
            return rows_of(leaf.shards[key][idx_l]), None
        shape = leaf.shape[lead:]
        t = next(iter(leaf.shards.values()))
        stand = col.all_gather(
            [torch.empty((1,) + tuple(shape), dtype=t.dtype,
                         device=t.device)], 0, [t.device], axes=axes,
            share=col.share_of(mesh, axes))[0][0]
        return rows_of(stand), None
    if d == lead and n == shd.dp_size(mesh) and per * n == leaf.shape[d]:
        return shd.row_shard(leaf, row)[idx], None  # the batch, as the rows
    dim = d - lead          # a state dim: the batch replicates (one row)
    if mesh.coord is not None:                       # a share's part
        mine = next(iter(leaf.shards.values()))[idx]
        share = col.share_of(mesh, axes)
        k = share[1] if share else 0
        whole = col.all_gather([mine], dim, [mine.device], axes=axes,
                               share=share)[0]
        return whole, lambda new: mine.copy_(new.narrow(dim, k * part,
                                                        part))
    parts = [leaf.shards[key_of(k)][idx] for k in range(n)]
    whole = col.all_gather(parts, dim, [mesh.rows[row][0]], axes=axes)[0]

    def write_back(new):
        for k, p in enumerate(parts):
            p.copy_(new.narrow(dim, k * part, part).to(p.device))
    return whole, write_back


def _advance_state(state: Dict[str, torch.Tensor],
                   new: Dict[str, torch.Tensor],
                   active: Optional[torch.Tensor]) -> None:
    """Write a layer's new recurrent state into its cache leaves (batch
    axis 0), in place; with ``active`` only on the active slots, the
    others keep theirs — a whole-batch step must not advance a slot
    that did not really consume a token. No host sync: a graphed step
    captures it."""
    for key, leaf in state.items():
        if active is None:
            leaf.copy_(new[key])
        else:
            keep = active.reshape((-1,) + (1,) * (leaf.dim() - 1))
            leaf.copy_(torch.where(keep, new[key], leaf))


def _zero_slots(leaf: torch.Tensor, mask: torch.Tensor, axis: int) -> None:
    """Zero, in place, ``leaf``'s entries of the ``mask`` slots (bool
    ``[B]`` on batch ``axis``)."""
    shape = [1] * leaf.dim()
    shape[axis] = -1
    leaf.masked_fill_(mask.reshape(shape), 0)


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
