"""GQA attention (port of ``repro.models.attention``): the
full-sequence block and the serving blocks over the paged KV cache and
over the contiguous (unpaged) one.

Activations stay ``[batch, seq, d_model]``. The full-sequence block
repeats each KV head to its G = H/KV query heads, as the reference
does, and hands ``[B, H, n, hd]`` to :func:`energon_attention`. The
serving blocks fold the G query heads of each KV head into the query
axis, ``[B, KV, G·C, hd]`` (group-major), so the attention kernels see
one KV head per row.

The port updates both caches **in place** (the reference returns new
caches functionally): a chunk's K/V rows are written with
``index_put_`` — through the block table into the pool, or at their
positions into the contiguous ``[B, KV, max_len, hd]`` cache, where the
reference scatters with a one-hot product — and the filter planes are
refreshed in the same leaves. The cache is the one resident copy, so
nothing is duplicated per step.

Every call writes a fixed number of rows, B·C, and never asks the host
which ones are kept, so a step can be captured as a CUDA graph. A row
that must write nothing (a padding or idle-slot sentinel, a slot the
``active`` mask drops) is sent to a **scratch target**: a few elements
that the cache allocates after each layer's leaf (:func:`stacked_leaf`)
and that no leaf shows, so no kernel and no reader ever sees them —
what the reference's all-zero one-hot rows do. Kept rows are distinct,
so no write has two sources except the scratch, which nothing reads.

On a tensor-parallel mesh the paged blocks take the pool as head shards
(each leaf a tuple, :mod:`repro_torch.distributed.sharding`): each
shard's K/V rows and planes are written on its device, and the
attention entry points run the fused ops once per shard. In training,
a mesh row's ``wq`` / ``wo`` head shards (M-tuples) split the
full-sequence block the same way: shard j runs its query heads against
the KV heads their groups read, and the row-parallel ``wo`` partials
add over 'model'.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.core import (
    EnergonConfig,
    energon_attention,
    energon_decode_attention,
    energon_paged_decode_attention,
    energon_paged_prefill_attention,
)
from repro_torch.core import quantization as qlib
from repro_torch.core.energon_attention import energon_decode_attention_parts
from repro_torch.distributed import collectives as col
from repro_torch.models import layers as L
from repro_torch.runtime import paged_cache as pgc


def init_attention(
    generator: torch.Generator, device, d_model: int, num_heads: int,
    num_kv_heads: int, head_dim: int, use_qk_norm: bool = False,
    dtype=torch.float32,
) -> Dict[str, object]:
    """Attention weights with the reference's layouts and stds:
    wq ``[d, H, hd]``, wk/wv ``[d, KV, hd]``, wo ``[H, hd, d]``."""
    std = d_model ** -0.5
    tn = lambda shape, s: L.trunc_normal(shape, s, generator, device, dtype)
    params = {
        "wq": tn((d_model, num_heads, head_dim), std),
        "wk": tn((d_model, num_kv_heads, head_dim), std),
        "wv": tn((d_model, num_kv_heads, head_dim), std),
        "wo": tn((num_heads, head_dim, d_model),
                 (num_heads * head_dim) ** -0.5),
    }
    if use_qk_norm:
        params["q_norm"] = {"scale": torch.ones(head_dim, dtype=dtype,
                                                device=device)}
        params["k_norm"] = {"scale": torch.ones(head_dim, dtype=dtype,
                                                device=device)}
    return params


def _project_qkv(
    params, x: torch.Tensor, positions: torch.Tensor,
    use_qk_norm: bool, rope_theta: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x ``[B, n, d_model]`` → q ``[B, n, H, hd]``, k/v ``[B, n, KV, hd]``."""
    def proj(w):
        d, h, hd = w.shape
        return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if use_qk_norm:
        q = L.rmsnorm(params["q_norm"], q)
        k = L.rmsnorm(params["k_norm"], k)
    q = L.apply_rope(q, positions, rope_theta)
    k = L.apply_rope(k, positions, rope_theta)
    return q, k, v


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, KV, n, hd]`` → ``[B, KV·groups, n, hd]`` (each KV head
    repeated for its query heads, in order)."""
    if groups == 1:
        return x
    return torch.repeat_interleave(x, groups, dim=1)


def attention_block(
    params,
    x: torch.Tensor,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
) -> torch.Tensor:
    """Full-sequence causal attention at positions 0 .. n−1.
    x ``[B, n, d]`` → ``[B, n, d]``. Head-sharded weights (``wq`` /
    ``wo`` M-tuples, a mesh row's view) take
    :func:`_attention_block_tp`."""
    if isinstance(params["wq"], tuple):
        return _attention_block_tp(
            params, x, energon, num_heads=num_heads,
            num_kv_heads=num_kv_heads, rope_theta=rope_theta,
            use_qk_norm=use_qk_norm, window=window, layer_index=layer_index)
    batch, n, _ = x.shape
    positions = torch.arange(n, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, positions, use_qk_norm, rope_theta)
    groups = num_heads // num_kv_heads
    out = energon_attention(
        q.transpose(1, 2),                              # [B, H, n, hd]
        _repeat_kv(k.transpose(1, 2), groups),
        _repeat_kv(v.transpose(1, 2), groups),
        energon, causal=True, window=window, layer_index=layer_index,
    )
    wo = params["wo"]
    out = out.transpose(1, 2).reshape(batch, n, -1)     # [B, n, H·hd]
    return out @ wo.reshape(-1, wo.shape[-1])


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def _attention_block_tp(params, x: torch.Tensor, energon: EnergonConfig, *,
                        num_heads: int, num_kv_heads: int, rope_theta: float,
                        use_qk_norm: bool, window: Optional[int],
                        layer_index: int) -> torch.Tensor:
    """:func:`attention_block` with the query heads over 'model' (the
    reference's head-sharded q/k/v constraints, ``allow_uneven``, and
    row-parallel ``wo``). Shard j, on its device, projects its query
    heads ``[j·c, j·c + h_j)`` — c = ⌈H/M⌉, h_j its ``wq`` shard's heads:
    H/M each where M divides H, else the
    :func:`~repro_torch.distributed.sharding.uneven_head_views` split,
    where a shard past the last head holds none and launches nothing —,
    reads the KV heads of their groups (head h reads h // G) and runs
    :func:`energon_attention` on them; the shards' ``wo`` partials (in
    x's dtype, zeros for a shard without heads) add over 'model' in f32
    in shard order, rounded once. K/V (``kv_heads`` → None: ``wk`` /
    ``wv`` whole on every shard) are projected whole on x's device where
    M divides H; where it does not, each shard projects the KV heads its
    query heads read, as GSPMD's padded split projects its device's."""
    devices = [w.device for w in params["wq"]]
    m = col.shard_total(params["wq"])          # shards over 'model'
    first = col.shard_start(params["wq"])      # a share's own index
    batch, n, d_model = x.shape
    per, groups = -(-num_heads // m), num_heads // num_kv_heads
    over = dict(axes=("model",), share=col.shards_share(params["wq"]))
    xs = col.broadcast(x, devices, **over)
    uneven = num_heads % m != 0
    norm_keys = (("q_norm", "k_norm") if uneven else ("q_norm",)) \
        if use_qk_norm else ()
    norms = {key: col.broadcast(params[key]["scale"], devices, **over)
             for key in norm_keys}
    if uneven:
        # shard j's KV heads: those its query heads read (h // G)
        kv = []
        for j, w in enumerate(params["wq"]):
            h0, hj = (first + j) * per, w.shape[-2]
            lo = min(h0 // groups, num_kv_heads)
            kv.append((lo, (h0 + hj - 1) // groups + 1 - lo if hj else 0))
        wks = col.slices(params["wk"], -2, kv, devices, axes=("model",))
        wvs = col.slices(params["wv"], -2, kv, devices, axes=("model",))
    else:
        positions = torch.arange(n, device=x.device)[None, :]
        k, v = _project(x, params["wk"]), _project(x, params["wv"])
        if use_qk_norm:
            k = L.rmsnorm(params["k_norm"], k)
        k = L.apply_rope(k, positions, rope_theta)
        ks = col.broadcast(k.transpose(1, 2), devices, **over)
        vs = col.broadcast(v.transpose(1, 2), devices, **over)
    parts = []
    for j, dev in enumerate(devices):
        h0, hj = (first + j) * per, params["wq"][j].shape[-2]
        if hj == 0:
            parts.append(torch.zeros((batch, n, d_model), dtype=x.dtype,
                                     device=dev))
            continue
        positions = torch.arange(n, device=dev)[None, :]
        q = _project(xs[j], params["wq"][j])
        if use_qk_norm:
            q = L.rmsnorm({"scale": norms["q_norm"][j]}, q)
        q = L.apply_rope(q, positions, rope_theta)
        heads = torch.arange(h0, h0 + hj, device=dev) // groups
        if uneven:
            k, v = _project(xs[j], wks[j]), _project(xs[j], wvs[j])
            if use_qk_norm:
                k = L.rmsnorm({"scale": norms["k_norm"][j]}, k)
            k = L.apply_rope(k, positions, rope_theta).transpose(1, 2)
            v, heads = v.transpose(1, 2), heads - kv[j][0]
        else:
            k, v = ks[j], vs[j]
        out = energon_attention(
            q.transpose(1, 2), k.index_select(1, heads),
            v.index_select(1, heads), energon, causal=True, window=window,
            layer_index=layer_index)
        wo = params["wo"][j]
        out = out.transpose(1, 2).reshape(batch, n, -1)
        parts.append(out @ wo.reshape(-1, wo.shape[-1]))
    return col.all_reduce(parts, x.device, **over)


def init_kv_cache(
    batch: int, num_kv_heads: int, max_len: int, head_dim: int, dtype,
    device, filter_block: int = 0,
) -> Dict[str, torch.Tensor]:
    """One layer's contiguous decode cache ``[B, KV, max_len, hd]``;
    ``filter_block > 0`` adds the resident filter planes: int16 codes in
    the same layout and one f32 absmax scale per ``filter_block``-row
    key block, kept fresh by the writers."""
    shape = (batch, num_kv_heads, max_len, head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
    if filter_block > 0:
        if max_len % filter_block:
            raise ValueError(
                f"max_len {max_len} not divisible by filter block "
                f"{filter_block}"
            )
        cache["k_codes"] = torch.zeros(shape, dtype=torch.int16,
                                       device=device)
        cache["k_scale"] = torch.zeros(
            (batch, num_kv_heads, max_len // filter_block),
            dtype=torch.float32, device=device,
        )
    return cache


def contiguous_scratch(head_dim: int) -> Dict[str, int]:
    """Scratch elements after each layer of a contiguous cache's leaves:
    one K/V row (the filter planes are refreshed by position, not by the
    write plan)."""
    return {"k": head_dim, "v": head_dim}


def paged_scratch(page_size: int, head_dim: int) -> Dict[str, int]:
    """Scratch elements after each layer of a page pool's leaves: one K/V
    row, one page of codes and one scale (a decode append re-quantizes
    the page it wrote; a dropped one re-quantizes into the scratch)."""
    return {"k": head_dim, "v": head_dim, "k_codes": page_size * head_dim,
            "k_scale": 1}


#: the storages :func:`stacked_leaf` allocated, by storage address: a
#: weak reference (the entry holds only while the storage lives), the
#: layers' stride and one layer's elements
_stacked: Dict[int, Tuple[StorageWeakRef, int, int]] = {}


def stacked_leaf(num_layers: int, shape, dtype, device,
                 scratch: int = 0) -> torch.Tensor:
    """Zeroed per-layer leaves ``[L, *shape]`` in which every layer is
    followed in memory by at least ``scratch`` elements that the leaf
    does not show. Each layer's slice is contiguous, starts 256-byte
    aligned (as the kernels require of their operands) and has the
    layout the kernels always read; only the fixed-shape writes reach
    past it (:func:`_rows_with_scratch`)."""
    per = math.prod(shape)
    align = max(1, 256 // dtype.itemsize)
    stride = -(-(per + scratch) // align) * align
    store = torch.zeros((num_layers, stride), dtype=dtype, device=device)
    for gone in [k for k, (ref, _, _) in _stacked.items() if ref.expired()]:
        del _stacked[gone]
    storage = store.untyped_storage()
    _stacked[storage._cdata] = (StorageWeakRef(storage), stride, per)
    return store[:, :per].view(num_layers, *shape)


def _rows_with_scratch(leaf: torch.Tensor, width: int) -> torch.Tensor:
    """One layer's leaf as ``[numel // width + 1, width]`` rows, the last
    of which is the scratch row after it. Raises unless the leaf is a
    whole layer of a :func:`stacked_leaf` with ``width`` elements of
    scratch after it: past any other leaf, that row would be someone
    else's data (the next layer's first row, in a plain stack)."""
    entry = _stacked.get(leaf.untyped_storage()._cdata)
    if (entry is None or entry[0].expired() or not leaf.is_contiguous()
            or leaf.numel() != entry[2] or leaf.storage_offset() % entry[1]
            or entry[2] + width > entry[1]):
        raise ValueError(
            "cache leaf has no write scratch after its layers; allocate "
            "the cache with LMModel.init_cache / init_paged_cache"
        )
    return leaf.as_strided((leaf.numel() // width + 1, width), (width, 1))


@dataclasses.dataclass(frozen=True)
class CacheWrite:
    """Where one call's K/V rows land in the contiguous cache: ``rows
    [B·C, KV]`` is each (token, KV head)'s row of the layer's
    ``[B·KV·max_len + 1, hd]`` row view; a dropped token's rows are all
    the scratch row ``B·KV·max_len``. Computed once per call
    (:func:`cache_write_plan`), as :class:`PagedWrite` is."""

    rows: torch.Tensor


def cache_write_plan(positions: torch.Tensor, max_len: int,
                     num_kv_heads: int) -> CacheWrite:
    """Token (b, c) lands in row ``positions[b, c]`` of slot b; positions
    outside ``[0, max_len)`` — the padding and idle-slot sentinels —
    land in the scratch row, as the reference's all-zero one-hot rows
    write nothing."""
    batch, chunk = positions.shape
    dev = positions.device
    pos = positions.long()[..., None]                          # [B, C, 1]
    slot = torch.arange(batch, device=dev)[:, None, None]
    head = torch.arange(num_kv_heads, device=dev)
    row = (slot * num_kv_heads + head) * max_len + pos         # [B, C, KV]
    keep = (pos >= 0) & (pos < max_len)
    rows = torch.where(keep, row, batch * num_kv_heads * max_len)
    return CacheWrite(rows=rows.reshape(batch * chunk, num_kv_heads))


def _refresh_filter_block(
    cache: Dict[str, torch.Tensor], pos: torch.Tensor, block: int
) -> None:
    """Re-quantize, in place, the key block each slot's append at
    ``pos [B]`` touched: after every write, block j's codes and scale
    equal a fresh per-block quantization of its rows. As the reference
    does, a position past the cache (an idle slot's sentinel) clips to
    the last block, which re-quantizes unchanged rows."""
    k = cache["k"]
    batch, kv, max_len, hd = k.shape
    n_kb = max_len // block
    rows = torch.arange(batch, device=k.device)
    blk = torch.clamp(pos.long(), 0, max_len - 1) // block
    sel = k.view(batch, kv, n_kb, block, hd)[rows, :, blk]   # [B,KV,bk,hd]
    codes, scale = qlib.quantize_int16_blocks(sel, block)
    cache["k_codes"].view(batch, kv, n_kb, block, hd)[rows, :, blk] = codes
    cache["k_scale"][rows, :, blk] = scale[..., 0]


def _fold_groups(q: torch.Tensor, num_heads: int,
                 num_kv_heads: int) -> torch.Tensor:
    """``[B, C, H, hd]`` queries → ``[B, KV, G·C, hd]`` (group-major)."""
    batch, chunk, _, hd = q.shape
    groups = num_heads // num_kv_heads
    return q.transpose(1, 2).reshape(batch, num_kv_heads, groups * chunk, hd)


def _project_update_fold(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    write: CacheWrite,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float,
    use_qk_norm: bool,
    filter_block: int,
) -> torch.Tensor:
    """Project the chunk, write its K/V rows into the contiguous cache
    where ``write`` says (in place) and fold GQA groups into the query
    axis.

    The filter planes are refreshed at the write: a decode append
    (C = 1) re-quantizes the one block each slot's position falls in; a
    prefill chunk re-quantizes every block of the cache. Returns
    ``q_folded [B, KV, G·C, hd]``.
    """
    chunk = x.shape[1]
    q, k, v = _project_qkv(params, x, positions, use_qk_norm, rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    hd = k.shape[-1]
    _rows_with_scratch(k_cache, hd)[write.rows] = (
        k.reshape(-1, num_kv_heads, hd).to(k_cache.dtype))
    _rows_with_scratch(v_cache, hd)[write.rows] = (
        v.reshape(-1, num_kv_heads, hd).to(v_cache.dtype))
    if "k_codes" in cache:
        if filter_block <= 0:
            raise ValueError(
                "cache carries filter planes but filter_block is unset")
        if chunk == 1:
            _refresh_filter_block(cache, positions[:, 0], filter_block)
        else:
            codes, scales = qlib.quantize_int16_blocks(k_cache, filter_block)
            cache["k_codes"].copy_(codes)
            cache["k_scale"].copy_(scales)
    return _fold_groups(q, num_heads, num_kv_heads)


def prefill_attention_block(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    write: CacheWrite,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
    telemetry: bool = False,
):
    """Chunked-prefill attention against the contiguous cache. x
    ``[B, C, d]``; positions ``[B, C]`` (sentinels ≥ max_len write
    nothing and produce outputs the caller ignores); ``write`` from
    :func:`cache_write_plan`. The chunk attends the updated cache under
    a per-row causal mask, reading the planes refreshed by its own
    write. Returns ``[B, C, d]``; with ``telemetry``, ``(y, stats)``
    where stats is the layer's int32 ``[B, 4]`` selection counts."""
    chunk = x.shape[1]
    qg = _project_update_fold(
        params, x, cache, positions, write,
        num_heads=num_heads, num_kv_heads=num_kv_heads,
        rope_theta=rope_theta, use_qk_norm=use_qk_norm,
        filter_block=energon.decode_key_block,
    )
    groups = num_heads // num_kv_heads
    qpos = positions.repeat(1, groups)       # folded row (g, c) → pos[c]
    out = energon_attention(
        qg, cache["k"], cache["v"], energon,
        causal=True, window=window, layer_index=layer_index,
        q_positions=qpos, filter_cache=_filter_planes(cache),
        telemetry=telemetry,
    )
    return _unfold_with_stats(out, params, num_heads, chunk, telemetry)


def decode_attention_block(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    cache_index: torch.Tensor,
    write: CacheWrite,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
    telemetry: bool = False,
):
    """One-token decode step over the contiguous cache. x ``[B, 1, d]``;
    cache_index ``[B]`` (an idle slot's ``max_len`` sentinel writes
    nothing and attends every row); ``write`` from
    :func:`cache_write_plan`. Returns ``[B, 1, d]``; with ``telemetry``,
    ``(y, stats [B, 4])``."""
    qg = _project_update_fold(
        params, x, cache, cache_index[:, None], write,
        num_heads=num_heads, num_kv_heads=num_kv_heads,
        rope_theta=rope_theta, use_qk_norm=use_qk_norm,
        filter_block=energon.decode_key_block,
    )
    out = energon_decode_attention(
        qg, cache["k"], cache["v"], cache_index + 1, energon,
        layer_index=layer_index, window=window,
        filter_cache=_filter_planes(cache), telemetry=telemetry,
    )
    return _unfold_with_stats(out, params, num_heads, 1, telemetry)


def _filter_planes(cache) -> Optional[Dict[str, torch.Tensor]]:
    if "k_codes" not in cache:
        return None
    return {"codes": cache["k_codes"], "scale": cache["k_scale"]}


def init_paged_kv_cache(
    num_pages: int, num_kv_heads: int, page_size: int, head_dim: int,
    dtype, device, filter_planes: bool = True,
) -> Dict[str, torch.Tensor]:
    """One layer's shared page pool: K/V rows ``[KV, pages·ps, hd]``
    plus, with ``filter_planes``, int16 codes in the same layout and one
    f32 absmax scale per physical page."""
    rows = num_pages * page_size
    cache = {
        "k": torch.zeros((num_kv_heads, rows, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((num_kv_heads, rows, head_dim), dtype=dtype,
                         device=device),
    }
    if filter_planes:
        cache["k_codes"] = torch.zeros((num_kv_heads, rows, head_dim),
                                       dtype=torch.int16, device=device)
        cache["k_scale"] = torch.zeros((num_kv_heads, num_pages),
                                       dtype=torch.float32, device=device)
    return cache


@dataclasses.dataclass(frozen=True)
class PagedWrite:
    """Where one call's K/V rows land in the pool, for all B·C tokens:
    ``rows [KV, B·C]`` each (KV head, token)'s row of the layer's
    ``[KV·pool_rows + 1, hd]`` row view, a dropped token's the scratch
    row ``KV·pool_rows``; ``page [B·C]`` the physical page a kept token
    wrote (0 for a dropped one, read but never written); ``pages [KV,
    B·C]`` that page's row of the ``[KV·num_pages + 1, ps·hd]`` codes
    view (and of the scales), a dropped token's the scratch page. The
    plan is the same for every layer — and on a head-sharded pool, where
    KV counts one shard's heads, for every shard —, so the model
    computes it once per call (:func:`paged_write_plan`)."""

    rows: torch.Tensor
    page: torch.Tensor
    pages: torch.Tensor

    def to(self, device) -> "PagedWrite":
        """The plan on ``device`` (itself where it lives there)."""
        return PagedWrite(*(t.to(device) for t in
                            (self.rows, self.page, self.pages)))


def paged_write_plan(
    positions: torch.Tensor,
    block_table: torch.Tensor,
    page_size: int,
    pool_rows: int,
    num_kv_heads: int,
    write_mask: Optional[torch.Tensor] = None,
) -> PagedWrite:
    """Token (b, c) at logical position p lands in pool row
    ``table[b, p // ps]·ps + p % ps``. Sentinel positions and masked-off
    slots resolve to :data:`~repro_torch.runtime.paged_cache.DROP_ROW`
    and go to the scratch target — ``index_put_`` has no drop mode, and
    an idle slot's table may alias pages a live slot owns, so a dropped
    row must not land on any pool row."""
    target = pgc.paged_row_targets(
        positions, block_table, page_size, write_mask=write_mask
    ).reshape(-1)
    keep = target < pool_rows
    head = torch.arange(num_kv_heads, device=target.device)[:, None]
    num_pages = pool_rows // page_size
    page = torch.where(keep, target // page_size, 0)
    return PagedWrite(
        rows=torch.where(keep, head * pool_rows + target,
                         num_kv_heads * pool_rows),
        page=page,
        pages=torch.where(keep, head * num_pages + page,
                          num_kv_heads * num_pages),
    )


def _project_update_fold_paged(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    write: PagedWrite,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float,
    use_qk_norm: bool,
    filter_block: int,
) -> torch.Tensor:
    """Project the chunk, write its K/V rows into the pool where
    ``write`` says (in place) and fold GQA groups into the query axis.

    The filter planes are refreshed at the write: a decode append
    (C = 1) re-quantizes exactly the one page each writing slot touched;
    a prefill chunk re-quantizes the whole pool. A head-sharded pool is
    written shard by shard, each on its device with its heads' K/V rows
    (``write`` then plans one shard's heads, the same for every shard),
    so a decode append re-quantizes one page per shard and a prefill
    chunk each shard's pool: the work of the whole pool. Returns
    ``q_folded [B, KV, G·C, hd]``.
    """
    if filter_block <= 0:
        raise ValueError("paged cache needs a positive page size")
    q, k, v = _project_qkv(params, x, positions, use_qk_norm, rope_theta)
    shards = pgc.pool_shards(cache)
    if shards is None:
        _write_pool(cache, k, v, write, x.shape[1], filter_block)
    else:
        per = num_kv_heads // len(shards)
        for s, part in enumerate(shards):
            dev = part["k"].device
            heads = slice(s * per, (s + 1) * per)
            _write_pool(part, k[:, :, heads].to(dev), v[:, :, heads].to(dev),
                        write.to(dev), x.shape[1], filter_block)
    return _fold_groups(q, num_heads, num_kv_heads)


def _write_pool(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor, write: PagedWrite, chunk: int,
                ps: int) -> None:
    """A chunk's K/V rows ``[B, C, KV, hd]`` into one layer's pool (or
    shard: KV its heads) where ``write`` says, and its planes
    refreshed."""
    k_pool, v_pool = cache["k"], cache["v"]
    kv, hd = k_pool.shape[0], k_pool.shape[-1]
    # [B, C, KV, hd] → [KV, B·C, hd]
    _rows_with_scratch(k_pool, hd)[write.rows] = (
        k.reshape(-1, kv, hd).transpose(0, 1).to(k_pool.dtype))
    _rows_with_scratch(v_pool, hd)[write.rows] = (
        v.reshape(-1, kv, hd).transpose(0, 1).to(v_pool.dtype))

    if "k_codes" in cache:
        num_pages = cache["k_scale"].shape[-1]
        if chunk == 1:
            # the one page each slot's append touched (a dropped append
            # re-quantizes page 0 into the scratch page)
            sel = k_pool.view(kv, num_pages, ps, hd)[:, write.page]
            new_codes, new_scale = qlib.quantize_int16_blocks(sel, ps)
            _rows_with_scratch(cache["k_codes"], ps * hd)[write.pages] = (
                new_codes.reshape(*write.pages.shape, ps * hd))
            _rows_with_scratch(cache["k_scale"], 1)[write.pages] = new_scale
        else:
            codes, scales = qlib.quantize_int16_blocks(k_pool, ps)
            cache["k_codes"].copy_(codes)
            cache["k_scale"].copy_(scales)


def _unfold_heads_out(
    out: torch.Tensor, params, num_heads: int, chunk: int
) -> torch.Tensor:
    """``[B, KV, G·C, hd]`` attention output → ``[B, C, d_model]``."""
    batch, _, _, head_dim = out.shape
    out = out.reshape(batch, num_heads, chunk, head_dim).transpose(1, 2)
    wo = params["wo"]
    return out.reshape(batch, chunk, -1) @ wo.reshape(-1, wo.shape[-1])


def _unfold_with_stats(out, params, num_heads: int, chunk: int,
                       telemetry: bool):
    """:func:`_unfold_heads_out` of an attention output that, with
    ``telemetry``, comes as ``(out, stats)``; the stats pass through."""
    if telemetry:
        out, stats = out
        return _unfold_heads_out(out, params, num_heads, chunk), stats
    return _unfold_heads_out(out, params, num_heads, chunk)


def paged_prefill_attention_block(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    block_table: torch.Tensor,
    write: PagedWrite,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
    telemetry: bool = False,
):
    """Chunked-prefill attention against the page pool. x ``[B, C, d]``;
    positions ``[B, C]`` (sentinels ≥ logical rows write nothing and
    produce outputs the caller ignores); ``write`` from
    :func:`paged_write_plan`. Returns ``[B, C, d]``; with ``telemetry``,
    ``(y, stats [B, 4])``."""
    chunk = x.shape[1]
    qg = _project_update_fold_paged(
        params, x, cache, positions, write,
        num_heads=num_heads, num_kv_heads=num_kv_heads,
        rope_theta=rope_theta, use_qk_norm=use_qk_norm,
        filter_block=energon.decode_key_block,
    )
    groups = num_heads // num_kv_heads
    qpos = positions.repeat(1, groups)       # folded row (g, c) → pos[c]
    out = energon_paged_prefill_attention(
        qg, cache, block_table, qpos, energon,
        layer_index=layer_index, window=window, telemetry=telemetry,
    )
    return _unfold_with_stats(out, params, num_heads, chunk, telemetry)


def paged_decode_attention_block(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    cache_index: torch.Tensor,
    block_table: torch.Tensor,
    write: PagedWrite,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
    telemetry: bool = False,
):
    """One-token paged decode step. x ``[B, 1, d]``; cache_index ``[B]``;
    ``write`` (from :func:`paged_write_plan` with the ``active`` slots'
    mask) says which slots' appends land. Returns ``[B, 1, d]``; with
    ``telemetry``, ``(y, stats [B, 4])``."""
    qg = _project_update_fold_paged(
        params, x, cache, cache_index[:, None], write,
        num_heads=num_heads, num_kv_heads=num_kv_heads,
        rope_theta=rope_theta, use_qk_norm=use_qk_norm,
        filter_block=energon.decode_key_block,
    )
    out = energon_paged_decode_attention(
        qg, cache, block_table, cache_index + 1, energon,
        layer_index=layer_index, window=window, telemetry=telemetry,
    )
    return _unfold_with_stats(out, params, num_heads, 1, telemetry)


# --------------------------------------------------------------------------
# decode over a mesh: the cache laid out by distributed/sharding's
# cache_pspec (heads over 'model', or the sequence split)
# --------------------------------------------------------------------------


def _head_shard(w, j: int, per: int, dim: int) -> torch.Tensor:
    """Head shard ``j`` of a weight: the entry of its model-axis shards
    (``collectives.Shards``) whose logical index is j, or a whole
    weight's ``per`` heads along ``dim``."""
    if isinstance(w, tuple):
        return w[j - col.shard_start(w)]
    return w.narrow(dim, j * per, per)


def _whole_heads(w, dim: int, device) -> torch.Tensor:
    """A weight with every head: model-axis shards gathered over 'model'
    onto ``device`` (a priced stand-in in a share)."""
    if not isinstance(w, tuple):
        return w
    return col.all_gather(list(w), dim, [device], axes=("model",),
                          share=col.shards_share(w))[0]


def _refresh_part_block(part: Dict[str, torch.Tensor],
                        scale: torch.Tensor, pos: torch.Tensor,
                        block: int) -> None:
    """:func:`_refresh_filter_block` on one sequence part of the cache:
    the block each slot's append at part-local ``pos [B]`` touched is
    re-quantized where the append lands in this part, and left as it is
    elsewhere (another part holds it); ``scale`` the part's block
    scales."""
    k = part["k"]
    batch, kv, n_s, hd = k.shape
    n_kb = n_s // block
    rows = torch.arange(batch, device=k.device)
    inside = (pos >= 0) & (pos < n_s)
    blk = torch.clamp(pos.long(), 0, n_s - 1) // block
    codes = part["k_codes"].view(batch, kv, n_kb, block, hd)
    new_codes, new_scale = qlib.quantize_int16_blocks(
        k.view(batch, kv, n_kb, block, hd)[rows, :, blk], block)
    codes[rows, :, blk] = torch.where(inside[:, None, None, None],
                                      new_codes, codes[rows, :, blk])
    scale[rows, :, blk] = torch.where(inside[:, None], new_scale[..., 0],
                                      scale[rows, :, blk])


def _decode_heads(params, x: torch.Tensor, parts, count: int, seq_axes,
                  k_scale: Optional[torch.Tensor], cache_index: torch.Tensor,
                  energon: EnergonConfig, *, num_heads: int,
                  num_kv_heads: int, rope_theta: float, use_qk_norm: bool,
                  window, layer_index: int) -> torch.Tensor:
    """One head group's decode step over its cache parts (``count`` along
    the sequence): a whole cache takes :func:`decode_attention_block`; a
    split one writes each part's rows where the append lands, refreshes
    its planes there, and attends through
    :func:`~repro_torch.core.energon_attention.
    energon_decode_attention_parts`."""
    if count == 1:
        part = parts[0]
        on = part["k"].device
        cache = {"k": part["k"], "v": part["v"]}
        copied = None
        if "k_codes" in part:
            cache["k_codes"] = part["k_codes"]
            cache["k_scale"] = copied = k_scale.to(on)
        write = cache_write_plan(cache_index.to(on)[:, None],
                                 part["k"].shape[-2], num_kv_heads)
        y = decode_attention_block(
            params, x.to(on), cache, cache_index.to(on), write, energon,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            rope_theta=rope_theta, use_qk_norm=use_qk_norm, window=window,
            layer_index=layer_index)
        if copied is not None and copied is not k_scale:
            k_scale.copy_(copied)
        return y.to(x.device)
    positions = cache_index[:, None]
    q, k, v = _project_qkv(params, x, positions, use_qk_norm, rope_theta)
    hd = k.shape[-1]
    n_s = next(iter(parts.values()))["k"].shape[-2]
    bk = energon.decode_key_block
    attend = {}
    for s in sorted(parts):
        part = parts[s]
        on = part["k"].device
        local = positions.to(on) - s * n_s
        write = cache_write_plan(local, n_s, num_kv_heads)
        for name, new in (("k", k), ("v", v)):
            _rows_with_scratch(part[name], hd)[write.rows] = (
                new.reshape(-1, num_kv_heads, hd).to(on, part[name].dtype))
        attend[s] = {"k": part["k"], "v": part["v"]}
        if "k_codes" in part:
            sl = k_scale[..., s * (n_s // bk):(s + 1) * (n_s // bk)]
            _refresh_part_block(part, sl, local[:, 0], bk)
            attend[s].update(codes=part["k_codes"], scale=sl)
    out = energon_decode_attention_parts(
        _fold_groups(q, num_heads, num_kv_heads), attend, count,
        cache_index + 1, energon, axes=seq_axes,
        k_scale=k_scale if "k_codes" in next(iter(parts.values())) else None,
        layer_index=layer_index, window=window)
    return _unfold_heads_out(out, params, num_heads, 1)


def mesh_decode_attention_block(
    params, x: torch.Tensor, pieces, layout, k_scale,
    cache_index: torch.Tensor, energon: EnergonConfig, *, num_heads: int,
    num_kv_heads: int, rope_theta: float = 10000.0,
    use_qk_norm: bool = False, window: Optional[int] = None,
    layer_index: int = 10**9,
) -> torch.Tensor:
    """One-token decode over a data row's cache on a mesh. x ``[b, 1,
    d]`` on the row's first device; ``params`` the row's attention view
    (``wq`` / ``wo`` model-axis shards where the specs split the heads,
    ``wk`` / ``wv`` whole); ``pieces`` ``{(j, s): {"k", "v"[,
    "k_codes"]}}`` the row's cache leaves of this layer — KV-head shard j
    of ``layout.heads``, sequence part s of ``layout.parts`` (a share
    holds its own piece) —, ``k_scale`` the row's ``[b, KV, n_kb]``
    scales (whole: the cache's spec splits only their batch);
    ``cache_index [b]``.

    Over KV-head shards each shard runs its heads whole — its query
    heads (the specs split ``wq`` / ``wo`` alike, so shard j holds the
    query heads of its KV heads), its slice of the replicated ``wk`` /
    ``wv`` — and the shards' ``wo`` partials add over 'model' in f32,
    rounded once. Over sequence parts the query heads are whole (``wq``
    / ``wo`` gathered over 'model' where split) and the parts attend
    together (:func:`_decode_heads`). Returns ``[b, 1, d]``."""
    heads = layout.heads
    if heads == 1:
        dev = x.device
        p = dict(params, wq=_whole_heads(params["wq"], 1, dev),
                 wo=_whole_heads(params["wo"], 0, dev))
        return _decode_heads(
            p, x, {s: pc for (_, s), pc in pieces.items()}, layout.parts,
            layout.seq_axes, k_scale, cache_index, energon,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            rope_theta=rope_theta, use_qk_norm=use_qk_norm, window=window,
            layer_index=layer_index)
    kvp, hp = num_kv_heads // heads, num_heads // heads
    js = sorted({j for j, _ in pieces})
    devices = [pieces[(j, min(s for jj, s in pieces if jj == j))]["k"].device
               for j in js]
    # a share holds its own KV-head shard alone
    share = None if len(js) == heads else (heads, js[0])
    xs = col.broadcast(x, devices, axes=layout.head_axes, share=share)
    partials = []
    for i, j in enumerate(js):
        p = {"wq": _head_shard(params["wq"], j, hp, 1),
             "wk": params["wk"].narrow(1, j * kvp, kvp),
             "wv": params["wv"].narrow(1, j * kvp, kvp),
             "wo": _head_shard(params["wo"], j, hp, 0)}
        for name in ("q_norm", "k_norm"):
            if name in params:
                p[name] = params[name]
        partials.append(_decode_heads(
            p, xs[i], {s: pc for (jj, s), pc in pieces.items() if jj == j},
            layout.parts, layout.seq_axes,
            None if k_scale is None else k_scale.narrow(-2, j * kvp, kvp),
            cache_index, energon, num_heads=hp, num_kv_heads=kvp,
            rope_theta=rope_theta, use_qk_norm=use_qk_norm, window=window,
            layer_index=layer_index).to(x.device))
    return col.all_reduce(partials, x.device, axes=layout.head_axes,
                          share=share)
