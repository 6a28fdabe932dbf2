"""What lets the port's serve steps replay from CUDA graphs, checked on
the CPU at the serve-smoke size (the card's graphed ≡ eager checks are
in ``test_torch_cuda.py``).

* No host sync: ``LMModel.decode_step`` and ``prefill``, paged and
  contiguous, with the fused kernels and on the XLA selection paths
  (``mpmrf_block``, ``mpmrf_row``, pallas without resident planes), run
  under a dispatch mode that fails on the ops that read
  a device value on the host or give a data-dependent shape (the
  parent's cache write plans made one ``nonzero`` per call, which CUDA
  graph capture refuses).
* The fixed-shape write plans send a dropped row (a sentinel position,
  a masked-off slot, an idle slot whose table aliases a live slot's
  page) to the scratch target after each layer's leaves, and leave the
  cache bit for bit as the parent's ``nonzero`` plans did (kept below as
  the oracle); nothing reads the scratch; a leaf without it is refused
  where the write would reach past it.
* The same over an MoE step on the expert-parallel path (experts and
  pool split over a ``(1, 2)`` mesh), and on the ``"serve"`` profile's
  2-D path (``apply_moe_serve_2d``) on that mesh.
* The same over a head-sharded pool (a tensor-parallel mesh), whose step
  gives the whole pool's logits and rows.
* A step on idle inputs, as warm-up and capture run it, leaves the cache
  bit for bit as it was.
* Launch accounting across replays: a capture's launches, set aside,
  added once per replay, equal an eager call's; a warm-up counts none.
* On the CPU, ``make_serve_step`` / ``make_prefill_step`` are the eager
  methods and ``ServeLoop`` runs no graph.

The new modules are imported inside the tests that use them, so the
dispatch guard also runs against a tree without them."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import get_serve_config
from repro_torch.core import quantization as qlib
from repro_torch.models import LMModel
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.runtime import paged_cache as pgc

MAX_LEN, CHUNK, SLOTS, PAGES = 64, 8, 3, 12
aten = torch.ops.aten


@pytest.fixture(scope="module")
def smoke():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    model = LMModel(cfg, device="cpu")
    return cfg, model, model.init(seed=0)


def _prompts(cfg, lens=(21, 13), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size - 1, size=n) for n in lens]


# pages 1-4 slot 0's, 5-8 slot 1's; idle slot 2 aliases slot 0's pages
TABLE = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [1, 2, 3, 4]], np.int32)


def _filled(model, params, paged):
    """A cache holding two prompts (slots 0, 1; slot 2 idle) after two
    chunks of prefill, and the inputs of one more prefill chunk and one
    decode step that carry sentinels and an idle slot."""
    cache = (model.init_paged_cache(PAGES, max_len=MAX_LEN) if paged
             else model.init_cache(SLOTS, MAX_LEN))
    prompts = _prompts(model.cfg)
    extra = {"block_table": torch.from_numpy(TABLE)} if paged else {}
    zero = torch.zeros(SLOTS, dtype=torch.int32)

    def chunk_inputs(c):
        toks = np.zeros((SLOTS, CHUNK), np.int32)
        pos = np.full((SLOTS, CHUNK), MAX_LEN, np.int32)     # sentinels
        for b, p in enumerate(prompts):
            part = p[c * CHUNK:(c + 1) * CHUNK]
            toks[b, :len(part)] = part
            pos[b, :len(part)] = c * CHUNK + np.arange(len(part))
        return {"tokens": torch.from_numpy(toks),
                "positions": torch.from_numpy(pos), **extra}

    for c in range(2):
        model.prefill(params, cache, chunk_inputs(c), zero)
    decode = {"tokens": torch.tensor([[5], [9], [0]], dtype=torch.int32),
              **extra}
    if paged:
        decode["active"] = torch.tensor([True, True, False])
        index = torch.tensor([16, 13, 16], dtype=torch.int32)
    else:
        index = torch.tensor([16, 13, MAX_LEN], dtype=torch.int32)
    return cache, chunk_inputs(2), zero, decode, index


# --------------------------------------------------------------------------
# no host sync in a step
# --------------------------------------------------------------------------


class HostSyncGuard(TorchDispatchMode):
    """Records every op that reads a device value on the host or whose
    output shape depends on the data."""

    SYNCING = (aten.nonzero, aten._local_scalar_dense, aten.masked_select,
               aten.is_nonzero, aten.equal)
    INDEXING = (aten.index, aten.index_put, aten.index_put_,
                aten._index_put_impl_)

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in self.SYNCING:
            self.seen.append(str(packet))
        elif packet in self.INDEXING and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.seen.append(f"{packet} with a bool index")
        return func(*args, **kwargs)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("method", ["decode_step", "prefill"])
def test_serve_steps_make_no_host_sync(smoke, paged, method):
    _, model, params = smoke
    cache, pre, zero, dec, index = _filled(model, params, paged)
    inputs, idx = (dec, index) if method == "decode_step" else (pre, zero)
    with HostSyncGuard() as guard:
        logits, _ = getattr(model, method)(params, cache, inputs, idx)
    assert guard.seen == []
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("method", ["decode_step", "prefill"])
@pytest.mark.parametrize("impl", ["mpmrf_block", "mpmrf_row",
                                  "pallas_fresh"])
def test_xla_serve_steps_make_no_host_sync(paged, method, impl):
    """The same guard over the reference's XLA selection paths: the
    block impl (resident planes), the row impl and pallas without
    resident planes (the XLA block path, fresh quantization)."""
    import dataclasses

    cfg = get_serve_config("qwen3-14b", smoke=True)
    over = (dict(impl="pallas", filter_cache_min_len=None)
            if impl == "pallas_fresh" else dict(impl=impl))
    cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, **over))
    model = LMModel(cfg, device="cpu")
    params = model.init(seed=0)
    cache, pre, zero, dec, index = _filled(model, params, paged)
    assert ("k_codes" in cache) == (impl == "mpmrf_block")
    inputs, idx = (dec, index) if method == "decode_step" else (pre, zero)
    with HostSyncGuard() as guard:
        logits, _ = getattr(model, method)(params, cache, inputs, idx)
    assert guard.seen == []
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("method", ["decode_step", "prefill"])
@pytest.mark.parametrize("impl", ["pallas", "mpmrf_block"])
def test_sharded_serve_steps_make_no_host_sync(method, impl):
    """The same guard over a step on a head-sharded pool (a ``(1, 2)``
    mesh of the CPU, active): per-shard writes, the fused ops once per
    shard (pallas), the shards' gathers (the dense prefix, mpmrf_block).
    The step's logits and every shard's leaves are the whole pool's
    step's, bit for bit."""
    import dataclasses

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    cfg = get_serve_config("qwen3-14b", smoke=True)
    cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, impl=impl))
    model = LMModel(cfg, device="cpu")
    params = model.init(seed=0)
    cache, pre, zero, dec, index = _filled(model, params, paged=True)
    mesh = make_mesh((1, 2), devices=["cpu", "cpu"])
    sharded = shd.shard_paged_cache(cache, mesh, cfg.energon.decode_key_block)
    inputs, idx = (dec, index) if method == "decode_step" else (pre, zero)
    ref, _ = getattr(model, method)(params, cache, inputs, idx)
    with shd.active_mesh(mesh), HostSyncGuard() as guard:
        logits, _ = getattr(model, method)(params, sharded, inputs, idx)
    assert guard.seen == []
    assert torch.equal(logits, ref)
    for name, leaf in cache.items():
        assert isinstance(sharded[name], tuple)
        assert torch.equal(torch.cat(sharded[name], dim=1), leaf), name


@pytest.mark.parametrize("method", ["decode_step", "prefill"])
def test_expert_parallel_serve_steps_make_no_host_sync(method):
    """The same guard over an MoE step on a ``(1, 2)`` mesh of the CPU:
    the pool split by KV head, the experts by the model axis
    (``shard_experts``), every layer's MoE through the expert-parallel
    path — routing once, each shard's dispatch, experts and combine, the
    cross-shard sum. Its logits are finite and, in fp32, within 1e-5 of
    the single-device step's (the cross-shard sum adds the top-k
    contributions in another order)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    model = LMModel(get_serve_config("olmoe-1b-7b", smoke=True),
                    device="cpu")
    params = model.init(seed=0)
    cache, pre, zero, dec, index = _filled(model, params, paged=True)
    mesh = make_mesh((1, 2), devices=["cpu", "cpu"])
    sharded = shd.shard_paged_cache(cache, mesh, 16)
    ep = shd.shard_experts(params, mesh)
    assert isinstance(ep["blocks"]["moe"]["w_down"], tuple)
    inputs, idx = (dec, index) if method == "decode_step" else (pre, zero)
    ref, _ = getattr(model, method)(params, cache, inputs, idx)
    with shd.active_mesh(mesh), HostSyncGuard() as guard:
        logits, _ = getattr(model, method)(ep, sharded, inputs, idx)
    assert guard.seen == []
    assert torch.isfinite(logits).all()
    torch.testing.assert_close(logits, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method", ["decode_step", "prefill"])
def test_serve_profile_2d_moe_steps_make_no_host_sync(method):
    """The same guard over an MoE step under the ``"serve"`` rules
    profile on a ``(1, 2)`` mesh of the CPU, as ``ServeLoop`` runs it:
    every layer's MoE through ``apply_moe_serve_2d`` (routing once, each
    device's dispatch, d_ff slice and combine, one f32 sum), no host
    sync; its logits finite and, in fp32, within 1e-5 of the
    single-device step's."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    model = LMModel(get_serve_config("olmoe-1b-7b", smoke=True),
                    device="cpu")
    params = model.init(seed=0)
    cache, pre, zero, dec, index = _filled(model, params, paged=True)
    mesh = make_mesh((1, 2), devices=["cpu", "cpu"])
    sharded = shd.shard_paged_cache(cache, mesh, 16)
    inputs, idx = (dec, index) if method == "decode_step" else (pre, zero)
    ref, _ = getattr(model, method)(params, cache, inputs, idx)
    calls = []
    real = moe.apply_moe_serve_2d

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    shd.set_rules_profile("serve")
    moe.apply_moe_serve_2d = spy
    try:
        two_d = shd.shard_experts(params, mesh)
        assert isinstance(two_d["blocks"]["moe"]["w_up"], tuple)
        with shd.active_mesh(mesh), HostSyncGuard() as guard:
            logits, _ = getattr(model, method)(two_d, sharded, inputs, idx)
    finally:
        moe.apply_moe_serve_2d = real
        shd.set_rules_profile("train")
    assert guard.seen == []
    assert len(calls) == model.cfg.num_layers
    assert torch.isfinite(logits).all()
    torch.testing.assert_close(logits, ref, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# fixed-shape write plans against the parent's nonzero plans
# --------------------------------------------------------------------------


def _old_fold_paged(params, x, cache, positions, table, write_mask, *,
                    kw, ps):
    """The parent's paged write: ``nonzero`` keeps the rows below the
    pool, then the scatter and the per-page re-quantization."""
    chunk = x.shape[1]
    kv = kw["num_kv_heads"]
    q, k, v = attn._project_qkv(params, x, positions, kw["use_qk_norm"],
                                kw["rope_theta"])
    k_pool, v_pool = cache["k"], cache["v"]
    rowid = pgc.paged_row_targets(positions, table, ps,
                                  write_mask=write_mask).reshape(-1)
    src = torch.nonzero(rowid < k_pool.shape[-2]).reshape(-1)
    rows = rowid[src]
    k_pool[:, rows] = k.reshape(-1, kv, k.shape[-1])[src].transpose(0, 1)
    v_pool[:, rows] = v.reshape(-1, kv, v.shape[-1])[src].transpose(0, 1)
    num_pages, hd = cache["k_scale"].shape[-1], k_pool.shape[-1]
    if chunk == 1:
        page = rows // ps
        sel = k_pool.view(kv, num_pages, ps, hd)[:, page]
        codes, scale = qlib.quantize_int16_blocks(sel, ps)
        cache["k_codes"].view(kv, num_pages, ps, hd)[:, page] = codes
        cache["k_scale"][:, page] = scale[..., 0]
    else:
        codes, scales = qlib.quantize_int16_blocks(k_pool, ps)
        cache["k_codes"].copy_(codes)
        cache["k_scale"].copy_(scales)
    return attn._fold_groups(q, kw["num_heads"], kv)


def _old_fold_contiguous(params, x, cache, positions, *, kw, block):
    """The parent's contiguous write: ``nonzero`` keeps positions inside
    the cache, then the positional scatter and the plane refresh."""
    chunk = x.shape[1]
    kv = kw["num_kv_heads"]
    q, k, v = attn._project_qkv(params, x, positions, kw["use_qk_norm"],
                                kw["rope_theta"])
    pos = positions.reshape(-1).long()
    src = torch.nonzero((pos >= 0) & (pos < cache["k"].shape[-2])
                        ).reshape(-1)
    slot = src // chunk
    cache["k"][slot, :, pos[src]] = k.reshape(-1, kv, k.shape[-1])[src]
    cache["v"][slot, :, pos[src]] = v.reshape(-1, kv, v.shape[-1])[src]
    if chunk == 1:
        attn._refresh_filter_block(cache, positions[:, 0], block)
    else:
        codes, scales = qlib.quantize_int16_blocks(cache["k"], block)
        cache["k_codes"].copy_(codes)
        cache["k_scale"].copy_(scales)
    return attn._fold_groups(q, kw["num_heads"], kv)


def _twin_layer_caches(cfg, paged, seed):
    """One layer's cache with random rows (and their planes) twice: with
    the write scratch after it (the new layout) and without."""
    kv, hd, ps = cfg.num_kv_heads, cfg.head_dim, cfg.energon.decode_key_block
    if paged:
        rows = PAGES * ps
        shapes = {"k": (kv, rows, hd), "v": (kv, rows, hd),
                  "k_codes": (kv, rows, hd), "k_scale": (kv, PAGES)}
        scratch = attn.paged_scratch(ps, hd)
    else:
        shapes = {k: (SLOTS, kv, MAX_LEN, hd) for k in ("k", "v", "k_codes")}
        shapes["k_scale"] = (SLOTS, kv, MAX_LEN // ps)
        scratch = attn.contiguous_scratch(hd)
    gen = torch.Generator().manual_seed(seed)
    k = torch.randn(shapes["k"], generator=gen)
    codes, scale = qlib.quantize_int16_blocks(k, ps)
    vals = {"k": k, "v": torch.randn(shapes["v"], generator=gen),
            "k_codes": codes, "k_scale": scale}
    new = {}
    for key, shape in shapes.items():
        new[key] = attn.stacked_leaf(1, shape, vals[key].dtype, "cpu",
                                     scratch.get(key, 0))[0]
        new[key].copy_(vals[key])
    return new, {key: v.clone() for key, v in vals.items()}


WRITE_CASES = {
    # slot 1 at the sentinel, idle slot 2 on slot 0's very row
    "paged-decode": (True, [[16], [MAX_LEN], [16]], [True, True, False]),
    # slot 1's chunk ends in padding; idle slot 2 all sentinels over
    # slot 0's pages
    "paged-prefill": (True, [list(range(16, 24)),
                             [60, 61, 62, 63] + [MAX_LEN] * 4,
                             [MAX_LEN] * 8], None),
    "unpaged-decode": (False, [[20], [MAX_LEN], [63]], None),
    "unpaged-prefill": (False, [list(range(16, 24)),
                                [60, 61, 62, 63] + [MAX_LEN] * 4,
                                [MAX_LEN] * 8], None),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_fixed_plans_write_what_the_nonzero_plans_wrote(smoke, case):
    cfg, model, params = smoke
    paged, positions, mask = WRITE_CASES[case]
    positions = torch.tensor(positions, dtype=torch.int32)
    chunk = positions.shape[1]
    layer = tfm.layer_slice(params["blocks"], cfg.energon.min_prune_layer)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((SLOTS, chunk, cfg.d_model), generator=gen)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              rope_theta=cfg.rope_theta, use_qk_norm=cfg.use_qk_norm)
    ps = cfg.energon.decode_key_block
    new, old = _twin_layer_caches(cfg, paged, seed=2)
    if paged:
        table = torch.from_numpy(TABLE)
        active = None if mask is None else torch.tensor(mask)
        write = attn.paged_write_plan(positions, table, ps,
                                      new["k"].shape[-2],
                                      cfg.num_kv_heads, write_mask=active)
        q_new = attn._project_update_fold_paged(
            layer["attn"], x, new, positions, write, filter_block=ps, **kw)
        q_old = _old_fold_paged(layer["attn"], x, old, positions, table,
                                active, kw=kw, ps=ps)
    else:
        write = attn.cache_write_plan(positions, MAX_LEN, cfg.num_kv_heads)
        q_new = attn._project_update_fold(
            layer["attn"], x, new, positions, write, filter_block=ps, **kw)
        q_old = _old_fold_contiguous(layer["attn"], x, old, positions,
                                     kw=kw, block=ps)
    assert write.rows.numel() == SLOTS * chunk * cfg.num_kv_heads
    assert torch.equal(q_new, q_old)
    for key in old:
        assert torch.equal(new[key], old[key]), key


def _scratch(leaf, n):
    """The ``n`` scratch elements after one layer's leaf."""
    return leaf.as_strided((n,), (1,), leaf.storage_offset() + leaf.numel())


def _scratch_sizes(cfg, paged):
    hd = cfg.head_dim
    return (attn.paged_scratch(cfg.energon.decode_key_block, hd) if paged
            else attn.contiguous_scratch(hd))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_no_read_sees_the_scratch(smoke, paged):
    """The same prefill chunk and decode step (each dropping rows) from
    the same cache, once with its scratch poisoned: the logits and the
    cache agree bit for bit, and the dropped rows did land there."""
    cfg, model, params = smoke
    runs = []
    for poison in (False, True):
        cache, pre, zero, dec, index = _filled(model, params, paged)
        if poison:
            for key, n in _scratch_sizes(cfg, paged).items():
                for layer in cache[key]:
                    bad = 32767 if layer.dtype == torch.int16 else np.nan
                    _scratch(layer, n).fill_(bad)
        out = [model.prefill(params, cache, pre, zero)[0].clone(),
               model.decode_step(params, cache, dec, index)[0].clone()]
        runs.append((out, cache))
    (out_a, cache_a), (out_b, cache_b) = runs
    for a, b in zip(out_a, out_b):
        assert torch.equal(a, b)
    for key in cache_a:
        assert torch.equal(cache_a[key], cache_b[key]), key
    for layer in cache_b["k"]:
        written = _scratch(layer, cfg.head_dim)
        assert torch.isfinite(written).all() and written.abs().sum() > 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_each_layer_of_a_cache_starts_aligned(smoke, paged):
    """The scratch after a layer must not move the next layer off the
    kernels' 16-byte operand alignment: layers start 256 bytes apart."""
    _, model, _ = smoke
    cache = (model.init_paged_cache(PAGES, max_len=MAX_LEN) if paged
             else model.init_cache(SLOTS, MAX_LEN))
    for key, leaf in cache.items():
        offsets = [layer.data_ptr() - leaf.data_ptr() for layer in leaf]
        assert all(o % 256 == 0 for o in offsets), key
        assert all(layer.is_contiguous() for layer in leaf), key


def test_a_cache_without_write_scratch_is_refused(smoke):
    _, model, params = smoke
    cache, pre, zero, _, _ = _filled(model, params, paged=True)
    plain = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(ValueError, match="no write scratch"):
        model.prefill(params, plain, pre, zero)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_a_block_refuses_leaves_without_write_scratch(smoke, case, layer):
    """The block functions check the scratch where they write past a
    leaf: given a layer of a stack without it, where the row after the
    leaf is the next layer's first, they refuse before writing."""
    cfg, model, params = smoke
    paged, positions, mask = WRITE_CASES[case]
    positions = torch.tensor(positions, dtype=torch.int32)
    blk = tfm.layer_slice(params["blocks"], cfg.energon.min_prune_layer)
    x = torch.randn((SLOTS, positions.shape[1], cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    one = (model.init_paged_cache(PAGES, max_len=MAX_LEN) if paged
           else model.init_cache(SLOTS, MAX_LEN))
    stack = {k: torch.zeros((2,) + v.shape[1:], dtype=v.dtype)
             for k, v in one.items()}
    leaves = {k: v[layer] for k, v in stack.items()}
    ps = cfg.energon.decode_key_block
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              rope_theta=cfg.rope_theta, use_qk_norm=cfg.use_qk_norm,
              filter_block=ps)
    with pytest.raises(ValueError, match="no write scratch"):
        if paged:
            write = attn.paged_write_plan(
                positions, torch.from_numpy(TABLE), ps, leaves["k"].shape[-2],
                cfg.num_kv_heads,
                write_mask=None if mask is None else torch.tensor(mask))
            attn._project_update_fold_paged(blk["attn"], x, leaves,
                                            positions, write, **kw)
        else:
            write = attn.cache_write_plan(positions, MAX_LEN,
                                          cfg.num_kv_heads)
            attn._project_update_fold(blk["attn"], x, leaves, positions,
                                      write, **kw)
    assert all(not v.any() for v in stack.values())


# --------------------------------------------------------------------------
# the capture's idle call, launch accounting, the CPU's eager steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("method", ["decode_step", "prefill"])
def test_an_idle_step_leaves_the_cache_as_it_was(smoke, paged, method):
    """Warm-up and capture run the step with every slot inactive: no row,
    code or scale of the cache changes — also where a reset page or slot
    holds all-zero blocks at scale 0, which a re-quantization would lift
    to the quantizer's floor."""
    from repro_torch.runtime.cuda_graph import idle_inputs, run_idle

    _, model, params = smoke
    cache, pre, zero, dec, index = _filled(model, params, paged)
    if paged:
        model.reset_pages(cache, torch.arange(PAGES) == 9)
    else:
        model.reset_decode_slots(cache, torch.tensor([False, False, True]))
    inputs, idx = (dec, index) if method == "decode_step" else (pre, zero)
    static, static_idx = idle_inputs(model, method, cache, inputs, idx)
    before = {k: v.clone() for k, v in cache.items()}
    assert (cache["k_scale"] == 0).any()
    run_idle(model, method, params, cache, static, static_idx)
    for key in before:
        assert torch.equal(cache[key], before[key]), key


def test_a_replay_counts_what_its_capture_launched():
    from repro_torch.kernels import _build

    saved = dict(_build.launch_counts)

    def step():                       # what a wrapper does per launch
        for name in ("mpmrf_paged_filter_scores",
                     "paged_decode_gather_attention") * 3:
            _build.count_launch(name)
        _build.count_launch("paged_prefill_gather_attention")

    try:
        _build.reset_launch_counts()
        step()
        eager = dict(_build.launch_counts)
        _build.reset_launch_counts()
        with _build.set_aside() as warm_up:
            step()
        assert not any(_build.launch_counts.values())
        with _build.set_aside() as capture:
            step()
        assert not any(_build.launch_counts.values())
        assert warm_up == capture == {k: v for k, v in eager.items() if v}
        for _ in range(4):
            _build.add_launches(capture)
        assert _build.launch_counts == {k: 4 * v for k, v in eager.items()}
    finally:
        _build.launch_counts.update(saved)


def test_cpu_steps_are_the_eager_methods(smoke):
    from repro_torch.runtime import ServeLoop, make_prefill_step, \
        make_serve_step

    _, model, params = smoke
    assert make_serve_step(model, device="cpu") == model.decode_step
    assert make_prefill_step(model, device="cpu") == model.prefill
    engine = ServeLoop(model, params, batch_slots=2, max_len=MAX_LEN,
                       prefill_chunk=CHUNK, device="cpu")
    assert not engine.cuda_graphs and engine.graphs == []
    with pytest.raises(ValueError, match="cuda_graphs needs a CUDA device"):
        ServeLoop(model, params, batch_slots=2, max_len=MAX_LEN,
                  prefill_chunk=CHUNK, device="cpu", cuda_graphs=True)


def test_a_wave_keeps_copies_of_its_last_rows():
    """A replayed step's logits are overwritten by the next replay: the
    rows a wave keeps across dispatches are copies."""
    from repro_torch.runtime.serve_loop import _take_rows

    logits = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    rows = _take_rows(logits, [(1, 2), (0, 0)])
    want = {1: logits[1, 2].clone(), 0: logits[0, 0].clone()}
    logits.zero_()
    assert set(rows) == {0, 1}
    assert all(torch.equal(rows[i], want[i]) for i in want)
    assert _take_rows(logits, []) == {}


def test_graphed_step_needs_a_cuda_device(smoke):
    from repro_torch.runtime.cuda_graph import GraphedStep

    _, model, _ = smoke
    with pytest.raises(ValueError, match="need a CUDA device"):
        GraphedStep(model, "decode_step", torch.device("cpu"))
