"""Serving over a tensor-parallel mesh, on ``cpu × M`` meshes.

Against the reference: the page-pool placement rule
(``paged_pool_pspec``) over a grid of shapes, the fused paged ops on a
head-sharded pool (outputs within fp32 1e-5 of the JAX ops, stats
exact), the greedy streams of a lone engine on a ``(1, 2)`` mesh (the
JAX ``ServeLoop``'s), and ``merge_partial_attention`` /
``partial_attention_stats`` (fp32, 1e-6 absolute and relative).

In-port contracts, bit for bit: the sharded ops ≡ the unsharded ones
(pools given whole or as shards), a TP engine ≡ the single-device
engine — greedy and stochastic requests, prefix sharing on, ample and
preempting pools, and preempted-on-mesh ≡ ample single-device —, shared
≡ unshared on a TP mesh, and a mesh whose model axis does not divide the
KV heads (the reference shards page rows there; the port keeps the pool
whole) ≡ single device. The refusals: a lone engine on a data axis > 1,
a mesh on the contiguous cache, a sharded pool without its mesh, and
the launcher's ``--mesh`` with too few devices.

The test model is the reference's mesh-serving one
(``tests/test_distributed.py``): 2 layers, d 32, 4 / 2 heads of 8,
``pallas``, key blocks of 8."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.core import sparse_attention as jspa
from repro.distributed import sharding as jshd
from repro.kernels import ops as jops
from repro.models import LMModel as JaxLMModel
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_params
from repro_torch.core import EnergonConfig
from repro_torch.core import sparse_attention as tspa
from repro_torch.core.energon_attention import _prefill_diag_blocks
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import LMModel
from repro_torch.models import attention as attn
from repro_torch.runtime import Request, ServeLoop
from repro_torch.runtime import paged_cache as pgc
from tests._torch_port import jax_model_config, n, t


def cpu_mesh(d, m):
    return make_mesh((d, m), ("data", "model"), ["cpu"] * (d * m))


def mesh_config(impl="pallas", kv=2, heads=4):
    return ModelConfig(
        name=f"mesh-serve-{impl}", family="dense", num_layers=2,
        d_model=32, num_heads=heads, num_kv_heads=kv, head_dim=8, d_ff=64,
        vocab_size=64, dtype="float32", remat="none",
        energon=EnergonConfig(impl=impl, pruning_ratio=2.0, query_block=8,
                              key_block=8, decode_key_block=8,
                              min_prune_layer=1, filter_cache_min_len=0))


@pytest.fixture(scope="module")
def models():
    """The reference's mesh-serving model in both packages (the port's
    params converted from the JAX init), and an MHA variant with four KV
    heads for a (1, 4) mesh."""
    cfg = mesh_config()
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    kv4 = LMModel(mesh_config(kv=4), device="cpu")
    return {"kv2": (model, params, jmodel, jparams),
            "kv4": (kv4, kv4.init(seed=3), None, None)}


def trace():
    """The reference's mesh trace: eight prompts, every third sampled at
    0.7, and two on one 16-token prefix."""
    rng = np.random.default_rng(1)
    reqs = [(u, rng.integers(1, 63, size=int(L)).tolist(),
             0.7 if u % 3 == 0 else 0.0)
            for u, L in enumerate((12, 24, 6, 40, 17, 9, 30, 21))]
    shared = rng.integers(1, 63, size=16).tolist()
    reqs += [(100 + i, shared + rng.integers(1, 63, size=4).tolist(), 0.0)
             for i in range(2)]
    return reqs


def drain(engine, reqs, request=Request, max_new=6):
    for u, prompt, temp in reqs:
        engine.submit(request(uid=u, prompt=list(prompt),
                              max_new_tokens=max_new, temperature=temp))
    engine.run_until_drained()
    return {r.uid: list(r.tokens_out) for r in engine.completed}


def engine(model, params, mesh=None, **kw):
    kw = dict(dict(batch_slots=4, max_len=64, prefill_chunk=8, seed=7,
                   device="cpu"), **kw)
    return ServeLoop(model, params, mesh=mesh, **kw)


# --------------------------------------------------------------------------
# (a) placement
# --------------------------------------------------------------------------


class _StubMesh:
    """What ``paged_pool_pspec`` reads of a mesh: no devices needed."""

    def __init__(self, m):
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": m}


class _Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_pool_spec_matches_reference(m, ps):
    mesh = _StubMesh(m)
    checked = 0
    for kv in range(1, 9):
        for pages in (1, 2, 3, 4, 6, 8, 12):
            rows = pages * ps
            shapes = {"k": (2, kv, rows, 8), "v": (kv, rows, 8),
                      "k_codes": (3, kv, rows, 16),
                      "k_scale": (2, kv, pages), "other": (2, kv, rows, 8)}
            for name, shape in shapes.items():
                ref = jshd.paged_pool_pspec(
                    (jax.tree_util.DictKey(name),), _Leaf(shape), mesh, ps)
                assert shd.paged_pool_spec(name, shape, mesh, ps) == tuple(
                    ref), (name, shape, m, ps)
                checked += 1
    assert checked == 8 * 7 * 5


def test_shard_paged_cache_splits_heads_or_keeps_the_pool_whole(models):
    model = models["kv2"][0]
    cache = model.init_paged_cache(8)
    gen = torch.Generator().manual_seed(0)
    for leaf in cache.values():
        leaf.copy_(torch.randint(-99, 99, leaf.shape, generator=gen))
    sharded = shd.shard_paged_cache(cache, cpu_mesh(1, 2), 8)
    for name, leaf in cache.items():
        parts = sharded[name]
        assert isinstance(parts, tuple) and len(parts) == 2
        for s, part in enumerate(parts):
            assert torch.equal(part, leaf[:, s:s + 1])
            assert part.data_ptr() != leaf.data_ptr()
    # every shard layer is a cache leaf with the write scratch after it
    attn._rows_with_scratch(sharded["k"][1][1], 8)
    assert pgc.attention_cache_bytes(sharded) == pgc.attention_cache_bytes(
        cache)
    assert pgc.attention_cache_shard_bytes(sharded) == [
        pgc.attention_cache_bytes(cache) // 2] * 2
    # KV 2 on a model axis of 4: the reference shards page rows; the
    # port keeps every leaf whole on the first device, unchanged
    whole = shd.shard_paged_cache(cache, cpu_mesh(1, 4), 8)
    assert all(whole[k] is cache[k] for k in cache)
    assert pgc.pool_shards(whole) is None


# --------------------------------------------------------------------------
# (b) the fused paged ops on a head-sharded pool
# --------------------------------------------------------------------------

KV, G, D, BK, NQ, BQ = 4, 2, 16, 8, 16, 8


def _pool_operands(seed=0, batch=3, mb=6, num_pages=20):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_pages)
    tables = perm[:batch * mb].reshape(batch, mb).astype(np.int32)
    kp = rng.normal(size=(KV, num_pages * BK, D)).astype(np.float32)
    vp = rng.normal(size=(KV, num_pages * BK, D)).astype(np.float32)
    codes, scale = jq.quantize_int16_blocks(jnp.asarray(kp), BK)
    return tables, dict(k=kp, v=vp, codes=np.asarray(codes),
                        scale=np.asarray(scale))


def _split(x, m):
    per = x.shape[0] // m
    return tuple(x[s * per:(s + 1) * per].clone() for s in range(m))


def _sharded_calls(call, pool, m):
    """``call(k, v, codes, scale)`` on the whole pool without a mesh, then
    on a (1, m) mesh with the pool whole and as head shards."""
    leaves = [t(pool[k]) for k in ("k", "v", "codes", "scale")]
    ref = call(*leaves)
    with shd.active_mesh(cpu_mesh(1, m)):
        whole = call(*leaves)
        shards = call(*(_split(x, m) for x in leaves))
    return ref, whole, shards


@pytest.mark.parametrize("m", [2, 4])
def test_fused_paged_decode_on_a_tp_mesh(m):
    tables, pool = _pool_operands(seed=m)
    rng = np.random.default_rng(10 + m)
    q = rng.normal(size=(3, KV, G, D)).astype(np.float32)
    cl = np.array([5, 30, 48], np.int32)
    budget = 3
    lb = np.array([1, 3, 3], np.int32)
    kw = dict(key_block=BK, block_budget=budget, telemetry=True)
    ref, whole, shards = _sharded_calls(
        lambda *leaves: tops.fused_paged_decode_attention(
            t(q), *leaves, t(tables), t(cl), live_budget=t(lb), **kw),
        pool, m)
    for out, stats in (whole, shards):
        assert torch.equal(out, ref[0]) and torch.equal(stats, ref[1])
    jout, jstats = jops.fused_paged_decode_attention(
        jnp.asarray(q), *(jnp.asarray(pool[k]) for k in
                          ("k", "v", "codes", "scale")),
        jnp.asarray(tables), jnp.asarray(cl), live_budget=jnp.asarray(lb),
        **kw)
    np.testing.assert_allclose(n(shards[0]), n(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(n(shards[1]), n(jstats))


@pytest.mark.parametrize("m", [2, 4])
def test_fused_paged_prefill_on_a_tp_mesh(m):
    tables, pool = _pool_operands(seed=20 + m)
    mb = tables.shape[1]
    n_k = mb * BK
    rng = np.random.default_rng(30 + m)
    q = rng.normal(size=(3, KV, NQ, D)).astype(np.float32)
    pos = np.stack([o + np.arange(NQ) for o in (0, 16, 30)]).astype(np.int32)
    pos[2, -4:] = n_k                       # sentinel rows
    budget = max(1, math.ceil(mb / 2.0))
    kw = dict(query_block=BQ, key_block=BK, block_budget=budget,
              telemetry=True)
    diag = _prefill_diag_blocks(t(pos), BQ, BK, n_k)
    ref, whole, shards = _sharded_calls(
        lambda *leaves: tops.fused_paged_prefill_attention(
            t(q), *leaves, t(tables), t(pos), diag_blocks=diag, **kw),
        pool, m)
    for out, stats in (whole, shards):
        assert torch.equal(out, ref[0]) and torch.equal(stats, ref[1])
    jout, jstats = jops.fused_paged_prefill_attention(
        jnp.asarray(q), *(jnp.asarray(pool[k]) for k in
                          ("k", "v", "codes", "scale")),
        jnp.asarray(tables), jnp.asarray(pos), diag_blocks=jnp.asarray(
            n(diag)), **kw)
    np.testing.assert_allclose(n(shards[0]), n(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(n(shards[1]), n(jstats))


def test_a_sharded_pool_needs_its_mesh():
    tables, pool = _pool_operands()
    q = torch.zeros((3, KV, G, D))
    leaves = [_split(t(pool[k]), 2) for k in ("k", "v", "codes", "scale")]
    with pytest.raises(ValueError, match="mesh active"):
        tops.fused_paged_decode_attention(
            q, *leaves, t(tables), torch.full((3,), 9, dtype=torch.int32),
            key_block=BK)
    with shd.active_mesh(cpu_mesh(1, 4)), pytest.raises(ValueError,
                                                        match="shards"):
        tops.fused_paged_decode_attention(
            q, *leaves, t(tables), torch.full((3,), 9, dtype=torch.int32),
            key_block=BK)


# --------------------------------------------------------------------------
# (c), (d), (f) engines on a mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,m", [("kv2", 2), ("kv4", 4)],
                         ids=["kv2-mesh1x2", "kv4-mesh1x4"])
def test_tp_streams_equal_single_device(models, name, m):
    """A lone engine on a TP mesh streams as the single-device engine,
    greedy and sampled, prefix sharing on, ample and preempting pools;
    the preempted mesh run equals the ample single-device run."""
    model, params = models[name][:2]
    mesh = cpu_mesh(1, m)
    ref = drain(engine(model, params), trace())
    tp_eng = engine(model, params, mesh)
    assert isinstance(tp_eng.cache["k"], tuple)
    assert len(tp_eng.cache["k"]) == m
    tp = drain(tp_eng, trace())
    ref_pre = drain(engine(model, params, num_pages=12), trace())
    tp_pre_eng = engine(model, params, mesh, num_pages=12)
    tp_pre = drain(tp_pre_eng, trace())
    assert tp == ref and len(tp) == 10
    assert tp_pre == ref_pre
    assert tp_pre == ref
    assert tp_pre_eng.metrics.preemptions > 0
    assert tp_eng.sharing and tp_pre_eng.sharing
    assert any(temp > 0 for _, _, temp in trace())
    tp_pre_eng.allocator.check_invariants()


def test_tp_greedy_streams_match_reference(models):
    model, params, jmodel, jparams = models["kv2"]
    greedy = [(u, p, 0.0) for u, p, _ in trace()]
    ref = drain(JaxServeLoop(jmodel, jparams, batch_slots=4, max_len=64,
                             prefill_chunk=8), greedy, request=JaxRequest)
    assert drain(engine(model, params, cpu_mesh(1, 2)), greedy) == ref


def shared_trace():
    """The reference's: three prefix families of 40 tokens, mixed
    temperatures."""
    tok = lambda fam, j: (fam * 97 + j * 31) % 61 + 1
    return [(u, [tok(u % 3, j) for j in range(40)]
             + [tok(u % 3 + 5, u * 17 + j) for j in range((u * 7) % 13)],
             0.8 if u % 2 else 0.0) for u in range(6)]


def test_shared_equals_unshared_on_tp_mesh(models):
    model, params = models["kv2"][:2]
    kw = dict(batch_slots=2, num_pages=32)
    mesh = cpu_mesh(1, 2)
    shared_eng = engine(model, params, mesh, prefix_sharing=True, **kw)
    shared = drain(shared_eng, shared_trace())
    unshared = drain(engine(model, params, mesh, prefix_sharing=False, **kw),
                     shared_trace())
    assert shared == unshared and len(shared) == 6
    assert shared_eng.metrics.prefix_hits > 0
    assert shared_eng.metrics.prefill_tokens_skipped > 0


def test_row_shard_mesh_keeps_the_pool_whole(models):
    """KV 2 over a model axis of 4: the reference shards page rows and
    its fused ops do not engage tensor parallelism; the port keeps the
    pool whole on the first device and streams as the single engine."""
    model, params = models["kv2"][:2]
    mesh = cpu_mesh(1, 4)
    assert shd.paged_pool_spec("k", (2, 2, 64 * 8, 8), mesh, 8) == (
        None, None, "model", None)
    eng = engine(model, params, mesh, num_pages=64)
    assert pgc.pool_shards(eng.cache) is None
    assert drain(eng, trace()) == drain(
        engine(model, params, num_pages=64), trace())


def test_make_serve_step_runs_on_its_mesh(models):
    """``make_serve_step`` / ``make_prefill_step`` with a mesh: the step
    activates the mesh itself (the fused ops refuse a sharded pool
    without it) and gives the whole pool's logits and rows."""
    from repro_torch.runtime import make_prefill_step, make_serve_step

    model, params = models["kv2"][:2]
    mesh = cpu_mesh(1, 2)
    cache = model.init_paged_cache(16, max_len=64)
    sharded = shd.shard_paged_cache(cache, mesh, 8)
    table = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    tokens = torch.randint(1, 63, (2, 8), generator=torch.Generator(
        ).manual_seed(0), dtype=torch.int32)
    pre = {"tokens": tokens, "positions": torch.arange(8, dtype=torch.int32
                                                       ).repeat(2, 1),
           "block_table": table}
    dec = {"tokens": tokens[:, :1], "block_table": table,
           "active": torch.tensor([True, True])}
    zero = torch.zeros(2, dtype=torch.int32)
    eight = torch.full((2,), 8, dtype=torch.int32)
    for make, inputs, index in ((make_prefill_step, pre, zero),
                                (make_serve_step, dec, eight)):
        ref, _ = make(model, device="cpu")(params, cache, inputs, index)
        logits, _ = make(model, mesh=mesh)(params, sharded, inputs, index)
        assert torch.equal(logits, ref)
    for name, leaf in cache.items():
        assert torch.equal(torch.cat(sharded[name], dim=1), leaf), name
    assert shd.get_active_mesh() is None
    with pytest.raises(ValueError, match="mesh active"):
        model.decode_step(params, sharded, dec, eight)


# --------------------------------------------------------------------------
# (e) refusals
# --------------------------------------------------------------------------


def test_lone_engine_refuses_a_data_axis(models):
    model, params = models["kv2"][:2]
    with pytest.raises(ValueError, match="ReplicatedServeLoop"):
        engine(model, params, cpu_mesh(2, 2))


def test_mesh_needs_the_paged_cache(models):
    model, params = models["kv2"][:2]
    with pytest.raises(ValueError, match="paged cache"):
        engine(model, params, cpu_mesh(1, 2), paged=False)


def test_launcher_mesh_needs_enough_devices(capsys):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match=r"--mesh 2x2 needs 4 devices, "
                       r"have 1 \(try --simulate-devices 4\)"):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--mesh", "2x2"])
    with pytest.raises(SystemExit, match="DxM"):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--mesh", "2by2"])


def test_launcher_serves_on_a_simulated_mesh(capsys):
    from repro_torch.launch import serve

    eng = serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                      "--requests", "5", "--prompt-len", "20",
                      "--new-tokens", "4", "--mesh", "2x2",
                      "--simulate-devices", "4"])
    out = capsys.readouterr().out
    assert "mesh 2x2 (data x model)" in out and "2 engine replicas" in out
    assert "2 head shards" in out
    assert len(eng.completed) == 5
    assert sorted(set(eng.placement.values())) == [0, 1]


def test_mesh_grid():
    mesh = cpu_mesh(2, 3)
    assert mesh.shape == {"data": 2, "model": 3}
    assert mesh.submesh(1).shape == {"data": 1, "model": 3}
    assert mesh.physical_devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="grid"):
        Mesh([["cpu"], ["cpu", "cpu"]])


# --------------------------------------------------------------------------
# (j) partial attention statistics and their merge
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_partial_attention_merge_matches_reference(shards):
    rng = np.random.default_rng(shards)
    q = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
    k = rng.normal(size=(2, 3, 32, 8)).astype(np.float32)
    v = rng.normal(size=(2, 3, 32, 8)).astype(np.float32)
    keep = rng.random((2, 3, 5, 32)) < 0.6
    keep[0, 0, 0] = False                    # a row with no key
    per = 32 // shards
    parts_t, parts_j = [], []
    for s in range(shards):
        sl = slice(s * per, (s + 1) * per)
        args = (q, k[..., sl, :], v[..., sl, :], keep[..., sl])
        parts_t.append(tspa.partial_attention_stats(*(t(a) for a in args)))
        parts_j.append(jspa.partial_attention_stats(
            *(jnp.asarray(a) for a in args)))
        for a, b in zip(parts_t[-1], parts_j[-1]):
            np.testing.assert_allclose(n(a), n(b), atol=1e-6, rtol=1e-6)
    merged = tspa.merge_partial_attention(
        *(torch.stack([p[i] for p in parts_t]) for i in range(3)))
    ref = jspa.merge_partial_attention(
        *(jnp.stack([p[i] for p in parts_j]) for i in range(3)))
    np.testing.assert_allclose(n(merged), n(ref), atol=1e-6, rtol=1e-6)
    # the merge is the masked attention over all keys (rows with a key)
    dense = tspa.dense_attention(t(q), t(k), t(v), t(keep))
    live = keep.any(-1)
    np.testing.assert_allclose(n(merged)[live], n(dense)[live], atol=1e-6,
                               rtol=1e-5)
