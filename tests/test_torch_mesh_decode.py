"""``LMModel.decode_step(..., mesh=)`` — the reference's decode under an
active mesh — against the reference's own decode under GSPMD on the
same meshes and the port's single-device step, on the CPU; the decode
attention over a cache split along the sequence; the per-pod serve-2-D
MoE; and a share's logical shard indices.

The reference runs once, in a module-scoped subprocess on eight host
devices (``tests/test_torch_mesh_train.py``'s pattern): for each case
it initializes the model, prefills 40 tokens on one device (the
recurrent families: two decode steps), then runs three decode steps
jitted with ``param_shardings`` / ``cache_shardings`` /
``batch_shardings`` on the case's ``(data, model)`` mesh, and hands
over its weights, the cache the mesh steps start from, the tokens and
each step's logits. The port starts from the same weights and cache
and decodes the same tokens over the same mesh.

Tolerances: logits in f32 within 1e-5 of max |logit| (the mesh sums its
row-parallel partials over 'model' in f32 in shard order and merges a
split cache's attention partials by log-sum-exp; XLA sums in its own
orders, so the last bits differ); the selection tables and the row
path's keep mask exact. The smoke configs ship ``mpmrf_row``, which
quantizes each query row to int16 before Eq. 3: a last-bit difference
in the query — from the tensor-parallel sums of an earlier layer —
could move a code and flip a token at the threshold, as the reference's
own GSPMD sums can. So the row path's model cases cut the model to one
layer pruned from layer 0: its query comes from the embedding, exact on
every mesh; the deeper cases run ``mpmrf_block`` (and the fused
``pallas`` serve config).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import filtering as flt
from repro_torch.core.energon_attention import (
    EnergonConfig, _decode_block_plan, _decode_valid_mask,
    _row_keep_over_parts, decode_block_table_parts,
    energon_decode_attention, energon_decode_attention_parts,
)
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LMModel
from repro_torch.models import layers as L
from repro_torch.models import moe

TOL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PREFILL, STEPS = 40, 3


def cpu_mesh(shape):
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, devices=["cpu"] * n)


def _copy_tree(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    else:
        dst.copy_(torch.from_numpy(np.asarray(src)))


#: (arch, serve config, impl, one layer from layer 0, mesh, batch, cache
#: rows, rules profile): KV heads over 'model' (batch over 'data'); the
#: sequence over 'model' (KV 2 on a model axis of 4); over ('data',
#: 'model') (batch 3 splits over no data axis); KV heads over 'model'
#: with the sequence over 'data'; the fused serve config on a head split
#: and on a sequence split (its B5/B6 route gathers); an MoE under the
#: serve profile; the hybrid and the xLSTM; the shipped row path on a
#: sequence split over 'model' and over ('data', 'model').
CASES = [
    ("qwen3-14b", False, "mpmrf_block", False, (2, 2), 4, 512, "train"),
    ("qwen3-14b", False, "mpmrf_block", False, (1, 4), 2, 512, "train"),
    ("qwen3-14b", False, "mpmrf_block", False, (2, 4), 3, 512, "train"),
    ("qwen3-14b", False, "mpmrf_block", False, (4, 2), 2, 512, "train"),
    ("qwen3-14b", True, None, False, (2, 2), 2, 1024, "train"),
    ("qwen3-14b", True, None, False, (1, 4), 2, 1024, "train"),
    ("olmoe-1b-7b", False, "mpmrf_block", False, (2, 2), 4, 512, "serve"),
    ("zamba2-7b", False, "mpmrf_block", False, (2, 2), 2, 256, "train"),
    ("xlstm-1.3b", False, None, False, (2, 2), 2, 64, "train"),
    ("qwen3-14b", False, "mpmrf_row", True, (1, 4), 2, 512, "train"),
    ("qwen3-14b", False, "mpmrf_row", True, (2, 4), 3, 512, "train"),
]
IDS = [f"{c[0]}-{c[2] or ('serve' if c[1] else 'as-shipped')}"
       f"{'-1layer' if c[3] else ''}-{'x'.join(map(str, c[4]))}"
       for c in CASES]


#: the cases held against the reference's own mesh decode: every one but
#: the row path on ('data', 'model'). There, on the second step, a score
#: of one query row lies 6.6e-8 (relative) from Eq. 3's threshold, the
#: mean over 512 keys: XLA and ATen sum that mean in different orders,
#: so one token flips between the two packages on one device as on the
#: mesh (θ ties, ROADMAP §C). The port's mesh keeps its own single
#: device's selection exactly there, and the row path's parity with the
#: reference on the same scores is ``test_torch_xla_paths.py``'s.
REF_IDS = [cid for cid in IDS if cid != "qwen3-14b-mpmrf_row-1layer-2x4"]


def case_config(arch, serve, impl, one_layer):
    cfg = (registry.get_serve_config(arch, smoke=True) if serve
           else registry.get_smoke_config(arch))
    energon = cfg.energon
    if impl is not None:
        energon = dataclasses.replace(energon, impl=impl)
    if one_layer:
        energon = dataclasses.replace(energon, min_prune_layer=0)
        cfg = dataclasses.replace(cfg, num_layers=1)
    return dataclasses.replace(cfg, energon=energon)


REFERENCE = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import ModelConfig
from repro.core import EnergonConfig
from repro.distributed import sharding as shd
from repro.models import LMModel

out, cases = sys.argv[1], pickle.load(open(sys.argv[2], "rb"))
devs = np.array(jax.devices())
assert devs.size == 8, devs.size


def flat(tree, prefix):
    return {prefix + "/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


for name, (cfg, grid, batch, rows, profile, prefill, prefill_len,
           steps) in cases.items():
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["energon"] = EnergonConfig(**dataclasses.asdict(cfg.energon))
    model = LMModel(ModelConfig(**fields))
    rng = np.random.default_rng(1)
    hi = cfg.vocab_size - 1
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    cache = model.init_cache(batch, rows)
    ci = np.zeros(batch, np.int32)
    if prefill:
        toks = rng.integers(1, hi, size=(batch, prefill_len)).astype(np.int32)
        _, cache = jax.jit(model.prefill)(params, cache, {"tokens": toks}, ci)
        ci = ci + prefill_len
    else:
        for _ in range(2):
            toks = rng.integers(1, hi, size=(batch, 1)).astype(np.int32)
            _, cache = jax.jit(model.decode_step)(params, cache,
                                                  {"tokens": toks}, ci)
            ci = ci + 1
    arrays = dict(flat(params, "params/"), **flat(cache, "cache/"))
    arrays["ci"] = ci
    n = int(np.prod(grid))
    mesh = Mesh(devs[:n].reshape(grid), ("data", "model"))
    shd.set_active_mesh(mesh)
    shd.set_rules_profile(profile)
    inputs = {"tokens": np.zeros((batch, 1), np.int32)}
    c_sh = shd.cache_shardings(cache, mesh)
    dp = shd.data_axes(mesh)
    rows_dp = int(np.prod([mesh.shape[a] for a in dp]))
    logits_sh = NamedSharding(mesh, P(
        dp if batch % rows_dp == 0 and batch > 1 else None, None, "model"))
    step = jax.jit(model.decode_step, in_shardings=(
        shd.param_shardings(params, mesh), c_sh,
        shd.batch_shardings(inputs, mesh), None),
        out_shardings=(logits_sh, c_sh))
    for s in range(steps):
        toks = rng.integers(1, hi, size=(batch, 1)).astype(np.int32)
        logits, cache = step(params, cache, {"tokens": toks}, ci)
        arrays[f"tokens/{s}"] = toks
        arrays[f"logits/{s}"] = np.asarray(logits)
        ci = ci + 1
    shd.set_active_mesh(None)
    shd.set_rules_profile("train")
    np.savez(os.path.join(out, name + ".npz"), **arrays)
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The reference's subprocess, started as the module begins so that
    the port-only tests run beside it (:func:`reference` waits for it)."""
    out = tmp_path_factory.mktemp("mesh_decode_ref")
    cases = {}
    for cid in REF_IDS:
        arch, serve, impl, one, grid, batch, rows, profile = CASES[
            IDS.index(cid)]
        cfg = case_config(arch, serve, impl, one)
        prefill = LMModel(cfg, device="meta").supports_prefill
        cases[cid] = (cfg, grid, batch, rows, profile, prefill, PREFILL,
                      STEPS)
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REFERENCE), str(out),
             str(out / "cases.pkl")], stdout=subprocess.DEVNULL,
            stderr=err, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(_reference_run):
    """Each reference case's arrays: ``params/…``, ``cache/…`` (the
    state the mesh steps start from), ``ci``, ``tokens/s`` and
    ``logits/s``."""
    proc, out = _reference_run
    proc.wait(timeout=900)
    assert proc.returncode == 0, (out / "stderr.txt").read_text()[-3000:]
    return {cid: dict(np.load(out / f"{cid}.npz")) for cid in REF_IDS}


def _tree(arrays, prefix):
    """The ``prefix``-ed ``/`` paths of an npz as a nested dict."""
    out = {}
    for key, value in arrays.items():
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return out


def _err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize(
    "arch,serve,impl,one_layer,grid,batch,rows,profile", CASES, ids=IDS)
def test_decode_step_over_a_mesh_equals_one_device(
        arch, serve, impl, one_layer, grid, batch, rows, profile):
    """The second witness, the port against itself: three steps after a
    40-token prefill (the recurrent families: two warm-up steps), the
    mesh's logits within 1e-5 of max |logit| of the single-device
    step's, on the same weights and cache."""
    cfg = case_config(arch, serve, impl, one_layer)
    model = LMModel(cfg, device="cpu")
    params = model.init(0)
    gen = torch.Generator().manual_seed(1)
    cache = model.init_cache(batch, rows)
    ci = torch.zeros(batch, dtype=torch.int32)
    warm = 2
    if model.supports_prefill:
        toks = torch.randint(1, cfg.vocab_size - 1, (batch, PREFILL),
                             generator=gen)
        model.prefill(params, cache, {"tokens": toks}, ci)
        ci = ci + PREFILL
        warm = 0
    mesh = cpu_mesh(grid)
    shd.set_rules_profile(profile)
    try:
        sp = shd.shard_tree(params, shd.param_shardings(params, mesh), mesh)
        for step in range(warm + STEPS):
            if step == warm:
                sc = model.shard_cache(cache, mesh)
            toks = torch.randint(1, cfg.vocab_size - 1, (batch, 1),
                                 generator=gen)
            want, _ = model.decode_step(params, cache, {"tokens": toks}, ci)
            if step >= warm:
                got, _ = model.decode_step(sp, sc, {"tokens": toks}, ci,
                                           mesh=mesh)
                got = model.mesh_logits(got)
                assert got.shape == want.shape
                assert _err(got, want) <= TOL, (step, _err(got, want))
            ci = ci + 1
    finally:
        shd.set_rules_profile("train")


def _random_decode(seed, *, batch=3, kv=2, g=4, d=16, n=512, ties=False):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(batch, kv, g, d, generator=gen)
    k = torch.randn(batch, kv, n, d, generator=gen)
    v = torch.randn(batch, kv, n, d, generator=gen)
    if ties:            # whole key blocks repeated: their scores tie
        k[:, :, 256:384] = k[:, :, 0:128]
    cl = torch.tensor([n, n // 2 + 7, 130][:batch], dtype=torch.int32)
    return q, k, v, cl


def _parts(t, count):
    return dict(enumerate(t.chunk(count, dim=-2)))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("count", [2, 4])
def test_split_selection_tables_are_exact(count, ties):
    """Exact: the survivor table each part selects from the all-gathered
    block scores equals the single-device selection's (the stable
    lower-index-first tie rule included)."""
    q, k, _, cl = _random_decode(3, ties=ties)
    cfg = EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0,
                           decode_key_block=64)
    _, _, live, mcfg = _decode_block_plan(cfg, k.shape[-2], cl)
    valid = _decode_valid_mask(q, k.shape[-2], cl, None)
    want = flt.mpmrf_decode_block_select(q, k, mcfg, valid, cl,
                                         live_budget=live)
    got = decode_block_table_parts(
        q, {s: {"k": p} for s, p in _parts(k, count).items()}, count, cl,
        cfg, axes=("model",))
    assert torch.equal(got[0], want.block_indices)
    assert torch.equal(got[1], want.block_valid)


@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("count", [2, 4])
def test_split_row_keep_mask_is_exact(count, window):
    """Exact: the split row path's token keep mask — the parts' ``max
    |k|`` and round score planes all-gathered, Eq. 3 over the whole row
    — equals the whole cache's ``mpmrf_row_select``."""
    q, k, _, cl = _random_decode(5)
    cfg = EnergonConfig(impl="mpmrf_row", pruning_ratio=4.0)
    valid = _decode_valid_mask(q, k.shape[-2], cl, window)
    want = flt.mpmrf_row_select(q, k, cfg.mpmrf("row"), valid).keep_mask
    got = _row_keep_over_parts(
        q, {s: {"k": p} for s, p in _parts(k, count).items()}, count, cl,
        cfg, ("model",), window)
    assert torch.equal(got, want)


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("impl,layer", [("mpmrf_block", 5), ("dense", 5),
                                        ("mpmrf_block", 0),
                                        ("mpmrf_row", 5), ("pallas", 5)])
def test_split_decode_attention_matches_the_whole_cache(impl, layer,
                                                        planes):
    """Within 1e-5 (f32): the split call over 4 parts — the block path's
    partials merged by log-sum-exp, the dense prefix layer's, and the
    fused / row routes over the gathered parts — against
    ``energon_decode_attention`` over the whole cache."""
    q, k, v, cl = _random_decode(4)
    cfg = EnergonConfig(impl=impl, pruning_ratio=4.0,
                           decode_key_block=64, min_prune_layer=2)
    fc = None
    parts = {s: {"k": a, "v": b} for s, (a, b) in enumerate(
        zip(k.chunk(4, -2), v.chunk(4, -2)))}
    if planes:
        from repro_torch.core import quantization as qlib

        codes, scale = qlib.quantize_int16_blocks(k, 64)
        fc = {"codes": codes, "scale": scale}
        for s, (c, sc) in enumerate(zip(codes.chunk(4, -2),
                                        scale.chunk(4, -1))):
            parts[s].update(codes=c, scale=sc)
    want = energon_decode_attention(q, k, v, cl, cfg, layer_index=layer,
                                       filter_cache=fc)
    got = energon_decode_attention_parts(
        q, parts, 4, cl, cfg, axes=("model",),
        k_scale=None if fc is None else fc["scale"], layer_index=layer)
    assert (got - want).abs().max() <= TOL * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pod_serve_2d_moe_equals_one_pod(dtype):
    """Bit for bit: the serve-2-D MoE layer on ``(2, 2, 2)`` — each pod
    summing its own ``(model, data)`` partials — equals the layer on
    ``(1, 2, 2)``."""
    cfg = moe.MoEConfig(num_experts=8, experts_per_token=2, d_model=32,
                        d_ff=16)
    params = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    params = {k: v.to(dtype) if k != "router" else v
              for k, v in params.items()}
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    shd.set_rules_profile("serve")
    try:
        one, m1 = moe.apply_moe_serve_2d(params, x, cfg, cpu_mesh((1, 2, 2)))
        two, m2 = moe.apply_moe_serve_2d(params, x, cfg, cpu_mesh((2, 2, 2)))
    finally:
        shd.set_rules_profile("train")
    assert torch.equal(one, two)
    assert torch.equal(m1["moe_drop_fraction"], m2["moe_drop_fraction"])


def test_a_share_keeps_its_logical_shard_index():
    """Device (1, 1)'s share of a ``(2, 2)`` mesh: one row of one
    device, its vocab shard kept as shard 1 of 2 — the embedding of a
    token it owns is the table's row, of one it does not zero —, and its
    shards are the whole mesh's at that coordinate."""
    cfg = registry.get_smoke_config("qwen3-14b")
    model = LMModel(cfg, device="cpu")
    params = model.init(0)
    mesh = cpu_mesh((2, 2))
    share = mesh.share((1, 1))
    assert share.coord == {"data": 1, "model": 1} and share.share_row == 1
    assert share.rows == ((torch.device("cpu"),),)
    specs = shd.param_shardings(params, mesh)
    sp = shd.share_tree(params, specs, share)
    whole = shd.shard_tree(params, specs, mesh)
    cut = shd.share_of(whole, share)
    for (_, a), (_, b) in zip(shd.sharded_leaves(sp),
                              shd.sharded_leaves(cut)):
        (ka, ta), = a.shards.items()
        (kb, tb), = b.shards.items()
        assert ka == kb and torch.equal(ta, tb)
    view = shd.row_views({"embed": sp["embed"]}, share, [0])[0]
    table = view["embed"]["table"]
    assert isinstance(table, col.Shards)
    assert (table.start, table.total, len(table)) == (1, 2, 1)
    assert col.shards_share(table) == (2, 1)
    per = cfg.vocab_size // 2
    toks = torch.tensor([[per + 3, 2]])
    rows = L.embed_tokens(view["embed"], toks)
    assert torch.equal(rows[0, 0], params["embed"]["table"][per + 3])
    assert torch.equal(rows[0, 1], torch.zeros(cfg.d_model))


# the reference's steps come last: its subprocess runs beside the tests
# above


@pytest.mark.parametrize("cid", REF_IDS)
def test_decode_step_over_a_mesh_equals_the_references(reference, cid):
    """Three steps from the reference's prefilled cache: the port's
    ``decode_step(mesh=)`` logits within 1e-5 of max |logit| of the
    reference's decode under GSPMD on the same mesh, weights, cache and
    tokens."""
    from repro_torch.convert import convert_params

    ref = reference[cid]
    arch, serve, impl, one_layer, grid, batch, rows, profile = CASES[
        IDS.index(cid)]
    cfg = case_config(arch, serve, impl, one_layer)
    model = LMModel(cfg, device="cpu")
    params = convert_params(_tree(ref, "params/"), model)
    cache = model.init_cache(batch, rows)
    _copy_tree(cache, _tree(ref, "cache/"))
    ci = torch.from_numpy(ref["ci"])
    mesh = cpu_mesh(grid)
    shd.set_rules_profile(profile)
    try:
        sp = shd.shard_tree(params, shd.param_shardings(params, mesh), mesh)
        sc = model.shard_cache(cache, mesh)
        for step in range(STEPS):
            toks = torch.from_numpy(ref[f"tokens/{step}"])
            got, _ = model.decode_step(sp, sc, {"tokens": toks}, ci,
                                       mesh=mesh)
            got = model.mesh_logits(got)
            want = torch.from_numpy(ref[f"logits/{step}"])
            assert got.shape == want.shape
            assert _err(got, want) <= TOL, (step, _err(got, want))
            ci = ci + 1
    finally:
        shd.set_rules_profile("train")
