"""The training half of ``distributed/sharding.py`` against the
reference's rules, on the CPU.

* The specs: the port's ``param_shardings`` (the factored moment's
  ``row`` / ``col`` leaves included), ``batch_pspec`` and ``cache_pspec``
  equal the reference's ``param_pspec`` / ``batch_pspec`` /
  ``cache_pspec`` on every leaf path of all ten archs' smoke configs, on
  ``(1, 1)``, ``(4, 2)`` and ``(2, 4)`` meshes. The reference reads a
  mesh's ``axis_names`` and ``shape`` only, so both get a stub mesh (as
  the reference's own ``test_row_shard_must_be_page_aligned`` does), and
  the ``"serve"`` profile's expert specs too.
* The layout: ``shard_tree`` / ``gather_tree`` round trip bit for bit,
  each shard on its mesh device, replicated shards held once, and each
  device addressing the bytes ``param_shardings`` gives it;
  ``row_views`` hands a data row the ZeRO-gathered weights, model-axis
  shards as tuples.
* Three-axis ``(pod, data, model)`` meshes: the specs on them (the
  batch over ``("pod", "data")``), the grid and its pod-major data rows,
  a dim split over a tuple of axes, a row's ZeRO gather and its
  gradient sum over every pod and data row, and the production meshes
  (``make_production_mesh``) against the reference's.
* ``split_layers_to_stages`` and the ``"serve"`` profile's
  ``apply_moe_serve_2d`` against the reference's on one device (their
  multi-device cases run in ``test_torch_distributed.py``'s subprocess).
* ``launch/dryrun.py --mesh single`` walks one device's share of the
  production mesh; ``launch/train.py --mesh 2x2x2`` trains.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.distributed import sharding as jshd
from repro.models import LMModel as JaxLMModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw as jadamw
from repro_torch.configs import registry
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import LMModel
from repro_torch.optim import AdamWConfig, adamw
from tests._torch_port import jax_model_config

MESH_SHAPES = [(1, 1), (4, 2), (2, 4)]


class StubMesh:
    """What the rules read of a mesh: its axis names and sizes."""

    axis_names = ("data", "model")

    def __init__(self, d, m):
        self.shape = {"data": d, "model": m}


def _ref_specs(tree, fn):
    """The reference's spec of every leaf, keyed by its ``/`` path."""
    out = {}

    def one(path, leaf):
        names = "/".join(str(k.key) for k in path)
        out[names] = tuple(fn(path, leaf))

    jax.tree_util.tree_map_with_path(one, tree)
    return out


def _flat(tree, prefix=""):
    """``/`` path → spec of a port spec tree (tuples are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def trees():
    """Each arch's reference parameter and factored-moment shapes, and
    the port's (on the meta device)."""
    out = {}
    for arch in registry.ARCH_NAMES:
        cfg = registry.get_smoke_config(arch)
        jmodel = JaxLMModel(jax_model_config(cfg))
        jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        jnu = jax.eval_shape(lambda p: jadamw.init(p, JaxAdamWConfig(
            factored_second_moment=True)), jshapes).nu
        meta = LMModel(cfg, device="meta").init()
        nu = adamw.init(meta, AdamWConfig(factored_second_moment=True)).nu
        out[arch] = (jmodel, jshapes, jnu, meta, nu)
    return out


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("profile", ["train", "serve"])
def test_param_specs_equal_the_reference_on_every_arch(trees, shape,
                                                       profile):
    mesh = StubMesh(*shape)
    shd.set_rules_profile(profile)
    jshd.set_rules_profile(profile)
    try:
        for arch, (_, jshapes, jnu, meta, nu) in trees.items():
            for jtree, tree in ((jshapes, meta), (jnu, nu)):
                want = _ref_specs(jtree, lambda p, leaf: jshd.param_pspec(
                    p, leaf, mesh))
                got = _flat(shd.param_shardings(tree, mesh))
                assert got == want, arch
            # every sharded dim divides (the divisibility guard)
            for path, spec in _flat(shd.param_shardings(meta, mesh)).items():
                leaf = dict(adamw.tree_leaves(meta))[path]
                for size, ax in zip(leaf.shape, spec):
                    assert ax is None or size % mesh.shape[ax] == 0
    finally:
        shd.set_rules_profile("train")
        jshd.set_rules_profile("train")


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_batch_and_cache_specs_equal_the_reference(trees, shape):
    mesh = StubMesh(*shape)
    for dims in [(8, 64), (6, 64), (8, 64, 32), (1, 64), ()]:
        leaf = jax.ShapeDtypeStruct(dims, np.float32)
        assert shd.batch_pspec(dims, mesh) == tuple(
            jshd.batch_pspec(leaf, mesh)), dims
    batch = {"inputs": (8, 16), "targets": (8, 16)}
    assert shd.batch_shardings(batch, mesh) == {
        k: ("data", None) for k in batch}
    for arch, (jmodel, *_rest) in trees.items():
        for b, max_len in ((8, 64), (1, 64), (2, 48)):
            jcache = jax.eval_shape(lambda: jmodel.init_cache(b, max_len))
            want = _ref_specs(jcache, lambda p, leaf: jshd.cache_pspec(
                p, leaf, mesh))
            got = {}
            for path, leaf in jax.tree_util.tree_leaves_with_path(jcache):
                names = tuple(str(k.key) for k in path)
                got["/".join(names)] = shd.cache_pspec(names, leaf.shape,
                                                       mesh)
            assert got == want, (arch, b)
    for dims in [(2, 8, 4, 64, 16), (2, 1, 4, 64, 16), (1, 3, 64, 16)]:
        assert shd.kv_cache_pspec(dims, mesh) == tuple(
            jshd.kv_cache_pspec(dims, mesh)), dims


def test_logical_axes_and_data_axes():
    assert shd.logical_axes_for(("blocks", "attn", "wq"), 4) == (
        None, "embed", "heads", None)
    assert shd.logical_axes_for("mlstm/cell/wq", 5) == (
        None, None, "embed", None, None)
    assert shd.logical_axes_for(("blocks", "moe", "w_up", "row"), 3) == (
        None, "experts", "embed")
    assert shd.logical_axes_for(("blocks", "mlp", "w_down", "col"), 2) == (
        None, "embed")
    assert shd.logical_axes_for(("final_norm", "scale"), 1) == (None,)
    assert shd.data_axes(StubMesh(2, 2)) == ("data",)
    # the divisibility guard: 36 heads over 16 stay whole
    assert shd.param_pspec(("blocks", "attn", "wq"), (32, 36, 128),
                           StubMesh(1, 16)) == ("data", None, None)


def _cpu_mesh(d, m):
    return make_mesh((d, m), devices=["cpu"] * (d * m))


def test_shard_and_gather_round_trip_bit_for_bit():
    cfg = registry.get_smoke_config("olmoe-1b-7b")
    model = LMModel(cfg, device="cpu")
    params = model.init(3)
    mesh = _cpu_mesh(2, 4)
    specs = shd.param_shardings(params, mesh)
    placed = shd.shard_tree(params, specs, mesh)
    back = shd.gather_tree(placed)
    for (path, a), (_, b) in zip(adamw.tree_leaves(params),
                                 adamw.tree_leaves(back)):
        assert torch.equal(a, b), path
    up = placed["blocks"]["moe"]["w_up"]          # [L, E, d, f]
    assert up.spec == (None, "model", "data", None)
    assert sorted(up.shards) == [(i, j) for i in range(2) for j in range(4)]
    assert up.shards[(1, 2)].shape == (2, 2, 32, 32)
    assert torch.equal(up.shards[(1, 2)],
                       params["blocks"]["moe"]["w_up"][:, 4:6, 32:])
    table = placed["embed"]["table"]               # vocab over 'model'
    assert table.spec == ("model", None) and sorted(table.shards) == [
        (0, j) for j in range(4)]
    norm = placed["final_norm"]["scale"]           # replicated: held once
    assert list(norm.shards) == [(0, 0)]
    # each device addresses what param_shardings gives it
    got = shd.device_bytes(placed, mesh)
    want = shd.reckoned_bytes(model.param_shapes(), model.param_dtypes(),
                              mesh)
    assert got == [[want] * 4] * 2


def test_row_views_gather_over_data_and_keep_model_shards():
    mesh = _cpu_mesh(2, 2)
    w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    tree = {"mlp": {"w_up": w, "w_down": w.T.contiguous()},
            "norm": {"scale": torch.ones(8)}}
    placed = shd.shard_tree(tree, shd.param_shardings(tree, mesh), mesh)
    assert placed["mlp"]["w_up"].spec == ("data", "model")
    views = shd.row_views(placed, mesh, [0, 1])
    for view in views:
        up = view["mlp"]["w_up"]
        assert isinstance(up, tuple) and len(up) == 2
        assert torch.equal(torch.cat(up, dim=1), w)
        assert torch.equal(view["norm"]["scale"], torch.ones(8))
    whole = shd.row_views(placed, mesh, [1], whole=True)[0]
    assert torch.equal(whole["mlp"]["w_down"], w.T)


class StubPodMesh:
    """A three-axis mesh as the rules read it."""

    axis_names = ("pod", "data", "model")

    def __init__(self, p, d, m):
        self.shape = {"pod": p, "data": d, "model": m}


POD_SHAPES = [(2, 2, 2), (2, 4, 1), (2, 1, 4)]


@pytest.mark.parametrize("shape", POD_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_three_axis_specs_and_layout_equal_the_reference(trees, shape):
    """On ``(pod, data, model)`` meshes: every arch's param specs (ZeRO
    over 'data' alone), the batch specs over ``("pod", "data")`` and the
    cache specs equal the reference's; a port ``Mesh`` with 'pod' holds
    its grid row-major, its data rows pod major, and ``shard_leaf``
    splits a dim over a tuple of axes and gathers it back bit for bit."""
    stub = StubPodMesh(*shape)
    for arch, (jmodel, jshapes, _, meta, _) in trees.items():
        want = _ref_specs(jshapes, lambda p, leaf: jshd.param_pspec(
            p, leaf, stub))
        assert _flat(shd.param_shardings(meta, stub)) == want, arch
        for b in (8, 2):
            jcache = jax.eval_shape(lambda: jmodel.init_cache(b, 64))
            want = _ref_specs(jcache, lambda p, leaf: jshd.cache_pspec(
                p, leaf, stub))
            got = {"/".join(str(k.key) for k in path): shd.cache_pspec(
                tuple(str(k.key) for k in path), leaf.shape, stub)
                for path, leaf in jax.tree_util.tree_leaves_with_path(
                    jcache)}
            assert got == want, (arch, b)
    for dims in [(8, 64), (6, 64), (1, 64)]:
        leaf = jax.ShapeDtypeStruct(dims, np.float32)
        assert shd.batch_pspec(dims, stub) == tuple(
            jshd.batch_pspec(leaf, stub)), dims
    assert shd.data_axes(stub) == jshd.data_axes(stub) == ("pod", "data")
    p, d, m = shape
    mesh = make_mesh(shape, devices=["cpu"] * (p * d * m))
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.shape == {"pod": p, "data": d, "model": m}
    assert len(mesh.devices) == p and len(mesh.devices[0]) == d \
        and len(mesh.devices[0][0]) == m
    assert len(mesh.rows) == p * d and mesh.row_coord(d) == {"pod": 1,
                                                             "data": 0}
    assert mesh.submesh((1, 0)).shape == {"pod": 1, "data": 1, "model": m}
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    leaf = shd.shard_leaf(x, (("pod", "data"), "model" if m <= 4 else None),
                          mesh)
    assert len(leaf.shards) == p * d * (m if m <= 4 else 1)
    assert torch.equal(leaf.shards[(1, 0, 0)],
                       x[d * (8 // (p * d)):(d + 1) * (8 // (p * d)),
                         :4 // m])
    assert torch.equal(shd.gather_leaf(leaf), x)
    with pytest.raises(ValueError, match="ordered subset"):
        Mesh([["cpu"]], ("model", "data"))
    with pytest.raises(ValueError, match="axes"):
        shd.shard_leaf(x, ("pod", None), _cpu_mesh(1, 1))


def test_a_pod_mesh_row_sees_the_data_gather():
    """``row_views`` on a ``(2, 2, 2)`` mesh: each of the four pod × data
    rows gathers the ZeRO shards (held once, on pod 0) whole over
    'data', model shards as tuples; the gather's backward sums every
    row's gradient into the shards, and the global norm of those
    gradients counts no pod replica twice."""
    mesh = make_mesh((2, 2, 2), devices=["cpu"] * 8)
    w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    tree = {"mlp": {"w_up": w}}
    placed = shd.shard_tree(tree, shd.param_shardings(tree, mesh), mesh)
    up = placed["mlp"]["w_up"]
    assert up.spec == ("data", "model")
    assert sorted(up.shards) == [(0, i, j) for i in range(2)
                                 for j in range(2)]
    shards = {k: v.requires_grad_() for k, v in up.shards.items()}
    views = shd.row_views(placed, mesh, [0, 1, 2, 3])
    total = 0
    for r, view in enumerate(views):
        parts = view["mlp"]["w_up"]
        assert torch.equal(torch.cat(parts, dim=1), w)
        total = total + sum(((r + 1) * q).sum() for q in parts)
    total.backward()
    for key, shard in shards.items():
        assert torch.equal(shard.grad, torch.full_like(shard, 10.0)), key
    # AdamW's global norm counts each logical element once, not once a pod
    grads = {"w": up.map(lambda t: t.grad)}
    assert float(adamw.global_norm(grads)) == float(
        torch.full((8, 6), 10.0).norm())
    # 8 × 6 f32 over data 2 × model 2: 48 bytes a device, pod 1's too
    assert shd.device_bytes(placed, mesh) == [[[48] * 2] * 2] * 2


def test_production_meshes_equal_the_reference():
    """``make_production_mesh`` over ``cpu`` × 256 / × 512: the
    reference's axes and shapes (its ``make_mesh_compat`` call, read
    without building a jax mesh), and a host with fewer devices
    refused, never padded."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch.mesh import make_production_mesh

    seen = []
    real = jmesh.make_mesh_compat
    jmesh.make_mesh_compat = lambda shape, axes: seen.append(
        (tuple(shape), tuple(axes)))
    try:
        jmesh.make_production_mesh()
        jmesh.make_production_mesh(multi_pod=True)
    finally:
        jmesh.make_mesh_compat = real
    for multi, (shape, axes) in zip((False, True), seen):
        n = math.prod(shape)
        mesh = make_production_mesh(multi_pod=multi, devices=["cpu"] * n)
        assert mesh.axis_names == axes
        assert tuple(mesh.shape.values()) == shape
        assert len(mesh.rows) == n // 16 and len(mesh.rows[0]) == 16
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            make_production_mesh(multi_pod=multi, devices=["cpu"] * (n - 1))
    assert make_production_mesh(devices=["cpu"] * 512).shape == {
        "data": 16, "model": 16}


def test_split_layers_to_stages_equals_the_reference():
    """``split_layers_to_stages`` on a stacked tree: the reference's
    reshape, leaf for leaf, and its refusal of an L that S does not
    divide."""
    from repro.distributed import pipeline as jpipe
    from repro_torch.distributed import pipeline

    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(8, 3, 2)).astype(np.float32),
            "b": {"scale": rng.normal(size=(8, 5)).astype(np.float32)}}
    want = jpipe.split_layers_to_stages(tree, 4)
    got = pipeline.split_layers_to_stages(
        {"w": torch.from_numpy(tree["w"]),
         "b": {"scale": torch.from_numpy(tree["b"]["scale"])}}, 4)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"]["scale"].numpy(),
                                  np.asarray(want["b"]["scale"]))
    for mod in (jpipe, pipeline):
        with pytest.raises(ValueError, match="not divisible"):
            mod.split_layers_to_stages({"w": tree["w"][:6]} if mod is jpipe
                                       else {"w": torch.zeros(6, 2)}, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_profile_moe_on_one_device_equals_the_reference(dtype):
    """``apply_moe_serve_2d`` on a ``(1, 1)`` mesh against the
    reference's ``_apply_moe_serve_2d`` on its one host device (the
    multi-device cases run in ``test_torch_distributed.py``'s
    subprocess): bf16 bit for bit, f32 within 1e-5."""
    import jax.numpy as jnp

    from repro.launch.mesh import make_mesh_compat
    from repro.models import moe as jmoe
    from repro_torch.models import moe

    cfg = moe.MoEConfig(num_experts=8, experts_per_token=2, d_model=16,
                        d_ff=8)
    jcfg = jmoe.MoEConfig(num_experts=8, experts_per_token=2, d_model=16,
                          d_ff=8)
    rng = np.random.default_rng(3)
    p = {"router": rng.normal(size=(16, 8)) * 0.25,
         "w_up": rng.normal(size=(8, 16, 8)) * 0.25,
         "w_gate": rng.normal(size=(8, 16, 8)) * 0.25,
         "w_down": rng.normal(size=(8, 8, 16)) * 0.35}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 4, 16)).astype(np.float32)
    jp = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(
        dtype) for k, v in p.items()}
    jshd.set_rules_profile("serve")
    try:
        want, jmet = jmoe._apply_moe_serve_2d(
            jp, jnp.asarray(x).astype(dtype), jcfg,
            make_mesh_compat((1, 1), ("data", "model")))
    finally:
        jshd.set_rules_profile("train")
    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v) if k == "router"
          else torch.from_numpy(v).to(tdt) for k, v in p.items()}
    got, met = moe.apply_moe_serve_2d(tp, torch.from_numpy(x).to(tdt), cfg,
                                      _cpu_mesh(1, 1))
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(met["moe_aux_loss"]),
                               float(jmet["moe_aux_loss"]), rtol=1e-6)
    assert float(met["moe_drop_fraction"]) == float(
        jmet["moe_drop_fraction"])


def test_dryrun_mesh_single_writes_the_reference_artifact(tmp_path):
    """The dry run's ``--mesh single``: ``main`` walks one device's share
    of the 16 × 16 production mesh on the meta device and writes the
    reference's artifact keys with ``chips`` 256 and ``mesh`` "single"
    (qwen3-14b's decode_32k, ≈ 10 s), its argument bytes the share's
    reckoning from ``param_pspec`` / ``cache_pspec``."""
    from repro_torch.configs import shapes_for_arch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun

    dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k", "--mesh",
                 "single", "--out", str(tmp_path)])
    with open(tmp_path / "qwen3-14b__decode_32k.json") as f:
        art = json.load(f)
    assert {"arch", "shape", "kind", "mesh", "chips", "compile_seconds",
            "cost_analysis", "memory_analysis", "parsed",
            "model_flops"} <= set(art)
    assert art["mesh"] == "single" and art["chips"] == 256
    assert art["coord"] == {"data": 0, "model": 0}
    assert set(art["parsed"]["collective_bytes_per_chip"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    shape = next(x for x in shapes_for_arch("qwen3-14b")
                 if x.name == "decode_32k")
    assert art["memory_analysis"]["argument_size_in_bytes"] == (
        dryrun.share_argument_bytes(get_config("qwen3-14b"), shape,
                                    dryrun.production_mesh("single")))


def test_the_train_launcher_trains_on_a_pod_mesh(capsys):
    """``--mesh 2x2x2 --simulate-devices 8`` trains a few smoke steps on
    a ``(pod, data, model)`` mesh."""
    from repro_torch.launch import train

    result = train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                         "--mesh", "2x2x2", "--simulate-devices", "8",
                         "--steps", "3", "--seq-len", "16",
                         "--global-batch", "8"])
    assert result["final_step"] == 3
    assert "on a 2x2x2 mesh of cpu: 3 steps" in capsys.readouterr().out
    up = result["params"]["blocks"]["mlp"]["w_up"]
    assert isinstance(up, shd.ShardedLeaf) and up.mesh.shape == {
        "pod": 2, "data": 2, "model": 2}
    with pytest.raises(SystemExit, match="PxDxM"):
        train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--mesh", "2x2x2x2"])
