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
* The refusals that stay: a ``pod`` axis or a three-axis mesh,
  ``pipeline.py``, the ``"serve"`` profile's ``_apply_moe_serve_2d``,
  ``launch/dryrun.py --mesh`` and ``launch/train.py --mesh DxMxK``,
  each naming ROADMAP A5b.
"""

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


def test_three_axes_and_pod_are_refused_naming_a5b():
    with pytest.raises(ValueError, match="A5b"):
        Mesh([["cpu"]], ("pod", "data", "model"))
    with pytest.raises(ValueError, match="A5b"):
        Mesh([["cpu"]], ("pod", "model"))
    with pytest.raises(ValueError, match="A5b"):
        make_mesh((2, 2, 2), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="A5b"):
        shd.shard_leaf(torch.zeros(4), (("pod", "data"),), _cpu_mesh(1, 1))


def test_pipeline_is_refused_naming_a5b():
    from repro_torch.distributed import pipeline

    with pytest.raises(NotImplementedError, match="A5b"):
        pipeline.pipeline_forward(lambda p, x: x, None, None, None)
    with pytest.raises(NotImplementedError, match="A5b"):
        pipeline.split_layers_to_stages(None, 4)


def test_serve_profile_moe_is_refused_naming_a5b():
    from repro_torch.models import moe

    cfg = moe.MoEConfig(num_experts=8, experts_per_token=2, d_model=16,
                        d_ff=8)
    params = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 4, 16)
    shd.set_rules_profile("serve")
    try:
        with shd.active_mesh(_cpu_mesh(1, 2)):
            with pytest.raises(NotImplementedError, match="A5b"):
                moe.apply_moe(params, x, cfg)
    finally:
        shd.set_rules_profile("train")


def test_dryrun_and_train_meshes_are_refused_naming_a5b():
    from repro_torch.launch import dryrun, train

    for name in ("single", "multi"):
        with pytest.raises(SystemExit, match="A5b"):
            dryrun.main(["--mesh", name])
    with pytest.raises(SystemExit, match="A5b"):
        train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--mesh", "2x2x2", "--simulate-devices", "8"])
