"""The dry run over a mesh (``launch/dryrun.py --mesh``) on the CPU: a
walk of one device's share (``Mesh.share``) of a mesh of meta devices.

* **Argument bytes.** On ``(2, 2)`` and ``(2, 2, 2)``, for qwen3-14b,
  olmoe-1b-7b and zamba2-7b × train, prefill and decode at smoke sizes,
  each share's argument bytes equal the reference's per-device
  ``memory_analysis.argument_size_in_bytes`` **exactly** (the reference
  lowered once, in a subprocess on 8 host devices, its ``get_config``
  patched to the smoke configs). Decode's batch 2 over the 4 data rows
  of ``(2, 2, 2)`` splits the cache's sequence over 'data'.
* **Conservation.** Every coordinate's share costs the same (FLOPs,
  traffic, collective bytes, temp), and the shares add up exactly to
  the one-controller walk of the whole mesh step in FLOPs and kernel
  launches — on a model axis of 1 (pod / data parallelism) and on the
  ``(2, 2)`` decode of a head-split cache (no matmul replicated over
  'model'). A row's replicated ops (norms, residual adds, a replicated
  leaf's optimizer step) run once per row in the one-controller program
  and once on every device of the row in a share, as in SPMD, so the
  traffic adds up exactly only on the pure data-parallel decode.
* **Priced collectives.** One smoke decoder layer's gathers and sums in
  a share, pinned to a hand count of their operand bytes by type and
  axis.
* **Against GSPMD's program.** The same subprocess hands over the
  reference's parsed per-chip FLOPs and collective bytes by type. Where
  the share lays out every matmul and collective as GSPMD does, they
  agree: olmoe-1b-7b's decode and prefill under the serve profile
  (collective bytes exact), qwen3-14b's on ``(2, 2)`` (its all-reduces
  exact, its all-gathers above GSPMD's by exactly the half of ``wk`` /
  ``wv`` a model shard does not read), FLOPs within a stated bound
  (XLA turns the RMS norms' sums of squares into dots, which the walk
  prices as the elementwise ops they are: exact on the decode cells).
  Everywhere the share must not do less than GSPMD's program. Where
  they cannot agree, and why:

  - every ``train`` cell: GSPMD reduces the ZeRO gradients with
    all-reduces, reshards with all-to-all and collective-permutes, and
    fuses the backward its own way; the share reduce-scatters each
    gathered weight's gradient (FLOPs 1.05× on qwen3-14b, 1.16× on
    olmoe-1b-7b, 1.71× on zamba2-7b);
  - prefill and decode of batch 2 on ``(2, 2, 2)``'s four data rows:
    the batch replicates over the rows (``batch_rows``), so every row
    runs all of it, where GSPMD splits the work another way;
  - zamba2-7b: its recurrent cells run whole on each row (as in
    training), where GSPMD splits the Mamba over 'model' with
    collective-permutes;
  - olmoe-1b-7b's decode on ``(2, 2, 2)``: the per-pod serve-2-D sum
    (the reference's psum counts each pod, ROADMAP §C) beside the cache
    split over 'data'.
* **Heads that do not divide 'model'** (qwen3-14b's smoke config with 6
  heads on ``(2, 4)``, as the production configs' 40 / 36 / 56 / 24
  heads over 16): ``wq`` / ``wo`` replicate over 'model' in both, GSPMD
  pads the heads and splits them, and the share's shard takes its
  ⌈H/M⌉ of them (``sharding.uneven_head_views``). Its prefill FLOPs
  differ from GSPMD's by exactly three hand-counted terms (the norms'
  dots, the LM head GSPMD runs over every position, and GSPMD's K/V
  projection split over the pair of devices that share a KV head) and
  its all-reduces are GSPMD's less that pair's sums; its train step
  stands to GSPMD's as the even heads' does.
* ``--mesh multi`` writes the reference's artifact keys with 512 chips.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.analysis import compute_costs
from repro_torch.configs import ShapeConfig, registry
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LMModel
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.model import _layer_of
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import make_train_step, shard_state

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("qwen3-14b", "olmoe-1b-7b", "zamba2-7b")
#: ``test_torch_dryrun.py``'s smoke cells
SHAPES = {"train": ShapeConfig("train_s", 64, 4, "train"),
          "prefill": ShapeConfig("prefill_s", 64, 2, "prefill"),
          "decode": ShapeConfig("decode_s", 64, 2, "decode")}
MESHES = {"2x2": (2, 2), "2x2x2": (2, 2, 2)}

REFERENCE = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import ShapeConfig
from repro.configs.registry import get_smoke_config
import repro.launch.dryrun as ref

# the import asks XLA for 512 host devices (the production meshes'); the
# backend starts below, on 8
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
# the smoke configs, and qwen3-14b's with 6 heads (uneven over 4)
ref.get_config = lambda arch: (
    dataclasses.replace(get_smoke_config("qwen3-14b"), num_heads=6)
    if arch == "qwen3-14b-h6" else get_smoke_config(arch))
shapes = (ShapeConfig("train_s", 64, 4, "train"),
          ShapeConfig("prefill_s", 64, 2, "prefill"),
          ShapeConfig("decode_s", 64, 2, "decode"))
devs = np.array(jax.devices())
assert devs.size == 8, devs.size
meshes = {"2x2": Mesh(devs[:4].reshape(2, 2), ("data", "model")),
          "2x2x2": Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))}
cells = [(arch, shape, name) for arch in %(archs)r for shape in shapes
         for name in meshes]
meshes["2x4"] = Mesh(devs.reshape(2, 4), ("data", "model"))
cells += [("qwen3-14b-h6", shape, "2x4") for shape in shapes[:2]]
out = {}
for arch, shape, name in cells:
    art = ref.lower_cell(arch, shape, meshes[name], name)
    out[f"{arch}/{shape.kind}/{name}"] = {
        "args": art["memory_analysis"]["argument_size_in_bytes"],
        "flops": art["parsed"]["flops_per_chip"],
        "collectives": art["parsed"]["collective_bytes_per_chip"]}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
""" % {"archs": ARCHS}


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The reference's lowering, started as the module begins so that the
    walks that do not read it run beside it (:func:`reference` waits)."""
    out = tmp_path_factory.mktemp("dryrun_mesh_ref")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REFERENCE),
             str(out / "costs.json")], stdout=subprocess.DEVNULL,
            stderr=err, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(_reference_run):
    """The reference's per-device ``args`` (argument bytes), ``flops``
    and ``collectives`` (bytes by type) of each cell
    ``arch/kind/mesh``."""
    proc, out = _reference_run
    proc.wait(timeout=900)
    assert proc.returncode == 0, (out / "stderr.txt").read_text()[-3000:]
    with open(out / "costs.json") as f:
        return json.load(f)


def meta_mesh(shape):
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, devices=["meta"] * n)


def _whole_walk(cfg, shape, mesh):
    """The one-controller walk of the whole mesh step (every row and
    shard) on meta devices, under the cell's rules profile."""
    model = LMModel(cfg, device="meta")
    prev = shd.get_rules_profile()
    shd.set_rules_profile(dryrun.rules_profile(cfg, shape))
    try:
        params = model.init()
        batch = dryrun.input_specs(cfg, shape, "meta")
        if shape.kind == "train":
            opt_cfg = dryrun.optimizer_config(cfg)
            sp, so = shard_state(params, adamw.init(params, opt_cfg), mesh)
            step = make_train_step(
                model, opt_cfg, mesh=mesh,
                num_microbatches=dryrun.microbatches_for(
                    cfg.name, mesh, shape.global_batch))
            return compute_costs(step, sp, so, batch)
        sp = shd.shard_tree(params, shd.param_shardings(params, mesh), mesh)
        if shape.kind == "prefill":
            return compute_costs(
                lambda p, b: model._mesh_forward(p, b, mesh,
                                                 last_only=True)[1],
                sp, batch)
        cache = model.shard_cache(
            model.init_cache(shape.global_batch, shape.seq_len), mesh)
        ci = torch.zeros(shape.global_batch, dtype=torch.int32,
                         device="meta")
        return compute_costs(
            lambda p, c, b, i: model.decode_step(p, c, b, i, mesh=mesh),
            sp, cache, batch, ci)
    finally:
        shd.set_rules_profile(prev)


#: (arch, serve config, shape, mesh, traffic adds up too)
CONSERVED = [
    ("qwen3-14b", False, SHAPES["train"], (2, 1), False),
    ("qwen3-14b", False, SHAPES["train"], (2, 2, 1), False),
    ("qwen3-14b", False, SHAPES["prefill"], (2, 1), False),
    ("qwen3-14b", False, SHAPES["decode"], (2, 1), True),
    ("qwen3-14b", True, ShapeConfig("decode_l", 1024, 2, "decode"), (2, 2),
     False),
    ("zamba2-7b", False, SHAPES["train"], (2, 2, 1), False),
    ("zamba2-7b", False, SHAPES["decode"], (2, 1), False),
]


@pytest.mark.parametrize("arch,serve,shape,grid,traffic", CONSERVED)
def test_shares_add_up_to_the_whole_mesh_walk(arch, serve, shape, grid,
                                              traffic):
    """Exact: Σ over every coordinate of the share's FLOPs and kernel
    launches = the whole mesh step's (and its traffic where ``traffic``);
    every share's FLOPs, traffic, collective bytes and temp equal."""
    cfg = (registry.get_serve_config(arch, smoke=True) if serve
           else registry.get_smoke_config(arch))
    mesh = meta_mesh(grid)
    whole = _whole_walk(cfg, shape, mesh)
    arts = [dryrun.lower_cell(arch, shape, mesh=mesh, coord=c, cfg=cfg)
            for c in mesh.coords()]
    per = {(a["parsed"]["flops_per_chip"], a["parsed"]["traffic_bytes_per_chip"],
            json.dumps(a["parsed"]["collective_bytes_per_chip"],
                       sort_keys=True),
            a["memory_analysis"]["temp_size_in_bytes"]) for a in arts}
    assert len(per) == 1
    assert sum(a["parsed"]["flops_per_chip"] for a in arts) == whole.flops
    launches = {}
    for a in arts:
        for k, v in a["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
    assert launches == whole.launches
    if serve:
        assert launches["decode_gather_attention"] == (
            4 * (cfg.num_layers - cfg.energon.min_prune_layer))
    if traffic:
        assert sum(a["parsed"]["traffic_bytes_per_chip"]
                   for a in arts) == whole.traffic_bytes


def test_priced_collectives_of_one_smoke_layer():
    """Exact hand count: device (0, 0) of a ``(2, 2)`` mesh runs one
    smoke decoder layer's attention and MLP (qwen3-14b smoke: d 128, 8
    heads, 2 KV heads, head dim 16, d_ff 256, f32; the train rules) over
    a row of 2 × 16 tokens. Its ZeRO gathers over 'data' send the local
    shards of ``wq`` [64, 4, 16], ``wk`` / ``wv`` [64, 2, 16], ``wo``
    [4, 16, 64], ``w_up`` / ``w_gate`` [64, 128] and ``w_down`` [128, 64]
    — (4096 + 2·2048 + 4096 + 3·8192) · 4 = 147456 bytes; its sums over
    'model' the attention's and the MLP's row-parallel partials, [2, 16,
    128] f32 each: 2 · 16384 = 32768 bytes. The norms' scales and the
    activations it broadcasts cost nothing."""
    cfg = registry.get_smoke_config("qwen3-14b")
    mesh = meta_mesh((2, 2))
    share = mesh.share((0, 0))
    model = LMModel(cfg, device="meta")
    params = model.init()
    sp = shd.share_tree(params, shd.param_shardings(params, mesh), share)
    layer = _layer_of(sp["blocks"], (0,))
    x = torch.empty(2, 16, cfg.d_model, device="meta")
    kw = model._attn_kwargs(0, None)

    def one_layer(layer, x):
        view = shd.row_views(layer, share, [0])[0]
        h = attn_lib.attention_block(view["attn"], x, cfg.energon, **kw)
        return L.apply_mlp(view["mlp"], h, cfg.activation)

    costs = compute_costs(one_layer, layer, x)
    assert costs.collective_bytes == {"all-gather": 147456.0,
                                      "all-reduce": 32768.0}
    assert costs.collective_bytes_by_axis == {"data": 147456.0,
                                              "model": 32768.0}


def test_collectives_price_by_the_reference_rule():
    """Exact: a share's all-gather of a [4, 8] f32 part over 'data' (2)
    counts its operand, 128 bytes, and its backward's reduce-scatter the
    gathered gradient's 256; the int8 gather 32 codes + 8 f32 scales (64
    bytes; its backward the f32 reduce-scatter, 256); an all-reduce of a
    [3, 5] f32 partial 60; a broadcast nothing forward and its
    gradient's all-reduce (128) backward. On the whole mesh an all-gather
    of two parts onto two devices counts both devices' operands."""
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    share = mesh.share((1, 0))
    part = torch.ones(4, 8, requires_grad=True)

    data, model = (dict(axes=(a,), share=col.share_of(share, (a,)))
                   for a in ("data", "model"))
    assert data["share"] == (2, 1) and model["share"] == (2, 0)

    def in_share(p):
        dev = [share.first_device]
        g = col.all_gather([p], 0, dev, **data)[0]
        q = col.quantized_all_gather([p], 0, dev, **data)[0]
        r = col.all_reduce([torch.ones(3, 5)], **model)
        b = col.broadcast(p, dev, **data)[0]
        assert g.shape == q.shape == (8, 8)
        return (g.sum() + q.sum() + r.sum() + b.sum()).backward()

    costs = compute_costs(in_share, part)
    assert costs.collective_bytes == {"all-gather": 128.0 + 64.0,
                                      "all-reduce": 60.0 + 128.0,
                                      "reduce-scatter": 256.0 + 256.0}
    parts = [torch.ones(4, 8, requires_grad=True) for _ in range(2)]
    whole = compute_costs(lambda: col.all_gather(
        parts, 0, mesh.rows[0][:1] + mesh.rows[1][:1], axes=("data",)))
    assert whole.collective_bytes == {"all-gather": 256.0}


def test_multi_pod_artifact_and_an_moe_inference_cell(tmp_path):
    """``--mesh multi`` writes the reference's keys with ``chips`` 512
    and the pod axis in the coordinate; a multi-pod MoE decode cell
    lowers under the serve profile (olmoe's smoke config on the
    production mesh's shape)."""
    cfg = registry.get_smoke_config("olmoe-1b-7b")
    art = dryrun.lower_cell("olmoe-1b-7b", SHAPES["decode"],
                            mesh=dryrun.production_mesh("multi"),
                            mesh_name="multi", cfg=cfg)
    assert art["chips"] == 512 and art["mesh"] == "multi"
    assert art["rules_profile"] == "serve"
    assert art["coord"] == {"pod": 0, "data": 0, "model": 0}
    assert art["fits"]["fits"]
    assert set(art["collective_bytes_by_axis"]) <= {
        "data", "model", "pod", "pod+data", "data+model", "model+data"}


# the tests that read the reference's lowering come last: its subprocess
# runs beside the tests above


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_share_argument_bytes_equal_the_references(reference, arch, kind,
                                                   mesh_name):
    """Exact: the share's shards of the parameters, AdamW state, cache
    and the batch leaves the step reads, device (0, …, 0)'s, against the
    reference's compiled per-device argument size."""
    cfg = registry.get_smoke_config(arch)
    got = dryrun.share_argument_bytes(cfg, SHAPES[kind],
                                      meta_mesh(MESHES[mesh_name]))
    assert got == reference[f"{arch}/{kind}/{mesh_name}"]["args"]


@functools.lru_cache(maxsize=None)
def _share_costs(arch, kind, mesh_name):
    """Device (0, …)'s share of a smoke cell: its parsed costs."""
    art = dryrun.lower_cell(arch, SHAPES[kind],
                            cfg=registry.get_smoke_config(arch),
                            mesh=meta_mesh(MESHES[mesh_name]))
    return art["parsed"]


def _hand_norm_dots(cfg, tokens, q_heads, kv_heads):
    """The FLOPs of the dots XLA makes of a decoder's RMS norms (each a
    sum of squares, 2 FLOPs an element): two d-wide norms and the q / k
    norms of a shard's heads each layer, the final norm, per token."""
    per_layer = 2 * 2 * cfg.d_model + 2 * cfg.head_dim * (q_heads + kv_heads)
    return tokens * (cfg.num_layers * per_layer + 2 * cfg.d_model)


#: (arch, kind, mesh, FLOPs bound): the cells whose layouts agree
AGREE = [
    ("olmoe-1b-7b", "decode", "2x2", 0.0),
    ("olmoe-1b-7b", "prefill", "2x2", 0.01),
    ("olmoe-1b-7b", "prefill", "2x2x2", 0.01),
    ("qwen3-14b", "decode", "2x2", 0.0),
    ("qwen3-14b", "prefill", "2x2", 0.02),
]


@pytest.mark.parametrize("arch,kind,mesh_name,bound", AGREE)
def test_share_costs_equal_gspmds_where_the_layouts_agree(
        reference, arch, kind, mesh_name, bound):
    """Per chip, the share against the reference's compiled program.
    Collective bytes by type: olmoe-1b-7b's exact; qwen3-14b's
    all-reduces exact and its all-gathers above GSPMD's by exactly the
    half of ``wk`` and ``wv`` a model shard does not read (the share
    gathers them whole over 'data' and projects its KV heads; GSPMD
    gathers each shard's half): layers · (d / D) · KV · hd · 4 bytes.
    FLOPs: the reference's exceed the share's by its RMS norms' dots —
    on the decode cells (one token a row, a shard's 4 / 2 query heads and
    2 / 1 KV heads) exactly the hand count, 896 and 2272; on the prefill
    cells by at most ``bound`` of its FLOPs (there XLA fuses some of the
    norms' squares before it forms dots)."""
    cfg = registry.get_smoke_config(arch)
    want = reference[f"{arch}/{kind}/{mesh_name}"]
    got = _share_costs(arch, kind, mesh_name)
    coll = dict(got["collective_bytes_per_chip"])
    if arch == "qwen3-14b":
        d_rows = MESHES[mesh_name][-2]
        coll["all-gather"] -= (cfg.num_layers * (cfg.d_model // d_rows)
                               * cfg.num_kv_heads * cfg.head_dim * 4)
    assert coll == want["collectives"]
    gap = want["flops"] - got["flops_per_chip"]
    if kind == "decode":
        m = MESHES[mesh_name][-1]
        assert gap == _hand_norm_dots(cfg, 1, cfg.num_heads // m,
                                      cfg.num_kv_heads // m)
    else:
        assert 0 <= gap <= bound * want["flops"]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_share_does_no_less_than_gspmd(reference, arch, kind, mesh_name):
    """Every smoke cell, laid out alike or not: the share's FLOPs at
    least GSPMD's less 2 % (the norms' dots), so the walk misses no
    matmul of the reference's program."""
    want = reference[f"{arch}/{kind}/{mesh_name}"]["flops"]
    got = _share_costs(arch, kind, mesh_name)["flops_per_chip"]
    assert got >= 0.98 * want


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_uneven_heads_share_runs_what_gspmd_splits(reference, kind):
    """qwen3-14b's smoke config with 6 heads (2 KV heads) on ``(2, 4)``:
    its argument bytes equal the reference's (``wq`` / ``wo`` replicate
    over 'model' in both), and device (0, 0) attends over its ⌈6/4⌉ = 2
    heads, as GSPMD's padded split does.

    Prefill, exact: GSPMD's FLOPs less the share's are its RMS norms'
    dots (two d-wide norms a layer, 2 query and 1 KV head of q / k
    norms, the final norm) plus its LM head over the other n − 1
    positions (the share takes the last alone), less GSPMD's saving on
    K/V: it splits the projection of the device's KV head over the two
    model devices that read it (half of d each), where the share
    projects it whole. Those two devices' sums of their K / V halves
    are the reference's all-reduces beyond the share's.

    Train: the share stands to GSPMD's program in FLOPs as the even
    heads' cell does (``qwen3-14b/train/2x2``: GSPMD fuses the backward
    its own way, 1.05×) or closer, and its all-reduces are no more than
    GSPMD's (which reduces the ZeRO gradients with all-reduces where the
    share reduce-scatters them)."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen3-14b"),
                              num_heads=6)
    want = reference[f"qwen3-14b-h6/{kind}/2x4"]
    assert dryrun.share_argument_bytes(cfg, SHAPES[kind],
                                       meta_mesh((2, 4))) == want["args"]
    got = dryrun.lower_cell("qwen3-14b", SHAPES[kind], cfg=cfg,
                            mesh=meta_mesh((2, 4)))["parsed"]
    all_reduce = got["collective_bytes_per_chip"]["all-reduce"]
    if kind == "prefill":
        n, m, d = SHAPES[kind].seq_len, 4, cfg.d_model
        head = (n - 1) * 2 * d * cfg.vocab_size // m
        kv_split = cfg.num_layers * 2 * 2 * n * (d // 2) * cfg.head_dim
        assert want["flops"] - got["flops_per_chip"] == (
            _hand_norm_dots(cfg, n, 2, 1) + head - kv_split)
        kv_sums = cfg.num_layers * 2 * n * cfg.head_dim * 4
        assert all_reduce + kv_sums == want["collectives"]["all-reduce"]
    else:
        even = _share_costs("qwen3-14b", "train", "2x2")["flops_per_chip"]
        bound = even / reference["qwen3-14b/train/2x2"]["flops"]
        assert 1.0 <= got["flops_per_chip"] / want["flops"] <= bound
        assert all_reduce <= want["collectives"]["all-reduce"]
