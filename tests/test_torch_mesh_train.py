"""Training over a ``(data, model)`` mesh on the CPU (``cpu`` × 8
simulates the devices), against the reference's sharded runs.

The reference runs once, in a module-scoped subprocess under eight
host devices (``--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` does), and hands its arrays over as
``.npz`` files:

* phi3-mini-3.8b's smoke config (``mpmrf_row`` at ρ = 1): the jitted
  loss and gradients with ``param_shardings`` / ``batch_shardings`` on a
  ``(4, 2)`` mesh. The port's mesh loss and gradients (ZeRO over 'data',
  heads / MLP columns / vocabulary over 'model') equal them, and its
  one-device loss too;
* qwen3-14b's smoke config with 6 query heads on ``(2, 4)``, heads
  that do not divide 'model' (``mpmrf_row`` at ρ = 1): GSPMD pads them
  and splits their compute; the port's shard j takes heads ``[2j,
  min(2j + 2, 6))`` of the replicated ``wq`` / ``wo`` (shard 3 none),
  and its mesh loss and gradients equal the reference's;
* the MoE layer of ``test_sharded_moe_equals_reference`` on ``(2, 4)``
  (capacity factor 8, and 1.25 where assignments drop): the port's
  ``apply_moe_sharded`` with a data axis equals the reference's output,
  aux loss and drop fraction;
* one train step of olmoe-1b-7b's smoke config on ``(2, 4)`` through
  ``make_train_step(mesh=…)``, with and without
  ``quantized_weight_gather``: loss, gradient norm and the updated
  parameters;
* phi3's and olmoe's (exact and int8 gathers) loss and gradients on a
  ``(pod, data, model)`` = ``(2, 2, 2)`` mesh, the same params and
  batches: the batch over the four pod × data rows, ZeRO over 'data'
  alone, every row's gradient summed;
* ``_quantized_all_gather`` over 'data' (f32 and bf16, either gather
  axis): the port's int8 gather equals it bit for bit, so its codes and
  scales are the reference's.

Every other family trains on a mesh with the port's one-device loss and
gradients (vlm / audio through their embeddings input, gemma3's tied
head and windows, starcoder2's LayerNorm, qwen3's KV heads fewer than
the model axis, xlstm-1.3b's and zamba2-7b's recurrent cells), and a
mesh train step with microbatches and the factored second moment equals
the one-device step.

Tolerances: losses at rtol 1e-5, gradients at ``test_torch_train.py``'s
rtol 1e-4 with atol 1e-6 × the leaf's largest |gradient| (the same f32
graph summed in other orders); zamba2's one-device comparison at the
log-sigmoid tolerance of that file (rtol 1e-3, atol 1e-4 × the largest).
A step's params as in ``test_torch_train_loop.py``: within 2e-5 on all
but 0.1 % of each leaf's elements, every one within 2·lr.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.convert import convert_params
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LMModel
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime.train_loop import (
    gather_state, make_train_step, shard_state,
)
from tests._torch_port import t
from tests.test_torch_train import GRAD_TOL, LOG_SIGMOID_TOL, _batch, _rho1
from tests.test_torch_train_loop import _check_close

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LR = 1e-3
MOE_LAYER = dict(num_experts=8, experts_per_token=2, d_model=32, d_ff=16)

REFERENCE = """
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import shard_map_unchecked as shard_map
from jax.sharding import PartitionSpec as P
from repro.configs.registry import get_smoke_config
from repro.distributed import sharding as shd
from repro.launch.mesh import make_mesh_compat
from repro.models import LMModel, moe as M
from repro.optim import adamw
from repro.runtime import make_train_step

out = sys.argv[1]


def flat(tree, prefix):
    return {prefix + "/".join(str(k.key) for k in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def rho1(cfg, **kw):
    return dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, pruning_ratio=1.0), **kw)


def batch(cfg, b, n, seed):
    rng = np.random.default_rng(seed)
    hi = min(cfg.vocab_size, 255)
    return {k: rng.integers(1, hi, size=(b, n)).astype(np.int32)
            for k in ("inputs", "targets")}


# phi3's smoke config: the jitted loss and gradients on a (4, 2) mesh
cfg = rho1(get_smoke_config("phi3-mini-3.8b"))
model = LMModel(cfg)
params = jax.jit(model.init)(jax.random.PRNGKey(0))
b = batch(cfg, 8, 64, 0)
loss_fn = lambda p, bb: model.loss(p, bb)[0]
single = jax.jit(loss_fn)(params, b)
mesh = make_mesh_compat((4, 2), ("data", "model"))
shd.set_active_mesh(mesh)
p_sh, b_sh = shd.param_shardings(params, mesh), shd.batch_shardings(b, mesh)
loss, grads = jax.jit(jax.value_and_grad(loss_fn),
                      in_shardings=(p_sh, b_sh))(
    jax.device_put(params, p_sh), jax.device_put(b, b_sh))
shd.set_active_mesh(None)
# the same loss and gradients on a (pod, data, model) = (2, 2, 2) mesh
pod_mesh = make_mesh_compat((2, 2, 2), ("pod", "data", "model"))


def pod_grads(loss_fn, params, b):
    shd.set_active_mesh(pod_mesh)
    p_sh = shd.param_shardings(params, pod_mesh)
    b_sh = shd.batch_shardings(b, pod_mesh)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn),
                          in_shardings=(p_sh, b_sh))(
        jax.device_put(params, p_sh), jax.device_put(b, b_sh))
    shd.set_active_mesh(None)
    return {"pod_loss": np.asarray(loss), **flat(grads, "pod_grads/")}


np.savez(os.path.join(out, "phi3.npz"), loss=np.asarray(loss),
         single=np.asarray(single), **flat(params, "params/"),
         **flat(grads, "grads/"), **{"batch/" + k: v for k, v in b.items()},
         **pod_grads(loss_fn, params, b))

# the MoE layer on (2, 4)
mesh = make_mesh_compat((2, 4), ("data", "model"))

# qwen3-14b's smoke config with 6 query heads (uneven over 4): the jitted
# loss and gradients on (2, 4), GSPMD padding and splitting the heads
cfg = rho1(dataclasses.replace(get_smoke_config("qwen3-14b"), num_heads=6))
model = LMModel(cfg)
params = jax.jit(model.init)(jax.random.PRNGKey(0))
b = batch(cfg, 8, 32, 3)
loss_fn = lambda p, bb: model.loss(p, bb)[0]
shd.set_active_mesh(mesh)
p_sh, b_sh = shd.param_shardings(params, mesh), shd.batch_shardings(b, mesh)
loss, grads = jax.jit(jax.value_and_grad(loss_fn),
                      in_shardings=(p_sh, b_sh))(
    jax.device_put(params, p_sh), jax.device_put(b, b_sh))
shd.set_active_mesh(None)
np.savez(os.path.join(out, "qwen3_h6.npz"), loss=np.asarray(loss),
         **flat(params, "params/"), **flat(grads, "grads/"),
         **{"batch/" + k: v for k, v in b.items()})
arrays = {}
for cap in (8.0, 1.25):
    mcfg = M.MoEConfig(num_experts=8, experts_per_token=2, d_model=32,
                       d_ff=16, capacity_factor=cap)
    p = M.init_moe(jax.random.PRNGKey(0), mcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32))
    shd.set_active_mesh(mesh)
    o, met = jax.jit(lambda p, x: M.apply_moe(p, x, mcfg))(p, x)
    shd.set_active_mesh(None)
    arrays.update({f"{cap}/out": np.asarray(o), f"{cap}/x": np.asarray(x),
                   f"{cap}/aux": np.asarray(met["moe_aux_loss"]),
                   f"{cap}/drop": np.asarray(met["moe_drop_fraction"]),
                   **flat(p, f"{cap}/p/")})
np.savez(os.path.join(out, "moe.npz"), **arrays)

# one olmoe train step on (2, 4), the int8 expert gathers off and on
for q in (False, True):
    cfg = rho1(get_smoke_config("olmoe-1b-7b"), moe_quantized_gather=q)
    model = LMModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    opt = adamw.AdamWConfig(learning_rate=%(lr)r)
    state = adamw.init(params, opt)
    b = batch(cfg, 8, 32, 1)
    shd.set_active_mesh(mesh)
    step = make_train_step(model, opt, mesh=mesh, donate=False)
    new, _, m = step(params, state,
                     jax.device_put(b, shd.batch_shardings(b, mesh)))
    shd.set_active_mesh(None)
    np.savez(os.path.join(out, f"olmoe_q{int(q)}.npz"),
             loss=np.asarray(m["loss"]), grad_norm=np.asarray(m["grad_norm"]),
             **flat(params, "params/"), **flat(new, "new/"),
             **{"batch/" + k: v for k, v in b.items()},
             **pod_grads(lambda p, bb: model.loss(p, bb)[0], params, b))

# _quantized_all_gather over 'data'
arrays = {}
for dt in ("float32", "bfloat16"):
    w = jax.random.normal(jax.random.PRNGKey(2), (4, 64, 16)).astype(dt)
    for axis in (1, 2):
        spec = P(None, "data", None) if axis == 1 else P(None, None, "data")
        g = shard_map(lambda w: M._quantized_all_gather(w, "data", axis),
                      mesh=mesh, in_specs=spec, out_specs=P())(w)
        arrays[f"{dt}/{axis}/w"] = np.asarray(w.astype(jnp.float32))
        arrays[f"{dt}/{axis}/g"] = np.asarray(g.astype(jnp.float32))
np.savez(os.path.join(out, "qag.npz"), **arrays)
print("done")
""" % {"lr": LR}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          str(out)], capture_output=True, text=True, env=env,
                         timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    return {name[:-4]: dict(np.load(out / name)) for name in os.listdir(out)}


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


def cpu_mesh(d, m):
    return make_mesh((d, m), devices=["cpu"] * (d * m))


def _grads(model, params, batch, mesh=None):
    def loss_fn(p, b):
        return model.loss(p, b, mesh=mesh)

    loss, grads, _ = adamw.accumulate_gradients(
        loss_fn, params, {k: t(v) for k, v in batch.items()}, 1)
    return loss, shd.gather_tree(grads)


def _assert_grads_close(got, want, tol=GRAD_TOL):
    rtol, share = tol
    got, want = dict(adamw.tree_leaves(got)), dict(want)
    assert sorted(got) == sorted(want)
    for path, g in want.items():
        np.testing.assert_allclose(
            got[path].numpy(), g, rtol=rtol,
            atol=share * float(np.abs(g).max()) + 1e-30, err_msg=path)


def test_dense_mesh_loss_and_grads_equal_the_reference_mesh_step(ref):
    arrays = ref["phi3"]
    model = LMModel(_rho1(registry.get_smoke_config("phi3-mini-3.8b")),
                    device="cpu")
    params = convert_params(_tree(arrays, "params/"), model)
    batch = _tree(arrays, "batch/")
    mesh = cpu_mesh(4, 2)
    placed = shd.shard_tree(params, shd.param_shardings(params, mesh), mesh)
    loss, grads = _grads(model, placed, batch, mesh)
    np.testing.assert_allclose(float(loss), float(arrays["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(arrays["loss"]), float(arrays["single"]),
                               rtol=1e-5)
    single, _ = model.loss(params, {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(single), rtol=1e-5)
    # the mesh's logits, gathered, are the one device's
    inputs = {"inputs": t(batch["inputs"])}
    np.testing.assert_allclose(model.apply(placed, inputs, mesh)[0].numpy(),
                               model.apply(params, inputs)[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    want = {k[len("grads/"):]: v for k, v in arrays.items()
            if k.startswith("grads/")}
    _assert_grads_close(grads, want)


def test_uneven_heads_mesh_loss_and_grads_equal_the_reference(
        ref, monkeypatch):
    """6 heads over a model axis of 4: each shard attends over at most
    ⌈6/4⌉ = 2 heads (the fourth over none), and the loss and gradients
    equal GSPMD's padded split."""
    arrays = ref["qwen3_h6"]
    cfg = _rho1(dataclasses.replace(registry.get_smoke_config("qwen3-14b"),
                                    num_heads=6))
    model = LMModel(cfg, device="cpu")
    params = convert_params(_tree(arrays, "params/"), model)
    batch = _tree(arrays, "batch/")
    mesh = cpu_mesh(2, 4)
    placed = shd.shard_tree(params, shd.param_shardings(params, mesh), mesh)
    heads = []
    real = attn_lib.energon_attention

    def counted(q, *args, **kwargs):
        heads.append(q.shape[1])
        return real(q, *args, **kwargs)

    monkeypatch.setattr(attn_lib, "energon_attention", counted)
    loss, grads = _grads(model, placed, batch, mesh)
    # per layer and data row, shards 0–2 attend over two heads each
    assert heads == [2] * (3 * cfg.num_layers * 2)
    np.testing.assert_allclose(float(loss), float(arrays["loss"]), rtol=1e-5)
    want = {k[len("grads/"):]: v for k, v in arrays.items()
            if k.startswith("grads/")}
    _assert_grads_close(grads, want)


def pod_mesh():
    return make_mesh((2, 2, 2), devices=["cpu"] * 8)


@pytest.mark.parametrize("case", ["phi3", "olmoe_q0", "olmoe_q1"],
                         ids=["phi3", "olmoe-exact", "olmoe-int8"])
def test_pod_mesh_loss_and_grads_equal_the_reference(ref, case):
    """phi3 and olmoe (exact and int8 expert gathers) on a ``(pod, data,
    model)`` = ``(2, 2, 2)`` mesh: the batch over the four pod × data
    rows (pod major), ZeRO over 'data' alone, each weight's gradient the
    sum of every row's; loss and gradients the reference's."""
    arrays = ref[case]
    arch = "phi3-mini-3.8b" if case == "phi3" else "olmoe-1b-7b"
    cfg = _rho1(registry.get_smoke_config(arch))
    if case != "phi3":
        cfg = dataclasses.replace(cfg,
                                  moe_quantized_gather=case == "olmoe_q1")
    model = LMModel(cfg, device="cpu")
    params = convert_params(_tree(arrays, "params/"), model)
    mesh = pod_mesh()
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    placed = shd.shard_tree(params, shd.param_shardings(params, mesh), mesh)
    loss, grads = _grads(model, placed, _tree(arrays, "batch/"), mesh)
    np.testing.assert_allclose(float(loss), float(arrays["pod_loss"]),
                               rtol=1e-5)
    want = {k[len("pod_grads/"):]: v for k, v in arrays.items()
            if k.startswith("pod_grads/")}
    _assert_grads_close(grads, want)


@pytest.mark.parametrize("cap", [8.0, 1.25])
def test_moe_layer_with_a_data_axis_equals_the_reference(ref, cap):
    arrays = ref["moe"]
    cfg = moe.MoEConfig(capacity_factor=cap, **MOE_LAYER)
    params = {k: t(v) for k, v in _tree(arrays, f"{cap}/p/").items()}
    out, met = moe.apply_moe_sharded(params, t(arrays[f"{cap}/x"]), cfg,
                                     cpu_mesh(2, 4))
    assert float((out - t(arrays[f"{cap}/out"])).abs().max()) < 1e-5
    np.testing.assert_allclose(float(met["moe_aux_loss"]),
                               float(arrays[f"{cap}/aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["moe_drop_fraction"]),
                               float(arrays[f"{cap}/drop"]), rtol=1e-6)
    if cap == 1.25:        # each data row's own capacity drops assignments
        assert float(met["moe_drop_fraction"]) > 0


@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int8"])
def test_moe_mesh_train_step_equals_the_reference(ref, quantized):
    arrays = ref[f"olmoe_q{int(quantized)}"]
    cfg = dataclasses.replace(
        _rho1(registry.get_smoke_config("olmoe-1b-7b")),
        moe_quantized_gather=quantized)
    model = LMModel(cfg, device="cpu")
    opt = AdamWConfig(learning_rate=LR)
    params = convert_params(_tree(arrays, "params/"), model)
    mesh = cpu_mesh(2, 4)
    placed, state = shard_state(params, adamw.init(params, opt), mesh)
    step = make_train_step(model, opt, mesh=mesh)
    placed, state, m = step(placed, state, _tree(arrays, "batch/"))
    np.testing.assert_allclose(float(m["loss"]), float(arrays["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(arrays["grad_norm"]), rtol=1e-4)
    new, _ = gather_state(placed, state)
    _check_close(new, _tree(arrays, "new/"), atol=2e-5, bound=2 * LR)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [1, 2])
def test_int8_gather_equals_the_reference_bit_for_bit(ref, dtype, axis):
    arrays = ref["qag"]
    w = t(arrays[f"{dtype}/{axis}/w"]).to(getattr(torch, dtype))
    parts = list(w.chunk(2, dim=axis))
    got = col.quantized_all_gather(parts, axis, [torch.device("cpu")],
                                   axes=("data",))[0]
    assert torch.equal(got.float(), t(arrays[f"{dtype}/{axis}/g"]))


# the port's mesh against its own one device, family by family

MESH_CASES = [
    ("llava-next-34b", (4, 2)), ("musicgen-medium", (2, 4)),
    ("gemma3-27b", (4, 2)), ("starcoder2-7b", (2, 2)),
    ("qwen3-14b", (2, 4)), ("olmoe-1b-7b", (4, 1)),
    ("xlstm-1.3b", (4, 2)), ("zamba2-7b", (2, 4)),
]


@pytest.mark.parametrize("arch,shape", MESH_CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in MESH_CASES])
def test_every_family_trains_on_a_mesh_as_on_one_device(arch, shape):
    cfg = _rho1(registry.get_smoke_config(arch))
    model = LMModel(cfg, device="cpu")
    params = model.init(seed=1)
    batch = _batch(cfg, batch=8, seq=32, embeddings=cfg.uses_embeddings_input)
    mesh = cpu_mesh(*shape)
    placed = shd.shard_tree(params, shd.param_shardings(params, mesh), mesh)
    loss, grads = _grads(model, placed, batch, mesh)
    want_loss, want = _grads(model, params, batch)
    tol = LOG_SIGMOID_TOL if arch == "zamba2-7b" else GRAD_TOL
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_grads_close(grads, {k: v.numpy()
                                for k, v in adamw.tree_leaves(want)}, tol)


def test_mesh_train_steps_equal_one_device_steps():
    """Three steps in two microbatches with the factored second moment:
    params, moments and metrics as the one-device steps'."""
    cfg = _rho1(registry.get_smoke_config("phi3-mini-3.8b"))
    model = LMModel(cfg, device="cpu")
    opt = AdamWConfig(learning_rate=LR, factored_second_moment=True)
    params = model.init(seed=2)
    state = adamw.init(params, opt)
    mesh = cpu_mesh(4, 2)
    placed, placed_state = shard_state(
        {k: v for k, v in params.items()},
        adamw.init(model.init(seed=2), opt), mesh)
    one = make_train_step(model, opt, num_microbatches=2)
    many = make_train_step(model, opt, mesh=mesh, num_microbatches=2)
    for i in range(3):
        batch = _batch(cfg, batch=16, seq=32, seed=30 + i)
        params, state, m1 = one(params, state, batch)
        placed, placed_state, m2 = many(placed, placed_state, batch)
        for key in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(m2[key]), float(m1[key]),
                                       rtol=1e-5, err_msg=key)
    got, got_state = gather_state(placed, placed_state)
    _check_close(got, params, atol=2e-5, bound=2 * 3 * LR)
    _check_close(got_state.mu, state.mu, atol=1e-7, rtol=1e-3)
    _check_close(got_state.nu, state.nu, atol=1e-10, rtol=1e-3)
    assert int(got_state.step) == 3
