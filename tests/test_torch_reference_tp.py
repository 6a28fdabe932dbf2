"""Where the reference's tensor parallelism parts from its single-device
path (ROADMAP §C 3): the first op whose output differs.

The reference's ``ServeLoop._install_mesh`` keeps the params replicated
so that, its docstring says, the output projection's contraction is
never split into a cross-device sum and mesh streams stay bit-identical
to the single-device run. On olmoe's serve-smoke widths made dense (4 /
4 heads of 16, G = 1, 3 layers, pallas, pages of 16, fp32) one prefill
wave on a ``(1, 2)`` mesh writes other K rows than the single-device
engine at layers 1 and 2 (layer 0's agree).

This runs the reference in a subprocess with two host devices, its
engine's own jitted prefill wave single and on the mesh, and taps each
layer's block input, attention input, attention output per head (before
the output projection), the projection's output and the block output
(``jax.debug.callback``; the tapped runs still part exactly where the
untapped ones do). Layer 0 agrees bit for bit up to and including the
per-head attention output; the first op that differs is layer 0's output
projection, ``einsum("bnhk,hkd->bnd", out, wo)``: its operand comes out
of the head-sharded pool sharded over the heads, so XLA's SPMD
partitioner splits the contraction over the model axis into per-device
partial sums and an f32 ``all-reduce`` of them — another association of
the sum. The compiled mesh step holds exactly that all-reduce, named
after the einsum. Every later difference follows from it.

So the reference's partitioned program breaks its own contract (TP ≡
single device); it computes no association the port should mirror (the
partial sums' order inside each device is XLA's own). The port keeps TP
≡ single device (``test_torch_mesh.py``), and its bf16 replicas part
from the reference's where this shift flips a token
(``test_torch_moe_ep.py``). Nothing of the JAX package is edited: the
taps are wrappers installed in the subprocess only."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = r"""
import os, sys, json, collections, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import jax, jax.numpy as jnp
from repro.distributed import sharding as shd
from repro.launch.mesh import make_mesh_compat
from repro.models import LMModel
from repro.models import attention as A
from repro.models import model as M
from repro.runtime import Request, ServeLoop
from repro_torch.configs import registry
from tests._torch_port import jax_model_config

cfg = dataclasses.replace(
    registry.get_serve_config("olmoe-1b-7b", smoke=True), family="dense",
    num_experts=0, experts_per_token=0, name="dense-mha", num_layers=3)
model = LMModel(jax_model_config(cfg))
params = model.init(jax.random.PRNGKey(0))
TAPS = collections.defaultdict(list)

def tap(name, x):
    jax.debug.callback(lambda v: TAPS[name].append(np.asarray(v)), x)

unfold = A._unfold_heads_out
def tapped_unfold(out, p, num_heads, chunk):
    tap("attn_heads", out)
    y = unfold(out, p, num_heads, chunk)
    tap("attn_wo", y)
    return y

block = M.LMModel._serve_block_step
def tapped_block(self, lp, x, kv, attn_call, telemetry=False):
    tap("block_in", x)
    def call(p, xn, c):
        tap("attn_in", xn)
        return attn_call(p, xn, c)
    out = block(self, lp, x, kv, call, telemetry)
    tap("block_out", out[0])
    return out

A._unfold_heads_out = tapped_unfold
M.LMModel._serve_block_step = tapped_block
rng = np.random.default_rng(0)
prompts = [rng.integers(1, 255, size=n).tolist() for n in (20, 13, 17)]
kw = dict(batch_slots=3, prefill_chunk=8, max_len=64, eos_token=-1)
mesh = make_mesh_compat((1, 2), ("data", "model"))
runs = {}
for name, m in (("single", None), ("tp", mesh)):
    TAPS.clear()
    eng = ServeLoop(model, params, mesh=m, **kw)
    for u, p in enumerate(prompts):
        eng.submit(Request(uid=u, prompt=p, max_new_tokens=2))
    eng.tick()                                  # one prefill wave
    runs[name] = ({k: list(v) for k, v in TAPS.items()},
                  np.asarray(eng.cache["k"]))
(s_taps, s_k), (t_taps, t_k) = runs["single"], runs["tp"]
out = {"k_mismatch": [int((s_k[l] != t_k[l]).sum())
                      for l in range(s_k.shape[0])],
       "taps": {k: [int((a != b).sum()) for a, b in zip(s_taps[k], t_taps[k])]
                for k in s_taps},
       "sizes": {k: int(s_taps[k][0].size) for k in s_taps}}
shd.set_active_mesh(mesh)
try:
    inputs = {"tokens": jnp.zeros((3, 8), jnp.int32),
              "positions": jnp.full((3, 8), 64, jnp.int32),
              "block_table": eng._device_block_table()}
    hlo = eng.prefill_fn.lower(eng.params, eng.cache, inputs,
                               eng.cache_index).compile().as_text()
finally:
    shd.set_active_mesh(None)
out["all_reduce_ops"] = sorted({
    line.split('op_name="')[1].split('"')[0]
    for line in hlo.splitlines()
    if " all-reduce(" in line and 'op_name="' in line})
print(json.dumps(out))
"""

#: the taps in program order within a layer
ORDER = ("block_in", "attn_in", "attn_heads", "attn_wo", "block_out")


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, ROOT])
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(PROBE)], capture_output=True,
        text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_tapped_runs_part_where_the_engines_do(probe):
    """Layer 0's K rows agree, layers 1 and 2's do not (as the untapped
    engines of ``test_torch_moe_ep.py`` show)."""
    k = probe["k_mismatch"]
    assert k[0] == 0 and all(c > 0 for c in k[1:])


def test_the_first_op_that_differs_is_layer_0s_output_projection(probe):
    taps = probe["taps"]
    first = next((layer, name) for layer in range(3) for name in ORDER
                 if taps[name][layer] > 0)
    assert first == (0, "attn_wo")
    for name in ("block_in", "attn_in", "attn_heads"):
        assert taps[name][0] == 0, name          # bit for bit up to it
    # the projection's output differs on most of its elements
    assert taps["attn_wo"][0] > probe["sizes"]["attn_wo"] // 2


def test_the_mesh_step_all_reduces_the_projections_partial_sums(probe):
    """The compiled mesh prefill sums the head shards' partial products
    of ``bnhk,hkd->bnd`` across the model axis (besides the fused
    kernels' own ``psum``)."""
    ops = probe["all_reduce_ops"]
    assert any(op.endswith("bnhk,hkd->bnd/dot_general") for op in ops), ops
