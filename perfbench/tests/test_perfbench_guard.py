"""What the benchmark loads: a CPU rehearsal of a run's harness loads no
JAX, no Flax and nothing of the JAX package (top-level names compared
whole), the reference loads nothing of the program, and ``run.py``
refuses to run, and prints no result, without a card."""

import json
import os
import subprocess
import sys

import _perfbench_paths  # noqa: F401
from _perfbench_paths import ROOT

REHEARSAL = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
torch.set_num_threads(1)
from perfbench.harness import bench, cli, score, serve
cell = bench.Cell("qwen3-14b.serve-chat")
mix = dict(cell.mix, rate_per_s=4.0, preroll_s=0.5, grace_s=5,
           shared_prefix=16, sampled_every=2,
           prompt=dict(dist="lognormal", median=8, sigma=0.4, min=4,
                       max=16),
           output=dict(dist="lognormal", median=8, sigma=0.4, min=4,
                       max=12),
           engine=dict(batch_slots=2, max_len=128, prefill_chunk=16,
                       scheduler="hybrid", prefix_sharing=True),
           trace=dict(start_frac=0.2, length_s=0.5),
           check=dict(min_served_tokens=8, max_requests=2))
out = serve.run(cell.config, mix, dict(cell.limits, tokens_checked=1),
                seed=3, seconds=1.5, trace=True, device=torch.device("cpu"),
                t_start=time.perf_counter(), smoke_layers=4)
bench.read_metrics(cell.end_to_end() + cell.per_layer(), out["run"])
cell = bench.Cell("olmoe-1b-7b.score-4k")
out = score.run(cell.config, dict(cell.mix, batch=2, seq_len=32),
                cell.limits, seed=4, seconds=0.2, trace=False,
                device=torch.device("cpu"), t_start=time.perf_counter(),
                smoke_layers=2)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = r"""
import json, sys
sys.path[:0] = [sys.argv[1]]
import perfbench.reference.model, perfbench.reference.energon
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_rehearsed_run_loads_no_jax():
    loaded = _modules(REHEARSAL)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(REFERENCE)
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "qwen3-14b.serve-chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr
