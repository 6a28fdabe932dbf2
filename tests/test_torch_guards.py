"""Boundaries of the port: it imports neither ``jax`` nor the reference
package, and its entry points run on CUDA unless told otherwise —
raising on a host without a GPU instead of falling back to the CPU."""

import ast
import pathlib

import pytest
import torch

from repro_torch.configs.registry import get_serve_config
from repro_torch.models import LMModel
from repro_torch.runtime import ServeLoop

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")


def test_model_defaults_to_cuda_and_refuses_the_cpu_fallback():
    _no_gpu()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMModel(get_serve_config("qwen3-14b", smoke=True))


def test_serve_loop_defaults_to_cuda():
    _no_gpu()
    model = LMModel(get_serve_config("qwen3-14b", smoke=True), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(model, model.init(), max_len=64)


def test_serve_launcher_defaults_to_cuda():
    _no_gpu()
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--requests", "1"])


def test_kernel_wrappers_take_only_cpu_or_cuda_tensors():
    from repro_torch.kernels import mpmrf_decode as dk

    q = torch.zeros((1, 1, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dk.paged_filter_scores(q, q, q, q, q, q, key_block=16)
