"""Serve steps replayed from CUDA graphs: the port's counterpart of the
reference's jitted, cache-donating steps (``make_serve_step`` /
``make_prefill_step`` in :mod:`repro_torch.runtime.serve_loop`).

An eager ``decode_step`` or ``prefill`` is a Python loop over the layers
that launches about a hundred kernels per layer, so the host, not the
card, sets a step's time. :class:`GraphedStep` captures one call per
input signature (batch, chunk, input keys) into a ``torch.cuda.CUDAGraph``
over static input buffers, and each later call copies its inputs into
those buffers and replays the graph: one dispatch per step, the same
kernels on the same shapes, so the same bits. The cache is updated in
place by the replay, as the reference donates it.

Capture, on the device's one capture stream:

* one eager warm-up call on that stream first, so that what the kernels
  set up at their first call exists before capture begins: the nvcc
  build, the decode gather's workspace and counts (kept per stream, and
  never freed once handed out), the cached SM count, occupancy and
  shared-memory attributes, cuBLAS's workspace;
* warm-up and capture run with every slot inactive — decode with
  ``active`` all false (paged, and a recurrent family's, whose state
  then advances on no slot) or every index at the cache-rows sentinel
  (contiguous), prefill with every position at the sentinel — so every
  K/V write lands in the cache's scratch target and no live row or
  state changes.
  They still re-quantize blocks whose rows they did not change, which
  gives those blocks their codes again; only an all-zero block's scale
  moves from the reset value 0 to the quantizer's floor, so the scales
  are saved before the warm-up and put back after (capture itself runs
  nothing);
* the kernels' launch counts of the warm-up are dropped and those of the
  capture kept, and each replay adds them (:func:`_build.set_aside`).

A ``telemetry`` step captures ``model.<method>(..., telemetry=True)``:
the same kernels, plus the selection counts of every layer, returned as
a third output that the replay overwrites like the logits.

A step over a head-sharded pool whose shards share the one device (a
simulated mesh, ``cuda:0`` × M) captures like any other: its shards'
kernels run in turn on the capture stream. One graph captures one
device's stream, so a mesh over several cards runs its steps eagerly
(``ServeLoop.graph_mode``).

A failed capture or replay raises; nothing falls back to the eager step.
The logits a replay returns live in the graph's static output, which the
next replay of either step overwrites: a caller that keeps rows across
dispatches copies them out first.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build


#: one capture stream per device, made at the first capture: captures run
#: one at a time, and a stream keeps what was first made for it (cuBLAS's
#: workspace, the decode gather's scratch) for the life of the process
_capture_streams: Dict[int, Any] = {}


def _capture_stream(device: torch.device):
    if device.index not in _capture_streams:
        _capture_streams[device.index] = torch.cuda.Stream(device)
    return _capture_streams[device.index]


@dataclasses.dataclass
class _Captured:
    graph: Any                        # torch.cuda.CUDAGraph
    inputs: Dict[str, torch.Tensor]   # static input buffers
    index: torch.Tensor               # static cache_index
    logits: torch.Tensor              # static output
    stats: Optional[torch.Tensor]     # static [L, B, 4] (telemetry)
    launches: Dict[str, int]          # kernel launches of one replay
    owner: Tuple[int, int]            # params' and cache's first addresses


def _first_ptr(tree) -> int:
    while isinstance(tree, (dict, tuple)):
        tree = tree[min(tree)] if isinstance(tree, dict) else tree[0]
    return tree.data_ptr()


def idle_inputs(model, method: str, cache, inputs: Dict[str, torch.Tensor],
                cache_index: torch.Tensor):
    """Buffers shaped as ``inputs`` / ``cache_index`` under which every
    slot is inactive, so no K/V write lands on a cache row: tokens 0,
    block tables 0, paged ``active`` false, prefill positions and
    contiguous decode indices at the cache-rows sentinel."""
    attn = cache.get("shared_attn", cache)
    if "block_table" in inputs:
        ps = model.cfg.energon.decode_key_block
        sentinel = inputs["block_table"].shape[-1] * ps
    else:
        # an attention-free cache (xLSTM's) reads no index
        sentinel = attn["k"].shape[-2] if "k" in attn else 0
    static = {k: torch.zeros_like(v) for k, v in inputs.items()}
    index = torch.zeros_like(cache_index)
    if "positions" in static:
        static["positions"].fill_(sentinel)
    if method == "decode_step" and "block_table" not in inputs:
        index.fill_(sentinel)
    return static, index


def run_idle(model, method: str, params, cache, static, index,
             telemetry: bool = False) -> None:
    """One call of ``model.<method>`` on :func:`idle_inputs`, leaving the
    cache bit for bit as it was: its writes land in the scratch target,
    its re-quantization reproduces each block's codes, and the scales
    (where only an all-zero block's would move) are put back."""
    # a tuple: a pool's head shards; a hybrid's in its shared block
    leaf = cache.get("shared_attn", cache).get("k_scale", ())
    parts = leaf if isinstance(leaf, tuple) else (leaf,)
    scales = [p.clone() for p in parts]
    getattr(model, method)(params, cache, static, index, telemetry=telemetry)
    for part, saved in zip(parts, scales):
        part.copy_(saved)


class GraphedStep:
    """``model.<method>`` (``decode_step`` or ``prefill``) as a callable
    ``(params, cache, inputs, cache_index) -> (logits, cache)`` that
    replays CUDA graphs (with ``telemetry``, ``(logits, cache, stats)``
    of ``model.<method>(..., telemetry=True)``). The inputs must say which rows are live, so that
    capture can run with none: ``positions`` for a prefill, ``active``
    for a paged decode. Steps given one ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) share their graphs' memory: safe
    where, as in one engine, they replay one at a time on one stream and
    each step's logits are consumed before the next replay."""

    def __init__(self, model, method: str, device: torch.device,
                 pool=None, telemetry: bool = False):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        if method not in ("decode_step", "prefill"):
            raise ValueError(f"no graphed step for {method!r}")
        self.model = model
        self.method = method
        self.telemetry = bool(telemetry)
        self.device = torch.device("cuda", torch.cuda.current_device()
                                   if device.index is None else device.index)
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self._graphs: Dict[Tuple, _Captured] = {}
        #: wall seconds of warm-ups and captures, and the device memory
        #: the captures reserved
        self.capture_seconds = 0.0
        self.graph_bytes = 0

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def __call__(self, params, cache, inputs: Dict[str, torch.Tensor],
                 cache_index: torch.Tensor):
        cap = self._prepared(params, cache, inputs, cache_index)
        for name, buf in cap.inputs.items():
            buf.copy_(inputs[name])
        cap.index.copy_(cache_index)
        cap.graph.replay()
        _build.add_launches(cap.launches)
        if self.telemetry:
            return cap.logits, cache, cap.stats
        return cap.logits, cache

    def prepare(self, params, cache, inputs: Dict[str, torch.Tensor],
                cache_index: torch.Tensor) -> None:
        """Capture the graph for inputs shaped as these, if it is not
        captured yet, without running a step: the cache is left as it
        was (a server does this before its first request)."""
        self._prepared(params, cache, inputs, cache_index)

    def _prepared(self, params, cache, inputs, cache_index) -> _Captured:
        key = tuple(sorted((k, tuple(v.shape)) for k, v in inputs.items()))
        cap = self._graphs.get(key)
        if cap is None:
            # a recurrent state advances on the active slots only
            live = ("positions" if self.method == "prefill" else
                    "active" if ("block_table" in inputs
                                 or not self.model.supports_prefill)
                    else None)
            if live is not None and live not in inputs:
                raise ValueError(
                    f"a graphed {self.method} needs inputs[{live!r}]: "
                    f"capture runs with every row of it dead")
            cap = self._graphs[key] = self._capture(params, cache, inputs,
                                                    cache_index)
        elif cap.owner != (_first_ptr(params), _first_ptr(cache)):
            raise ValueError(
                "a captured step replays on the params and cache it was "
                "captured with")
        return cap

    def _capture(self, params, cache, inputs, cache_index) -> _Captured:
        """Warm up and capture one graph for inputs shaped as these, with
        every slot inactive."""
        t0 = time.perf_counter()
        static, index = idle_inputs(self.model, self.method, cache, inputs,
                                    cache_index)
        stream = _capture_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with _build.set_aside(), torch.cuda.stream(stream):
            run_idle(self.model, self.method, params, cache, static, index,
                     self.telemetry)
        current.wait_stream(stream)
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        fn = getattr(self.model, self.method)
        with _build.set_aside() as launches:
            with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                out = fn(params, cache, static, index,
                         telemetry=self.telemetry)
        self.graph_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self.capture_seconds += time.perf_counter() - t0
        return _Captured(
            graph=graph, inputs=static, index=index, logits=out[0],
            stats=out[2] if self.telemetry else None,
            launches=dict(launches),
            owner=(_first_ptr(params), _first_ptr(cache)),
        )
