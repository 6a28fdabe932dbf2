"""Engine replicas behind one queue (``ReplicatedServeLoop``), on ``cpu ×
N`` meshes and host-only replicas.

Against the reference: ``replica_home`` for uids 0–9999 over 1–8
replicas; the placement of one trace — home, spill past the threshold,
and the bounded queue's fallthrough and rejection — equal to the JAX
``ReplicatedServeLoop(replicas=N)``'s, by submissions alone and with
ticks between them (then the greedy streams equal too); the registry's
merge semantics.

In-port contracts: streams on ``(2, 2)`` and ``(4, 1)`` meshes equal a
single engine's, greedy and sampled, while the placements differ;
merged metrics sum the counters and take the max of the peak pages and
the wall clocks; the merged registry holds the namespaced series and
the stripped aggregates (tests/test_distributed.py's cases)."""

import jax
import numpy as np
import pytest

from repro.models import LMModel as JaxLMModel
from repro.observability.metrics import MetricsRegistry as JaxRegistry
from repro.runtime import QueueFull as JaxQueueFull
from repro.runtime import ReplicatedServeLoop as JaxReplicated
from repro.runtime import Request as JaxRequest
from repro.runtime import replica_home as jax_replica_home
from repro_torch.convert import convert_params
from repro_torch.models import LMModel
from repro_torch.observability.metrics import (
    MetricsRegistry,
    strip_replica_prefix,
)
from repro_torch.runtime import (
    EngineMetrics,
    QueueFull,
    ReplicatedServeLoop,
    Request,
    ServeLoop,
    replica_home,
)
from tests._torch_port import jax_model_config
from tests.test_torch_mesh import cpu_mesh, drain, mesh_config, trace

KW = dict(batch_slots=4, max_len=64, prefill_chunk=8, device="cpu")


@pytest.fixture(scope="module")
def block_models():
    """The mesh-serving model on the reference's ``mpmrf_block`` (its
    replicated tests' impl), in both packages."""
    cfg = mesh_config(impl="mpmrf_block")
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return model, params, jmodel, jparams


@pytest.fixture(scope="module")
def pallas_model():
    model = LMModel(mesh_config(), device="cpu")
    return model, model.init(seed=5)


@pytest.mark.parametrize("n_rep", range(1, 9))
def test_replica_home_matches_reference(n_rep):
    homes = [replica_home(u, n_rep) for u in range(10_000)]
    assert homes == [jax_replica_home(u, n_rep) for u in range(10_000)]
    counts = [homes.count(r) for r in range(n_rep)]
    assert min(counts) > 0.15 * len(homes) / n_rep, counts


def _place(loop, request, full, reqs):
    """Submit ``reqs``; the placement and the uids the queue rejected."""
    rejected = []
    for u, prompt, temp in reqs:
        try:
            loop.submit(request(uid=u, prompt=list(prompt), max_new_tokens=4,
                                temperature=temp))
        except full:
            rejected.append(u)
    return dict(loop.placement), rejected


def _many(count=40, seed=4):
    rng = np.random.default_rng(seed)
    return [(int(u), rng.integers(1, 63, size=int(rng.integers(3, 30))
                                  ).tolist(), 0.0)
            for u in rng.permutation(1000)[:count]]


@pytest.mark.parametrize("n_rep,spill,limit", [
    (2, None, None), (3, 1, None), (4, 0, None), (3, 2, 5), (2, 1, 3),
], ids=["default", "spill1", "spill0", "queue-limit", "queue-full"])
def test_placement_matches_reference(block_models, n_rep, spill, limit):
    model, params, jmodel, jparams = block_models
    kw = dict(batch_slots=4, max_len=64, queue_limit=limit)
    port = ReplicatedServeLoop(model, params, replicas=n_rep,
                               spill_threshold=spill, device="cpu", **kw)
    ref = JaxReplicated(jmodel, jparams, replicas=n_rep,
                        spill_threshold=spill, **kw)
    placed, rejected = _place(port, Request, QueueFull, _many())
    assert (placed, rejected) == _place(ref, JaxRequest, JaxQueueFull,
                                        _many())
    homes = [replica_home(u, n_rep) for u in placed]
    spilled = sum(r != h for r, h in zip(placed.values(), homes))
    if spill is not None and limit is None:
        assert spilled > 0
    if limit == 3:
        assert rejected


def test_placement_with_ticks_and_streams_match_reference(block_models):
    """Submissions between ticks: loads count queued and live requests,
    so placement follows both engines' schedules, and the greedy
    streams of the drain equal the reference's."""
    model, params, jmodel, jparams = block_models
    port = ReplicatedServeLoop(model, params, replicas=2, spill_threshold=1,
                               **KW)
    ref = JaxReplicated(jmodel, jparams, replicas=2, spill_threshold=1,
                        batch_slots=4, max_len=64, prefill_chunk=8)
    reqs = [(u, p, 0.0) for u, p, _ in trace()]
    for lo in range(0, len(reqs), 3):
        assert _place(port, Request, QueueFull, reqs[lo:lo + 3]) == _place(
            ref, JaxRequest, JaxQueueFull, reqs[lo:lo + 3])
        port.tick()
        ref.tick()
    port.run_until_drained()
    ref.run_until_drained()
    streams = {r.uid: list(r.tokens_out) for r in port.completed}
    assert streams == {r.uid: list(r.tokens_out) for r in ref.completed}
    assert len(streams) == len(reqs)
    assert len(set(port.placement.values())) == 2


def test_replica_streams_are_placement_invariant(pallas_model):
    """The same trace (sampled requests in it) through one engine, 2×TP2
    and 4×TP1 replicas: equal streams, different placements."""
    model, params = pallas_model
    ref = drain(ServeLoop(model, params, seed=7, **KW), trace())
    r2 = ReplicatedServeLoop(model, params, mesh=cpu_mesh(2, 2), seed=7,
                             **KW)
    s2 = drain(r2, trace())
    r4 = ReplicatedServeLoop(model, params, mesh=cpu_mesh(4, 1), seed=7,
                             **KW)
    s4 = drain(r4, trace())
    assert s2 == ref and s4 == ref and len(ref) == 10
    assert r2.placement != r4.placement
    assert len(set(r2.placement.values())) == 2
    assert len(set(r4.placement.values())) >= 3
    assert all(isinstance(e.cache["k"], tuple) for e in r2.engines)
    assert r2.completed == sorted(r2.completed, key=lambda r: r.uid)


def test_merged_metrics_and_registry(pallas_model):
    model, params = pallas_model
    loop = ReplicatedServeLoop(model, params, mesh=cpu_mesh(2, 2), seed=7,
                               **KW)
    drain(loop, trace())
    m = loop.merged_metrics()
    per = [e.metrics for e in loop.engines]
    assert m.decode_tokens == sum(x.decode_tokens for x in per)
    assert m.prefill_dispatches == sum(x.prefill_dispatches for x in per)
    assert m.peak_pages_in_use == max(x.peak_pages_in_use for x in per)
    assert m.peak_pages_in_use < sum(x.peak_pages_in_use for x in per)
    assert m.decode_time == max(x.decode_time for x in per)
    assert m.requests_recorded == 10
    assert [r["uid"] for r in m.request_records] == sorted(
        r["uid"] for r in m.request_records)
    assert m.graph_mode == "eager"
    reg = loop.merged_registry()
    names = reg.names()
    assert any(name.startswith("replica1/serve_") for name in names)
    assert reg.counter("serve_decode_tokens").value == m.decode_tokens
    assert reg.counter("replica0/serve_decode_tokens").value == (
        per[0].decode_tokens)
    assert reg.gauge("serve_peak_pages_in_use").value == m.peak_pages_in_use


def test_engine_metrics_replica_namespace():
    reg = MetricsRegistry()
    m0 = EngineMetrics(registry=reg, replica=0)
    m1 = EngineMetrics(registry=reg, replica=1)
    plain = EngineMetrics(registry=reg)
    m0.decode_tokens += 5
    m1.decode_tokens += 7
    plain.decode_tokens += 1
    assert reg.counter("replica0/serve_decode_tokens").value == 5
    assert reg.counter("replica1/serve_decode_tokens").value == 7
    assert reg.counter("serve_decode_tokens").value == 1


def _merged(cls):
    a, b = cls(), cls()
    a.counter("replica0/serve_x").value = 3
    b.counter("replica1/serve_x").value = 4
    a.gauge("replica0/serve_peak").set(7)
    b.gauge("replica1/serve_peak").set(5)
    a.histogram("replica0/serve_h", (1.0, 2.0)).observe(0.5)
    b.histogram("replica1/serve_h", (1.0, 2.0)).observe(1.5)
    merged = cls()
    for src in (a, b):
        merged.merge(src)
        merged.merge(src, rename=lambda n: (
            strip_replica_prefix(n) if strip_replica_prefix(n) != n
            else None))
    return merged


def test_registry_merge_matches_reference():
    merged = _merged(MetricsRegistry)
    assert merged.counter("serve_x").value == 7
    assert merged.counter("replica0/serve_x").value == 3
    assert merged.gauge("serve_peak").value == 7
    h = merged.histogram("serve_h", (1.0, 2.0))
    assert h.count == 2 and h.counts[0] == 1 and h.counts[1] == 1
    assert h.min == 0.5 and h.max == 1.5
    assert merged.snapshot() == _merged(JaxRegistry).snapshot()


def test_merge_rejects_mismatched_bounds():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.histogram("h", (1.0, 2.0)).observe(0.5)
    b.histogram("h", (1.0, 3.0)).observe(0.5)
    with pytest.raises(ValueError):
        a.merge(b)


def test_replicated_loop_refusals(pallas_model):
    model, params = pallas_model
    with pytest.raises(ValueError, match="data axis"):
        ReplicatedServeLoop(model, params, mesh=cpu_mesh(2, 1), replicas=3,
                            **KW)
    with pytest.raises(ValueError, match="replicas >= 1"):
        ReplicatedServeLoop(model, params, **KW)
