"""The port's observability modules against the reference's, on the same
inputs: histogram percentiles and their edge cases, the registry's
snapshot, Prometheus text (byte for byte), merge and the replica-prefix
rename, the sparsity aggregator's snapshots, the event trace's ring
buffer and the Chrome trace, which the reference's validator must
accept. The engine-level checks (telemetry end to end, the disabled
path) are in ``test_torch_telemetry.py``."""

import json

import numpy as np
import pytest

from repro import observability as ref_obs
from repro.observability import metrics as ref_metrics
from repro_torch import observability as obs_lib
from repro_torch.observability import metrics as port_metrics

SAMPLE_SEEDS = [0, 1, 2]


def _samples(seed, n=2000):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.lognormal(mean=-4.0, sigma=1.5, size=n),
        [0.0, 1e-5, 61.0],                   # both open-ended buckets
    ])


@pytest.mark.parametrize("seed", SAMPLE_SEEDS)
def test_histogram_percentiles_equal_the_reference(seed):
    samples = _samples(seed)
    port = port_metrics.Histogram("t", port_metrics.DEFAULT_LATENCY_BOUNDS)
    ref = ref_metrics.Histogram("t", ref_metrics.DEFAULT_LATENCY_BOUNDS)
    for s in samples:
        port.observe(s)
        ref.observe(s)
    for p in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert port.percentile(p) == ref.percentile(p), p
    assert (port.counts, port.count, port.sum, port.min, port.max,
            port.mean) == (ref.counts, ref.count, ref.sum, ref.min,
                           ref.max, ref.mean)


def test_histogram_edge_cases_as_the_reference():
    assert port_metrics.DEFAULT_LATENCY_BOUNDS == \
        ref_metrics.DEFAULT_LATENCY_BOUNDS
    assert port_metrics.RHO_BOUNDS == ref_metrics.RHO_BOUNDS
    for mod in (port_metrics, ref_metrics):
        h = mod.Histogram("t", (1.0, 2.0))
        assert h.percentile(50) == 0.0 and h.mean == 0.0
        h.observe(5.0)                       # overflow bucket
        assert h.percentile(50) == 5.0
        h.observe(1.0)                       # on a bound: its own bucket
        assert h.counts == [1, 0, 1]
        with pytest.raises(ValueError):
            mod.Histogram("bad", (2.0, 1.0))
        with pytest.raises(ValueError):
            mod.Histogram("bad", ())
        reg = mod.MetricsRegistry()
        reg.counter("x").inc()
        with pytest.raises(ValueError):
            reg.gauge("x")
        reg.histogram("h", (1.0, 2.0))
        with pytest.raises(ValueError):
            reg.histogram("h", (1.0, 3.0))
        assert reg.histogram("h", (1.0, 2.0)) is reg.histogram("h",
                                                               (1.0, 2.0))


def _fill(mod, seed):
    """The same metrics, values and helps in a registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    reg.counter("serve_ticks", "ticks").value = int(rng.integers(1, 99))
    reg.counter("replica1/serve_decode_tokens").inc(int(rng.integers(9)))
    g = reg.gauge("serve_pool_occupancy", "pages")
    for v in rng.integers(0, 64, size=5):
        g.set(int(v))
    reg.gauge("serve_prefill_time_seconds").set(float(rng.random()))
    h = reg.histogram("serve_itl_seconds", mod.DEFAULT_LATENCY_BOUNDS,
                      "gaps")
    for v in rng.lognormal(-4.0, 1.0, size=50):
        h.observe(float(v))
    r = reg.histogram("replica0/serve_rho_eff_decode", mod.RHO_BOUNDS)
    for v in rng.random(20):
        r.observe(float(v))
    reg.histogram("3bad-name.x", (0.1, 1.0)).observe(0.5)
    return reg


@pytest.mark.parametrize("seed", SAMPLE_SEEDS)
def test_registry_exports_equal_the_reference(seed, tmp_path):
    port, ref = _fill(port_metrics, seed), _fill(ref_metrics, seed)
    assert port.names() == ref.names()
    assert port.snapshot() == ref.snapshot()
    assert port.prometheus_text() == ref.prometheus_text()
    port.write_json(str(tmp_path / "port.json"))
    ref.write_json(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize("rename", [None, "strip"])
def test_merge_equals_the_reference(rename):
    def merged(mod):
        out = _fill(mod, 0)
        fn = mod.strip_replica_prefix if rename else None
        return out.merge(_fill(mod, 1), rename=fn).merge(_fill(mod, 2),
                                                         rename=fn)

    port, ref = merged(port_metrics), merged(ref_metrics)
    assert port.snapshot() == ref.snapshot()
    assert port.prometheus_text() == ref.prometheus_text()
    for name in ("replica12/serve_x", "serve_x", "replicaX/serve_x",
                 "a/replica1/x"):
        assert port_metrics.strip_replica_prefix(name) == \
            ref_metrics.strip_replica_prefix(name)


def _stats(seed, layers=3, batch=4):
    """Selection counts as a step returns them: selected ≤ live, pinned
    and filled ≤ selected; a dense prefix layer's row all zero."""
    rng = np.random.default_rng(seed)
    live = rng.integers(0, 40, size=(layers, batch))
    sel = rng.integers(0, live + 1)
    pinned = rng.integers(0, sel + 1)
    filled = rng.integers(0, sel - pinned + 1)
    st = np.stack([sel, live, pinned, filled], -1).astype(np.int32)
    st[0] = 0
    return st


def test_sparsity_aggregator_equals_the_reference():
    port, ref = obs_lib.SparsityAggregator(), ref_obs.SparsityAggregator()
    assert port.snapshot() == ref.snapshot()        # nothing recorded
    for seed in range(6):
        st = _stats(seed)
        slots = [[0, 2], [1], None, [0, 1, 2, 3], [3], []][seed]
        for agg in (port, ref):
            agg.record_decode(st, slots)
            agg.record_prefill(st)
        assert port.snapshot() == ref.snapshot()
    snap = port.snapshot()
    assert snap["decode"]["dispatches"] == 5        # the empty slot list
    assert 0.0 < snap["decode"]["rho_eff"] <= 1.0
    assert snap["decode"]["rho_eff_per_layer"][0] is None   # dense layer
    json.dumps(snap)
    with pytest.raises(ValueError):
        port.record_prefill(np.zeros((2, 4), np.int32))


def test_observability_records_like_the_reference():
    port, ref = obs_lib.Observability(), ref_obs.Observability()
    for o in (port, ref):
        for tick in range(5):
            o.record_tick_series(tick, pool_occupancy=tick * 3,
                                 queue_depth=5 - tick, live_slots=tick % 2)
            o.record_decode_stats(_stats(tick), slots=[0, 3])
            o.record_prefill_stats(_stats(tick + 10))
    sp, sr = port.snapshot(), ref.snapshot()
    assert sp == sr
    assert sp["metrics"]["serve_rho_eff_decode"]["count"] == 5
    assert port.series_stats("pool_occupancy") == \
        ref.series_stats("pool_occupancy")
    assert port.trace.signature() == ref.trace.signature()


def test_trace_ring_buffer_stays_bounded():
    trace = obs_lib.EventTrace(capacity=8)
    for i in range(20):
        trace.emit("decode_tick", site="t", dur=0.001, i=i)
    assert len(trace) == 8 and trace.dropped == 12
    assert trace.events[0].args["i"] == 12 and trace.events[0].seq == 12
    assert [s[-1] for s in trace.signature()] == [
        (("i", i),) for i in range(12, 20)]
    with pytest.raises(ValueError):
        obs_lib.EventTrace(capacity=0)


def test_chrome_trace_passes_the_reference_validator(tmp_path):
    """A trace with every lane and kind of event, rendered by the port,
    is accepted by both validators and spans every request's slot
    residency."""
    trace = obs_lib.EventTrace()
    trace.emit("admit", slot=0, uid=7, resumed=False, prompt_len=9, skip=0)
    trace.emit("prefill_wave", site="prefill", dur=0.01, chunks=2, slots=1)
    trace.emit("admit", slot=1, uid=8, resumed=False, prompt_len=3, skip=0)
    for name in obs_lib.COUNTER_EVENTS:
        trace.emit(name, value=3)
    trace.emit("fault_injected", site="nan_logits", n=1)
    trace.emit("page_evict", site="allocator", page=4)
    trace.emit("decode_tick", site="decode", dur=0.002, live=2)
    trace.emit("quarantine", slot=1, uid=8, error="non-finite logits")
    trace.emit("retry", site="step_dispatch", attempt=0)
    trace.emit("admit", slot=2, uid=9, resumed=False, prompt_len=3, skip=0)
    trace.emit("finish", slot=0, uid=7, tokens=4)
    path = tmp_path / "trace.json"
    doc = obs_lib.export_chrome_trace(trace, str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
    ref_obs.validate_chrome_trace(doc)
    obs_lib.validate_chrome_trace(doc)
    spans = {e["args"]["uid"]: e["args"]["release"]
             for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"].startswith("req ")}
    assert spans == {7: "finish", 8: "quarantine", 9: "open"}
    for bad in ({"traceEvents": [{"ph": "?"}]}, {"events": []},
                {"traceEvents": [{"ph": "i", "name": "x", "pid": 1,
                                  "ts": 0, "tid": 1}]}):
        for validate in (obs_lib.validate_chrome_trace,
                         ref_obs.validate_chrome_trace):
            with pytest.raises(ValueError):
                validate(bad)
