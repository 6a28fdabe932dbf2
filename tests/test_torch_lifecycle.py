"""The port's request lifecycle, fault containment and observability
through ``ServeLoop``, mirroring the reference's
``tests/test_fault_tolerance_engine.py``, ``test_hybrid_scheduler.py::
TestMidPrefillLifecycle`` and ``test_observability.py::
TestEngineObservability`` / ``TestMetricsRetention`` on the fp32
qwen3-14b serve-smoke config (impl pallas, pages of 16, weights carried
from the reference by ``repro_torch.convert``), paged and unpaged where
the reference runs both; then the checks across the two packages.

The reference's versions of some of these tests lean on its sampled
streams: a request meant to stay live could hit its EOS at once under
another PRNG. Here every engine takes an EOS the model cannot emit
(-1), so a request lives exactly ``max_new_tokens`` tokens, and
stochastic streams are only compared inside the port.

* Lifecycle: states, cancel (queued, live, mid-prefill), deadlines,
  backpressure and shedding, the requeue past the queue limit.
* Stall detection: a named ``EngineStalled`` instead of a spin.
* Containment: NaN quarantine of the faulted slot only, in decode and
  at prefill completion (before prefix registration, so a poisoned
  prompt's pages never attach), retried step faults, delays.
* Fault survivors ≡ the fault-free run, over fixed seeds and a small
  seeded fuzz, paged and unpaged; a schedule replays exactly.
* Across packages: greedy requests under one ``FaultSpec`` seed give
  the same terminal states, survivor streams, injector counts and event
  trace signature in the JAX engine and the port's.
* ITL attribution and ``on_token``; the launcher's lifecycle and
  observability flags."""

import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro.observability import Observability as JaxObservability
from repro.observability import validate_chrome_trace as ref_validate
from repro.runtime import FaultInjector as JaxFaultInjector
from repro.runtime import FaultSpec as JaxFaultSpec
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs.registry import get_serve_config
from repro_torch.convert import convert_params
from repro_torch.models import LMModel
from repro_torch.observability import (
    DEFAULT_LATENCY_BOUNDS,
    MetricsRegistry,
    Observability,
    validate_chrome_trace,
)
from repro_torch.runtime import (
    EngineMetrics,
    EngineStalled,
    FaultInjector,
    FaultSpec,
    QueueFull,
    Request,
    RetryPolicy,
    ServeLoop,
    StepFailure,
    TransientStepError,
)
from tests._torch_port import jax_model_config

#: an EOS no model emits: every request lives its max_new_tokens
EOS = -1


@pytest.fixture(scope="module")
def mt():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, model, params, jmodel, jparams


def _trace(n_req=5, greedy=False):
    """Two shared-prefix families with ragged suffixes, greedy and (odd
    uids, unless ``greedy``) stochastic requests."""
    trace = []
    for uid in range(n_req):
        fam = uid % 2
        prefix = [(fam * 43 + j * 13) % 61 + 1 for j in range(20)]
        suffix = [(uid * 29 + j * 7) % 61 + 1 for j in range((uid * 5) % 11)]
        trace.append({
            "uid": uid, "prompt": prefix + suffix,
            "max_new_tokens": 4 + (uid % 4),
            "temperature": 0.8 if uid % 2 and not greedy else 0.0,
        })
    return trace


def _engine(mt, **kw):
    _, model, params = mt[:3]
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 96)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("audit", True)
    return ServeLoop(model, params, eos_token=EOS, device="cpu", **kw)


def _drain(mt, trace, **kw):
    e = _engine(mt, **kw)
    for r in trace:
        e.submit(Request(**r))
    done = e.run_until_drained(max_ticks=20_000)
    return e, {r.uid: list(r.tokens_out) for r in done}


def _pages_home(e):
    """Every page free or cached: nothing live holds one."""
    if e.paged:
        assert e.allocator.pages_in_use == 0
        assert e.allocator.free_pages == e.layout.num_pages


LAYOUTS = pytest.mark.parametrize("paged", [True, False],
                                  ids=["paged", "unpaged"])


# --------------------------------------------------------------------------
# lifecycle: states, cancel, deadlines, backpressure
# --------------------------------------------------------------------------


class TestRequestLifecycle:
    def test_state_machine_happy_path(self, mt):
        e = _engine(mt)
        req = Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=3)
        assert req.state == "new"
        e.submit(req)
        assert req.state == "pending"
        e.tick()
        assert req.state == "decode"     # prefill happened inside the tick
        e.run_until_drained()
        assert req.state == "done" and req.done and req.error is None

    @LAYOUTS
    def test_cancel_pending_and_live(self, mt, paged):
        e = _engine(mt, paged=paged)
        trace = _trace(4)
        for r in trace:
            e.submit(Request(**r))
        e.tick()
        live_uid = next(s.uid for s in e.slots if s is not None)
        queued_uid = e.pending[-1].uid
        assert e.cancel(live_uid)
        assert e.cancel(queued_uid)
        assert not e.cancel(live_uid)        # already terminal
        assert not e.cancel(999)             # unknown
        done = e.run_until_drained()
        got = {r.uid for r in done}
        assert got == {r["uid"] for r in trace} - {live_uid, queued_uid}
        states = {r.uid: r.state for r in e.terminated}
        assert states == {live_uid: "cancelled", queued_uid: "cancelled"}
        assert e.metrics.cancelled_requests == 2
        assert not any(r.done for r in e.terminated)
        _pages_home(e)

    @LAYOUTS
    def test_cancel_is_invisible_to_survivors(self, mt, paged):
        trace = _trace(4)
        _, base = _drain(mt, trace, paged=paged)
        e = _engine(mt, paged=paged)
        for r in trace:
            e.submit(Request(**r))
        e.tick()
        victim = next(s.uid for s in e.slots if s is not None)
        e.cancel(victim)
        e.run_until_drained()
        assert len(e.completed) == 3
        for r in e.completed:
            assert list(r.tokens_out) == base[r.uid]

    def test_deadline_expires_pending(self, mt):
        e = _engine(mt, default_deadline_s=0.0)
        e.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4))
        assert e.run_until_drained() == []
        assert e.terminated[0].state == "expired"
        assert e.terminated[0].error == "deadline exceeded"
        assert e.metrics.expired_requests == 1

    @LAYOUTS
    def test_deadline_evicts_live_slot(self, mt, paged):
        e = _engine(mt, paged=paged)
        e.submit(Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=64,
                         deadline_s=0.05))
        e.submit(Request(uid=1, prompt=[5, 6, 7], max_new_tokens=3))
        e.tick()
        assert any(s is not None and s.uid == 0 for s in e.slots)
        time.sleep(0.06)
        done = e.run_until_drained()
        assert {r.uid for r in done} == {1}
        assert [(r.uid, r.state) for r in e.terminated] == [(0, "expired")]
        _pages_home(e)

    def test_per_request_deadline_overrides_default(self, mt):
        e = _engine(mt, default_deadline_s=0.0)
        e.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2,
                         deadline_s=60.0))
        assert [r.uid for r in e.run_until_drained()] == [0]

    def test_queue_full_without_shedding(self, mt):
        e = _engine(mt, queue_limit=2)
        e.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=2))
        e.submit(Request(uid=1, prompt=[3, 4], max_new_tokens=2))
        with pytest.raises(QueueFull):
            e.submit(Request(uid=2, prompt=[5, 6], max_new_tokens=2))
        # the rejected request never entered any engine list
        assert len(e.pending) == 2 and not e.terminated

    def test_load_shedding_prefers_lowest_priority_youngest(self, mt):
        e = _engine(mt, queue_limit=3, load_shedding=True)
        e.submit(Request(uid=0, prompt=[1, 2], priority=1))
        e.submit(Request(uid=1, prompt=[3, 4], priority=0))
        e.submit(Request(uid=2, prompt=[5, 6], priority=0))
        # victim = lowest priority, youngest of the tie → uid 2
        e.submit(Request(uid=3, prompt=[7, 8], priority=5))
        assert [r.uid for r in e.pending] == [0, 1, 3]
        assert (e.terminated[0].uid, e.terminated[0].state) == (2, "shed")
        assert e.metrics.shed_requests == 1
        # a newcomer that outranks nobody is itself rejected
        with pytest.raises(QueueFull):
            e.submit(Request(uid=4, prompt=[9], priority=0))

    def test_preemption_requeue_bypasses_queue_limit(self, mt):
        e = _engine(mt, queue_limit=1)
        e.submit(Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=8))
        e.tick()
        e.submit(Request(uid=1, prompt=[5, 6], max_new_tokens=2))
        victim = next(i for i, s in enumerate(e.slots) if s is not None)
        e._preempt(victim)               # queue already at limit
        assert len(e.pending) == 2
        assert e.pending[0].state == "preempted"
        assert {r.uid for r in e.run_until_drained()} == {0, 1}

    def test_lifecycle_counters_in_summary(self, mt):
        e = _engine(mt)
        e.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
        e.cancel(0)
        s = e.metrics.summary()
        assert "lifecycle:" in s and "1 cancelled" in s
        assert "lifecycle:" not in _engine(mt).metrics.summary()


# --------------------------------------------------------------------------
# stall diagnostics
# --------------------------------------------------------------------------


class TestStallDetection:
    def test_permanent_alloc_denial_raises_named_stall(self, mt):
        inj = FaultInjector(seed=0, spec=FaultSpec(alloc_failure=1.0))
        e = _engine(mt, fault_injector=inj, stall_patience=3)
        e.submit(Request(uid=7, prompt=[1, 2, 3, 4], max_new_tokens=4))
        with pytest.raises(EngineStalled) as exc:
            e.run_until_drained()
        assert exc.value.uids == [7] and "7" in str(exc.value)
        assert inj.counts["alloc_failure"] == 4      # patience + 1 ticks

    def test_max_ticks_exhaustion_raises(self, mt):
        e = _engine(mt)
        for r in _trace(5):
            e.submit(Request(**r))
        with pytest.raises(EngineStalled) as exc:
            e.run_until_drained(max_ticks=2)
        assert exc.value.uids == [0, 1, 2, 3, 4]

    def test_raise_on_stall_false_returns_partial(self, mt):
        e = _engine(mt)
        for r in _trace(5):
            e.submit(Request(**r))
        assert e.run_until_drained(max_ticks=2, raise_on_stall=False) == []

    def test_clean_trace_never_trips_detector(self, mt):
        # fault-free patience is the tightest (1): admission waves,
        # preemptions (a pool of 4 pages for two slots of 2-3 each) and
        # completions must not read as a stall
        e = _engine(mt, max_len=64, num_pages=4)
        assert e.stall_patience == 1
        for r in _trace(6):
            e.submit(Request(**r))
        assert len(e.run_until_drained()) == 6
        assert e.metrics.preemptions > 0


# --------------------------------------------------------------------------
# failure containment: NaN quarantine, bounded retry
# --------------------------------------------------------------------------


class TestFailureContainment:
    @LAYOUTS
    def test_decode_nan_quarantines_only_faulted_slot(self, mt, paged):
        trace = _trace(4)
        _, base = _drain(mt, trace, paged=paged)
        inj = FaultInjector(seed=5, spec=FaultSpec(nan_logits=0.12))
        e, streams = _drain(mt, trace, paged=paged, fault_injector=inj)
        assert e.metrics.failed_requests == inj.counts["nan_logits"] >= 1
        failed = {r.uid for r in e.terminated}
        for r in e.terminated:
            assert (r.state, r.error) == ("failed", "non-finite logits")
        assert set(streams) == {r["uid"] for r in trace} - failed
        for uid, toks in streams.items():
            assert toks == base[uid]
        _pages_home(e)

    @LAYOUTS
    def test_prefill_nan_quarantines_fresh_admission(self, mt, paged):
        trace = _trace(4)
        _, base = _drain(mt, trace, paged=paged)
        inj = FaultInjector(seed=3, spec=FaultSpec(nan_prefill=0.7))
        e, streams = _drain(mt, trace, paged=paged, fault_injector=inj)
        assert e.metrics.failed_requests == inj.counts["nan_prefill"] >= 1
        assert all(not r.tokens_out for r in e.terminated)
        for uid, toks in streams.items():
            assert toks == base[uid]
        _pages_home(e)

    @LAYOUTS
    def test_injected_step_faults_are_retried_invisibly(self, mt, paged):
        trace = _trace(4)
        _, base = _drain(mt, trace, paged=paged)
        inj = FaultInjector(seed=11, spec=FaultSpec(
            step_exception=0.3, step_exception_burst=2))
        e, streams = _drain(mt, trace, paged=paged, fault_injector=inj)
        assert inj.counts["step_exception"] > 0
        assert e.metrics.retries == inj.counts["step_exception"]
        assert streams == base           # nobody lost, nothing perturbed
        assert e.metrics.failed_requests == 0

    def test_retry_budget_exhaustion_surfaces_step_failure(self, mt):
        inj = FaultInjector(seed=0, spec=FaultSpec(
            step_exception=1.0, step_exception_burst=1))
        e = _engine(mt, fault_injector=inj,
                    retry_policy=RetryPolicy(max_retries=0, base_delay=0.0))
        e.submit(Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=2))
        with pytest.raises(StepFailure):
            e.run_until_drained()

    def test_transient_step_error_is_retriable(self):
        assert issubclass(TransientStepError, RuntimeError)
        assert issubclass(TransientStepError, RetryPolicy().retriable)

    def test_injected_delay_drains_clean(self, mt):
        trace = _trace(3)
        _, base = _drain(mt, trace)
        inj = FaultInjector(seed=2, spec=FaultSpec(delay=0.5,
                                                   delay_seconds=0.002))
        e, streams = _drain(mt, trace, fault_injector=inj)
        assert inj.counts["delay"] > 0
        assert streams == base


# --------------------------------------------------------------------------
# fault survivors ≡ the fault-free run
# --------------------------------------------------------------------------

_CHAOS_SPEC = dict(
    alloc_failure=0.1, step_exception=0.1, step_exception_burst=2,
    nan_logits=0.01, nan_prefill=0.1, preempt_storm=0.1,
    preempt_storm_size=2,
)
#: the fuzz's seeds, drawn once from a fixed generator
FUZZ_SEEDS = [int(s) for s in
              np.random.default_rng(2026).integers(0, 2**31 - 1, size=5)]


class TestFaultInvisibility:
    """On any seeded fault trace, survivors stream bit-identically to
    the fault-free paged AND unpaged runs, and every request reaches a
    terminal state (none lost)."""

    _clean = None

    @classmethod
    def _baselines(cls, mt):
        if cls._clean is None:
            trace = _trace(5)
            _, paged = _drain(mt, trace, num_pages=8)
            _, unpaged = _drain(mt, trace, paged=False)
            assert paged == unpaged
            cls._clean = paged
        return cls._clean

    def _assert_invisible(self, mt, seed, **kw):
        trace = _trace(5)
        clean = self._baselines(mt)
        inj = FaultInjector(seed=seed, spec=FaultSpec(**_CHAOS_SPEC))
        e, streams = _drain(mt, trace, fault_injector=inj, **kw)
        survivors = set(streams)
        faulted = {r.uid for r in e.terminated}
        assert survivors | faulted == {r["uid"] for r in trace}
        assert not survivors & faulted
        for uid in survivors:
            assert streams[uid] == clean[uid], (
                f"uid {uid} diverged under chaos seed {seed}")
        assert e.metrics.failed_requests == len(faulted)
        _pages_home(e)
        return inj

    @pytest.mark.parametrize("kw", [{"num_pages": 8}, {"paged": False},
                                    {"num_pages": 8, "scheduler": "sync"}],
                             ids=["paged", "unpaged", "sync"])
    def test_fault_invisibility_fixed_seeds(self, mt, kw):
        injected = 0
        for seed in (0, 1, 2026):
            injected += self._assert_invisible(mt, seed, **kw).total_injected
        assert injected > 0

    def test_fault_invisibility_with_a_sparse_layer_below_the_top(
            self, sparse_below_top):
        """The same on a model whose cached rows depend on a selection
        (layer 1 sparse): survivors evicted after decoding must restore
        those rows exactly, and every row of theirs is compared."""
        trace = _trace(5)
        _, clean = _drain(sparse_below_top, trace, num_pages=8)
        preempted = 0
        for seed in (0, 1, 2026):
            inj = FaultInjector(seed=seed, spec=FaultSpec(**_CHAOS_SPEC))
            e, streams = _drain(sparse_below_top, trace, num_pages=8,
                                fault_injector=inj)
            assert set(streams) | {r.uid for r in e.terminated} == set(clean)
            for uid, toks in streams.items():
                assert toks == clean[uid], (seed, uid)
            preempted += e.metrics.preemptions
            _pages_home(e)
        assert preempted > 0

    @pytest.mark.parametrize("seed", FUZZ_SEEDS)
    def test_fault_invisibility_fuzz(self, mt, seed):
        self._assert_invisible(mt, seed, num_pages=8)

    def test_chaos_schedule_replays_exactly(self, mt):
        trace = _trace(5)

        def run(seed):
            inj = FaultInjector(seed=seed, spec=FaultSpec(**_CHAOS_SPEC))
            obs = Observability()
            e, streams = _drain(mt, trace, num_pages=8, fault_injector=inj,
                                observability=obs)
            return (streams, sorted(r.uid for r in e.terminated),
                    dict(inj.counts), e.metrics.preemptions,
                    obs.trace.signature())

        first = run(99)
        assert first == run(99)
        assert sum(first[2].values()) > 0


# --------------------------------------------------------------------------
# a request evicted after it decoded restores its rows exactly
# --------------------------------------------------------------------------


def _rows(e, slot, n):
    """Slot ``slot``'s first ``n`` logical K and V rows in every layer."""
    from repro_torch.runtime import paged_cache as pgc

    out = []
    for key in ("k", "v"):
        leaf = e.cache[key]
        for layer in range(leaf.shape[0]):
            if e.paged:
                table = torch.from_numpy(
                    e.allocator.block_tables[slot:slot + 1].copy())
                rows = pgc.gather_logical_rows(leaf[layer], table,
                                               e.layout.page_size)[0]
            else:
                rows = leaf[layer, slot]
            out.append(rows[:, :n].clone())
    return out


@pytest.fixture(scope="module")
def sparse_below_top(mt):
    """The serve-smoke model with its dense prefix cut to layer 0, so
    that the sparse layer 1 feeds the K/V rows of layer 2 (with the
    default prefix of two, only the top layer is sparse and no cached
    row depends on a selection)."""
    cfg = mt[0]
    cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, min_prune_layer=1))
    model = LMModel(cfg, device="cpu")
    return cfg, model, model.init(seed=0)


@pytest.mark.parametrize("kw", [{}, {"paged": False}, {"scheduler": "sync"},
                                {"prefix_sharing": False}],
                         ids=["paged", "unpaged", "sync", "unshared"])
def test_restore_after_decoding_reproduces_the_rows(sparse_below_top, kw):
    """Preempted after 8 decode steps, a request comes back with every
    K/V row of every layer as the uninterrupted run wrote it, and the
    same stream: its prompt rows by prefill chunks on the original grid
    (or attached pages), the rows its decode steps wrote by replaying
    those steps. Re-prefilling those rows instead (the reference's
    restore) selects other key blocks in the sparse layer: layer 2's
    rows move by ~0.03 here, and at qwen3-14b's full width the stream
    changed."""
    prompt = [(j * 11) % 61 + 1 for j in range(150)]

    def run(preempt_after):
        e = _engine(sparse_below_top, max_len=256, prefill_chunk=16, **kw)
        e.submit(Request(uid=0, prompt=list(prompt), max_new_tokens=24,
                         temperature=0.7))
        states = set()
        while True:
            e.tick()
            req = e.slots[0]
            states.add(req.state)
            if preempt_after and len(req.tokens_out) == preempt_after:
                e._preempt(0)
                preempt_after = None
            elif len(req.tokens_out) == 20:
                return e, list(req.tokens_out), states

    clean, clean_toks, _ = run(None)
    resumed, toks, states = run(8)
    assert "replay" in states and resumed.metrics.preemptions == 1
    assert toks == clean_toks
    n = len(prompt) + 19
    for a, b in zip(_rows(resumed, 0, n), _rows(clean, 0, n)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# quarantine before prefix registration
# --------------------------------------------------------------------------


class _PoisonUid(FaultInjector):
    """A test double: poisons the final prefill logits of one uid, and
    nothing else."""

    def __init__(self, uid):
        super().__init__(seed=0)
        self.uid = uid

    def poison_prefill(self, uids):
        hit = [u for u in uids if u == self.uid]
        self._note("nan_prefill", len(hit))
        return hit


@pytest.mark.parametrize("scheduler", ["hybrid", "sync"])
def test_prefill_quarantine_precedes_prefix_registration(mt, scheduler):
    """A poisoned prompt's pages never enter the trie: an identical
    prompt after it recomputes everything (no prefix hit) and streams as
    on a clean engine, where the same pair would share the prefix."""
    prompt = [(j * 11) % 61 + 1 for j in range(40)]

    def run(injector):
        e = _engine(mt, scheduler=scheduler, fault_injector=injector)
        e.submit(Request(uid=0, prompt=list(prompt), max_new_tokens=3))
        e.run_until_drained()
        # the clean run's pages are registered (cached); the poisoned not
        assert (e.allocator.match_prefix(prompt) == []) == (
            injector is not None)
        e.submit(Request(uid=1, prompt=list(prompt), max_new_tokens=3))
        done = e.run_until_drained()
        return e, next(list(r.tokens_out) for r in done if r.uid == 1)

    clean, clean_out = run(None)
    assert clean.metrics.prefix_hits > 0
    poisoned, out = run(_PoisonUid(0))
    assert [(r.uid, r.state) for r in poisoned.terminated] == [(0, "failed")]
    assert poisoned.metrics.prefix_hits == 0
    assert poisoned.metrics.prefill_tokens == 2 * len(prompt)
    assert out == clean_out
    _pages_home(poisoned)


# --------------------------------------------------------------------------
# cancel, deadline and preemption between chunk waves
# --------------------------------------------------------------------------


class TestMidPrefillLifecycle:
    """cancel / deadline expiry / preemption landing between chunk waves:
    pages come home, the trie stays attachable, survivors stream on."""

    def _start_long_job(self, mt, **kw):
        e = _engine(mt, max_len=256, prefill_chunk=16, **kw)
        e.submit(Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=6,
                         temperature=0.7))
        e.tick()
        prompt = [(j * 11) % 61 + 1 for j in range(96)]
        e.submit(Request(uid=1, prompt=list(prompt), max_new_tokens=4))
        e.tick()                         # uid 1 admits; its job is mid-flight
        assert 1 in e._prefill_jobs
        assert e.slots[1] is not None and e.slots[1].state == "prefill"
        return e, prompt

    def _alone(self, mt, req, **kw):
        _, out = _drain(mt, [req], max_len=256, prefill_chunk=16, **kw)
        return out[req["uid"]]

    @LAYOUTS
    def test_cancel_mid_prefill(self, mt, paged):
        ref = self._alone(mt, dict(uid=0, prompt=[1, 2, 3, 4],
                                   max_new_tokens=6, temperature=0.7),
                          paged=paged)
        e, prompt = self._start_long_job(mt, paged=paged)
        assert e.cancel(1)
        assert 1 not in e._prefill_jobs and e.slots[1] is None
        # an identical prompt registers and completes (the cancelled job
        # never registered its pages)
        e.submit(Request(uid=2, prompt=list(prompt), max_new_tokens=4))
        done = e.run_until_drained(max_ticks=40_000)
        assert {r.uid for r in done} == {0, 2}
        assert next(list(r.tokens_out) for r in done if r.uid == 0) == ref
        assert [(r.uid, r.state) for r in e.terminated] == [(1, "cancelled")]
        _pages_home(e)

    @LAYOUTS
    def test_deadline_expires_mid_prefill(self, mt, paged):
        e, _ = self._start_long_job(mt, paged=paged)
        e.slots[1].deadline_s = 1e-9     # lapses before the next tick
        done = e.run_until_drained(max_ticks=40_000)
        assert {r.uid for r in done} == {0}
        assert [(r.uid, r.state) for r in e.terminated] == [(1, "expired")]
        assert 1 not in e._prefill_jobs
        _pages_home(e)

    @LAYOUTS
    def test_preempt_mid_prefill_resumes_exactly(self, mt, paged):
        e, prompt = self._start_long_job(mt, paged=paged)
        e._preempt(1)
        assert 1 not in e._prefill_jobs
        assert (e.pending[0].uid, e.pending[0].state) == (1, "preempted")
        done = e.run_until_drained(max_ticks=40_000)
        ref = self._alone(mt, dict(uid=1, prompt=list(prompt),
                                   max_new_tokens=4), paged=paged)
        assert next(list(r.tokens_out) for r in done if r.uid == 1) == ref


# --------------------------------------------------------------------------
# streaming and ITL attribution
# --------------------------------------------------------------------------


def test_on_token_sees_each_token_in_commit_order(mt):
    got = []
    e = _engine(mt, max_len=128, prefill_chunk=16)

    def on_token(req, tok):
        got.append((req.uid, tok, e.metrics.ticks, len(req.tokens_out)))

    trace = [dict(r, on_token=on_token) for r in _trace(4)]
    for r in trace:
        e.submit(Request(**r))
    done = e.run_until_drained()
    for r in done:
        mine = [g for g in got if g[0] == r.uid]
        assert [tok for _, tok, _, _ in mine] == list(r.tokens_out)
        # called after the commit: tokens_out already holds the token
        assert [k for _, _, _, k in mine] == list(
            range(1, len(r.tokens_out) + 1))
        ticks = [k for _, _, k, _ in mine]
        assert ticks == sorted(ticks) and ticks[0] < e.metrics.ticks
    _, base = _drain(mt, _trace(4), max_len=128, prefill_chunk=16)
    assert {r.uid: list(r.tokens_out) for r in done} == base


def test_decode_itl_never_exceeds_the_wall_gap(mt):
    """Long prompts puncture live streams: the decode-attributed gap
    strips the prefill time between two commits, so entry by entry it
    never exceeds the raw gap, and the stalls show in the raw p95."""
    rng = np.random.default_rng(11)
    trace = [dict(uid=u, prompt=[int(x) for x in rng.integers(
        1, 62, size=70 if u % 3 == 0 else 12)], max_new_tokens=10)
        for u in range(8)]
    obs = Observability()
    e, _ = _drain(mt, trace, max_len=160, prefill_chunk=16,
                  observability=obs)
    n_gaps = stalled = 0
    for rec in e.metrics.request_records:
        assert len(rec["itl"]) == len(rec["itl_decode"]) == 9
        for raw, dec in zip(rec["itl"], rec["itl_decode"]):
            assert 0.0 <= dec <= raw
            n_gaps += 1
            stalled += dec < raw
    assert stalled > 0                   # some gaps held a prefill wave
    stats = e.metrics.latency_stats()
    assert 0.0 < stats["itl_decode_p95"] <= stats["itl_p95"]
    hist = obs.registry.histogram("serve_itl_decode_seconds",
                                  DEFAULT_LATENCY_BOUNDS)
    assert hist.count == n_gaps == obs.registry.histogram(
        "serve_itl_seconds").count


# --------------------------------------------------------------------------
# engine observability
# --------------------------------------------------------------------------


def _observed(mt, observability=None, chaos_seed=None, **kw):
    injector = None
    if chaos_seed is not None:
        injector = FaultInjector(seed=chaos_seed, spec=FaultSpec(
            alloc_failure=0.05, step_exception=0.05, nan_logits=0.02,
            preempt_storm=0.05))
    return _drain(mt, _trace(), fault_injector=injector,
                  observability=observability, **kw)


class TestEngineObservability:
    def test_trace_deterministic_under_fixed_seed_chaos(self, mt):
        obs_a, obs_b = Observability(), Observability()
        _, out_a = _observed(mt, obs_a, chaos_seed=7)
        _, out_b = _observed(mt, obs_b, chaos_seed=7)
        assert out_a == out_b
        sig_a = obs_a.trace.signature()
        assert sig_a and sig_a == obs_b.trace.signature()
        names = {s[0] for s in sig_a}
        assert {"admit", "decode_tick", "fault_injected"} <= names

    def test_lifecycle_events_cover_requests(self, mt):
        obs = Observability()
        engine, out = _observed(mt, obs)
        admits = [e for e in obs.trace.events if e.name == "admit"]
        finishes = [e for e in obs.trace.events if e.name == "finish"]
        assert {e.uid for e in finishes} == set(out)
        assert len(admits) >= len(out)
        for e in admits + finishes:
            assert e.slot is not None and 0 <= e.slot < 2
        assert len(obs.series["live_slots"]) == engine.metrics.ticks
        assert obs.registry.gauge("serve_pool_occupancy").peak > 0

    def test_exporters_schema_valid(self, mt, tmp_path):
        obs = Observability()
        e, _ = _observed(mt, obs, chaos_seed=3, num_pages=8)
        path = tmp_path / "trace.json"
        doc = obs.export_chrome_trace(str(path))
        validate_chrome_trace(doc)
        ref_validate(json.loads(path.read_text()))
        names = {ev["name"] for ev in doc["traceEvents"]}
        assert {"admit", "decode_tick", "pool_occupancy"} <= names
        assert [ev for ev in doc["traceEvents"]
                if ev["ph"] == "X" and ev["name"].startswith("req ")]
        text = obs.registry.prometheus_text()
        assert "serve_ticks" in text and "serve_itl_seconds_bucket" in text
        snap = obs.snapshot()
        assert snap["metrics"]["serve_retries"]["value"] == e.metrics.retries
        json.loads(json.dumps(snap))
        with pytest.raises(ValueError):
            validate_chrome_trace({"traceEvents": [{"ph": "?"}]})

    def test_trace_ring_buffer_bounded(self):
        obs = Observability(trace_capacity=8)
        for i in range(20):
            obs.trace.emit("decode_tick", site="t", i=i)
        assert len(obs.trace) == 8 and obs.trace.dropped == 12
        assert obs.trace.events[0].args["i"] == 12


class TestMetricsRetention:
    def test_request_records_capped(self):
        m = EngineMetrics(max_request_records=4)
        for uid in range(10):
            req = Request(uid=uid, prompt=[1], max_new_tokens=1)
            req._t_submit, req._t_admit, req._t_first = 0.0, 0.5, 1.0
            req._itl.extend([0.01, 0.02])
            m.record_request(req)
        assert len(m.request_records) == 4 and m.requests_recorded == 10
        assert m.request_records[0]["uid"] == 6
        st = m.latency_stats()
        assert st["requests"] == 10.0 and st["ttft_p50"] == 1.0

    def test_latency_stats_safe_on_empty(self):
        st = EngineMetrics().latency_stats()
        assert st["requests"] == 0.0 and all(v == 0.0 for v in st.values())

    def test_itl_tail_bounded_but_streamed(self):
        reg = MetricsRegistry()
        m = EngineMetrics(registry=reg)
        req = Request(uid=0, prompt=[1], max_new_tokens=1)
        for _ in range(1000):
            req._itl.append(0.01)
            m.observe_itl(0.01, 0.005)
        assert len(req._itl) == 512
        assert reg.histogram("serve_itl_seconds").count == 1000
        assert reg.histogram("serve_itl_decode_seconds").count == 1000

    def test_counters_mirror_into_registry(self):
        reg = MetricsRegistry()
        m = EngineMetrics(registry=reg)
        m.ticks += 3
        m.peak_pages_in_use = 7
        assert m.ticks == 3
        assert reg.counter("serve_ticks").value == 3
        assert reg.gauge("serve_peak_pages_in_use").value == 7
        m2 = EngineMetrics()
        m2.ticks += 3
        assert m2.ticks == 3 and m2.registry is None


# --------------------------------------------------------------------------
# across the two packages
# --------------------------------------------------------------------------

#: every fault site but the two that evict a live slot (storms, and
#: allocation denials, which preempt at decode growth): see below
_CROSS_SPEC = dict(
    step_exception=0.15, step_exception_burst=2, nan_logits=0.03,
    nan_prefill=0.15, delay=0.2, delay_seconds=0.0,
)
_EVICTING = dict(alloc_failure=0.1, preempt_storm=0.1, preempt_storm_size=1)


def _both(mt, spec, seed=2024):
    """The same greedy requests under one FaultSpec seed through the JAX
    engine and the port's: (engine, injector, trace) of each."""
    cfg, model, params, jmodel, jparams = mt
    trace = _trace(6, greedy=True)
    kw = dict(batch_slots=2, max_len=96, prefill_chunk=8, num_pages=8,
              audit=True)
    jobs = JaxObservability()
    jinj = JaxFaultInjector(seed=seed, spec=JaxFaultSpec(**spec))
    jeng = JaxServeLoop(jmodel, jparams, eos_token=EOS, fault_injector=jinj,
                        observability=jobs, **kw)
    obs = Observability()
    inj = FaultInjector(seed=seed, spec=FaultSpec(**spec))
    eng = _engine(mt, fault_injector=inj, observability=obs, **kw)
    for e, cls in ((jeng, JaxRequest), (eng, Request)):
        for r in trace:
            e.submit(cls(**r))
        e.run_until_drained(max_ticks=20_000)
    return (eng, inj, obs.trace), (jeng, jinj, jobs.trace)


def _outcome(e):
    return ({r.uid: r.state for r in e.completed + e.terminated},
            {r.uid: list(r.tokens_out) for r in e.completed})


def test_same_chaos_seed_same_outcome_in_both_packages(mt):
    """Greedy requests under one FaultSpec seed (step faults, decode and
    prefill poison, delays) through the JAX engine and the port's: the
    same terminal state per uid, survivor streams, injector counts and
    trace signature (every event's name, tick, slot, uid, site and
    arguments). The injectors draw from one numpy stream at the same
    sites in the same order, and greedy streams do not depend on either
    package's random numbers."""
    (eng, inj, trace), (jeng, jinj, jtrace) = _both(mt, _CROSS_SPEC)
    assert _outcome(eng) == _outcome(jeng)
    assert set(_outcome(eng)[0].values()) == {"done", "failed"}
    assert inj.counts == jinj.counts
    assert inj.counts["step_exception"] > 0 and inj.counts["delay"] > 0
    assert eng.metrics.retries == jeng.metrics.retries > 0
    assert eng.metrics.preemptions == jeng.metrics.preemptions == 0
    assert trace.signature() == jtrace.signature()


def test_packages_part_where_an_evicted_request_had_decoded(mt):
    """With the evicting sites on as well, the two engines agree event
    for event up to the re-admission of the first request evicted after
    it had decoded. There the reference re-prefills the tokens it had
    generated (a prefill chunk), which selects other key blocks than
    the decode steps that first wrote those rows and so changes them
    (``test_restore_after_decoding_reproduces_the_rows``); the port
    replays their decode steps instead, over later ticks. The dispatch
    counts, and with them the fault draws, differ from there on."""
    spec = dict(_CROSS_SPEC, **_EVICTING)
    (eng, inj, trace), (jeng, _, jtrace) = _both(mt, spec)
    sig, jsig = trace.signature(), jtrace.signature()
    prompts = {r["uid"]: len(r["prompt"]) for r in _trace(6, greedy=True)}
    k = next(n for n, ev in enumerate(trace.events)
             if ev.name == "admit" and ev.args["resumed"]
             and ev.args["prompt_len"] > prompts[ev.uid])
    assert sig[:k] == jsig[:k]
    assert jsig[k][:4] == sig[k][:4]         # the same re-admission
    assert eng.metrics.preemptions > 0


# --------------------------------------------------------------------------
# the launcher's lifecycle and observability flags
# --------------------------------------------------------------------------


def test_launcher_writes_metrics_and_trace(tmp_path, capsys):
    from repro_torch.launch import serve

    metrics, trace = tmp_path / "metrics.json", tmp_path / "trace.json"
    engine = serve.main([
        "--arch", "qwen3-14b", "--smoke", "--device", "cpu",
        "--requests", "6", "--batch-slots", "2", "--prompt-len", "20",
        "--new-tokens", "4", "--max-len", "64", "--prefill-chunk", "16",
        "--obs", "--metrics-out", str(metrics), "--trace-out", str(trace),
        "--chaos-seed", "3", "--deadline-ms", "60000", "--queue-limit", "5",
    ])
    out = capsys.readouterr().out
    assert "[serve] lifecycle:" in out and "[serve] chaos (seed 3)" in out
    assert "[serve] sparsity: rho_eff" in out
    assert engine.queue_limit == 5 and engine.default_deadline_s == 60.0
    assert engine._injector is not None and engine._injector.seed == 3
    # one request past the queue limit was rejected at submission
    assert len(engine.completed) + len(engine.terminated) == 5
    snap = json.loads(metrics.read_text())
    assert snap["schema"] == "energon-obs-v1"
    assert snap["metrics"]["serve_ticks"]["value"] == engine.metrics.ticks
    assert snap["sparsity"]["decode"]["dispatches"] > 0
    doc = json.loads(trace.read_text())
    validate_chrome_trace(doc)
    ref_validate(doc)
