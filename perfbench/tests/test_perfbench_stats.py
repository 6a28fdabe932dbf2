"""Percentiles over whole windows: numpy's linear rule on the observed
samples, censored samples ranked past every observed one; and the rule
that holds each compared number to its limit."""

import math

import _perfbench_paths  # noqa: F401
import numpy as np
import pytest

from perfbench.harness.stats import percentile
from perfbench.harness.verdict import verdict


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_matches_numpy_without_censoring(q):
    vals = list(np.random.default_rng(1).exponential(size=301))
    assert percentile(vals, q) == pytest.approx(np.percentile(vals, q))


def test_censored_rank_past_every_observed():
    seen = [1.0, 2.0, 3.0]
    # 6 samples: the median lies between ranks 2 and 3 (3.0 and a
    # censored one): it reports the censoring bound
    assert percentile(seen, 50, [10.0, 11.0, 12.0]) == 12.0
    # with few censored the median stays among the observed
    assert percentile(seen + [4.0, 5.0], 50, [9.0]) == pytest.approx(3.5)


def test_censored_bound_never_reads_low():
    assert percentile([5.0], 95, [1.0]) == 5.0


def test_empty_is_nan():
    assert math.isnan(percentile([], 50))


def test_itl_and_ttft_readers_use_whole_windows():
    from perfbench.harness.bench import reader
    from perfbench.harness.record import RequestRecord, Run

    run = Run(kind="serve", spec={}, mix={}, seconds=10.0, window=(0.0, 10.0),
              censor_time=20.0)
    run.requests = [
        RequestRecord(uid=0, due=-1.0, prompt_len=5, temperature=0.0,
                      token_times=[0.5, 1.0, 1.5, 12.0]),
        RequestRecord(uid=1, due=2.0, prompt_len=5, temperature=0.0,
                      token_times=[2.4, 2.6]),
        RequestRecord(uid=2, due=3.0, prompt_len=5, temperature=0.0,
                      token_times=[]),
        RequestRecord(uid=3, due=4.0, prompt_len=5, temperature=0.0,
                      token_times=[4.1]),
    ]
    # tokens committed inside [0, 10): 3 + 2 + 1
    assert reader("serve_tok_s")(run) == pytest.approx(0.6)
    # TTFTs of the requests due in the window: 0.4, 0.1, censored (17)
    assert reader("ttft_p50_ms")(run) == pytest.approx(400.0)
    # gaps ending in the window: 0.5, 0.5, 0.2 (12.0 ends outside)
    assert reader("itl_p95_ms")(run) == pytest.approx(
        1e3 * np.percentile([0.5, 0.5, 0.2], 95))


@pytest.mark.parametrize("numbers, correct", [
    ({"mean_gap": 1e-3, "tokens_checked": 400}, True),
    ({"mean_gap": 1.2e-3, "tokens_checked": 900}, False),
    ({"mean_gap": 1e-4, "tokens_checked": 399}, False),
    ({"mean_gap": float("nan"), "tokens_checked": 900}, False),
])
def test_verdict_holds_each_number_to_its_limit(numbers, correct):
    limits = {"mean_gap": 1.1e-3, "tokens_checked": 400}
    checks, ok = verdict(numbers, limits)
    assert ok is correct
    assert list(checks) == ["mean_gap", "tokens_checked"]
    assert checks["mean_gap"] == {"value": numbers["mean_gap"],
                                  "max": 1.1e-3}
    assert checks["tokens_checked"]["min"] == 400
