"""The traffic generator: deterministic in the seed, the same work for
every seed (stratified lengths and gaps, permuted), and the check's
sample drawn from the seed."""

import _perfbench_paths  # noqa: F401
import numpy as np
import pytest

from perfbench.harness import bench, traffic

MIX = bench.load_json(bench.HERE / "traffic" / "serve-chat.json")
BIG = 2 ** 31 + 12345


def _summary(arrivals):
    return [(a.due, a.prompt, a.max_new_tokens, a.temperature)
            for a in arrivals]


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_open_loop_is_deterministic_in_the_seed(seed):
    a = traffic.open_loop(MIX, seed, 30.0, 151936, 4096)
    b = traffic.open_loop(MIX, seed, 30.0, 151936, 4096)
    assert _summary(a) == _summary(b)
    assert _summary(a) != _summary(traffic.open_loop(MIX, seed + 1, 30.0,
                                                     151936, 4096))


def test_a_fixed_schedule_is_replayed_with_the_seeds_tokens():
    runs = [traffic.open_loop(MIX, s, 30.0, 151936, 4096)
            for s in (1, 2, BIG)]
    shape = {tuple((a.due, len(a.prompt), a.max_new_tokens, a.temperature)
                   for a in r) for r in runs}
    assert len(shape) == 1
    assert len({tuple(r[0].prompt) for r in runs}) == 3


def test_every_schedule_offers_the_same_work():
    runs = [traffic.open_loop(dict(MIX, schedule_seed=s), 5, 30.0, 151936,
                              4096) for s in (1, 2, BIG)]
    for part in (lambda a: a.due < 0, lambda a: 0 <= a.due < 30.0):
        for f in (lambda a: len(a.prompt), lambda a: a.max_new_tokens,
                  lambda a: a.temperature > 0):
            assert len({tuple(sorted(f(a) for a in r if part(a)))
                        for r in runs}) == 1
    assert all(a.due < 30.0 for r in runs for a in r)
    assert len({tuple(np.round([a.due for a in r], 9)) for r in runs}) == 3


def test_open_loop_shape():
    arr = traffic.open_loop(MIX, 3, 40.0, 151936, 4096)
    n = len(arr)
    assert n == (round(MIX["rate_per_s"] * MIX["preroll_s"])
                 + round(MIX["rate_per_s"] * 40))
    assert arr[0].due == pytest.approx(-MIX["preroll_s"])
    assert all(a.due <= b.due for a, b in zip(arr, arr[1:]))
    system = arr[0].prompt[:MIX["shared_prefix"]]
    for a in arr:
        assert a.prompt[:MIX["shared_prefix"]] == system
        user = len(a.prompt) - MIX["shared_prefix"]
        assert MIX["prompt"]["min"] <= user <= MIX["prompt"]["max"]
        assert 1 <= a.max_new_tokens <= MIX["output"]["max"]
        assert len(a.prompt) + a.max_new_tokens <= 4096
        assert all(0 <= t < 151936 for t in a.prompt)
    every = MIX["sampled_every"]
    n_pre = round(MIX["rate_per_s"] * MIX["preroll_s"])
    assert sum(a.temperature > 0 for a in arr) == (
        n_pre // every + (n - n_pre) // every)


def test_quantiles_are_stratified():
    q = traffic.quantiles({"dist": "lognormal", "median": 384,
                           "sigma": 0.8, "min": 64, "max": 3072}, 101)
    assert q[50] == 384
    assert list(q) == sorted(q)
    u = traffic.quantiles({"dist": "uniform", "min": 64, "max": 256}, 4)
    assert list(u) == [88, 136, 184, 232]
    with pytest.raises(ValueError):
        traffic.quantiles({"dist": "pareto", "min": 64, "max": 256}, 4)


LONG = bench.load_json(bench.HERE / "traffic" / "serve-longctx.json")


def _sessions(seed, mix=LONG):
    return [(s.document, s.turns) for s in traffic.sessions(
        mix, seed, 151936, mix["engine"]["max_len"])]


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_sessions_are_deterministic_in_the_seed(seed):
    assert _sessions(seed) == _sessions(seed)
    assert _sessions(seed) != _sessions(seed + 1)


def test_sessions_offer_the_same_work_for_every_seed():
    def shape(ss):
        return [[(len(q), a) for q, a in turns] for _, turns in ss]

    runs = [_sessions(s) for s in (1, 2, BIG)]
    assert len({str(shape(r)) for r in runs}) == 1
    other = _sessions(1, dict(LONG, schedule_seed=3))
    assert shape(other) != shape(runs[0])
    for part in (0, 1):
        assert sorted(x[part] for t in shape(other) for x in t) == sorted(
            x[part] for t in shape(runs[0]) for x in t)
    r = runs[0]
    assert len(r) == LONG["sessions"]
    assert len({tuple(d) for d, _ in r}) == LONG["sessions"]
    for doc, turns in r:
        assert len(doc) == LONG["document"] and len(turns) == LONG["turns"]
        for q, a in turns:
            assert LONG["question"]["min"] <= len(q) <= LONG["question"][
                "max"]
            assert LONG["answer"]["min"] <= a <= LONG["answer"]["max"]
            assert len(doc) + len(q) + a <= LONG["engine"]["max_len"]


def test_a_session_turn_is_its_document_and_question():
    s = traffic.sessions(LONG, 5, 1000, 16384)[2]
    a = s.turn(1, 42, 3.5)
    assert a.prompt == s.document + s.turns[1][0]
    assert (a.uid, a.due, a.max_new_tokens, a.temperature) == (
        42, 3.5, s.turns[1][1], 0.0)
    n = len(s.turns)
    late = s.turn(n + 3, 0, 0.0)
    assert late.prompt[:len(s.document)] == s.document
    question = late.prompt[len(s.document):]
    assert len(question) == len(s.turns[3][0])
    assert late.max_new_tokens == s.turns[3][1]
    assert question not in [q for q, _ in s.turns]
    assert late.prompt == s.turn(n + 3, 1, 2.0).prompt


def test_score_tokens_are_deterministic():
    import torch

    mix = {"batch": 2, "seq_len": 16}
    a = traffic.score_tokens(mix, BIG, 3, 100, torch.device("cpu"))
    assert torch.equal(a, traffic.score_tokens(mix, BIG, 3, 100,
                                               torch.device("cpu")))
    assert not torch.equal(a, traffic.score_tokens(mix, BIG, 4, 100,
                                                   torch.device("cpu")))
    assert a.shape == (2, 17) and int(a.max()) < 100


class _Req:
    def __init__(self, uid, n, temp=0.0):
        self.uid, self.tokens_out, self.temperature = uid, [0] * n, temp


def test_check_sample_takes_the_longest_and_is_seeded():
    done = [_Req(i, 10 + (i * 37) % 50, 0.8 if i % 5 == 0 else 0.0)
            for i in range(20)]
    s1 = traffic.check_sample(done, 11, 100, 4)
    s2 = traffic.check_sample(done, 11, 100, 4)
    assert [r.uid for r in s1] == [r.uid for r in s2]
    longest = max((r for r in done if r.temperature == 0),
                  key=lambda r: len(r.tokens_out))
    assert s1[0] is longest
    assert all(r.temperature == 0 for r in s1)
    assert len(s1) <= 4
