"""A serving window: arrival processes found by the mix's ``loop`` name,
and a traced run's engine counters read over the untraced steady stretch,
whose steps the harness's own bookkeeping counts alike."""

import time

import _perfbench_paths  # noqa: F401
import pytest
import torch

from perfbench.harness import bench, serve, traffic

CHAT = bench.load_json(bench.HERE / "traffic" / "serve-chat.json")
LONG = bench.load_json(bench.HERE / "traffic" / "serve-longctx.json")
BIG = 2 ** 31 + 77


def test_the_open_loop_is_found_by_name():
    p = traffic.process(CHAT, BIG, 1000, 4096)
    assert [a.uid for a in p.setup] == [-1, -2]
    assert p.cached == CHAT["shared_prefix"]
    got = p.start(CHAT, 20.0)
    want = traffic.open_loop(CHAT, BIG, 20.0, 1000, 4096)
    assert [(a.uid, a.due, a.prompt) for a in got] == [
        (a.uid, a.due, a.prompt) for a in want]
    assert p.released(got[0].uid, 1.0, len(got)) == []


def test_the_closed_loop_releases_the_sessions_next_turn():
    p = traffic.process(LONG, BIG, 1000, LONG["engine"]["max_len"])
    sessions = traffic.sessions(LONG, BIG, 1000, LONG["engine"]["max_len"])
    assert [a.prompt for a in p.setup] == [s.document for s in sessions]
    first = p.start(LONG, 30.0)
    assert [a.due for a in first] == [-float(LONG["preroll_s"])] * len(
        sessions)
    nxt = p.released(first[2].uid, 4.5, 8)
    want = sessions[2].turn(1, 8, 4.5)
    assert [(a.uid, a.due, a.prompt, a.max_new_tokens) for a in nxt] == [
        (want.uid, want.due, want.prompt, want.max_new_tokens)]
    # that turn's completion releases the same session's third
    assert p.released(8, 6.0, 9)[0].prompt == sessions[2].turn(
        2, 9, 6.0).prompt


def test_an_unknown_loop_is_refused():
    with pytest.raises(KeyError, match="no arrival process"):
        traffic.process(dict(CHAT, loop="bursty-nowhere"), 1, 100, 128)


@pytest.mark.parametrize("name", ["qwen3-14b.serve-chat",
                                  "qwen3-14b.serve-longctx"])
def test_counters_cover_the_steady_steps(name):
    torch.set_num_threads(2)
    cell = bench.Cell(name)
    mix = dict(cell.mix, preroll_s=0.5, grace_s=5,
               engine=dict(batch_slots=2, max_len=128, prefill_chunk=16,
                           scheduler="hybrid", prefix_sharing=True),
               trace=dict(start_frac=0.5, length_s=0.3),
               check=dict(min_served_tokens=8, max_requests=2))
    if mix["loop"] == "closed":
        mix.update(sessions=2, document=40, turns=3,
                   question=dict(dist="uniform", min=4, max=12),
                   answer=dict(dist="uniform", min=6, max=10))
    else:
        mix.update(rate_per_s=4.0, shared_prefix=16, sampled_every=2,
                   prompt=dict(dist="lognormal", median=8, sigma=0.4,
                               min=4, max=40),
                   output=dict(dist="lognormal", median=8, sigma=0.4,
                               min=4, max=12))
    out = serve.run(cell.config, mix, dict(cell.limits, tokens_checked=1),
                    seed=BIG, seconds=2.0, trace=True,
                    device=torch.device("cpu"), t_start=time.perf_counter(),
                    smoke_layers=2)
    run = out["run"]
    e, steady = run.engine, run.steady_ticks
    assert e["decode_dispatches"] > 0 and e["prefill_dispatches"] > 0
    assert e["decode_dispatches"] == sum(1 for t in steady
                                         if t.decode_lengths)
    assert e["decode_tokens"] == sum(len(t.decode_lengths) for t in steady)
    assert e["prefill_dispatches"] == sum(1 for t in steady
                                          if t.prefill_rows)
    assert e["prefill_tokens"] == sum(b - a for t in steady
                                      for a, b in t.prefill_rows)
    assert run.tracer.done and run.tracer.window_s > 0
    got = bench.read_metrics(cell.per_layer(), run)
    assert {"decode_tick_ms", "decode_mfu"} <= set(got)
