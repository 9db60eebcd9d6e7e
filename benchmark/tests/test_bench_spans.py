"""The readers of the program's spans (`benchmark/spans.py`: the step-3
phases' idle milliseconds and the renderer's host milliseconds) on a
hand-made trace with known gaps and spans, None without spans, and the
CPU traced run of the harness reporting them."""

import io
import math
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest
import torch

from benchmark import run, spec, trace as tracing, window
from benchmark.tests.tiny import args, tiny_cell

READERS = ("idle_ms.step3.forward", "idle_ms.step3.backward",
           "idle_ms.step3.optimizer", "render_ms.step3")


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _note(name, start, end):
    return _event("user_annotation", name, start, end - start)


def _kernel(start, end):
    return _event("kernel", "k", start, end - start)


HARNESS = [_note("g2s.stage", 0, 260), _note("g2s.step1", 0, 60),
           _note("g2s.step3", 60, 260)]
# two step-3 iterations from 60 us; a step-1 block before them and spans
# after the stage, neither of which counts
PROGRAM = [
    _note("g2s.step1.forward", 1, 30), _note("g2s.render.warp", 5, 15),
    _note("g2s.step3.forward", 60, 120), _note("g2s.render.warp", 70, 80),
    _note("g2s.render.grid", 80, 85),
    _note("g2s.step3.backward", 120, 160),
    _note("g2s.step3.optimizer", 160, 170),
    _note("g2s.step3.forward", 170, 220), _note("g2s.render.warp", 180, 190),
    _note("g2s.render.grid", 188, 195),   # overlaps the warp: 180-195
    _note("g2s.step3.backward", 220, 250),
    _note("g2s.step3.optimizer", 250, 258),
    _note("g2s.step3.forward", 300, 400), _note("g2s.render.view", 300, 400),
]
# step 3's idle gaps: 60-65, 75-90, 130-155, 165-210, 255-260
DEVICE = [_kernel(40, 65), _kernel(65, 75), _kernel(90, 130),
          _kernel(155, 165), _kernel(210, 255), _kernel(300, 400)]


def _run(events):
    w = window.Window()
    w.blocks = [{"step": "step1", "n": 1, "profiled": True},
                {"step": "step3", "n": 2, "profiled": True},
                {"step": "step3", "n": 9, "profiled": False}]
    return SimpleNamespace(trace=tracing.parse(events), window=w)


@pytest.mark.parametrize("prefix", ["", "seq."])
def test_span_readers_on_a_hand_made_trace(prefix):
    r = _run(HARNESS + PROGRAM + DEVICE)
    got = {m: spec.load_reader(prefix + m)(r) for m in READERS}
    # forward: 60-65, 75-90 and 170-210 idle (5 + 15 + 40 us) over 2
    assert got["idle_ms.step3.forward"] == pytest.approx(60 / 2 / 1e3)
    # backward: 130-155 (25 us); optimizer: 165-170 and 255-258 (8 us)
    assert got["idle_ms.step3.backward"] == pytest.approx(25 / 2 / 1e3)
    assert got["idle_ms.step3.optimizer"] == pytest.approx(8 / 2 / 1e3)
    # the renderer's union: 70-85 and 180-195
    assert got["render_ms.step3"] == pytest.approx(30 / 2 / 1e3)
    # all but 258-260 of step 3's 95 idle us lies in a phase span
    lo, hi = tracing.blocks(r.trace, "step3")[0]
    idle = sum(e - s for s, e in tracing.idle_gaps(
        tracing.within(r.trace["activities"], lo, hi), lo, hi))
    assert idle == 95
    assert sum(got[m] for m in READERS[:3]) == pytest.approx(93 / 2 / 1e3)
    # the stage's gaps are labelled with the program's innermost span
    gaps = tracing.breakdown(r.trace)["idle_gaps"]
    assert gaps[:2] == [["render.warp", 45e-6], ["step1.forward", 40e-6]]


def test_span_readers_read_none_without_spans():
    bare = _run(HARNESS + DEVICE)
    untraced = SimpleNamespace(trace=None, window=bare.window)
    for m in READERS:
        assert spec.load_reader(m)(bare) is None
        assert spec.load_reader(m)(untraced) is None


def test_traced_run_reports_the_program_spans():
    cell = tiny_cell(cut=200)  # the profiled second stage comes early
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with redirect_stdout(io.StringIO()):
            code, result = run.main(args(seconds=20, trace=1), device="cpu",
                                    cell=cell)
    finally:
        torch.set_num_threads(saved)
    assert code == 0 and result["correct"]
    for m in READERS:
        v = result["metrics"]["seq." + m]["value"]
        assert math.isfinite(v) and v > 0, m
    names = {n for n, _ in result["breakdown"]["idle_gaps"]}
    phases = {f"{s}.{p}" for s in ("step1", "step2", "step3")
              for p in ("forward", "backward", "optimizer")}
    phases |= {"step1.invariants", "step2.invariants", "step2.sample",
               "render.warp", "render.grid", "render.view"}
    assert names & phases, names
