"""The metric readers and the yardstick's arithmetic on hand-made inputs:
the window's terms, instance_s, the trace (union of overlapping intervals,
idle gaps and their labels, launches per iteration), the peak chosen from
the flags, the kernels' bytes, mfu, the cut schedule, and the gaps of the
correctness check."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, roofline, spec, trace as tracing, window


def reader(name):
    return spec.load_reader(name)


def _window(blocks, terms, instances=1):
    w = window.Window()
    w.blocks = [dict(zip(("step", "n", "seconds", "profiled", "instance",
                          "stage"), b)) for b in blocks]
    w.terms.update(terms)
    w.instances = instances
    return w


def test_instance_s_on_hand_made_terms():
    w = _window([("prior", 10, 1.0, False), ("step1", 4, 2.0, False),
                 ("step2", 5, 5.0, False), ("step3", 2, 3.0, False)],
                {"prep": 0.5, "prior": 1.0, "step1": 2.0, "step2": 5.0,
                 "step3": 3.0}, instances=2)
    counts = {"prior": 1000, "step1": 1300, "step2": 2200, "step3": 1800}
    run = SimpleNamespace(window=w, counts=counts, n_instances=8)
    want = (0.5 / 2 + 1000 * 1.0 / 10 + 1300 * 2.0 / 4 + 2200 * 5.0 / 5
            + 1800 * 3.0 / 2) / 8
    assert reader("instance_s")(run) == pytest.approx(want)


class _Sleeper:
    """A system whose blocks sleep: 2 ms a prep, 1 ms an iteration."""
    n = 2

    def inputs(self, number):
        return None, None

    def prep(self, images, latents):
        time.sleep(0.002)

    def run(self, step, n):
        time.sleep(0.001 * n)
        return [torch.zeros(self.n) for _ in range(n)]


def test_the_terms_sum_to_the_window():
    traffic = {"cut": 100, "schedule": {"prior": 1000, "stages": [
        {"step1": 700, "step2": 700, "step3": 600}] + [
        {"step1": 200, "step2": 500, "step3": 400}] * 3}}
    w = window.run(_Sleeper(), traffic, 0.2, lambda: None)
    assert abs(sum(w.terms.values()) - w.wall) <= 0.01 * w.wall
    assert w.attempted == 2 * sum(b["n"] for b in w.blocks)
    assert w.failed == 0 and w.instances >= 2
    assert [b["n"] for b in w.blocks[:4]] == [10, 7, 7, 6]
    assert w.terms["prep"] > 0 and w.terms["step2"] > w.terms["step3"]


def test_non_finite_losses_count_as_failed():
    class Bad(_Sleeper):
        def run(self, step, n):
            return [torch.tensor([float("nan"), 1.0])] * n
    traffic = {"cut": 1000, "schedule": {"prior": 1000, "stages": [
        {"step1": 1000, "step2": 1000, "step3": 1000}]}}
    w = window.run(Bad(), traffic, 0.0, lambda: None)
    assert w.failed == w.attempted // 2 == 1


def test_cut_schedule_and_full_counts():
    traffic = spec.load_cell("face128-seq").traffic
    prior, stages = window.cut_schedule(traffic)
    assert prior == 20
    assert stages == [{"step1": 14, "step2": 14, "step3": 12}] + [
        {"step1": 4, "step2": 10, "step3": 8}] * 3
    assert window.full_counts(traffic) == {
        "prior": 1000, "step1": 1300, "step2": 2200, "step3": 1800}
    prior, stages = window.cut_schedule(spec.load_cell("car512-n8").traffic)
    assert prior == 10 and stages[0] == {"step1": 7, "step2": 7, "step3": 6}
    assert stages[1] == {"step1": 2, "step2": 5, "step3": 4}


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _hand_trace():
    """A stage 0-100 us: step1 0-20, step3 20-100 (2 iterations)."""
    return tracing.parse([
        _event("user_annotation", "g2s.stage", 0, 100),
        _event("user_annotation", "g2s.step1", 0, 20),
        _event("user_annotation", "g2s.step3", 20, 80),
        _event("user_annotation", "aten::conv2d", 30, 5),
        _event("kernel", "void tests_kernel<3, 16>(short const*)", 5, 10),
        _event("kernel", "cudnn_conv", 10, 10),       # overlaps: 5-20
        _event("gpu_memset", "Memset", 30, 10),
        _event("kernel", "fetch2x2_kernel(float const*)", 35, 10),  # 30-45
        _event("gpu_memcpy", "Memcpy DtoD", 60, 20),  # 60-80
        _event("gpu_user_annotation", "g2s.step3", 20, 80),
        _event("kernel", "outside", 200, 10),
    ])


def test_union_of_overlapping_intervals_and_idle_gaps():
    t = _hand_trace()
    lo, hi = tracing.stage(t)
    acts = tracing.within(t["activities"], lo, hi)
    assert len(acts) == 5
    assert tracing.busy_us(acts) == 15 + 15 + 20
    assert tracing.idle_gaps(acts, lo, hi) == [(0, 5), (20, 30), (45, 60),
                                               (80, 100)]
    bd = tracing.breakdown(t)
    assert bd["idle_gaps"][0] == ["step3", 20e-6]
    assert ["step1", 5e-6] in bd["idle_gaps"]
    assert bd["device_ops"][0] == ["Memcpy DtoD", 20e-6]


def test_launches_per_iteration_and_idle_share():
    """The busy union (50 us) over the profiled stage's unprofiled twin,
    the next stage of the same instance (80 us, against the profiled
    100 us); nothing where the twin did not run whole."""
    t = _hand_trace()
    profiled = [("step1", 1, 60e-6, True, 1, 1), ("step3", 2, 40e-6, True,
                                                   1, 1)]
    twin = [("step1", 1, 30e-6, False, 1, 2), ("step3", 2, 50e-6, False,
                                                 1, 2)]
    other = [("step1", 1, 9.0, False, 2, 1), ("step3", 2, 9.0, False, 1, 3)]
    run = SimpleNamespace(trace=t, window=_window(profiled + other + twin,
                                                  {}))
    assert reader("launches_per_iter.step3")(run) == 3 / 2
    assert reader("device_idle_pct")(run) == pytest.approx(37.5)
    cut = SimpleNamespace(trace=t, window=_window(profiled + twin[:1], {}))
    assert reader("device_idle_pct")(cut) is None


def test_kernel_roofline_share():
    t = _hand_trace()
    w = _window([], {})
    w.kernel_calls = [("raster_tests", 5e-6), ("fetch2x2", 2.5e-6)]
    run = SimpleNamespace(trace=t, window=w)
    # tests_kernel 10 us + fetch2x2_kernel 10 us of device time
    assert reader("kernels_roofline")(run) == pytest.approx(37.5)
    assert reader("bias_act_roofline")(run) is None
    assert not roofline.is_port_kernel("cudnn_conv")
    assert roofline.is_port_kernel("void splat2x2_kernel<8>(float*)")
    assert roofline.is_port_kernel("void bias_act_kernel<float>(float*)")
    assert not roofline.is_port_kernel("void bias_act_kernel<float>()",
                                       "kernels_roofline")


def test_the_peak_is_chosen_from_the_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for mm, dnn, act, want in [(False, False, "float32", 67e12),
                                   (True, False, "float32", 495e12),
                                   (False, True, "float32", 495e12),
                                   (False, False, "bfloat16", 989e12)]:
            torch.backends.cuda.matmul.allow_tf32 = mm
            torch.backends.cudnn.allow_tf32 = dnn
            assert roofline.peak_flops(act) == want
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_mfu_on_hand_made_counts():
    w = _window([("step2", 10, 2.0, False), ("step2", 10, 9.0, True),
                 ("step3", 4, 2.0, False)], {})
    run = SimpleNamespace(window=w, flops={"step2": (1e12, 5e11),
                                           "step3": (2e11, 0.0)},
                          peak_flops=67e12)
    done = 5e11 + 10e12 + 4 * 2e11
    assert reader("mfu_pct")(run) == pytest.approx(100 * done / 4.0 / 67e12)


def test_iter_ms_leaves_out_the_profiled_stage():
    w = _window([("step2", 10, 2.0, False), ("step2", 10, 9.0, True),
                 ("step3", 4, 2.0, False)], {})
    run = SimpleNamespace(window=w)
    assert reader("iter_ms.step2")(run) == pytest.approx(200.0)
    assert reader("iter_ms.step3")(run) == pytest.approx(500.0)


def test_kernel_bytes():
    """The raster and window entries of the roofline registry count the
    bytes the kernel table's bounds count."""
    entries = roofline.kernel_entries()
    place = entries["raster_place"].CALLS["raster_place"]
    tests = entries["raster_tests"].CALLS["raster_tests"]
    fetch = entries["fetch2x2"].CALLS["fetch2x2"]
    splat = entries["splat2x2"].CALLS["splat2x2"]
    vx = torch.zeros(2, 8, 8)
    assert place(vx, vx, vx, 3, 0.3, 1.3) == \
        3 * 4 * 128 + 2 * 2 * 4 * 10 * 16 * 16 * 2
    bufs = torch.zeros(2, 2, 2, 2, 10, 16, 16, dtype=torch.int16)
    assert tests(bufs, 8, 8, 3, 0.3, 1.3) == \
        bufs.numel() * 2 + 2 * 64 * 4
    src = torch.zeros(2, 3, 8, 8)
    iy = torch.zeros(2, 64, dtype=torch.int32)
    assert fetch(src, iy, iy) == \
        src.numel() * 4 + 2 * 128 * 4 + 2 * 12 * 64 * 4
    small = torch.zeros(2, 4, dtype=torch.int32)
    assert fetch(src, small, small) == \
        16 * 6 * 4 + 2 * 8 * 4 + 2 * 12 * 4 * 4
    g = torch.zeros(2, 12, 64)
    assert splat(g, iy, iy, (2, 3, 8, 8)) == \
        g.numel() * 4 + 2 * 128 * 4 + 384 * 4


def _readings(loss, grads, changes, handoff=(1.0, 2.0)):
    return {"handoff": {s: [tuple(torch.tensor(handoff) * (i + 1)
                                  for i in range(len(ts)))]
                        for s, ts in check.HANDOFFS.items()},
            "loss": {s: np.array(loss, float) for s in check.STEPS},
            "grad": {s: {k: np.array(v, float) for k, v in grads.items()}
                     for s in check.STEPS},
            "change": {s: {k: np.array(v, float) for k, v in changes.items()}
                       for s in check.STEPS}}


def test_gaps_by_the_worst_leaf_against_the_median_floor():
    want = _readings([[2.0], [1.0]], {"a": [1.0], "b": [2.0], "c": [1e-6]},
                     {"a": [1.0], "b": [2.0], "c": [1e-4]})
    got = _readings([[2.0], [1.01]], {"a": [1.0], "b": [2.2], "c": [0.0]},
                    {"a": [1.05], "b": [2.0], "c": [0.0]}, (1.0, 2.5))
    out = check.gaps(got, want)
    assert set(out) == set(check.NUMBERS)
    for s in check.STEPS:
        assert out[f"{s}_loss"] == pytest.approx(0.01)
        # leaf c reads 1e-6 against the median 1.0: the floor is the median
        assert out[f"{s}_grad"] == pytest.approx(0.2 / 2.0)
        # leaves a, b, c read 0, 0.1, 1e-6 / 1.0: the median leaf 1e-6
        assert out[f"{s}_grad_med"] == pytest.approx(1e-6)
        # c's gradient is under 1e-3 of the median: left out of the change
        assert out[f"{s}_change"] == pytest.approx(0.05)
    for s, ts in check.HANDOFFS.items():
        for t in ts:
            assert out[f"{s}_{t}"] == pytest.approx(0.5 / 2.0)
    limits = {"step2_loss": 0.02, "step3_grad": 0.2, "prior_change": 0.1}
    ok, rows = check.judge(out, limits)
    assert ok and [r[0] for r in rows] == ["prior_change", "step2_loss",
                                           "step3_grad"]
    assert not check.judge(out, {**limits, "step1_loss": 0.005})[0]
