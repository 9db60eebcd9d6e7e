"""What a new GAN architecture, a span's device time and a kernel's
roofline are added as: files found by name.  The reference GAN picked by
the configuration (`reference/gans/`), the frozen weights bit-equal to
those the harness drew before the registry, `spans.device_ms` and
`spans.cover_pct` on hand-made traces, and the roofline registry
(`kernels/`): the calls `kernels_roofline` records and its value unchanged
beside the epilogue's entry, whose bytes are counted here by hand."""

import hashlib
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import roofline, spec, trace as tracing, weights, window
from benchmark.reference import gans
from benchmark.reference.model import GAN2Shape as ReferenceModel

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


# ---------------- the reference GAN, picked by the configuration ----------

def test_the_default_architecture_is_stylegan2():
    assert gans.of({}) is gans.load("stylegan2")
    assert gans.of({"gan_arch": "stylegan2"}) is gans.load()
    g, d = gans.load().build({"gan_size": 64, "z_dim": 32,
                              "channel_multiplier": 1})
    assert g.n_mlp == 8 and g.style_dim == 32 and g.size == 64
    assert type(d).__name__ == "Discriminator"
    assert "stylegan2" in gans.names()


def test_an_unknown_architecture_names_the_files_there_are():
    with pytest.raises(ValueError, match=r"stylegan2") as err:
        gans.of({"gan_arch": "stylegan9"})
    assert "stylegan9" in str(err.value)
    with pytest.raises(ValueError):
        gans.load("__init__")


TOY = '''"""A toy GAN: one seeded conv a side and one frozen random buffer."""

import torch
import torch.nn as nn

from ..layers import Conv2d


class ToyGenerator(nn.Module):
    def __init__(self, size, style_dim):
        super().__init__()
        self.size, self.style_dim, self.n_mlp = size, style_dim, 2
        self.conv = Conv2d(3, 3, 3, padding=1)
        self.register_buffer("fixed", torch.zeros(1, 3, size, size))


class ToyDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 4, 3, padding=1)


def build(config):
    return (ToyGenerator(config["gan_size"], config["z_dim"]),
            ToyDiscriminator())


def draw_buffers(generator, gen, device):
    generator.fixed.copy_(torch.randn(generator.fixed.shape, generator=gen,
                                      device=device))
'''

PROBE = '''
import json
from benchmark import spec, weights
from benchmark.reference.model import GAN2Shape
conf = dict(spec.load_cell("face128-seq").config, image_size=64,
            gan_size=64, z_dim=16, gan_arch="toy")
m = GAN2Shape(conf, device="cpu")
weights.make_frozen(m, 7)
print(json.dumps({"generator": type(m.generator).__name__,
                  "discriminator": type(m.discriminator).__name__,
                  "n_mlp": m.generator.n_mlp,
                  "buffer": float(m.generator.fixed.abs().sum()),
                  "weight": float(m.discriminator.conv.weight.abs().sum())}))
'''


def test_a_new_architecture_is_a_new_file(tmp_path):
    """A copy of the harness with `reference/gans/toy.py` added and no other
    edit builds a reference model on the toy GAN and draws its weights and
    its buffer from the seed."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "benchmark" / "reference" / "gans" / "toy.py").write_text(TOY)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["generator"] == "ToyGenerator"
    assert got["discriminator"] == "ToyDiscriminator"
    assert got["n_mlp"] == 2 and got["buffer"] > 0 and got["weight"] > 0


# sha256 of the generator's, discriminator's and LPIPS's state_dicts after
# make_frozen(seed 2**31 + 11) on the CPU, recorded from the harness before
# the GAN registry
FROZEN_DIGESTS = {
    "face128-seq":
        "1931b5f55ed42fed87eecc33a9bde78257b626bfb0b6ddfd4cae2d4f82f12bf5",
    "car512-n8":
        "5396f3c9fa62a726d8ebbd0ea1f8cd54877e1c2fc8bdb15a93deaea1f652f2c3",
}


@pytest.mark.parametrize("cell", sorted(FROZEN_DIGESTS))
def test_frozen_weights_are_those_drawn_before_the_registry(cell):
    model = ReferenceModel(spec.load_cell(cell).config, device="cpu")
    weights.make_frozen(model, 2 ** 31 + 11)
    h = hashlib.sha256()
    for part in ("generator", "discriminator", "lpips"):
        for k, v in getattr(model, part).state_dict().items():
            h.update(f"{part}.{k}".encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    assert h.hexdigest() == FROZEN_DIGESTS[cell]


# ---------------- device time by program span ----------------

def _event(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _note(name, start, end):
    return _event("user_annotation", name, start, end - start)


def _launch(corr, host, start, end, name="k", tid=1, cat="cuda_runtime"):
    """A launch call on the host at `host` and its kernel on the device."""
    return [_event(cat, "cudaLaunchKernel", host, 1, corr, tid),
            _event("kernel", name, start, end - start, corr, tid=7)]


# a step-2 block 0-200 us of two iterations; spans on the main thread
SPANS = [_note("g2s.stage", 0, 300), _note("g2s.step2", 0, 200),
         _note("g2s.step2.forward", 10, 60),
         _note("g2s.render.warp", 20, 30),       # nested in forward
         _note("g2s.step2.backward", 60, 120),
         _note("g2s.step2.backward", 130, 150),   # nested in the one below
         _note("g2s.step2.backward", 125, 180),
         _note("g2s.step3", 200, 300), _note("g2s.step2.forward", 210, 250)]
LAUNCHES = (
    _launch(1, 12, 15, 25)                       # forward: 10 us
    + _launch(2, 25, 25, 35)                     # under the nested render
    + _launch(3, 40, 30, 40, tid=1)              # forward, overlaps #2: 5
    + _launch(4, 70, 70, 100, tid=2)             # backward, autograd thread
    + _launch(5, 80, 90, 110, tid=2, cat="cuda_driver")  # side stream
    + _launch(6, 140, 140, 150, tid=2)           # inside both nested spans
    + _launch(7, 122, 150, 160)                  # between spans: uncovered
    + _launch(8, 230, 230, 240))                 # step 3's block: not read
KERNEL_LOST = [_event("kernel", "lost", 185, 10, 99)]  # no launch recorded


def _run(events):
    w = window.Window()
    w.blocks = [{"step": "step2", "n": 2, "profiled": True},
                {"step": "step3", "n": 1, "profiled": True},
                {"step": "step2", "n": 5, "profiled": False}]
    return SimpleNamespace(trace=tracing.parse(events), window=w)


def test_parse_keeps_the_launch_time_of_each_activity():
    t = tracing.parse(SPANS + LAUNCHES + KERNEL_LOST)
    assert len(t["activities"]) == 9
    assert t["launched"][:3] == [(12, 15, 25, "k"), (25, 25, 35, "k"),
                                 (40, 30, 40, "k")]
    assert len(t["launched"]) == 8  # the lost kernel has no launch
    assert [a[:3] for a in t["activities"][:2]] == [(15, 25, "k"),
                                                    (25, 35, "k")]


@pytest.mark.parametrize("prefix", ["", "seq."])
def test_device_ms_by_the_launch_inside_the_span(prefix):
    r = _run(SPANS + LAUNCHES + KERNEL_LOST)
    fwd = spec.load_reader(prefix + "device_ms.step2.forward")(r)
    bwd = spec.load_reader(prefix + "device_ms.step2.backward")(r)
    # forward: 15-25, 25-35, 30-40 as one union of 25 us; two iterations
    assert fwd == pytest.approx(25 / 2 / 1e3)
    # backward: the autograd thread's 70-100 and the side stream's 90-110
    # (union 40 us), and 140-150 once though two backward spans hold it
    assert bwd == pytest.approx(50 / 2 / 1e3)
    # the blocks' busy: 15-40, 70-110, 140-160, 185-195 = 95 us; the spans
    # cover 75 of it (#7's launch lies between spans, the lost kernel has
    # no launch)
    cover = spec.load_reader(prefix + "span_cover_pct.step2")(r)
    assert cover == pytest.approx(100 * 75 / 95)


def test_device_ms_reads_none_without_spans_or_launches():
    no_spans = _run([e for e in SPANS if "step2." not in e["name"]]
                    + LAUNCHES)
    no_launch = _run(SPANS + [e for e in LAUNCHES
                              if e["cat"] == "kernel"])
    untraced = SimpleNamespace(trace=None, window=no_spans.window)
    for r in (no_spans, no_launch, untraced):
        for m in ("device_ms.step2.forward", "device_ms.step2.backward",
                  "span_cover_pct.step2"):
            assert spec.load_reader(m)(r) is None, m


# ---------------- the roofline registry ----------------

def test_the_registry_records_the_calls_it_recorded_before():
    """`kernels_roofline` takes the four raster and window wrappers it
    wrapped before the registry, with the same kernels; the epilogue's
    entry is of another metric."""
    entries = roofline.kernel_entries()
    mine = {(e.MODULE, attr) for e in entries.values()
            if e.METRIC == "kernels_roofline" for attr in e.CALLS}
    assert mine == {("gan2shape_torch.ops.rasterize", "raster_place"),
                    ("gan2shape_torch.ops.rasterize", "raster_tests"),
                    ("gan2shape_torch.ops.gather_window", "fetch2x2"),
                    ("gan2shape_torch.ops.gather_window", "splat2x2")}
    kernels = {k for e in entries.values() if e.METRIC == "kernels_roofline"
               for k in e.KERNELS}
    assert kernels == {"place_collide_kernel", "place_write_kernel",
                       "tests_kernel", "fetch2x2_kernel",
                       "splat_amax_kernel", "splat2x2_kernel",
                       "splat_convert_kernel"}
    bias = entries["bias_act"]
    assert (bias.MODULE, set(bias.CALLS), bias.METRIC) == (
        "gan2shape_torch.ops.fused_act", {"_forward", "_grad"},
        "bias_act_roofline")
    for e in entries.values():
        module = importlib.import_module(e.MODULE)
        for attr in e.CALLS:
            assert callable(getattr(module, attr)), (e.MODULE, attr)


class _OnCard:
    """A CPU tensor that says it is on the card, for the recording
    wrappers."""
    is_cuda = True

    def __init__(self, t):
        self.t = t

    def __getattr__(self, k):
        return getattr(self.t, k)


def test_recording_wraps_each_entry_and_restores_it(monkeypatch):
    from gan2shape_torch.ops import fused_act, gather_window, rasterize
    stubs = [(rasterize, "raster_place"), (rasterize, "raster_tests"),
             (gather_window, "fetch2x2"), (gather_window, "splat2x2"),
             (fused_act, "_forward"), (fused_act, "_grad")]
    for mod, attr in stubs:
        monkeypatch.setattr(mod, attr, lambda *a, **k: "done")
    real = {attr: getattr(mod, attr) for mod, attr in stubs}
    x = torch.zeros(2, 4, 8, 8)
    iy = torch.zeros(2, 64, dtype=torch.int32)
    calls = []
    with roofline.recording_calls(calls):
        assert fused_act._forward(_OnCard(x), None, None, None, None, 0.2,
                                  2 ** 0.5, want_mask=True) == "done"
        fused_act._grad(_OnCard(x), None, None, None, None, True, False,
                        False, False, 0.2, 2 ** 0.5)
        gather_window.fetch2x2(_OnCard(x), iy, iy)
        gather_window.fetch2x2(x, iy, iy)     # on the CPU: not recorded
    assert [c[0] for c in calls] == ["bias_act", "bias_act", "fetch2x2"]
    bps = roofline.HBM_BYTES_PER_S
    assert calls[0][1] * bps == pytest.approx(2 * 512 * 4 + 64)
    assert calls[1][1] * bps == pytest.approx(2 * 512 * 4 + 64)
    assert calls[2][1] * bps == pytest.approx(
        64 * 8 * 4 + 2 * 128 * 4 + 2 * 16 * 64 * 4)
    assert {attr: getattr(mod, attr) for mod, attr in stubs} == real


def test_bias_act_bytes_counted_by_hand():
    """Forward: x read, y written, a mask bit an element (16 bytes a
    128-element chunk) where the mask is written or read.  Backward: g and
    the mask read, x read for grad_demod, grad_x written, the gradient
    before the demodulation written for grad_noise unless it is grad_x."""
    e = roofline.kernel_entries()["bias_act"]
    fwd, grad = e.CALLS["_forward"], e.CALLS["_grad"]
    # car512-n8's 512^2 layer: 64 images of 64 channels, f32
    x = torch.empty(64, 64, 512, 512, device="meta")
    n = 64 * 64 * 512 * 512
    assert fwd(x, None, None, None, None, 0.2, 1.4, want_mask=True) == \
        8 * n + n // 8
    assert fwd(x, None, None, None, None, 0.2, 1.4, want_mask=False) == 8 * n
    assert fwd(x, None, None, None, x, 0.2, 1.4, want_mask=False) == \
        8 * n + n // 8
    demod = torch.empty(64, 64, device="meta")
    # the E2 row: grad_x and grad_demod
    assert grad(x, None, x, demod, None, True, True, False, False, 0.2,
                1.4) == 12 * n + n // 8
    assert grad(x, None, None, demod, None, True, False, False, True, 0.2,
                1.4) == 8 * n + n // 8
    # grad_noise with demod: its own pre-demodulation buffer
    assert grad(x, None, None, demod, (1, 1, 512, 512), True, False, True,
                False, 0.2, 1.4) == 12 * n + n // 8
    # without demod grad_x is that buffer
    assert grad(x, None, None, None, (1, 1, 512, 512), True, False, True,
                False, 0.2, 1.4) == 8 * n + n // 8
    # bf16, a plane of 100 elements: two chunks of mask
    y = torch.empty(1, 1, 10, 10, dtype=torch.bfloat16, device="meta")
    assert fwd(y, None, None, None, None, 0.2, 1.4, want_mask=True) == \
        2 * 100 * 2 + 16


def test_kernels_roofline_unchanged_beside_the_epilogue():
    """A profiled stage with the raster and window kernels and the
    epilogue's: `kernels_roofline` reads what it read before the registry,
    from its own calls and kernels only, and `bias_act_roofline` from the
    epilogue's."""
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    t = tracing.parse([
        ev("user_annotation", "g2s.stage", 0, 100),
        ev("kernel", "void tests_kernel<3, 16>(short const*)", 5, 10),
        ev("kernel", "fetch2x2_kernel(float const*)", 35, 10),
        ev("kernel", "void bias_act_kernel<float>(float const*)", 50, 20),
        ev("kernel", "void bias_act_grad_kernel<float>(float const*)", 70,
           8),
        ev("kernel", "void bias_sum_kernel<float>(float const*)", 78, 2),
    ])
    w = window.Window()
    w.kernel_calls = [("raster_tests", 5e-6), ("bias_act", 12e-6),
                      ("fetch2x2", 2.5e-6), ("bias_act", 6e-6)]
    run = SimpleNamespace(trace=t, window=w)
    before = 100.0 * (5e-6 + 2.5e-6) / ((10 + 10) / 1e6)
    assert spec.load_reader("kernels_roofline")(run) == before
    assert spec.load_reader("seq.kernels_roofline")(run) == before
    assert spec.load_reader("bias_act_roofline")(run) == pytest.approx(
        100.0 * 18e-6 / 30e-6)
    assert spec.load_reader("seq.bias_act_roofline")(run) == \
        spec.load_reader("bias_act_roofline")(run)


def test_a_new_kernel_entry_is_a_new_file(tmp_path):
    """An entry added to a copy of the registry is recorded under its own
    metric and leaves `kernels_roofline`'s entries as they were."""
    here = tmp_path / "kernels"
    shutil.copytree(BENCH / "kernels", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "modulate.py").write_text(
        'MODULE = "gan2shape_torch.ops.fused_act"\n'
        'KERNELS = ("modulate_kernel",)\n'
        'METRIC = "modulate_roofline"\n'
        'CALLS = {"bias_act_plain": lambda x, *a, **k: 4 * x.numel()}\n')
    entries = roofline.kernel_entries(here)
    assert entries["modulate"].METRIC == "modulate_roofline"
    assert roofline.is_port_kernel("void modulate_kernel<float>()",
                                   "modulate_roofline", here)
    assert not roofline.is_port_kernel("void modulate_kernel<float>()",
                                       "kernels_roofline", here)


def test_cover_pct_stays_within_the_launched_work():
    """A kernel launched inside the block whose device interval the host's
    clock puts a little before the block's start (the two clocks differ by
    microseconds) counts on both sides: the share cannot pass 100%."""
    early = _launch(11, 15, -3, 5)                # launched in forward
    r = _run(SPANS + early + _launch(12, 20, 20, 30))
    assert spec.load_reader("span_cover_pct.step2")(r) == pytest.approx(100)
