"""The port's spans (`core/diagnostics.span`): a tiny `Trainer` and a tiny
`InstanceParallelTrainer` (N=2) stage, at 64 px with a 32-px GAN, recorded
by `diagnostics.profile_trace` on the CPU, emit every phase span of the
trainer and the renderer, nested in order, under names that no harness
block uses; with no profiler running, a stage enters no span at all."""

import json

import pytest
import torch

from gan2shape_torch.core import diagnostics
from gan2shape_torch.core.trainer import Trainer
from gan2shape_torch.parallel import InstanceParallelTrainer

S = 64
CFG = {
    "image_size": S, "gan_size": 32, "z_dim": 512,
    "channel_multiplier": 1, "category": "face", "disc_ftr_num": 3,
    "rot_center_depth": 1.0, "fov": 10, "n_proj_samples": 1,
    "n_epochs_prior": 1, "learning_rate": 1e-4, "prior_name": "box",
}
STAGE = {"step1": 2, "step2": 1, "step3": 2}
PHASES = ("forward", "backward", "optimizer")
# the names the benchmark's own blocks carry, matched exactly there
HARNESS = {"g2s.prep", "g2s.prior", "g2s.step1", "g2s.step2", "g2s.step3",
           "g2s.stage"}
RENDER = {"g2s.render.warp", "g2s.render.grid", "g2s.render.view"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trainer(n):
    if n == 1:
        return Trainer(CFG, seed=0, device="cpu")
    return InstanceParallelTrainer(CFG, n_instances=n, seed=0, device="cpu")


def _inputs(n):
    g = torch.Generator().manual_seed(1)
    images = torch.rand(n, 3, S, S, generator=g) * 2 - 1
    latents = torch.randn(n, CFG["z_dim"], generator=g)
    priors = torch.ones(n, S, S)
    return images, latents, priors[0] if n == 1 else priors


def _run(trainer, n):
    images, latents, priors = _inputs(n)
    trainer.run_prior(images, priors, 1)
    trainer.run_stage(images, latents, STAGE)


@pytest.fixture(scope="module", params=[1, 2], ids=["trainer", "instances"])
def spans(request, tmp_path_factory):
    """(start, end, name) of every `g2s.` annotation a traced stage
    recorded, by start."""
    n = request.param
    trainer = _trainer(n)
    logdir = tmp_path_factory.mktemp(f"trace{n}")
    with diagnostics.profile_trace(str(logdir)):
        _run(trainer, n)
    events = json.loads((logdir / "trace_rank0.json").read_text())
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for e in events["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("g2s."))


def test_a_stage_emits_every_span(spans):
    want = {f"g2s.{s}.{p}" for s in ("prior", "step1", "step2", "step3")
            for p in PHASES}
    want |= {"g2s.step1.invariants", "g2s.step2.invariants",
             "g2s.step2.sample"} | RENDER
    assert {n for _, _, n in spans} == want


def test_phase_spans_nest_in_order_inside_their_iterations(spans):
    """Each iteration is forward, backward, optimizer (step 2's pool draw
    before its forward), one after the other; the invariants open each
    block; every renderer span sits inside a phase span of the trainer."""
    outer = [s for s in spans if s[2] not in RENDER]
    for a, b in zip(outer, outer[1:]):
        assert a[1] <= b[0], (a, b)
    order = [n[len("g2s."):] for _, _, n in outer]
    one = [f"{{}}.{p}" for p in PHASES]
    assert order == (
        [x.format("prior") for x in one]
        + ["step1.invariants"] + [x.format("step1") for x in one] * 2
        + ["step2.invariants", "step2.sample"]
        + [x.format("step2") for x in one]
        + [x.format("step3") for x in one] * 2)
    for s, e, n in spans:
        if n in RENDER:
            assert any(o[0] <= s and e <= o[1] for o in outer), n
    # step 3's forward renders twice: the image's view, the samples' views
    for s, e, n in outer:
        if n == "g2s.step3.forward":
            inside = sorted(r[2] for r in spans
                            if r[2] in RENDER and s <= r[0] <= e)
            assert inside == ["g2s.render.grid"] * 2 + [
                "g2s.render.warp"] * 2


def test_no_span_is_named_like_a_harness_block(spans):
    assert not {n for _, _, n in spans} & HARNESS


def test_without_a_profiler_a_stage_enters_no_span(monkeypatch):
    """Off, a span is the shared no-op context: no record_function is
    entered under a `g2s.` name."""
    entered = []
    real = torch.profiler.record_function

    def recording(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", recording)
    assert diagnostics.span("step3.forward") is diagnostics.span("other")
    _run(_trainer(1), 1)
    assert not [n for n in entered if n.startswith("g2s.")]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with diagnostics.span("step3.forward"):
            pass
    assert [n for n in entered if n.startswith("g2s.")] == [
        "g2s.step3.forward"]
