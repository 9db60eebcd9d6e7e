"""The measured window: the cut schedule, instance after instance, each
second charged to one term.

An instance is `prep` (new seeded images and latents on the card, their
depth priors) and then its blocks: the prior, then each stage's step 1,
step 2 and step 3, every count of the method's schedule divided by the
traffic's `cut` and rounded.  The card is synchronised before and after
each block, as `fit` reaches the host once a stage.  The window closes at
the first block boundary after `seconds`.  In a traced run, torch.profiler
covers the first instance's second stage, and the port's kernel wrappers
record their calls there."""

import time
from contextlib import nullcontext

import torch

from benchmark import roofline

STEPS = ("prior", "step1", "step2", "step3")
TERMS = ("prep",) + STEPS
PREFIX = "g2s."


def cut_schedule(traffic):
    """(prior iterations, [stage {step: iterations}]) of the cut schedule."""
    cut = traffic["cut"]
    sched = traffic["schedule"]

    def c(n):
        return max(1, round(n / cut))
    return c(sched["prior"]), [{k: c(v) for k, v in st.items()}
                               for st in sched["stages"]]


def full_counts(traffic):
    """{step: its iterations over the whole schedule}: C of instance_s."""
    sched = traffic["schedule"]
    counts = {"prior": sched["prior"]}
    for k in ("step1", "step2", "step3"):
        counts[k] = sum(st[k] for st in sched["stages"])
    return counts


def instance_blocks(traffic):
    """[(stage index or None, step, iterations)] of one instance."""
    prior, stages = cut_schedule(traffic)
    out = [(None, "prior", prior)]
    for i, st in enumerate(stages):
        out += [(i, k, st[k]) for k in ("step1", "step2", "step3")]
    return out


class Window:
    """The record of one window: `terms` (seconds per term), `blocks`
    ([{step, n, seconds, profiled, instance, stage}]), `instances` begun, `failed`
    instance-iterations (raised or non-finite), `wall` seconds."""

    def __init__(self):
        self.terms = dict.fromkeys(TERMS, 0.0)
        self.blocks = []
        self.instances = 0
        self.failed = 0
        self.attempted = 0
        self.errors = []
        self.wall = 0.0
        self.kernel_calls = []
        self.profiler = None   # running
        self.profiled = None   # stopped, to export

    def iterations(self, step, profiled=None):
        return sum(b["n"] for b in self.blocks if b["step"] == step
                   and (profiled is None or b["profiled"] == profiled))

    def seconds(self, step, profiled=None):
        return sum(b["seconds"] for b in self.blocks if b["step"] == step
                   and (profiled is None or b["profiled"] == profiled))

    def unprofiled_twin(self):
        """The seconds of the profiled stage's twin: the next stage of the
        same instance, which runs the same steps and counts without the
        profiler; None where the window closed before it ended or nothing
        was profiled."""
        mine = [b for b in self.blocks if b.get("profiled")]
        if not mine:
            return None
        inst, stage = mine[0]["instance"], mine[0]["stage"]
        twin = [b for b in self.blocks if b.get("instance") == inst
                and b.get("stage") == stage + 1]
        if [(b["step"], b["n"]) for b in twin] != [(b["step"], b["n"])
                                                    for b in mine]:
            return None
        return sum(b["seconds"] for b in twin)


def _non_finite(losses):
    if not losses:
        return 0
    return int((~torch.isfinite(torch.stack(
        [x.detach().reshape(-1) for x in losses]))).sum())


def run(system, traffic, seconds, synchronize, trace=False):
    """Drive the system for `seconds`; returns the Window.  Instance k of
    the window takes the inputs numbered k + 1 (0 is the check's)."""
    w = Window()
    blocks = instance_blocks(traffic)
    profile_stage = 1 if trace else None
    n = system.n
    synchronize()
    start = time.perf_counter()
    mark = start

    def charge(term):
        nonlocal mark
        now = time.perf_counter()
        w.terms[term] += now - mark
        mark = now
        return now

    done = False
    while not done:
        images, latents = system.inputs(w.instances + 1)
        system.prep(images, latents)
        synchronize()
        charge("prep")
        w.instances += 1
        for stage, step, iters in blocks:
            profiled = w.instances == 1 and stage == profile_stage
            if profiled and step == "step1":
                w.profiler = _start_profiler(w)
            t0 = mark
            try:
                with _annotate(step, profiled):
                    losses = system.run(step, iters)
                    synchronize()
                bad = _non_finite(losses)
            except Exception as exc:  # a failed block ends the window
                w.errors.append(f"{step}: {exc!r}")
                bad = iters * n
                done = True
            if profiled and step == "step3":
                _stop_profiler(w)
            end = charge(step)
            w.blocks.append({"step": step, "n": iters, "seconds": end - t0,
                             "profiled": profiled, "instance": w.instances,
                             "stage": stage})
            w.attempted += iters * n
            w.failed += bad
            if done or end - start >= seconds:
                done = True
                break
    if w.profiler is not None:  # the window closed inside the stage
        _stop_profiler(w)
        last, t0 = w.blocks[-1], mark
        last["seconds"] += charge(last["step"]) - t0
    w.wall = time.perf_counter() - start
    return w


def _annotate(step, on):
    """A profiler annotation around a profiled block; nothing otherwise."""
    return torch.profiler.record_function(PREFIX + step) if on \
        else nullcontext()


def _start_profiler(w):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    w._stage = torch.profiler.record_function(PREFIX + "stage")
    w._stage.__enter__()
    w._calls = roofline.recording_calls(w.kernel_calls)
    w._calls.__enter__()
    return prof


def _stop_profiler(w):
    w._calls.__exit__(None, None, None)
    w._stage.__exit__(None, None, None)
    w.profiler.stop()
    w.profiled = w.profiler
    w.profiler = None
