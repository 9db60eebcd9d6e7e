"""Gradient-flow diagnostics for `--debug` (the global L2 norm of each
net's gradient, and a log line per net, a warning where it is zero), the
program's spans, and a profiler trace context that records them."""

import contextlib
import logging
import os

import torch

from gan2shape_torch import distributed

log = logging.getLogger(__name__)


def grad_norms(nets, loss):
    """{net name: L2 norm of d loss / d its parameters} for a dict of
    modules; a parameter the loss does not reach counts as zero."""
    names = list(nets)
    params = [list(nets[n].parameters()) for n in names]
    grads = torch.autograd.grad(loss, [p for ps in params for p in ps],
                                allow_unused=True)
    out, i = {}, 0
    for name, ps in zip(names, params):
        sq = sum(float(torch.sum(g.float() ** 2)) for g in grads[i:i + len(ps)]
                 if g is not None)
        out[name] = sq ** 0.5
        i += len(ps)
    return out


def report_grad_norms(norms, step_name=""):
    for name, v in norms.items():
        if v == 0.0:
            log.warning("%s: net %r received ZERO gradient", step_name, name)
        else:
            log.info("%s: |grad %s| = %.3e", step_name, name, v)


SPAN_PREFIX = "g2s."
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name):
    """A profiler annotation `g2s.<name>` around a phase of the program,
    on the profiler's clock with the device's activities; while no torch
    profiler records, a shared no-op context that costs one check.  A
    span never synchronises and never touches the device."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(logdir="results/profile", enabled=True):
    """A torch.profiler window (the host, and the card when there is one)
    written as a Chrome trace `trace_rank{r}.json` under `logdir`, the
    program's spans among its annotations; yields the profiler (None when
    disabled, which does nothing)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_rank{distributed.rank()}.json")
    prof.export_chrome_trace(path)
    log.info("profile trace written to %s", path)
