"""Gradient-flow diagnostics for `--debug` (the global L2 norm of each
net's gradient, and a log line per net, a warning where it is zero), a
profiler trace context and a per-block timer."""

import contextlib
import logging
import os
import time

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


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(logdir="results/profile", enabled=True):
    """A torch.profiler window (the host, and the card when there is one)
    written as a Chrome trace `trace_rank{r}.json` under `logdir`; yields
    the profiler (None when disabled, which does nothing)."""
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


class StepTimer:
    """Wall-clock time of named blocks, each ended by a synchronisation
    with the card when one is in use."""

    def __init__(self):
        self.records = []

    @contextlib.contextmanager
    def time(self, name, n_iters=1):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        dt = time.perf_counter() - t0
        self.records.append(
            {"name": name, "seconds": dt, "iters": n_iters,
             "iters_per_sec": n_iters / dt if dt > 0 else float("inf")})

    def summary(self):
        return self.records
