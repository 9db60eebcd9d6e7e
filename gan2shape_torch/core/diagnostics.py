"""Gradient-flow diagnostics for `--debug`: the global L2 norm of each
net's gradient, and a log line per net (a warning where it is zero)."""

import logging

import torch

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
