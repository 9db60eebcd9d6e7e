"""How `correct` is decided: the program's first steps against the plain
reference (`reference/`).

Set-up drives the program's trainer from the seed through `check_iters`
iterations each of the prior, step 1, step 2 and step 3, through the
trainer's own per-step runners (the window's call and feed), on images
that all differ, and keeps what each step read (`ProgramProbe`): the
per-instance losses, the first gradient of every leaf as its Adam took it
(its first moment after one update over 1 - beta1, so with the weight
decay), how far each leaf moved over the step's iterations, and what the
step handed to the next.  The same trainer then goes on into the window.
Once the window has closed and the program is freed, the reference
follows (`reference_readings`).

It follows step by step from the program's state.  Adam's first updates
are lr * g / (|g| + eps): an entry of g that rounding can flip flips its
update, so two correct runs that round differently part after a few
updates, and a chained reference would judge that parting, not the step.
So the prior starts from the weights the reference makes itself from the
seed (the start, checked on its own), and each later step from the nets
the program held when the step began and what the previous step handed
it (kept on the host).  What a step hands on is checked against what the
reference computes from the same start and the same weights: the
invariants of the nets the step began from, and the output of the trained
net at the weights the program's last iteration used (recorded by an
optimizer pre-step hook), so that Adam's parting of the weights drops out.

For each step (prior, step1, step2, step3), by the worst instance,
iteration and leaf:
  <step>_loss    |program loss - reference loss| / |reference loss|;
  <step>_grad    |‖g‖ program - ‖g‖ reference| / max(‖g‖ reference, the
                 median leaf's ‖g‖ reference), of each leaf's first
                 gradient;
  <step>_change  the same of each leaf's change over the step's
                 iterations, leaving out the leaves whose reference
                 gradient is under 1e-3 of the median leaf's (they move
                 under Adam by round-off alone);
  <step>_grad_med  the same first-gradient gap of the median leaf (the
                 worst instance's): steady from seed to seed where the
                 worst leaf is not (a seed whose method is ill-conditioned
                 there sends a few leaves' gaps to the control's level);
and for each tensor that step 1 or step 2 hands on (`HANDOFFS`)
  <step>_<tensor>  max |program - reference| / max |reference|, by the
                 worst instance: step 1's normal, lights, depth (invariants
                 of the nets it began from) and albedo, step 2's projected
                 samples and their masks.
The numbers compared are those `limits/<cell>.json` gives a limit."""

import numpy as np
import torch
from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                   register_optimizer_step_pre_hook)

from benchmark import weights
from benchmark.reference.model import GAN2Shape as ReferenceModel
from benchmark.reference.steps import STEP_NETS, block, prior_of

STEPS = ("prior", "step1", "step2", "step3")
KINDS = ("loss", "grad", "change")
HANDOFFS = {"step1": ("normal", "light_a", "light_b", "albedo", "depth"),
            "step2": ("projected", "mask")}
NUMBERS = tuple(f"{s}_{k}" for s in STEPS for k in KINDS) + tuple(
    f"{s}_{t}" for s, ts in HANDOFFS.items() for t in ts) + tuple(
    f"{s}_grad_med" for s in STEPS)
QUIET_LEAF = 1e-3
NETS = ("lighting", "viewpoint", "depth", "albedo", "offset_encoder")


def program_leaves(nets, step):
    """{leaf name: (parameter, instances stacked on its first axis or 0)}
    of the program's nets that `step` trains: plain modules, or the
    instance-parallel trainer's stacked nets (`names`, `stacked`)."""
    leaves = {}
    for net in STEP_NETS[step]:
        module = nets[net]
        if hasattr(module, "stacked"):
            for k, p in zip(module.names, module.stacked):
                leaves[f"{net}.{k}"] = (p, module.n)
        else:
            for k, p in module.named_parameters():
                leaves[f"{net}.{k}"] = (p, 0)
    return leaves


def _norms(t, n):
    """Per-instance norms: (n,) of an (n, ...) stack, (1,) of a plain
    tensor."""
    return t.detach().reshape(max(n, 1), -1).norm(dim=1)


def _host(tensors):
    return tuple(x.detach().cpu().clone() for x in tensors)


class ProgramProbe:
    """Records what the program's first steps read.  `block(step, run,
    handoff)` wraps one runner call; an optimizer post-step hook reads the
    first moment of the first update of each optimizer stepped inside, and
    a pre-step hook keeps the trained nets' weights as the last iteration
    used them (what that iteration handed on was computed with them)."""

    def __init__(self, nets, n):
        self.nets = nets
        self.n = n
        self.readings = {"loss": {}, "grad": {}, "change": {}, "nets": {},
                         "last": {}, "handoff": {}}
        self._step = None
        self._seen = set()

    def _before_step(self, opt, args, kwargs):
        if self._step in HANDOFFS:
            self.readings["last"][self._step] = self._instance_states(
                STEP_NETS[self._step])

    def _after_step(self, opt, args, kwargs):
        if self._step is None or id(opt) in self._seen:
            return
        self._seen.add(id(opt))
        ids = {id(p): (k, n) for k, (p, n)
               in program_leaves(self.nets, self._step).items()}
        beta1 = opt.param_groups[0]["betas"][0]
        grads = {}
        for group in opt.param_groups:
            for p in group["params"]:
                if id(p) in ids and p in opt.state:
                    k, n = ids[id(p)]
                    grads[k] = (_norms(opt.state[p]["exp_avg"], n)
                                / (1 - beta1))
        self.readings["grad"][self._step] = grads

    def _instance_states(self, nets=NETS):
        """Each instance's {net: state_dict} of `nets` on the host."""
        out = []
        for j in range(self.n):
            state = {}
            for net in nets:
                module = self.nets[net]
                sd = (module.instance_state_dict(j)
                      if hasattr(module, "stacked") else module.state_dict())
                state[net] = {k: v.detach().cpu().clone()
                              for k, v in sd.items()}
            out.append(state)
        return out

    def block(self, step, run, handoff=None):
        """Run `run()` (a runner call returning its list of per-iteration
        (n,) losses) as step `step`'s first block, and record it;
        `handoff()` gives what the block handed on."""
        leaves = program_leaves(self.nets, step)
        self.readings["nets"][step] = self._instance_states()
        before = {k: p.detach().clone() for k, (p, _) in leaves.items()}
        self._step = step
        hooks = (register_optimizer_step_post_hook(self._after_step),
                 register_optimizer_step_pre_hook(self._before_step))
        try:
            losses = run()
        finally:
            for hook in hooks:
                hook.remove()
            self._step = None
        self.readings["loss"][step] = torch.stack(
            [x.detach().reshape(-1) for x in losses])
        self.readings["change"][step] = {
            k: _norms(p - before[k], n) for k, (p, n) in leaves.items()}
        if handoff is not None:
            self.readings["handoff"][step] = _host(handoff())
        return losses

    def host(self):
        """The readings on the host, numpy where they are numbers: loss
        [step] (iters, N), grad / change[step][leaf] (N,); the nets each
        step began from, the trained nets as the last iteration of steps 1
        and 2 used them, and the hand-offs as they were."""
        r = self.readings
        return {"loss": {s: v.cpu().numpy() for s, v in r["loss"].items()},
                "grad": {s: {k: v.cpu().numpy() for k, v in d.items()}
                         for s, d in r["grad"].items()},
                "change": {s: {k: v.cpu().numpy() for k, v in d.items()}
                           for s, d in r["change"].items()},
                "nets": r["nets"], "last": r["last"],
                "handoff": r["handoff"]}


def first_steps(system, n_iters, synchronize=lambda: None):
    """Drive the system's trainer from the seed through `n_iters`
    iterations of each step on the check's inputs (number 0), through its
    own runners, recording them.  Returns (the probe's readings on the
    host, the images, the latents), the inputs on the host."""
    images, latents = system.inputs(0)
    system.prep(images, latents)
    probe = ProgramProbe(system.model.nets, system.n)
    for step in STEPS:
        probe.block(step, lambda: system.run(step, n_iters),
                    system.handoff(step))
    synchronize()
    return probe.host(), images.cpu(), latents.cpu()


def _rows(tensors, j, n):
    """Instance j's rows of each tensor of an N-instance hand-off."""
    return tuple(x.reshape(n, -1, *x.shape[1:])[j] for x in tensors)


def reference_readings(config, seed, images, latents, n_iters, device,
                       program, tf32=False, half_batch=None):
    """The reference's readings of each instance, stacked like the
    program's.  The prior from the reference's own seeded nets; steps 1-3
    from the nets the program's instance held when the step began
    (`program["nets"]`), step 2 and 3 from the program's hand-offs; step
    2's samples are instance j's rows of the draws of all N
    (`instance_range`) from a sampler seeded as the trainer's (seed + 1).
    What steps 1 and 2 hand on is computed again at the weights the
    program's last iteration used (`program["last"]`).  TF32 in cuBLAS
    and cuDNN as `tf32` says (off: the reference; on: its control);
    restored after.  `half_batch` ("step2" or "step3") plants a fault:
    that step takes half of its samples."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    n = images.shape[0]
    runs = []
    try:
        model = ReferenceModel(config, device=device)
        weights.make_frozen(model, seed)

        def to_dev(xs):
            return tuple(x.to(device) for x in xs)

        for j in range(n):
            model.instance_range = (j, n)
            image = images[j:j + 1].to(device)
            latent = latents[j:j + 1].to(device)
            weights.make_nets(model, seed, j)
            r = {"prior": block(model, config, "prior", image, latent,
                                n_iters, prior=prior_of(config, image))}
            for step in ("step1", "step2", "step3"):
                for net, sd in program["nets"][step][j].items():
                    model.nets[net].load_state_dict(sd)
                kw = {"half_batch": half_batch == step}
                if program["last"].get(step):  # none where nothing stepped
                    kw["last"] = program["last"][step][j]
                if step == "step2":
                    kw["collected"] = to_dev(_rows(
                        program["handoff"]["step1"], j, n))
                    kw["sampler"] = torch.Generator(
                        device=device).manual_seed(seed + 1)
                if step == "step3":
                    kw["collected2"] = to_dev(_rows(
                        program["handoff"]["step2"], j, n))
                r[step] = block(model, config, step, image, latent, n_iters,
                                **kw)
            runs.append(r)
        del model
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return {"loss": {s: np.array([r[s]["loss"] for r in runs]).T
                     for s in STEPS},
            "grad": {s: {k: np.array([r[s]["grad"][k] for r in runs])
                         for k in runs[0][s]["grad"]} for s in STEPS},
            "change": {s: {k: np.array([r[s]["change"][k] for r in runs])
                           for k in runs[0][s]["change"]} for s in STEPS},
            "handoff": {s: [_host(r[s]["handoff"]) for r in runs]
                        for s in HANDOFFS}}


def _leaf_gap(got, want, keep=None, over_leaves=np.max):
    """|‖got‖ - ‖want‖| / max(‖want‖, median leaf's ‖want‖) of each leaf
    (in `keep`, each (N,) of booleans, where given), taken over the leaves
    by `over_leaves` and then the worst instance; infinite where the
    program read no such leaf."""
    names = sorted(want)
    if any(k not in got for k in names):
        return float("inf")
    w = np.stack([want[k] for k in names])            # (leaves, N)
    g = np.stack([got[k] for k in names])
    floor = np.maximum(w, np.median(w, axis=0, keepdims=True))
    gap = np.abs(g - w) / np.maximum(floor, 1e-30)
    if keep is not None:
        gap = np.where(np.stack([keep[k] for k in names]), gap, 0.0)
    return float(over_leaves(gap, axis=0).max())


def gaps(got, want):
    """{number: reading} of the program's readings against the
    reference's."""
    out = {}
    for s in STEPS:
        lw = want["loss"][s]
        out[f"{s}_loss"] = float((np.abs(got["loss"][s] - lw)
                                  / np.maximum(np.abs(lw), 1e-30)).max())
        gw = want["grad"][s]
        median = np.median(np.stack(list(gw.values())), axis=0)
        keep = {k: v >= QUIET_LEAF * median for k, v in gw.items()}
        out[f"{s}_grad"] = _leaf_gap(got["grad"].get(s, {}), gw)
        out[f"{s}_grad_med"] = _leaf_gap(got["grad"].get(s, {}), gw,
                                         over_leaves=np.median)
        out[f"{s}_change"] = _leaf_gap(got["change"].get(s, {}),
                                       want["change"][s], keep)
    for s, names in HANDOFFS.items():
        for i, t in enumerate(names):
            out[f"{s}_{t}"] = _handoff_gap(got["handoff"].get(s),
                                           want["handoff"][s], i)
    return out


def _handoff_gap(got, want, i):
    """Worst max |got - want| / max |want| over the instances of the i-th
    tensor handed on (`want` holds one tuple an instance, `got` too or the
    program's N-instance tuple); infinite where nothing, or a tensor of
    another shape, was handed on."""
    if got is None:
        return float("inf")
    n = len(want)
    worst = 0.0
    for j, w in enumerate(want):
        mine = got[j] if isinstance(got, list) else _rows(got, j, n)
        g, r = mine[i], w[i]
        if g.shape != r.shape:
            return float("inf")
        scale = max(float(r.abs().max()), 1e-30)
        worst = max(worst, float((g - r).abs().max()) / scale)
    return worst


def judge(readings, limits):
    """(correct, [(name, reading, limit)]): every number that `limits`
    names at or under its limit (a missing reading is not correct)."""
    rows = [(k, readings.get(k), limits[k]) for k in NUMBERS if k in limits]
    ok = all(v is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
