"""The system under test: the port's trainer for a cell, driven through
its own per-step runners in the order `fit` calls them.

traffic "sequential": `gan2shape_torch.core.trainer.Trainer` (cli.train's
default, one image after another); traffic "instances":
`gan2shape_torch.parallel.sharding.InstanceParallelTrainer` (N images at
once, the nets stacked and vmapped).  The weights are the benchmark's
(`weights.py`), loaded over the trainer's own; the nets and Adam states
carry over from one instance to the next, as in `fit`."""

import numpy as np
import torch

from benchmark import weights
from benchmark.reference.model import GAN2Shape as ReferenceModel

STEPS = ("prior", "step1", "step2", "step3")


class System:
    def __init__(self, cell, seed, device):
        config = dict(cell.config)
        kind = cell.traffic["trainer"]
        self.n = cell.n_instances
        if kind == "sequential":
            from gan2shape_torch.core.trainer import Trainer
            if self.n != 1:
                raise ValueError("the sequential trainer takes one instance")
            self.trainer = Trainer(config, seed=seed, device=device)
        elif kind == "instances":
            from gan2shape_torch.parallel.sharding import \
                InstanceParallelTrainer
            self.trainer = InstanceParallelTrainer(
                config, n_instances=self.n, seed=seed, device=device)
        else:
            raise ValueError(f"unknown trainer {kind!r}")
        self.kind = kind
        self.config = config
        self.seed = seed
        self.device = self.trainer.device
        self.model = self.trainer.model
        self._load_weights()

    @torch.no_grad()
    def _load_weights(self):
        """The benchmark's weights into the program's frozen and trainable
        nets, in place (the trainer's optimizers keep their parameters)."""
        ref = ReferenceModel(self.config, device=self.device)
        weights.make_frozen(ref, self.seed)
        for name in ("generator", "discriminator", "lpips"):
            getattr(self.model, name).load_state_dict(
                getattr(ref, name).state_dict())
        for j in range(self.n):
            weights.make_nets(ref, self.seed, j)
            if self.kind == "sequential":
                self.model.nets.load_state_dict(ref.nets.state_dict())
            else:
                self.model.nets.load_instance(j, ref.nets)
        del ref

    def inputs(self, number):
        """The images and latents of the run's instance `number`."""
        c = self.config
        return weights.make_inputs(self.seed, number, self.n,
                                   c.get("image_size", 128),
                                   c.get("z_dim", 512), self.device)

    def prep(self, images, latents):
        """Take an instance: its depth priors from the trainer's prior
        generator on the host, as `fit` makes them, and everything on the
        card."""
        gen = self.trainer.prior_generator
        priors = np.stack([np.asarray(gen(images[j:j + 1].cpu().numpy())
                                      ).reshape(images.shape[2:])
                           for j in range(self.n)])
        self.images = images
        self.latents = latents
        priors = torch.as_tensor(priors, device=self.device)
        self.priors = priors[0] if self.kind == "sequential" else priors

    def handoff(self, step):
        """What step `step`'s block hands to the next step, as a callable
        (None for a step that hands nothing on)."""
        if step == "step1":
            return lambda: self.collected
        if step == "step2":
            return lambda: self.collected2
        return None

    def run(self, step, n_iters):
        """One block: `n_iters` iterations of `step` through the trainer's
        runner.  Returns its list of per-iteration (N,) loss tensors."""
        t = self.trainer
        if step == "prior":
            return t.run_prior(self.images, self.priors, n_iters)
        if step == "step1":
            self.collected, losses = t.run_step1(self.images, n_iters)
            return losses
        if step == "step2":
            self.collected2, losses = t.run_step2(
                self.images, self.latents, self.collected, n_iters)
            return losses
        if step == "step3":
            return t.run_step3(self.images, self.latents, self.collected2,
                               n_iters)
        raise ValueError(step)
