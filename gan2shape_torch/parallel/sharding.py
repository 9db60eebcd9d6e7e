"""Instance-parallel training: N image instances, each with its own five
trainable nets, optimised at once on one device, or split over the ranks
of a process group (N / W on each).

Each net's parameters are stacked on a leading instance axis
(`StackedNets`) and mapped over a batch of N contiguous groups with
`torch.func.vmap` of `functional_call`: each layer of all N instances is one
grouped convolution.  The frozen GAN and LPIPS, the renderer and every
kernel run once on the flattened (N * B, ...) batch: B = 1 in the prior and
in steps 1 and 3, B = n_proj_samples for step 2's pseudo samples and step
3's projected ones.  Every loss is per instance (`GAN2Shape.n_instances`)
and the instances' losses are summed before the backward pass, so each
slice of a stacked parameter gets exactly its own instance's gradient; Adam
is elementwise and all instances step together, so one Adam over the
stacked tensors is N independent Adams.

The JAX package shards the instance axis over a device mesh; here over
the ranks of `mesh` (`distributed.make_mesh()`: the current process
group, one device a rank, launched by torchrun).  Rank r trains instances
[r N / W, (r + 1) N / W) with no collective at all: every rank draws the
nets of all N instances and step 2's samples of all N from the same seeded
generators and keeps its own, so W ranks repeat the one-process run of the
same N.  Checkpoints and `evaluate` cover the rank's own instances.
"""

import copy
import logging
import time

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call, vmap

from gan2shape_torch.core.model import GAN2Shape
from gan2shape_torch.core.trainer import Trainer, _last
from gan2shape_torch.distributed import make_mesh

log = logging.getLogger(__name__)


class StackedNet(nn.Module):
    """N copies of one net, of one structure, as a single module: each
    parameter stacked on a leading instance axis.  `forward` maps a batch
    of N contiguous groups, group j through copy j."""

    def __init__(self, nets):
        super().__init__()
        if any(True for _ in nets[0].buffers()):
            raise ValueError("StackedNet stacks parameters only; the net "
                             "holds buffers")
        self.n = len(nets)
        self.names = [k for k, _ in nets[0].named_parameters()]
        self.stacked = nn.ParameterList(
            nn.Parameter(torch.stack([dict(m.named_parameters())[k].detach()
                                      for m in nets]))
            for k in self.names)
        # the structure without storage, held in a tuple so that it is not
        # a submodule (its parameters are replaced at every call)
        self._template = (copy.deepcopy(nets[0]).to("meta"),)

    def forward(self, x):
        template = self._template[0]

        def one(params, xi):
            return functional_call(template, params, (xi,))

        xs = x.reshape(self.n, x.shape[0] // self.n, *x.shape[1:])
        out = vmap(one)(dict(zip(self.names, self.stacked)), xs)
        return out.reshape(x.shape[0], *out.shape[2:])

    def instance_state_dict(self, j):
        return {k: p[j].detach() for k, p in zip(self.names, self.stacked)}

    def instance(self, j):
        """Copy j as a module of its own (on the stack's device)."""
        net = copy.deepcopy(self._template[0]).to_empty(
            device=self.stacked[0].device)
        net.load_state_dict(self.instance_state_dict(j))
        return net

    @torch.no_grad()
    def load_instance(self, j, state_dict):
        for k, p in zip(self.names, self.stacked):
            p[j].copy_(state_dict[k])


class StackedNets(nn.ModuleDict):
    """The trainable nets of N instances: {name: StackedNet}, from a list
    of N {name: net} dicts."""

    def __init__(self, instances):
        super().__init__({k: StackedNet([inst[k] for inst in instances])
                          for k in instances[0].keys()})

    def instance(self, j):
        return nn.ModuleDict({k: v.instance(j) for k, v in self.items()})

    def load_instance(self, j, nets):
        for k, v in self.items():
            v.load_instance(j, nets[k].state_dict())


class InstanceParallelTrainer(Trainer):
    """Train N instances at once, split over the ranks of `mesh` (default
    `make_mesh()`: the process group, or this process alone).

    Usage:
        t = InstanceParallelTrainer(config, n_instances=8)
        t.fit(images, latents, priors, stages)   # leading N axis each

    Instance 0's nets are those of `Trainer(config, seed=seed)` and the
    frozen nets too (drawn in that order from one seeded generator); the
    other instances' nets follow from the same generator.  `model` is used
    as the trainer's model with its frozen nets as they are; `frozen`, a
    GAN2Shape, lends its frozen nets, mean latent and view/light sampler.
    Step 2's samples come from one device generator (seed + 1) drawing
    all N * n_proj_samples at once.  `n` is this rank's number of
    instances, `n_total` N."""

    def __init__(self, model_config, n_instances, frozen=None, seed=0,
                 model=None, save_ckpts=False, device=None, mesh=None):
        if isinstance(device, (list, tuple)):
            if len(device) > 1:
                raise NotImplementedError(
                    "several devices in one process: run one process per "
                    "device with torchrun (python -m torch.distributed.run "
                    "--nproc_per_node K ...), whose ranks split the "
                    "instances")
            device = device[0]
        if n_instances < 1:
            raise ValueError("n_instances must be >= 1")
        self.mesh = mesh if mesh is not None else make_mesh()
        if n_instances % self.mesh.size:
            raise ValueError(f"{n_instances} instances do not divide over "
                             f"{self.mesh.size} ranks")
        self.n_total = n_instances
        self.n = n_instances // self.mesh.size
        self.first = self.mesh.rank * self.n
        self.given_model, self.frozen_source = model, frozen
        super().__init__(model_config, save_ckpts=save_ckpts, seed=seed,
                         device=device if device is not None
                         else self.mesh.device)

    def _init_model(self, device, init):
        """Instance 0's nets, then the frozen nets (unless lent or given),
        then instances 1..N-1's, all from `init`; this rank's instances'
        nets stacked."""
        self.model = self.given_model if self.given_model is not None \
            else GAN2Shape(self.config, device=device)
        instances = [self._fresh_nets(init)]
        if self.frozen_source is not None:
            self._share_frozen(self.frozen_source)
        elif self.given_model is None:
            self.model.init_frozen(init)
        instances += [self._fresh_nets(init)
                      for _ in range(1, self.n_total)]
        own = instances[self.first:self.first + self.n]
        self.model.nets = StackedNets(own).to(self.model.device)
        self.model.n_instances = self.n
        self.model.instance_range = (self.first, self.n_total)

    def _fresh_nets(self, generator):
        self.model.init_params(generator)
        return copy.deepcopy(self.model.nets)

    def _share_frozen(self, frozen):
        for name in ("generator", "discriminator", "lpips"):
            getattr(self.model, name).load_state_dict(
                getattr(frozen, name).state_dict())
        self.model.mean_latent = frozen.mean_latent
        self.model.view_light_sampler = frozen.view_light_sampler

    def _curves(self, losses):
        """(N, iterations) host array of a step's per-instance losses."""
        if not losses:
            return np.zeros((self.n, 0), np.float32)
        return torch.stack(losses, 1).detach().cpu().numpy()

    def _own(self, x):
        """This rank's rows of an N-row sequence."""
        return x[self.first:self.first + self.n]

    def _batch(self, x):
        """This rank's instances of an (N, ...) array, on the device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.shape[0] != self.n_total:
            raise ValueError(f"expected a leading axis of {self.n_total} "
                             f"instances, got {tuple(x.shape)}")
        return self._own(x)

    # ---------------- training ----------------

    def fit(self, images, latents, priors=None, stages=None,
            reset_opt=False, data_indices=None):
        """images (N, 3, H, W), latents (N, D), priors (N, H, W) (or None:
        no prior pretraining), all N instances on every rank.  The Adam
        states carry across calls unless `reset_opt`.  `data_indices` names
        the instances in the history and the checkpoints (default
        0..N-1).  Returns one record per (instance of this rank, stage)
        with the sequential Trainer's keys and the full loss curves."""
        stages = stages or [{"step1": 1, "step2": 1, "step3": 1}]
        if data_indices is None:
            data_indices = list(range(self.n_total))
        if len(data_indices) != self.n_total:
            raise ValueError(f"{len(data_indices)} data indices for "
                             f"{self.n_total} instances")
        data_indices = self._own(list(data_indices))
        images = self._batch(images)
        latents = self._batch(latents).reshape(self.n, -1)
        if priors is not None and self.n_epochs_prior > 0:
            priors = self._batch(priors).reshape(self.n, *images.shape[2:])
            losses = self.run_prior(images, priors, self.n_epochs_prior)
            log.info("prior pretrain of %d instances: %.3e", self.n,
                     float(losses[-1].mean()))
        if reset_opt:
            self.optimizers = self._optimizers()

        history = []
        total_it = 0
        for i, stage in enumerate(stages):
            t0 = time.time()
            l1, l2, l3 = (self._curves(c) for c in
                          self.run_stage(images, latents, stage))
            dt = time.time() - t0
            total_it += l1.shape[1] + l2.shape[1] + l3.shape[1]
            for j, idx in enumerate(data_indices):
                c1, c2, c3 = (c[j].tolist() for c in (l1, l2, l3))
                history.append({
                    "image": int(idx), "stage": i, "loss_step1": _last(c1),
                    "loss_step2": _last(c2), "loss_step3": _last(c3),
                    "seconds": dt, "total_it": total_it,
                    "losses_step1": c1, "losses_step2": c2,
                    "losses_step3": c3})
            log.info("stage %d: %d instances, %.1fs, %d it", i, self.n, dt,
                     total_it)
            if self.save_ckpts:
                self.save_checkpoints(data_indices, i, total_it)
        return history

    def save_checkpoints(self, data_indices, stage, total_it):
        """Per-instance checkpoints in the sequential Trainer's format:
        one manifest and five .pth files per image of this rank
        (`data_indices`, one per instance of the rank)."""
        for j, idx in enumerate(data_indices):
            self.ckpt.save(self.model.nets.instance(j), idx, stage, total_it,
                           self.category)

    def evaluate(self, images):
        """(recon_im (n, 3, H, W), recon_depth (n, H, W)) of this rank's
        n instances, from the images (N, 3, H, W) of all N."""
        return self.model.evaluate_results(self._batch(images))
