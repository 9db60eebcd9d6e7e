"""Instance-mode training: per image, depth-prior pretraining, then stages of
step 1, step 2 and step 3, each a Python loop of optimizer steps.

Per-step parameter subsets: step1 -> albedo | step2 -> offset_encoder |
step3 -> lighting + viewpoint + depth + albedo, each with its own Adam
(lr 1e-4, betas (0.9, 0.999), weight decay 5e-4 added to the gradient, not
AdamW).  The prior pretraining uses a fresh Adam over the depth net per
image.
"""

import logging
import time

import numpy as np
import torch

from gan2shape_torch.core.model import GAN2Shape
from gan2shape_torch.core.priors import PriorGenerator

log = logging.getLogger(__name__)

STEP_SUBSETS = {
    1: ("albedo",),
    2: ("offset_encoder",),
    3: ("lighting", "viewpoint", "depth", "albedo"),
}


def default_optimizer(params, lr=1e-4, betas=(0.9, 0.999),
                      weight_decay=5e-4):
    return torch.optim.Adam(params, lr=lr, betas=betas,
                            weight_decay=weight_decay)


def _last(losses):
    return losses[-1] if losses else float("nan")


class Trainer:
    """Instance-mode trainer: `fit` trains each (image, latent, index) of
    its input in turn, batch 1."""

    def __init__(self, model_config, seed=0, device=None):
        self.config = dict(model_config)
        self.model = GAN2Shape(model_config, device=device)
        self.device = self.model.device
        self.image_size = model_config.get("image_size", 128)
        self.n_proj_samples = model_config.get("n_proj_samples", 8)
        self.n_epochs_prior = model_config.get("n_epochs_prior", 1000)
        self.learning_rate = model_config.get("learning_rate", 1e-4)
        if int(model_config.get("pseudo_pool_every", 1)) != 1:
            raise NotImplementedError("only pseudo_pool_every = 1 is ported")

        init = torch.Generator().manual_seed(seed)
        self.model.init_params(init)
        self.model.init_frozen(init)
        # step-2 pseudo-sample randomness, drawn on the model's device
        self.sampler = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.prior_generator = PriorGenerator(
            self.image_size, model_config.get("category", "face"),
            model_config.get("prior_name", "ellipsoid"))
        self.optimizers = {
            s: default_optimizer(self._params(sub), self.learning_rate)
            for s, sub in STEP_SUBSETS.items()}

    def _params(self, names):
        return [p for n in names for p in self.model.nets[n].parameters()]

    def _step(self, loss, optimizer):
        self.model.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()

    # ---------------- per-step runners ----------------

    def run_prior(self, image, prior, n_iters):
        """Fresh Adam over the depth net; returns the per-iteration
        losses (device tensors)."""
        opt = default_optimizer(self._params(("depth",)), self.learning_rate)
        losses = []
        for _ in range(n_iters):
            loss, _ = self.model.depth_net_forward(image, prior)
            self._step(loss, opt)
            losses.append(loss.detach())
        return losses

    def run_step1(self, image, n_iters):
        """Returns (collected, losses).  With n_iters == 0 it only computes
        the collected state that step 2 consumes."""
        inv = self.model.step1_invariants(image)
        if n_iters == 0:
            with torch.no_grad():
                _, albedo = self.model.step1_iter(image, inv)
        losses = []
        for _ in range(n_iters):
            loss, albedo = self.model.step1_iter(image, inv)
            self._step(loss, self.optimizers[1])
            losses.append(loss.detach())
        collected = (inv["normal"], inv["light_a"], inv["light_b"],
                     albedo.detach(), inv["depth"])
        return collected, losses

    def run_step2(self, image, latent, collected, n_iters):
        """Returns (collected2, losses); a fresh pseudo-sample pool every
        iteration."""
        inv2 = self.model.step2_invariants(latent)
        n_proj = self.n_proj_samples
        if n_iters == 0:
            pool = self.model.step2_sample(self.sampler, collected, n_proj)
            with torch.no_grad():
                _, coll2 = self.model.step2_loss(latent, *pool, inv2)
            return coll2, []
        losses = []
        for _ in range(n_iters):
            pool = self.model.step2_sample(self.sampler, collected, n_proj)
            loss, coll2 = self.model.step2_loss(latent, *pool, inv2)
            self._step(loss, self.optimizers[2])
            losses.append(loss.detach())
        return coll2, losses

    def run_step3(self, image, latent, collected2, n_iters):
        losses = []
        for _ in range(n_iters):
            loss, _ = self.model.forward_step3(image, latent, collected2)
            self._step(loss, self.optimizers[3])
            losses.append(loss.detach())
        return losses

    # ---------------- training loops ----------------

    def pretrain_on_prior(self, image, image_idx):
        prior = self.prior_generator(image.detach().cpu().numpy())
        prior = torch.as_tensor(prior[0] if prior.ndim == 3 else prior,
                                device=self.device)
        losses = [float(x) for x in self.run_prior(image, prior,
                                                   self.n_epochs_prior)]
        if losses:
            log.info("prior pretrain image %s: loss %.3e -> %.3e", image_idx,
                     losses[0], losses[-1])
        return losses

    def fit(self, images_latents, stages=None):
        """Train on each (image (3, H, W), latent (512,) or (1, 512), index)
        in turn.  Returns one history record per stage with the full loss
        curves."""
        stages = stages or [{"step1": 1, "step2": 1, "step3": 1}] * 2
        total_it = 0
        history = []
        for image, latent, data_index in images_latents:
            image = torch.as_tensor(np.asarray(image),
                                    device=self.device)[None]
            latent = torch.as_tensor(np.asarray(latent), device=self.device)
            if latent.dim() == 1:
                latent = latent[None]
            self.pretrain_on_prior(image, data_index)

            for stage_i, stage in enumerate(stages):
                t0 = time.time()
                # a step with 0 iterations still runs once without updates
                # when a later step consumes its collected state
                l1s, l2s, l3s = [], [], []
                if stage["step1"] or stage["step2"] or stage["step3"]:
                    collected, l1s = self.run_step1(image, stage["step1"])
                if stage["step2"] or stage["step3"]:
                    collected2, l2s = self.run_step2(image, latent, collected,
                                                     stage["step2"])
                if stage["step3"]:
                    l3s = self.run_step3(image, latent, collected2,
                                         stage["step3"])
                l1, l2, l3 = ([float(x) for x in ls] for ls in (l1s, l2s, l3s))
                dt = time.time() - t0
                total_it += len(l1) + len(l2) + len(l3)
                log.info("image %s stage %d: losses %.4f/%.4f/%.4f "
                         "(%.1fs, %d it)", data_index, stage_i, _last(l1),
                         _last(l2), _last(l3), dt, total_it)
                history.append({
                    "image": int(data_index), "stage": stage_i,
                    "loss_step1": _last(l1), "loss_step2": _last(l2),
                    "loss_step3": _last(l3), "seconds": dt,
                    "total_it": total_it, "losses_step1": l1,
                    "losses_step2": l2, "losses_step3": l3})
        log.info("finished training")
        return history

    def evaluate(self, image):
        return self.model.evaluate_results(image)
