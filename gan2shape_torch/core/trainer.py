"""Training: instance mode (`Trainer`) and generalizing mode
(`GeneralizingTrainer`).  Each step's iterations run as a Python loop of
optimizer steps.

Per-step parameter subsets: step1 -> albedo | step2 -> offset_encoder |
step3 -> lighting + viewpoint + depth + albedo, each with its own Adam
(lr 1e-4, betas (0.9, 0.999), weight decay 5e-4 added to the gradient, not
AdamW).  The prior pretraining uses a fresh Adam over the depth net.

Randomness: the step-2 pseudo samples come from the trainer's device
generator (seed + 1) and the `shuffle` order from its host generator
(seed + 2).  Neither is the JAX package's PRNG stream.
"""

import logging
import time

import numpy as np
import torch

from gan2shape_torch.core.checkpoint import CheckpointManager, load_nets
from gan2shape_torch.core.model import GAN2Shape
from gan2shape_torch.core.priors import PriorGenerator
from gan2shape_torch import distributed

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


def _floats(losses):
    return [float(x) for x in losses]


class Trainer:
    """Instance-mode trainer: `fit` trains each (image, latent, index) of
    its input in turn, batch 1: prior pretraining (unless resuming), then
    the stages."""

    def __init__(self, model_config, debug=False, plot_intermediate=False,
                 log_wandb=False, save_ckpts=False, load_dict=None, seed=0,
                 device=None):
        self.config = dict(model_config)
        self.image_size = model_config.get("image_size", 128)
        self.category = model_config.get("category", "face")
        self.n_proj_samples = model_config.get("n_proj_samples", 8)
        self.n_epochs_prior = model_config.get("n_epochs_prior", 1000)
        self.learning_rate = model_config.get("learning_rate", 1e-4)
        # K > 1 draws a new pseudo-sample pool only every K step-2
        # iterations (K = 1, a fresh pool every iteration, is the method's)
        self.pool_every = int(model_config.get("pseudo_pool_every", 1))
        if self.pool_every < 1:
            raise ValueError("pseudo_pool_every must be >= 1")
        self.debug = debug
        self.plot_intermediate = plot_intermediate
        self.log_wandb = log_wandb
        self.save_ckpts = save_ckpts

        self._init_model(device, torch.Generator().manual_seed(seed))
        self.device = self.model.device
        # step-2 pseudo-sample randomness, drawn on the model's device
        self.sampler = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.shuffler = torch.Generator().manual_seed(seed + 2)
        self.prior_generator = PriorGenerator(
            self.image_size, self.category,
            model_config.get("prior_name", "ellipsoid"), device=self.device)
        self.optimizers = self._optimizers()

        self.ckpt = CheckpointManager(
            model_config.get("our_nets_ckpts",
                             {"VLADE_nets": "checkpoints/our_nets"}
                             )["VLADE_nets"])
        if load_dict is not None:
            load_nets(self.model, self.ckpt.load_latest_general(
                load_dict["category"], stage=load_dict.get("stage", "*"),
                iteration=load_dict.get("iteration", "*"),
                time=load_dict.get("time", "*")))
        self.load_dict = load_dict

    def _init_model(self, device, init):
        """Build the model on `device` and draw its nets from `init`."""
        self.model = GAN2Shape(self.config, device=device)
        self.model.init_params(init)
        self.model.init_frozen(init)

    def _optimizers(self):
        return {s: default_optimizer(self._params(sub), self.learning_rate)
                for s, sub in STEP_SUBSETS.items()}

    def _params(self, names):
        return [p for n in names for p in self.model.nets[n].parameters()]

    def _step(self, loss, optimizer):
        """One update from the (n,) per-instance losses, summed: each
        instance's parameters get exactly their own loss's gradient."""
        self.model.zero_grad(set_to_none=True)
        loss.sum().backward()
        optimizer.step()

    def _order(self, n, shuffle):
        if shuffle:
            return torch.randperm(n, generator=self.shuffler).tolist()
        return list(range(n))

    # ---------------- per-step runners ----------------

    def run_prior(self, images, priors, n_iters):
        """Fresh Adam over the depth net; returns the per-iteration
        losses (device tensors)."""
        opt = default_optimizer(self._params(("depth",)), self.learning_rate)
        losses = []
        for _ in range(n_iters):
            loss, _ = self.model.depth_net_forward(images, priors)
            self._step(loss, opt)
            losses.append(loss.detach())
        return losses

    def run_step1(self, images, n_iters):
        """Returns (collected, losses).  With n_iters == 0 it only computes
        the collected state that step 2 consumes."""
        inv = self.model.step1_invariants(images)
        if n_iters == 0:
            with torch.no_grad():
                _, albedo = self.model.step1_iter(images, inv)
        losses = []
        for _ in range(n_iters):
            loss, albedo = self.model.step1_iter(images, inv)
            self._step(loss, self.optimizers[1])
            losses.append(loss.detach())
        collected = (inv["normal"], inv["light_a"], inv["light_b"],
                     albedo.detach(), inv["depth"])
        return collected, losses

    def run_step2(self, image, latent, collected, n_iters):
        """Returns (collected2, losses).  The pseudo-sample pool is drawn at
        iterations i with i % pool_every == 0, and once for n_iters == 0."""
        inv2 = self.model.step2_invariants(latent)
        n_proj = self.n_proj_samples
        if n_iters == 0:
            pool = self.model.step2_sample(self.sampler, collected, n_proj)
            with torch.no_grad():
                _, coll2 = self.model.step2_loss(latent, *pool, inv2)
            return coll2, []
        losses = []
        for i in range(n_iters):
            if i % self.pool_every == 0:
                pool = self.model.step2_sample(self.sampler, collected,
                                               n_proj)
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

    def run_stage(self, image, latent, stage):
        """One stage's steps on one image (batch 1) per instance.  A step with 0
        iterations still runs once without updates when a later step
        consumes its collected state.  Returns the three lists of
        per-iteration (n,) loss tensors."""
        l1, l2, l3 = [], [], []
        if stage["step1"] or stage["step2"] or stage["step3"]:
            collected, l1 = self.run_step1(image, stage["step1"])
        if stage["step2"] or stage["step3"]:
            collected2, l2 = self.run_step2(image, latent, collected,
                                            stage["step2"])
        if stage["step3"]:
            l3 = self.run_step3(image, latent, collected2, stage["step3"])
        return l1, l2, l3

    # ---------------- training loops ----------------

    def debug_report(self, image, latent):
        """Log which nets receive gradients in each step."""
        from gan2shape_torch.core import diagnostics

        nets = self.model.nets
        loss1, coll = self.model.forward_step1(image)
        diagnostics.report_grad_norms(diagnostics.grad_norms(nets, loss1),
                                      "step1")
        gen = torch.Generator(device=self.device).manual_seed(0)
        coll = tuple(c.detach() for c in coll)
        loss2, coll2 = self.model.forward_step2(latent, coll, gen,
                                                n_proj_samples=2)
        diagnostics.report_grad_norms(diagnostics.grad_norms(nets, loss2),
                                      "step2")
        loss3, _ = self.model.forward_step3(image, latent, coll2)
        diagnostics.report_grad_norms(diagnostics.grad_norms(nets, loss3),
                                      "step3")

    def pretrain_on_prior(self, image, image_idx):
        prior = self.prior_generator(image.detach().cpu().numpy())
        prior = torch.as_tensor(prior[0] if prior.ndim == 3 else prior,
                                device=self.device)
        losses = _floats(self.run_prior(image, prior, self.n_epochs_prior))
        if losses:
            log.info("prior pretrain image %s: loss %.3e -> %.3e", image_idx,
                     losses[0], losses[-1])
        return losses

    def _to_device(self, image, latent):
        image = torch.as_tensor(np.asarray(image), device=self.device)
        latent = torch.as_tensor(np.asarray(latent), device=self.device)
        return image, latent[None] if latent.dim() == 1 else latent

    def fit(self, images_latents, stages=None, shuffle=False):
        """Train on each (image (3, H, W), latent (512,) or (1, 512), index)
        of an indexable dataset, in order or shuffled by the trainer's
        generator.  Returns one history record per image and stage with the
        full loss curves."""
        stages = stages or [{"step1": 1, "step2": 1, "step3": 1}] * 2
        total_it = 0
        history = []
        for pos, idx in enumerate(self._order(len(images_latents), shuffle)):
            image, latent, data_index = images_latents[idx]
            image, latent = self._to_device(image, latent)
            image = image[None]
            log.info("training on image %d/%d (dataset index %d)",
                     pos + 1, len(images_latents), idx)
            if self.debug and idx == 0:
                self.debug_report(image, latent)
            if self.load_dict is None:
                self.pretrain_on_prior(image, data_index)

            for stage_i, stage in enumerate(stages):
                t0 = time.time()
                l1, l2, l3 = (_floats(c) for c in
                              self.run_stage(image, latent, stage))
                dt = time.time() - t0
                n_it = len(l1) + len(l2) + len(l3)
                log.info("image %s stage %d: losses %.4f/%.4f/%.4f "
                         "(%.1fs, %d it)", data_index, stage_i, _last(l1),
                         _last(l2), _last(l3), dt, total_it + n_it)
                history.append({
                    "image": int(data_index), "stage": stage_i,
                    "loss_step1": _last(l1), "loss_step2": _last(l2),
                    "loss_step3": _last(l3), "seconds": dt,
                    "total_it": total_it + n_it, "losses_step1": l1,
                    "losses_step2": l2, "losses_step3": l3})
                total_it = self._log_wandb_iters(stage_i, data_index,
                                                 total_it, l1, l2, l3)
                if self.save_ckpts:
                    self.ckpt.save(self.model.nets, data_index, stage_i,
                                   total_it, self.category)

            if self.plot_intermediate:
                try:
                    from gan2shape_torch.utils import plotting
                    recon_im, recon_depth = self.evaluate(image)
                    plotting.plot_reconstructions(
                        recon_im.cpu().numpy(), recon_depth.cpu().numpy(),
                        total_it=str(total_it), im_idx=str(data_index))
                except Exception as e:  # plotting must never end training
                    log.warning("intermediate plot failed: %s", e)
        log.info("finished training")
        return history

    def _wandb(self):
        if not self.log_wandb or distributed.rank() != 0:
            return None
        try:
            import wandb
        except ImportError:
            return None
        return wandb

    def _log_wandb_iters(self, stage_i, data_index, total_it, l1, l2, l3):
        """One wandb record per iteration (stage, total_it, loss_step{k},
        image_num).  Always advances and returns the iteration count."""
        wandb = self._wandb()
        for k, losses in ((1, l1), (2, l2), (3, l3)):
            for v in losses:
                total_it += 1
                if wandb is not None:
                    wandb.log({"stage": stage_i, "total_it": total_it,
                               f"loss_step{k}": v,
                               "image_num": int(data_index)})
        return total_it

    def evaluate(self, image):
        return self.model.evaluate_results(image)


class GeneralizingTrainer(Trainer):
    """Nets shared by all images.  The priors of every image are computed
    on the host; the prior pretraining runs batched over all images; then
    per epoch, for each batch of `batch_size` images, step 1 runs batched
    and steps 2 and 3 run per image on slices of step 1's collected state.
    Only the first stage of a schedule is used.  A checkpoint with image ""
    is saved on epochs where epoch % 20 == 0.

    Data parallelism over ranks (`mesh`, the process group's, or
    `data_parallel: true` for `distributed.make_mesh()`): the nets are
    broadcast from rank 0 when `fit` starts; the batched prior and step 1
    split the image batch over the ranks when it divides by their number
    and run whole on every rank otherwise; steps 2 and 3 run per image on
    every rank.  Every gradient, of split and of replicated steps, is
    averaged over the ranks before the optimizer step, so every rank makes
    the same update (the splat's atomics make replicated gradients differ
    in their last bits).  Rank 0 writes the checkpoints."""

    def __init__(self, model_config, mesh=None, **kw):
        if mesh is None and model_config.get("data_parallel", False):
            mesh = distributed.make_mesh()
        if mesh is not None and kw.get("device") is None:
            kw["device"] = mesh.device
        self.mesh = mesh
        self.grouped = distributed.group_mesh(mesh)  # collectives run
        super().__init__(model_config, **kw)
        self.n_epochs = model_config.get("n_epochs_generalized", 1)

    # ---------------- data parallelism ----------------

    def _rows(self, n):
        """The rows of an n-image batch this rank computes, or None: no
        split (one rank, or n not divisible by the ranks)."""
        if not self.grouped or n % self.mesh.size:
            return None
        return distributed.local_slice(n)

    def _step(self, loss, optimizer):
        """The Trainer's update with the gradients averaged over the ranks
        (zeros for a parameter the loss did not reach, which stays without
        a gradient)."""
        if not self.grouped:
            return super()._step(loss, optimizer)
        self.model.zero_grad(set_to_none=True)
        loss.sum().backward()
        params = [p for g in optimizer.param_groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        distributed.all_reduce_mean_(grads)
        optimizer.step()

    def run_prior(self, images, priors, n_iters):
        rows = self._rows(images.shape[0])
        if rows is None:
            return super().run_prior(images, priors, n_iters)
        # a split step's losses averaged: the whole batch's
        return distributed.mean_over_ranks(
            super().run_prior(images[rows], priors[rows], n_iters))

    def run_step1(self, images, n_iters):
        """Step 1 on this rank's slice of the batch; the collected state of
        the whole batch, gathered from the ranks, for steps 2 and 3."""
        rows = self._rows(images.shape[0])
        if rows is None:
            return super().run_step1(images, n_iters)
        self.model.batch_split = True
        try:
            collected, losses = super().run_step1(images[rows], n_iters)
        finally:
            self.model.batch_split = False
        return (tuple(distributed.gather_rows_of(collected)),
                distributed.mean_over_ranks(losses))

    def fit(self, images_latents, stages=None, batch_size=2, shuffle=False):
        stage = (stages or [{"step1": 1, "step2": 1, "step3": 1}])[0]
        n = len(images_latents)
        total_it = 0
        history = []

        images, latents, priors = [], [], []
        for i in range(n):
            im, lat, _ = images_latents[i]
            images.append(np.asarray(im))
            lat = np.asarray(lat)
            latents.append(lat[None] if lat.ndim == 1 else lat)
            priors.append(np.asarray(self.prior_generator(np.asarray(im))))
        images = torch.as_tensor(np.stack(images), device=self.device)
        latents = torch.as_tensor(np.concatenate(latents), device=self.device)
        priors = torch.as_tensor(np.stack(priors), device=self.device
                                 ).reshape(n, self.image_size,
                                           self.image_size)

        if self.grouped:
            distributed.broadcast_(self.model.nets.parameters())
        if self.load_dict is None and self.n_epochs_prior > 0:
            losses = self.run_prior(images, priors, self.n_epochs_prior)
            log.info("prior pretrain done: %.3e", float(losses[-1]))

        for epoch in range(self.n_epochs):
            order = self._order(n, shuffle)
            for start in range(0, n, batch_size):
                idxs = order[start:start + batch_size]
                imgs, lats = images[idxs], latents[idxs]
                l1 = []
                if stage["step1"] or stage["step2"] or stage["step3"]:
                    collected, l1 = self.run_step1(imgs, stage["step1"])
                    l1 = _floats(l1)
                # step 1's iterations are batch-level: logged once a batch
                total_it = self._log_wandb_iters(epoch, -1, total_it, l1, [],
                                                 [])
                for bi in range(len(idxs)):
                    img, lat = imgs[bi:bi + 1], lats[bi:bi + 1]
                    l2, l3 = [], []
                    if stage["step2"] or stage["step3"]:
                        coll_i = tuple(x[bi:bi + 1] for x in collected)
                        coll2, l2 = self.run_step2(img, lat, coll_i,
                                                   stage["step2"])
                    if stage["step3"]:
                        l3 = self.run_step3(img, lat, coll2, stage["step3"])
                    l2, l3 = _floats(l2), _floats(l3)
                    image_num = int(idxs[bi])
                    history.append({
                        "epoch": epoch, "image_num": image_num,
                        "total_it": total_it + len(l2) + len(l3),
                        "loss_step1": _last(l1), "loss_step2": _last(l2),
                        "loss_step3": _last(l3), "losses_step2": l2,
                        "losses_step3": l3})
                    total_it = self._log_wandb_iters(epoch, image_num,
                                                     total_it, [], l2, l3)
                history[-1]["losses_step1"] = l1
            log.info("epoch %d: %.4f/%.4f/%.4f", epoch, _last(l1),
                     _last(l2), _last(l3))
            if epoch % 20 == 0 and self.save_ckpts and \
                    distributed.rank() == 0:
                self.ckpt.save(self.model.nets, "", epoch, total_it,
                               self.category)
        log.info("finished training")
        return history

    def _log_wandb_iters(self, epoch, data_index, total_it, l1, l2, l3):
        """Step 1's records carry epoch / total_it / loss_step1 (no image);
        steps 2 and 3's add image_num.  Always advances and returns the
        iteration count."""
        wandb = self._wandb()
        for v in l1:
            total_it += 1
            if wandb is not None:
                wandb.log({"epoch": epoch, "total_it": total_it,
                           "loss_step1": v})
        for k, losses in ((2, l2), (3, l3)):
            for v in losses:
                total_it += 1
                if wandb is not None:
                    wandb.log({"epoch": epoch, "total_it": total_it,
                               f"loss_step{k}": v,
                               "image_num": int(data_index)})
        return total_it


# the name the reference's entry point uses
GeneralizingTrainer2 = GeneralizingTrainer
