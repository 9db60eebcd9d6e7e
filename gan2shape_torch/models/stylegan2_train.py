"""StyleGAN2 adversarial training: the JAX package's StyleGAN2Trainer in
PyTorch, on one device or data-parallel over the ranks of a process group.

  * non-saturating logistic losses;
  * lazy R1 on the (augmented) reals every `d_reg_every` steps, weight
    r1/2 * d_reg_every, differentiated through the augmentation;
  * lazy path-length regularisation every `g_reg_every` steps (decay 0.01,
    weight path_regularize * g_reg_every), the running mean carried in
    `mean_path_length`;
  * style mixing with probability `mixing`: one mixing decision and one
    crossover index per batch;
  * g_ema with decay 0.5 ** (32 / 10000), as e * d + p * (1 - d);
  * adaptive augmentation (models/augment.py) with p passed per step;
  * Adam with the lazy-regularisation scaling lr * r/(r+1), betas
    (0, 0.99 ** (r/(r+1)));
  * full-state checkpoints in the reference stylegan2-pytorch layout.

As in the JAX trainer, the main generator step takes its latents from the
mapping network without differentiating it, so the mapping network learns
only through the path-length term; fresh per-sample noise goes into every
synthesis.  Randomness comes from one `torch.Generator` on the device
(`self.rng`), drawn by `_mixed_latent`, `_fresh_noise`, `_maybe_augment`
and `_path_noise`; tests replace those on an instance to inject inputs.

Data parallelism (`mesh`: the process group's W ranks,
`distributed.make_mesh()`): each rank
takes an equal slice of the real batch; the latents, noise and
augmentation parameters of the whole batch are drawn on every rank from
the same generator and each keeps its rows; the discriminator's minibatch
standard deviation is the whole batch's; gradients are averaged over the
ranks before each Adam step and the metrics are the whole batch's (the
sign sum summed over the ranks), so every rank holds the same G, D, EMA
and Adam state as one process would.  The path-length step runs the same
small batch on every rank (its gradients averaged too).
"""

import copy
import math
import os

import torch
import torch.nn.functional as F

from gan2shape_torch.device import resolve_device
from gan2shape_torch.models.augment import (
    augment, sample_color, sample_inverse_affine,
)
from gan2shape_torch.models.layers import reset_parameters
from gan2shape_torch.models.stylegan2 import Discriminator, Generator
from gan2shape_torch import distributed


def d_logistic_loss(real_pred, fake_pred):
    return torch.mean(F.softplus(-real_pred) + F.softplus(fake_pred))


def g_nonsaturating_loss(fake_pred):
    return torch.mean(F.softplus(-fake_pred))


def _noise_size(i):
    return 2 ** ((i + 5) // 2)


class StyleGAN2Trainer:
    """Usage:
        t = StyleGAN2Trainer(size=256, use_augment=True)
        for i in range(iters):
            metrics = t.train_step(real, ada_p)
            ada_p = ada.tune(metrics["real_sign_sum"], batch)
            if i % t.d_reg_every == 0:
                r1 = t.d_reg_step(real, ada_p)
            if i % t.g_reg_every == 0:
                path = t.g_reg_step()
    Weights are drawn from `seed` on the CPU (the same on every device)."""

    def __init__(self, size, style_dim=512, n_mlp=8, channel_multiplier=2,
                 lr=2e-3, r1_weight=10.0, d_reg_every=16, g_reg_every=4,
                 mixing=0.9, path_regularize=2.0, path_batch_shrink=2,
                 use_augment=False, seed=0, device=None, mesh=None):
        self.grouped = distributed.group_mesh(mesh)  # collectives run
        self.world = mesh.size if self.grouped else 1
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.size = size
        self.style_dim = style_dim
        self.r1_weight = r1_weight
        self.d_reg_every = d_reg_every
        self.g_reg_every = g_reg_every
        self.mixing = mixing
        self.path_regularize = path_regularize
        self.path_batch_shrink = path_batch_shrink
        self.use_augment = use_augment
        self.ema_decay = 0.5 ** (32 / (10 * 1000))

        init = torch.Generator().manual_seed(seed)
        g = Generator(size, style_dim, n_mlp, channel_multiplier)
        d = Discriminator(size, channel_multiplier)
        reset_parameters(g, init)
        reset_parameters(d, init)
        with torch.no_grad():
            for buf, n in zip(g.noise_list(), g.make_noise(init)):
                buf.copy_(n)
        self.generator = g.to(self.device)
        self.discriminator = d.to(self.device)
        self.g_ema = copy.deepcopy(self.generator).requires_grad_(False)
        self.mean_path_length = torch.zeros((), device=self.device)
        self.rng = torch.Generator(self.device).manual_seed(seed + 1)

        g_ratio = g_reg_every / (g_reg_every + 1)
        d_ratio = d_reg_every / (d_reg_every + 1)
        self.g_optim = torch.optim.Adam(
            self.generator.parameters(), lr=lr * g_ratio,
            betas=(0.0, 0.99 ** g_ratio), eps=1e-8)
        self.d_optim = torch.optim.Adam(
            self.discriminator.parameters(), lr=lr * d_ratio,
            betas=(0.0, 0.99 ** d_ratio), eps=1e-8)

    # ---------------- randomness ----------------

    def _fresh_noise(self, batch):
        """Per-sample noise for every layer."""
        return [torch.randn(batch, 1, _noise_size(i), _noise_size(i),
                            generator=self.rng, device=self.device)
                for i in range(self.generator.num_layers)]

    def _mixed_latent(self, g, batch):
        """(batch, n_latent, style_dim) w latents of `g`'s mapping network:
        with probability `mixing` a second w from a random crossover index
        on, decided once for the batch."""
        z = torch.randn(2, batch, self.style_dim, generator=self.rng,
                        device=self.device)
        w1 = g.style_forward(z[0])
        w2 = g.style_forward(z[1])
        n_latent = g.n_latent
        use_mix = torch.rand((), generator=self.rng,
                             device=self.device) < self.mixing
        inject = torch.randint(1, n_latent, (), generator=self.rng,
                               device=self.device)
        take2 = use_mix & (torch.arange(n_latent, device=self.device)
                           >= inject)
        return torch.where(take2[None, :, None], w2[:, None, :],
                           w1[:, None, :])

    def _maybe_augment(self, img, ada_p):
        """`img` (this rank's rows) through transforms drawn for the whole
        batch."""
        if not self.use_augment:
            return img
        b, _, h, w = img.shape
        G = sample_inverse_affine(self.rng, ada_p, b * self.world, h, w)
        C = sample_color(self.rng, ada_p, b * self.world)
        return augment(self.rng, img, ada_p,
                       (self._own(G), self._own(C)))[0]

    def _path_noise(self, shape):
        """The unit-normal image the path-length Jacobian is applied to."""
        return torch.randn(shape, generator=self.rng, device=self.device)

    # ---------------- pieces ----------------

    def _own(self, x):
        """This rank's rows of a whole-batch draw."""
        return x[distributed.local_slice(x.shape[0])] if self.grouped else x

    def _whole_batch_draws(self, g, batch):
        """Latents and noise of the whole batch (`batch` rows a rank), this
        rank's rows."""
        latent = self._own(self._mixed_latent(g, batch * self.world))
        noise = [self._own(n) for n in self._fresh_noise(batch * self.world)]
        return latent, noise

    def _mean_over_ranks(self, values):
        """0-d tensors averaged over the ranks (one collective)."""
        if not self.grouped:
            return values
        return distributed.mean_over_ranks(values)

    @staticmethod
    def _synth(g, latent, noise):
        img, _ = g([latent], noise, input_is_w=True)
        return img

    def _update(self, optim, params, grads):
        """One optimizer step on `grads` averaged over the ranks; a
        parameter the loss did not reach gets a zero gradient, so that
        every Adam step count advances (as optax's do)."""
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        if self.grouped:
            distributed.all_reduce_mean_([p.grad for p in params])
        optim.step()
        for p in params:
            p.grad = None

    @torch.no_grad()
    def _accumulate_ema(self):
        d = self.ema_decay
        ema = list(self.g_ema.parameters())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(
            list(self.generator.parameters()), 1 - d))

    # ---------------- the main step ----------------

    def train_step(self, real, ada_p=0.0):
        """One D update on augmented reals and fakes, one G update against
        the updated D, then the EMA.  Returns 0-d device tensors."""
        metrics = self.d_step(real, ada_p)
        metrics["g_loss"] = self.g_step(real.shape[0], ada_p)
        self._accumulate_ema()
        return metrics

    def d_step(self, real, ada_p=0.0):
        """The D half of `train_step`."""
        g, d = self.generator, self.discriminator
        with torch.no_grad():
            fake = self._synth(g, *self._whole_batch_draws(g, real.shape[0]))
            real_aug = self._maybe_augment(real, ada_p)
            fake_aug = self._maybe_augment(fake, ada_p)
        real_pred, _ = d(real_aug, split_batch=self.grouped)
        fake_pred, _ = d(fake_aug, split_batch=self.grouped)
        d_loss = d_logistic_loss(real_pred, fake_pred)
        d_params = list(d.parameters())
        self._update(self.d_optim, d_params,
                     torch.autograd.grad(d_loss, d_params))
        # the sign sum as a mean over the ranks times W: exact for integers
        values = self._mean_over_ranks([
            d_loss.detach(), real_pred.detach().mean(),
            fake_pred.detach().mean(), torch.sign(real_pred.detach()).sum()])
        return {"d_loss": values[0], "real_score": values[1],
                "fake_score": values[2],
                "real_sign_sum": values[3] * self.world}

    def g_step(self, batch, ada_p=0.0):
        """The G half of `train_step` (without the EMA); returns the loss."""
        g, d = self.generator, self.discriminator
        with torch.no_grad():
            latent, noise = self._whole_batch_draws(g, batch)
        fake = self._synth(g, latent, noise)
        fake_pred, _ = d(self._maybe_augment(fake, ada_p), split_batch=self.grouped)
        g_loss = g_nonsaturating_loss(fake_pred)
        g_params = list(g.parameters())
        self._update(self.g_optim, g_params, torch.autograd.grad(
            g_loss, g_params, allow_unused=True))
        return self._mean_over_ranks([g_loss.detach()])[0]

    # ---------------- lazy R1 ----------------

    def d_reg_step(self, real, ada_p=0.0):
        """R1 on the reals, through a freshly drawn augmentation, weight
        r1/2 * d_reg_every.  Returns the penalty."""
        d = self.discriminator
        real = real.detach().requires_grad_(True)
        pred, _ = d(self._maybe_augment(real, ada_p), split_batch=self.grouped)
        grad_real, = torch.autograd.grad(pred.sum(), real, create_graph=True)
        r1 = torch.sum(grad_real ** 2) / real.shape[0]
        loss = (self.r1_weight / 2) * r1 * self.d_reg_every
        d_params = list(d.parameters())
        # biases after the minibatch-stddev layer do not reach R1
        self._update(self.d_optim, d_params, torch.autograd.grad(
            loss, d_params, allow_unused=True))
        return self._mean_over_ranks([r1.detach()])[0]

    # ---------------- lazy path length ----------------

    def g_reg_step(self, batch=None):
        """Path-length regularisation on `batch` samples (default
        max(1, 2 // path_batch_shrink), the JAX trainer's): the norm of the
        latent-to-image Jacobian applied to white noise scaled 1/sqrt(hw),
        pulled toward its running mean.  The same samples on every rank."""
        batch = batch or max(1, 2 // self.path_batch_shrink)
        g = self.generator
        noise = self._fresh_noise(batch)
        latent = self._mixed_latent(g, batch)
        img = self._synth(g, latent, noise)
        h, w = img.shape[2], img.shape[3]
        noise_img = self._path_noise(img.shape) / math.sqrt(h * w)
        grad, = torch.autograd.grad(img, latent, grad_outputs=noise_img,
                                    create_graph=True)
        path_lengths = torch.sqrt(torch.mean(torch.sum(grad ** 2, 2), 1))
        path_mean = (self.mean_path_length
                     + 0.01 * (torch.mean(path_lengths)
                               - self.mean_path_length)).detach()
        penalty = torch.mean((path_lengths - path_mean) ** 2)
        loss = self.path_regularize * self.g_reg_every * penalty
        g_params = list(g.parameters())
        self._update(self.g_optim, g_params, torch.autograd.grad(
            loss, g_params, allow_unused=True))
        self.mean_path_length = path_mean
        return {"path_loss": penalty.detach(),
                "path_length": path_lengths.detach().mean(),
                "mean_path_length": path_mean}

    # ---------------- sampling / checkpoints ----------------

    @torch.no_grad()
    def sample_ema(self, z, generator=None, truncation=1.0,
                   truncation_latent=None):
        """Images of the EMA generator for z (B, style_dim): zero noise, or
        fresh noise drawn from `generator`."""
        if generator is None:
            noise = [torch.zeros(1, 1, _noise_size(i), _noise_size(i),
                                 device=self.device)
                     for i in range(self.g_ema.num_layers)]
        else:
            noise = [torch.randn(z.shape[0], 1, _noise_size(i),
                                 _noise_size(i), generator=generator,
                                 device=self.device)
                     for i in range(self.g_ema.num_layers)]
        img, _ = self.g_ema([z], noise, truncation=truncation,
                            truncation_latent=truncation_latent)
        return img

    def state_dict(self):
        """The reference stylegan2-pytorch checkpoint layout, plus the
        running `mean_path_length` and the draws' generator state (`rng`,
        so that a resumed run draws on where the saved one stopped)."""
        return {"g": self.generator.state_dict(),
                "d": self.discriminator.state_dict(),
                "g_ema": self.g_ema.state_dict(),
                "g_optim": self.g_optim.state_dict(),
                "d_optim": self.d_optim.state_dict(),
                "mean_path_length": self.mean_path_length,
                "rng": {"device": self.rng.device.type,
                        "state": self.rng.get_state()}}

    def save_checkpoint(self, path, iteration, ada_p=0.0):
        """Full-state `.pt` checkpoint after `iteration`."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save({**self.state_dict(), "ada_aug_p": float(ada_p),
                    "iteration": int(iteration)}, path)

    def load_checkpoint(self, path):
        """Restore the full state; returns (iteration, ada_aug_p)."""
        # on the CPU: load_state_dict moves each entry where it belongs
        # (Adam keeps its step counts on the CPU)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        self.generator.load_state_dict(ckpt["g"])
        self.discriminator.load_state_dict(ckpt["d"])
        self.g_ema.load_state_dict(ckpt["g_ema"])
        self.g_optim.load_state_dict(ckpt["g_optim"])
        self.d_optim.load_state_dict(ckpt["d_optim"])
        self.mean_path_length = ckpt["mean_path_length"].to(self.device)
        # a reference checkpoint has no `rng`, and a CPU generator's state
        # does not fit a CUDA one's: those keep this trainer's seeded stream
        rng = ckpt.get("rng")
        if rng is not None and rng["device"] == self.rng.device.type:
            self.rng.set_state(rng["state"])
        return int(ckpt["iteration"]), float(ckpt["ada_aug_p"])
