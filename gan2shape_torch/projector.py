"""LPIPS-driven GAN inversion: find the w (or W+) latent and the per-layer
noise maps with which a generator reproduces target images.

  * objective: LPIPS + noise_regularize_weight * the noise pyramid penalty
    + mse_weight * MSE; syntheses larger than 256 px are mean-pooled to 256
    before both (the targets are at most 256 px);
  * the noise pyramid penalises the spatial autocorrelation of every noise
    map at every octave down to 8 px;
  * every noise map is renormalised to zero mean and unit (Bessel) std after
    each step;
  * plain Adam with a cosine ramp-up / ramp-down of the learning rate;
  * the latent is perturbed by latent_std * noise * max(0, 1 -
    t / noise_ramp)^2 times unit normal noise, and starts at the mean w of
    10000 mapped draws (whose spread gives latent_std).
"""

import math

import torch
import torch.nn.functional as F


def noise_regularize(noises):
    """Sum over maps and octaves of the squared mean autocorrelation at a
    one-pixel shift along each axis."""
    loss = 0.0
    for noise in noises:
        size = noise.shape[2]
        while True:
            loss = (loss
                    + torch.mean(noise * torch.roll(noise, 1, dims=3)) ** 2
                    + torch.mean(noise * torch.roll(noise, 1, dims=2)) ** 2)
            if size <= 8:
                break
            noise = noise.reshape(noise.shape[0], 1, size // 2, 2,
                                  size // 2, 2).mean(dim=(3, 5))
            size //= 2
    return loss


def noise_normalize(noises):
    """Each map to zero mean and unit std (Bessel-corrected, as torch's
    `.std()`), in place."""
    with torch.no_grad():
        for noise in noises:
            mean = noise.mean()
            std = torch.sqrt(torch.sum((noise - mean) ** 2)
                             / max(noise.numel() - 1, 1))
            noise.sub_(mean).div_(std)


def get_lr(t, initial_lr, rampdown=0.25, rampup=0.05):
    lr_ramp = min(1.0, (1.0 - t) / rampdown)
    lr_ramp = 0.5 - 0.5 * math.cos(lr_ramp * math.pi)
    lr_ramp = lr_ramp * min(1.0, t / rampup)
    return initial_lr * lr_ramp


class Projector:
    """Usage:
        proj = Projector(generator, lpips)
        result = proj.project(torch.Generator(device).manual_seed(0), images)
    `images` (B, 3, S, S) in [-1, 1] on the generator's device.  Returns
    {'latent': (B, 512) or (B, n_latent, 512) with w_plus, 'noises',
    'image' (the final synthesis), 'losses' (the logged records)}."""

    def __init__(self, generator, lpips=None, w_plus=False, lr=0.1,
                 noise=0.05, noise_ramp=0.75, noise_regularize_weight=1e5,
                 mse_weight=0.0, lr_rampup=0.05, lr_rampdown=0.25):
        self.gen = generator.requires_grad_(False)
        self.lpips = lpips.requires_grad_(False) if lpips is not None \
            else None
        self.w_plus = w_plus
        self.lr = lr
        self.noise = noise
        self.noise_ramp = noise_ramp
        self.noise_reg_w = noise_regularize_weight
        self.mse_weight = mse_weight
        self.lr_rampup = lr_rampup
        self.lr_rampdown = lr_rampdown
        self.latent = self.noises = self.optim = None

    @property
    def device(self):
        return self.gen.input.input.device

    # ---------------- initialisation ----------------

    @torch.no_grad()
    def latent_stats(self, rng, n_mean_latent=10000):
        """Mean w of `n_mean_latent` mapped draws and their spread."""
        z = torch.randn(n_mean_latent, self.gen.style_dim, generator=rng,
                        device=self.device)
        w = self.gen.style_forward(z)
        mean = w.mean(0)
        std = torch.sqrt(torch.sum((w - mean) ** 2) / n_mean_latent)
        return mean, std

    def init_variables(self, rng, batch):
        """Sets the latent (at the mean w), fresh N(0, 1) noise maps per
        image and a fresh Adam; returns latent_std."""
        mean, std = self.latent_stats(rng)
        latent = mean[None].repeat(batch, 1)
        if self.w_plus:
            latent = latent[:, None].repeat(1, self.gen.n_latent, 1)
        noises = [torch.randn(batch, 1, 2 ** ((i + 5) // 2),
                              2 ** ((i + 5) // 2), generator=rng,
                              device=self.device)
                  for i in range(self.gen.num_layers)]
        self.set_variables(latent, noises)
        return std

    def set_variables(self, latent, noises):
        """Start from the given latent and noise maps, with a fresh Adam."""
        self.latent = latent.detach().clone().requires_grad_(True)
        self.noises = [n.detach().clone().requires_grad_(True)
                       for n in noises]
        self.optim = torch.optim.Adam([self.latent] + self.noises, lr=0.0,
                                      betas=(0.9, 0.999), eps=1e-8)

    # ---------------- one step ----------------

    def _synth(self, latent, noises):
        styles = latent if latent.dim() == 3 else \
            latent[:, None].expand(-1, self.gen.n_latent, -1)
        img, _ = self.gen([styles], noises, input_is_w=True)
        return img

    @staticmethod
    def _pooled(img):
        h = img.shape[2]
        if h <= 256:
            return img
        f = h // 256
        b, c = img.shape[0], img.shape[1]
        return img.reshape(b, c, h // f, f, h // f, f).mean(dim=(3, 5))

    def step(self, target, lr, noise_strength, perturbation):
        """One Adam step at learning rate `lr` on the latent perturbed by
        noise_strength * `perturbation` (unit normal, the latent's shape),
        then the noise renormalisation.  Returns 0-d tensors (perceptual,
        noise regularisation, mse) of the step's forward pass."""
        lat_n = self.latent + perturbation * noise_strength
        img = self._pooled(self._synth(lat_n, self.noises))
        p_loss = torch.sum(self.lpips(img, target)) if self.lpips \
            is not None else img.new_zeros(())
        n_loss = noise_regularize(self.noises)
        mse = F.mse_loss(img, target)
        total = p_loss + self.noise_reg_w * n_loss + self.mse_weight * mse
        for group in self.optim.param_groups:
            group["lr"] = lr
        self.optim.zero_grad(set_to_none=True)
        total.backward()
        self.optim.step()
        noise_normalize(self.noises)
        return p_loss.detach(), n_loss.detach(), mse.detach()

    # ---------------- the whole run ----------------

    def project(self, rng, images, steps=1000, log_every=50, progress=None):
        batch = images.shape[0]
        latent_std = self.init_variables(rng, batch)
        losses = []
        for i in range(steps):
            t = i / steps
            lr = get_lr(t, self.lr, self.lr_rampdown, self.lr_rampup)
            noise_strength = (latent_std * self.noise
                              * max(0.0, 1.0 - t / self.noise_ramp) ** 2)
            perturbation = torch.randn(self.latent.shape, generator=rng,
                                       device=self.device)
            p, n, mse = self.step(images, lr, noise_strength, perturbation)
            if i % log_every == 0 or i == steps - 1:
                rec = {"step": i, "perceptual": float(p),
                       "noise_regularize": float(n), "mse": float(mse),
                       "lr": lr}
                losses.append(rec)
                if progress is not None:
                    progress(rec)
        with torch.no_grad():
            img = self._synth(self.latent, self.noises)
        return {"latent": self.latent.detach(),
                "noises": [n.detach() for n in self.noises], "image": img,
                "losses": losses}
