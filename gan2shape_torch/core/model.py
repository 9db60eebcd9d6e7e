"""The GAN2Shape method: the depth-prior objective and the three alternating
optimisation steps, with pseudo-sample synthesis and GAN inversion.

GAN2Shape is an nn.Module that owns the five trainable nets (`nets`), the
frozen StyleGAN2 generator, discriminator and LPIPS, and the renderer.
Randomness (lights, views) comes from an explicit torch.Generator.  The
loop-invariant parts of step 1 and step 2 are separate methods computed once
per block under torch.no_grad().

Deliberate choices carried over from the JAX package: per-image depth
mean-centering, and a step-1 photometric loss over the whole batch.

Instances.  The batch holds `n_instances` = N independent instances in
contiguous groups (N > 1 is set by `parallel.InstanceParallelTrainer`, whose
`nets` map N stacked copies of each net over the N groups): every loss is
the (N,) vector of per-instance losses, step 2's and step 3's per-instance
draws and samples are contiguous groups, and nothing takes a statistic
across instances.  The default N = 1 is one problem over the whole batch,
with a (1,) loss.

Ranks.  Over a process group, a model may hold instances [first, first + N)
of `total` (`instance_range`, set by `InstanceParallelTrainer`): its step-2
draws are then those of all `total` instances, from one stream, of which
it keeps its own, so that W ranks repeat one process's run.  And step 1's
batch may be one rank's slice of a batch split over a group
(`batch_split`, set by `GeneralizingTrainer`): its masked L1 then takes its
mask sum over the whole batch (core/losses.py).
"""

import math
from contextlib import nullcontext

import numpy as np
import torch
import torch.nn as nn

from gan2shape_torch.core.losses import (
    discriminator_feature_loss, instance_mean, photometric_loss, smooth_loss,
)
from gan2shape_torch.device import resolve_device
from gan2shape_torch.models import networks
from gan2shape_torch.models.layers import relu, reset_parameters
from gan2shape_torch.models.lpips import LPIPS
from gan2shape_torch.models.stylegan2 import Discriminator, Generator
from gan2shape_torch.ops.grid_sample import grid_sample
from gan2shape_torch.ops.resize import resize
from gan2shape_torch.rendering.renderer import Renderer, get_transform_matrices
from gan2shape_torch.utils.precision import (
    exact_matmul, set_act_dtype, set_matmul_precision,
)


class ViewLightSampler:
    """Multivariate-normal view/light sampler: mean + chol @ eps (exact f32
    under every precision policy), on CUDA unless the caller asks for the
    CPU (`resolve_device`)."""

    def __init__(self, view_mean, view_cov, light_mean, light_cov,
                 view_scale=1.0, device=None):
        device = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def chol(cov):
            return t(np.linalg.cholesky(np.asarray(cov, np.float64)))

        self.view_mean = t(view_mean)
        self.light_mean = t(light_mean)
        self._view_chol = chol(view_cov)
        self._light_chol = chol(light_cov)
        self.view_scale = view_scale

    @classmethod
    def default(cls, view_scale=1.0, device=None):
        """Neutral stats (zero mean, small isotropic covariance) for running
        without the reference's MVN files."""
        return cls(np.zeros(6), np.eye(6) * 0.04, np.zeros(4),
                   np.eye(4) * 0.04, view_scale, device)

    def sample(self, generator, n, kind="view"):
        if kind == "view":
            mean, chol = self.view_mean, self._view_chol
        else:
            mean, chol = self.light_mean, self._light_chol
        eps = torch.randn(n, mean.shape[0], generator=generator,
                          device=mean.device)
        s = mean[None] + exact_matmul(eps, chol.T)
        if kind == "view":
            scale = torch.ones_like(mean)
            scale[1] = self.view_scale
            s = s * scale
        return s


class GAN2Shape(nn.Module):
    """Usage:
        model = GAN2Shape(config)            # on CUDA; device="cpu" for tests
        model.init_params(g); model.init_frozen(g)
        loss, collected = model.forward_step1(images)
    """

    NETS = ("lighting", "viewpoint", "depth", "albedo", "offset_encoder")

    def __init__(self, config, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = dict(config)
        # the precision policy (utils/precision.py); geometry stays exact
        # f32 under every policy
        if "matmul_precision" in config:
            set_matmul_precision(config["matmul_precision"])
        if "act_dtype" in config:
            set_act_dtype(config["act_dtype"])
        self.z_dim = config.get("z_dim", 512)
        self.image_size = config.get("image_size", 128)
        self.gan_size = config.get("gan_size", self.image_size)
        self.channel_multiplier = config.get("channel_multiplier", 2)
        self.category = config.get("category", "face")

        self.max_depth = 1.1
        self.min_depth = 0.9
        self.border_depth = 0.7 * self.max_depth + 0.3 * self.min_depth
        self.lam_perc = config.get("lam_perc", 1.0)
        self.lam_smooth = config.get("lam_smooth", 0.01)
        self.lam_regular = config.get("lam_regular", 0.01)
        self.xyz_rotation_range = config.get("xyz_rotation_range", 60)
        self.xy_translation_range = config.get("xy_translation_range", 0.1)
        self.z_translation_range = config.get("z_translation_range", 0.1)
        self.relative_encoding = config.get("relative_encoding", False)
        self.rand_light = config.get(
            "rand_light", [-1, 1, -0.2, 0.8, -0.1, 0.6, -0.6])
        self.truncation = config.get("truncation", 1)
        self.F1_d = config.get("F1_d", 2)
        self.disc_ftr_num = config.get("disc_ftr_num", 4)

        s = self.image_size
        self.nets = nn.ModuleDict({
            "lighting": networks.LightingNet(s),
            "viewpoint": networks.ViewpointNet(s),
            "depth": networks.DepthNet(s),
            "albedo": networks.AlbedoNet(s),
            "offset_encoder": networks.OffsetEncoder(s, cout=self.z_dim),
        })
        self.generator = Generator(self.gan_size, style_dim=self.z_dim,
                                   n_mlp=8,
                                   channel_multiplier=self.channel_multiplier)
        self.discriminator = Discriminator(
            self.gan_size, channel_multiplier=self.channel_multiplier)
        # the perceptual backbone: 'vgg' (the reference's), 'alex' or
        # 'squeeze'
        self.lpips = LPIPS(backbone=config.get("lpips_net", "vgg"))
        for m in (self.generator, self.discriminator, self.lpips):
            m.requires_grad_(False)
        self.mean_latent = None
        self.n_instances = 1
        self.instance_range = None  # (first, total) over ranks
        self.batch_split = False    # step 1's batch split over the ranks

        border = np.zeros((1, s, s), np.float32)
        border[:, :, :2] = 1.02  # the reference's literal pad value
        border[:, :, -2:] = 1.02
        self.register_buffer("_border", torch.as_tensor(border),
                             persistent=False)
        self.renderer = Renderer(config, s, self.min_depth, self.max_depth,
                                 device=self.device)
        self.view_light_sampler = ViewLightSampler.default(
            config.get("view_scale", 1), device=self.device)
        self.to(self.device)

    # ---------------- initialization ----------------

    def set_samplers(self, view_mvn, light_mvn, view_scale=None):
        """Install view/light MVN stats ({"mean", "cov"} dicts)."""
        self.view_light_sampler = ViewLightSampler(
            view_mvn["mean"], view_mvn["cov"], light_mvn["mean"],
            light_mvn["cov"],
            self.config.get("view_scale", 1) if view_scale is None
            else view_scale, device=self.device)

    def init_params(self, generator):
        """Seeded torch-default init of the five trainable nets."""
        for name in self.NETS:
            reset_parameters(self.nets[name], generator)

    def init_frozen(self, generator):
        """Seeded random frozen GAN + LPIPS (real runs load converted
        checkpoints instead) and the generator's fixed noise."""
        for m in (self.generator, self.discriminator, self.lpips):
            reset_parameters(m, generator)
        for buf, n in zip(self.generator.noise_list(),
                          self.generator.make_noise(generator)):
            buf.copy_(n)
        if self.truncation < 1:
            self.set_mean_latent()

    def set_mean_latent(self):
        """The truncation centre of the current generator: the mean of 4096
        mapped draws from a seeded generator on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(42)
        with torch.no_grad():
            self.mean_latent = self.generator.mean_latent(4096, gen)

    # ---------------- shared math ----------------

    def rescale_depth(self, depth):
        return ((1 + depth) / 2 * self.max_depth
                + (1 - depth) / 2 * self.min_depth)

    def get_clamped_depth(self, depth_raw, clamp_border=True):
        """(B, H, W) raw -> centered, tanh, rescaled depth with the 2-px
        left/right border blend."""
        centered = depth_raw - depth_raw.mean(dim=(1, 2), keepdim=True)
        depth = self.rescale_depth(torch.tanh(centered))
        if clamp_border:
            depth = (depth * (1 - self._border)
                     + self._border * self.border_depth)
        return depth

    def get_view_transformation(self, view):
        return torch.cat([
            view[:, :3] * math.pi / 180 * self.xyz_rotation_range,
            view[:, 3:5] * self.xy_translation_range,
            view[:, 5:] * self.z_translation_range], 1)

    def get_lighting_directions(self, lighting):
        lighting_a = lighting[:, :1] / 2 + 0.5
        lighting_b = lighting[:, 1:2] / 2 + 0.5
        d = torch.cat([lighting[:, 2:], lighting.new_ones(
            (lighting.shape[0], 1))], 1)
        d = d / torch.sqrt(torch.sum(d ** 2, dim=1, keepdim=True))
        return lighting_a, lighting_b, d

    @staticmethod
    def _diffuse(normal, light_d):
        return relu(torch.sum(normal * light_d.reshape(-1, 1, 1, 3),
                              dim=3))[:, None]

    def get_shading(self, normal, lighting_a, lighting_b, lighting_d, albedo):
        diffuse = self._diffuse(normal, lighting_d)
        shading = (lighting_a.reshape(-1, 1, 1, 1)
                   + lighting_b.reshape(-1, 1, 1, 1) * diffuse)
        texture = (albedo / 2 + 0.5) * shading * 2 - 1
        return diffuse, texture

    def _each(self, x, k):
        """The first sample of each instance, each repeated k times:
        (instances * k, ...)."""
        n = self.n_instances
        first = x.reshape(n, -1, *x.shape[1:])[:, 0]
        return first[:, None].expand(n, k, *first.shape[1:]).reshape(
            n * k, *first.shape[1:])

    def _recon_mask(self, recon_depth):
        margin = (self.max_depth - self.min_depth) / 2
        return (recon_depth < self.max_depth + margin).to(
            recon_depth.dtype).detach()[:, None]

    # ---------------- prior pretraining ----------------

    def depth_net_forward(self, images, prior):
        depth_raw = self.nets["depth"](images)[:, 0]
        centered = depth_raw - depth_raw.mean(dim=(1, 2), keepdim=True)
        depth = self.rescale_depth(torch.tanh(centered))
        if prior.dim() == 2:
            prior = prior[None]
        return instance_mean((depth - prior.detach()) ** 2,
                             self.n_instances), depth

    # ---------------- step 1 ----------------

    def forward_step1(self, images, step1=True, eval_mode=False):
        frozen = torch.no_grad() if step1 else nullcontext()
        with frozen:
            depth_raw = self.nets["depth"](images)
            view = self.nets["viewpoint"](images)
            lighting = self.nets["lighting"](images)
        depth = self.get_clamped_depth(depth_raw[:, 0])
        view = view + self.view_light_sampler.view_mean[None]
        rot, trans = get_transform_matrices(self.get_view_transformation(view))
        albedo = self.nets["albedo"](images)
        lighting = lighting + self.view_light_sampler.light_mean[None]
        light_a, light_b, light_d = self.get_lighting_directions(lighting)

        normal = self.renderer.get_normal_from_depth(depth)
        diffuse, texture = self.get_shading(normal, light_a, light_b,
                                            light_d, albedo)
        recon_depth = self.renderer.warp_canon_depth(depth, rot, trans)
        grid = self.renderer.get_inv_warped_2d_grid(recon_depth, rot, trans)
        recon_mask = self._recon_mask(recon_depth)
        recon_im = torch.clamp(grid_sample(texture, grid), -1.0, 1.0)
        if eval_mode:
            return recon_im, recon_depth

        n = self.n_instances
        loss_l1 = photometric_loss(recon_im, images, mask=recon_mask, n=n)
        loss_perc = instance_mean(self.lpips(recon_im * recon_mask,
                                             images * recon_mask), n)
        loss_smooth = smooth_loss(depth, n) + smooth_loss(diffuse, n)
        loss = (loss_l1 + self.lam_perc * loss_perc
                + self.lam_smooth * loss_smooth)
        return loss, (normal, light_a, light_b, albedo, depth)

    # Within a step-1 block only the albedo net trains, so everything but the
    # albedo branch is computed once per block.

    @torch.no_grad()
    def step1_invariants(self, images):
        depth = self.get_clamped_depth(self.nets["depth"](images)[:, 0])
        view = (self.nets["viewpoint"](images)
                + self.view_light_sampler.view_mean[None])
        rot, trans = get_transform_matrices(self.get_view_transformation(view))
        lighting = (self.nets["lighting"](images)
                    + self.view_light_sampler.light_mean[None])
        light_a, light_b, light_d = self.get_lighting_directions(lighting)
        normal = self.renderer.get_normal_from_depth(depth)
        diffuse = self._diffuse(normal, light_d)
        shading = (light_a.reshape(-1, 1, 1, 1)
                   + light_b.reshape(-1, 1, 1, 1) * diffuse)
        recon_depth = self.renderer.warp_canon_depth(depth, rot, trans)
        grid = self.renderer.get_inv_warped_2d_grid(recon_depth, rot, trans)
        loss_smooth = (smooth_loss(depth, self.n_instances)
                       + smooth_loss(diffuse, self.n_instances))
        return {"depth": depth, "normal": normal, "light_a": light_a,
                "light_b": light_b, "shading": shading, "grid": grid,
                "recon_mask": self._recon_mask(recon_depth),
                "loss_smooth": loss_smooth}

    def step1_iter(self, images, inv):
        """Per-iteration part: albedo forward, texture, warp-sample, losses.
        Returns (loss, albedo)."""
        albedo = self.nets["albedo"](images)
        texture = (albedo / 2 + 0.5) * inv["shading"] * 2 - 1
        recon_im = torch.clamp(grid_sample(texture, inv["grid"]), -1.0, 1.0)
        mask = inv["recon_mask"]
        n = self.n_instances
        loss_l1 = photometric_loss(recon_im, images, mask=mask, n=n,
                                   split=self.batch_split)
        loss_perc = instance_mean(self.lpips(recon_im * mask, images * mask),
                                  n)
        loss = (loss_l1 + self.lam_perc * loss_perc
                + self.lam_smooth * inv["loss_smooth"])
        return loss, albedo

    # ---------------- pseudo samples ----------------

    @torch.no_grad()
    def sample_pseudo_imgs(self, generator, n_images, normal, light_a,
                           light_b, albedo, depth):
        """`n_images` pseudo samples of each instance's first image under
        random lights and views (instance-major, one draw for all: with an
        `instance_range`, for all its instances, of which this model's are
        kept)."""
        h = w = self.image_size
        dev = depth.device
        total = self.n_instances * n_images
        first, n_all = self.instance_range or (0, self.n_instances)
        own = slice(first * n_images, first * n_images + total)
        x_min, x_max, y_min, y_max, d_min, d_max, alpha = self.rand_light
        lo = torch.tensor([x_min, y_min], device=dev)
        hi = torch.tensor([x_max, y_max], device=dev)
        dxy = lo + torch.rand(n_all * n_images, 2, generator=generator,
                              device=dev)[own] * (hi - lo)
        light_d = torch.cat([dxy, dxy.new_ones((total, 1))], 1)
        light_d = light_d / torch.sqrt(torch.sum(light_d ** 2, 1,
                                                 keepdim=True))
        rand_diffuse_shading = self._diffuse(self._each(normal, n_images),
                                             light_d)
        rand = d_min + torch.rand(n_all * n_images, 1, 1, 1,
                                  generator=generator,
                                  device=dev)[own] * (d_max - d_min)
        rand_diffuse = (self._each(light_b, n_images).reshape(-1, 1, 1, 1)
                        + rand) * rand_diffuse_shading
        rand_shading = (self._each(light_a, n_images).reshape(-1, 1, 1, 1)
                        + alpha * rand + rand_diffuse)
        rand_light_im = ((self._each(albedo, n_images) / 2 + 0.5)
                         * rand_shading * 2 - 1)

        mask = torch.ones((total, 3, h, w), device=dev)
        views = self.view_light_sampler.sample(generator, n_all * n_images,
                                               "view")[own]
        pseudo, mask = self.renderer.render_given_view(
            rand_light_im, self._each(depth, n_images),
            self.get_view_transformation(views), mask=mask)
        return torch.clamp(pseudo, -1.0, 1.0), mask[:, :1]

    # ---------------- step 2 ----------------

    def latent_projection(self, image, gan_im, latent, center_w, center_h):
        offset = self.nets["offset_encoder"](image)
        k = image.shape[0] // latent.shape[0]
        if self.relative_encoding:
            offset = offset - self._each(self.nets["offset_encoder"](gan_im),
                                         k)
        skip = self.generator.n_mlp - self.F1_d
        offset = self.generator.style_forward(offset + center_h,
                                              skip=skip) - center_w
        return offset, self._each(latent, k) + offset

    @torch.no_grad()
    def step2_invariants(self, latent):
        """The GAN re-synthesis of the latent and the mapping anchors,
        constant across a step-2 block."""
        gan_im, _ = self.generator([latent], input_is_w=True,
                                   truncation=self.truncation,
                                   truncation_latent=self.mean_latent)
        gan_im = resize(torch.clamp(gan_im, -1.0, 1.0),
                        (self.image_size, self.image_size))
        zeros = latent.new_zeros((1, self.z_dim))
        center_w = self.generator.style_forward(zeros)
        center_h = self.generator.style_forward(
            zeros, depth=self.generator.n_mlp - self.F1_d)
        return {"gan_im": gan_im, "center_w": center_w, "center_h": center_h}

    @torch.no_grad()
    def step2_sample(self, generator, collected, n_proj_samples):
        """The pseudo-sample pool of one step-2 iteration."""
        normal, light_a, light_b, albedo, depth = collected
        return self.sample_pseudo_imgs(generator, n_proj_samples, normal,
                                       light_a, light_b, albedo, depth)

    def step2_loss(self, latent, pseudo_im, mask, invariants):
        """GAN-inversion loss of step 2.  Returns (loss, (projected image,
        mask)) with the collected pair detached."""
        offset, latent_proj = self.latent_projection(
            pseudo_im, invariants["gan_im"], latent, invariants["center_w"],
            invariants["center_h"])
        projected_image, offset = self.generator.invert(
            (offset, latent_proj), truncation=self.truncation,
            mean_latent=self.mean_latent)
        projected_image = resize(projected_image,
                                 (self.image_size, self.image_size))
        n = self.n_instances
        loss_l1 = photometric_loss(projected_image, pseudo_im, mask=mask,
                                   n=n)
        # image_size inputs into the gan_size discriminator: the ftr_num
        # early exit keeps the spatial dims valid
        loss_rec = discriminator_feature_loss(
            self.discriminator, projected_image, pseudo_im, mask=mask,
            ftr_num=self.disc_ftr_num, n=n)
        loss = (loss_l1 + loss_rec
                + self.lam_regular * instance_mean(offset ** 2, n))
        return loss, (projected_image.detach(), mask.detach())

    def forward_step2(self, latent, collected, generator, n_proj_samples=8,
                      invariants=None):
        pseudo_im, mask = self.step2_sample(generator, collected,
                                            n_proj_samples)
        if invariants is None:
            invariants = self.step2_invariants(latent)
        return self.step2_loss(latent, pseudo_im, mask, invariants)

    # ---------------- step 3 ----------------

    def forward_step3(self, images, latents, collected):
        projected_samples, masks = (c.detach() for c in collected)
        k = projected_samples.shape[0] // self.n_instances
        step1_loss, c = self.forward_step1(images, step1=False)
        normal, _, _, albedo, depth = c
        normal, albedo, depth = (self._each(x, k)
                                 for x in (normal, albedo, depth))

        view = (self.nets["viewpoint"](projected_samples)
                + self.view_light_sampler.view_mean[None])
        rot, trans = get_transform_matrices(self.get_view_transformation(view))
        light = (self.nets["lighting"](projected_samples)
                 + self.view_light_sampler.light_mean[None])
        light_a, light_b, light_d = self.get_lighting_directions(light)
        _, texture = self.get_shading(normal, light_a, light_b, light_d,
                                      albedo)

        recon_depth = self.renderer.warp_canon_depth(depth, rot, trans)
        grid = self.renderer.get_inv_warped_2d_grid(recon_depth, rot, trans)
        recon_mask = self._recon_mask(recon_depth) * masks
        recon_im = torch.clamp(grid_sample(texture, grid), -1.0, 1.0)
        n = self.n_instances
        loss_l1 = photometric_loss(recon_im, projected_samples,
                                   mask=recon_mask, n=n)
        loss_perc = instance_mean(self.lpips(recon_im * recon_mask,
                                             projected_samples * recon_mask),
                                  n)
        return step1_loss + loss_l1 + self.lam_perc * loss_perc, None

    # ---------------- evaluation ----------------

    @torch.no_grad()
    def evaluate_results(self, image):
        recon_im, _ = self.forward_step1(image, eval_mode=True)
        depth_raw = self.nets["depth"](image)[:, 0]
        return recon_im, self.get_clamped_depth(depth_raw,
                                                clamp_border=False)
