"""The run's weights and inputs, made by the benchmark from `--seed` on the
device, and handed alike to the program and to the reference.

Each piece has its own generator on the device, seeded from (seed, piece):
the frozen nets (the configuration's GAN, `reference/gans/`, with its
frozen random buffers, and LPIPS-VGG), the five trainable nets of each
instance, and the
images and latents of each instance of the run.  So the reference remakes
any one piece without the others.  A piece's tensors are drawn in two large
calls (one uniform, one normal), by the initialisation laws of the
reference's layers (`reference/layers.py:recording`)."""

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.layers import recording, reset_parameters

FROZEN, INPUTS, NETS = 0, 1, 2


def generator(seed, device, *piece):
    """A device generator for one piece of the run, from the seed."""
    state = np.random.SeedSequence([int(seed), *piece]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


@torch.no_grad()
def _draw(modules, gen):
    """Draw every parameter of `modules` that the reference's laws draw
    (constants are set in place), in one uniform and one normal call."""
    with recording() as draws:
        for m in modules:
            reset_parameters(m, None)
    device = gen.device
    for law in ("uniform", "normal"):
        taken = [(t, s) for t, kind, s in draws if kind == law]
        total = sum(t.numel() for t, _ in taken)
        if not total:
            continue
        flat = torch.empty(total, device=device)
        if law == "uniform":
            flat.uniform_(-1.0, 1.0, generator=gen)
        else:
            flat.normal_(0.0, 1.0, generator=gen)
        at = 0
        for t, scale in taken:
            n = t.numel()
            t.copy_(flat[at:at + n].view(t.shape) * scale)
            at += n


@torch.no_grad()
def make_frozen(model, seed):
    """The reference model's frozen nets, then the GAN generator's frozen
    random buffers (`draw_buffers` of its `reference/gans/` file)."""
    gen = generator(seed, model.device, FROZEN)
    _draw((model.generator, model.discriminator, model.lpips), gen)
    model.gan.draw_buffers(model.generator, gen, model.device)


def make_nets(model, seed, instance):
    """Instance `instance`'s five trainable nets, into the reference
    model's `nets`."""
    _draw([model.nets], generator(seed, model.device, NETS, instance))


def make_inputs(seed, number, n, size, z_dim, device):
    """The images (n, 3, size, size) in (-1, 1) and W latents (n, z_dim) of
    the run's instance `number`: smooth random images (8 x 8 normal noise,
    bilinearly enlarged, through tanh) and normal latents."""
    gen = generator(seed, device, INPUTS, number)
    low = torch.randn(n, 3, 8, 8, generator=gen, device=device)
    images = torch.tanh(F.interpolate(low, size=(size, size),
                                      mode="bilinear", align_corners=False))
    latents = torch.randn(n, z_dim, generator=gen, device=device)
    return images.contiguous(), latents
