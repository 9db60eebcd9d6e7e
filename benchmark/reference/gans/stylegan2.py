"""StyleGAN2 (Karras et al., arXiv:1912.04958; rosinality's layout): the
generator with an 8-layer mapping network and one noise plane a layer,
and the residual discriminator, at the configuration's GAN size and
channel multiplier."""

from ..stylegan2 import Discriminator, Generator


def build(config):
    size = config.get("gan_size", config.get("image_size", 128))
    multiplier = config.get("channel_multiplier", 2)
    generator = Generator(size, style_dim=config.get("z_dim", 512),
                          n_mlp=8, channel_multiplier=multiplier)
    discriminator = Discriminator(size, channel_multiplier=multiplier)
    return generator, discriminator


def draw_buffers(generator, gen, device):
    """The noise planes, in the generator's layer order."""
    for buf, n in zip(generator.noise_list(),
                      generator.make_noise(gen, device)):
        buf.copy_(n)
