"""The reference's GANs, one file each, picked by the configuration's
`gan_arch` (absent: "stylegan2"): `gans/<gan_arch>.py`, found by name as
the harness finds a metric's reader, so a new architecture is a new file
and a configuration that names it.

A file exports
  build(config) -> (generator, discriminator), both nn.Modules, from the
      method's configuration (`gan_size`, `z_dim`, `channel_multiplier`
      and whatever else the architecture reads);
  draw_buffers(generator, gen, device) -> None: draws, from the
      torch.Generator `gen` on `device`, the generator's frozen random
      buffers that are not parameters (StyleGAN2's noise planes), after
      its parameters were drawn.

What the method (`reference/model.py`) uses of them:
  generator.n_mlp, generator.style_dim: the mapping network's depth
      (step 2's offset enters it `n_mlp - F1_d` layers in) and width;
  generator.style_forward(x, skip, depth): mapping layers [skip, depth);
  generator.mean_latent(n, gen): the mean of `n` mapped draws;
  generator.forward([w], input_is_w=True, truncation=, truncation_latent=)
      -> (image, features or None), the image in [-1, 1]-ish NCHW at the
      GAN's size;
  generator.invert(latent, truncation=, mean_latent=): the image of a W
      latent as the inversion (step 2's projection) calls it;
  discriminator.forward(x, ftr_num=): its features, the first `ftr_num`
      taps (`losses.discriminator_feature_loss`)."""

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT = "stylegan2"
_loaded = {}


def names(here=HERE):
    """The architectures that have a file."""
    return sorted(p.stem for p in Path(here).glob("*.py")
                  if not p.stem.startswith("_"))


def load(arch=DEFAULT, here=HERE):
    """The module of `gans/<arch>.py`; an unknown name raises, listing the
    files there are."""
    path = Path(here) / f"{arch}.py"
    if arch.startswith("_") or not path.is_file():
        raise ValueError(f"no reference GAN {arch!r}: gan_arch names one of "
                         f"{names(here)} ({Path(here)})")
    key = str(path)
    if key not in _loaded:
        spec = importlib.util.spec_from_file_location(f"{__name__}.{arch}",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[key] = module
    return _loaded[key]


def of(config, here=HERE):
    """The module of the configuration's `gan_arch`."""
    return load(config.get("gan_arch", DEFAULT), here)
