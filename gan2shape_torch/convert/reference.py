"""Load the reference GAN2Shape release assets into a port GAN2Shape.

The port's modules keep the reference's torch state_dict names, so loading
is `load_state_dict`:
  - the StyleGAN2 checkpoint ({"g_ema", "d", ...}): `g_ema` (its noise
    buffers included) into the generator, `d` into the discriminator;
  - a torchvision backbone file (`features.*`: `vgg16.pth`, `alexnet.pth`
    or `squeezenet1_1.pth`, as the config's `lpips_net` asks) and the lpips
    v0.1 heads of the same backbone (`lin{k}.model.1.weight`) into LPIPS;
  - the view / light MVN files ({"mean", "cov"}) into the model's sampler.
The reference registers its FIR blur and upsample kernels as state
(`*.kernel`); the port builds them as constants, so those entries are
dropped.  Every other entry must match.

`build_frozen_assets` is what the train and evaluate entry points call: a
missing file leaves the seeded random init in place, with a warning.
"""

import logging
from os import path

import numpy as np
import torch

log = logging.getLogger(__name__)

# the seed of the random frozen init: fixed, so the trainer and the
# evaluator build the same frozen nets when no asset file exists
FROZEN_SEED = 7


def load_torch_file(filename):
    """A reference asset file (a pickle that may hold more than tensors)."""
    return torch.load(filename, map_location="cpu", weights_only=False)


def load_reference_state_dict(module, state_dict, what):
    """`module.load_state_dict` of a reference state_dict, less the FIR
    kernel constants; raises on any other missing or unexpected entry."""
    own = module.state_dict()
    extra = [k for k in state_dict if k not in own]
    unknown = [k for k in extra if not k.endswith(".kernel")]
    missing = [k for k in own if k not in state_dict]
    if unknown or missing:
        raise KeyError(f"{what}: entries missing {missing[:5]} "
                       f"unexpected {unknown[:5]}")
    module.load_state_dict({k: torch.as_tensor(v) for k, v in
                            state_dict.items() if k in own})


def load_gan_checkpoint(model, filename):
    ckpt = load_torch_file(filename)
    load_reference_state_dict(model.generator, ckpt["g_ema"],
                              f"{filename} g_ema")
    load_reference_state_dict(model.discriminator, ckpt["d"],
                              f"{filename} d")


# where the backbone files lie by default, and the config key that moves them
LPIPS_TRUNK_FILES = {"vgg": ("vgg_ckpt_path", "checkpoints/vgg/vgg16.pth"),
                     "alex": ("alex_ckpt_path",
                              "checkpoints/alex/alexnet.pth"),
                     "squeeze": ("squeeze_ckpt_path",
                                 "checkpoints/squeeze/squeezenet1_1.pth")}


def load_lpips(model, trunk_path, lpips_path):
    """The torchvision file of the module's backbone (its `features.*`) plus
    the lpips linear heads into `model.lpips` (or into `model` itself when
    it is an LPIPS module); a module without heads (the `net` mode) reads
    no heads file."""
    lpips = getattr(model, "lpips", model)
    trunk = load_torch_file(trunk_path)
    sd = {f"{lpips.backbone}.{k}": v for k, v in trunk.items()
          if k.startswith("features.")}
    if lpips.lpips_heads:
        sd.update(load_torch_file(lpips_path))
    load_reference_state_dict(lpips, sd, f"{trunk_path} + {lpips_path}")


def load_mvn(filename):
    d = load_torch_file(filename)
    return {k: np.array(torch.as_tensor(d[k]).numpy(), np.float32)
            for k in ("mean", "cov")}


def _existing(filename):
    return filename if filename and path.exists(filename) else None


def build_frozen_assets(model, config):
    """Seeded random frozen nets, then whatever reference files exist (the
    paths of `config`), then the view/light sampler; mean_latent is
    recomputed from a loaded generator when truncation < 1."""
    model.init_frozen(torch.Generator().manual_seed(FROZEN_SEED))
    gan_ckpt = _existing(config.get("gan_ckpt_path"))
    if gan_ckpt is None:
        log.warning("GAN checkpoint not found — using random weights "
                    "(run download_data.py for the reference assets)")
    else:
        load_gan_checkpoint(model, gan_ckpt)
        log.info("loaded GAN checkpoint %s", gan_ckpt)
        if model.truncation < 1:
            model.set_mean_latent()  # init_frozen's came from random weights
    backbone = model.lpips.backbone
    key, default = LPIPS_TRUNK_FILES[backbone]
    trunk = _existing(config.get(key, default))
    lp = _existing(config.get("lpips_ckpt_path",
                              f"checkpoints/lpips/{backbone}.pth"))
    if trunk and lp:
        load_lpips(model, trunk, lp)
        log.info("loaded LPIPS-%s weights", backbone)
    vm = _existing(config.get("view_mvn_path"))
    lm = _existing(config.get("light_mvn_path"))
    if vm and lm:
        model.set_samplers(load_mvn(vm), load_mvn(lm))
    else:
        log.warning("view/light MVN stats not found — using neutral sampler")
    return model
