"""gan2shape_torch — the GAN2Shape method (unsupervised 2D-GAN-to-3D shape
recovery) in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

It mirrors the JAX package `gan2shape_tpu` module for module and is held
against it by the tests in `tests/test_torch_*.py`; it never imports JAX or
that package.  Layout:

  ops/        fused activation, upfirdn2d, resize, the 2x2-window fetch and
              splat (CUDA), grid_sample, the grid-mesh rasterizer (CUDA)
  csrc/       the CUDA sources, built at first use (ops/_cuda.py)
  models/     StyleGAN2, the five trainable nets, LPIPS (VGG, AlexNet,
              SqueezeNet), ADA and the StyleGAN2 trainer
  rendering/  camera, warps, normals, the Renderer
  core/       losses, priors, the three-step method, the instance Trainer
  convert/    JAX parameter pytrees -> the port's state_dicts
  native/     the mmap record cache (C++, built by g++ at first use)
  projector   LPIPS-driven GAN inversion
  tools/      check_raster and the GAN tools: prepare_data, train_gan,
              generate, project

Entry points run on CUDA unless the caller passes device="cpu"; on the CPU
every kernel wrapper runs its plain PyTorch version.
"""

from gan2shape_torch.device import resolve_device

__all__ = ["resolve_device"]
