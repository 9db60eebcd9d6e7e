"""The plain reference of the benchmark: a frozen copy of the method (the
five nets, the GAN, LPIPS-VGG, the renderer, the losses, the priors) in
plain torch, with every hand-written kernel replaced by its plain torch
version, and the trainer's per-step loops (`steps.py`).  It imports nothing
of the program: it is what the program's outputs are judged against.

The GAN is the configuration's `gan_arch`: `gans/<gan_arch>.py` (absent:
`gans/stylegan2.py`) builds its generator and discriminator and draws its
frozen random buffers; `gans/__init__.py` lists what the method uses of
them.  A new architecture is a new file there."""
