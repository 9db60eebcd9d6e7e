"""The plain reference of the benchmark: a frozen copy of the method (the
five nets, StyleGAN2, LPIPS-VGG, the renderer, the losses, the priors) in
plain torch, with every hand-written kernel replaced by its plain torch
version, and the trainer's per-step loops (`steps.py`).  It imports nothing
of the program: it is what the program's outputs are judged against."""
