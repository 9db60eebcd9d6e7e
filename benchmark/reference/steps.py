"""The trainer's steps in plain torch: the prior's fresh Adam over the
depth net, and steps 1, 2 and 3, each with its own Adam (lr from the
config, betas (0.9, 0.999), weight decay 5e-4 added to the gradient), on
one image and its latent.  What each block reads: its losses, the first
gradient as its Adam takes it (with the weight decay), how far its nets
moved over its iterations, and what it hands to the next step."""

import torch

from .priors import PriorGenerator

STEP_NETS = {
    "prior": ("depth",),
    "step1": ("albedo",),
    "step2": ("offset_encoder",),
    "step3": ("lighting", "viewpoint", "depth", "albedo"),
}
BETAS = (0.9, 0.999)
WEIGHT_DECAY = 5e-4


def step_params(nets, step):
    """{leaf name: parameter} of the nets that `step` trains."""
    return {f"{net}.{k}": p for net in STEP_NETS[step]
            for k, p in nets[net].named_parameters()}


def prior_of(config, image):
    """The depth prior (H, W) of one image (1, 3, H, W)."""
    gen = PriorGenerator(config.get("image_size", 128),
                         config.get("category", "face"),
                         config.get("prior_name", "ellipsoid"))
    return torch.as_tensor(gen(image.detach().cpu().numpy())[0],
                           device=image.device)


def block(model, config, step, image, latent, n_iters, prior=None,
          collected=None, collected2=None, sampler=None, half_batch=False,
          last=None):
    """`n_iters` iterations of one step on the model's nets as they stand,
    with a fresh Adam, as the trainer's runner does them.  Step 2 takes
    step 1's hand-off (`collected`: normal, light_a, light_b, albedo,
    depth) and draws its pseudo samples from `sampler`; step 3 takes step
    2's (`collected2`: projected samples and their masks).  Returns
    {"loss": [float] * n_iters, "grad": {leaf: norm}, "change": {leaf:
    norm}, "handoff": what the next step takes, or None}.  With `last`
    ({net: state_dict} of the nets the step trains), the hand-off is
    computed again, after the block, at those weights: the last
    iteration's input to what it handed on.  `half_batch` plants a fault:
    step 2 or step 3 takes only the first half of its samples."""
    lr = config.get("learning_rate", 1e-4)
    pool_every = int(config.get("pseudo_pool_every", 1))
    n_proj = config.get("n_proj_samples", 8)
    params = step_params(model.nets, step)
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=BETAS,
                           weight_decay=WEIGHT_DECAY)
    before = {k: p.detach().clone() for k, p in params.items()}
    out = {"loss": [], "handoff": None}
    state = {}
    if step == "step1":
        inv = model.step1_invariants(image)
    if step == "step2":
        inv2 = model.step2_invariants(latent)
    for i in range(n_iters):
        if step == "prior":
            loss = model.depth_net_forward(image, prior)[0]
        elif step == "step1":
            loss, albedo = model.step1_iter(image, inv)
            out["handoff"] = (inv["normal"], inv["light_a"], inv["light_b"],
                              albedo.detach(), inv["depth"])
        elif step == "step2":
            if i % pool_every == 0:
                pool = model.step2_sample(sampler, collected, n_proj)
                if half_batch:
                    pool = tuple(x[:max(x.shape[0] // 2, 1)] for x in pool)
                state["pool"] = pool
            loss, out["handoff"] = model.step2_loss(latent, *state["pool"],
                                                    inv2)
        else:
            if half_batch:
                collected2 = tuple(x[:max(x.shape[0] // 2, 1)]
                                   for x in collected2)
            loss = model.forward_step3(image, latent, collected2)[0]
        model.zero_grad(set_to_none=True)
        loss.sum().backward()
        opt.step()
        out["loss"].append(float(loss.detach().sum()))
        if i == 0:
            out["grad"] = {
                k: float(opt.state[p]["exp_avg"].norm() / (1 - BETAS[0]))
                for k, p in params.items()}
    out["change"] = {k: float((p.detach() - before[k]).norm())
                     for k, p in params.items()}
    if last is not None and n_iters > 0:
        with torch.no_grad():
            for net, sd in last.items():
                model.nets[net].load_state_dict(sd)
            if step == "step1":
                albedo = model.step1_iter(image, inv)[1]
                out["handoff"] = out["handoff"][:3] + (albedo,
                                                       out["handoff"][4])
            elif step == "step2":
                out["handoff"] = model.step2_loss(latent, *state["pool"],
                                                  inv2)[1]
    return out
