"""The precision gate of the port, the counterpart of the JAX package's
tools/check_precision.py: the face-128 Trainer runs the depth prior and
steps 1-3 from one seeded init under each precision policy
(utils/precision.py), and the loss trajectories of the faster policies are
held to the exact-f32 run's.

    python -m gan2shape_torch.tools.check_precision          # on the GPU
    python -m gan2shape_torch.tools.check_precision --device cpu --size 64 \
        --iters 3 --n-proj 2                                 # small, on the CPU

Policies, each set through the model config's `matmul_precision` and
`act_dtype` keys:

  highest   'highest' + 'float32'    exact f32, the reference
  high      'high' + 'float32'       TF32 in cuBLAS and cuDNN
  default   'default' + 'bfloat16'   TF32, and bf16 activations in the
                                     frozen G, D and LPIPS trunk

The schedule is the JAX gate's: `box` prior (a flat prior map), 50 prior
iterations, then `--iters` of step 1, 2 and 3 (16 pseudo samples a step-2
iteration), on a seeded random image and latent.  A faster policy passes a
step when its losses are finite, its last loss is below its first, and the
mean of its last 5 losses lies within MAX_REL_DEV of the reference's
(relative) or within ATOL (absolute).  On the CPU TF32 does not exist, so
'high' repeats 'highest' there; the bf16 activations do apply.

Writes the result as JSON to --out (never the JAX gate's
PRECISION_CHECK.json), prints it, restores the policy that was set before,
and exits non-zero unless every verdict passes.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gan2shape_torch.core.trainer import Trainer
from gan2shape_torch.device import resolve_device
from gan2shape_torch.utils.precision import policy

STEPS = ("prior", "step1", "step2", "step3")
# the JAX gate's bounds on the relative deviation of the last-5 mean: step
# 2's loss is stochastic (fresh pseudo samples every iteration), and Adam's
# normalised updates turn small gradient differences into diverging but
# equivalent trajectories
MAX_REL_DEV = {"prior": 0.05, "step1": 0.05, "step2": 0.15, "step3": 0.05}
ATOL = 1e-4  # the prior's losses converge to ~0
TAIL = 5
POLICIES = {"highest": ("highest", "float32"),
            "high": ("high", "float32"),
            "default": ("default", "bfloat16")}
REFERENCE = "highest"
N_EPOCHS_PRIOR = 50
DEFAULT_OUT = os.path.join("build", "precision_check_torch.json")


def gate_config(size, n_proj):
    """The face config of the JAX gate at `size` (image and GAN)."""
    return {"image_size": size, "gan_size": size, "z_dim": 512,
            "channel_multiplier": 1, "category": "face",
            "n_proj_samples": n_proj, "n_epochs_prior": N_EPOCHS_PRIOR,
            "learning_rate": 1e-4, "prior_name": "box",
            "rot_center_depth": 1.0, "fov": 10}


def gate_inputs(size, device):
    """The seeded image (1, 3, S, S), latent (1, 512) and flat prior."""
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (1, 3, size, size)).astype(np.float32)
    latent = rng.standard_normal((1, 512)).astype(np.float32)
    return (torch.as_tensor(image, device=device),
            torch.as_tensor(latent, device=device),
            torch.full((size, size), 1.0, device=device))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_trajectory(name, size=128, iters=40, n_proj=16, device=None):
    """A Trainer from seed 0 with policy `name` in its config, run through
    the gate's schedule.  The policy stays set: run it inside `policy()`.
    Returns ({step: losses}, {step: seconds}, the trainer, and the inputs
    and collected state (image, latent, prior, collected, collected2))."""
    matmul, act = POLICIES[name]
    config = {**gate_config(size, n_proj), "matmul_precision": matmul,
              "act_dtype": act}
    trainer = Trainer(config, seed=0, device=device)
    device = trainer.device
    image, latent, prior = gate_inputs(size, device)
    seconds = {}

    def timed(step, fn):
        _sync(device)
        t = time.perf_counter()
        out = fn()
        _sync(device)
        seconds[step] = time.perf_counter() - t
        return out

    losses = {"prior": timed("prior", lambda: trainer.run_prior(
        image, prior, N_EPOCHS_PRIOR))}
    collected, losses["step1"] = timed(
        "step1", lambda: trainer.run_step1(image, iters))
    collected2, losses["step2"] = timed(
        "step2", lambda: trainer.run_step2(image, latent, collected, iters))
    losses["step3"] = timed(
        "step3", lambda: trainer.run_step3(image, latent, collected2, iters))
    losses = {k: [float(x) for x in v] for k, v in losses.items()}
    return (losses, seconds, trainer,
            (image, latent, prior, collected, collected2))


def verdict(reference, losses, step):
    """One step of one faster policy against the reference run."""
    ref, run = np.asarray(reference), np.asarray(losses)
    ref_tail = float(np.mean(ref[-TAIL:]))
    run_tail = float(np.mean(run[-TAIL:]))
    dev = abs(run_tail - ref_tail)
    rel = dev / max(abs(ref_tail), 1e-6)
    finite = bool(np.isfinite(run).all())
    decreasing = bool(run[-1] < run[0])
    return {"tail_mean_reference": ref_tail, "tail_mean": run_tail,
            "tail_rel_dev": rel, "bound": MAX_REL_DEV[step],
            "finite": finite, "decreasing": decreasing,
            "pass": bool(finite and decreasing
                         and (dev <= ATOL or rel <= MAX_REL_DEV[step]))}


def run_gate(size=128, iters=40, n_proj=16, device=None, after=None):
    """Every policy from the same init, the reference first.  `after(name,
    trainer, state)`, if given, runs under each policy right after its
    trajectory.  Restores the policy that was set before."""
    device = resolve_device(device)
    runs = {}
    with policy():
        for name in POLICIES:
            losses, seconds, trainer, state = run_trajectory(
                name, size, iters, n_proj, device)
            runs[name] = {"matmul_precision": POLICIES[name][0],
                          "act_dtype": POLICIES[name][1],
                          "seconds": seconds, "losses": losses}
            if after is not None:
                after(name, trainer, state)
            del trainer, state
    steps = {step: {name: verdict(runs[REFERENCE]["losses"][step],
                                  runs[name]["losses"][step], step)
                    for name in POLICIES if name != REFERENCE}
             for step in STEPS}
    return {"ok": all(v["pass"] for s in steps.values() for v in s.values()),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "size": size, "iters": iters, "n_proj": n_proj,
            "n_epochs_prior": N_EPOCHS_PRIOR, "reference": REFERENCE,
            "steps": steps, "policies": runs}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=40)
    parser.add_argument("--n-proj", type=int, default=16)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    results = run_gate(args.size, args.iters, args.n_proj, args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({k: v for k, v in results.items() if k != "policies"},
                     indent=1))
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
