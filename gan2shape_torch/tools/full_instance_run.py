"""One full instance schedule of the port, timed: the counterpart of the JAX
package's tools/full_instance_run.py.

The north star of BASELINE.md: face-128 shape recovery of one instance
(1000 prior iterations, then stages {700, 700, 600} + 3 x {200, 500, 400}
of step 1, 2 and 3: 6300 optimization iterations, which BASELINE.md counts
as 5900) in 5 minutes or less.
This runs exactly that schedule through `Trainer.fit` for a seeded random
instance (seed 0), then for a second one (seed 1) on the same trainer.
`first_instance_s` includes what the first use pays once: the CUDA kernels'
build (or load from build/kernels/) and cuDNN's and cuBLAS's first-call
set-up; `steady_state_instance_s` is what each further instance of a
multi-image run pays.  Both are host-clock seconds around a synchronised
`fit`.

    python -m gan2shape_torch.tools.full_instance_run          # on the GPU
    python -m gan2shape_torch.tools.full_instance_run --device cpu

Writes the JSON to --out (default build/full_run_torch.json, never the JAX
tool's FULL_RUN.json) and prints it.
"""

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

from gan2shape_torch.core.trainer import Trainer
from gan2shape_torch.device import describe, synchronize
from gan2shape_torch.tools.bench import FACE128

FULL_PRIOR = 1000
FULL_STAGES = ([{"step1": 700, "step2": 700, "step3": 600}]
               + [{"step1": 200, "step2": 500, "step3": 400}] * 3)
NORTH_STAR_S = 300
DEFAULT_OUT = os.path.join("build", "full_run_torch.json")


def schedule_name(prior, stages):
    """'1000 prior + [{700,700,600}] + 3x[{200,500,400}]': equal
    consecutive stages counted once."""
    groups = []
    for stage in stages:
        text = "{%d,%d,%d}" % (stage["step1"], stage["step2"],
                               stage["step3"])
        if groups and groups[-1][0] == text:
            groups[-1][1] += 1
        else:
            groups.append([text, 1])
    return " + ".join([f"{prior} prior"] + [
        (f"{n}x" if n > 1 else "") + f"[{text}]" for text, n in groups])


def instance(seed, size):
    """A seeded random (image (3, S, S), latent (512,), index 0)."""
    r = np.random.default_rng(seed)
    return [(r.uniform(-1, 1, (3, size, size)).astype(np.float32),
             r.standard_normal(512).astype(np.float32), 0)]


def run(prior=FULL_PRIOR, stages=FULL_STAGES, device=None, config=None):
    """Two instances of the schedule through one face-128 Trainer (the
    config updated by `config`).  Returns the JSON record."""
    config = {**FACE128, "n_epochs_prior": prior, **(config or {})}
    n_steps = prior + sum(sum(s.values()) for s in stages)
    trainer = Trainer(config, device=device)

    def timed_fit(seed):
        synchronize(trainer.device)
        t0 = time.perf_counter()
        history = trainer.fit(instance(seed, trainer.image_size),
                              stages=stages)
        synchronize(trainer.device)
        return history, time.perf_counter() - t0

    _, first_s = timed_fit(0)
    history, steady_s = timed_fit(1)
    return {
        "schedule": schedule_name(prior, stages),
        "total_optimization_steps": n_steps,
        "first_instance_s": round(first_s, 1),
        "steady_state_instance_s": round(steady_s, 1),
        "steady_state_steps_per_sec": round(n_steps / steady_s, 2),
        "north_star_s": NORTH_STAR_S,
        "meets_north_star": steady_s <= NORTH_STAR_S,
        "final_losses": {k: round(float(v), 4)
                         for k, v in history[-1].items()
                         if k.startswith("loss_")},
        "device": describe(trainer.device),
    }


def main(argv=None, prior=FULL_PRIOR, stages=FULL_STAGES, config=None):
    """The CLI; `prior`, `stages` and `config` cut the run for tests."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    result = run(prior, stages, args.device, config)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    main()
