"""Fidelity study of `pseudo_pool_every` on the port, the counterpart of the
JAX package's tools/check_pool_every.py.

The reference draws a fresh step-2 pseudo-sample pool every iteration
(K = 1); K > 1 draws one every K iterations and saves most of step 2's
sampling.  For each K this runs one face-128 instance (seed-0 image and
latent, `box` prior, seeded random weights, the same init for every K)
through the full instance schedule (1000 prior + {700, 700, 600} + 3 x
{200, 500, 400}) or, with --fast, through prior 50 + {20, 30, 30}; then
compares each K > 1 with the first K of --ks:

  * the foreground depth-MAD of the evaluated depth maps, below
    DEPTH_MAD_BOUND (the composed-parity envelope of PARITY.md);
  * per step: finite losses, a last loss below the first, and the mean of
    the last 20 losses within MAX_TAIL_DEV (relative) of the base's.

On the GPU two runs of one K differ too (the splat's atomics, cuDNN's
algorithm choice), so a K's distance from K = 1 is a finding only where it
exceeds that spread: --floor runs the first K a second time and reports
the two runs' distance as "floor" (the same measures, no verdict).

    python -m gan2shape_torch.tools.check_pool_every           # full, GPU
    python -m gan2shape_torch.tools.check_pool_every --fast    # smoke sizes
    python -m gan2shape_torch.tools.check_pool_every --fast --device cpu
    python -m gan2shape_torch.tools.check_pool_every --floor   # + K=1 again

Writes the JSON to --out (default build/pool_every_check_torch.json, never
the JAX tool's POOL_EVERY_CHECK.json), prints it, and exits non-zero
unless every K passes.
"""

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from gan2shape_torch.core.trainer import Trainer
from gan2shape_torch.device import synchronize
from gan2shape_torch.tools.bench import FACE128
from gan2shape_torch.tools.compare_depth import depth_mad
from gan2shape_torch.tools.full_instance_run import FULL_PRIOR, FULL_STAGES

# the JAX study's bounds: step 2's loss is stochastic by construction, and
# the deliverable is the depth map
MAX_TAIL_DEV = {"step1": 0.05, "step2": 0.15, "step3": 0.05}
DEPTH_MAD_BOUND = 2.5e-2
TAIL = 20
FAST_PRIOR = 50
FAST_STAGES = [{"step1": 20, "step2": 30, "step3": 30}]
STEPS = ("step1", "step2", "step3")
DEFAULT_OUT = os.path.join("build", "pool_every_check_torch.json")


def run_one(K, fast, device=None, config=None, prior=None, stages=None):
    """One instance at pool_every K.  Returns {"wall_s", "depth" (H, W)
    numpy, "losses": {step: numpy curve over all stages}}.  `config`,
    `prior` and `stages` cut the run for tests."""
    if prior is None:
        prior = FAST_PRIOR if fast else FULL_PRIOR
    if stages is None:
        stages = FAST_STAGES if fast else FULL_STAGES
    config = {**FACE128, "n_epochs_prior": prior, **(config or {}),
              "pseudo_pool_every": K}
    trainer = Trainer(config, seed=0, device=device)
    s = trainer.image_size
    rng = np.random.default_rng(0)
    data = [(rng.uniform(-1, 1, (3, s, s)).astype(np.float32),
             rng.standard_normal(512).astype(np.float32), 0)]

    synchronize(trainer.device)
    t0 = time.perf_counter()
    history = trainer.fit(data, stages=stages)
    synchronize(trainer.device)
    wall = time.perf_counter() - t0

    image = torch.as_tensor(data[0][0], device=trainer.device)[None]
    with torch.no_grad():
        _, depth = trainer.evaluate(image)
    losses = {k: np.concatenate([np.asarray(rec[f"losses_{k}"], np.float64)
                                 for rec in history]) for k in STEPS}
    return {"wall_s": wall, "depth": depth[0].cpu().numpy(),
            "losses": losses}


def tails(run, base, step):
    """(the run's last-TAIL mean, the base's, their relative deviation)."""
    tail_lo = float(np.mean(run["losses"][step][-TAIL:]))
    tail_hi = float(np.mean(base["losses"][step][-TAIL:]))
    return tail_lo, tail_hi, abs(tail_lo - tail_hi) / max(abs(tail_hi), 1e-6)


def depth_distance(run, base):
    mad = depth_mad(run["depth"], base["depth"])
    return {"depth_mad_vs_base": mad["mad"],
            "depth_p95_vs_base": mad["p95_ad"]}


def spread(run, base):
    """The measures of `judge` between two runs, without a verdict."""
    return {**depth_distance(run, base),
            "tail_rel_dev": {step: round(tails(run, base, step)[2], 4)
                             for step in STEPS}}


def judge(runs, ks):
    """The study's verdicts: each K of ks[1:] against ks[0], from runs
    {K: run_one's record}."""
    base = runs[ks[0]]
    results = {"ok": True, "baseline_K": ks[0],
               "wall_s": {str(k): round(runs[k]["wall_s"], 1) for k in ks},
               "depth_mad_bound": DEPTH_MAD_BOUND, "ks": {}}
    for K in ks[1:]:
        r = runs[K]
        entry = depth_distance(r, base)
        ok = entry["depth_mad_vs_base"] < DEPTH_MAD_BOUND
        for step in STEPS:
            lo = np.asarray(r["losses"][step])
            tail_lo, tail_hi, rel = tails(r, base, step)
            step_ok = bool(np.isfinite(lo).all() and lo[-1] < lo[0]
                           and rel <= MAX_TAIL_DEV[step])
            entry[step] = {"tail_base": tail_hi, "tail_K": tail_lo,
                           "tail_rel_dev": round(rel, 4),
                           "bound": MAX_TAIL_DEV[step], "pass": step_ok}
            ok = ok and step_ok
        entry["pass"] = bool(ok)
        results["ks"][str(K)] = entry
        results["ok"] = results["ok"] and ok
    passing = [int(k) for k, v in results["ks"].items() if v["pass"]]
    results["recommended_default"] = max(passing) if passing else ks[0]
    return results


def main(argv=None, config=None, prior=None, stages=None):
    """The CLI; returns (exit code, results, runs).  `config`, `prior` and
    `stages` cut the runs for tests."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--ks", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--floor", action="store_true",
                        help="run the first K again: the two runs' spread")
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    def run(K):
        print(f"running K={K} ...", file=sys.stderr)
        r = run_one(K, args.fast, args.device, config, prior, stages)
        print(f"K={K}: {r['wall_s']:.1f}s", file=sys.stderr)
        return r

    runs = {K: run(K) for K in args.ks}
    results = {"fast": args.fast, **judge(runs, args.ks)}
    if args.floor:
        again = run(args.ks[0])
        results["floor"] = {"wall_s": round(again["wall_s"], 1),
                            **spread(again, runs[args.ks[0]])}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    return (0 if results["ok"] else 1), results, runs


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    sys.exit(main()[0])
