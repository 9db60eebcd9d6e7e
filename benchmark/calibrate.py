"""The readings the correctness limits are set from, on the card, at a
cell's own sizes.

    python3 -m benchmark.calibrate --workload car512-n8 --seeds 101 102 ... --controls 3

For each seed: the program's first steps (as a run's set-up drives them)
against the reference: the sound readings.  For the first `--controls`
seeds also the control (the reference with TF32 on in cuBLAS and cuDNN,
the precision below the configured exact f32) and two planted faults (the
reference with half of step 2's or of step 3's samples left out) against
the reference, each with whether the cell's limits fail it.
With `--flops`, the FLOPs of one iteration of each step
(torch.utils.flop_counter) and the split of step 2's between the
generator and the discriminator.  One JSON line per reading on stdout."""

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import check, spec
from benchmark.system import STEPS, System


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_readings(cell, seed, device, n_iters):
    system = System(cell, seed, device)
    return check.first_steps(system, n_iters,
                             lambda: synchronize(device)), system


def flop_split(system):
    """GFLOP of one step-2 iteration in all, in the generator, and in the
    discriminator, at the system's shapes."""
    from benchmark.roofline import flop_counter

    parts = {}

    def counted(name, module):
        real = module.forward

        def forward(*a, **kw):
            with flop_counter() as c:
                out = real(*a, **kw)
            parts[name] = parts.get(name, 0) + c.get_total_flops()
            return out
        return real, forward

    model = system.model
    saved = []
    for name in ("generator", "discriminator", "lpips"):
        module = getattr(model, name)
        real, fwd = counted(name, module)
        module.forward = fwd
        saved.append((module, real))
    try:
        with flop_counter() as total:
            system.run("step2", 1)
        synchronize(system.device)
    finally:
        for module, real in saved:
            module.forward = real
    # forward FLOPs of each stack as called (its backward is not split)
    return {"total_gflop": total.get_total_flops() / 1e9,
            **{f"{k}_forward_gflop": v / 1e9 for k, v in parts.items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--flops", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload)
    device = torch.device(a.device)
    if device.type == "cuda":
        from gan2shape_torch.ops import _cuda
        _cuda.build()
    n_iters = int(cell.traffic["check_iters"])
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        (program, images, latents), system = program_readings(
            cell, seed, device, n_iters)
        if a.flops and i == 0:
            from benchmark import roofline
            flops = roofline.count_flops(system, STEPS,
                                         lambda: synchronize(device))
            print(json.dumps({"cell": cell.name, "flops_per_iter_gflop": {
                k: v[0] / 1e9 for k, v in flops.items()},
                "flops_per_block_gflop": {k: v[1] / 1e9
                                          for k, v in flops.items()},
                "step2_split": flop_split(system)}), flush=True)
        del system
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        want = check.reference_readings(cell.config, seed, images, latents,
                                        n_iters, device, program)
        sound = check.gaps(program, want)
        print(json.dumps({"cell": cell.name, "seed": seed, "kind": "program",
                          "readings": sound,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if i < a.controls:
            for kind, kw in (("control_tf32", {"tf32": True}),
                             ("fault_half_batch", {"half_batch": "step2"}),
                             ("fault_half_batch3", {"half_batch": "step3"})):
                got = check.reference_readings(cell.config, seed, images,
                                               latents, n_iters, device,
                                               program, **kw)
                worst = check.gaps(got, want)
                print(json.dumps({"cell": cell.name, "seed": seed,
                                  "kind": kind, "readings": worst,
                                  "passes_limits": check.judge(
                                      worst, cell.limits)[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
