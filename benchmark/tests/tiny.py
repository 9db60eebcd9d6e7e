"""A cell at a size the CPU runs in seconds: image and GAN 64, channel
multiplier 1, one pseudo sample, the schedule cut 100 times."""

import copy

from benchmark import spec

TINY = {"image_size": 64, "gan_size": 64, "channel_multiplier": 1,
        "n_proj_samples": 1}


def tiny_cell(name="face128-seq", n_instances=None, **traffic):
    cell = copy.deepcopy(spec.load_cell(name))
    cell.config.update(TINY)
    cell.traffic.update({"cut": 100, **traffic})
    if n_instances is not None:
        cell.traffic["n_instances"] = n_instances
    return cell


def args(seed=2 ** 31 + 11, seconds=12, trace=0, workload="face128-seq"):
    return ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
