"""The whole step's share of the card's dense peak: the FLOPs that
torch.utils.flop_counter counts for one iteration of each step (and once
per block for its invariants), times the iterations of the blocks outside
the profiled stage, over those blocks' seconds, over the peak of the
precision the flags allowed at the window's start."""


def read(run):
    if not run.flops or not run.peak_flops:
        return None
    done = seconds = 0.0
    for b in run.window.blocks:
        if b["profiled"]:
            continue
        per, once = run.flops[b["step"]]
        done += once + per * b["n"]
        seconds += b["seconds"]
    if not done or not seconds:
        return None
    return 100.0 * done / seconds / run.peak_flops
