"""GPU seconds of one instance over the whole schedule, from the window:
(prep / I + sum_k C_k T_k / n_k) / N, with C_k the schedule's iterations
of step k, T_k / n_k the window's seconds per iteration of step k (all its
blocks), I the instances begun and N those trained at once."""


def read(run):
    w = run.window
    total = w.terms["prep"] / max(w.instances, 1)
    for step, count in run.counts.items():
        n = w.iterations(step)
        if n == 0:
            return None
        total += count * w.terms[step] / n
    return total / run.n_instances
