"""Multi-process runtime: one process per rank in one `torch.distributed`
process group, the counterpart of the JAX package's
`gan2shape_tpu/parallel/{distributed,mesh}.py`.

Launch the ranks with torchrun, which sets MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK and LOCAL_RANK in each process:

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m gan2shape_torch.cli.train --distributed --n-instances 8 ...

or start them yourself with G2S_COORDINATOR (host:port of rank 0),
G2S_NUM_PROCESSES and G2S_PROCESS_ID, the names the JAX package reads.
`initialize_from_env()` joins the group either way.  G2S_NUM_PROCESSES of
1 stays single-process, as in JAX; torchrun's variables always form a
group, even of one rank, since torchrun started the process as one.

The backend follows the device: NCCL on CUDA, gloo on the CPU.
G2S_DIST_BACKEND=gloo (or `backend="gloo"`) runs gloo on CUDA, which two
ranks sharing one card need (NCCL refuses two ranks on one device); gloo
stages CUDA tensors through the host.  Only `broadcast` and `all_reduce`
are used, the two collectives gloo offers for CUDA tensors.

A process holds at most one group, and every collective here runs in it
(the default group).  `Mesh` records the ranks a trainer spreads over:
`make_mesh()` gives the group's.
"""

import datetime
import logging
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")
# every collective of a rank waits at most this long for the others
TIMEOUT = datetime.timedelta(minutes=10)

_G2S = ("G2S_COORDINATOR", "G2S_NUM_PROCESSES", "G2S_PROCESS_ID")
_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

# the device the group was initialised for (a process holds one group)
_device = None


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_initialized() else 0


def world_size():
    return dist.get_world_size() if is_initialized() else 1


def group_device():
    """The device this process's group was initialised for (None without
    a group)."""
    return _device if is_initialized() else None


def local_device(process_id=None):
    """This rank's CUDA device: (LOCAL_RANK, else the rank) modulo the
    visible devices."""
    local = int(os.environ.get("LOCAL_RANK", rank() if process_id is None
                               else process_id))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclass(frozen=True)
class Mesh:
    """`size` ranks, this process being `rank`, on `device` (None: the
    trainer's default).  The instance trainer takes any such record (a
    rank's share alone in one process too); the data-parallel trainers
    take the group's (`make_mesh`), whose collectives they run."""
    size: int
    rank: int
    device: torch.device = None


def make_mesh():
    """The current process group as a Mesh (a group of one rank too);
    this process alone when none is initialised."""
    if not is_initialized():
        return Mesh(1, 0)
    return Mesh(world_size(), rank(), group_device())


def group_mesh(mesh):
    """Whether `mesh` is the process group's, whose collectives a trainer
    then runs; False for None or a mesh without a group.  A mesh of
    several ranks that is not the group's raises."""
    if mesh is None or not is_initialized():
        if mesh is not None and mesh.size > 1:
            raise ValueError(f"a mesh of {mesh.size} ranks without a process "
                             "group: launch the ranks with torchrun")
        return False
    if (mesh.size, mesh.rank) != (world_size(), rank()):
        raise ValueError(f"mesh {mesh} is not the process group's (rank "
                         f"{rank()} of {world_size()})")
    return True


def _backend(backend, device):
    backend = backend or os.environ.get("G2S_DIST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs CUDA; the CPU runs gloo")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if backend == "nccl" and local_world > torch.cuda.device_count():
        raise ValueError(
            f"{local_world} ranks on {torch.cuda.device_count()} device(s): "
            "NCCL refuses two ranks on one device; set G2S_DIST_BACKEND=gloo")
    return backend


def initialize(coordinator, num_processes, process_id, backend=None,
               device=None):
    """Join the group of `num_processes` ranks as rank `process_id`, with
    rank 0 listening at `coordinator` (host:port).  `device` is the
    device the trainers run on (default CUDA: this rank's `local_device`);
    it picks the backend unless `backend` or G2S_DIST_BACKEND names one.
    Returns True."""
    global _device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the ranks on the CPU")
        if device.index is None:
            device = local_device(int(process_id))
        torch.cuda.set_device(device)
    backend = _backend(backend, device)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=TIMEOUT)
    _device = device
    log.info("distributed: rank %d of %d, %s on %s", rank(), world_size(),
             backend, device)
    return True


def initialize_from_env(device=None, required=False):
    """Join a group if the environment (G2S_* or torchrun's variables)
    asks for it; returns whether a group is active.  A partial set of
    either raises, as does `required` (--distributed) or G2S_MULTIHOST=1
    without coordinates: torch has no autodetection of a pod."""
    if is_initialized():
        return True
    g2s = {k: os.environ.get(k) for k in _G2S}
    run = {k: os.environ.get(k) for k in _TORCHRUN}
    if any(g2s.values()):
        # a partial spec must fail loudly: silently staying single-process
        # makes every host train alone over the same checkpoints
        if not all(v is not None and v != "" for v in g2s.values()):
            raise RuntimeError(
                "partial multi-host environment: need ALL of "
                "G2S_COORDINATOR, G2S_NUM_PROCESSES, G2S_PROCESS_ID; got "
                f"{g2s}")
        if int(g2s["G2S_NUM_PROCESSES"]) <= 1:
            log.info("distributed: G2S_NUM_PROCESSES=%s, staying "
                     "single-process", g2s["G2S_NUM_PROCESSES"])
            return False
        return initialize(g2s["G2S_COORDINATOR"], g2s["G2S_NUM_PROCESSES"],
                          g2s["G2S_PROCESS_ID"], device=device)
    if any(run.values()):
        if not all(run.values()):
            raise RuntimeError(
                "partial multi-host environment: need ALL of MASTER_ADDR, "
                f"MASTER_PORT, WORLD_SIZE, RANK (torchrun sets them); got "
                f"{run}")
        return initialize(f"{run['MASTER_ADDR']}:{run['MASTER_PORT']}",
                          run["WORLD_SIZE"], run["RANK"], device=device)
    if required or os.environ.get("G2S_MULTIHOST") == "1":
        raise RuntimeError(
            "multi-process training asked for (--distributed or "
            "G2S_MULTIHOST=1) without coordinates: launch the ranks with "
            "python -m torch.distributed.run, or set G2S_COORDINATOR, "
            "G2S_NUM_PROCESSES and G2S_PROCESS_ID")
    return False


def shutdown():
    """Leave the group (a no-op without one)."""
    global _device
    if is_initialized():
        dist.destroy_process_group()
    _device = None


def local_slice(n):
    """The rows of an n-row batch that this rank owns: the contiguous
    block [r n / W, (r + 1) n / W); n must divide by W."""
    w, r = world_size(), rank()
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} ranks")
    return slice(r * n // w, (r + 1) * n // w)


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


@torch.no_grad()
def _unflat_(flat, tensors):
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


# The helpers below are identities without a group, and run their
# collective in a group of any size, one rank included.

def broadcast_(tensors, src=0):
    """Overwrite each tensor with rank `src`'s, as one flattened bucket
    (one collective a call)."""
    tensors = list(tensors)
    if not is_initialized() or not tensors:
        return tensors
    flat = _flat(tensors)
    dist.broadcast(flat, src)
    _unflat_(flat, tensors)
    return tensors


def all_reduce_mean_(tensors):
    """Replace each tensor by its mean over the ranks, as one flattened
    bucket: a step issues one collective per parameter set, not one per
    tensor.  Every rank ends with the same bits."""
    tensors = list(tensors)
    if not is_initialized() or not tensors:
        return tensors
    flat = _flat(tensors)
    dist.all_reduce(flat)
    flat /= world_size()
    _unflat_(flat, tensors)
    return tensors


def mean_over_ranks(tensors):
    """Tensors of one shape (losses, metrics) averaged over the ranks, as
    a list: one collective for all of them."""
    tensors = list(tensors)
    if not is_initialized() or not tensors:
        return tensors
    stacked = torch.stack([t.detach() for t in tensors])
    all_reduce_mean_([stacked])
    return list(stacked)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward pass is the same sum of the
    gradients (itself differentiable: R1 differentiates through it
    twice)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x):
    """The sum of x over the ranks, differentiable: each rank's gradient
    of x is the sum over the ranks of theirs of the result."""
    return _AllReduceSum.apply(x)


def gather_rows(x):
    """The rows of every rank's equal slice `x` (b, ...) in rank order:
    (W b, ...), differentiably (the backward pass sums each rank's
    gradient of its rows over the ranks).  An all-reduce of a zero-filled
    buffer in which each rank writes its own rows: gloo has no all-gather
    for CUDA tensors."""
    w, r, b = world_size(), rank(), x.shape[0]
    return all_reduce_sum(torch.cat([
        x.new_zeros((r * b,) + x.shape[1:]), x,
        x.new_zeros(((w - r - 1) * b,) + x.shape[1:])]))


def gather_rows_of(tensors):
    """`gather_rows` of several tensors with one leading batch axis, as one
    collective; returns the gathered tensors."""
    tensors = list(tensors)
    if not is_initialized():
        return tensors
    b = tensors[0].shape[0]
    rows = gather_rows(torch.cat([t.detach().reshape(b, -1)
                                  for t in tensors], 1))
    out, i = [], 0
    for t in tensors:
        k = t[:1].numel()
        out.append(rows[:, i:i + k].reshape((-1,) + t.shape[1:]))
        i += k
    return out
