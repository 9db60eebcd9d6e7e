"""Smoke run of gan2shape_torch on one NVIDIA GPU (sm_90a, e.g. an H100).

    python3 chip_smoke.py

Phases, each of which must pass:
  1. the card: name and power limit (nvidia-smi); fails without CUDA;
  2. build the CUDA kernels from gan2shape_torch/csrc (one nvcc per source,
     all at once) into build/kernels/;
  3. hold every kernel against its plain PyTorch version on the card at the
     main path's shapes (B=1, 16 and 32; N and 16 * N of phase 9), (the
     raster kernels at windows 3 and 5, their
     payload buffers and keys bit-equal, the placement also on a folded
     warp; the splat within 4 ulps of its f32 plain version, bit-equal over
     SPLAT_REPEATS more calls and bit-equal to its fixed-point emulation,
     on synthetic starts and on splat calls captured from short runs of
     phase 6's fit, phase 9's instance trainer and the generalizing
     trainer's batched step 1), and time the kernel's wrapper, the plain
     version and, where one exists, one PyTorch call of the same function
     (a yardstick only), by CUDA events per call; beside each wrapper time,
     the kernel's own device time per launch (the splat's: its three
     kernels' a call), from torch.profiler by kernel name, and the least
     time the card could take for what the function must do on this data;
     then the StyleGAN2 epilogue's pair (`bias_act`, `bias_act_grad`) at
     car512's 512^2 and face128's 128^2 planes: forward bit-equal, grad_x
     equal, repeated bit for bit, timed beside the plain chain, and its
     host time a call beside the plain chain's;
  4. the rasterizer check (`gan2shape_torch.tools.check_raster`, the path of
     `raster_mega`, the counterpart of the JAX `_raster_mega_pallas`) at 64
     and 128 px, with the launch counts zeroed just before and read just
     after, its `raster_mega` checks held bit-exact; then `raster_mega`
     timed against the buffers path (its launches in the kernels line are
     those of the kernels it runs on this path: `place_collide_kernel`,
     `place_write_kernel` and `tests_kernel`);
  5. the other raster modes and the renders at full width: `warp_canon_depth`
     in 'scatter' and 'invwarp' mode at B=16 and `render_view` (mesh RGB) at
     B=1, 128 px, checked finite and covered, and timed;
  6. the main path at full width: the face-128 Trainer (image 128, GAN 128,
     channel_multiplier 1, z 512, 16 pseudo samples, LPIPS-VGG, box prior,
     seeded random weights) runs `fit` on one random image and latent, with
     every kernel's launch count zeroed just before and read just after;
     then a timed block of each step, the instance time it projects, and a
     torch.profiler window per step (device-busy share, the overlapping
     kernels by stream, top kernels);
  7. the entry points, in a temporary folder holding a written data/face
     set of 32 128-px PNGs with latents, on the face config of the port's
     `load_config` (paths and depth overridden): `cli.train` in instance
     mode on two images with checkpoints, `cli.evaluate --record-loss` on
     them (reloads bit-equal, step-1 losses equal to the trainer's within
     1e-6 relative), `--generalize` with batch_size 32 (its batched step 1
     timed, launches counted) and `--load-pretrained` from its checkpoint;
  8. the masker: seeded random BiSeNet and PSPNet-50 weights written as
     the reference's parsing checkpoints in a temporary folder, each
     `MaskingModel` built on the card by `make_masking_model`, its masks
     finite and in [0, 1], its logits against the same net's on the CPU,
     one forward timed (BiSeNet at 512², PSPNet at 473²); then `cli.train
     --n-instances 2` there, whose smoothed_confidence priors must come
     from the net;
  9. instances in parallel: the face-128 `InstanceParallelTrainer` at
     N_INSTANCES runs phase 6's fit with the launch counts zeroed before
     and read after, and must launch each kernel as often as phase 6's one
     instance did (one launch covers all instances); instance 0's step-1
     iteration-0 loss against a sequential Trainer's from the same init
     within 1e-5; then timed blocks and profiler windows of each step, the
     instance time it projects and the peak memory;
  10. the GAN side at the church config's GAN width (256², channel
     multiplier 2), in a temporary folder: `tools.prepare_data` of 64
     written 256² PNGs (the native mmap cache built by g++ and held against
     the plain numpy read), `tools.train_gan` at batch 16 with --augment for
     iterations 0-4 with a checkpoint at 4 (bit-equal to the live state)
     and resumed for 5-7, the trained g_ema in a GAN2Shape model of
     configs/church.yml (its image of a fixed z equal to sample_ema's
     within 1e-6 without cuDNN, within 1e-5 of its largest value with
     it), `tools.generate` (2 batches of 4 at truncation 0.7) and
     `tools.project` (2 images, 50 steps, LPIPS-VGG from written
     reference-layout files; the perceptual loss must fall), with the
     launch counts zeroed before and read after (none of the port's
     kernels lies on this path); then ms per train_step / d_reg_step /
     g_reg_step with and without the augmentation, images/s, a profiler
     window, peak memory; the iteration-0 losses and R1 at 256², batch 2,
     card against CPU within 1e-4 relative (the path penalty within 3e-4:
     see PATH_TOL), the CPU half after the card's; and LPIPS (VGG,
     Alex, Squeeze; net-lin and net) and L2 / DSSIM in RGB and Lab, card
     against CPU within 1e-5 of the largest value;
  11. the precision policy (gan2shape_torch/utils/precision.py; phases 1-10
     run at 'highest' / 'float32', set at the start): under 'high' and
     'default' the TF32 flags read back after a Renderer is built, and a
     4096² matmul and a 3x3 256-channel conv at 128² differ from 'highest'
     and run faster; at B=16, 128², grid mode, warp_canon_depth, its depth
     gradient, the raster keys, the resize and the view/light samples are
     bit-equal to 'highest'; under 'bfloat16' the face-128 G, D and
     LPIPS-VGG return f32 within JAX's bounds of their f32 run; then the
     gate (`gan2shape_torch.tools.check_precision`, the JAX gate's
     schedule: PRECISION lines with each verdict, the faster policies
     finite; the JSON in build/precision_check_torch.json) with a timed
     block and a profiler window of each step under each policy (TIME
     precision lines), and the GAN train_step at 256², channel multiplier
     2, batch 16 under each; the policy restored at the end;
  12. processes (gan2shape_torch/distributed.py), with the kernels built
     above: (a) in this process, a world of one rank over NCCL joined
     through torchrun's variables: an all-reduce, and a data_parallel
     GeneralizingTrainer's step-1 block at B=32 against a plain trainer's;
     then the one-process runs of (b)-(d) and two ranks on the card
     started by `python -m torch.distributed.run` over gloo (NCCL refuses
     two ranks on one device), killed with every process they started
     after DIST_TIMEOUT: (b) phase 9's N_INSTANCES instances split 4 + 4,
     held against one process training the same share and, at iteration
     0, against one process of all 8, each rank's launches equal to one
     process's; (c) GeneralizingTrainer with data_parallel over 32 images
     split 16 + 16 in fit's order (the batched prior, a step-1 block, one
     image's steps 2 and 3), the two ranks' nets bit-equal (a hash
     printed by each); (d) StyleGAN2 at phase 10's width, batch 16 split
     8 + 8 with ADA: iteration 0 of each step from the init within phase
     10's tolerances of one process and the gradients each step applied
     within 1e-4 of the largest, `tools.train_gan --distributed` for 2
     iterations with rank 0's checkpoint reloading.  (a)-(c) hold a rank
     to fixed limits (CARD_ITER0_TOL, INST_LIMITS, GEN_LIMITS), and the
     spread of two one-process runs to the same limits; TIME distributed
     lines (ms per iteration per rank, the collectives' share from a
     profiler window on rank 0, peak memory per rank);
  13. the tools (gan2shape_torch/tools): `bench` at full width (a warm-up
     and 2 timed blocks of 25/25/25, its JSON line re-printed as a BENCH
     line, every kernel of the main path launched, counts zeroed before and
     read after), `bench --instances N_INSTANCES` at 5 iterations a step;
     `full_instance_run` on a cut schedule (prior 20 + {5, 5, 5}, two
     instances); `check_pool_every --fast --floor` with K 1 and 2 (K=1
     run again for the floor that K=2's depth-MAD is read against: POOL
     lines); `bench_raster` and `chain_raster` at 128², B=16 on the
     pseudo-sample inputs (`raster_mega` against `dense_winner` exactly
     1); `run_real_assets` in an empty root (exit 2, every file listed),
     then --fast over seeded random release files written in the
     reference's layout (each read, a written port checkpoint giving the
     depth-MAD); FULL_RUN.json, POOL_EVERY_CHECK.json and RUN_REAL.json
     hashed before and after, unchanged;
  14. two card runs repeat: in a child process started with
     CUBLAS_WORKSPACE_CONFIG (cuBLAS reads it once, at its first handle),
     phase 6's fit twice from one seed under
     `gan2shape_torch.utils.precision.deterministic()`, every kernel
     launched (counts zeroed before each fit, read after), every loss and
     every net parameter bit-equal; twice more without the context (an
     INFO line with their gaps); then phase 6's timed blocks with and
     without it, in turns (TIME repeat lines);
  15. the other categories, each in a temporary folder of its own holding
     a written data/<category> set of CATEGORY_IMAGES 128-px images, a
     seeded random StyleGAN2 checkpoint at the config's gan_ckpt_path, size
     and width, and a PSPNet-50 parsing file: for cat (GAN 256, channel
     multiplier 1, 16 pseudo samples), church (256, 2, 8) and car (512, 2,
     8), the config of `load_config` (the smoothed_box prior and the depth
     overridden); `cli.train --prior smoothed_box --save-ckpts --images 0`
     (prior 20 + one 5/5/5 stage) with the launch counts zeroed before and
     read after, every kernel launched, losses finite, the written GAN
     checkpoint loaded, the prior from the net (church: the all-ones mask
     of a category outside VOC's); `cli.evaluate --record-loss` as in phase
     7; timed blocks and profiler windows of each step, the peak memory and
     the instance time projected (car's step 2 also under 'high'); car's
     `--generalize` at batch_size 8 (its batched step 1 timed); for church
     and car, the InstanceParallelTrainer at N=2 held to a sequential
     Trainer (launches, instance 0's iteration-0 loss within 1e-5), then
     the largest N of CATEGORY_NS whose memory, reckoned from the peaks of
     N=1 and N=2, fits CATEGORY_HEADROOM of the card, for one timed block
     (its peak must fit too);
  16. one JSON line describing every kernel, the card line again, and last
     {"ok": true, "device": {...}}.

Any failure exits non-zero before the last line.  Kernel builds and run
outputs stay inside the checkout (build/).

    python3 chip_smoke.py --kernels

runs phases 1-3 only and ends the same way.  It times whatever kernel
sources the checkout holds, so two builds are compared on one card by
running it in turns in two checkouts (the recipe is in README.md).

    python3 chip_smoke.py --precision

runs phases 1-3 and 11 and ends the same way, and

    python3 chip_smoke.py --distributed

phases 1-3 and 12;

    python3 chip_smoke.py --distributed-planted

phases 1-3 and 12 without (a), with faults planted in the ranks
(FAULTS: G2S_SMOKE_PLANT names them, default draws,unaveraged,stddev):
the checks of the planted faults must fail, and only those;

    python3 chip_smoke.py --tools

phases 1-3 and 13;

    python3 chip_smoke.py --repeat

phases 1-3 and 14;

    python3 chip_smoke.py --categories

phases 1-3 and 15.  `--kernels` also saves the captured splat calls to
SPLAT_CALLS, and

    python3 chip_smoke.py --splat-times build/splat_calls.pt

times this checkout's splat on the synthetic calls and on those, with no
check, so that two checkouts' splats are compared on the same calls (the
recipe is in README.md).
"""

import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FACE128 = {
    "image_size": 128, "gan_size": 128, "z_dim": 512,
    "channel_multiplier": 1, "category": "face", "n_proj_samples": 16,
    "n_epochs_prior": 20, "learning_rate": 1e-4, "prior_name": "box",
    "rot_center_depth": 1.0, "fov": 10,
}
STAGE = {"step1": 5, "step2": 5, "step3": 5}
# instances trained at once in the instance-parallel phase: its step 2
# renders and inverts 16 * N pseudo samples in one batch
N_INSTANCES = 8
TIMED_ITERS = 10
PROFILED_ITERS = 3
# the instance schedule of main.py: 1000 prior epochs, then stages
# {700, 700, 600} + 3 x {200, 500, 400} of step 1, 2, 3
SCHEDULE = {"prior": 1000, "step1": 1300, "step2": 2200, "step3": 1800}
VIEWS = [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
         [0.12, -0.2, 0.05, 0.02, -0.02, 0.03],
         [-0.25, 0.3, -0.1, -0.05, 0.04, -0.06],
         [0.3, 0.15, -0.2, 0.05, 0.05, -0.05]]
# large yaws and shifts over a depth step: the far sheet folds over the near
# one, so faces collide in their payload slots, and part of each grid
# leaves the padded viewport
FOLD_VIEWS = [[0.1, 0.5, 0.0, 0.04, 0.0, 0.0],
              [-0.2, -0.6, 0.1, -0.03, 0.02, 0.0],
              [0.0, 0.7, -0.2, 0.0, -0.04, 0.05],
              [0.3, -0.4, 0.0, 0.03, 0.03, 0.0]]

KERNELS = {
    "raster_place": ("gan2shape_torch/csrc/raster.cu",
                     "gan2shape_tpu/ops/rasterize.py:781"),
    "raster_tests": ("gan2shape_torch/csrc/raster.cu",
                     "gan2shape_tpu/ops/rasterize.py:482"),
    "fetch2x2": ("gan2shape_torch/csrc/window.cu",
                 "gan2shape_tpu/ops/splat_window.py:126"),
    "splat2x2": ("gan2shape_torch/csrc/window.cu",
                 "gan2shape_tpu/ops/splat_window.py:33"),
    "raster_mega": ("gan2shape_torch/csrc/raster.cu",
                    "gan2shape_tpu/ops/rasterize.py:595"),
}
# raster_mega launches no kernel of its own: it runs the kernels of
# raster_place and raster_tests, counted by those wrappers
SERVED_BY = {"raster_mega": ("raster_place", "raster_tests")}
# the CUDA kernel names (as torch.profiler reports them) behind each entry;
# a wrapper's call launches each of its kernels once
KERNEL_NAMES = {"raster_place": ("place_collide_kernel",
                                 "place_write_kernel"),
                "raster_tests": ("tests_kernel",),
                "fetch2x2": ("fetch2x2_kernel",),
                "splat2x2": ("splat_amax_kernel", "splat2x2_kernel",
                             "splat_convert_kernel"),
                "raster_mega": ("place_collide_kernel", "place_write_kernel",
                                "tests_kernel")}
# the kernels each driven path must launch
MAIN_PATH = ("raster_place", "raster_tests", "fetch2x2", "splat2x2")
CHECK_PATH = ("raster_place", "raster_tests", "fetch2x2")
# the splat's batches on the main path, at 128 px and C=3 (no gradient
# reaches the C=6 render): 1 (steps 1 and 3), N_INSTANCES (the instance
# trainer's steps 1 and 3), 16 (the step-3 pool), 32 (the generalizing
# step 1) and 16 * N_INSTANCES
SPLAT_BATCHES = (1, N_INSTANCES, 16, 32, 16 * N_INSTANCES)
SPLAT_REPEATS = 10        # calls that must repeat the first's bits
CAPTURED_PER_LABEL = 2    # captured calls kept of each step and shape
SPLAT_CALLS = "build/splat_calls.pt"  # --kernels saves its captured calls


class Failed(Exception):
    pass


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps=30, warmup=3):
    """Mean milliseconds per call by CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(prof):
    """The device activities of a torch.profiler run: kernels, copies and
    memsets, not the user-annotation ranges it also puts on the device."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_times(fn, reps=30, warmup=3, attempts=3):
    """Device time of what `fn` launches, by name, from torch.profiler over
    `reps` calls after warm-up: {name: (ms per launch, launches per call)}.
    A window in which the profiler delivered no device activity is taken
    again, up to `attempts` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = {}
        for e in device_events(prof):
            us, n = total.get(e.name, (0.0, 0))
            total[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        if total:
            return {k: (us / n / 1e3, n / reps)
                    for k, (us, n) in total.items()}
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{attempts} windows")


def device_summary(times, names):
    """(device ms per launch of the kernels whose names contain one of
    `names`, device ms per call of everything the call launched, that
    breakdown as {short name: [ms per launch, launches per call]})."""
    own = [(ms, n) for k, (ms, n) in times.items()
           if any(x in k for x in names)]
    if not own:
        raise RuntimeError(f"no device time recorded for {names}")
    launches = sum(n for _, n in own)
    per_launch = sum(ms * n for ms, n in own) / launches
    per_call = sum(ms * n for ms, n in times.values())
    return per_launch, per_call, {short_name(k): [ms, n]
                                  for k, (ms, n) in times.items()}


def short_name(kernel):
    """A kernel's name without its return type and argument list."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()[:60]


def check(cond, what):
    print(("PASS " if cond else "FAIL ") + what, flush=True)
    if not cond:
        raise Failed(what)


# ---------------- inputs at the main path's shapes ----------------


def training_scene(renderer, b, seed):
    """Smooth depth maps (B, S, S) and training-scale views (rot, trans)."""
    import torch
    import torch.nn.functional as F
    from gan2shape_torch.rendering.renderer import get_transform_matrices

    g = torch.Generator(device="cuda").manual_seed(seed)
    s = renderer.image_size
    low = torch.randn(b, 1, s // 8, s // 8, generator=g, device="cuda")
    depth = 1.0 + 0.08 * torch.tanh(F.interpolate(
        low, size=(s, s), mode="bicubic", align_corners=False))[:, 0]
    views = torch.tensor((VIEWS * (b // len(VIEWS) + 1))[:b],
                         device="cuda")
    return (depth, *get_transform_matrices(views))


def screen_vertices(renderer, depth, rot, trans):
    """Vertices (vx, vy, vz) of depth maps under views, as the renderer
    projects them."""
    b, s, _ = depth.shape
    pts = renderer.get_warped_3d_grid(depth, rot, trans).reshape(b, -1, 3)
    return [t.reshape(b, s, s).contiguous()
            for t in renderer._project_screen(pts)]


def training_warp(renderer, b, seed):
    """Vertices of smooth depth maps under training-scale views."""
    return screen_vertices(renderer, *training_scene(renderer, b, seed))


def folded_warp(renderer, b):
    """Vertices of a depth map with a steep step under FOLD_VIEWS."""
    import torch
    from gan2shape_torch.rendering.renderer import get_transform_matrices

    s = renderer.image_size
    ys, xs = torch.meshgrid(torch.arange(s, device="cuda"),
                            torch.arange(s, device="cuda"), indexing="ij")
    step = torch.where(xs + 0.5 * ys < 0.6 * s, 0.95, 1.1)
    views = torch.tensor((FOLD_VIEWS * b)[:b], device="cuda")
    return screen_vertices(renderer, step.expand(b, s, s).contiguous(),
                           *get_transform_matrices(views))


def raster_work(bufs, h, w, window, near, far):
    """What the candidate tests must do on this data, by the plain version's
    own arithmetic: the slots some pixel tests that can cover a pixel (a
    face, |denom| > 0.5), those slots' (slot, offset) tests inside the image,
    and the candidates that cover their pixel.  Returns (slots, offset
    tests, covered candidates, all candidates)."""
    from gan2shape_torch.ops import rasterize as R
    b = bufs.shape[1]
    pad = window + 1
    n_faces = (h - 1) * (w - 1)
    live = []
    for parity in range(2):
        dx0, dy0, dx1, dy1, dx2, dy2 = bufs[parity, :, :, :, :6].float(
            ).unbind(3)
        cell = bufs[parity, :, :, :, 9]
        denom = (dy1 - dy2) * (dx0 - dx2) + (dx2 - dx1) * (dy0 - dy2)
        live.append((cell >= 0) & (denom.abs() > 0.5))  # (B, 2, 2, hp, wp)
    n_slots = sum(int(m[..., pad - window + 1:pad + h,
                        pad - window + 1:pad + w].sum()) for m in live)
    n_tests = n_inside = 0
    for parity in range(2):
        for oy in range(window):
            for ox in range(window):
                n_tests += int(live[parity][..., pad - oy:pad - oy + h,
                                            pad - ox:pad - ox + w].sum())
                for sy in range(2):
                    for sx in range(2):
                        sl = bufs[parity, :, sy, sx, :, pad - oy:pad - oy + h,
                                  pad - ox:pad - ox + w].float()
                        key = R._cand_key_int(*sl.unbind(1), ox, oy, parity,
                                              n_faces, near, far)
                        n_inside += int((key != R.SENTINEL).sum())
    return n_slots, n_tests, n_inside, 2 * 4 * window * window * b * h * w


# ---------------- phase 3: kernels against plain versions ----------------


def raster_ops(bufs, b, s, window, near, far):
    """f32 operations of placement and of the candidate tests at these
    inputs.  Placement: ~60 a face.  The tests need 15 a slot that can cover
    a pixel (a, bq, e, d, f, denom and its test, the three
    r_lo + r * r_step terms), 8 for each of its offset tests (px2, py2, the
    two numerators) and 18 more where the candidate covers its pixel (the
    two divisions, l2, the three comparisons, the depth and its
    quantization).  The yardstick of earlier versions, ~25 every candidate
    and ~17 a covering one, counts more than that (every offset of every
    slot, empty ones included) and is kept only to compare with them.
    Returns (placement, tests, yardstick, covered, candidates)."""
    n_slots, n_tests, n_inside, n_cand = raster_work(bufs, s, s, window,
                                                     near, far)
    return (2 * b * (s - 1) ** 2 * 60, 15 * n_slots + 8 * n_tests
            + 18 * n_inside, 25 * n_cand + 17 * n_inside, n_inside, n_cand)


def check_raster(results):
    import torch
    from gan2shape_torch.ops import rasterize as R
    from gan2shape_torch.rendering.renderer import Renderer

    near, far = 0.8, 1.2
    worst = 0
    # window 3 is the training default; window 5 is the reach of the exact
    # z-buffer, of `raster_window: 5` and of the rasterizer check
    # B=32 at 128 px is the generalizing trainer's batched step 1; B=N and
    # 16 * N the instance-parallel trainer's steps 1 and 2-3
    nb = N_INSTANCES * FACE128["n_proj_samples"]
    for window, cases in ((3, ((128, 1), (128, 16), (128, 32), (64, 4),
                               (128, N_INSTANCES), (128, nb))),
                          (5, ((128, 16), (64, 4)))):
        for s, b in cases:
            renderer = Renderer(FACE128, s, 0.9, 1.1, device="cuda")
            vx, vy, vz = training_warp(renderer, b, seed=s + b)
            bufs = R.raster_place(vx, vy, vz, window, near, far)
            key = R.raster_tests(bufs, s, s, window, near, far)
            torch.cuda.synchronize()
            covered = float((key != R.SENTINEL).float().mean())
            # the plain version on the same inputs, on the card and (up to
            # B=32, where the host's time stays short) the CPU
            for where in ("cuda", "cpu")[:2 if b <= 32 else 1]:
                v = [t.to(where) for t in (vx, vy, vz)]
                ref_bufs = R.build_winner_buffers_plain(*v, window, near, far)
                ref_key = R.dense_winner_plain(ref_bufs, s, s, window, near,
                                               far)
                # the test kernel alone, on the plain version's payloads
                key_on_ref = R.raster_tests(ref_bufs.cuda(), s, s, window,
                                            near, far).to(where)
                buf_eq = bool(torch.equal(bufs.to(where), ref_bufs))
                agree = float((key.to(where) == ref_key).float().mean())
                agree_t = float((key_on_ref == ref_key).float().mean())
                worst = max(worst, int((key.to(where).long()
                                        - ref_key.long()).abs().max()))
                check(buf_eq and agree == 1.0 and agree_t == 1.0
                      and covered > 0.5,
                      f"raster {s}px B={b} window {window} vs plain on "
                      f"{where}: payload buffers equal {buf_eq}, key "
                      f"agreement {agree:.6f}, tests kernel alone "
                      f"{agree_t:.6f} (== 1), covered {covered:.4f}")
    # a folded warp at 128 px: faces collide in their slots (fewer slots
    # won than faces placed) and some leave the padded viewport
    s = 128
    renderer = Renderer(FACE128, s, 0.9, 1.1, device="cuda")
    for window in (3, 5):
        for b in (1, 16):
            vx, vy, vz = folded_warp(renderer, b)
            bufs = R.raster_place(vx, vy, vz, window, near, far)
            won = int((bufs[:, :, :, :, 9] >= 0).sum())
            placed = faces_in_viewport(vx, vy, window + 1)
            n_faces = 2 * b * (s - 1) ** 2
            for where in ("cuda", "cpu"):
                ref = R.build_winner_buffers_plain(
                    *(t.to(where) for t in (vx, vy, vz)), window, near, far)
                buf_eq = bool(torch.equal(bufs.to(where), ref))
                check(buf_eq and won < placed < n_faces,
                      f"raster_place folded warp {s}px B={b} window "
                      f"{window} vs plain on {where}: payload buffers equal "
                      f"{buf_eq}, {won} slots won by {placed} faces placed "
                      f"of {n_faces}")
    # timings and bounds at the main path's calls, 128 px at B=16 (step 2's
    # pool, step 3) and B=1 (steps 1 and 3), at window 3 (the main path's;
    # B=16 goes into the kernels line) and window 5; at B=32, window 3
    # (the generalizing trainer's batched step 1); at B=N and 16 * N,
    # window 3 (the instance-parallel trainer's)
    for b, window in ((16, 3), (16, 5), (1, 3), (1, 5), (32, 3),
                      (N_INSTANCES, 3), (nb, 3)):
        vx, vy, vz = training_warp(renderer, b, seed=7)
        bufs = R.raster_place(vx, vy, vz, window, near, far)
        place_ops, tests_ops, yard_ops, n_inside, n_cand = raster_ops(
            bufs, b, s, window, near, far)
        # the vertex fields in, the payload buffers between (the collision
        # key scratch is not counted), the keys out
        buf_bytes = bufs.numel() * 2
        tests_bytes = buf_bytes + b * s * s * 4
        place_bound = bound_ms(3 * b * s * s * 4 + buf_bytes, place_ops)
        tests_bound = bound_ms(tests_bytes, tests_ops)
        timings = {
            "raster_place": (
                lambda: R.raster_place(vx, vy, vz, window, near, far),
                cuda_ms(lambda: R.build_winner_buffers_plain(
                    vx, vy, vz, window, near, far), reps=10),
                place_bound, None),
            "raster_tests": (
                lambda: R.raster_tests(bufs, s, s, window, near, far),
                cuda_ms(lambda: R.dense_winner_plain(bufs, s, s, window,
                                                     near, far), reps=5),
                tests_bound, bound_ms(tests_bytes, yard_ops)[0]),
        }
        for name, (fn, plain_ms, (bms, by), yard) in timings.items():
            ms = cuda_ms(fn)
            dev, dev_call, parts = device_summary(device_times(fn),
                                                  KERNEL_NAMES[name])
            extra = {} if yard is None else {"yardstick_ms": yard}
            if (b, window) == (16, 3):
                results[name] = {"max_abs_err": float(worst), "ms": ms,
                                 "device_ms": dev,
                                 "wrapper_device_ms": dev_call,
                                 "plain_ms": plain_ms, "bound_ms": bms,
                                 "bound_by": by, "library_ms": None,
                                 "library_device_ms": None, **extra}
            yard_text = "" if yard is None else \
                f", earlier yardstick {yard:.4f} ms"
            print(f"TIME {name}: {ms:.4f} ms, device {dev:.4f} ms per "
                  f"launch ({dev_call:.4f} ms per call: {parts}), plain "
                  f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}"
                  f"{yard_text}), at B={b} {s}px window {window} "
                  f"({n_inside} of {n_cand} candidates covered)", flush=True)


def faces_in_viewport(vx, vy, pad):
    """Faces whose half-pixel bbox start lies in the padded viewport: the
    faces placement puts into a slot."""
    import torch
    h, w = vx.shape[1:]
    n = 0
    for tri in (((0, 0), (1, 0), (0, 1)), ((0, 1), (1, 0), (1, 1))):
        bx2, by2 = (torch.floor(2 * torch.stack(
            [v[:, di:di + h - 1, dj:dj + w - 1] for di, dj in tri]).amin(0))
            for v in (vx, vy))
        n += int(((bx2 >= -2 * pad) & (bx2 < 2 * (w + pad))
                  & (by2 >= -2 * pad) & (by2 < 2 * (h + pad))).sum())
    return n


def window_inputs(b, c, s, seed):
    """Window starts of a smooth warp (pixel + small displacement)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    py = torch.arange(s, device="cuda").reshape(1, s, 1).expand(b, s, s)
    px = torch.arange(s, device="cuda").reshape(1, 1, s).expand(b, s, s)
    dy = torch.randint(-2, 3, (b, s, s), generator=g, device="cuda")
    dx = torch.randint(-2, 3, (b, s, s), generator=g, device="cuda")
    iy = (py + dy).clamp(0, s - 2).to(torch.int32).reshape(b, -1).contiguous()
    ix = (px + dx).clamp(0, s - 2).to(torch.int32).reshape(b, -1).contiguous()
    src = torch.randn(b, c, s, s, generator=g, device="cuda")
    gr = torch.randn(b, 4 * c, s * s, generator=g, device="cuda")
    return src, iy, ix, gr


def flat_index(iy, ix, c, h, w):
    """(B, 4C, P) index into src.view(B, C*H*W) for the one-call
    yardsticks."""
    import torch
    b = iy.shape[0]
    ch = torch.arange(c, device="cuda").reshape(1, 1, c, 1) * (h * w)
    taps = torch.stack([(iy + a) * w + (ix + t) for a in (0, 1)
                        for t in (0, 1)], 1).long()  # (B, 4, P)
    return (taps[:, :, None, :] + ch).reshape(b, 4 * c, -1)


def same_bits(a, b):
    """Bit-equality of two f32 tensors (a NaN equals the same NaN)."""
    import torch
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def check_splat(label, g, iy, ix, shape):
    """The splat kernel on one call: within 4 ulps of the largest value of
    the f32 plain version, the same bits on SPLAT_REPEATS calls, and bit
    for bit its fixed-point emulation.  Returns the max abs error."""
    import torch
    from gan2shape_torch.ops import splat_window as W

    d = W.splat2x2(g, iy, ix, shape)
    dref = W.splat2x2_plain(g, iy, ix, shape)
    err = float((d - dref).abs().max())
    scale = float(dref.abs().max())
    # the f32 sum rounds at each of a few adds a pixel, the kernel once: a
    # few ulps of the largest value
    tol = 4 * torch.finfo(torch.float32).eps * max(scale, 1.0)
    check(err <= tol, f"splat2x2 {label}: max abs err {err:.3e} at scale "
          f"{scale:.4g} (<= {tol:.3e})")
    same = all(same_bits(W.splat2x2(g, iy, ix, shape), d)
               for _ in range(SPLAT_REPEATS))
    check(same, f"splat2x2 {label}: {SPLAT_REPEATS} more calls bit-equal "
          f"to the first")
    check(same_bits(W.splat2x2_fixed_plain(g, iy, ix, shape), d),
          f"splat2x2 {label}: bit-equal to splat2x2_fixed_plain")
    return err


def per_call_ms(times, names=None):
    """Device ms a call from device_times' {name: (ms per launch, launches
    a call)}, of the activities whose names contain one of `names` (all of
    them for None).  The profiler sometimes drops a record (a memset seen
    29 times in 30 calls, once a kernel 6 times in 30), which would
    shrink a count: each activity counts as launched a whole number of
    times a call, at least once."""
    return sum(m * max(1, round(n)) for k, (m, n) in times.items()
               if names is None or any(x in k for x in names))


def time_splat(label, g, iy, ix, shape):
    """A TIME line of the splat on one call: its wrapper by CUDA events; the
    device time a call of its own kernels and of everything the call
    launches (torch.profiler); the plain version; one torch.scatter_add of
    the same function (a yardstick only) and its device time; and the
    bound: g and the starts read once, dsrc written once.  Returns the
    kernels-line entry (without max_abs_err)."""
    import torch
    from gan2shape_torch.ops import splat_window as W

    b, c, h, w = shape
    p = iy.shape[1]
    io_bytes = (b * 4 * c * p + b * c * h * w) * 4 + 2 * b * p * 4
    bms, by = bound_ms(io_bytes, b * p * 4 * c)
    fn = lambda: W.splat2x2(g, iy, ix, shape)  # noqa: E731
    ms = cuda_ms(fn)
    times = device_times(fn)
    own = per_call_ms(times, KERNEL_NAMES["splat2x2"])
    dev_call = per_call_ms(times)
    plain = cuda_ms(lambda: W.splat2x2_plain(g, iy, ix, shape))
    zeros = torch.zeros(b, c * h * w, device="cuda")
    idx = flat_index(iy, ix, c, h, w).reshape(b, -1)
    gflat = g.reshape(b, -1)
    lib_fn = lambda: torch.scatter_add(zeros, 1, idx, gflat)  # noqa: E731
    lib = cuda_ms(lib_fn)
    lib_times = device_times(lib_fn)
    lib_dev = per_call_ms(lib_times)
    parts = {short_name(k): [round(m, 5), n] for k, (m, n) in times.items()}
    print(f"TIME splat2x2 {label}: {ms:.4f} ms, device {own:.4f} ms a call "
          f"in its kernels ({dev_call:.4f} ms all it launches: {parts}), "
          f"plain {plain:.4f} ms, torch.scatter_add {lib:.4f} ms (device "
          f"{lib_dev:.4f} ms), bound {bms:.4f} ms ({by}); device/bound "
          f"{own / bms:.2f}, device/scatter_add {own / lib_dev:.2f}",
          flush=True)
    return {"ms": ms, "device_ms": own, "wrapper_device_ms": dev_call,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "library_device_ms": lib_dev}


def synthetic_splat_calls():
    """The splat at each main-path batch of SPLAT_BATCHES, 128 px, C=3, on
    window_inputs' starts: [(label, g, iy, ix, shape)]."""
    calls = []
    for b in SPLAT_BATCHES:
        _, iy, ix, g = window_inputs(b, 3, 128, seed=99)
        calls.append((f"synthetic B={b} C=3", g, iy, ix, (b, 3, 128, 128)))
    return calls


def capture_splat_calls():
    """Real splat2x2 calls of the method, as its backward passes give them
    to the kernel: phase 6's fit (B=1 in steps 1 and 3, B=16 in step 3),
    the instance trainer's steps at N_INSTANCES (B=N and 16 * N) and the
    generalizing trainer's batched step 1 (B=32), from seeded random
    weights.  The first CAPTURED_PER_LABEL calls of each step and shape,
    copied: [(label, g, iy, ix, shape)]."""
    import numpy as np
    import torch
    from gan2shape_torch.core.trainer import GeneralizingTrainer, Trainer
    from gan2shape_torch.ops import gather_window
    from gan2shape_torch.parallel import InstanceParallelTrainer

    calls, where = [], {"source": "", "step": ""}

    def recording(real):
        def splat(g, iy, ix, shape):
            label = (f"{where['source']} {where['step']} B={shape[0]} "
                     f"C={shape[1]}")
            if sum(c[0] == label for c in calls) < CAPTURED_PER_LABEL:
                calls.append((label, g.clone(), iy.clone(), ix.clone(),
                              tuple(shape)))
            return real(g, iy, ix, shape)
        return splat

    def labelled(step):
        def make(real):
            def run(self, *args):
                where["step"] = step
                return real(self, *args)
            return run
        return make

    rng = np.random.default_rng(0)  # phase 6's image and latent
    image = rng.uniform(-1, 1, (3, 128, 128)).astype(np.float32)
    latent = rng.standard_normal(512).astype(np.float32)
    rng = np.random.default_rng(10)  # phase 9's
    n = N_INSTANCES
    images = torch.as_tensor(rng.uniform(-1, 1, (n, 3, 128, 128)).astype(
        np.float32), device="cuda")
    latents = torch.as_tensor(rng.standard_normal((n, 512)).astype(
        np.float32), device="cuda")
    batch = torch.as_tensor(np.random.default_rng(12).uniform(
        -1, 1, (ENTRY_IMAGES, 3, 128, 128)).astype(np.float32),
        device="cuda")
    with patched(gather_window, "splat2x2", recording), \
            patched(Trainer, "run_step1", labelled("step1")), \
            patched(Trainer, "run_step3", labelled("step3")):
        where["source"] = "fit"
        Trainer(FACE128, seed=0).fit([(image, latent, 0)], stages=[STAGE])
        where["source"] = "instances"
        trainer = InstanceParallelTrainer(FACE128, n, seed=0)
        collected, _ = trainer.run_step1(images, 2)
        coll2, _ = trainer.run_step2(images, latents, collected, 1)
        trainer.run_step3(images, latents, coll2, 2)
        del trainer
        where["source"] = "generalizing"
        GeneralizingTrainer(dist_face_config(), seed=0).run_step1(batch, 2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return calls


def displacement_box(iy, ix, shape):
    """For a call with one window per pixel (P = H*W): the largest box of
    window displacements (start minus pixel) over the batch's items, as
    (rows, cols), the (dy, dx) values a per-pixel walk over displacements
    would visit; None for other P."""
    import torch
    b, _, h, w = shape
    if iy.shape[1] != h * w:
        return None
    pix = torch.arange(h * w, device=iy.device)
    dy = iy.long() - pix // w
    dx = ix.long() - pix % w
    rows = dy.amax(1) - dy.amin(1) + 1
    cols = dx.amax(1) - dx.amin(1) + 1
    i = int((rows * cols).argmax())
    return int(rows[i]), int(cols[i])


def check_splat_calls(calls, results):
    """check_splat on every call, and time_splat on the first of each
    label; the synthetic B=16 call's timing goes into the kernels line."""
    timed = set()
    worst = results.get("splat2x2", {}).get("max_abs_err", 0.0)
    for label, g, iy, ix, shape in calls:
        worst = max(worst, check_splat(label, g, iy, ix, shape))
        if label not in timed:
            timed.add(label)
            print(f"INFO splat2x2 {label}: largest displacement box of an "
                  f"item {displacement_box(iy, ix, shape)} (rows, cols)",
                  flush=True)
            entry = time_splat(label, g, iy, ix, shape)
            if label == "synthetic B=16 C=3":
                results["splat2x2"] = entry
    results["splat2x2"]["max_abs_err"] = worst


def time_saved_splats(path):
    """`--splat-times FILE`: time this checkout's splat on the synthetic
    calls and on the captured calls saved in FILE (by `--kernels`), the
    first of each label; no checks.  Two checkouts' kernels are compared
    by running it in each, in turns, on one FILE."""
    import torch

    saved = torch.load(path)
    calls = synthetic_splat_calls() + [
        (label, g.cuda(), iy.cuda(), ix.cuda(), shape)
        for label, g, iy, ix, shape in saved]
    timed = set()
    for label, g, iy, ix, shape in calls:
        if label not in timed:
            timed.add(label)
            time_splat(label, g, iy, ix, shape)


def check_window(results):
    """The fetch and the splat against their plain versions at the main
    path's (B, C), both timed; then the splat on the method's own calls."""
    import torch
    from gan2shape_torch.ops import splat_window as W

    worst_fetch, worst_splat = 0.0, 0.0
    # the main path's (B, C) at 128 px: C=3 vertex fields and textures at
    # B=1 (steps 1, 3) and B=16 (step 2 pool, step 3), and C=6 at B=16, the
    # step-2 pseudo-sample render's image with its 3-channel mask in one
    # fetch; the splat runs at C=3 only (no gradient reaches that render);
    # C=3 at B=32 is the generalizing trainer's batched step 1; C=3 at B=N
    # and C=3 and 6 at B=16 * N are the instance-parallel trainer's
    nb = N_INSTANCES * FACE128["n_proj_samples"]
    for b, c in ((1, 3), (16, 3), (16, 6), (32, 3), (N_INSTANCES, 3),
                 (nb, 3), (nb, 6)):
        s = 128
        src, iy, ix, gr = window_inputs(b, c, s, seed=b * 10 + c)
        out = W.fetch2x2(src, iy, ix)
        ref = W.fetch2x2_plain(src, iy, ix)
        err = float((out - ref).abs().max())
        worst_fetch = max(worst_fetch, err)
        check(err == 0.0, f"fetch2x2 C={c} B={b}: max abs err {err}"
              " (bit-exact)")
        worst_splat = max(worst_splat, check_splat(
            f"C={c} B={b}", gr, iy, ix, (b, c, s, s)))
    # the fetch's timings at its largest main-path call, B=16 and 128 px
    # at C=6 (image + mask; it goes into the kernels line), then at the
    # generalizing step 1's B=32, C=3, and at the instance-parallel
    # trainer's B=N and 16 * N
    s = 128
    for b, c in ((16, 6), (32, 3), (N_INSTANCES, 3), (nb, 3), (nb, 6)):
        src, iy, ix, _ = window_inputs(b, c, s, seed=99)
        idx = flat_index(iy, ix, c, s, s)
        io_bytes = (b * c * s * s + b * 4 * c * s * s) * 4 + 2 * b * s * s * 4
        bms, by = bound_ms(io_bytes, b * s * s * 4 * c)
        flat = src.reshape(b, -1)
        fn = lambda: W.fetch2x2(src, iy, ix)  # noqa: E731
        plain = cuda_ms(lambda: W.fetch2x2_plain(src, iy, ix))
        lib_fn = lambda: torch.gather(flat, 1,  # noqa: E731
                                      idx.reshape(b, -1))
        ms = cuda_ms(fn)
        times = device_times(fn)
        dev, dev_call, parts = device_summary(times, KERNEL_NAMES["fetch2x2"])
        lib = cuda_ms(lib_fn)
        lib_times = device_times(lib_fn)
        lib_dev = sum(m * n for m, n in lib_times.values())
        if b == 16:
            results["fetch2x2"] = {"max_abs_err": worst_fetch, "ms": ms,
                                   "device_ms": dev,
                                   "wrapper_device_ms": dev_call,
                                   "plain_ms": plain, "bound_ms": bms,
                                   "bound_by": by, "library_ms": lib,
                                   "library_device_ms": lib_dev}
        print(f"TIME fetch2x2: {ms:.4f} ms, device {dev:.4f} ms per launch "
              f"({dev_call:.4f} ms per call: {parts}), plain {plain:.4f} ms, "
              f"library {lib:.4f} ms (device {lib_dev:.4f} ms: "
              f"{ {short_name(k): v for k, v in lib_times.items()} }), bound "
              f"{bms:.4f} ms ({by}), at B={b} {s}px C={c}", flush=True)
    # the splat at every main-path batch on synthetic starts, then on the
    # method's own calls; B=16 synthetic goes into the kernels line
    results["splat2x2"] = {"max_abs_err": worst_splat}
    t0 = time.perf_counter()
    captured = capture_splat_calls()
    print(f"captured {len(captured)} splat2x2 calls of the method in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{sorted({c[0] for c in captured})}", flush=True)
    check_splat_calls(synthetic_splat_calls() + captured, results)
    return captured


# the StyleGAN2 epilogue's largest main-path planes: car512's 512^2 layer
# at 64 images (car512-n8's step 2) and face128's 128^2 layer at 128
# images (face128-n8's)
BIAS_ACT_SHAPES = {"car512 512^2": (64, 64, 512, 512),
                   "face128 128^2": (128, 128, 128, 128)}
BIAS_ACT_HOST_SHAPE = (16, 512, 4, 4)  # face128's first layer, one instance
BIAS_ACT_HOST_CALLS = 200


def check_bias_act():
    """The StyleGAN2 epilogue (ops/fused_act.py, csrc/bias_act.cu) against
    the plain chain at the main path's largest planes: the forward bit for
    bit, grad_x equal, grad_demod within a reduction-order tolerance, a
    second call the same bits; each kernel timed beside the plain chain's
    forward or backward and its byte bound.  Then the host time of one
    call with gradients on, the wrapper against the plain chain, at the
    smallest plane, where the host sets the pace."""
    import torch
    from gan2shape_torch.ops import fused_act as FA

    slope, gain = 0.2, FA.SQRT2
    for label, shape in BIAS_ACT_SHAPES.items():
        b, c, h, w = shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(shape, device="cuda", generator=gen)
        x[:, ::4, ::3, ::2] = 0
        demod = torch.rand(b, c, device="cuda", generator=gen) + 0.5
        noise = 0.3 * torch.randn(1, 1, h, w, device="cuda", generator=gen)
        noise[..., ::3, :] = 0
        bias = torch.randn(c, device="cuda", generator=gen)
        bias[::4] = 0
        g = torch.randn(shape, device="cuda", generator=gen)

        def fwd():
            return FA._forward(x, demod, noise, bias, None, slope, gain,
                               want_mask=True)

        y, mask = fwd()
        check(same_bits(y, FA.bias_act_plain(x, demod, noise, bias)),
              f"bias_act {label}: forward bit-equal to the plain chain")

        def bwd():
            return FA._grad(g, mask, x, demod, None, True, True, False, False,
                            slope, gain)

        gx, gd = bwd()[:2]
        leaves = [t.clone().requires_grad_(True) for t in (x, demod)]
        plain_y = FA.bias_act_plain(leaves[0], leaves[1], noise, bias)
        want = torch.autograd.grad(plain_y, leaves, g, retain_graph=True)
        gd_err = float(((gd - want[1]).abs()
                        / (gain * (g * x).abs().sum((2, 3)))).max())
        check(torch.equal(gx, want[0]) and gd_err <= 16 * 2 ** -23,
              f"bias_act {label}: grad_x equal to the plain chain's, "
              f"grad_demod within {gd_err:.2e} of the sum of its terms' "
              f"magnitudes (<= 16 f32 units)")
        y2, mask2 = fwd()
        gx2, gd2 = bwd()[:2]
        check(same_bits(y2, y) and torch.equal(mask2, mask)
              and same_bits(gx2, gx) and same_bits(gd2, gd),
              f"bias_act {label}: a second call gives the same bits")
        n = x.numel()
        for name, fn, kernel, io_bytes, plain in (
                ("bias_act", fwd, "bias_act_kernel", 8 * n + n // 8,
                 lambda: FA.bias_act_plain(x, demod, noise, bias)),
                ("bias_act_grad", bwd, "bias_act_grad_kernel",
                 12 * n + n // 8,
                 lambda: torch.autograd.grad(plain_y, leaves, g,
                                             retain_graph=True))):
            ms = cuda_ms(fn)
            dev = per_call_ms(device_times(fn), (kernel,))
            plain_ms = cuda_ms(plain)
            bms, by = bound_ms(io_bytes, 0)
            print(f"TIME {name}: {ms:.4f} ms, device {dev:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
                  f"{100 * bms / dev:.1f}% of it), at {label} "
                  f"{tuple(shape)} f32", flush=True)
        del x, g, y, y2, mask, mask2, gx, gx2, leaves, plain_y, want
        torch.cuda.empty_cache()

    b, c, h, w = BIAS_ACT_HOST_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    args = [torch.randn(b, c, h, w, device="cuda", generator=gen),
            torch.rand(b, c, device="cuda", generator=gen) + 0.5,
            torch.randn(1, 1, h, w, device="cuda", generator=gen),
            torch.randn(c, device="cuda", generator=gen)]
    args = [t.requires_grad_(True) for t in args]
    host = {}
    for name, fn in (("wrapper", FA.bias_act), ("plain", FA.bias_act_plain),
                     ("wrapper", FA.bias_act), ("plain", FA.bias_act_plain)):
        for _ in range(10):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BIAS_ACT_HOST_CALLS):
            fn(*args)
        host[name] = (time.perf_counter() - t0) / BIAS_ACT_HOST_CALLS * 1e6
        torch.cuda.synchronize()
    print(f"HOST bias_act: {host['wrapper']:.2f} us a call with gradients "
          f"on, the plain chain {host['plain']:.2f} us, at "
          f"{BIAS_ACT_HOST_SHAPE} (second of two turns each)", flush=True)


def check_raster_gradients():
    """rasterize_depth on the card (kernels) against the plain path on the
    CPU: depth within 1e-5, vertex gradients within 5e-5 relative."""
    import torch
    from gan2shape_torch.ops.rasterize import rasterize_depth_grid
    from gan2shape_torch.rendering.renderer import Renderer

    renderer = Renderer(FACE128, 128, 0.9, 1.1, device="cuda")
    verts = training_warp(renderer, 16, seed=3)
    g = torch.randn(verts[0].shape, device="cuda")
    outs = []
    for dev in ("cuda", "cpu"):
        v = [t.detach().to(dev).requires_grad_(True) for t in verts]
        depth = rasterize_depth_grid(*v, window=3, near=0.8, far=1.2)
        (depth * g.to(dev)).sum().backward()
        outs.append((depth.detach().cpu(), [t.grad.cpu() for t in v]))
    (d_k, g_k), (d_p, g_p) = outs
    derr = float((d_k - d_p).abs().max())
    gerr = max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(g_k, g_p))
    check(derr <= 1e-5 and gerr <= 5e-5,
          f"rasterize_depth B=16 128px: depth max abs err {derr:.3e} "
          f"(<= 1e-5), vertex-gradient rel err {gerr:.3e} (<= 5e-5)")


# ---------------- phase 4: the rasterizer check (raster_mega) ------------


def run_check_path(results):
    """`check_raster.run_checks` on the card at 64 and 128 px, with the
    launch counts zeroed before and read after, its `raster_mega` checks
    held bit-exact; then `raster_mega` and the buffers path timed at 128 px,
    B=4, window 5.  Returns the path's launch counts."""
    import torch
    from gan2shape_torch.ops import _cuda
    from gan2shape_torch.ops import rasterize as R
    from gan2shape_torch.rendering.renderer import Renderer
    from gan2shape_torch.tools import check_raster as CR

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = CR.run_checks(sizes=(64, 128), batch=4, device="cuda")
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    print(f"check_raster at 64 and 128 px, B=4, in "
          f"{time.perf_counter() - t0:.2f} s on {res['device']}; launches "
          f"{launches}", flush=True)
    for c in res["checks"]:
        cov = (f", covered agreement {c['covered_agreement']:.6f} (>= "
               f"{c['covered_min']})" if "covered_agreement" in c else "")
        print(("PASS" if c["pass"] else "FAIL") + f" check_raster "
              f"{c['check']}: agreement {c['agreement']:.6f} (>= "
              f"{c['min']}){cov}", flush=True)
    check(res["ok"], f"every check_raster check passed "
          f"({len(res['checks'])} checks)")
    # on the card the kernels compute the buffers path's function exactly,
    # so hold raster_mega's checks to bit-equality, tighter than the tool's
    mega = [c for c in res["checks"] if c["check"].startswith("raster_mega")]
    err = max(c["max_abs_err"] for c in mega)
    check(len(mega) == 2 and err == 0.0
          and all(c["agreement"] == 1.0 for c in mega),
          f"raster_mega vs the buffers path at 64 and 128 px, B=4, window "
          f"5: max abs err {err} (bit-exact)")
    missing = [k for k in CHECK_PATH if launches[k] == 0]
    check(not missing, f"every kernel of the check path launched (none "
          f"missing: {missing})")

    s, b, window, near, far = 128, 4, 5, 0.8, 1.2
    renderer = Renderer(FACE128, s, 0.9, 1.1, device="cuda")
    vx, vy, vz = training_warp(renderer, b, seed=11)
    bufs = R.raster_place(vx, vy, vz, window, near, far)
    place_ops, tests_ops, yard_ops, n_inside, n_cand = raster_ops(
        bufs, b, s, window, near, far)
    # the fused function's own inputs and outputs: the vertex fields in,
    # cell and parity (f32) and covered (bool) out
    io_bytes = 3 * b * s * s * 4 + b * s * s * 9
    bms, by = bound_ms(io_bytes, place_ops + tests_ops)
    yard = bound_ms(io_bytes, place_ops + yard_ops)[0]
    fn = lambda: R.raster_mega(vx, vy, vz, window, near, far)  # noqa: E731
    ms = cuda_ms(fn)
    # its device ms: the three kernel launches of one call
    dev, dev_call, parts = device_summary(device_times(fn),
                                          KERNEL_NAMES["raster_mega"])
    dev *= len(KERNEL_NAMES["raster_mega"])
    plain = cuda_ms(lambda: R.dense_winner(vx, vy, vz, window, near, far),
                    reps=5)
    results["raster_mega"] = {"max_abs_err": err, "ms": ms,
                              "device_ms": dev, "wrapper_device_ms": dev_call,
                              "plain_ms": plain, "bound_ms": bms,
                              "bound_by": by, "library_ms": None,
                              "library_device_ms": None,
                              "yardstick_ms": yard}
    print(f"TIME raster_mega: {ms:.4f} ms, device {dev:.4f} ms in its three "
          f"kernel launches ({dev_call:.4f} ms per call: {parts}), plain "
          f"{plain:.4f} ms, bound {bms:.4f} ms ({by}, earlier yardstick "
          f"{yard:.4f} ms), at B={b} {s}px window {window} ({n_inside} of "
          f"{n_cand} candidates covered)", flush=True)
    return launches


# ---------------- phase 5: the other raster modes and the renders ---------


def run_modes_and_renders():
    """`warp_canon_depth` in 'scatter' and 'invwarp' mode at B=16 and
    `render_view` (mesh RGB, 9 yaw + 5 pitch frames) at B=1, 128 px:
    finite, covered, timed."""
    import torch
    from gan2shape_torch.rendering.renderer import Renderer

    renderer = Renderer(FACE128, 128, 0.9, 1.1, device="cuda")
    far = renderer.max_depth + renderer.margin
    depth, rot, trans = training_scene(renderer, 16, seed=5)
    for mode in ("scatter", "invwarp"):
        d = renderer.warp_canon_depth(depth, rot, trans, raster_mode=mode)
        covered = float((d < far).float().mean())
        check(bool(torch.isfinite(d).all()) and covered > 0.5,
              f"warp_canon_depth {mode} B=16 128px: finite, covered "
              f"{covered:.4f} (> 0.5)")
        ms = cuda_ms(lambda: renderer.warp_canon_depth(
            depth, rot, trans, raster_mode=mode), reps=5, warmup=1)
        print(f"TIME warp_canon_depth {mode}: {ms:.3f} ms per call at B=16 "
              f"128px (window {max(renderer.raster_window, 5)}, search "
              f"{renderer.raster_search})", flush=True)
    g = torch.Generator(device="cuda").manual_seed(6)
    # colours inside (-1, 1): a covered pixel never equals the background 1
    im = torch.rand(1, 3, 128, 128, generator=g, device="cuda") * 1.8 - 0.9
    frames = renderer.render_view(im, depth[:1])
    torch.cuda.synchronize()
    covered = (frames != 1.0).float().mean((0, 2, 3, 4))
    check(tuple(frames.shape) == (1, 14, 3, 128, 128)
          and bool(torch.isfinite(frames).all())
          and float(covered.mean()) > 0.5,
          f"render_view B=1 128px: 14 frames finite, covered "
          f"{float(covered.mean()):.4f} on average (> 0.5), per frame "
          f"{[round(float(c), 3) for c in covered]}")
    ms = cuda_ms(lambda: renderer.render_view(im, depth[:1]), reps=3,
                 warmup=1)
    print(f"TIME render_view: {ms:.3f} ms per call at B=1 128px (9 yaw + 5 "
          f"pitch mesh-RGB frames)", flush=True)


# ---------------- phase 6: the main path ----------------


def run_main_path():
    """Returns (launch counts of `fit`, ms/iter of each step)."""
    import numpy as np
    import torch
    from gan2shape_torch.core.trainer import Trainer
    from gan2shape_torch.ops import _cuda

    t0 = time.perf_counter()
    trainer = Trainer(FACE128, seed=0)  # device defaults to CUDA
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (3, 128, 128)).astype(np.float32)
    latent = rng.standard_normal(512).astype(np.float32)
    print(f"trainer built in {time.perf_counter() - t0:.2f} s", flush=True)

    _cuda.reset_launches()
    t0 = time.perf_counter()
    history = trainer.fit([(image, latent, 0)], stages=[STAGE])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    print(f"fit (prior {FACE128['n_epochs_prior']} + {STAGE}) in "
          f"{fit_s:.2f} s; launches {launches}", flush=True)
    rec = history[0]
    losses = rec["losses_step1"] + rec["losses_step2"] + rec["losses_step3"]
    check(len(losses) == sum(STAGE.values())
          and all(math.isfinite(x) for x in losses),
          f"fit losses finite: step1 {rec['losses_step1']}, step2 "
          f"{rec['losses_step2']}, step3 {rec['losses_step3']}")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    check(not missing, f"every kernel of the main path launched "
          f"(none missing: {missing})")

    # timed block: each step's iterations alone, with per-step launches
    img = torch.as_tensor(image, device="cuda")[None]
    lat = torch.as_tensor(latent, device="cuda")[None]
    n = TIMED_ITERS
    prior = torch.full((128, 128), 1.0, device="cuda")
    per_step, (l0, l1, l2, l3), collected, coll2 = timed_steps(
        trainer, img, lat, prior, n)
    for name, (ms, counts) in per_step.items():
        print(f"STEP {name}: {ms:.2f} ms/iter over {n} iterations; "
              f"launches per iteration "
              f"{ {k: v / n for k, v in counts.items()} }", flush=True)
    step_ms = sum(per_step[s][0] for s in ("step1", "step2", "step3"))
    print(f"STEPS/S {3e3 / step_ms:.3f} (step1+2+3 mix, {n} iterations "
          f"each, face-128, n_proj 16)", flush=True)
    instance_s = sum(k * per_step[s][0] for s, k in SCHEDULE.items()) / 1e3
    print(f"INSTANCE {instance_s:.1f} s projected for the face schedule "
          f"{SCHEDULE} from these per-iteration times", flush=True)
    check(all(math.isfinite(float(x)) for x in l0 + l1 + l2 + l3),
          "timed-block losses finite")
    step_ms = {k: v[0] for k, v in per_step.items()}
    profile_steps(trainer, img, lat, prior, collected, coll2, step_ms)
    return launches, step_ms


def timed_steps(trainer, img, lat, prior, n):
    """A timed block of `n` iterations of each step, alone, by the host
    clock around synchronised runs.  Returns ({step: (ms/iter, launches in
    the block)}, the four loss lists, collected, collected2)."""
    import torch
    from gan2shape_torch.ops import _cuda

    per_step = {}

    def timed(name, fn):
        _cuda.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per_step[name] = ((time.perf_counter() - t) * 1e3 / n,
                          dict(_cuda.LAUNCHES))
        return out

    l0 = timed("prior", lambda: trainer.run_prior(img, prior, n))
    collected, l1 = timed("step1", lambda: trainer.run_step1(img, n))
    coll2, l2 = timed("step2", lambda: trainer.run_step2(img, lat, collected,
                                                         n))
    l3 = timed("step3", lambda: trainer.run_step3(img, lat, coll2, n))
    return per_step, (l0, l1, l2, l3), collected, coll2


def profile_steps(trainer, img, lat, prior, collected, coll2, step_ms,
                  label=""):
    """One torch.profiler window of PROFILED_ITERS iterations per step:
    device-busy ms per iteration, its share of the unprofiled ms/iter of
    the timed block (`step_ms`; the profiler slows the host), CUDA kernels
    per iteration, the kernels that take the most device time, and the
    ported kernels' share.  Reports; never fails the run.  Returns {step:
    device-busy ms/iter}, None for a window that was not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = PROFILED_ITERS
    runs = {"prior": lambda: trainer.run_prior(img, prior, n),
            "step1": lambda: trainer.run_step1(img, n),
            "step2": lambda: trainer.run_step2(img, lat, collected, n),
            "step3": lambda: trainer.run_step3(img, lat, coll2, n)}
    busy = {}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        try:
            busy[name] = report_profile(label + name, prof, wall_us,
                                        step_ms[name], n)
        except Exception as exc:  # a measurement only: say so, run on
            busy[name] = None
            print(f"PROFILE {label}{name}: not measured ({exc!r})",
                  flush=True)
    return busy


def busy_union_us(events):
    """Microseconds in which at least one of `events` ran on the device:
    activities that overlap in time count once."""
    busy, end = 0.0, None
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def overlapping_pairs(events):
    """(earlier, later, overlap us) for each device activity that starts
    before the activity that has ended last so far ends."""
    pairs, last = [], None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if last is not None and e.time_range.start < last.time_range.end:
            pairs.append((last, e, min(e.time_range.end, last.time_range.end)
                          - e.time_range.start))
        if last is None or e.time_range.end > last.time_range.end:
            last = e
    return pairs


def activity_label(e):
    """An activity's stream and name, for the overlap report."""
    return f"stream {e.device_resource_id} {e.name[:60]}"


def report_overlaps(name, kernels, n):
    """Which device activities overlap in time, by stream and name: the
    overlapped time that `busy_union_us` counts once.  On the H100 they
    are kernels on cuDNN's and cuFFT's side streams (grouped and FFT
    convolutions), not annotation ranges."""
    pairs = overlapping_pairs(kernels)
    by_pair = {}
    for a, b, us in pairs:
        key = (activity_label(a), activity_label(b))
        count, total = by_pair.get(key, (0, 0.0))
        by_pair[key] = (count + 1, total + us)
    streams = sorted({e.device_resource_id for e in kernels})
    print(f"OVERLAP {name}: {len(pairs) / n:.1f} overlapping pairs/iter, "
          f"{sum(p[2] for p in pairs) / n / 1e3:.3f} ms/iter overlapped; "
          f"device streams {streams}", flush=True)
    for (a, b), (count, us) in sorted(by_pair.items(),
                                      key=lambda kv: -kv[1][1])[:2]:
        print(f"  {count / n:6.1f}/iter {us / n / 1e3:8.3f} ms/iter  {a}  "
              f"| {b}", flush=True)


def report_profile(name, prof, wall_us, step_ms, n):
    kernels = device_events(prof)
    report_overlaps(name, kernels, n)
    sum_us = sum(e.time_range.elapsed_us() for e in kernels)
    busy_us = busy_union_us(kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    ours = sum(v for k, v in by_name.items()
               if any(s in k for names in KERNEL_NAMES.values()
                      for s in names))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    busy_ms = busy_us / n / 1e3
    print(f"PROFILE {name}: device busy {busy_ms:.2f} ms/iter = "
          f"{busy_ms / step_ms:.1%} of the unprofiled {step_ms:.2f} ms/iter "
          f"(idle {1 - busy_ms / step_ms:.1%}; profiled wall "
          f"{wall_us / n / 1e3:.2f} ms/iter; the activities' own times sum "
          f"to {sum_us / n / 1e3:.2f} ms/iter), {len(kernels) / n:.0f} "
          f"device activities/iter, ported kernels "
          f"{ours / max(sum_us, 1e-9):.2%} of device time", flush=True)
    for k, v in top:
        print(f"  {v / sum_us:6.1%} {v / n / 1e3:8.3f} ms/iter "
              f"{k[:110]}", flush=True)
    return busy_ms


# ---------------- phase 7: the entry points ----------------

ENTRY_IMAGES = 32  # the face config's batch_size: one generalizing batch
ENTRY_STAGE = {"step1": 5, "step2": 5, "step3": 5}
GENERALIZING_STAGE = {"step1": 13, "step2": 1, "step3": 1}


class patched:
    """Replace `owner.name` by `make(original)` inside a with block."""

    def __init__(self, owner, name, make):
        self.owner, self.name, self.make = owner, name, make

    def __enter__(self):
        self.had = self.name in vars(self.owner)
        self.real = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self.make(self.real))

    def __exit__(self, *exc):
        if self.had:
            setattr(self.owner, self.name, self.real)
        else:
            delattr(self.owner, self.name)


def write_image_set(root, n, size, seed, category="face"):
    """A data/<category> set as download_data.py lays it out: list.txt,
    PNGs and latents/*.pt."""
    import os

    import numpy as np
    import torch
    from PIL import Image

    rng = np.random.default_rng(seed)
    folder = os.path.join(root, "data", category)
    os.makedirs(os.path.join(folder, "latents"))
    names = []
    for i in range(n):
        name = f"{i:06d}.png"
        Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                     dtype=np.uint8)).save(
            os.path.join(folder, name))
        torch.save(torch.from_numpy(rng.standard_normal(
            (1, 512)).astype(np.float32)),
            os.path.join(folder, "latents", name[:-4] + ".pt"))
        names.append(name)
    with open(os.path.join(folder, "list.txt"), "w") as f:
        f.write("".join(n + "\n" for n in names))


def all_finite(values):
    return len(values) > 0 and all(math.isfinite(v) for v in values)


def run_entry_points(card):
    """`cli.train.run` and `cli.evaluate.run` on a written data/face set of
    ENTRY_IMAGES 128-px images, with the face config from the port's
    `load_config` (only paths and depth overridden), in a temporary folder:
    (a) instance training of two images with checkpoints, (b) their
    evaluation with --record-loss, (c) --generalize over one batch of 32,
    (d) --load-pretrained from (c)'s checkpoint.  Returns the launch
    counts of (c)'s batched step 1."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from gan2shape_torch.cli import evaluate as E
    from gan2shape_torch.cli import train as T
    from gan2shape_torch.core import checkpoint as C
    from gan2shape_torch.core.dataset import ImageLatentDataset
    from gan2shape_torch.core.trainer import GeneralizingTrainer
    from gan2shape_torch.ops import _cuda
    from gan2shape_torch.utils.config import load_config

    root = Path(__file__).resolve().parent
    here = os.getcwd()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_image_set(tmp, ENTRY_IMAGES, 128, seed=5)
        config = load_config(
            category="face", config_dir=str(root / "configs"),
            minimal_config=str(root / "minimal_config.yml"),
            overrides={"root_path": os.path.join(tmp, "data"),
                       "our_nets_ckpts": {
                           "VLADE_nets": os.path.join(tmp, "ckpts")},
                       "n_epochs_prior": 20, "n_epochs_generalized": 1})
        check(config["image_size"] == 128 and config["gan_size"] == 128
              and config["channel_multiplier"] == 1
              and config["n_proj_samples"] == 16
              and config["batch_size"] == ENTRY_IMAGES,
              f"face config from load_config: image {config['image_size']}, "
              f"GAN {config['gan_size']}, channel_multiplier "
              f"{config['channel_multiplier']}, n_proj_samples "
              f"{config['n_proj_samples']}, batch_size "
              f"{config['batch_size']}, prior {config['prior_name']}")
        os.chdir(tmp)  # results/ goes here
        try:
            instance_and_evaluation(T, E, C, _cuda, config)
            data = ImageLatentDataset(os.path.join(tmp, "data", "face"),
                                      image_size=config["image_size"])
            fitted, launches = generalizing(T, C, GeneralizingTrainer, _cuda,
                                            config, data, card)
            resume(T, C, config, fitted, data)
        finally:
            os.chdir(here)
    print(f"TIME entry points phase: {time.perf_counter() - t_phase:.2f} s "
          f"wall (train, evaluate, generalize, resume; {card})", flush=True)
    return launches


def instance_and_evaluation(T, E, C, _cuda, config, images=(0, 1),
                            flags=()):
    """(a) and (b) of `run_entry_points` on `config`'s category and data:
    `cli.train --save-ckpts --images ...` (with `flags`) and `cli.evaluate
    --record-loss` of its checkpoints.  Returns (the trainer, the launch
    counts of cli.train, its history)."""
    import os

    import numpy as np
    import torch
    from gan2shape_torch.core.dataset import ImageDataset

    category = config["category"]
    picked = [str(i) for i in images]

    snapshots = {}

    def snapshot_save(real):
        def save(self, nets, img_idx, *rest):
            snapshots[img_idx] = {n: {k: v.detach().clone() for k, v in
                                      nets[n].state_dict().items()}
                                  for n in C.NETS}
            return real(self, nets, img_idx, *rest)
        return save

    args_list = ["--category", category, "--save-ckpts", *flags,
                 "--images", *picked]
    args = T.parse_args(args_list)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with patched(C.CheckpointManager, "save", snapshot_save):
        trainer, history = T.run(config, args, stages=[ENTRY_STAGE])
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    print(f"cli.train {category} instance mode: {len(images)} images, "
          f"prior {config['n_epochs_prior']} + {ENTRY_STAGE} in "
          f"{time.perf_counter() - t0:.2f} s; launches {launches}",
          flush=True)
    ckpts = config["our_nets_ckpts"]["VLADE_nets"]
    files = os.listdir(os.path.join(ckpts, category))
    counts = {img: (sum(f.startswith(f"manifest_image_{img}_")
                        for f in files),
                    sum(f"_image_{img}_" in f and f.endswith(".pth")
                        for f in files)) for img in images}
    losses = [x for h in history for k in ("losses_step1", "losses_step2",
                                           "losses_step3") for x in h[k]]
    check([h["image"] for h in history] == list(images)
          and len(losses) == len(images) * sum(ENTRY_STAGE.values())
          and all_finite(losses)
          and counts == {img: (1, 5) for img in images}
          and sorted(snapshots) == list(images),
          f"cli.train {' '.join(args_list)}: {len(losses)} losses finite, "
          f"per image (manifests, .pth files) {counts}")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    check(not missing, f"every kernel of the main path launched in "
          f"cli.train {category} (none missing: {missing})")

    # (b) the evaluation reloads what the trainer saved
    mgr = C.CheckpointManager(ckpts)
    equal = {int(img): all(torch.equal(nets[n][k], v.cpu())
                           for n in C.NETS
                           for k, v in snapshots[int(img)][n].items())
             for img, nets in mgr.load_per_image(category)}
    check(equal == {img: True for img in images},
          f"{category} reloaded state_dicts bit-equal to the trainer's: "
          f"{equal}")
    eargs = E.parse_args(["--category", category, "--record-loss",
                          "--images", *picked])
    t0 = time.perf_counter()
    records = E.run(config, eargs)
    torch.cuda.synchronize()
    print(f"cli.evaluate {category} --record-loss: {len(records)} images in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    data = ImageDataset(os.path.join(config["root_path"], category),
                        image_size=config["image_size"])
    worst = 0.0
    for r in records:
        C.load_nets(trainer.model, snapshots[r["image"]])
        with torch.no_grad():
            want, _ = trainer.model.forward_step1(torch.as_tensor(
                data[r["image"]], device=trainer.device)[None])
        worst = max(worst, abs(r["loss"] - float(want)) / abs(float(want)))
    finite = all(bool(np.isfinite(r["recon"]).all()
                      and np.isfinite(r["depth"]).all()) for r in records)
    check([r["image"] for r in records] == list(images) and worst <= 1e-6
          and finite and os.path.exists("results/step1_losses.npy"),
          f"cli.evaluate {category}: step-1 losses "
          f"{[round(r['loss'], 6) for r in records]} from the checkpoints "
          f"equal the trainer's in-memory model's within {worst:.2e} "
          f"relative (<= 1e-6); reconstructions and depths finite")
    return trainer, launches, history


def generalizing(T, C, GeneralizingTrainer, _cuda, config, data, card,
                 stage=GENERALIZING_STAGE, flags=()):
    """(c): --generalize (with `flags`) over one batch of all of `data`
    with checkpoints, on `config`'s category, its batch_size the size of
    `data`; the batched step 1 timed and its launches counted.  Returns
    the nets' state after the fit and the step's launch counts."""
    import numpy as np
    import torch

    category = config["category"]
    n_images = len(data)
    step1 = []

    def counted_step1(real):
        def run_step1(self, images, n_iters):
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t = time.perf_counter()
            out = real(self, images, n_iters)
            torch.cuda.synchronize()
            step1.append((images.shape[0], n_iters,
                          time.perf_counter() - t, dict(_cuda.LAUNCHES)))
            return out
        return run_step1

    args_list = ["--category", category, "--save-ckpts", *flags,
                 "--generalize"]
    args = T.parse_args(args_list)
    t0 = time.perf_counter()
    with patched(GeneralizingTrainer, "run_step1", counted_step1):
        trainer, history = T.run(config, args, stages=[stage])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = ([h["loss_step1"] for h in history]
              + [x for h in history for k in ("losses_step1", "losses_step2",
                                              "losses_step3")
                 for x in h.get(k, [])])
    (m,) = C.CheckpointManager(config["our_nets_ckpts"]["VLADE_nets"]
                               ).select(category, img_idx="")
    check(len(history) == n_images == config["batch_size"]
          and all_finite(losses)
          and len(history[-1]["losses_step1"]) == stage["step1"]
          and (m["image"], m["stage"]) == ("", 0)
          and m["total_it"] == history[-1]["total_it"],
          f"cli.train {' '.join(args_list)}, batch_size "
          f"{config['batch_size']}: "
          f"{len(history)} image records, {len(losses)} losses finite, "
          f"epoch-0 general checkpoint (image '{m['image']}', stage "
          f"{m['stage']}, total_it {m['total_it']})")
    (b, n, dt, launches), = step1
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    check(b == n_images and n == stage["step1"] and not missing,
          f"{category} batched step 1 at B={b}, {n} iterations: launches "
          f"{launches} (none missing: {missing})")
    print(f"TIME generalizing {category} step 1 at B={b} 128px: "
          f"{dt * 1e3 / n:.2f} ms per iteration over the fit's {n}-iteration "
          f"block (its invariants included); fit {fit_s:.2f} s (prior "
          f"{config['n_epochs_prior']} at B={b}, {stage}; "
          f"{card})", flush=True)
    fitted = {n: {k: v.clone() for k, v in
                  trainer.model.nets[n].state_dict().items()}
              for n in C.NETS}
    # a timed block of TIMED_ITERS after the fit, as phase 6 times its steps
    images = torch.as_tensor(np.stack([data[i][0] for i in range(len(data))]),
                             device=trainer.device)
    trainer.run_step1(images, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, l1 = trainer.run_step1(images, TIMED_ITERS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / TIMED_ITERS
    check(all_finite([float(x) for x in l1]),
          f"timed generalizing {category} step-1 losses finite")
    print(f"TIME generalizing {category} step 1 at B={n_images} 128px: "
          f"{ms:.2f} ms per iteration over a timed block of {TIMED_ITERS} "
          f"({card})", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.run_step1(images, PROFILED_ITERS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    try:
        report_profile(f"generalizing {category} step1 B={n_images}", prof,
                       wall_us, ms, PROFILED_ITERS)
    except Exception as exc:  # a measurement only: say so, run on
        print(f"PROFILE generalizing step1: not measured ({exc!r})",
              flush=True)
    return fitted, launches


def resume(T, C, config, fitted, data):
    """(d): --load-pretrained from (c)'s checkpoint: the nets equal the
    saved ones and the trainer's after its fit (`fitted`), and the prior
    does not run."""
    import torch

    resumed = T.build_trainer(config, T.parse_args(
        ["--category", "face", "--generalize", "--load-pretrained"]))
    saved = C.CheckpointManager(
        config["our_nets_ckpts"]["VLADE_nets"]).load_latest_general("face")
    equal = all(torch.equal(v.cpu(), saved[n][k])
                and torch.equal(v, fitted[n][k])
                for n in C.NETS
                for k, v in resumed.model.nets[n].state_dict().items())
    priors = []
    real_prior = resumed.run_prior
    resumed.run_prior = lambda *a: priors.append(a) or real_prior(*a)
    history = resumed.fit(data, stages=[{"step1": 1, "step2": 0,
                                         "step3": 0}],
                          batch_size=config["batch_size"])
    check(equal and not priors
          and all_finite([h["loss_step1"] for h in history]),
          f"--load-pretrained: the loaded nets equal the saved ones {equal}, "
          f"prior skipped {not priors}, {len(history)} records with finite "
          "step-1 losses")


# ---------------- phase 8: the masker ----------------

# (category, parsing file, net input size)
MASKER_NETS = (("face", "bisenet.pth", 512), ("car", "pspnet_voc.pth", 473))
MASKER_TOL = 1e-4  # of the largest |logit|: cuDNN against oneDNN, f32


def random_parsing_state_dict(category, seed):
    """A seeded random port BiSeNet / PSPNet-50 state_dict, BatchNorm
    running statistics randomised."""
    import torch
    from gan2shape_torch.models.segmentation import BiSeNet, PSPNet

    g = torch.Generator().manual_seed(seed)
    net = (BiSeNet(n_classes=19) if category == "face"
           else PSPNet(classes=21)).init_weights(g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.05 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.copy_(0.6 + 0.8 * torch.rand(
                    m.running_var.shape, generator=g))
    return net.state_dict()


def run_masker(card):
    """Random parsing checkpoints written in the reference's layout under
    a temporary checkpoints/parsing/: each MaskingModel built on the card
    by `make_masking_model`, its masks finite and in [0, 1], its logits
    against the same net's on the CPU, one forward timed; then `cli.train
    --n-instances 2` with the face config's smoothed_confidence prior,
    whose priors must come from the net (not the fallback ellipse).
    Returns {category: forward ms}."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from gan2shape_torch.cli import train as T
    from gan2shape_torch.core import masking as M
    from gan2shape_torch.core.priors import FallbackMasker, PriorGenerator
    from gan2shape_torch.parallel import sharding
    from gan2shape_torch.utils.config import load_config

    root = Path(__file__).resolve().parent
    here = os.getcwd()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            os.makedirs(os.path.join("checkpoints", "parsing"))
            rng = np.random.default_rng(8)
            image = rng.uniform(-1, 1, (1, 3, 128, 128)).astype(np.float32)
            for category, filename, size in MASKER_NETS:
                sd = random_parsing_state_dict(category, seed=size)
                torch.save({"state_dict": {f"module.{k}": v
                                           for k, v in sd.items()}},
                           os.path.join("checkpoints", "parsing", filename))
                masker = M.make_masking_model(category, 128, device="cuda")
                conf = masker.confidence_mask(image)
                hard = masker.image_mask(image)
                ok = all(bool(np.isfinite(m).all() and m.min() >= 0
                              and m.max() <= 1) for m in (conf, hard))
                check(isinstance(masker, M.MaskingModel)
                      and next(masker.net.parameters()).is_cuda and ok
                      and conf.shape == hard.shape == (1, 128, 128),
                      f"{category} MaskingModel from {filename} on the card:"
                      f" confidence and hard masks finite, in [0, 1], "
                      f"(1, 128, 128)")
                x = torch.as_tensor(rng.uniform(-1, 1, (1, 3, size, size))
                                    .astype(np.float32), device="cuda")
                with torch.no_grad():
                    got = masker.net(x).cpu()
                    want = M.MaskingModel(category, 128, state_dict=sd,
                                          device="cpu").net(x.cpu())
                scale = float(want.abs().max())
                err = float((got - want).abs().max())
                check(err <= MASKER_TOL * scale,
                      f"{category} net logits at 1x3x{size}^2, card against "
                      f"CPU (TF32 off): max abs err {err:.3e} at scale "
                      f"{scale:.3e} (<= {MASKER_TOL} of it)")
                with torch.no_grad():
                    fn = lambda: masker.net(x)  # noqa: E731
                    ms = cuda_ms(fn, reps=10)
                    dev = sum(m * n for m, n in device_times(
                        fn, reps=5).values())
                times[category] = ms
                print(f"TIME masker {category} forward at 1x3x{size}^2: "
                      f"{ms:.3f} ms by CUDA events, {dev:.3f} ms of device "
                      f"time by torch.profiler ({card})", flush=True)
            # the masker behind the priors of cli.train --n-instances
            write_image_set(tmp, 2, 128, seed=9)
            config = load_config(
                category="face", config_dir=str(root / "configs"),
                minimal_config=str(root / "minimal_config.yml"),
                overrides={"root_path": os.path.join(tmp, "data"),
                           "our_nets_ckpts": {"VLADE_nets": os.path.join(
                               tmp, "ckpts")},
                           "n_epochs_prior": 5})
            seen = []

            def capture(real):
                def fit(self, images, latents, priors=None, **kw):
                    seen.append((self.prior_generator.masking_model, images,
                                 priors))
                    return real(self, images, latents, priors, **kw)
                return fit

            args = T.parse_args(["--category", "face", "--n-instances",
                                 "2"])
            with patched(sharding.InstanceParallelTrainer, "fit", capture):
                _, history = T.run(config, args, stages=[
                    {"step1": 1, "step2": 1, "step3": 1}])
            (masker, images, priors), = seen
            size = config["image_size"]
            fallback = PriorGenerator(
                size, "face", config["prior_name"],
                masking_model=FallbackMasker(size))
            gap = max(float(np.abs(priors[i] - fallback(images[i])[0]).max())
                      for i in range(2))
            check(config["prior_name"] == "smoothed_confidence"
                  and isinstance(masker, M.MaskingModel)
                  and len(history) == 2 and gap > 1e-3,
                  f"cli.train --n-instances 2: {config['prior_name']} priors"
                  f" from the BiSeNet masker, {gap:.3e} from the fallback "
                  f"masker's at most")
        finally:
            os.chdir(here)
    return times


# ---------------- phase 9: instances in parallel ----------------


def counted_fit(trainer, images, latents, priors):
    """The instance trainer's fit of phase 6's stage with the launch counts
    zeroed just before and read just after: (history, launches, s)."""
    import torch
    from gan2shape_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    history = trainer.fit(images, latents, priors, stages=[STAGE])
    torch.cuda.synchronize()
    return history, dict(_cuda.LAUNCHES), time.perf_counter() - t0


def timed_instance_steps(trainer, img, lat, prior, k):
    """k iterations of the prior and of each step, each on the host clock
    around a synchronised block: ({step: ms/iter}, (step 1's and step 2's
    collected state), the losses)."""
    import torch

    per_step = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per_step[name] = (time.perf_counter() - t) * 1e3 / k
        return out

    l0 = timed("prior", lambda: trainer.run_prior(img, prior, k))
    collected, l1 = timed("step1", lambda: trainer.run_step1(img, k))
    coll2, l2 = timed("step2", lambda: trainer.run_step2(img, lat, collected,
                                                         k))
    l3 = timed("step3", lambda: trainer.run_step3(img, lat, coll2, k))
    return per_step, (collected, coll2), l0 + l1 + l2 + l3


def run_instances(card, seq_launches, seq_step_ms):
    """The face-128 InstanceParallelTrainer at N_INSTANCES on the card:
    phase 6's fit with the launch counts zeroed before and read after (each
    kernel launched as often as in phase 6's one-instance fit), instance
    0's step-1 iteration-0 loss against a sequential Trainer's from the
    same init, then a timed block and a profiler window of each step.
    Returns the fit's launch counts."""
    import numpy as np
    import torch
    from gan2shape_torch.core.trainer import Trainer
    from gan2shape_torch.parallel import InstanceParallelTrainer

    n = N_INSTANCES
    t0 = time.perf_counter()
    trainer = InstanceParallelTrainer(FACE128, n, seed=0)
    seq = Trainer(FACE128, seed=0)
    rng = np.random.default_rng(10)
    size = FACE128["image_size"]
    images = rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32)
    latents = rng.standard_normal((n, 512)).astype(np.float32)
    priors = np.stack([trainer.prior_generator(im)[0] for im in images])
    print(f"instance-parallel trainer of {n} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    img = torch.as_tensor(images, device="cuda")
    lat = torch.as_tensor(latents, device="cuda")
    with torch.no_grad():
        batched, _ = trainer.model.step1_iter(
            img, trainer.model.step1_invariants(img))
        alone, _ = seq.model.step1_iter(
            img[:1], seq.model.step1_invariants(img[:1]))
    rel = abs(float(batched[0]) - float(alone)) / abs(float(alone))
    check(batched.shape == (n,) and rel <= 1e-5,
          f"instance 0's step-1 iteration-0 loss {float(batched[0]):.7f} "
          f"against a sequential Trainer's {float(alone):.7f} from the same "
          f"init and image: {rel:.2e} relative (<= 1e-5)")
    del seq

    torch.cuda.reset_peak_memory_stats()
    history, launches, fit_s = counted_fit(trainer, images, latents, priors)
    print(f"instance-parallel fit of {n} (prior {FACE128['n_epochs_prior']} "
          f"+ {STAGE}) in {fit_s:.2f} s; launches {launches}", flush=True)
    losses = [x for h in history for k in ("losses_step1", "losses_step2",
                                           "losses_step3") for x in h[k]]
    check(len(history) == n and all_finite(losses)
          and len(losses) == n * sum(STAGE.values()),
          f"{n} instances' fit losses finite ({len(losses)} losses)")
    same = {k: (launches[k], seq_launches[k]) for k in MAIN_PATH}
    check(all(a == b > 0 for a, b in same.values()),
          f"each kernel launched as often for {n} instances as for one "
          f"(instances, one): {same}")

    k = TIMED_ITERS
    prior = torch.as_tensor(priors, device="cuda")
    per_step, (collected, coll2), timed_losses = timed_instance_steps(
        trainer, img, lat, prior, k)
    check(all(bool(torch.isfinite(x).all()) for x in timed_losses),
          "instance-parallel timed-block losses finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, ms in per_step.items():
        print(f"STEP instances {name}: {ms:.2f} ms/iter for {n} instances "
              f"({ms / n:.2f} ms an instance-iteration; one instance alone "
              f"{seq_step_ms[name]:.2f}) over {k} iterations", flush=True)
    step_ms = sum(per_step[s] for s in ("step1", "step2", "step3"))
    alone_ms = sum(seq_step_ms[s] for s in ("step1", "step2", "step3"))
    print(f"INSTANCE-ITERS/S {3e3 * n / step_ms:.3f} (step1+2+3 mix, {n} "
          f"instances; one instance alone {3e3 / alone_ms:.3f})", flush=True)
    projected = sum(c * per_step[s] for s, c in SCHEDULE.items()) / 1e3 / n
    alone = sum(c * seq_step_ms[s] for s, c in SCHEDULE.items()) / 1e3
    print(f"INSTANCE {projected:.1f} s projected per instance at N={n} for "
          f"the face schedule {SCHEDULE} (phase 6's one instance: "
          f"{alone:.1f} s); peak memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); {card}", flush=True)
    profile_steps(trainer, img, lat, prior, collected, coll2, per_step,
                  label=f"instances N={n} ")
    return launches


# ---------------- phase 10: the GAN side ----------------

GAN_SIZE = 256          # configs/church.yml: gan_size 256,
GAN_CM = 2              # channel_multiplier 2 (train_gan's defaults)
GAN_BATCH = 16
GAN_IMAGES = 64
GAN_TOL = 1e-4          # card against CPU, iteration-0 values, relative
# the path penalty squares a 196608-term sum of random-sign products: the
# CPU's own value moves 1.2e-4 between 6 and 8 threads, the card's 1.1e-4
# between runs
PATH_TOL = 3e-4
LPIPS_TOL = 1e-5        # card against CPU, of the largest value
SAMPLE_TOL = 1e-6       # GAN2Shape's generator against sample_ema
# the same with cuDNN on, of the image's largest value: cuDNN may pick
# another algorithm for each of two modules of equal shapes (5.84e-6 of
# values up to 5.34 apart in one run, 0 in others)
SAMPLE_CUDNN_TOL = 1e-5
PROJECT_STEPS = 50


def write_pngs(folder, n, size, seed):
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                     dtype=np.uint8)).save(
            os.path.join(folder, f"{i:06d}.png"))


def inject(trainer, inputs):
    """Replace the trainer's draws by `inputs` (numpy), consumed in call
    order: latents (z1, z2, take2), noise lists, (G, C) transforms and the
    path-length image."""
    import torch
    from gan2shape_torch.models.augment import augment

    dev = trainer.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    def mixed(g, batch):
        z1, z2, take2 = inputs["latents"].pop(0)
        w1, w2 = g.style_forward(t(z1)), g.style_forward(t(z2))
        return torch.where(t(take2)[None, :, None], w2[:, None],
                           w1[:, None])

    trainer._mixed_latent = mixed
    trainer._fresh_noise = lambda batch: [t(n) for n in
                                          inputs["noise"].pop(0)]
    trainer._maybe_augment = lambda img, p: augment(
        None, img, p, transforms=tuple(map(t, inputs["aug"].pop(0))))[0]
    trainer._path_noise = lambda shape: t(inputs["path"])


def gan_inputs(b, seed):
    """One step's injected draws for each of train_step, d_reg_step and
    g_reg_step, at batch `b` and GAN_SIZE."""
    import numpy as np
    import torch
    from gan2shape_torch.models import augment as A

    log_size = int(math.log2(GAN_SIZE))
    n_latent, num_layers = log_size * 2 - 2, (log_size - 2) * 2 + 1
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)

    def latent(n):
        take2 = np.arange(n_latent) >= rng.integers(1, n_latent)
        return (rng.standard_normal((n, 512)).astype(np.float32),
                rng.standard_normal((n, 512)).astype(np.float32), take2)

    def noise(n):
        return [rng.standard_normal((n, 1, 2 ** ((i + 5) // 2),
                                     2 ** ((i + 5) // 2))).astype(np.float32)
                for i in range(num_layers)]

    def aug():
        G = torch.linalg.inv(A.sample_affine(gen, 0.6, b, GAN_SIZE,
                                             GAN_SIZE))
        return G.numpy(), A.sample_color(gen, 0.6, b).numpy()

    return {"train": {"latents": [latent(b), latent(b)],
                      "noise": [noise(b), noise(b)],
                      "aug": [aug(), aug(), aug()]},
            "d_reg": {"aug": [aug()]},
            "g_reg": {"latents": [latent(1)], "noise": [noise(1)],
                      "path": rng.standard_normal(
                          (1, 3, GAN_SIZE, GAN_SIZE)).astype(np.float32)}}


def first_moments(optim):
    """Adam's first moment of each parameter, in order: with b1 = 0 (the
    GAN trainer's), the last step's gradient itself."""
    return [optim.state[p]["exp_avg"].detach().cpu()
            for g in optim.param_groups for p in g["params"]]


def iteration0_values(device, real, inputs=None, mesh=None, record=None):
    """train_step's D and G losses, R1 and the path penalty, each from the
    seeded init at GAN_SIZE on `device`, with `inputs` injected (None: the
    trainer's own draws, the whole batch's under a group's `mesh`).  A
    `record` dict also gets the gradients each step applied (Adam's first
    moments) and the nets after train_step."""
    import copy

    import torch
    from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer

    trainer = StyleGAN2Trainer(GAN_SIZE, channel_multiplier=GAN_CM,
                               use_augment=True, seed=0, device=device,
                               mesh=mesh)
    init = copy.deepcopy(trainer.state_dict())
    real = torch.as_tensor(real, device=trainer.device)
    out = {}
    for step in ("train", "d_reg", "g_reg"):
        for name in ("g", "d", "g_ema"):
            getattr(trainer, {"g": "generator", "d": "discriminator",
                              "g_ema": "g_ema"}[name]).load_state_dict(
                init[name])
        trainer.g_optim.load_state_dict(init["g_optim"])
        trainer.d_optim.load_state_dict(init["d_optim"])
        trainer.mean_path_length = init["mean_path_length"].clone()
        if inputs is not None:
            inject(trainer, copy.deepcopy(inputs[step]))
        if step == "train":
            m = trainer.train_step(real, 0.6)
            out["d_loss"], out["g_loss"] = float(m["d_loss"]), \
                float(m["g_loss"])
            if record is not None:
                record["train d"] = first_moments(trainer.d_optim)
                record["train g"] = first_moments(trainer.g_optim)
                record["after_train_step"] = {
                    k: {n: v.detach().cpu().clone() for n, v in
                        getattr(trainer, k).state_dict().items()}
                    for k in ("generator", "discriminator")}
        elif step == "d_reg":
            out["r1"] = float(trainer.d_reg_step(real, 0.6))
            if record is not None:
                record["r1 d"] = first_moments(trainer.d_optim)
        else:
            out["path"] = float(trainer.g_reg_step()["path_loss"])
            if record is not None:
                record["path g"] = first_moments(trainer.g_optim)
    return out


def gan_card_against_cpu(card):
    """Iteration 0 from the same weights and injected draws, batch 2 at
    GAN_SIZE, on the card and then on the CPU."""
    import numpy as np

    real = np.random.default_rng(12).uniform(
        -1, 1, (2, 3, GAN_SIZE, GAN_SIZE)).astype(np.float32)
    inputs = gan_inputs(2, seed=11)
    t0 = time.perf_counter()
    cuda = iteration0_values("cuda", real, inputs)
    t1 = time.perf_counter()
    cpu = iteration0_values("cpu", real, inputs)
    rel = {k: abs(cuda[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
    tol = {k: PATH_TOL if k == "path" else GAN_TOL for k in cpu}
    check(all(rel[k] <= tol[k] for k in cpu)
          and all(math.isfinite(v) and v != 0 for v in cpu.values()),
          f"GAN iteration 0 at {GAN_SIZE}^2, channel_multiplier {GAN_CM}, "
          f"batch 2, injected inputs, card against CPU (TF32 off): "
          + ", ".join(f"{k} {cuda[k]:.6g} vs {cpu[k]:.6g} ({rel[k]:.1e} "
                      f"<= {tol[k]})" for k in cpu) + " relative")
    print(f"TIME GAN card-against-CPU check: {t1 - t0:.2f} s wall on the "
          f"card, {time.perf_counter() - t1:.2f} s on the CPU ({card})",
          flush=True)


def gan_timing(trainer, real, card):
    """Device time of each step after warm-up by CUDA events, with and
    without the augmentation; a profiler window over one iteration of each;
    images/s of the lazy schedule; peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def per_call(fn, reps):
        fn()  # warm-up
        return cuda_ms(fn, reps=reps, warmup=0)

    torch.cuda.reset_peak_memory_stats()
    times = {}
    for aug in (True, False):
        trainer.use_augment = aug
        tag = "" if aug else " (no augmentation)"
        times["train_step" + tag] = per_call(
            lambda: trainer.train_step(real, 0.6), 3)
        times["d_reg_step" + tag] = per_call(
            lambda: trainer.d_reg_step(real, 0.6), 2)
    trainer.use_augment = True
    times["g_reg_step"] = per_call(trainer.g_reg_step, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, ms in times.items():
        print(f"TIME GAN {name}: {ms:.2f} ms per call by CUDA events at "
              f"{GAN_SIZE}^2, channel_multiplier {GAN_CM}, batch "
              f"{real.shape[0]} ({card})", flush=True)
    it_ms = (times["train_step"] + times["d_reg_step"] / trainer.d_reg_every
             + times["g_reg_step"] / trainer.g_reg_every)
    share = 1 - ((times["train_step (no augmentation)"]
                  + times["d_reg_step (no augmentation)"]
                  / trainer.d_reg_every
                  + times["g_reg_step"] / trainer.g_reg_every) / it_ms)
    print(f"IMAGES/S GAN {real.shape[0] * 1e3 / it_ms:.2f} (one iteration "
          f"{it_ms:.2f} ms: train_step + d_reg_step / "
          f"{trainer.d_reg_every} + g_reg_step / {trainer.g_reg_every}); "
          f"the augmentation {share:.1%} of it; peak memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); {card}", flush=True)

    def one_of_each():
        trainer.train_step(real, 0.6)
        trainer.d_reg_step(real, 0.6)
        trainer.g_reg_step()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        one_of_each()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = device_events(prof)
    busy_ms = busy_union_us(events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    print(f"PROFILE gan (one train_step + d_reg_step + g_reg_step): device "
          f"busy {busy_ms:.2f} ms of {wall_ms:.2f} ms profiled wall = "
          f"{busy_ms / wall_ms:.1%}; {len(events)} device activities; the "
          f"activities' own times sum to {total / 1e3:.2f} ms", flush=True)
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {v / total:6.1%} {v / 1e3:9.3f} ms {k[:110]}", flush=True)
    return times, peak


def gan_lpips_checks(card):
    """LPIPS (VGG, Alex, Squeeze) in net-lin and net modes and the L2 /
    DSSIM distances in RGB and Lab at 1x3x256^2, card against CPU."""
    import numpy as np
    import torch
    from gan2shape_torch.models.layers import reset_parameters
    from gan2shape_torch.models.lpips import LPIPS, perceptual_distance

    rng = np.random.default_rng(13)
    a, b = (rng.uniform(-1, 1, (1, 3, 256, 256)).astype(np.float32)
            for _ in range(2))
    times = {}
    ta, tb = (torch.as_tensor(x, device="cuda") for x in (a, b))
    for backbone in ("vgg", "alex", "squeeze"):
        full = LPIPS(backbone=backbone)
        reset_parameters(full, torch.Generator().manual_seed(14))
        for model in ("net-lin", "net"):
            net = LPIPS(backbone=backbone, lpips_heads=model == "net-lin")
            net.load_state_dict({k: v for k, v in full.state_dict().items()
                                 if k in net.state_dict()})
            gpu = LPIPS(backbone=backbone,
                        lpips_heads=model == "net-lin").cuda()
            gpu.load_state_dict(net.state_dict())
            with torch.no_grad():
                got = perceptual_distance(gpu, ta, tb, model=model).cpu()
                want = perceptual_distance(net, torch.as_tensor(a),
                                           torch.as_tensor(b), model=model)
            err = float((got - want).abs().max() / want.abs().max())
            check(err <= LPIPS_TOL, f"LPIPS {backbone} {model} at "
                  f"1x3x256^2, card against CPU: {err:.2e} of the largest "
                  f"value (<= {LPIPS_TOL})")
            if model == "net-lin":
                with torch.no_grad():
                    times[backbone] = cuda_ms(lambda: gpu(ta, tb), reps=10)
    for model in ("L2", "DSSIM"):
        for space in ("RGB", "Lab"):
            got = perceptual_distance(
                None, torch.as_tensor(a, device="cuda"),
                torch.as_tensor(b, device="cuda"), model=model,
                colorspace=space).cpu()
            want = perceptual_distance(None, torch.as_tensor(a),
                                       torch.as_tensor(b), model=model,
                                       colorspace=space)
            err = float((got - want).abs().max() / want.abs().max())
            check(err <= LPIPS_TOL, f"{model} in {space} at 1x3x256^2, "
                  f"card against CPU: {err:.2e} of the largest value "
                  f"(<= {LPIPS_TOL})")
    for backbone, ms in times.items():
        print(f"TIME LPIPS {backbone} net-lin at 1x3x256^2 (two images "
              f"through the trunk): {ms:.3f} ms per call by CUDA events "
              f"({card})", flush=True)
    return times


def run_gan_side(card):
    """The GAN side's user path on the card (prepare_data -> train_gan, 8
    iterations with a checkpoint and a resume -> the GAN2Shape model on the
    trained g_ema -> generate -> project, then the step times), the card
    against the CPU, and LPIPS.  Returns the numbers the run printed."""
    from pathlib import Path

    from gan2shape_torch import native

    root = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = native.build()
    print(f"BUILD native cache {lib.name} in {time.perf_counter() - t0:.2f} "
          f"s (g++)", flush=True)
    launched = gan_on_the_card(root, card)
    gan_card_against_cpu(card)
    lpips_ms = gan_lpips_checks(card)
    print(f"TIME GAN side phase: {time.perf_counter() - t_phase:.2f} s wall "
          f"({card})", flush=True)
    return {**launched, "lpips_ms": lpips_ms}


def write_reference_lpips(trunk_path, heads_path, seed):
    """Random LPIPS-VGG weights in the reference files' layout: the VGG16
    trunk as torchvision's `features.*` (from `seed`) and the lpips v0.1
    heads (from seed + 1)."""
    import torch
    from gan2shape_torch.models.layers import reset_parameters
    from gan2shape_torch.models.lpips import LPIPS

    net = LPIPS()
    reset_parameters(net, torch.Generator().manual_seed(seed))
    sd = net.state_dict()
    torch.save({k[4:]: v for k, v in sd.items() if k.startswith("vgg.")},
               trunk_path)
    heads = torch.Generator().manual_seed(seed + 1)
    torch.save({k: torch.rand(v.shape, generator=heads)
                for k, v in sd.items() if k.startswith("lin")}, heads_path)


def gan_on_the_card(root, card):
    """The GAN side's user path on the card, in a temporary folder, then
    the step times."""
    import os
    import tempfile

    import numpy as np
    import torch
    from gan2shape_torch import native
    from gan2shape_torch import projector as P
    from gan2shape_torch.convert.reference import load_gan_checkpoint
    from gan2shape_torch.core.dataset import MultiResolutionDataset
    from gan2shape_torch.core.model import GAN2Shape
    from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer
    from gan2shape_torch.ops import _cuda
    from gan2shape_torch.tools import generate, prepare_data, project, \
        train_gan
    from gan2shape_torch.utils.config import load_config

    _cuda.reset_launches()
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            write_pngs(os.path.join(tmp, "images"), GAN_IMAGES, GAN_SIZE,
                       seed=10)
            t0 = time.perf_counter()
            sizes = (GAN_SIZE // 2, GAN_SIZE)
            # with its worker pool, in this process, which holds torch's
            # threads and a CUDA context
            prepare_data.main(["--out", "data", "--size",
                               ",".join(map(str, sizes)), "--n_worker", "8",
                               "images"])
            ds = MultiResolutionDataset("data", resolution=GAN_SIZE)
            got = ds.get_batch([0, 63, 5], [False, True, False]).numpy()
            want = native.read_records_plain(
                os.path.join("data", f"{GAN_SIZE}.bin"), GAN_IMAGES,
                (3, GAN_SIZE, GAN_SIZE), [0, 63, 5])
            want[1] = want[1][..., ::-1]
            check(len(ds) == GAN_IMAGES and np.array_equal(got, want)
                  and sorted(os.listdir("data")) == sorted(
                      [f"{n}.bin" for n in sizes] + ["meta.json"]),
                  f"prepare_data of {GAN_IMAGES} {GAN_SIZE}^2 PNGs at sizes "
                  f"{sizes} in {time.perf_counter() - t0:.2f} s; the "
                  f"native mmap cache's batch equal to the plain numpy "
                  f"read (flips included)")

            base = ["data", "--size", str(GAN_SIZE), "--channel_multiplier",
                    str(GAN_CM), "--batch", str(GAN_BATCH), "--augment",
                    "--d_reg_every", "16", "--g_reg_every", "4",
                    "--n_sample", "16", "--out_dir", "run"]
            t0 = time.perf_counter()
            trainer, log = train_gan.run(train_gan.parse_args(
                base + ["--iter", "5", "--ckpt_every", "4"]))
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            ckpt = os.path.join("run", "checkpoint", "000004.pt")
            saved = torch.load(ckpt, map_location="cpu", weights_only=False)
            live = trainer.state_dict()
            same = all(torch.equal(saved[k][n], v.cpu())
                       for k in ("g", "d", "g_ema")
                       for n, v in live[k].items())
            same &= all(torch.equal(saved[k]["state"][i][n], v.cpu())
                        for k in ("g_optim", "d_optim")
                        for i, st in live[k]["state"].items()
                        for n, v in st.items())
            same &= torch.equal(saved["mean_path_length"],
                                live["mean_path_length"].cpu())
            t0 = time.perf_counter()
            resumed, log2 = train_gan.run(train_gan.parse_args(
                base + ["--iter", "8", "--ckpt", ckpt]))
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            log = log + log2
            vals = [x for r in log for x in (r["d"], r["g"], r["r1"],
                                            r["path"])]
            check([r["iter"] for r in log] == list(range(8))
                  and all_finite(vals) and log[0]["r1"] > 0
                  and log[0]["path"] > 0 and log[4]["path"] > 0 and same,
                  f"train_gan at {GAN_SIZE}^2, channel_multiplier {GAN_CM},"
                  f" batch {GAN_BATCH}, --augment: iterations 0-4 in "
                  f"{first_s:.2f} s, the checkpoint at 4 bit-equal to the "
                  f"live state, resumed 5-7 in {resume_s:.2f} s; losses "
                  f"finite, R1 at 0 ({log[0]['r1']:.4g}), path length at 0 "
                  f"and 4 ({log[0]['path']:.4g}, {log[4]['path']:.4g})")

            config = load_config(category="church",
                                 config_dir=str(root / "configs"),
                                 minimal_config=str(root /
                                                    "minimal_config.yml"))
            check(config["gan_size"] == GAN_SIZE
                  and config["channel_multiplier"] == GAN_CM,
                  f"church config from load_config: gan_size "
                  f"{config['gan_size']}, channel_multiplier "
                  f"{config['channel_multiplier']}")
            model = GAN2Shape(config)
            load_gan_checkpoint(model, ckpt)
            reader = StyleGAN2Trainer(GAN_SIZE, channel_multiplier=GAN_CM)
            reader.load_checkpoint(ckpt)
            weights = all(torch.equal(v, reader.g_ema.state_dict()[k])
                          for k, v in model.generator.state_dict().items())
            z = torch.as_tensor(np.random.default_rng(15).standard_normal(
                (1, 512)).astype(np.float32), device="cuda")
            zero = [torch.zeros_like(n) for n in model.generator.noise_list()]
            gaps = {}
            # cuDNN may pick other algorithms for two modules of equal
            # shapes (its plan cache keys on pointer alignment); without it
            # the two forwards are the same arithmetic
            for label, enabled in (("without cuDNN", False),
                                   ("with cuDNN", True)):
                with torch.no_grad(), torch.backends.cudnn.flags(
                        enabled=enabled):
                    img, _ = model.generator([z], zero)
                    want = reader.sample_ema(z)
                gaps[label] = float((img - want).abs().max())
            top = float(want.abs().max())
            check(weights and gaps["without cuDNN"] <= SAMPLE_TOL
                  and gaps["with cuDNN"] <= SAMPLE_CUDNN_TOL * top,
                  f"GAN2Shape (configs/church.yml) with the trained g_ema "
                  f"from load_gan_checkpoint: weights bit-equal, the image "
                  f"of a fixed z with zero noise {gaps['without cuDNN']:.2e} "
                  f"from sample_ema's without cuDNN (<= {SAMPLE_TOL}), "
                  f"{gaps['with cuDNN']:.2e} with it, of values up to "
                  f"{top:.3g} (<= {SAMPLE_CUDNN_TOL} of that)")
            del reader, model

            t0 = time.perf_counter()
            n = generate.run(generate.parse_args([
                "--ckpt", ckpt, "--size", str(GAN_SIZE),
                "--channel_multiplier", str(GAN_CM), "--sample", "4",
                "--pics", "2", "--truncation", "0.7", "--save_path",
                "samples"]))
            lats = [np.load(os.path.join("samples", "latents",
                                         f"{i:06d}.npy")) for i in range(n)]
            check(n == 8 and all(x.shape == (512,) and np.isfinite(x).all()
                                 for x in lats),
                  f"generate: 2 batches of 4 at truncation 0.7 in "
                  f"{time.perf_counter() - t0:.2f} s, latents finite")

            os.makedirs("lpips")
            write_reference_lpips(os.path.join("lpips", "vgg16.pth"),
                                  os.path.join("lpips", "vgg.pth"), seed=16)
            files = [os.path.join("samples", "000000.png"),
                     os.path.join("samples", "000005.png")]
            steps_ms = []

            def timed_step(real):
                def step(self, *a, **kw):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = real(self, *a, **kw)
                    torch.cuda.synchronize()
                    steps_ms.append((time.perf_counter() - t) * 1e3)
                    return out
                return step

            t0 = time.perf_counter()
            with patched(P.Projector, "step", timed_step):
                result = project.run(project.parse_args([
                    "--ckpt", ckpt, "--size", str(GAN_SIZE),
                    "--channel_multiplier", str(GAN_CM), "--step",
                    str(PROJECT_STEPS), "--vgg_ckpt",
                    os.path.join("lpips", "vgg16.pth"), "--lpips_ckpt",
                    os.path.join("lpips", "vgg.pth"), *files]))
            project_s = time.perf_counter() - t0
            losses = result["losses"]
            first, last = losses[0]["perceptual"], losses[-1]["perceptual"]
            step_ms = float(np.median(steps_ms[2:]))
            check(len(steps_ms) == PROJECT_STEPS and last < first
                  and os.path.exists("000000-project.png")
                  and os.path.exists(os.path.join("samples", "latents",
                                                  "000000.png.npy")),
                  f"project: 2 images at {GAN_SIZE}^2 with LPIPS-VGG "
                  f"net-lin from reference-layout files, {PROJECT_STEPS} "
                  f"steps in {project_s:.2f} s; perceptual loss "
                  f"{first:.4f} -> {last:.4f}")
            print(f"TIME project step: {step_ms:.2f} ms per step (median "
                  f"after 2, host clock around a synchronised step; 2 images"
                  f" at {GAN_SIZE}^2, LPIPS-VGG) ({card})", flush=True)

            real = ds.get_batch(np.arange(GAN_BATCH)).cuda()
            times, peak = gan_timing(resumed, real, card)
            del trainer, resumed
        finally:
            os.chdir(here)
    launched = dict(_cuda.LAUNCHES)
    check(all(launched[k] == 0 for k in MAIN_PATH)
          and launched["bias_act"] > 0 and launched["bias_act_grad"] > 0,
          f"the GAN side launched the StyleGAN2 epilogue's kernels (R1's "
          f"and the path penalty's double backward among them) and none "
          f"of the renderer's: {launched}")
    return {"steps_ms": times, "peak_gib": peak, "project_step_ms": step_ms,
            "launches": launched}


# ---------------- phase 11: the precision policy ----------------

# the JAX gate's schedule (tools/check_precision.py): 50 prior iterations,
# then 40 of each step with 16 pseudo samples, at face-128
PRECISION_ITERS = 40
PRECISION_N_PROJ = 16
FAST_POLICIES = ("high", "default")
MATMUL_N = 4096
CONV_SHAPE = (8, 256, 128)  # batch, channels in and out, size: a 3x3 conv
# JAX's own bounds for a bf16 stack against its f32 run
# (tests/test_stylegan2.py::test_bf16_activation_policy): the image's
# largest difference (JAX's 0.1 for images in [-1, 1], here over the f32
# image's largest magnitude where that is above 1: the random-weight
# generator's images reach about 3), the loss relative, the gradient cosine;
# LPIPS relative (with an absolute floor of 1e-4)
BF16_IMAGE, BF16_LOSS, BF16_COS = 0.1, 0.05, 0.95


def run_precision(card):
    """The precision policy on the card: the flags of each policy take
    effect (and no module built afterwards undoes them), the geometry is
    bit-equal under every policy, the bf16 frozen stacks return f32 within
    JAX's bounds of their f32 run; then the gate at the JAX gate's schedule
    with a timed block and a profiler window of each step under each
    policy, and the GAN train_step under each.  Restores the policy."""
    import torch
    from gan2shape_torch.utils import precision as P

    t_phase = time.perf_counter()
    before = (P.matmul_precision(), P.act_dtype())
    with P.policy():
        precision_flags()
        precision_geometry()
        precision_bf16_stacks()
        precision_gate(card)
        precision_gan_steps(card)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    check((P.matmul_precision(), P.act_dtype()) == before
          and flags == (before[0] != "highest",) * 2,
          f"the policy restored after the phase: {P.matmul_precision()} / "
          f"{P.act_dtype()}, TF32 flags (cuBLAS, cuDNN) {flags}")
    print(f"TIME precision phase: {time.perf_counter() - t_phase:.2f} s wall "
          f"({card})", flush=True)


def precision_flags():
    """Under each policy, set before a Renderer is built (resolve_device
    runs there): the flags read back as the name maps, and a 4096² f32
    matmul and a 3x3 conv of 256 channels at 128² differ from 'highest' and
    run faster under 'high' and 'default'."""
    import torch
    import torch.nn.functional as F
    from gan2shape_torch.rendering.renderer import Renderer
    from gan2shape_torch.utils import precision as P

    g = torch.Generator(device="cuda").manual_seed(0)
    n = MATMUL_N
    a = torch.randn(n, n, generator=g, device="cuda")
    b = torch.randn(n, n, generator=g, device="cuda")
    bt, c, s = CONV_SHAPE
    x = torch.randn(bt, c, s, s, generator=g, device="cuda")
    w = torch.randn(c, c, 3, 3, generator=g, device="cuda") / math.sqrt(9 * c)
    ops = {f"matmul {n}x{n}": lambda: a @ b,
           f"conv3x3 {c}ch {s}^2 B={bt}": lambda: F.conv2d(x, w, padding=1)}
    ref, ms = {}, {}
    for name in ("highest",) + FAST_POLICIES:
        P.set_matmul_precision(name)
        Renderer(FACE128, 128, 0.9, 1.1)  # resolve_device after the policy
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        tf32 = name != "highest"
        check(flags == (tf32, tf32),
              f"precision {name}: TF32 flags read back (cuBLAS, cuDNN) "
              f"{flags} after a Renderer was built, float32 matmul "
              f"precision {torch.get_float32_matmul_precision()!r}")
        for op, fn in ops.items():
            out = fn()
            ms[name, op] = cuda_ms(fn, reps=20)
            if name == "highest":
                ref[op] = out
                print(f"TIME precision highest {op}: {ms[name, op]:.4f} ms "
                      f"by CUDA events", flush=True)
                continue
            err = float((out - ref[op]).abs().max() / ref[op].abs().max())
            check(err > 0 and ms[name, op] < ms["highest", op],
                  f"precision {name} {op}: {err:.2e} of the largest from "
                  f"'highest', {ms[name, op]:.4f} ms against "
                  f"{ms['highest', op]:.4f} by CUDA events")


def precision_geometry():
    """At B=16, 128², 'grid' mode, on fixed inputs: warp_canon_depth, its
    gradient with respect to depth, the raster keys, the resize (both ways,
    and its gradient) and the view and light samples are bit-equal under
    'high' and 'default' to 'highest'.  The depth cotangent is nonzero on
    every 4th row and column only, so each vertex's gradient gathers at
    most one nonzero term in the splat's atomic adds and the gradient is
    the same in every run (with a dense cotangent the adds' order varies)."""
    import torch
    from gan2shape_torch.core.model import ViewLightSampler
    from gan2shape_torch.ops.rasterize import winner_keys
    from gan2shape_torch.ops.resize import resize
    from gan2shape_torch.rendering.renderer import (
        Renderer, get_transform_matrices,
    )
    from gan2shape_torch.utils import precision as P

    b, s = 16, 128
    renderer = Renderer(FACE128, s, 0.9, 1.1)
    depth = training_scene(renderer, b, seed=11)[0]
    views = torch.tensor((VIEWS * (b // len(VIEWS) + 1))[:b], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(12)
    cot = torch.zeros(b, s, s, device="cuda")
    cot[:, ::4, ::4] = torch.randn(b, s // 4, s // 4, generator=g,
                                   device="cuda")
    image = torch.rand(b, 3, s, s, generator=g, device="cuda") * 2 - 1
    cot_small = torch.randn(b, 3, 64, 64, generator=g, device="cuda")
    cot_big = torch.randn(b, 3, 256, 256, generator=g, device="cuda")
    lo = renderer.min_depth - renderer.margin
    hi = renderer.max_depth + renderer.margin

    def run():
        d = depth.clone().requires_grad_(True)
        rot, trans = get_transform_matrices(views)
        warped = renderer.warp_canon_depth(d, rot, trans, raster_mode="grid")
        grad, = torch.autograd.grad(warped, d, cot)
        vx, vy, vz = screen_vertices(renderer, depth, rot, trans)
        keys = winner_keys(vx, vy, vz, renderer.raster_window, lo, hi)
        im = image.clone().requires_grad_(True)
        small, big = resize(im, (64, 64)), resize(im, (256, 256))
        grad_im, = torch.autograd.grad(
            (small * cot_small).sum() + (big * cot_big).sum(), im)
        sampler = ViewLightSampler.default(device="cuda")
        gs = torch.Generator(device="cuda").manual_seed(13)
        return {"warp_canon_depth": warped.detach(), "its depth gradient":
                grad, "raster keys": keys, "resize to 64": small.detach(),
                "resize to 256": big.detach(), "the resize's gradient":
                grad_im, "view sample": sampler.sample(gs, b, "view"),
                "light sample": sampler.sample(gs, b, "light")}

    P.set_matmul_precision("highest")
    ref = run()
    again = run()
    check(all(torch.equal(again[k], v) for k, v in ref.items()),
          "precision highest: the geometry repeats bit for bit "
          f"({', '.join(ref)})")
    for name in FAST_POLICIES:
        P.set_matmul_precision(name)
        got = run()
        same = {k: torch.equal(got[k], v) for k, v in ref.items()}
        check(all(same.values()),
              f"precision {name}: bit-equal to 'highest' at B={b}, {s}^2, "
              f"grid mode: {same}")
    P.set_matmul_precision("highest")


def precision_bf16_stacks():
    """The face-128 frozen G, D and LPIPS-VGG (seeded random weights) under
    'bfloat16' against their f32 run: f32 and finite outputs, within JAX's
    bounds (BF16_*)."""
    import torch
    from gan2shape_torch.core.model import GAN2Shape
    from gan2shape_torch.utils import precision as P

    model = GAN2Shape(FACE128)
    model.init_frozen(torch.Generator().manual_seed(0))
    gen, disc, lpips = model.generator, model.discriminator, model.lpips
    z = torch.randn(4, 512, generator=torch.Generator().manual_seed(1))
    w = gen.style_forward(z.cuda()).detach()
    g = torch.Generator(device="cuda").manual_seed(2)
    in0 = torch.rand(4, 3, 128, 128, generator=g, device="cuda") * 2 - 1
    in1 = torch.rand(4, 3, 128, 128, generator=g, device="cuda") * 2 - 1

    def run():
        wv = w.clone().requires_grad_(True)
        img, feats = gen([wv], input_is_w=True, return_features=True)
        score, dfeats = disc(img)
        loss = sum(torch.mean(torch.abs(f)) for f in dfeats[:3])
        grad, = torch.autograd.grad(loss, wv)
        with torch.no_grad():
            dist = lpips(in0, in1)
        return {"image": img.detach(), "score": score.detach(),
                "loss": loss.detach(), "grad": grad, "lpips": dist,
                **{f"G tap {i}": f.detach() for i, f in enumerate(feats)},
                **{f"D tap {i}": f.detach() for i, f in enumerate(dfeats)}}

    P.set_act_dtype("float32")
    ref = run()
    P.set_act_dtype("bfloat16")
    got = run()
    P.set_act_dtype("float32")
    taps = {net: sum(k.startswith(net + " tap") for k in got)
            for net in ("G", "D")}
    check(all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
              for v in got.values()),
          f"precision bfloat16: the face-128 G image and {taps['G']} taps, "
          f"the D score and {taps['D']} taps, the tap loss, its gradient "
          f"and the LPIPS-VGG distance are f32 and finite")
    rel = {k: float((got[k] - v).abs().max() / v.abs().max())
           for k, v in ref.items() if "tap" in k or k == "score"}
    print(f"INFO precision bfloat16: of the largest f32 value: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()), flush=True)
    scale = max(1.0, float(ref["image"].abs().max()))
    img_err = float((got["image"] - ref["image"]).abs().max())
    loss_rel = float(abs(got["loss"] - ref["loss"]) / abs(ref["loss"]))
    cos = float(torch.nn.functional.cosine_similarity(
        got["grad"].flatten(), ref["grad"].flatten(), dim=0))
    lp_err = float(((got["lpips"] - ref["lpips"]).abs()
                    - BF16_LOSS * ref["lpips"].abs()).max())
    check(img_err / scale < BF16_IMAGE and loss_rel < BF16_LOSS
          and cos > BF16_COS and lp_err <= 1e-4,
          f"precision bfloat16 against float32 (JAX's bounds): image "
          f"max abs {img_err:.4f} at scale {scale:.3f} (< {BF16_IMAGE} of "
          f"it), tap loss {loss_rel:.2e} relative (< {BF16_LOSS}), "
          f"gradient cosine {cos:.6f} (> {BF16_COS}), LPIPS "
          f"{got['lpips'].flatten().tolist()} against "
          f"{ref['lpips'].flatten().tolist()} (rtol {BF16_LOSS}, atol 1e-4)")


def precision_gate(card):
    """The gate (gan2shape_torch.tools.check_precision) at its defaults;
    then, with each policy's trainer kept, a timed block of each step under
    every policy, and only after all of them a profiler window of each (a
    profiler window slows the host's later work, so timing a policy after
    another's window would favour the first).  The faster policies must
    stay finite; the verdicts against the bounds are findings, not the
    phase's pass condition (the default stays exact)."""
    import os
    from gan2shape_torch.tools import check_precision as gate
    from gan2shape_torch.utils import precision as P

    kept = {}

    def after(name, trainer, state):
        kept[name] = (trainer, state)

    res = gate.run_gate(128, PRECISION_ITERS, PRECISION_N_PROJ, "cuda",
                        after=after)
    times = {}
    for name, (trainer, (img, lat, prior, _, _)) in kept.items():
        with P.policy(*gate.POLICIES[name]):
            per_step, _, collected, coll2 = timed_steps(
                trainer, img, lat, prior, TIMED_ITERS)
        kept[name] = (trainer, (img, lat, prior, collected, coll2))
        times[name] = {k: v[0] for k, v in per_step.items()}
    busy = {}
    for name, (trainer, state) in kept.items():
        with P.policy(*gate.POLICIES[name]):
            busy[name] = profile_steps(trainer, *state, times[name],
                                       label=f"precision {name} ")
    kept.clear()
    os.makedirs(os.path.dirname(gate.DEFAULT_OUT), exist_ok=True)
    with open(gate.DEFAULT_OUT, "w") as f:
        json.dump({**res, "card": card}, f, indent=1)
    for step in gate.STEPS:
        for name in FAST_POLICIES:
            v = res["steps"][step][name]
            print(f"PRECISION {step} {name}: tail mean {v['tail_mean']:.6g} "
                  f"against highest {v['tail_mean_reference']:.6g}, "
                  f"relative deviation {v['tail_rel_dev']:.4f} (bound "
                  f"{v['bound']}), finite {v['finite']}, decreasing "
                  f"{v['decreasing']}, verdict "
                  f"{'pass' if v['pass'] else 'FAIL'}", flush=True)
    for name, run in res["policies"].items():
        step_ms = times[name]
        for step in gate.STEPS:
            b = busy[name].get(step)
            print(f"TIME precision {name} {step}: {step_ms[step]:.2f} ms/iter "
                  f"over {TIMED_ITERS} iterations, device busy "
                  + (f"{b:.2f}" if b is not None else "not measured")
                  + f" ms/iter; the gate's {len(run['losses'][step])} "
                  f"iterations {run['seconds'][step]:.2f} s ({card})",
                  flush=True)
    check(all(v[name]["finite"] for v in res["steps"].values()
              for name in FAST_POLICIES),
          f"precision gate at face-128, {PRECISION_ITERS} iterations a "
          f"step, {PRECISION_N_PROJ} pseudo samples: the faster policies' "
          f"losses finite (verdicts: "
          + ", ".join(f"{s} {n} {'pass' if v[n]['pass'] else 'fail'}"
                      for s, v in res["steps"].items()
                      for n in FAST_POLICIES) + f"); {gate.DEFAULT_OUT}")


def precision_gan_steps(card):
    """ms per train_step at the GAN side's width (256², channel multiplier
    2, batch 16, ADA at p 0.6) under each policy, by CUDA events over 3
    calls after one warm-up."""
    import torch
    from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer
    from gan2shape_torch.tools.check_precision import POLICIES
    from gan2shape_torch.utils import precision as P

    trainer = StyleGAN2Trainer(GAN_SIZE, channel_multiplier=GAN_CM,
                               use_augment=True, seed=0)
    g = torch.Generator(device="cuda").manual_seed(5)
    real = torch.rand(GAN_BATCH, 3, GAN_SIZE, GAN_SIZE, generator=g,
                      device="cuda") * 2 - 1
    for name, (matmul, act) in POLICIES.items():
        P.set_matmul_precision(matmul)
        P.set_act_dtype(act)
        metrics = trainer.train_step(real, 0.6)  # warm-up
        ms = cuda_ms(lambda: trainer.train_step(real, 0.6), reps=3, warmup=0)
        check(all(math.isfinite(float(metrics[k]))
                  for k in ("d_loss", "g_loss")),
              f"precision {name} GAN train_step losses finite: d_loss "
              f"{float(metrics['d_loss']):.4f}, g_loss "
              f"{float(metrics['g_loss']):.4f}")
        print(f"TIME precision {name} GAN train_step: {ms:.2f} ms per call "
              f"by CUDA events at {GAN_SIZE}^2, channel_multiplier {GAN_CM},"
              f" batch {GAN_BATCH}, ADA ({card})", flush=True)
    P.set_matmul_precision("highest")
    P.set_act_dtype("float32")


# ---------------- phase 12: processes ----------------

DIST_RANKS = 2          # on the one card: gloo (NCCL refuses two ranks)
DIST_DEVICE = "cuda"
DIST_TIMEOUT = 600      # seconds for the ranks' launch (the phase: < 180)
DIST_IMAGES = 32        # the face config's batch_size, split 16 + 16
DIST_PRIOR = 5          # (c)'s batched prior iterations, which fit runs first
DIST_STAGE = {"step1": 5, "step2": 1, "step3": 1}
DIST_GAN_BATCH = 16     # phase 10's, split 8 + 8
DIST_GAN_IMAGES = 16
DIST_TIMED = 3
# A rank's run against one process's, on the card: fixed limits between
# the largest gap of sound runs and the smallest gap of a planted fault
# (`--distributed-planted`; PERF.md §6: sound gaps up to 4.6e-6 at
# iteration 0, 6.2e-3 in (b)'s curves and 4.4e-3 in its nets, 2.4e-4 in
# (c)'s losses and 1.0e-3 in its nets, 1.2e-3 in a GAN gradient; unsliced
# draws moved iteration 0 by 1.3e-2 and the curves by 2.1e-2, a per-rank
# stddev the GAN gradients by 1.2e-2 or more).  The spread of two
# one-process runs made in the same run is held to them too.
CARD_ITER0_TOL = 1e-5   # iteration-0 losses, relative (phase 9's bound)
INST_LIMITS = {"curves": 1e-2, "nets": 1e-2}
GEN_LIMITS = {"losses": 3e-3, "nets": 3e-3}  # ROADMAP C's generalizing
GAN_GRAD_TOL = 3e-3     # the gradients a GAN step applied, of the largest
# b1 = 0 Adam moves a parameter by up to lr (2e-3 * 16/17 for D) on its
# first step whatever the gradient: a sanity bound only
GAN_PARAM_TOL = 2 * 2e-3 * 16 / 17
GAN_GRADS = ("train d", "train g", "r1 d", "path g")


def per_image():
    """How many images of (c)'s batch run their steps 2 and 3."""
    import os

    return int(os.environ.get("G2S_SMOKE_PER_IMAGE", "1"))


def dist_face_config(**kw):
    return dict(FACE128, n_epochs_generalized=1, **kw)


def state_hash(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def collective_ms(prof):
    """Host milliseconds spent in the collectives of a profiler window
    (the backends' own spans, gloo:* or nccl:*, waits included)."""
    return sum(e.cpu_time_total for e in prof.key_averages()
               if e.key.startswith(("gloo:", "nccl:"))) / 1e3


def net_gap(a, b):
    return max(float((v - b[k]).abs().max()) for k, v in a.items())


def curve_gap(a, b):
    """The largest |a - b| / (1 + |b|) over loss lists: <= tol when they
    are np.allclose with rtol = atol = tol."""
    return max((abs(x - y) / (1 + abs(y)) for p, q in zip(a, b)
                for x, y in zip(p, q)), default=0.0)


def dist_instances(job, out, mesh=None, key="instances", timed=True):
    """(b) on one rank or one process: the N_INSTANCES face-128 instances
    (this rank's share, or `mesh`'s: a Mesh without a group trains one
    rank's share in one process): iteration-0 losses from the init (step
    2's samples drawn from a seeded generator on the card), phase 9's fit
    with the launches counted, a timed block of each step (`timed`), peak
    memory."""
    import torch
    from gan2shape_torch.parallel import InstanceParallelTrainer

    torch.cuda.reset_peak_memory_stats()
    trainer = InstanceParallelTrainer(FACE128, N_INSTANCES, seed=0,
                                      mesh=mesh)
    img, lat, prior = (trainer._batch(job[k])
                       for k in ("images", "latents", "priors"))
    m = trainer.model
    with torch.no_grad():
        l_prior, _ = m.depth_net_forward(img, prior)
        inv = m.step1_invariants(img)
        l1, albedo = m.step1_iter(img, inv)
        collected = (inv["normal"], inv["light_a"], inv["light_b"], albedo,
                     inv["depth"])
        pool = m.step2_sample(torch.Generator("cuda").manual_seed(1),
                              collected, FACE128["n_proj_samples"])
        l2, coll2 = m.step2_loss(lat, *pool, m.step2_invariants(lat))
        l3, _ = m.forward_step3(img, lat, coll2)
    history, launches, fit_s = counted_fit(trainer, job["images"],
                                           job["latents"], job["priors"])
    ms = (timed_instance_steps(trainer, img, lat, prior, DIST_TIMED)[0]
          if timed else None)
    out[key] = {
        "first": trainer.first, "n": trainer.n,
        "iteration0": torch.stack([l_prior, l1, l2, l3]).cpu(),
        "history": history, "launches": launches, "fit_s": fit_s,
        "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "nets": [{k: v.cpu() for k, v in
                  trainer.model.nets.instance(j).state_dict().items()}
                 for j in range(trainer.n)]}


def dist_generalizing(job, out, data_parallel, logdir=None,
                      key="generalizing"):
    """(c) on the ranks (`data_parallel`) or one process: GeneralizingTrainer
    over one batch of DIST_IMAGES face-128 images in fit's order, cut in
    depth (the nets broadcast from rank 0 under a group, DIST_PRIOR
    iterations of the batched prior, a step-1 block, then step 2 and step
    3 of the first G2S_SMOKE_PER_IMAGE images, default 1, where fit runs
    all 32), the losses and nets after each; then a timed step-1 block (a
    profiler window of it on rank 0 when `logdir`)."""
    import torch
    from gan2shape_torch import distributed
    from gan2shape_torch.core import diagnostics
    from gan2shape_torch.core.trainer import GeneralizingTrainer

    def nets():
        return {k: v.detach().cpu().clone()
                for k, v in trainer.model.nets.state_dict().items()}

    torch.cuda.reset_peak_memory_stats()
    trainer = GeneralizingTrainer(dist_face_config(
        data_parallel=data_parallel), seed=0)
    images, latents, priors = (
        torch.as_tensor(job[k], device=trainer.device)
        for k in ("gen_images", "gen_latents", "gen_priors"))
    if trainer.grouped:
        distributed.broadcast_(trainer.model.nets.parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, after = {}, {}
    losses["prior"] = trainer.run_prior(images, priors, DIST_PRIOR)
    after["prior"] = nets()
    collected, losses["step1"] = trainer.run_step1(images,
                                                   DIST_STAGE["step1"])
    after["step1"] = nets()
    losses["step2"], losses["step3"] = [], []
    for i in range(per_image()):
        img, lat = images[i:i + 1], latents[i:i + 1]
        coll2, l2 = trainer.run_step2(img, lat,
                                      tuple(x[i:i + 1] for x in collected),
                                      DIST_STAGE["step2"])
        losses["step2"] += l2
        losses["step3"] += trainer.run_step3(img, lat, coll2,
                                             DIST_STAGE["step3"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    after["steps 2, 3"] = nets()
    lead = logdir is not None and distributed.rank() == 0
    with diagnostics.profile_trace(logdir, enabled=lead) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.run_step1(images, DIST_TIMED)
        torch.cuda.synchronize()
        block_ms = (time.perf_counter() - t) * 1e3
    out[key] = {
        "losses": {k: [float(x) for x in v] for k, v in losses.items()},
        "nets": after, "hash": state_hash(after["steps 2, 3"].values()),
        "run_s": run_s, "ms": block_ms / DIST_TIMED,
        "collective_share": (collective_ms(prof) / block_ms if lead
                             else None),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def grad_gaps(got, want):
    """Each step's largest gap of the gradients applied, over one
    process's largest gradient."""
    return {k: max(float((a - b).abs().max()) for a, b in zip(got[k], w))
            / max(float(b.abs().max()) for b in w)
            for k, w in ((k, want[k]) for k in GAN_GRADS)}


def dist_gan(job, out, logdir=None, want_grads=None):
    """(d) on the ranks (under a group) or one process: iteration 0 of each
    StyleGAN2 step from the seeded init at phase 10's width with the
    trainer's own draws (the whole batch's, sliced on a rank) and the
    gradients each applied (against `want_grads`, one process's, on a
    rank); then tools.train_gan for 2 iterations with checkpoints; then
    timed train_steps (a profiler window of one on rank 0 when
    `logdir`)."""
    import os

    import torch
    from gan2shape_torch import distributed
    from gan2shape_torch.core import diagnostics
    from gan2shape_torch.core.dataset import MultiResolutionDataset
    from gan2shape_torch.tools import train_gan

    torch.cuda.reset_peak_memory_stats()
    ds = MultiResolutionDataset(job["gan_data"], resolution=GAN_SIZE)
    rows = distributed.local_slice(DIST_GAN_BATCH)
    idx = list(range(DIST_GAN_BATCH))
    real = ds.get_batch(idx[rows], [i % 2 == 1 for i in idx][rows]).cuda()
    rec, again = {}, {}
    vals = iteration0_values(DIST_DEVICE, real, mesh=distributed.make_mesh(),
                             record=rec)
    if want_grads is None:
        # one process: its gradients, and a second run's gap from them
        iteration0_values(DIST_DEVICE, real, record=again)
        grads = {"grads": {k: rec[k] for k in GAN_GRADS},
                 "grad_gap": grad_gaps(again, rec)}
    else:
        grads = {"grad_gap": grad_gaps(rec, want_grads)}

    run_dir = job["gan_out"] + (f"_rank{distributed.rank()}"
                                if distributed.is_initialized() else "")
    args = train_gan.parse_args(
        [job["gan_data"], "--size", str(GAN_SIZE), "--channel_multiplier",
         str(GAN_CM), "--batch", str(DIST_GAN_BATCH), "--augment",
         "--iter", "2", "--ckpt_every", "1", "--n_sample", "4",
         "--out_dir", run_dir]
        + (["--distributed"] if distributed.is_initialized() else []))
    t0 = time.perf_counter()
    trainer, log = train_gan.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    trainer.train_step(real, 0.6)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(DIST_TIMED):
        trainer.train_step(real, 0.6)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / DIST_TIMED
    lead = logdir is not None and distributed.rank() == 0
    with diagnostics.profile_trace(logdir, enabled=lead) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_step(real, 0.6)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t) * 1e3
    ckpt_dir = os.path.join(run_dir, "checkpoint")
    out["gan"] = {
        "iteration0": vals, "after_train_step": rec["after_train_step"],
        **grads, "log": log, "run_dir": run_dir, "run_s": run_s,
        "ms": step_ms,
        "checkpoints": sorted(os.listdir(ckpt_dir))
        if os.path.isdir(ckpt_dir) else [],
        "collective_share": (collective_ms(prof) / window_ms if lead
                             else None),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# faults a rank can carry (`--distributed-planted`, G2S_SMOKE_PLANT names
# them) and the check each falls under
FAULTS = {
    "draws": "(b)",       # step 2's samples of the rank's instances alone
    "unaveraged": "(c)",  # Adam on the rank's own gradients
    "mask_sum": "(c)",    # step 1's masked L1 over the rank's mask sum
    "ungathered": "(c)",  # step 1's collected state left on its rank
    "stddev": "(d)",      # the D's minibatch stddev over the rank's rows
}
PLANTED = "draws,unaveraged,stddev"  # the default set, each one caught


def planted_faults():
    import os

    names = os.environ.get("G2S_SMOKE_PLANT", PLANTED).split(",")
    if not set(names) <= set(FAULTS):
        raise ValueError(f"G2S_SMOKE_PLANT={names}: faults are {list(FAULTS)}")
    return names


def plant_faults(names):
    """Plant the named FAULTS in this rank (after the ranks of
    `--distributed-planted` start)."""
    from gan2shape_torch import distributed
    from gan2shape_torch.core import losses
    from gan2shape_torch.core.trainer import GeneralizingTrainer, Trainer
    from gan2shape_torch.models.stylegan2 import Discriminator
    from gan2shape_torch.parallel import InstanceParallelTrainer

    init_model = InstanceParallelTrainer._init_model
    masked_mean = losses.masked_mean
    forward = Discriminator.forward

    def own_draws(self, device, init):
        init_model(self, device, init)
        self.model.instance_range = None

    if "draws" in names:
        InstanceParallelTrainer._init_model = own_draws
    if "unaveraged" in names:
        GeneralizingTrainer._step = Trainer._step
    if "mask_sum" in names:
        losses.masked_mean = (lambda x, mask, n=1, split=False:
                              masked_mean(x, mask, n))
    if "ungathered" in names:
        distributed.gather_rows_of = list
    if "stddev" in names:
        Discriminator.forward = (
            lambda self, x, ftr_num=100, split_batch=False:
            forward(self, x, ftr_num))


def dist_rank_main(workdir):
    """One rank of phase 12's launch (torchrun sets its variables):
    (b), (c) and (d) on its share, its results in workdir/rank{r}.pt."""
    import os

    import torch
    from gan2shape_torch import distributed
    from gan2shape_torch.utils import precision as P

    P.set_matmul_precision("highest")
    P.set_act_dtype("float32")
    if os.environ.get("G2S_SMOKE_PLANTED") == "1":
        plant_faults(planted_faults())
    distributed.initialize_from_env(required=True)
    r = distributed.rank()
    print(f"RANK {r} of {distributed.world_size()}: "
          f"{torch.distributed.get_backend()} on "
          f"{distributed.group_device()}", flush=True)
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    want_grads = torch.load(os.path.join(workdir, "gan_grads.pt"))
    out = {}
    try:
        dist_instances(job, out)
        dist_generalizing(job, out, True, logdir=os.path.join(workdir, "gen"))
        print(f"HASH rank {r} generalizing nets {out['generalizing']['hash']}",
              flush=True)
        dist_gan(job, out, logdir=os.path.join(workdir, "gan"),
                 want_grads=want_grads)
        torch.save(out, os.path.join(workdir, f"rank{r}.pt"))
    finally:
        distributed.shutdown()
    return 0


def dist_job(tmp):
    """Phase 12's inputs, written for the ranks: phase 9's instances, 32
    face images with latents and priors, and a prepared GAN cache of 256²
    images."""
    import os

    import numpy as np
    import torch
    from gan2shape_torch.core.priors import PriorGenerator
    from gan2shape_torch.tools import prepare_data

    rng = np.random.default_rng(10)
    size = FACE128["image_size"]
    n = N_INSTANCES
    pg = PriorGenerator(size, "face", FACE128["prior_name"], device=DIST_DEVICE)

    def priors(images):
        return np.stack([pg(im)[0] for im in images])

    job = {"images": rng.uniform(-1, 1, (n, 3, size, size)).astype(
               np.float32),
           "latents": rng.standard_normal((n, 512)).astype(np.float32),
           "gen_images": rng.uniform(-1, 1, (DIST_IMAGES, 3, size, size)
                                     ).astype(np.float32),
           "gen_latents": rng.standard_normal((DIST_IMAGES, 512)).astype(
               np.float32),
           "gan_data": os.path.join(tmp, "gan_data"),
           "gan_out": os.path.join(tmp, "gan_run")}
    job["priors"] = priors(job["images"])
    job["gen_priors"] = priors(job["gen_images"])
    write_pngs(os.path.join(tmp, "gan_images"), DIST_GAN_IMAGES, GAN_SIZE,
               seed=13)
    prepare_data.main(["--out", job["gan_data"], "--size", str(GAN_SIZE),
                       "--n_worker", "2", os.path.join(tmp, "gan_images")])
    torch.save(job, os.path.join(tmp, "job.pt"))
    return job


def dist_world_of_one(card, job):
    """(a): a world of one rank over NCCL, joined through torchrun's
    variables by initialize_from_env: an all-reduce of a known tensor, and
    a data_parallel GeneralizingTrainer's step-1 block at B=32 against a
    plain trainer's, with the spread of two plain runs beside."""
    import os
    import socket

    import torch
    import torch.distributed as dist
    from gan2shape_torch import distributed
    from gan2shape_torch.core.trainer import GeneralizingTrainer

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in (*env, "G2S_DIST_BACKEND")}
    os.environ.pop("G2S_DIST_BACKEND", None)
    os.environ.update(env)
    try:
        check(distributed.initialize_from_env()
              and dist.get_backend() == "nccl",
              f"(a) torchrun's variables, world size 1: a group over "
              f"{dist.get_backend()} on {distributed.group_device()}")
        x = torch.arange(8, dtype=torch.float32, device=DIST_DEVICE)
        y = x.clone()
        dist.all_reduce(y)
        check(torch.equal(x, y), "(a) NCCL all-reduce of arange(8) over "
              "one rank: itself")
        images = torch.as_tensor(job["gen_images"], device=DIST_DEVICE)
        runs = {}
        for name, dp in (("plain", False), ("plain again", False),
                         ("data_parallel", True)):
            t = GeneralizingTrainer(dist_face_config(data_parallel=dp),
                                    seed=0)
            if dp:
                distributed.broadcast_(t.model.nets.parameters())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, losses = t.run_step1(images, DIST_STAGE["step1"])
            torch.cuda.synchronize()
            runs[name] = ([[float(v) for v in losses]],
                          {k: v.detach().clone() for k, v in
                           t.model.nets["albedo"].state_dict().items()},
                          (time.perf_counter() - t0) * 1e3
                          / DIST_STAGE["step1"], t.grouped)
            del t
        # the first run warms cuDNN and the caches: times from the others
        (pl, pp, _, _), (al, ap, pms, _), (dl, dp_, dms, grouped) = (
            runs["plain"], runs["plain again"], runs["data_parallel"])
        spread = (curve_gap(al, pl), net_gap(ap, pp))
        gap = (curve_gap(dl, pl), net_gap(dp_, pp))
        lim = (GEN_LIMITS["losses"], GEN_LIMITS["nets"])
        check(grouped and dl[0][0] == pl[0][0]
              and all(g <= t and s <= t for g, s, t in zip(gap, spread, lim)),
              f"(a) data_parallel step-1 block at B={DIST_IMAGES}, "
              f"{DIST_STAGE['step1']} iterations, over the NCCL group: "
              f"iteration-0 loss equal to the plain trainer's "
              f"({dl[0][0]:.7f}); losses {gap[0]:.2e} and albedo nets "
              f"{gap[1]:.2e} from it (<= {lim[0]}, {lim[1]}); two plain "
              f"runs {spread[0]:.2e}, {spread[1]:.2e} apart")
        print(f"TIME distributed (a) step 1 at B={DIST_IMAGES}: {dms:.2f} ms "
              f"per iteration data_parallel over one NCCL rank, {pms:.2f} "
              f"plain ({card})", flush=True)
    finally:
        distributed.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def launch_ranks(tmp, planted=False):
    """torchrun with DIST_RANKS ranks of this script on the one card over
    gloo (the faults of `planted_faults` planted in them when `planted`);
    killed with every process it started after DIST_TIMEOUT.  Returns
    {rank: results}."""
    import os
    import signal
    import socket

    import torch

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, G2S_DIST_BACKEND="gloo",
               G2S_SMOKE_PLANTED="1" if planted else "0")
    for k in ("G2S_COORDINATOR", "G2S_NUM_PROCESSES", "G2S_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(DIST_RANKS), "--master_addr", "localhost",
           "--master_port", str(port), os.path.abspath(__file__),
           "--distributed-rank", tmp]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    try:
        output, _ = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        output, _ = proc.communicate()
        print(output[-6000:], flush=True)
        check(False, f"the {DIST_RANKS} ranks finished within "
              f"{DIST_TIMEOUT} s")
    for line in output.splitlines():
        if line.startswith(("RANK ", "HASH ", "PASS", "FAIL")):
            print("  " + line, flush=True)
    if proc.returncode != 0:
        print(output[-6000:], flush=True)
    check(proc.returncode == 0, f"torchrun of {DIST_RANKS} ranks exited "
          f"{proc.returncode}")
    return {r: torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False)
            for r in range(DIST_RANKS)}


def instance_gaps(got, want, lo):
    """Largest gaps of a rank's instances against a run holding instance lo
    onwards: (iteration 0 per loss (prior, steps 1-3), relative; curves,
    as `curve_gap`; nets, absolute)."""
    n = got["n"]
    at = lo - want["first"]
    w0 = want["iteration0"][:, at:at + n]
    gap0 = ((got["iteration0"] - w0).abs() / w0.abs()).amax(1).tolist()
    keys = ("losses_step1", "losses_step2", "losses_step3")
    curve = curve_gap([rec[k] for rec in got["history"] for k in keys],
                      [rec[k] for rec in want["history"][at:at + n]
                       for k in keys])
    net = max(net_gap(got["nets"][j], want["nets"][at + j])
              for j in range(n))
    return gap0, curve, net


def fmt(xs):
    return "/".join(f"{x:.1e}" for x in xs)


def compare_instances(ranks, one, shares, again, card):
    """(b): each rank's instances against one process training the same
    share (the same shapes, so the same cuDNN algorithms) and, at
    iteration 0, against one process of all N (whose grouped convolutions
    of N groups sum in another order), within the fixed limits; the gap
    of two one-process runs of rank 0's share within them too."""
    spread = instance_gaps(again, shares[0], 0)
    lines = [(r, instance_gaps(v["instances"], shares[r],
                               v["instances"]["first"]),
              instance_gaps(v["instances"], one, v["instances"]["first"]))
             for r, v in ranks.items()]
    print(f"INFO (b) gaps against one process of all {N_INSTANCES}: "
          + "; ".join(f"rank {r} iteration 0 {fmt(w[0])}, curves "
                      f"{w[1]:.2e}, nets {w[2]:.2e}" for r, _, w in lines),
          flush=True)

    def within(g):
        return (max(g[0]) <= CARD_ITER0_TOL and g[1] <= INST_LIMITS["curves"]
                and g[2] <= INST_LIMITS["nets"])

    same = {r: {k: (v["instances"]["launches"][k], one["launches"][k])
                for k in MAIN_PATH} for r, v in ranks.items()}
    for r, v in ranks.items():
        g = v["instances"]
        print(f"TIME distributed (b) rank {r}: fit {g['fit_s']:.2f} s; ms "
              f"per iteration " + ", ".join(f"{k} {ms:.2f}" for k, ms in
                                           g["ms"].items())
              + f" for its {g['n']} instances; peak {g['peak_gib']:.2f} GiB "
              f"(two ranks share one card; {card})", flush=True)
    print(f"TIME distributed (b) one process N={N_INSTANCES}: fit "
          f"{one['fit_s']:.2f} s; ms per iteration "
          + ", ".join(f"{k} {ms:.2f}" for k, ms in one["ms"].items())
          + f"; peak {one['peak_gib']:.2f} GiB ({card})", flush=True)
    check(within(spread) and all(within(o) and max(w[0]) <= CARD_ITER0_TOL
                                 for _, o, w in lines)
          and [v["instances"]["first"] for v in ranks.values()]
          == [r * N_INSTANCES // DIST_RANKS for r in range(DIST_RANKS)]
          and all(a == b > 0 for s in same.values() for a, b in s.values()),
          f"(b) InstanceParallelTrainer N={N_INSTANCES} split over "
          f"{DIST_RANKS} ranks, against one process of the same share: "
          + "; ".join(f"rank {r} iteration 0 (prior/1/2/3) {fmt(o[0])}, "
                      f"curves {o[1]:.2e}, nets {o[2]:.2e}"
                      for r, o, _ in lines)
          + f"; two one-process runs {fmt(spread[0])}, {spread[1]:.2e}, "
          f"{spread[2]:.2e} (all <= {CARD_ITER0_TOL}, "
          f"{INST_LIMITS['curves']}, {INST_LIMITS['nets']}); against one "
          f"process of all {N_INSTANCES}, iteration 0 <= {CARD_ITER0_TOL}; "
          f"launches per rank equal to one process's {same}")


def generalizing_gaps(got, want):
    """{stage: gap} of the losses (`curve_gap`) and of the nets after each
    stage (absolute)."""
    return ({k: curve_gap([v], [want["losses"][k]])
             for k, v in got["losses"].items()},
            {k: net_gap(v, want["nets"][k]) for k, v in got["nets"].items()})


def compare_generalizing(ranks, one, again, card):
    """(c): the ranks' nets bit-equal to each other; the prior's
    iteration-0 loss (from the broadcast init) within CARD_ITER0_TOL of one
    process's; every stage's losses and nets within the fixed limits of
    one process's, and two one-process runs within them too."""
    hashes = {r: v["generalizing"]["hash"] for r, v in ranks.items()}
    by_rank = [generalizing_gaps(v["generalizing"], one)
               for v in ranks.values()]
    gaps = tuple({k: max(g[i][k] for g in by_rank) for k in by_rank[0][i]}
                 for i in (0, 1))
    spread = generalizing_gaps(again, one)
    prior0 = max(abs(v["generalizing"]["losses"]["prior"][0]
                     - one["losses"]["prior"][0])
                 / abs(one["losses"]["prior"][0]) for v in ranks.values())

    def show(g):
        return ", ".join(f"{k} {v:.2e}" for k, v in g.items())

    print(f"INFO (c) by stage, the ranks against one process: losses "
          f"{show(gaps[0])}; nets {show(gaps[1])}. Two one-process runs: "
          f"losses {show(spread[0])}; nets {show(spread[1])}", flush=True)
    for r, v in ranks.items():
        g = v["generalizing"]
        share = ("" if g["collective_share"] is None else
                 f"; collectives {100 * g['collective_share']:.1f}% of the "
                 "block (profiler window, gloo spans)")
        print(f"TIME distributed (c) rank {r}: step 1 {g['ms']:.2f} ms per "
              f"iteration on its {DIST_IMAGES // DIST_RANKS} images{share}; "
              f"peak {g['peak_gib']:.2f} GiB (two ranks share one card, gloo "
              f"stages CUDA tensors through the host; {card})", flush=True)
    print(f"TIME distributed (c) one process: step 1 {one['ms']:.2f} ms per "
          f"iteration at B={DIST_IMAGES}; peak {one['peak_gib']:.2f} GiB "
          f"({card})", flush=True)
    worst = [max(g.values()) for g in gaps]
    worst_spread = [max(g.values()) for g in spread]
    lim = (GEN_LIMITS["losses"], GEN_LIMITS["nets"])
    check(len(set(hashes.values())) == 1 and prior0 <= CARD_ITER0_TOL
          and all(g <= t and s <= t
                  for g, s, t in zip(worst, worst_spread, lim))
          and all([len(v["generalizing"]["losses"][k]) for k in
                   ("prior", *DIST_STAGE)] == [
                       DIST_PRIOR, DIST_STAGE["step1"],
                       DIST_STAGE["step2"] * per_image(),
                       DIST_STAGE["step3"] * per_image()]
                  for v in ranks.values()),
          f"(c) data_parallel GeneralizingTrainer, B={DIST_IMAGES} split "
          f"over {DIST_RANKS} ranks, fit's order cut to {DIST_PRIOR} prior "
          f"iterations, a {DIST_STAGE['step1']}-iteration step-1 block and "
          f"{per_image()} image(s)' step 2 / step 3: the ranks' nets "
          f"bit-equal ({len(set(hashes.values()))} distinct sha256 of "
          f"{len(hashes)}: {sorted(set(h[:16] for h in hashes.values()))}"
          f"); against one "
          f"process, the prior's iteration 0 {prior0:.1e} (<= "
          f"{CARD_ITER0_TOL}), losses {worst[0]:.2e} and nets "
          f"{worst[1]:.2e} at worst; two one-process runs {worst_spread[0]:.2e}"
          f" and {worst_spread[1]:.2e} (all <= {lim[0]}, {lim[1]})")


def compare_gan(ranks, one, card):
    """(d): iteration-0 values and the gradients each step applied against
    one process's; rank 0's checkpoints reload; iteration 0 of the
    runs."""
    import os

    import torch
    from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer

    got = ranks[0]["gan"]
    tol = {"d_loss": GAN_TOL, "g_loss": GAN_TOL, "r1": GAN_TOL,
           "path": PATH_TOL}
    rel = {r: {k: abs(v["gan"]["iteration0"][k] - one["iteration0"][k])
               / abs(one["iteration0"][k]) for k in tol}
           for r, v in ranks.items()}
    grad = {k: max(v["gan"]["grad_gap"][k] for v in ranks.values())
            for k in GAN_GRADS}
    spread = one["grad_gap"]
    gap = max(float((v - one["after_train_step"][net][k]).abs().max())
              for r in ranks for net in ("generator", "discriminator")
              for k, v in ranks[r]["gan"]["after_train_step"][net].items())
    for r, v in ranks.items():
        g = v["gan"]
        share = ("" if g["collective_share"] is None else
                 f"; collectives {100 * g['collective_share']:.1f}% of a "
                 "train_step (profiler window, gloo spans)")
        print(f"TIME distributed (d) rank {r}: train_gan 2 iterations "
              f"{g['run_s']:.2f} s; train_step {g['ms']:.2f} ms on its "
              f"{DIST_GAN_BATCH // DIST_RANKS} images{share}; peak "
              f"{g['peak_gib']:.2f} GiB (two ranks share one card, gloo "
              f"stages CUDA tensors through the host; {card})", flush=True)
    print(f"TIME distributed (d) one process: train_gan 2 iterations "
          f"{one['run_s']:.2f} s; train_step {one['ms']:.2f} ms at batch "
          f"{DIST_GAN_BATCH}; peak {one['peak_gib']:.2f} GiB ({card})",
          flush=True)
    check(all(rel[r][k] <= tol[k] for r in rel for k in tol)
          and all(g <= GAN_GRAD_TOL for g in (*grad.values(),
                                              *spread.values()))
          and gap <= GAN_PARAM_TOL,
          f"(d) StyleGAN2 at {GAN_SIZE}^2, channel multiplier {GAN_CM}, "
          f"batch {DIST_GAN_BATCH} split over {DIST_RANKS} ranks, with ADA "
          f"at p 0.6, iteration 0 from the init against one process: "
          + ", ".join(f"{k} {max(rel[r][k] for r in rel):.1e} (<= {tol[k]})"
                      for k in tol)
          + " relative; the gradients applied (Adam's first moments) "
          + ", ".join(f"{k} {v:.1e}" for k, v in grad.items())
          + " of one process's largest, two one-process runs "
          + ", ".join(f"{v:.1e}" for v in spread.values())
          + f" (<= {GAN_GRAD_TOL}); parameters "
          f"after train_step {gap:.2e} apart (<= 2 lr = {GAN_PARAM_TOL:.2e})")
    ckpts = [r["gan"]["checkpoints"] for r in ranks.values()]
    reloaded = StyleGAN2Trainer(GAN_SIZE, channel_multiplier=GAN_CM,
                                use_augment=True, seed=1)
    path = os.path.join(got["run_dir"], "checkpoint", "000001.pt")
    it, _ = reloaded.load_checkpoint(path)
    saved = torch.load(path, map_location="cpu", weights_only=False)
    equal = all(torch.equal(v.cpu(), saved[k][n])
                for k, mod in (("g", reloaded.generator),
                               ("d", reloaded.discriminator),
                               ("g_ema", reloaded.g_ema))
                for n, v in mod.state_dict().items())
    first = {k: (got["log"][0][k], one["log"][0][k]) for k in ("d", "g")}
    check(ckpts[0] == ["000000.pt", "000001.pt"] and not any(ckpts[1:])
          and it == 1 and equal
          and all(abs(a - b) <= GAN_TOL * abs(b) for a, b in first.values()),
          f"(d) tools.train_gan --distributed, 2 iterations: rank 0 wrote "
          f"{ckpts[0]}, the other ranks nothing; its last checkpoint "
          f"reloads (iteration {it}, state bit-equal); iteration 0's d and "
          f"g {first} against one process")


def run_distributed(card, planted=False):
    """Phase 12: (a) in this process over NCCL; the one-process runs of
    (b)-(d); then DIST_RANKS ranks on the card through torchrun over gloo,
    each held against them.  Returns each rank's launch counts in (b).
    With `planted`, the ranks carry `planted_faults()` and (a) is skipped:
    the checks of the planted faults must fail, and only those."""
    import gc
    import os
    import tempfile
    from pathlib import Path

    import torch
    from gan2shape_torch.distributed import Mesh

    root = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    os.makedirs(root / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        job = dist_job(tmp)
        if not planted:
            dist_world_of_one(card, job)
        one = {}
        dist_instances(job, one)
        shares = {}
        for r in [*range(DIST_RANKS), "again"]:
            dist_instances(job, shares, Mesh(DIST_RANKS, 0 if r == "again"
                                             else r), key=r, timed=False)
        dist_generalizing(job, one, False)
        dist_generalizing(job, one, False, key="generalizing again")
        dist_gan(job, one)
        torch.save(one["gan"].pop("grads"), os.path.join(tmp, "gan_grads.pt"))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch_ranks(tmp, planted)
        ranks_s = time.perf_counter() - t0
        failed = {}
        for name, compare, args in (
                ("(b)", compare_instances, (one["instances"], shares,
                                            shares.pop("again"))),
                ("(c)", compare_generalizing, (one["generalizing"],
                                               one["generalizing again"])),
                ("(d)", compare_gan, (one["gan"],))):
            try:
                compare(ranks, *args, card)
            except Failed as exc:  # report every check after a failed one
                failed[name] = str(exc)
    print(f"TIME distributed phase: {time.perf_counter() - t_phase:.2f} s "
          f"wall, the {DIST_RANKS} ranks' launch {ranks_s:.2f} s of it "
          f"({card})", flush=True)
    if planted:
        names = planted_faults()
        want = sorted({FAULTS[f] for f in names})
        check(sorted(failed) == want,
              f"planted faults {names}: the checks that failed {sorted(failed)}"
              f", those of the faults {want}")
    elif failed:
        raise Failed("; ".join(failed.values()))
    return {r: v["instances"]["launches"] for r, v in ranks.items()}


# ---------------- phase 13: the tools ----------------

# files of the JAX tools that the port's tools must never write
TRACKED_JSONS = ("FULL_RUN.json", "POOL_EVERY_CHECK.json", "RUN_REAL.json")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
TOOLS_BENCH_BLOCKS = 2     # timed blocks after the warm-up (the CLI's: 4)
TOOLS_INSTANCE_ITERS = 5   # --instances N_INSTANCES (the CLI's: 15)
TOOLS_PRIOR = 20           # full_instance_run cut to prior 20 + {5, 5, 5}
TOOLS_STAGES = [{"step1": 5, "step2": 5, "step3": 5}]
TOOLS_POOL_KS = ["1", "2"]
FULL_RUN_KEYS = {"schedule", "total_optimization_steps", "first_instance_s",
                 "steady_state_instance_s", "steady_state_steps_per_sec",
                 "north_star_s", "meets_north_star", "final_losses",
                 "device"}


def tracked_hashes(root):
    import hashlib

    out = {}
    for name in TRACKED_JSONS:
        path = root / name
        out[name] = (hashlib.sha256(path.read_bytes()).hexdigest()
                     if path.exists() else None)
    return out


def quietly(fn, *args, **kw):
    """(fn's result, the lines it printed on stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kw)
    return result, buf.getvalue().splitlines()


def run_tools(card):
    """Phase 13: the port's measurement and study tools, each through its
    entry point, with the JAX tools' tracked JSONs hashed before and
    after.  Returns the launch counts of the bench's blocks."""
    import os
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    before = tracked_hashes(root)
    t_phase = time.perf_counter()
    os.makedirs(root / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        launches = tools_bench(card)
        tools_full_run(tmp, card)
        tools_pool_every(tmp)
        tools_raster(card)
        tools_real_assets(tmp)
    after = tracked_hashes(root)
    check(after == before, f"the JAX tools' {', '.join(TRACKED_JSONS)} "
          f"unchanged by the port's tools (SHA-256 {after})")
    print(f"TIME tools phase: {time.perf_counter() - t_phase:.2f} s wall "
          f"({card})", flush=True)
    return launches


def bench_line(lines, metric):
    """The bench's one stdout line, parsed and checked."""
    result = json.loads(lines[0]) if len(lines) == 1 else {}
    check(set(result) == BENCH_KEYS and result["metric"] == metric
          and math.isfinite(result["value"]) and result["value"] > 0,
          f"bench printed one JSON line on stdout: {lines}")
    print(f"BENCH {lines[0]}", flush=True)
    return result


def tools_bench(card):
    import torch
    from gan2shape_torch.ops import _cuda
    from gan2shape_torch.tools import bench

    _cuda.reset_launches()
    t0 = time.perf_counter()
    _, lines = quietly(bench.main, n_blocks=TOOLS_BENCH_BLOCKS)
    bench_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    bench_line(lines, bench.STEPS_METRIC)
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    check(not missing, f"tools.bench: a warm-up and {TOOLS_BENCH_BLOCKS} "
          f"timed blocks of 25/25/25 in {bench_s:.2f} s, every kernel of "
          f"the main path launched (launches {launches}, none missing: "
          f"{missing})")
    torch.cuda.empty_cache()

    _cuda.reset_launches()
    t0 = time.perf_counter()
    _, lines = quietly(bench.bench_instances, N_INSTANCES,
                       n_iters=TOOLS_INSTANCE_ITERS)
    inst_s = time.perf_counter() - t0
    bench_line(lines, bench.INSTANCES_METRIC.format(k=N_INSTANCES))
    inst = dict(_cuda.LAUNCHES)
    missing = [k for k in MAIN_PATH if inst[k] == 0]
    check(not missing, f"tools.bench --instances {N_INSTANCES} at "
          f"{TOOLS_INSTANCE_ITERS} iterations a step in {inst_s:.2f} s, "
          f"every kernel of the main path launched (launches {inst})")
    torch.cuda.empty_cache()
    return launches


def tools_full_run(tmp, card):
    import os

    from gan2shape_torch.tools import full_instance_run as F

    out = os.path.join(tmp, "full_run_torch.json")
    result, _ = quietly(F.main, ["--out", out], prior=TOOLS_PRIOR,
                        stages=TOOLS_STAGES)
    with open(out) as f:
        saved = json.load(f)
    n = TOOLS_PRIOR + sum(sum(s.values()) for s in TOOLS_STAGES)
    check(saved == result and set(saved) == FULL_RUN_KEYS
          and saved["total_optimization_steps"] == n
          and saved["schedule"] == F.schedule_name(TOOLS_PRIOR,
                                                   TOOLS_STAGES)
          and saved["steady_state_instance_s"] > 0
          and all(math.isfinite(v) for v in saved["final_losses"].values())
          and len(saved["final_losses"]) == 3 and saved["device"] == card,
          f"tools.full_instance_run on a cut schedule ({saved['schedule']}, "
          f"{n} steps) twice: first {saved['first_instance_s']} s, steady "
          f"{saved['steady_state_instance_s']} s, losses "
          f"{saved['final_losses']}, device {saved['device']!r}; its JSON "
          f"where --out says")


def tools_pool_every(tmp):
    import os

    from gan2shape_torch.tools import check_pool_every as C

    out = os.path.join(tmp, "pool_every_check_torch.json")
    t0 = time.perf_counter()
    (code, results, _), _ = quietly(
        C.main, ["--fast", "--ks", *TOOLS_POOL_KS, "--floor", "--out", out])
    study_s = time.perf_counter() - t0
    with open(out) as f:
        saved = json.load(f)
    entry, floor = saved["ks"]["2"], saved["floor"]
    check(saved == json.loads(json.dumps(results)) and saved["fast"]
          and code == (0 if saved["ok"] else 1)
          and math.isfinite(entry["depth_mad_vs_base"])
          and math.isfinite(floor["depth_mad_vs_base"])
          and all(math.isfinite(entry[s]["tail_rel_dev"]) for s in C.STEPS),
          f"tools.check_pool_every --fast --ks 1 2 --floor in "
          f"{study_s:.2f} s: its JSON where --out says, exit code {code}")
    print(f"POOL K=2 against K=1: depth MAD {entry['depth_mad_vs_base']:.3e}"
          f" (p95 {entry['depth_p95_vs_base']:.3e}); floor, K=1 run twice: "
          f"{floor['depth_mad_vs_base']:.3e} (p95 "
          f"{floor['depth_p95_vs_base']:.3e}); bound {C.DEPTH_MAD_BOUND}",
          flush=True)
    for step in C.STEPS:
        print(f"POOL {step}: tail deviation K=2 {entry[step]['tail_rel_dev']}"
              f" (floor {floor['tail_rel_dev'][step]}, bound "
              f"{C.MAX_TAIL_DEV[step]}), pass {entry[step]['pass']}",
              flush=True)
    print(f"POOL verdict: ok {saved['ok']}, recommended_default "
          f"{saved['recommended_default']}; wall {saved['wall_s']} s "
          f"(a K inside the floor is not a finding)", flush=True)


def tools_raster(card):
    from gan2shape_torch.tools import bench_raster, chain_raster

    result = bench_raster.run(128, 16)
    check(result["agreement"] == 1.0
          and all(math.isfinite(v) and v > 0 for v in result["ms"].values())
          and result["device"] == card,
          f"tools.bench_raster at 128^2, B=16: raster_mega against "
          f"dense_winner agreement {result['agreement']:.5f} (exactly 1), "
          f"{len(result['ms'])} passes timed")
    for impl in chain_raster.IMPLS:
        r = chain_raster.per_call(impl, 20, 128, 16)
        check(math.isfinite(r["ms_per_call"]),
              f"tools.chain_raster --impl {impl}: {r['ms_per_call']:.4f} ms "
              f"a call (t[{r['n_small']}] {r['t_small_ms']:.3f} ms, "
              f"t[{r['n_big']}] {r['t_big_ms']:.3f} ms; {card})")


def write_reference_assets(root, seed):
    """Seeded random release files of the face category in the reference's
    layout under `root` (the StyleGAN2 checkpoint, VGG16, the LPIPS heads,
    the view / light MVNs, a data/face set of one image) and a trained
    checkpoint of the port's format under checkpoints/our_nets."""
    import os
    from pathlib import Path

    import numpy as np
    import torch
    from gan2shape_torch.core.checkpoint import CheckpointManager
    from gan2shape_torch.core.model import GAN2Shape
    from gan2shape_torch.utils.config import load_config

    repo = Path(__file__).resolve().parent
    config = load_config(category="face", config_dir=str(repo / "configs"),
                         minimal_config=str(repo / "minimal_config.yml"))
    write_image_set(root, 1, config["image_size"], seed)
    model = GAN2Shape(config, device="cpu")
    init = torch.Generator().manual_seed(seed)
    model.init_params(init)
    model.init_frozen(init)
    for sub in ("stylegan2", "view_light", "vgg", "lpips"):
        os.makedirs(os.path.join(root, "checkpoints", sub))
    torch.save({"g_ema": model.generator.state_dict(),
                "d": model.discriminator.state_dict()},
               os.path.join(root, config["gan_ckpt_path"]))
    write_reference_lpips(
        os.path.join(root, "checkpoints", "vgg", "vgg16.pth"),
        os.path.join(root, "checkpoints", "lpips", "vgg.pth"), seed + 1)
    rng = np.random.default_rng(seed)
    for name, n in (("view_mvn.pth", 6), ("light_mvn.pth", 4)):
        a = rng.standard_normal((n, n)).astype(np.float32)
        torch.save({"mean": torch.from_numpy(
                        0.1 * rng.standard_normal(n).astype(np.float32)),
                    "cov": torch.from_numpy(0.01 * (a @ a.T / n + 0.1 * np.eye(
                        n, dtype=np.float32)))},
                   os.path.join(root, "checkpoints", "view_light", name))
    CheckpointManager(os.path.join(root, "checkpoints", "our_nets")).save(
        model.nets, 0, 0, 1, "face")


class LogLines:
    """The messages one logger emits inside a with block."""

    def __init__(self, name):
        import logging

        self.logger = logging.getLogger(name)
        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.lines.append(
            record.getMessage())

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def tools_real_assets(tmp):
    import os

    import numpy as np
    from gan2shape_torch.tools import run_real_assets as R

    empty = os.path.join(tmp, "empty")
    os.makedirs(empty)
    code, lines = quietly(R.main, ["--root", empty, "--fast"])
    summary = os.path.join(empty, "build", "run_real_torch.json")
    with open(summary) as f:
        blocked = json.load(f)
    wanted = [p for p, _ in R.required_assets("face")]
    check(code == 2 and all(any(p in line for line in lines)
                            for p in wanted)
          and blocked == {"ok": False, "skipped": True, "category": "face",
                          "missing": wanted}
          and sorted(os.listdir(empty)) == ["build"],
          f"tools.run_real_assets in an empty root: exit {code}, the "
          f"{len(wanted)} missing files listed, the summary skipped")

    assets = os.path.join(tmp, "assets")
    t0 = time.perf_counter()
    write_reference_assets(assets, seed=20)
    written_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with LogLines("gan2shape_torch.convert.reference") as log:
        code, _ = quietly(R.main, ["--root", assets, "--fast"])
    run_s = time.perf_counter() - t0
    out_dir = os.path.join(assets, "results", "real_assets", "face")
    with open(os.path.join(out_dir, "REAL_ASSETS.json")) as f:
        result = json.load(f)
    with open(os.path.join(assets, "build", "run_real_torch.json")) as f:
        summary = json.load(f)
    depth = np.load(os.path.join(out_dir, "depth.npy"))
    mad = result.get("depth_mad_vs_reference_ckpt")
    loaded = [line for line in log if line.startswith("loaded")]
    check(code == 0 and summary == {"ok": True, "skipped": False, **result}
          and depth.shape == (128, 128) and np.isfinite(depth).all()
          and result["depth_stats"]["finite"]
          and all(math.isfinite(v) for v in result["final_losses"].values())
          and isinstance(mad, float) and math.isfinite(mad)
          and len(loaded) == 2 and not any("not found" in line
                                           for line in log),
          f"tools.run_real_assets --fast over random reference-layout files "
          f"(written in {written_s:.2f} s): exit {code} in {run_s:.2f} s, "
          f"fit {result['wall_s']} s, depth {depth.shape} in "
          f"[{depth.min():.4f}, {depth.max():.4f}], losses "
          f"{result['final_losses']}, depth-MAD against the written "
          f"checkpoint {mad}; files read: {loaded}")


# ---------------- phase 14: two card runs repeat ----------------

REPEAT_TIMEOUT = 600  # seconds for the child process (the phase: ~1 min)


def run_repeat(card):
    """Phase 14 in a child process whose environment holds
    CUBLAS_WORKSPACE_CONFIG from its start: cuBLAS reads it once, when its
    first handle is made, which the earlier phases did without it."""
    import os
    from gan2shape_torch.utils import precision as P

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=P.CUBLAS_WORKSPACE_CONFIG)
    sys.stdout.flush()
    t0 = time.perf_counter()
    try:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--repeat-child"], env=env,
                            timeout=REPEAT_TIMEOUT).returncode
    except subprocess.TimeoutExpired:  # run() has killed the child
        rc = f"a timeout after {REPEAT_TIMEOUT} s"
    check(rc == 0, f"the repeat phase's process ended with {rc}")
    print(f"TIME repeat phase: {time.perf_counter() - t0:.2f} s wall, its "
          f"process included ({card})", flush=True)


def recorded_fit(image, latent):
    """Phase 6's fit from seed 0: (every iteration's loss of the prior and
    the three steps, in order, as one tensor; the nets' parameters; the
    launch counts, zeroed just before and read just after)."""
    import torch
    from gan2shape_torch.core.trainer import Trainer
    from gan2shape_torch.ops import _cuda

    losses = []

    def recording(real):
        def step(self, loss, opt):
            losses.append(loss.detach().clone())
            return real(self, loss, opt)
        return step

    trainer = Trainer(FACE128, seed=0)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with patched(Trainer, "_step", recording):
        trainer.fit([(image, latent, 0)], stages=[STAGE])
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    nets = {k: v.detach().clone()
            for k, v in trainer.model.nets.state_dict().items()}
    return torch.cat([x.reshape(-1) for x in losses]), nets, launches


def fits_compared(a, b):
    """(losses bit-equal, every parameter bit-equal, largest loss gap,
    largest parameter gap) of two recorded fits."""
    import torch
    la, na, _ = a
    lb, nb, _ = b
    nets = all(torch.equal(na[k], nb[k]) for k in na)
    loss_gap = float((la - lb).abs().max())
    net_gap = max(float((na[k] - nb[k]).abs().max()) for k in na)
    return torch.equal(la, lb), nets, loss_gap, net_gap


def repeat_main():
    """`--repeat-child`: phase 6's fit twice from one seed under
    `precision.deterministic()`, every loss and every net parameter
    compared bit for bit; twice more without it (an INFO line: how far two
    runs differ there); then phase 6's timed blocks with and without the
    context, in turns."""
    import numpy as np
    import torch
    from gan2shape_torch.core.trainer import Trainer
    from gan2shape_torch.device import resolve_device
    from gan2shape_torch.ops import _cuda
    from gan2shape_torch.utils import precision as P

    P.set_matmul_precision("highest")
    P.set_act_dtype("float32")
    resolve_device("cuda")
    _cuda.build()
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (3, 128, 128)).astype(np.float32)
    latent = rng.standard_normal(512).astype(np.float32)
    try:
        t0 = time.perf_counter()
        with P.deterministic():
            a = recorded_fit(image, latent)
            b = recorded_fit(image, latent)
        fit_s = (time.perf_counter() - t0) / 2
        launches = a[2]
        missing = [k for k in MAIN_PATH if launches[k] == 0]
        check(not missing and a[2] == b[2],
              f"repeat: every kernel of the main path launched under "
              f"deterministic(), as often in both runs (none missing: "
              f"{missing}; {launches})")
        losses, nets, loss_gap, net_gap = fits_compared(a, b)
        check(bool(torch.isfinite(a[0]).all()) and losses,
              f"repeat: phase 6's fit twice under deterministic() "
              f"({fit_s:.2f} s a fit): all {a[0].numel()} losses (prior "
              f"{FACE128['n_epochs_prior']} + {STAGE}) bit-equal")
        check(nets, f"repeat: every one of the {len(a[1])} net parameter "
              f"tensors bit-equal after the two fits")
        c = recorded_fit(image, latent)
        d = recorded_fit(image, latent)
        losses, nets, loss_gap, net_gap = fits_compared(c, d)
        print(f"INFO repeat without deterministic(): losses bit-equal "
              f"{losses} (largest gap {loss_gap:.3e}), nets bit-equal {nets} "
              f"(largest gap {net_gap:.3e}); against the deterministic run: "
              f"losses {float((c[0] - a[0]).abs().max()):.3e} apart",
              flush=True)

        trainer = Trainer(FACE128, seed=0)
        img = torch.as_tensor(image, device="cuda")[None]
        lat = torch.as_tensor(latent, device="cuda")[None]
        prior = torch.full((128, 128), 1.0, device="cuda")
        blocks = {True: [], False: []}
        for det in (True, False, False, True):
            if det:
                with P.deterministic():
                    per_step = timed_steps(trainer, img, lat, prior,
                                           TIMED_ITERS)[0]
            else:
                per_step = timed_steps(trainer, img, lat, prior,
                                       TIMED_ITERS)[0]
            blocks[det].append({k: v[0] for k, v in per_step.items()})
        ms = {det: {k: sum(blk[k] for blk in v) / len(v) for k in v[0]}
              for det, v in blocks.items()}
        for k in ms[True]:
            print(f"TIME repeat {k}: {ms[True][k]:.2f} ms/iter under "
                  f"deterministic(), {ms[False][k]:.2f} without "
                  f"({ms[True][k] / ms[False][k] - 1:+.1%}; blocks of "
                  f"{TIMED_ITERS} in turns on, off, off, on: "
                  f"{[round(b[k], 2) for b in blocks[True]]} / "
                  f"{[round(b[k], 2) for b in blocks[False]]})", flush=True)
        inst = {det: sum(n * ms[det][k] for k, n in SCHEDULE.items()) / 1e3
                for det in ms}
        print(f"TIME repeat instance: {inst[True]:.1f} s projected for the "
              f"face schedule under deterministic(), {inst[False]:.1f} "
              f"without ({inst[True] / inst[False] - 1:+.1%})", flush=True)
    except Failed:
        return 1
    return 0


# ---------------- phase 15: the other categories ----------------

# configs/<category>.yml's widths: GAN size, channel multiplier, pseudo
# samples a step-2 iteration
CATEGORY_WIDTHS = {"cat": (256, 1, 16), "church": (256, 2, 8),
                   "car": (512, 2, 8)}
CATEGORY_PRIOR = "smoothed_box"  # the prior of BASELINE.json's targets
CATEGORY_IMAGES = 8     # each written set: car's --generalize batch
CATEGORY_GENERALIZING_STAGE = {"step1": 5, "step2": 1, "step3": 1}
CATEGORY_AT_ONCE = ("church", "car")  # instance-parallel at N=2, then N
CATEGORY_NS = (8, 4)    # the N tried after N=2, the largest first
CATEGORY_HEADROOM = 0.9  # the share of the card's memory an N may take
CATEGORY_N_ITERS = 5    # the large N's timed block, iterations a step


class OnesMasker:
    """The all-ones masks of a category outside the VOC classes."""

    def __init__(self, size):
        self.size = size

    def confidence_mask(self, image):
        import numpy as np
        return np.ones((1, self.size, self.size), np.float32)

    image_mask = confidence_mask


def write_gan_checkpoint(filename, size, channel_multiplier, seed):
    """A seeded random StyleGAN2 checkpoint in the reference's layout
    ({"g_ema", "d"}, the generator's noise buffers included) at `size` and
    `channel_multiplier`.  Returns what it wrote."""
    import os

    import torch
    from gan2shape_torch.models.layers import reset_parameters
    from gan2shape_torch.models.stylegan2 import Discriminator, Generator

    g = torch.Generator().manual_seed(seed)
    gen = Generator(size, 512, 8, channel_multiplier)
    disc = Discriminator(size, channel_multiplier)
    reset_parameters(gen, g)
    reset_parameters(disc, g)
    with torch.no_grad():
        for buf, n in zip(gen.noise_list(), gen.make_noise(g)):
            buf.copy_(n)
    ckpt = {"g_ema": gen.state_dict(), "d": disc.state_dict()}
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    torch.save(ckpt, filename)
    return ckpt


def write_parsing_checkpoint(category, image, seed):
    """checkpoints/parsing/pspnet_voc.pth of seeded random PSPNet-50
    weights.  For a VOC category the final bias of its class is raised by
    the median of the margin by which it loses on `image`, so that it wins
    on about half of the net's pixels there: random weights alone may never
    pick the class, and the masker would then give its all-ones mask."""
    import os

    import numpy as np
    import torch
    from gan2shape_torch.core import masking as M

    sd = random_parsing_state_dict(category, seed)
    if category in M.CATEGORY2NUMBER:
        k = M.CATEGORY2NUMBER[category]
        out = M.MaskingModel(category, 128, state_dict=sd,
                             device="cuda").logits(image[None])[0]
        margin = np.delete(out, k, axis=0).max(0) - out[k]
        sd["cls.4.bias"][k] += float(np.median(margin))
    os.makedirs(os.path.join("checkpoints", "parsing"), exist_ok=True)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               M.checkpoint_path(category))


def free_card():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def step2_gflop(trainer, img, lat, collected):
    """GFLOP of one step-2 iteration's forward and backward (not its pool's
    render), as torch.utils.flop_counter counts them: the convolutions and
    matrix products, on this trainer's shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    model = trainer.model
    inv = model.step2_invariants(lat)
    pool = model.step2_sample(trainer.sampler, collected,
                              trainer.n_proj_samples)
    counter = FlopCounterMode(display=False)
    with counter:
        loss, _ = model.step2_loss(lat, *pool, inv)
        loss.sum().backward()
    model.zero_grad(set_to_none=True)
    return counter.get_total_flops() / 1e9


def run_categories(card):
    """Phase 15: the method at the cat, church and car configs, each in a
    temporary folder of its own, after the FLOP count of face-128's step 2
    for comparison.  Returns {category: the launch counts of its cli.train
    instance run}."""
    import numpy as np
    import torch
    from gan2shape_torch.core.trainer import Trainer

    t_phase = time.perf_counter()
    face = Trainer(FACE128, seed=0)
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.uniform(-1, 1, (1, 3, 128, 128)).astype(
        np.float32), device="cuda")
    lat = torch.as_tensor(rng.standard_normal((1, 512)).astype(np.float32),
                          device="cuda")
    collected, _ = face.run_step1(img, 0)
    print(f"FLOP face-128 step2: {step2_gflop(face, img, lat, collected):.1f}"
          f" GFLOP an iteration (torch.utils.flop_counter)", flush=True)
    del face
    free_card()
    launches = {}
    for i, category in enumerate(CATEGORY_WIDTHS):
        t0 = time.perf_counter()
        launches[category] = run_category(category, 30 + 10 * i, card)
        print(f"TIME category {category}: {time.perf_counter() - t0:.2f} s "
              f"wall ({card})", flush=True)
    print(f"TIME categories phase: {time.perf_counter() - t_phase:.2f} s "
          f"wall ({card})", flush=True)
    return launches


def run_category(category, seed, card):
    """One category: its config from load_config (the prior, as --prior
    smoothed_box gives it, and the depth overridden), the reference-layout
    files written (an image set, the GAN checkpoint, the PSPNet parsing
    file), cli.train in instance mode and cli.evaluate, timed blocks of
    each step, car's --generalize, and for church and car instances at
    once."""
    import os
    import tempfile
    from pathlib import Path

    from gan2shape_torch.cli import evaluate as E
    from gan2shape_torch.cli import train as T
    from gan2shape_torch.core import checkpoint as C
    from gan2shape_torch.core.dataset import ImageLatentDataset
    from gan2shape_torch.core.trainer import GeneralizingTrainer
    from gan2shape_torch.ops import _cuda
    from gan2shape_torch.utils.config import load_config

    root = Path(__file__).resolve().parent
    here = os.getcwd()
    gan_size, cm, n_proj = CATEGORY_WIDTHS[category]
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the config's relative paths and results/ live here
        try:
            config = load_config(
                category=category, config_dir=str(root / "configs"),
                minimal_config=str(root / "minimal_config.yml"),
                overrides={"prior_name": CATEGORY_PRIOR,
                           "n_epochs_prior": FACE128["n_epochs_prior"],
                           "n_epochs_generalized": 1})
            check(config["image_size"] == 128
                  and (config["gan_size"], config["channel_multiplier"],
                       config["n_proj_samples"]) == (gan_size, cm, n_proj)
                  and config["z_dim"] == 512
                  and config.get("lpips_net", "vgg") == "vgg"
                  and config.get("disc_ftr_num", 4) == 4,
                  f"{category} config from load_config: image "
                  f"{config['image_size']}, GAN {config['gan_size']}, "
                  f"channel_multiplier {config['channel_multiplier']}, "
                  f"n_proj_samples {config['n_proj_samples']}, z "
                  f"{config['z_dim']}, LPIPS-"
                  f"{config.get('lpips_net', 'vgg')}, disc_ftr_num "
                  f"{config.get('disc_ftr_num', 4)}, prior "
                  f"{config['prior_name']}, GAN checkpoint "
                  f"{config['gan_ckpt_path']}")
            t0 = time.perf_counter()
            write_image_set(".", CATEGORY_IMAGES, 128, seed, category)
            data = ImageLatentDataset(os.path.join("data", category),
                                      image_size=128)
            gan = write_gan_checkpoint(config["gan_ckpt_path"], gan_size, cm,
                                       seed)
            write_parsing_checkpoint(category, data[0][0], seed)
            print(f"{category}: {CATEGORY_IMAGES} images, the GAN checkpoint "
                  f"and the parsing file written in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)

            trainer, launches, prior = category_instance(
                T, E, C, _cuda, config, gan, data)
            category_timing(trainer, data, prior, card)
            del trainer
            free_card()
            if category == "car":
                generalizing(T, C, GeneralizingTrainer, _cuda,
                             dict(config, batch_size=CATEGORY_IMAGES), data,
                             card, stage=CATEGORY_GENERALIZING_STAGE,
                             flags=["--prior", CATEGORY_PRIOR])
                free_card()
            if category in CATEGORY_AT_ONCE:
                category_instances(config, data, card)
        finally:
            os.chdir(here)
            free_card()
    return launches


def category_instance(T, E, C, _cuda, config, gan, data):
    """cli.train --category <c> --prior smoothed_box --save-ckpts --images
    0 and cli.evaluate --record-loss (phase 7's checks), with the GAN
    checkpoint that build_frozen_assets loaded held against the written
    one and the prior held to the masker's.  Returns (the trainer, the
    launch counts of cli.train, image 0's prior)."""
    import numpy as np
    import torch
    from gan2shape_torch.core import masking as M
    from gan2shape_torch.core.priors import FallbackMasker, PriorGenerator
    from gan2shape_torch.core.trainer import Trainer

    category = config["category"]
    seen = []

    def recording(real):
        def run_prior(self, images, priors, n_iters):
            seen.append((self.prior_generator.masking_model,
                         priors.detach().cpu().numpy()))
            return real(self, images, priors, n_iters)
        return run_prior

    with patched(Trainer, "run_prior", recording), \
            LogLines("gan2shape_torch.convert.reference") as log:
        trainer, launches, history = instance_and_evaluation(
            T, E, C, _cuda, config, images=(0,),
            flags=["--prior", CATEGORY_PRIOR])
    loaded = [line for line in log if line.startswith("loaded GAN")]
    same = all(torch.equal(v.cpu(), gan[key][k])
               for key, net in (("g_ema", trainer.model.generator),
                                ("d", trainer.model.discriminator))
               for k, v in net.state_dict().items())
    check(len(loaded) == 2 and not any("not found" in line and "GAN" in line
                                       for line in log) and same,
          f"{category}: the written GAN checkpoint ({config['gan_size']}^2, "
          f"channel_multiplier {config['channel_multiplier']}, "
          f"{trainer.model.generator.n_latent} latents) loaded by "
          f"cli.train and cli.evaluate ({loaded[:1]}), the trainer's G and "
          f"D bit-equal to it")

    (masker, prior), = seen
    image = data[0][0]
    size = config["image_size"]

    def prior_of(m):
        return PriorGenerator(size, category, CATEGORY_PRIOR,
                              masking_model=m)(image)[0]

    share = float((np.asarray(masker.image_mask(image[None])) > 0.5).mean())
    ones = np.abs(prior - prior_of(OnesMasker(size))).max()
    fallback = np.abs(prior - prior_of(FallbackMasker(size))).max()
    if category in M.CATEGORY2NUMBER:
        ok = 0 < share < 1 and ones > 1e-3 and fallback > 1e-3
        what = (f"{share:.3f} of the image in the hard mask; "
                f"{ones:.3e} from the all-ones mask's prior")
    else:
        ok = share == 1 and ones == 0 and fallback > 1e-3
        what = "the all-ones mask of a category outside VOC's (bit-equal)"
    check(isinstance(masker, M.MaskingModel) and ok,
          f"{category}: the {CATEGORY_PRIOR} prior from the written PSPNet: "
          f"{what}; {fallback:.3e} from the fallback masker's")
    return trainer, launches, torch.as_tensor(prior, device="cuda")


def category_timing(trainer, data, prior, card):
    """Phase 6's timed blocks and profiler windows on the category's
    trained instance, the peak memory over the blocks and the instance
    time the schedule projects; car's step 2 also under 'high'."""
    import numpy as np
    import torch
    from gan2shape_torch.utils import precision as P

    category = trainer.category
    image, latent, _ = data[0]
    img = torch.as_tensor(image, device="cuda")[None]
    lat = torch.as_tensor(np.asarray(latent).reshape(1, -1), device="cuda")
    free_card()
    per_step, losses, collected, coll2 = timed_steps(
        trainer, img, lat, prior, TIMED_ITERS)
    peak = peak_gib()
    check(all(math.isfinite(float(x)) for x in sum(losses, [])),
          f"{category} timed-block losses finite")
    step_ms = {k: v[0] for k, v in per_step.items()}
    for name, ms in step_ms.items():
        print(f"STEP {category} {name}: {ms:.2f} ms/iter over {TIMED_ITERS} "
              f"iterations", flush=True)
    instance_s = sum(k * step_ms[s] for s, k in SCHEDULE.items()) / 1e3
    print(f"INSTANCE {category} {instance_s:.1f} s projected for the "
          f"schedule {SCHEDULE}; peak memory {peak:.2f} GiB over the blocks "
          f"(torch.cuda.max_memory_allocated); {card}", flush=True)
    busy = profile_steps(trainer, img, lat, prior, collected, coll2, step_ms,
                         label=f"{category} ")
    gflop = step2_gflop(trainer, img, lat, collected)
    rate = (f"{gflop / busy['step2']:.2f} TFLOP/s of its device-busy time"
            if busy.get("step2") else "device busy not measured")
    print(f"FLOP {category} step2: {gflop:.1f} GFLOP an iteration "
          f"(torch.utils.flop_counter): {gflop / step_ms['step2']:.2f} "
          f"TFLOP/s over its {step_ms['step2']:.2f} ms/iter, {rate}",
          flush=True)
    if category == "car":
        with P.policy("high"):
            trainer.run_step2(img, lat, collected, 1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, l2 = trainer.run_step2(img, lat, collected, TIMED_ITERS)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3 / TIMED_ITERS
        check(all_finite([float(x) for x in l2])
              and P.matmul_precision() == "highest",
              "car step 2 under 'high': losses finite, the policy restored")
        print(f"TIME car step2 under 'high': {ms:.2f} ms/iter over "
              f"{TIMED_ITERS} iterations, against {step_ms['step2']:.2f} at "
              f"'highest' ({card})", flush=True)


def category_instances(config, data, card):
    """InstanceParallelTrainer at N=2 on phase 9's fit, held to a
    sequential Trainer (launches, iteration 0); then the largest N of
    CATEGORY_NS that the peak memory of N=1 and N=2 says fits the card
    with CATEGORY_HEADROOM, for one timed block."""
    import numpy as np
    import torch
    from gan2shape_torch.convert.reference import build_frozen_assets
    from gan2shape_torch.core.trainer import Trainer
    from gan2shape_torch.ops import _cuda
    from gan2shape_torch.parallel import InstanceParallelTrainer

    category = config["category"]

    def losses_of(history):
        return [x for h in history for k in ("losses_step1", "losses_step2",
                                             "losses_step3") for x in h[k]]

    def instances(n):
        trainer = InstanceParallelTrainer(config, n, seed=0)
        build_frozen_assets(trainer.model, config)
        images = np.stack([data[i][0] for i in range(n)])
        latents = np.stack([np.asarray(data[i][1]).reshape(-1)
                            for i in range(n)])
        priors = np.stack([trainer.prior_generator(im)[0] for im in images])
        return trainer, images, latents, priors

    def iteration0(model, img):
        with torch.no_grad():
            loss, _ = model.step1_iter(img, model.step1_invariants(img))
        return loss

    seq = Trainer(config, seed=0)
    build_frozen_assets(seq.model, config)
    image, latent, _ = data[0]
    img0 = torch.as_tensor(image, device="cuda")[None]
    alone = float(iteration0(seq.model, img0))
    free_card()
    _cuda.reset_launches()
    seq_losses = losses_of(seq.fit([(image, latent, 0)], stages=[STAGE]))
    torch.cuda.synchronize()
    seq_launches = dict(_cuda.LAUNCHES)
    p1 = peak_gib()
    del seq
    free_card()

    trainer, images, latents, priors = instances(2)
    batched = iteration0(trainer.model, torch.as_tensor(images,
                                                        device="cuda"))
    rel = abs(float(batched[0]) - alone) / abs(alone)
    check(batched.shape == (2,) and rel <= 1e-5,
          f"{category} instance 0's step-1 iteration-0 loss "
          f"{float(batched[0]):.7f} at N=2 against a sequential Trainer's "
          f"{alone:.7f} from the same init: {rel:.2e} relative (<= 1e-5)")
    free_card()
    history, launches, fit_s = counted_fit(trainer, images, latents, priors)
    p2 = peak_gib()
    losses = losses_of(history)
    same = {k: (launches[k], seq_launches[k]) for k in MAIN_PATH}
    check(len(history) == 2 and all_finite(losses + seq_losses)
          and all(a == b > 0 for a, b in same.values()),
          f"{category} N=2 fit in {fit_s:.2f} s and a sequential Trainer's "
          f"fit of one instance, {len(losses)} + {len(seq_losses)} losses "
          f"finite; each kernel launched as often at N=2 as for one "
          f"instance (N=2, one): {same}")
    del trainer
    free_card()

    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    per = p2 - p1
    reckoned = {n: p1 + (n - 1) * per for n in CATEGORY_NS}
    fits = [n for n in CATEGORY_NS if reckoned[n] <= CATEGORY_HEADROOM * total]
    n = fits[0] if fits else 2
    print(f"MEMORY {category}: peak {p1:.2f} GiB for one instance's fit, "
          f"{p2:.2f} at N=2 ({per:.2f} an instance); reckoned "
          + ", ".join(f"N={k} {v:.2f}" for k, v in reckoned.items())
          + f" GiB against {CATEGORY_HEADROOM:.0%} of {total:.2f}: N={n}",
          flush=True)
    trainer, images, latents, priors = instances(n)
    img = torch.as_tensor(images, device="cuda")
    lat = torch.as_tensor(latents, device="cuda")
    prior = torch.as_tensor(priors, device="cuda")
    free_card()
    per_step, _, timed_losses = timed_instance_steps(trainer, img, lat, prior,
                                                     CATEGORY_N_ITERS)
    peak = peak_gib()
    check(all(bool(torch.isfinite(x).all()) for x in timed_losses)
          and peak <= CATEGORY_HEADROOM * total,
          f"{category} N={n}: timed-block losses finite, peak memory "
          f"{peak:.2f} GiB (reckoned {reckoned.get(n, p2):.2f}) within "
          f"{CATEGORY_HEADROOM:.0%} of the card's {total:.2f}")
    for name, ms in per_step.items():
        print(f"STEP {category} instances {name}: {ms:.2f} ms/iter for {n} "
              f"instances ({ms / n:.2f} an instance) over "
              f"{CATEGORY_N_ITERS} iterations", flush=True)
    projected = sum(c * per_step[s] for s, c in SCHEDULE.items()) / 1e3 / n
    print(f"INSTANCE {category} {projected:.1f} s projected per instance at "
          f"N={n} for the schedule {SCHEDULE}; peak memory {peak:.2f} GiB; "
          f"{card}", flush=True)


def main(argv):
    import torch

    if len(argv) == 2 and argv[0] == "--distributed-rank":
        return dist_rank_main(argv[1])
    if argv == ["--repeat-child"]:
        return repeat_main()
    kernels_only = argv == ["--kernels"]
    precision_only = argv == ["--precision"]
    planted = argv == ["--distributed-planted"]
    distributed_only = argv == ["--distributed"] or planted
    tools_only = argv == ["--tools"]
    repeat_only = argv == ["--repeat"]
    categories_only = argv == ["--categories"]
    splat_times = argv[1] if len(argv) == 2 and argv[0] == "--splat-times" \
        else None
    if argv and not (kernels_only or precision_only or distributed_only
                     or tools_only or repeat_only or categories_only
                     or splat_times):
        print(f"usage: python3 chip_smoke.py [--kernels | --precision | "
              f"--distributed | --distributed-planted | --tools | --repeat "
              f"| --categories | --splat-times FILE] (got {argv})")
        return 2
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: this smoke run needs one GPU",
              flush=True)
        return 1
    card = card_line()
    print(f"CARD {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if splat_times:
        time_saved_splats(splat_times)
        print(card_line(), flush=True)
        return 0
    try:
        from gan2shape_torch.device import resolve_device
        from gan2shape_torch.ops import _cuda
        from gan2shape_torch.utils import precision as P

        # phases 1-10 run at exact f32, whatever the environment asks for
        P.set_matmul_precision("highest")
        P.set_act_dtype("float32")
        resolve_device("cuda")
        t0 = time.perf_counter()
        logs = _cuda.build()
        print(f"BUILD {sorted(logs)} in {time.perf_counter() - t0:.2f} s "
              f"(already built: {sorted(set(_cuda.SOURCES) - set(logs))})",
              flush=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

        results = {}
        check_raster(results)
        captured = check_window(results)
        check_bias_act()
        if kernels_only:
            torch.save([(label, g.cpu(), iy.cpu(), ix.cpu(), shape)
                        for label, g, iy, ix, shape in captured],
                       SPLAT_CALLS)
        if precision_only:
            run_precision(card)
        elif distributed_only:
            run_distributed(card, planted)
        elif tools_only:
            run_tools(card)
        elif repeat_only:
            run_repeat(card)
        elif categories_only:
            category_launches = run_categories(card)
        elif not kernels_only:
            check_raster_gradients()
            check_launches = run_check_path(results)
            run_modes_and_renders()
            launches, step_ms = run_main_path()
            gen_launches = run_entry_points(card)
            run_masker(card)
            inst_launches = run_instances(card, launches, step_ms)
            gan = run_gan_side(card)
            run_precision(card)
            rank_launches = run_distributed(card)
            bench_launches = run_tools(card)
            run_repeat(card)
            category_launches = run_categories(card)
    except Failed:
        return 1
    except RuntimeError as exc:  # a timing that found no device activity
        print(f"FAIL {exc}", flush=True)
        return 1
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if (kernels_only or precision_only or distributed_only or tools_only
                or repeat_only or categories_only):
            # no main path: no launch counts (the categories' own apart)
            if name in results:
                extra = {f"launches_{c}": n[name] for c, n in
                         category_launches.items()} if categories_only \
                    and name not in SERVED_BY else {}
                kernels.append({"name": name, "route": "cuda",
                                "source": source, "replaces": replaces,
                                "launches": None, **results[name], **extra})
            continue
        # each entry's launches on the path that is its own: raster_mega's,
        # those of the kernels that serve it on the rasterizer check; the
        # others' on the main path
        extra = {}
        if name in SERVED_BY:
            extra["served_by"] = {
                kernel: check_launches[counter] // len(KERNEL_NAMES[counter])
                for counter in SERVED_BY[name]
                for kernel in KERNEL_NAMES[counter]}
            n = sum(extra["served_by"].values())
        else:
            n = launches[name]
            extra["launches_generalizing_step1"] = gen_launches[name]
            extra[f"launches_{N_INSTANCES}_instances"] = inst_launches[name]
            extra["launches_gan_side"] = gan["launches"][name]
            extra[f"launches_{N_INSTANCES}_instances_per_rank"] = [
                rank_launches[r][name] for r in sorted(rank_launches)]
            extra["launches_bench"] = bench_launches[name]
            for c, counts in category_launches.items():
                extra[f"launches_{c}"] = counts[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n,
                        **results[name], **extra})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
