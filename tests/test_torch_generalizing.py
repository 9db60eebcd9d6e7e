"""The port's GeneralizingTrainer against the JAX package's, and the
pseudo-sample pool schedule of `pseudo_pool_every`.

The trainers run from one init, the port's, brought into the JAX trainer
by the JAX package's own converters (gan2shape_tpu/convert/torch2jax.py),
at 64 px with a 32-px GAN: 2 images, `batch_size` 2, one epoch, stage
{2, 1, 1}: a batched prior, batched step 1, then steps 2 and 3 per image.
The step-2 pool is one fixed numpy pool on both sides, and the JAX scans
run as Python loops: XLA:CPU runs the step-2 convolutions ~100x slower
inside a while loop, and `unroll=True` keeps one for the 1-iteration blocks
here (about 50 s a step-2 call against 0.6).  The JAX side rasterizes in its
exact 'scatter' mode; the port in 'grid', its training path.  The loss
trajectories are held to rtol 3e-3 with atol 3e-3, the limits of
test_torch_trainer.py: Adam's sign-like first steps amplify rounding
differences that far (ROADMAP C).  Measured: the largest relative gap is
1.2e-3, in the second image's step-3 loss (1.9e-3 absolute); step 1's are
2.9e-4 and below."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.convert import torch2jax
from gan2shape_tpu.core import trainer as j_trainer
from gan2shape_tpu.core.model import GAN2Shape as JGAN2Shape

from gan2shape_torch.core import trainer as t_trainer
from gan2shape_torch.core.checkpoint import CheckpointManager, NETS
from gan2shape_torch.distributed import make_mesh

S = 64
CFG = {
    "image_size": S, "gan_size": 32, "z_dim": 512,
    "channel_multiplier": 1, "category": "face", "disc_ftr_num": 3,
    "rot_center_depth": 1.0, "fov": 10, "n_proj_samples": 2,
    "n_epochs_prior": 2, "learning_rate": 1e-4, "prior_name": "box",
    "n_epochs_generalized": 1,
}
STAGES = [{"step1": 2, "step2": 1, "step3": 1}]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes it (these CPU tests ran 10-30x slower in the suite than
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def python_scan(f, init, xs=None, length=None, **_):
    """jax.lax.scan's semantics as a Python loop (traced straight-line)."""
    n = length if xs is None else len(jax.tree.leaves(xs)[0])
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, None if xs is None
                     else jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def _jax_init(model):
    """A port GAN2Shape's weights as the JAX package's init_params and
    init_frozen pytrees (the encoder nets' converter there is written for
    128 px, whose nets have one more conv: conv0..conv{n-3}, conv5, conv6
    in layer order)."""
    def j(tree):
        return jax.tree.map(jnp.asarray, tree)

    params = {}
    for name in NETS:
        sd = model.nets[name].state_dict()
        if name in ("viewpoint", "lighting"):
            names = [f"conv{i}" for i in range(len(sd) - 2)] + ["conv5",
                                                                 "conv6"]
            params[name] = {"params": {"encoder": {
                n: {"weight": sd[f"network.{2 * i}.weight"].numpy()}
                for i, n in enumerate(names)}}}
        elif name == "offset_encoder":
            params[name] = torch2jax.convert_offset_encoder(sd, S)
        else:
            params[name] = torch2jax.convert_encoder_decoder_net(sd)
    gen, noise = torch2jax.convert_generator(model.generator.state_dict())
    lp = model.lpips.state_dict()
    frozen = {"generator": gen, "noise": [np.asarray(n) for n in noise],
              "discriminator": torch2jax.convert_discriminator(
                  model.discriminator.state_dict()),
              "lpips": torch2jax.convert_lpips(
                  {k[4:]: v for k, v in lp.items() if k.startswith("vgg.")},
                  lp)}
    return j(params), j(frozen)


def _data(rng, n):
    images = rng.uniform(-1, 1, (n, 3, S, S)).astype(np.float32)
    latents = rng.standard_normal((n, 512)).astype(np.float32)
    return [(images[i], latents[i], i) for i in range(n)]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    rng = np.random.default_rng(0)
    data = _data(rng, 2)
    pool = (rng.uniform(-1, 1, (2, 3, S, S)).astype(np.float32),
            (rng.uniform(0, 1, (2, 1, S, S)) > 0.2).astype(np.float32))
    jdir = tmp_path_factory.mktemp("jax_ckpts")
    tdir = tmp_path_factory.mktemp("port_ckpts")

    tt = t_trainer.GeneralizingTrainer2(
        dict(CFG, raster_mode="grid",
             our_nets_ckpts={"VLADE_nets": str(tdir)}),
        save_ckpts=True, device="cpu")
    params, frozen = _jax_init(tt.model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JGAN2Shape, "init_params", lambda self, key: params)
        jt = j_trainer.GeneralizingTrainer(
            dict(CFG, raster_mode="scatter",
                 our_nets_ckpts={"VLADE_nets": str(jdir)}), save_ckpts=True,
            frozen=frozen)

    def jax_pool(key, collected, n):
        # tied to a traced value so XLA does not fold the discriminator
        # pass over the pool at compile time
        z = 0.0 * jnp.sum(collected[3])
        return jnp.asarray(pool[0]) + z, jnp.asarray(pool[1]) + z

    jt.model.step2_sample = jax_pool
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "scan", python_scan)
        jh = jt.fit(data, stages=STAGES, batch_size=2)

    tt.model.step2_sample = lambda g, collected, n: tuple(
        torch.from_numpy(a.copy()) for a in pool)
    th = tt.fit(data, stages=STAGES, batch_size=2)
    return jh, th, tt, jdir, tdir


def test_history_structure_matches_jax(fitted):
    jh, th = fitted[:2]
    assert len(th) == len(jh) == 2
    for jr, tr in zip(jh, th):
        assert set(tr) == set(jr)
        for k in ("epoch", "image_num", "total_it"):
            assert tr[k] == jr[k], k
    assert th[-1]["total_it"] == 2 + 2 * (1 + 1)
    assert "losses_step1" not in th[0] and len(th[-1]["losses_step1"]) == 2


def test_loss_trajectories_match_jax(fitted):
    jh, th = fitted[:2]
    for jr, tr in zip(jh, th):
        for k in ("losses_step1", "losses_step2", "losses_step3"):
            if k not in jr:
                continue
            assert len(tr[k]) == len(jr[k]) > 0
            assert np.all(np.isfinite(tr[k]))
            np.testing.assert_allclose(tr[k], jr[k], rtol=3e-3, atol=3e-3)
        for k in ("loss_step1", "loss_step2", "loss_step3"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=3e-3, atol=3e-3)


def test_general_checkpoint_matches_jax(fitted):
    """Epoch 0 writes one general checkpoint (image "") in each package,
    with the same manifest fields; the port's files hold its final nets."""
    jh, th, tt, jdir, tdir = fitted
    (jm,) = j_trainer.CheckpointManager(str(jdir)).manifests("face")
    mgr = CheckpointManager(str(tdir))
    (tm,) = mgr.manifests("face")
    for k in ("image", "stage", "total_it", "dataset"):
        assert tm[k] == jm[k], k
    assert tm["image"] == "" and tm["total_it"] == th[-1]["total_it"]
    assert all(f.endswith(".pth") for f in tm["nets"].values())
    saved = mgr.load_latest_general("face")
    for net in NETS:
        own = tt.model.nets[net].state_dict()
        assert saved[net].keys() == own.keys()
        for k, v in own.items():
            assert torch.equal(saved[net][k], v), (net, k)


def test_resume_loads_the_checkpoint_and_skips_the_prior(fitted):
    tt, tdir = fitted[2], fitted[4]
    rt = t_trainer.GeneralizingTrainer(
        dict(CFG, our_nets_ckpts={"VLADE_nets": str(tdir)}),
        load_dict={"category": "face"}, seed=5, device="cpu")
    for net in NETS:
        for (k, a), b in zip(rt.model.nets[net].state_dict().items(),
                             tt.model.nets[net].state_dict().values()):
            assert torch.equal(a, b), (net, k)
    calls = []
    rt.run_prior = lambda *a: calls.append(a) or []
    rng = np.random.default_rng(1)
    hist = rt.fit(_data(rng, 2), stages=[{"step1": 1, "step2": 0,
                                          "step3": 0}], batch_size=2)
    assert calls == [] and len(hist) == 2
    assert np.isfinite(hist[-1]["loss_step1"])


@pytest.mark.parametrize("mesh, cfg", [(make_mesh(), {}),
                                       (None, {"data_parallel": True})])
def test_data_parallel_is_refused(mesh, cfg):
    """No longer refused: without a process group, a `make_mesh()` record
    and `data_parallel: true` are one rank, whose run is the plain
    trainer's, bit for bit.  Over ranks: tests/test_torch_distributed.py."""
    stages = [{"step1": 1, "step2": 0, "step3": 0}]
    data = _data(np.random.default_rng(2), 2)
    runs = []
    for kw in ({"mesh": mesh, "cfg": cfg}, {"mesh": None, "cfg": {}}):
        tt = t_trainer.GeneralizingTrainer(dict(CFG, n_epochs_prior=1,
                                                **kw["cfg"]),
                                           mesh=kw["mesh"], device="cpu")
        runs.append((tt, tt.fit(data, stages=stages, batch_size=2)))
    (dp, got), (plain, want) = runs
    assert dp.mesh.size == 1 and not dp.grouped and plain.mesh is None
    np.testing.assert_equal(got, want)  # NaN: no step-2/3 iteration
    for k, v in plain.model.nets.state_dict().items():
        assert torch.equal(dp.model.nets.state_dict()[k], v), k


# ---------------- pseudo_pool_every ----------------

N_ITERS = 5


def _jax_draws(k, n_iters):
    """Iterations at which the JAX step-2 scan draws a pool, from a stub
    model: a jax.debug.callback records each drawn key, matched to the
    per-iteration keys of the block."""
    drawn = []

    def sample(key, collected, n):
        jax.debug.callback(lambda kk: drawn.append(np.asarray(kk)), key)
        return jax.random.uniform(key, (n, 3, 4, 4)), jnp.ones((n, 1, 4, 4))

    def loss(params, frozen, latent, pseudo_im, mask, inv):
        w = params["offset_encoder"]["w"]
        return jnp.sum(w * jnp.mean(pseudo_im)), (pseudo_im, mask)

    jt = j_trainer.Trainer.__new__(j_trainer.Trainer)
    jt.model = SimpleNamespace(step2_invariants=lambda frozen, latent: {},
                               step2_sample=sample, step2_loss=loss)
    jt.config = {"pseudo_pool_every": k}
    jt.optimizers = {s: j_trainer.default_optimizer() for s in (1, 2, 3)}
    jt._build_jitted_steps()
    sub = {"offset_encoder": {"w": jnp.ones(3)}}
    key = jax.random.PRNGKey(3)
    jt._run_step2(sub, jt.optimizers[2].init(sub), {}, None, None, None, key,
                  n_iters=n_iters, n_proj=2)
    jax.effects_barrier()
    keys = np.asarray(jax.random.split(key, max(n_iters, 1)))
    return sorted({i for d in drawn for i in range(len(keys))
                   if np.array_equal(d, keys[i])}), len(drawn)


def _port_draws(k, n_iters):
    tt = t_trainer.Trainer(dict(CFG, pseudo_pool_every=k), device="cpu")
    events = []
    w = torch.nn.Parameter(torch.ones(3))
    tt.optimizers[2] = t_trainer.default_optimizer([w])

    def sample(g, collected, n):
        events.append(len([e for e in events if e == "L"]))
        return torch.rand(n, 3, 4, 4, generator=g), torch.ones(n, 1, 4, 4)

    def loss(latent, pseudo_im, mask, inv):
        events.append("L")
        return torch.sum(w * pseudo_im.mean()), (pseudo_im, mask)

    tt.model.step2_invariants = lambda latent: {}
    tt.model.step2_sample = sample
    tt.model.step2_loss = loss
    tt.run_step2(None, None, None, n_iters)
    draws = [e for e in events if e != "L"]
    return sorted(set(draws)), len(draws)


@pytest.mark.parametrize("k, want", [(1, [0, 1, 2, 3, 4]), (2, [0, 2, 4]),
                                     (3, [0, 3])])
def test_pool_every_draws_where_jax_does(k, want):
    """K draws a pool at iterations i with i % K == 0, as JAX's lax.cond
    does (JAX also draws the iteration-0 pool once before its scan, with
    the same key)."""
    j_iters, _ = _jax_draws(k, N_ITERS)
    t_iters, t_count = _port_draws(k, N_ITERS)
    assert t_iters == j_iters == want
    assert t_count == len(want)


def test_zero_length_step2_draws_one_pool():
    assert _jax_draws(2, 0) == ([0], 1)
    assert _port_draws(2, 0) == ([0], 1)


# ---------------- shuffle and intermediate plots ----------------

NO_STEPS = [{"step1": 0, "step2": 0, "step3": 0}]


@pytest.mark.parametrize("cls, key", [(t_trainer.Trainer, "image"),
                                      (t_trainer.GeneralizingTrainer,
                                       "image_num")])
def test_shuffle_follows_the_trainers_own_generator(cls, key):
    """shuffle=True visits the images in the order of torch.randperm on
    the trainer's host generator (seed + 2), not JAX's PRNG stream."""
    data = _data(np.random.default_rng(2), 5)
    trainer = cls(dict(CFG, n_epochs_prior=0), seed=3, device="cpu")
    kw = {} if cls is t_trainer.Trainer else {"batch_size": 5}
    history = trainer.fit(data, stages=NO_STEPS, shuffle=True, **kw)
    want = torch.randperm(5, generator=torch.Generator().manual_seed(5))
    assert [h[key] for h in history] == want.tolist() != list(range(5))


def test_intermediate_plot_failures_are_logged_not_raised(monkeypatch,
                                                          caplog):
    from gan2shape_torch.utils import plotting

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(plotting, "plot_reconstructions", broken)
    trainer = t_trainer.Trainer(dict(CFG, n_epochs_prior=0),
                                plot_intermediate=True, device="cpu")
    history = trainer.fit(_data(np.random.default_rng(2), 2),
                          stages=NO_STEPS)
    assert len(history) == 2
    assert caplog.text.count("intermediate plot failed: disk full") == 2
