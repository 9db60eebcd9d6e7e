"""The port's segmentation nets and masking model against the JAX
package's, on one seeded random port init (BatchNorm running statistics
randomised, as tests/test_segmentation.py does) converted by the JAX
package's own `convert_bisenet` / `convert_pspnet`: BiSeNet at 64², PSPNet-50
at 89², the masks of `MaskingModel` for face and car with both sides' net
sizes set to those, and a parsing checkpoint on disk driving the prior.

Measured on this init (logits up to 82 for BiSeNet, 2.8e3 for PSPNet,
whose residual stack grows the kaiming-normal activations): largest gaps
6.1e-5 and 3.1e-3, held to atol 1e-4 and 4e-3 (the JAX pair's own
tolerances are 2e-3 and 5e-3 with rtol 1e-3).  XLA's and oneDNN's
convolutions sum in different orders."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.convert.torch2jax import convert_bisenet, convert_pspnet
from gan2shape_tpu.core import masking as j_masking
from gan2shape_tpu.core import priors as j_priors

from gan2shape_torch.core import masking as t_masking
from gan2shape_torch.core.priors import FallbackMasker, PriorGenerator
from gan2shape_torch.models.segmentation import BiSeNet, PSPNet

# category: (port net, JAX converter, net size in these tests, logits atol)
NETS = {"face": (lambda: BiSeNet(n_classes=19), convert_bisenet, 64, 1e-4),
        "car": (lambda: PSPNet(classes=21), convert_pspnet, 89, 4e-3)}
IMAGE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads, as in test_torch_entry.py: six test processes
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_net(category, seed=0):
    g = torch.Generator().manual_seed(seed)
    net = NETS[category][0]().init_weights(g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.05 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.copy_(0.6 + 0.8 * torch.rand(
                    m.running_var.shape, generator=g))
    return net


@pytest.fixture(scope="module", params=["face", "car"])
def maskers(request):
    """(category, port state_dict, port MaskingModel, JAX MaskingModel),
    both at the test net size."""
    category = request.param
    sd = _random_net(category).state_dict()
    port = t_masking.MaskingModel(category, IMAGE, state_dict=sd,
                                  device="cpu")
    jax_m = j_masking.MaskingModel(category, IMAGE,
                                   params=NETS[category][1](sd))
    port.net_size = jax_m.net_size = NETS[category][2]
    return category, sd, port, jax_m


def _images(n, size, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32)


def test_logits_match_jax(maskers):
    category, _, port, jax_m = maskers
    x = _images(1, port.net_size, 1)
    with torch.no_grad():
        got = port.net(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_m._forward(jnp.asarray(x)))
    assert got.shape == want.shape == (1, 19 if category == "face" else 21,
                                       port.net_size, port.net_size)
    np.testing.assert_allclose(got, want, atol=NETS[category][3], rtol=0)
    # the logits are not trivially small
    assert np.abs(want).max() > 10


def test_confidence_mask_matches_jax(maskers):
    category, _, port, jax_m = maskers
    image = _images(1, IMAGE, 2)
    got = port.confidence_mask(image)
    want = np.asarray(jax_m.confidence_mask(image))
    assert got.shape == want.shape == (1, IMAGE, IMAGE)
    assert got.min() >= 0 and got.max() <= 1 and got.max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_depth", [False, True])
def test_image_mask_matches_jax(maskers, with_depth):
    """The hard mask (face: classes 1-13 but 16, with 17 dropped before the
    argmax; car: VOC class 7), and with a depth the depth NaN'd outside
    the mask at net resolution: NaN patterns equal, values within 1e-5."""
    category, _, port, jax_m = maskers
    image = _images(1, IMAGE, 3)
    depth = None
    if with_depth:
        depth = 0.9 + 0.2 * np.random.default_rng(4).uniform(
            size=(1, IMAGE, IMAGE)).astype(np.float32)
    got = port.image_mask(image, depth)
    want = np.asarray(jax_m.image_mask(image, depth))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               atol=1e-5, rtol=0)
    if not with_depth:  # area-resized from the net size: in [0, 1]
        assert got.min() >= 0 and got.max() <= 1 and got.mean() > 0


def test_released_layout_loads_with_a_module_prefix(maskers, tmp_path):
    """The released checkpoints are DataParallel saves: every key under
    `module.`, possibly inside {"state_dict": ...}.  They load bit-equal,
    and the port's dict has every key the JAX converter reads."""
    category, sd, port, _ = maskers
    ckpt = tmp_path / t_masking.checkpoint_path(category, ".")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    loaded = t_masking.make_masking_model(category, IMAGE, str(tmp_path),
                                          device="cpu")
    assert isinstance(loaded, t_masking.MaskingModel)
    got = loaded.net.state_dict()
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    assert not loaded.net.training
    loaded.net.train()
    assert not loaded.net.training  # frozen: never in train mode
    assert not any(p.requires_grad for p in loaded.net.parameters())


@pytest.mark.parametrize("category", ["face", "car"])
def test_missing_checkpoint_falls_back_and_a_broken_one_raises(tmp_path,
                                                               category):
    assert isinstance(t_masking.make_masking_model(category, 64,
                                                   str(tmp_path)),
                      FallbackMasker)
    ckpt = tmp_path / t_masking.checkpoint_path(category, ".")
    ckpt.write_bytes(b"")
    with pytest.raises(EOFError):
        t_masking.make_masking_model(category, 64, str(tmp_path),
                                     device="cpu")
    torch.save({"module.conv.weight": torch.zeros(1)}, ckpt)
    with pytest.raises(RuntimeError, match="state_dict"):
        t_masking.make_masking_model(category, 64, str(tmp_path),
                                     device="cpu")


@pytest.mark.parametrize("prior", ["smoothed_confidence", "masked_box"])
def test_parsing_checkpoint_drives_the_prior(tmp_path, monkeypatch, prior):
    """With checkpoints/parsing/bisenet.pth in the working directory, a
    PriorGenerator without a masker (the trainers' and cli.train's) uses
    the net, and gives the prior of the JAX PriorGenerator over the same
    converted weights; it differs from the fallback masker's."""
    from gan2shape_torch.core.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    (tmp_path / "checkpoints" / "parsing").mkdir(parents=True)
    sd = _random_net("face", seed=1).state_dict()
    torch.save(sd, tmp_path / "checkpoints" / "parsing" / "bisenet.pth")
    pg = PriorGenerator(IMAGE, "face", prior, device="cpu")
    assert isinstance(pg.masking_model, t_masking.MaskingModel)
    jm = j_masking.MaskingModel("face", IMAGE, params=convert_bisenet(sd))
    pg.masking_model.net_size = jm.net_size = 64
    jpg = j_priors.PriorGenerator(IMAGE, "face", prior, masking_model=jm)
    image = _images(1, IMAGE, 5)[0]
    got, want = pg(image), np.asarray(jpg(image))
    assert got.shape == want.shape == (1, IMAGE, IMAGE)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    fallback = PriorGenerator(IMAGE, "face", prior,
                              masking_model=FallbackMasker(IMAGE))(image)
    assert np.abs(got - fallback).max() > 1e-2
    trainer = Trainer({"image_size": 64, "gan_size": 32,
                       "channel_multiplier": 1, "prior_name": prior},
                      device="cpu")
    assert isinstance(trainer.prior_generator.masking_model,
                      t_masking.MaskingModel)
