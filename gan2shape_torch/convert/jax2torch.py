"""JAX parameter pytrees (as numpy arrays) -> the port's torch state_dicts.

The inverse of gan2shape_tpu/convert/torch2jax.py: the JAX package names
its flax parameters after the reference's torch modules, and the port's
modules keep the reference's state_dict names, so each function here undoes
one `convert_*` there.  Inputs are the nested dicts of `GAN2Shape.init_params`
/ `init_frozen` (with or without the top-level "params" key), leaves anything
`np.asarray` accepts.  Nothing here imports JAX.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _params(tree):
    return tree["params"] if "params" in tree else tree


def generator_state_dict(gen_params, noise, n_mlp=8):
    """Generator params + noise list -> Generator state_dict."""
    p = _params(gen_params)
    sd = {"input.input": _t(p["input"])}
    for i in range(n_mlp):
        sd[f"style.{i + 1}.weight"] = _t(p[f"style_{i}"]["weight"])
        sd[f"style.{i + 1}.bias"] = _t(p[f"style_{i}"]["bias"])

    def styled_conv(prefix, q):
        sd[f"{prefix}.conv.weight"] = _t(q["conv"]["weight"])
        sd[f"{prefix}.conv.modulation.weight"] = _t(
            q["conv"]["modulation"]["weight"])
        sd[f"{prefix}.conv.modulation.bias"] = _t(
            q["conv"]["modulation"]["bias"])
        sd[f"{prefix}.noise.weight"] = _t(q["noise"]["weight"])
        sd[f"{prefix}.activate.bias"] = _t(q["act_bias"])

    def to_rgb(prefix, q):
        sd[f"{prefix}.conv.weight"] = _t(q["conv"]["weight"])
        sd[f"{prefix}.conv.modulation.weight"] = _t(
            q["conv"]["modulation"]["weight"])
        sd[f"{prefix}.conv.modulation.bias"] = _t(
            q["conv"]["modulation"]["bias"])
        sd[f"{prefix}.bias"] = _t(q["bias"])

    styled_conv("conv1", p["conv1"])
    to_rgb("to_rgb1", p["to_rgb1"])
    i = 0
    while f"convs_{i}" in p:
        styled_conv(f"convs.{i}", p[f"convs_{i}"])
        i += 1
    j = 0
    while f"to_rgbs_{j}" in p:
        to_rgb(f"to_rgbs.{j}", p[f"to_rgbs_{j}"])
        j += 1
    for k, n in enumerate(noise):
        sd[f"noises.noise_{k}"] = _t(n)
    return sd


def discriminator_state_dict(disc_params):
    p = _params(disc_params)
    sd = {"convs.0.0.weight": _t(p["convs_0"]["conv"]["weight"]),
          "convs.0.1.bias": _t(p["convs_0"]["act_bias"])}
    i = 1
    while f"convs_{i}" in p:
        q = p[f"convs_{i}"]
        sd[f"convs.{i}.conv1.0.weight"] = _t(q["conv1"]["conv"]["weight"])
        sd[f"convs.{i}.conv1.1.bias"] = _t(q["conv1"]["act_bias"])
        sd[f"convs.{i}.conv2.1.weight"] = _t(q["conv2"]["conv"]["weight"])
        sd[f"convs.{i}.conv2.2.bias"] = _t(q["conv2"]["act_bias"])
        sd[f"convs.{i}.skip.1.weight"] = _t(q["skip"]["conv"]["weight"])
        i += 1
    sd["final_conv.0.weight"] = _t(p["final_conv"]["conv"]["weight"])
    sd["final_conv.1.bias"] = _t(p["final_conv"]["act_bias"])
    for k in (0, 1):
        sd[f"final_linear.{k}.weight"] = _t(p[f"final_linear_{k}"]["weight"])
        sd[f"final_linear.{k}.bias"] = _t(p[f"final_linear_{k}"]["bias"])
    return sd


def encoder_net_state_dict(params):
    """ViewpointNet / LightingNet: conv0..conv{n-1}, conv5, conv6 in layer
    order at Sequential indices 0, 2, 4, ..."""
    p = _params(params)["encoder"]
    downs = sorted((k for k in p if k not in ("conv5", "conv6")),
                   key=lambda k: int(k[4:]))
    return {f"network.{2 * i}.weight": _t(p[name]["weight"])
            for i, name in enumerate(downs + ["conv5", "conv6"])}


_ED_CONVS = {0: "down0", 3: "down1", 6: "down2", 9: "down3",
             11: "bottleneck", 13: "up0", 15: "up0b", 17: "up1", 20: "up1b",
             23: "up2", 26: "up2b", 29: "up3", 32: "up3b", 36: "up4",
             39: "up5", 42: "head"}
_ED_GNS = {1: "down0_gn", 4: "down1_gn", 7: "down2_gn", 18: "up1_gn",
           21: "up1b_gn", 24: "up2_gn", 27: "up2b_gn", 30: "up3_gn",
           33: "up3b_gn", 37: "up4_gn", 40: "up5_gn"}


def encoder_decoder_state_dict(params):
    """DepthNet / AlbedoNet."""
    p = _params(params)["net"]
    sd = {f"network.{i}.weight": _t(p[n]["weight"])
          for i, n in _ED_CONVS.items()}
    for i, n in _ED_GNS.items():
        sd[f"network.{i}.weight"] = _t(p[n]["scale"])
        sd[f"network.{i}.bias"] = _t(p[n]["bias"])
    return sd


def offset_encoder_state_dict(params):
    p = _params(params)
    sd = {}

    def conv(prefix, q):
        sd[f"{prefix}.weight"] = _t(q["weight"])
        sd[f"{prefix}.bias"] = _t(q["bias"])

    conv("network.0", p["stem"])
    n_blocks = 4 if "block3" in p else 3
    for k in range(n_blocks):
        q = p[f"block{k}"]
        conv(f"network.{k + 2}.res_path.1", q["res0"])
        conv(f"network.{k + 2}.res_path.3", q["res1"])
        conv(f"network.{k + 2}.identity_path.1", q["idn"])
    conv(f"network.{n_blocks + 2}", p["penult"])
    conv(f"network.{n_blocks + 4}", p["head"])
    return sd


_VGG16_FEATURE_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_ALEX_FEATURE_IDX = (0, 3, 6, 8, 10)
# torchvision SqueezeNet 1.1 fire-module indices of JAX's fire2 .. fire9
_SQUEEZE_FIRE_IDX = (3, 4, 6, 7, 9, 10, 11, 12)


def _conv_wb(q):
    return _t(q["weight"]), _t(q["bias"])


def vgg16_state_dict(trunk):
    """VGG16Features params -> torchvision `features.*`."""
    sd = {}
    for i, idx in enumerate(_VGG16_FEATURE_IDX):
        sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"] = \
            _conv_wb(trunk[f"conv{i}"])
    return sd


def alexnet_state_dict(trunk):
    """AlexFeatures params -> torchvision `features.*`."""
    sd = {}
    for i, idx in enumerate(_ALEX_FEATURE_IDX):
        sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"] = \
            _conv_wb(trunk[f"conv{i}"])
    return sd


def squeezenet_state_dict(trunk):
    """SqueezeFeatures params -> torchvision SqueezeNet 1.1 `features.*`."""
    sd = {}
    sd["features.0.weight"], sd["features.0.bias"] = _conv_wb(trunk["conv0"])
    for fire, idx in enumerate(_SQUEEZE_FIRE_IDX, start=2):
        for ours, theirs in (("squeeze", "squeeze"),
                             ("expand1", "expand1x1"),
                             ("expand3", "expand3x3")):
            w, b = _conv_wb(trunk[f"fire{fire}_{ours}"])
            sd[f"features.{idx}.{theirs}.weight"] = w
            sd[f"features.{idx}.{theirs}.bias"] = b
    return sd


TRUNK_STATE_DICTS = {"vgg": vgg16_state_dict, "alex": alexnet_state_dict,
                     "squeeze": squeezenet_state_dict}


def lpips_state_dict(lpips_params):
    """LPIPS params of any backbone -> LPIPS state_dict
    (`{backbone}.features.*`, and `lin{k}` when the params hold heads)."""
    p = _params(lpips_params)
    backbone, = (b for b in TRUNK_STATE_DICTS if b in p)
    sd = {f"{backbone}.{k}": v
          for k, v in TRUNK_STATE_DICTS[backbone](p[backbone]).items()}
    k = 0
    while f"lin{k}" in p:
        sd[f"lin{k}.model.1.weight"] = _t(p[f"lin{k}"]["weight"])
        k += 1
    return sd


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def gan_state_dicts(state, noise=None):
    """A JAX `GANTrainState` (or a dict with its fields) -> the port's
    {"g", "d", "g_ema"} state_dicts.  The JAX state holds no noise maps:
    `noise` (a list per layer) fills the generators' noise buffers, zeros
    when None."""
    g_params = _params(_field(state, "g_params"))
    n_mlp = sum(k.startswith("style_") for k in g_params)
    if noise is None:
        n_convs = sum(k.startswith("convs_") for k in g_params)
        noise = [np.zeros((1, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2)),
                          np.float32) for i in range(n_convs + 1)]
    return {"g": generator_state_dict(g_params, noise, n_mlp),
            "d": discriminator_state_dict(_field(state, "d_params")),
            "g_ema": generator_state_dict(_field(state, "g_ema"), noise,
                                          n_mlp)}


NET_STATE_DICTS = {
    "viewpoint": encoder_net_state_dict,
    "lighting": encoder_net_state_dict,
    "depth": encoder_decoder_state_dict,
    "albedo": encoder_decoder_state_dict,
    "offset_encoder": offset_encoder_state_dict,
}


def load_into(model, params=None, frozen=None):
    """Load JAX `init_params` / `init_frozen` pytrees into a port
    GAN2Shape (either may be None)."""
    dev = model.device
    if params is not None:
        for name, fn in NET_STATE_DICTS.items():
            model.nets[name].load_state_dict(
                {k: v.to(dev) for k, v in fn(params[name]).items()})
    if frozen is not None:
        model.generator.load_state_dict(
            {k: v.to(dev) for k, v in generator_state_dict(
                frozen["generator"], frozen["noise"],
                model.generator.n_mlp).items()})
        model.discriminator.load_state_dict(
            {k: v.to(dev) for k, v in discriminator_state_dict(
                frozen["discriminator"]).items()})
        model.lpips.load_state_dict(
            {k: v.to(dev) for k, v in lpips_state_dict(
                frozen["lpips"]).items()})
        if "mean_latent" in frozen:
            model.mean_latent = _t(frozen["mean_latent"]).to(dev)
    return model
