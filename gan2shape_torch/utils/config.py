"""Config: DEFAULTS < minimal_config.yml < configs/{category}.yml (or an
explicit config file) < overrides, as the JAX package merges them."""

import os
from os import path

import yaml

DEFAULTS = {
    "n_workers": 0,
    "n_epochs_generalized": 100,
    "n_epochs_prior": 1000,
    "image_size": 128,
    "z_dim": 512,
    "learning_rate": 1e-4,
    "view_scale": 1,
    "batch_size": 32,
    "root_path": "data",
    "prior_name": "smoothed_confidence",
    "view_mvn_path": "checkpoints/view_light/view_mvn.pth",
    "light_mvn_path": "checkpoints/view_light/light_mvn.pth",
    "our_nets_ckpts": {"VLADE_nets": "checkpoints/our_nets", "other": "?"},
    "rot_center_depth": 1.0,
    "fov": 10,
    "tex_cube_size": 2,
}


def _read_yaml(filename):
    with open(filename) as f:
        return yaml.safe_load(f) or {}


def load_config(category=None, config_file=None, config_dir="configs",
                minimal_config="minimal_config.yml", overrides=None):
    """Merge DEFAULTS < minimal_config.yml < configs/{category}.yml (or an
    explicit config_file) < overrides (None values are not overrides)."""
    config = dict(DEFAULTS)
    if category is not None:
        if path.exists(minimal_config):
            config.update(_read_yaml(minimal_config))
        config.update(_read_yaml(path.join(config_dir, f"{category}.yml")))
        config["category"] = category
    elif config_file is not None:
        config.update(_read_yaml(config_file))
    if overrides:
        config.update({k: v for k, v in overrides.items() if v is not None})
    return config


def create_results_folder():
    os.makedirs("results/plots", exist_ok=True)
    os.makedirs("results/htmls", exist_ok=True)
