"""Checkpoints of the five trainable nets: one torch state_dict `.pth` file
per net, named as the reference names them,

    {base}/{category}/{net}_image_{idx}_stage_{stage}_{it}_it_{time}.pth

plus a JSON manifest that lists them with the image, stage, iteration count
and save time.  Resume and evaluation select manifests by glob-style
`stage` / `iteration` / `time` selectors (default "*"); "latest" is by the
manifest's save time, ties broken by (stage, total_it), never by file name.

The JAX package writes the same manifests over flax msgpack files, which
the port cannot read: a manifest whose net files are `.msgpack` is refused
before any net is loaded.
"""

import datetime
import fnmatch
import json
import logging
import os
import re
from glob import glob

import torch

log = logging.getLogger(__name__)

NETS = ("lighting", "viewpoint", "depth", "albedo", "offset_encoder")

_STAMP_FMT = "%Y_%m_%d_%H_%M_%S"
# the stamp of manifests written without a "time" field (minute or second
# granularity)
_STAMP_RE = re.compile(r"_it_(\d{4}_\d{2}_\d{2}_\d{2}_\d{2}(?:_\d{2})?)\.json$")


def _order_key(m):
    return (m.get("time", ""), int(m.get("stage", 0)),
            int(m.get("total_it", 0)))


def _match(value, pattern):
    return fnmatch.fnmatch(str(value), str(pattern))


class CheckpointManager:
    def __init__(self, base_path):
        self.base = base_path

    def _path(self, category, net, img_idx, stage, total_it, stamp):
        return (f"{self.base}/{category}/{net}_image_{img_idx}_stage_"
                f"{stage}_{total_it}_it_{stamp}.pth")

    def save(self, nets, img_idx, stage, total_it, category):
        """Each net's state_dict (on the host) and the manifest.  A failure
        is logged and training goes on."""
        try:
            stamp = datetime.datetime.now().strftime(_STAMP_FMT)
            os.makedirs(f"{self.base}/{category}", exist_ok=True)
            manifest = {"total_it": int(total_it), "dataset": str(category),
                        "image": str(img_idx), "stage": int(stage),
                        "time": stamp, "nets": {}}
            for net in NETS:
                filename = self._path(category, net, img_idx, stage,
                                      total_it, stamp)
                torch.save({k: v.detach().cpu() for k, v in
                            nets[net].state_dict().items()}, filename)
                manifest["nets"][net] = filename
            mpath = (f"{self.base}/{category}/manifest_image_{img_idx}_stage_"
                     f"{stage}_{total_it}_it_{stamp}.json")
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1)
        except Exception as e:  # a failed save must not end training
            log.error("saving failed (%s)... continuing training", e)

    # ---------------- discovery ----------------

    def manifests(self, category):
        """All manifests of a category, oldest to newest by save time."""
        out = []
        for p in glob(f"{self.base}/{category}/manifest_*.json"):
            with open(p) as f:
                m = json.load(f)
            if "time" not in m:
                match = _STAMP_RE.search(p)
                m["time"] = match.group(1) if match else ""
            out.append(m)
        out.sort(key=_order_key)
        return out

    def select(self, category, img_idx="*", stage="*", iteration="*",
               time="*"):
        """Manifests matching the glob-style selectors, oldest to newest."""
        return [m for m in self.manifests(category)
                if _match(m["image"], img_idx)
                and _match(m["stage"], stage)
                and _match(m["total_it"], iteration)
                and _match(m["time"], time)]

    def load_manifest(self, manifest):
        """{net: state_dict} of a manifest, on the host."""
        foreign = [f for f in manifest["nets"].values()
                   if not f.endswith(".pth")]
        if foreign:
            raise ValueError(
                f"checkpoint {foreign[0]} is not a torch state_dict (.pth): "
                "the JAX package's flax msgpack checkpoints cannot be loaded "
                "by the port")
        return {net: torch.load(manifest["nets"][net], map_location="cpu",
                                weights_only=True) for net in NETS}

    def load_latest_general(self, category, stage="*", iteration="*",
                            time="*"):
        """The nets of the latest manifest matching the selectors."""
        ms = self.select(category, stage=stage, iteration=iteration,
                         time=time)
        if not ms:
            raise FileNotFoundError(
                f"no checkpoints under {self.base}/{category} matching "
                f"stage={stage} iteration={iteration} time={time}")
        log.info("resuming from %s", ms[-1]["nets"]["depth"])
        return self.load_manifest(ms[-1])

    def load_per_image(self, category, stage="*", iteration="*", time="*"):
        """Yield (image, {net: state_dict}) per distinct image, each the
        latest manifest matching the selectors."""
        by_image = {}
        for m in self.select(category, stage=stage, iteration=iteration,
                             time=time):
            by_image[m["image"]] = m  # oldest to newest: the latest wins
        for img, m in sorted(by_image.items(),
                             key=lambda kv: (len(kv[0]), kv[0])):
            yield img, self.load_manifest(m)


def load_nets(model, state_dicts):
    """Load {net: state_dict} into `model.nets`, on the model's device."""
    for net, sd in state_dicts.items():
        model.nets[net].load_state_dict(sd)
