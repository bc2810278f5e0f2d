"""Encoder registry: embedding name -> (preprocess, apply_fn, params,
out_size) handle (counterpart of ``pvr_habitat_tpu/models/registry.py``).

Every name of the JAX package's zoo (``all_encoder_names``):
``true_state``, ``random``, the ResNet family (resnet18/34/50, places,
demy, moco, the l3/l4 grafts), the MoCo "uber" fusions of those, the MAE
ViTs, the CLIP towers and the Mask R-CNN C4 backbone.  Pretrained
checkpoints keep the reference's filenames and key surgery; a torch
checkpoint's state dict already is the port's flat dict (OIHW).  When a
file is absent the encoder falls back to a deterministic, name-seeded
random init with the JAX package's numpy stream, so both packages build
the same weights for the same name.
"""

import hashlib
import os
import pickle
import warnings
import zipfile
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.models import (clip, convert, maskrcnn,
                                          random_conv, resnet, vit)
from pvr_habitat_tpu_torch.models.convert import FLAT_FORMAT
from pvr_habitat_tpu_torch.ops import image as im
from pvr_habitat_tpu_torch.utils.platform import resolve_device


@dataclass
class EncoderHandle:
    name: str
    preprocess: Optional[im.Preprocess]
    apply_fn: Callable       # (params, x_normalized, train, fused) -> (N, O)
    params: dict
    out_size: int
    # The ``fused`` values apply_fn takes; the first kernel route listed
    # after "off" is the card's default (EmbeddingNet).
    fused_routes: tuple = ("off",)
    sub_names: tuple = ()    # uber constituents


# ---------------------------------------------------------------------------
# Checkpoint filename map (reference: src/embeddings.py:121-195)
# ---------------------------------------------------------------------------

CHECKPOINT_FILES = {
    "resnet50_places": "resnet50_places.pth.tar",
    "resnet50_l4": "resnet50_l4.pth.tar",
    "resnet50_l3": "resnet50_l3.tar",
    "resnet50_places_l4": "resnet50_places_l4.tar",
    "resnet50_places_l3": "resnet50_places_l3.tar",
    "demy": "demy.pth",
    "moco_aug": "moco_aug.pth.tar",
    "moco_aug_habitat": "moco_aug_habitat_64.pth",
    "moco_aug_mujoco": "moco_aug_mujoco.pth",
    "moco_aug_uber": "moco_aug_uber.pth",
    "moco_aug_places": "moco_aug_places.pth.tar",
    "moco_aug_l4": "moco_aug_l4.pth",
    "moco_aug_places_l4": "moco_aug_places_l4.pth",
    "moco_aug_l3": "moco_aug_l3.pth",
    "moco_aug_places_l3": "moco_aug_places_l3.pth",
    "moco_croponly": "moco_croponly.pth",
    "moco_croponly_places": "moco_croponly_places.pth",
    "moco_croponly_habitat": "moco_croponly_habitat_64.pth",
    "moco_croponly_mujoco": "moco_croponly_mujoco.pth",
    "moco_croponly_uber": "moco_croponly_uber.pth",
    "moco_croponly_l4": "moco_croponly_l4.pth",
    "moco_croponly_l3": "moco_croponly_l3.pth",
    "moco_croponly_places_l4": "moco_croponly_places_l4.pth",
    "moco_croponly_places_l3": "moco_croponly_places_l3.pth",
    "moco_coloronly": "moco_coloronly.pth",
    "maskrcnn_l3": "maskrcnn_l3.pth",
    "mae_base": "mae_pretrain_vit_base.pth",
    "mae_large": "mae_pretrain_vit_large.pth",
    "mae_huge": "mae_pretrain_vit_huge.pth",
    "resnet18": "resnet18_imagenet.pth",
    "resnet34": "resnet34_imagenet.pth",
    "resnet50": "resnet50_imagenet.pth",
    "clip_vit": "clip_vit_b32.pth",
    "clip_rn50": "clip_rn50.pth",
}


# Uber fusions: concatenated constituents (src/embeddings.py:195-280).
_UBER_SUFFIX = {"345": ("_l3", "_l4", ""), "35": ("_l3", ""),
                "34": ("_l3", "_l4"), "45": ("_l4", "")}


def uber_constituents(name):
    """'moco_aug_places_uber_345' -> ('moco_aug_places_l3', ...)."""
    base, code = name.rsplit("_uber_", 1)
    return tuple(base + suffix for suffix in _UBER_SUFFIX[code])


def all_uber_names():
    names = []
    for base in ("moco_aug", "moco_aug_places", "moco_croponly",
                 "moco_croponly_places"):
        for code in _UBER_SUFFIX:
            names.append(f"{base}_uber_{code}")
    return names


def _name_seed(name, run_id=0):
    digest = hashlib.sha256(f"{name}:{run_id}".encode()).digest()
    return int.from_bytes(digest[:4], "little")


def _is_flat_artifact(path):
    """True for a ``convert.save_flat`` payload of either package.

    ``EmbeddingNet.save`` persists '{data_path}/{name}.tar'.  For names
    whose pretrained CHECKPOINT_FILES entry is also '{name}.tar' that
    artifact shadows the expected torch checkpoint; it holds folded
    serving params, so it must not be loaded as one.  Skipping it falls
    back to the seeded random init, which is run_id-independent and so
    bit-identical to the weights the embed stage used."""
    try:
        with open(path, "rb") as handle:
            head = handle.read(256)
    except OSError:
        return False
    return FLAT_FORMAT.encode() in head


def _find_checkpoint(name, checkpoint_dir):
    filename = CHECKPOINT_FILES.get(name)
    if filename is None:
        return None
    for base in ([checkpoint_dir] if checkpoint_dir else []) + ["."]:
        path = os.path.join(base, filename)
        if os.path.isfile(path) and not _is_flat_artifact(path):
            return path
    return None


# Errors the load -> surgery -> key-check chain is EXPECTED to raise on a
# corrupt or foreign checkpoint file.  Anything else must propagate.
_EXPECTED_LOAD_ERRORS = (OSError, EOFError, KeyError, ValueError,
                         RuntimeError, pickle.UnpicklingError,
                         zipfile.BadZipFile)


def _load_or_init(name, pretrained, checkpoint_dir, load, init):
    """The encoder's params: ``load(checkpoint)`` when ``pretrained`` and
    the file is present, else ``init()`` (with a warning when a file was
    asked for)."""
    path = _find_checkpoint(name, checkpoint_dir) if pretrained else None
    if path is not None:
        # Fail fast by default: pretrained=True silently yielding random
        # features would invalidate results.  PVR_TPU_CKPT_FALLBACK=1 opts
        # into warn-and-continue, as in the JAX package.
        try:
            return load(convert.load_torch_checkpoint(path))
        except _EXPECTED_LOAD_ERRORS as exc:
            if os.environ.get("PVR_TPU_CKPT_FALLBACK") != "1":
                raise RuntimeError(
                    f"encoder '{name}': failed to load checkpoint "
                    f"{path} ({exc}); set PVR_TPU_CKPT_FALLBACK=1 to "
                    f"warn and fall back to the seeded random init "
                    f"instead") from exc
            warnings.warn(
                f"encoder '{name}': failed to load checkpoint {path} "
                f"({exc}); using the seeded random init instead")
    if pretrained:
        warnings.warn(
            f"encoder '{name}': checkpoint "
            f"{CHECKPOINT_FILES.get(name)} not found; using random init")
    return init()


def _resnet_family(name):
    """Returns (spec, surgery) or None."""
    plain = {"resnet18": 18, "resnet34": 34, "resnet50": 50}
    if name in plain:
        return resnet.ResNetSpec(plain[name]), convert.strip_module_prefix
    if name in ("resnet50_places", "demy"):
        surgery = (convert.strip_module_prefix if name == "resnet50_places"
                   else convert.moco_encoder_q)
        return resnet.ResNetSpec(50), surgery
    if name.startswith("resnet50") and name.endswith(("_l3", "_l4")):
        return (resnet.ResNetSpec(50, cut=name[-2:]),
                convert.strip_module_prefix)
    if name.startswith("moco_") and name.endswith(("_l3", "_l4")):
        return (resnet.ResNetSpec(50, cut=name[-2:]), convert.moco_encoder_q)
    if name.startswith("moco_"):
        return resnet.ResNetSpec(50), convert.moco_encoder_q
    return None


def _build_uber(name, subs):
    """The fusion of ``subs`` (the constituents' handles, in
    ``uber_constituents`` order): their params under ``models.{i}.``, their
    outputs concatenated.  ``fused`` goes to every constituent, so its
    routes are the ones all constituents share."""
    params = {}
    for i, handle in enumerate(subs):
        params.update(cm.add_prefix(handle.params, f"models.{i}"))
    fns = tuple(h.apply_fn for h in subs)
    routes = tuple(r for r in subs[0].fused_routes
                   if all(r in h.fused_routes for h in subs))

    def uber_apply(p, x, train=False, fused="off"):
        return torch.cat([fn(cm.sub(p, f"models.{i}"), x, train=train,
                             fused=fused) for i, fn in enumerate(fns)],
                         dim=-1)

    return EncoderHandle(name, im.default_preprocess(), uber_apply, params,
                         sum(h.out_size for h in subs), routes,
                         sub_names=tuple(h.name for h in subs))


def build_encoder(name, *, pretrained=True, checkpoint_dir=None, run_id=0,
                  device=None):
    """Construct an EncoderHandle for any zoo name."""
    dev = resolve_device(device)

    if name == "true_state":
        return EncoderHandle(name, None, lambda p, x, train=False: x, {}, 12)

    if name == "random":
        params = random_conv.init_params(
            np.random.RandomState(_name_seed(name, run_id)), dev)
        pre = im.default_preprocess()
        return EncoderHandle(
            name, pre, random_conv.apply, params,
            random_conv.out_size(pre.crop_size))

    if "_uber_" in name:
        return _build_uber(name, [
            build_encoder(s, pretrained=pretrained,
                          checkpoint_dir=checkpoint_dir, run_id=run_id,
                          device=dev)
            for s in uber_constituents(name)])

    if name in vit.MAE_CONFIGS:
        return vit.build_mae_encoder(name, pretrained=pretrained,
                                     checkpoint_dir=checkpoint_dir,
                                     device=dev)

    if name.startswith("clip_"):
        return clip.build_clip_encoder(name, pretrained=pretrained,
                                       checkpoint_dir=checkpoint_dir,
                                       device=dev)

    if name == "maskrcnn_l3":
        return maskrcnn.build_maskrcnn_encoder(
            pretrained=pretrained, checkpoint_dir=checkpoint_dir,
            device=dev)

    fam = _resnet_family(name)
    if fam is None:
        raise NotImplementedError(f"Requested model not available: {name}")
    spec, surgery = fam
    pre = im.default_preprocess()

    def load(ckpt):
        state_dict = surgery(ckpt.get("state_dict", ckpt))
        expected = set(spec.param_names())
        params = {k: v.detach().float().to(dev)
                  for k, v in state_dict.items() if k in expected}
        convert.check_expected(params, expected, context=name)
        return params

    params = _load_or_init(
        name, pretrained, checkpoint_dir, load,
        lambda: resnet.init_params(spec, np.random.RandomState(
            _name_seed(name)), dev))

    def rn_apply(p, x, train=False, fused="off", _spec=spec):
        if fused == "off":
            return resnet.apply(p, x, _spec, train=train)
        return resnet.FUSED_APPLY[fused](p, x, _spec)

    return EncoderHandle(name, pre, rn_apply, params,
                         spec.out_size(pre.crop_size),
                         resnet.fused_routes(spec))


def all_encoder_names():
    """The full zoo (reference registry, src/embeddings.py:90-321)."""
    moco_bases = [
        "moco_aug", "moco_aug_habitat", "moco_aug_mujoco", "moco_aug_uber",
        "moco_aug_places", "moco_croponly", "moco_croponly_places",
        "moco_croponly_habitat", "moco_croponly_mujoco",
        "moco_croponly_uber", "moco_coloronly",
    ]
    moco_cuts = [
        "moco_aug_l4", "moco_aug_l3", "moco_aug_places_l4",
        "moco_aug_places_l3", "moco_croponly_l4", "moco_croponly_l3",
        "moco_croponly_places_l4", "moco_croponly_places_l3",
    ]
    return (
        ["random", "resnet18", "resnet34", "resnet50", "resnet50_places",
         "resnet50_l4", "resnet50_l3", "resnet50_places_l4",
         "resnet50_places_l3", "demy"]
        + moco_bases + moco_cuts + all_uber_names()
        + ["maskrcnn_l3", "clip_vit", "clip_rn50",
           "mae_base", "mae_large", "mae_huge", "true_state"]
    )
