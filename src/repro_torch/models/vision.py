"""The paper's own models: LeNet5 (CIFAR-10) and ResNet18 + GroupNorm
(CIFAR-100 / TinyImageNet); counterpart of repro/models/vision.py.

Public functions take the reference's layouts — NHWC images, HWIO conv
weights — so the port and the reference compare like with like and a
parameter tree carries across unchanged (repro_torch.bridge). Inside,
``F.conv2d`` gets permuted views: NHWC -> NCHW is the channels_last
layout, and HWIO -> OIHW is a view too; nothing is copied for the
permutes.

Padding follows XLA's "SAME": total = max((ceil(n/s) - 1)·s + k - n, 0),
low = total // 2, high = the rest. At stride 2 on an even size that is
(0, 1), not PyTorch's symmetric (1, 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import jax_prng
from repro_torch.models.layers import group_norm, init_group_norm


@dataclass(frozen=True)
class VisionConfig:
    name: str
    family: str                 # lenet5 | resnet18
    image_size: int = 32
    channels: int = 3
    num_classes: int = 10
    width: int = 64             # resnet stem width
    groups: int = 8             # groupnorm groups


def _he_normal(key, shape, fan_in: int) -> torch.Tensor:
    """jax.random.normal(key, shape) * sqrt(2 / fan_in), in f32 as the
    reference multiplies it."""
    w = jax_prng.normal(key, shape) * np.float32(math.sqrt(2.0 / fan_in))
    return torch.from_numpy(w)


def _conv_init(key, kh, kw, cin, cout):
    return _he_normal(key, (kh, kw, cin, cout), kh * kw * cin)


def _same_pads(size: int, k: int, stride: int):
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding: str = "SAME") -> torch.Tensor:
    """x (B, C, H, W) NCHW view, w (kh, kw, cin, cout) HWIO."""
    wt = w.permute(3, 2, 0, 1)
    if padding == "SAME":
        top, bottom = _same_pads(x.shape[-2], w.shape[0], stride)
        left, right = _same_pads(x.shape[-1], w.shape[1], stride)
        if (top, left) == (bottom, right):
            return F.conv2d(x, wt, stride=stride, padding=(top, left))
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, wt, stride=stride)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


# ---------------- LeNet5 ----------------

def init_lenet5(cfg: VisionConfig, key):
    ks = jax_prng.split(key, 5)
    flat = ((cfg.image_size // 4 - 3) ** 2) * 16    # 32 -> 5*5*16 = 400
    return {
        "c1": _conv_init(ks[0], 5, 5, cfg.channels, 6),
        "c2": _conv_init(ks[1], 5, 5, 6, 16),
        "f1": {"w": _he_normal(ks[2], (flat, 120), flat),
               "b": torch.zeros(120)},
        "f2": {"w": _he_normal(ks[3], (120, 84), 120),
               "b": torch.zeros(84)},
        "f3": {"w": _he_normal(ks[4], (84, cfg.num_classes), 84),
               "b": torch.zeros(cfg.num_classes)},
    }


def lenet5_forward(cfg: VisionConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, classes)."""
    h = F.relu(_conv(_nchw(x), p["c1"], padding="VALID"))
    h = F.max_pool2d(h, 2, 2)
    h = F.relu(_conv(h, p["c2"], padding="VALID"))
    h = F.max_pool2d(h, 2, 2)
    # flatten in (H, W, C) order, as the reference flattens NHWC
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ p["f1"]["w"] + p["f1"]["b"])
    h = F.relu(h @ p["f2"]["w"] + p["f2"]["b"])
    return h @ p["f3"]["w"] + p["f3"]["b"]


# ---------------- ResNet18 + GroupNorm ----------------

_WIDTHS = (1, 1, 2, 2, 4, 4, 8, 8)
_STRIDES = (1, 1, 2, 1, 2, 1, 2, 1)


def _init_block(key, cin, cout, stride, groups):
    ks = jax_prng.split(key, 3)
    p = {
        "conv1": _conv_init(ks[0], 3, 3, cin, cout),
        "gn1": init_group_norm(groups, cout),
        "conv2": _conv_init(ks[1], 3, 3, cout, cout),
        "gn2": init_group_norm(groups, cout),
    }
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(ks[2], 1, 1, cin, cout)
        p["gn_proj"] = init_group_norm(groups, cout)
    return p


def _block(p, x, stride, groups):
    h = _conv(x, p["conv1"], stride)
    h = F.relu(group_norm(p["gn1"], h, groups))
    h = _conv(h, p["conv2"], 1)
    h = group_norm(p["gn2"], h, groups)
    if "proj" in p:
        x = group_norm(p["gn_proj"], _conv(x, p["proj"], stride), groups)
    return F.relu(h + x)


def init_resnet18(cfg: VisionConfig, key):
    w = cfg.width
    ks = jax_prng.split(key, 10)
    blocks = []
    cin = w
    for i, (mult, stride) in enumerate(zip(_WIDTHS, _STRIDES)):
        blocks.append(_init_block(ks[1 + i], cin, mult * w, stride,
                                  cfg.groups))
        cin = mult * w
    return {
        "stem": _conv_init(ks[0], 3, 3, cfg.channels, w),
        "gn_stem": init_group_norm(cfg.groups, w),
        "blocks": blocks,
        "head": {"w": _he_normal(ks[9], (8 * w, cfg.num_classes), 8 * w),
                 "b": torch.zeros(cfg.num_classes)},
    }


def resnet18_forward(cfg: VisionConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, classes)."""
    h = F.relu(group_norm(p["gn_stem"], _conv(_nchw(x), p["stem"], 1),
                          cfg.groups))
    for bp, s in zip(p["blocks"], _STRIDES):
        h = _block(bp, h, s, cfg.groups)
    h = h.mean(dim=(2, 3))
    return h @ p["head"]["w"] + p["head"]["b"]


# ---------------- unified ----------------

def init_vision(cfg: VisionConfig, key):
    """He-normal init from the reference's key tree: ``key`` is a
    ``core.jax_prng.PRNGKey``, split as ``repro/models/vision.py`` splits
    it, so the parameters are the reference's ``init_vision`` draws (f32
    CPU tensors; normals within a few ulp, see core/jax_prng.py)."""
    if cfg.family == "lenet5":
        return init_lenet5(cfg, key)
    return init_resnet18(cfg, key)


def vision_forward(cfg: VisionConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.family == "lenet5":
        return lenet5_forward(cfg, p, x)
    return resnet18_forward(cfg, p, x)


def vision_loss_fn(cfg: VisionConfig, p, batch) -> torch.Tensor:
    """batch: {images (B,H,W,C), labels (B,)} -> mean CE (paper §5.2.2)."""
    logits = vision_forward(cfg, p, batch["images"]).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[:, None])[:, 0]
    return (logz - gold).mean()


def vision_accuracy(cfg: VisionConfig, p, images, labels) -> torch.Tensor:
    pred = torch.argmax(vision_forward(cfg, p, images), dim=-1)
    return (pred == labels).float().mean()
