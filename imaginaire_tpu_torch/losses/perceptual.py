"""Perceptual loss with a VGG19 feature extractor (port of
``imaginaire_tpu/losses/perceptual.py:351-452``, VGG19 only).

The weighted L1 distance between named relu activations of the fake and
the real images, imagenet-normalized. The images are rounded to
``compute_dtype`` (bf16 by default, whatever the trainer's policy, as in
the JAX package, whose SPADE trainer never passes it) before the
extractor; the extractor's convolutions then run in the type of their
parameters, which the trainer never casts (fp32), as flax promotes a
bf16 input against fp32 kernels. The target's features carry no
gradient.

Weights come from a local ``.npz`` of torchvision's VGG19 ``features``
state dict (``features.<i>.weight`` OIHW, ``features.<i>.bias``: the
format ``load_torch_vgg_weights`` reads), or, with
``allow_random_init``, from a seeded random draw. Otherwise
``init_params`` raises ``FileNotFoundError``: nothing is downloaded.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.utils.misc import apply_imagenet_normalization

# torchvision `features` config: numbers are conv widths, 'M' a 2x maxpool
_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def _vgg_relu_names(cfg):
    """Each conv's relu named 'relu_<block>_<idx>'."""
    names, block, idx = [], 1, 1
    for v in cfg:
        if v == "M":
            block, idx = block + 1, 1
        else:
            names.append(f"relu_{block}_{idx}")
            idx += 1
    return names


class VGGFeatures(nn.Module):
    """The VGG19 stack up to the deepest captured relu, NCHW; submodules
    ``conv_<k>`` as the JAX module names them."""

    def __init__(self, capture, cfg=_VGG19_CFG):
        super().__init__()
        names = _vgg_relu_names(cfg)
        unknown = [n for n in capture if n not in names]
        if unknown:
            raise ValueError(f"unknown VGG19 layers {unknown}")
        self.capture = tuple(capture)
        self.names = names
        deepest = max(names.index(n) for n in capture)
        self.plan = []  # ("M",) or ("C", k)
        cin, k = 3, 0
        for v in cfg:
            if v == "M":
                self.plan.append(("M",))
                continue
            self.add_module(f"conv_{k}", nn.Conv2d(cin, v, 3, padding=1))
            self.plan.append(("C", k))
            cin = v
            if k >= deepest:
                break
            k += 1

    def forward(self, x):
        out = {}
        for step in self.plan:
            if step[0] == "M":
                x = F.max_pool2d(x, 2)
                continue
            conv = getattr(self, f"conv_{step[1]}")
            dt = torch.promote_types(x.dtype, conv.weight.dtype)
            x = F.relu(F.conv2d(x.to(dt), conv.weight.to(dt),
                                conv.bias.to(dt), padding=1))
            name = self.names[step[1]]
            if name in self.capture:
                out[name] = x
        return out


def load_torch_vgg_weights(npz_path, module):
    """Copy torchvision's VGG19 ``features`` state dict (npz) into
    ``module``'s ``conv_<k>`` layers."""
    raw = np.load(npz_path)
    conv_k, torch_i = 0, 0
    with torch.no_grad():
        for v in _VGG19_CFG:
            if v == "M":
                torch_i += 1  # MaxPool2d occupies one Sequential slot
                continue
            conv = getattr(module, f"conv_{conv_k}", None)
            if conv is None:
                break
            conv.weight.copy_(torch.from_numpy(raw[f"features.{torch_i}.weight"]))
            conv.bias.copy_(torch.from_numpy(raw[f"features.{torch_i}.bias"]))
            conv_k += 1
            torch_i += 2  # conv + relu
    return module


class PerceptualLoss:
    """Weighted multi-layer L1 feature distance over VGG19, at one scale
    (the JAX loss's defaults; its criterion, resize, scale and
    instance-norm options are not ported)."""

    def __init__(self, network="vgg19", layers="relu_4_1", weights=None,
                 compute_dtype=torch.bfloat16, weights_path=None,
                 allow_random_init=False, device=None):
        if isinstance(layers, str):
            layers = [layers]
        if weights is None:
            weights = [1.0] * len(layers)
        elif isinstance(weights, (int, float)):
            weights = [weights]
        if len(layers) != len(weights):
            raise ValueError(
                f"The number of layers ({len(layers)}) must equal the number "
                f"of weights ({len(weights)}).")
        if network != "vgg19":
            raise NotImplementedError(f"perceptual network {network!r} is not "
                                      f"in the port yet (ROADMAP.md); it has vgg19")
        self.layers, self.weights = list(layers), list(weights)
        self.compute_dtype = compute_dtype
        self.allow_random_init = allow_random_init
        if weights_path is None:
            weights_path = (Path(__file__).resolve().parents[2] / "weights"
                            / "vgg19_features.npz")
        self.weights_path = Path(weights_path)
        with torch.device(device or "cpu"):
            self.module = VGGFeatures(self.layers)
        self.module.eval().requires_grad_(False)

    def init_params(self, generator=None):
        """Load the weights from ``weights_path``, else draw them (only
        with ``allow_random_init``), else raise."""
        if self.weights_path.exists():
            return load_torch_vgg_weights(self.weights_path, self.module)
        if not self.allow_random_init:
            raise FileNotFoundError(
                f"Pretrained vgg19 weights not found at {self.weights_path}. "
                "Convert torchvision's VGG19 features to an .npz "
                "(scripts/convert_weights.py) or set "
                "trainer.perceptual_loss.allow_random_init (tests only — "
                "training quality will not match the reference).")
        with torch.no_grad():
            for conv in self.module.children():
                fan_in = conv.weight[0].numel()
                conv.weight.copy_(torch.randn(
                    conv.weight.shape, generator=generator,
                    device=conv.weight.device) / math.sqrt(fan_in))
                conv.bias.zero_()
        return self.module

    def __call__(self, inp, target):
        inp = apply_imagenet_normalization(inp)
        with torch.no_grad():
            target = apply_imagenet_normalization(target)
            tg_feats = self.module(target.to(self.compute_dtype))
        in_feats = self.module(inp.to(self.compute_dtype))
        loss = torch.zeros((), device=inp.device)
        for layer, weight in zip(self.layers, self.weights):
            diff = in_feats[layer].float() - tg_feats[layer].float()
            loss = loss + weight * diff.abs().mean()
        return loss
