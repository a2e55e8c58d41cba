"""Multi-resolution PatchGAN discriminator (port of
``imaginaire_tpu/models/discriminators/multires_patch.py``): the N-layer
patch discriminator, the pyramid's 2x downsampling (one discriminator a
scale, or one shared by every scale), and the config-driven
``Discriminator`` (pix2pixHD's) over concat(label, image).

The pyramid is bilinear with ALIGN-CORNERS sampling, the reference's
convention (output pixel i samples input position i (n_in - 1) /
(n_out - 1)), not ``jax.image.resize``'s half-pixel one. NCHW.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import Conv2dBlock
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy
from imaginaire_tpu_torch.utils.data import (
    get_paired_input_image_channel_number,
    get_paired_input_label_channel_number,
)


def _axis(n_in, n_out, dtype, device):
    if n_out > 1:
        pos = torch.arange(n_out, dtype=torch.float32) * ((n_in - 1) / (n_out - 1))
    else:
        pos = torch.zeros(1)
    i0 = torch.floor(pos).long()
    i1 = torch.clamp_max(i0 + 1, n_in - 1)
    frac = (pos - i0).to(dtype)
    return i0.to(device), i1.to(device), frac.to(device)


def resize_bilinear_align_corners(x, out_h, out_w):
    """Bilinear resize of an NCHW tensor with align-corners sampling,
    rows then columns, as the JAX package computes it."""
    _, _, h, w = x.shape
    i0, i1, fh = _axis(h, out_h, x.dtype, x.device)
    fh = fh.view(1, 1, -1, 1)
    x = x[:, :, i0] * (1 - fh) + x[:, :, i1] * fh
    j0, j1, fw = _axis(w, out_w, x.dtype, x.device)
    fw = fw.view(1, 1, 1, -1)
    return x[:, :, :, j0] * (1 - fw) + x[:, :, :, j1] * fw


def downsample2x_bilinear(x):
    """Half resolution, align-corners bilinear (the patch D pyramid)."""
    h, w = x.shape[-2:]
    return resize_bilinear_align_corners(x, h // 2, w // 2)


class NLayerPatchDiscriminator(nn.Module):
    """Stride-2 CNA convs and a 1-channel patch head; returns (logits,
    features), the features being every conv block's output but the
    head's. ``remat`` checkpoints the conv blocks (not the head)."""

    def __init__(self, in_channels, kernel_size=3, num_filters=64,
                 num_layers=4, max_num_filters=512, activation_norm_type="",
                 weight_norm_type="", remat="none"):
        super().__init__()
        pad = int(math.floor((kernel_size - 1.0) / 2))
        self.num_layers = num_layers
        self.remat = resolve_policy(remat, where="dis.remat")

        def block(cin, cout, stride):
            return Conv2dBlock(cin, cout, kernel_size=kernel_size,
                               stride=stride, padding=pad,
                               weight_norm_type=weight_norm_type,
                               activation_norm_type=activation_norm_type,
                               nonlinearity="leakyrelu", order="CNA")

        nf = num_filters
        self.layer0 = block(in_channels, nf, 2)
        for n in range(num_layers):
            nf_prev, nf = nf, min(nf * 2, max_num_filters)
            stride = 2 if n < (num_layers - 1) else 1
            self.add_module(f"layer{n + 1}", block(nf_prev, nf, stride))
        self.add_module(f"layer{num_layers + 1}", Conv2dBlock(
            nf, 1, kernel_size=3, stride=1, padding=pad,
            weight_norm_type=weight_norm_type))

    def forward(self, x):
        features = []
        for n in range(self.num_layers + 1):
            x = call_block(getattr(self, f"layer{n}"), self.remat, x)
            features.append(x)
        logits = getattr(self, f"layer{self.num_layers + 1}")(x)
        return logits, features


class MultiResPatchDiscriminator(nn.Module):
    """One ``NLayerPatchDiscriminator`` a pyramid scale (``d_<i>``, as
    the flax tree names them), or with ``weight_shared`` one
    (``d_shared``) applied at every scale, each scale the align-corners
    bilinear half of the one before. Returns (logits a scale, features a
    scale)."""

    def __init__(self, in_channels, num_discriminators=3, kernel_size=3,
                 num_filters=64, num_layers=4, max_num_filters=512,
                 activation_norm_type="", weight_norm_type="", weight_shared=False,
                 remat="none"):
        super().__init__()
        self.num_discriminators = num_discriminators
        self.weight_shared = weight_shared
        for i in range(1 if weight_shared else num_discriminators):
            self.add_module("d_shared" if weight_shared else f"d_{i}",
                            NLayerPatchDiscriminator(
                                in_channels, kernel_size=kernel_size,
                                num_filters=num_filters, num_layers=num_layers,
                                max_num_filters=max_num_filters,
                                activation_norm_type=activation_norm_type,
                                weight_norm_type=weight_norm_type, remat=remat))

    def forward(self, x):
        outputs, features_list = [], []
        for i in range(self.num_discriminators):
            d = self.d_shared if self.weight_shared else getattr(self, f"d_{i}")
            logits, feats = d(x)
            outputs.append(logits)
            features_list.append(feats)
            if i != self.num_discriminators - 1:
                x = downsample2x_bilinear(x)
        return outputs, features_list


class Discriminator(nn.Module):
    """Config-driven wrapper: ``MultiResPatchDiscriminator`` (``model``,
    as the flax tree names it) over concat(label, image), with the JAX
    defaults (kernel 3, 128 filters, 5 layers, no activation norm,
    spectral weight norm). The fake images go through first, then the
    real ones, so each spectral-norm ``u`` advances in that order."""

    def __init__(self, dis_cfg, data_cfg):
        super().__init__()
        dis_cfg = as_attrdict(dis_cfg)
        data_cfg = as_attrdict(data_cfg)
        in_channels = (get_paired_input_label_channel_number(data_cfg)
                       + get_paired_input_image_channel_number(data_cfg))
        self.model = MultiResPatchDiscriminator(
            in_channels,
            num_discriminators=cfg_get(dis_cfg, "num_discriminators", 2),
            kernel_size=cfg_get(dis_cfg, "kernel_size", 3),
            num_filters=cfg_get(dis_cfg, "num_filters", 128),
            num_layers=cfg_get(dis_cfg, "num_layers", 5),
            max_num_filters=cfg_get(dis_cfg, "max_num_filters", 512),
            activation_norm_type=cfg_get(dis_cfg, "activation_norm_type", "none"),
            weight_norm_type=cfg_get(dis_cfg, "weight_norm_type", "spectral"),
            remat=cfg_get(dis_cfg, "remat", "none"))

    def forward(self, data, net_G_output):
        out = {}
        out["fake_outputs"], out["fake_features"] = self.model(
            torch.cat([data["label"], net_G_output["fake_images"]], dim=1))
        out["real_outputs"], out["real_features"] = self.model(
            torch.cat([data["label"], data["images"]], dim=1))
        return out
