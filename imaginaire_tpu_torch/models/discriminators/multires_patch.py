"""Multi-resolution PatchGAN pieces (port of
``imaginaire_tpu/models/discriminators/multires_patch.py``): the N-layer
patch discriminator and the pyramid's 2x downsampling.

The pyramid is bilinear with ALIGN-CORNERS sampling, the reference's
convention (output pixel i samples input position i (n_in - 1) /
(n_out - 1)), not ``jax.image.resize``'s half-pixel one. NCHW.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from imaginaire_tpu_torch.layers import Conv2dBlock
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy


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
