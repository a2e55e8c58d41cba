"""FUNIT projection discriminator (port of
``imaginaire_tpu/models/discriminators/funit.py``).

A conv7, then per level a pair of NACNAC residual blocks (leaky ReLU, no
norm, biases on both convs and the shortcut), the second widening to
``min(2 nf, max_num_filters)``, and between levels a reflect pad of one
pixel and a 3x3 average pool of stride 2; then a 1x1 classifier (leaky
ReLU, then the conv) to patch logits. With class labels the logits are
shifted by the projection ``<embed(label), pooled features>`` (the cGAN
projection), and the model returns (logits, the pooled features); without
labels, the pooled features alone. The class embedding is flax's
``Embed``, which the JAX package draws with its own default (``Embed``).
In the configs D carries spectral norm; its ``u`` advances in the D step
only (``trainers/base.py``). NCHW; submodule names follow the JAX
parameter tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import Conv2dBlock, Res2dBlock
from imaginaire_tpu_torch.layers.state import cast_param
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy


class Embed(nn.Module):
    """flax's ``Embed``: an ``embedding`` table (classes, features),
    drawn by flax's default (``variance_scaling(1, 'fan_in', 'normal')``:
    an untruncated normal of variance 1 / features), whatever the
    trainer's init."""

    def __init__(self, num_embeddings, features):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    @torch.no_grad()
    def draw_own_init(self, generator):
        w = self.embedding
        z = torch.randn(w.shape, generator=generator, device=w.device)
        w.copy_(z * w.shape[1] ** -0.5)

    def forward(self, labels):
        return cast_param(self, self.embedding)[labels.long()]


class FUNITResDiscriminator(nn.Module):
    def __init__(self, in_channels=3, num_classes=119, num_filters=64,
                 max_num_filters=1024, num_layers=6, padding_mode="reflect",
                 weight_norm_type="", remat="none"):
        super().__init__()
        common = dict(padding_mode=padding_mode, activation_norm_type="none",
                      weight_norm_type=weight_norm_type, bias=[True, True, True],
                      nonlinearity="leakyrelu", order="NACNAC")
        self.num_layers = num_layers
        self.remat = resolve_policy(remat, where="dis.remat")
        nf = num_filters
        self.conv_in = Conv2dBlock(in_channels, nf, 7, stride=1, padding=3,
                                   padding_mode=padding_mode,
                                   weight_norm_type=weight_norm_type)
        for i in range(num_layers):
            nf_next = min(nf * 2, max_num_filters)
            self.add_module(f"res_{i}_0", Res2dBlock(nf, nf, **common))
            self.add_module(f"res_{i}_1", Res2dBlock(nf, nf_next, **common))
            nf = nf_next
        self.classifier = Conv2dBlock(nf, 1, kernel_size=1, stride=1, padding=0,
                                      nonlinearity="leakyrelu",
                                      weight_norm_type=weight_norm_type, order="NACNAC")
        self.embedder = Embed(num_classes, nf)

    def forward(self, images, labels=None):
        x = self.conv_in(images)
        for i in range(self.num_layers):
            x = call_block(getattr(self, f"res_{i}_0"), self.remat, x)
            x = call_block(getattr(self, f"res_{i}_1"), self.remat, x)
            if i != self.num_layers - 1:
                x = F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, 2)
        outputs = self.classifier(x)
        features_1x1 = x.mean(dim=(2, 3))
        if labels is None:
            return features_1x1
        embeddings = self.embedder(labels).to(features_1x1.dtype)
        proj = (embeddings * features_1x1).sum(dim=1).view(-1, 1, 1, 1)
        return outputs + proj, features_1x1


class Discriminator(nn.Module):
    """``model``, applied to the translation and the real style image
    under the style labels, and with ``recon`` to the reconstruction
    under the content labels."""

    def __init__(self, dis_cfg, data_cfg=None):
        super().__init__()
        d = as_attrdict(dis_cfg)
        self.model = FUNITResDiscriminator(
            in_channels=cfg_get(d, "num_image_channels", 3),
            num_classes=cfg_get(d, "num_classes", 119),
            num_filters=cfg_get(d, "num_filters", 64),
            max_num_filters=cfg_get(d, "max_num_filters", 1024),
            num_layers=cfg_get(d, "num_layers", 6),
            padding_mode=cfg_get(d, "padding_mode", "reflect"),
            weight_norm_type=cfg_get(d, "weight_norm_type", ""),
            remat=cfg_get(d, "remat", "none"))

    def forward(self, data, net_G_output, recon=True):
        out = {}
        out["fake_out_trans"], out["fake_features_trans"] = self.model(
            net_G_output["images_trans"], data["labels_style"])
        out["real_out_style"], out["real_features_style"] = self.model(
            data["images_style"], data["labels_style"])
        if recon:
            out["fake_out_recon"], out["fake_features_recon"] = self.model(
                net_G_output["images_recon"], data["labels_content"])
        return out
