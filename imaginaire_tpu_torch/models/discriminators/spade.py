"""SPADE combined discriminator (port of
``imaginaire_tpu/models/discriminators/spade.py``).

FPSE plus ``num_discriminators`` patch discriminators over an
align-corners bilinear pyramid of concat(label, image). Outputs are
[fpse pred2, pred3, pred4, patch logits...]; features come from the patch
Ds only (the feature-matching loss). The real images go through first,
then the fake ones, so in the D step every spectral-norm ``u`` advances
once in each pass, in that order. Submodule names mirror the flax tree
(``patch_d_<i>``, ``fpse``).
"""

from __future__ import annotations

import torch
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.models.discriminators.fpse import FPSEDiscriminator
from imaginaire_tpu_torch.models.discriminators.multires_patch import (
    NLayerPatchDiscriminator,
    downsample2x_bilinear,
)
from imaginaire_tpu_torch.utils.data import (
    get_paired_input_image_channel_number,
    get_paired_input_label_channel_number,
)


class Discriminator(nn.Module):
    def __init__(self, dis_cfg, data_cfg):
        super().__init__()
        dis_cfg = as_attrdict(dis_cfg)
        data_cfg = as_attrdict(data_cfg)
        video = str(cfg_get(data_cfg, "type", "")).endswith("paired_videos")
        num_labels = get_paired_input_label_channel_number(data_cfg, video=video)
        image_channels = get_paired_input_image_channel_number(data_cfg)
        num_filters = cfg_get(dis_cfg, "num_filters", 128)
        weight_norm_type = cfg_get(dis_cfg, "weight_norm_type", "spectral")
        remat = cfg_get(dis_cfg, "remat", "none")
        self.num_discriminators = cfg_get(dis_cfg, "num_discriminators", 2)
        for i in range(self.num_discriminators):
            self.add_module(f"patch_d_{i}", NLayerPatchDiscriminator(
                num_labels + image_channels,
                kernel_size=cfg_get(dis_cfg, "kernel_size", 3),
                num_filters=num_filters,
                num_layers=cfg_get(dis_cfg, "num_layers", 5),
                max_num_filters=cfg_get(dis_cfg, "max_num_filters", 512),
                activation_norm_type=cfg_get(dis_cfg, "activation_norm_type", "none"),
                weight_norm_type=weight_norm_type, remat=remat))
        self.fpse = FPSEDiscriminator(
            num_labels, image_channels=image_channels, num_filters=num_filters,
            kernel_size=cfg_get(dis_cfg, "fpse_kernel_size", 3),
            weight_norm_type=weight_norm_type,
            activation_norm_type=cfg_get(dis_cfg, "fpse_activation_norm_type", "none"),
            remat=remat)

    def _single_forward(self, label, image):
        outputs = list(self.fpse(image, label))
        features_list = []
        x = torch.cat([label, image], dim=1)
        for i in range(self.num_discriminators):
            logits, feats = getattr(self, f"patch_d_{i}")(x)
            outputs.append(logits)
            features_list.append(feats)
            if i != self.num_discriminators - 1:
                x = downsample2x_bilinear(x)
        return outputs, features_list

    def forward(self, data, net_G_output):
        out = {}
        out["real_outputs"], out["real_features"] = self._single_forward(
            data["label"], data["images"])
        out["fake_outputs"], out["fake_features"] = self._single_forward(
            data["label"], net_G_output["fake_images"])
        return out
