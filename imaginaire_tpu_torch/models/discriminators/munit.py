"""MUNIT discriminator (port of ``imaginaire_tpu/models/discriminators/munit.py``).

One discriminator a domain (``dis_a``, ``dis_b``, as the flax tree
names the JAX module's ``discriminator_a`` and ``discriminator_b``):
a multi-resolution patch discriminator (``patch_wise``, the default) or
a global residual one. ``forward`` runs the translations (``out_ab`` by
B's discriminator, ``out_ba`` by A's), then with ``real`` the real
images, then with ``gan_recon`` the within-domain reconstructions, and
returns each one's logits and features (``fea_*``), in the JAX order, so
each spectral-norm ``u`` advances as it does there. NCHW.
"""

from __future__ import annotations

from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.models.discriminators.multires_patch import (
    MultiResPatchDiscriminator,
)
from imaginaire_tpu_torch.models.discriminators.residual import ResDiscriminator


def _make_domain_dis(dis_cfg, patch_key, weight_shared, in_channels=3):
    dis_cfg = as_attrdict(dis_cfg)
    if cfg_get(dis_cfg, patch_key, True):
        return MultiResPatchDiscriminator(
            in_channels,
            num_discriminators=cfg_get(dis_cfg, "num_discriminators", 3),
            kernel_size=cfg_get(dis_cfg, "kernel_size", 3),
            num_filters=cfg_get(dis_cfg, "num_filters", 64),
            num_layers=cfg_get(dis_cfg, "num_layers", 4),
            max_num_filters=cfg_get(dis_cfg, "max_num_filters", 512),
            activation_norm_type=cfg_get(dis_cfg, "activation_norm_type", "none"),
            weight_norm_type=cfg_get(dis_cfg, "weight_norm_type", ""),
            weight_shared=weight_shared,
            remat=cfg_get(dis_cfg, "remat", "none"))
    return ResDiscriminator(
        in_channels,
        num_filters=cfg_get(dis_cfg, "num_filters", 64),
        max_num_filters=cfg_get(dis_cfg, "max_num_filters", 512),
        first_kernel_size=cfg_get(dis_cfg, "first_kernel_size", 1),
        num_layers=cfg_get(dis_cfg, "num_layers", 4),
        padding_mode=cfg_get(dis_cfg, "padding_mode", "zeros"),
        activation_norm_type=cfg_get(dis_cfg, "activation_norm_type", ""),
        weight_norm_type=cfg_get(dis_cfg, "weight_norm_type", ""),
        aggregation=cfg_get(dis_cfg, "aggregation", "conv"),
        order=cfg_get(dis_cfg, "order", "pre_act"),
        remat=cfg_get(dis_cfg, "remat", "none"))


class Discriminator(nn.Module):
    patch_key = "patch_wise"
    weight_shared = False

    def __init__(self, dis_cfg, data_cfg=None):
        super().__init__()
        self.dis_a = _make_domain_dis(dis_cfg, self.patch_key, self.weight_shared)
        self.dis_b = _make_domain_dis(dis_cfg, self.patch_key, self.weight_shared)

    def forward(self, data, net_G_output, real=True, gan_recon=False):
        d_a, d_b = self.dis_a, self.dis_b
        out = {}
        out["out_ab"], out["fea_ab"] = d_b(net_G_output["images_ab"])[:2]
        out["out_ba"], out["fea_ba"] = d_a(net_G_output["images_ba"])[:2]
        if real:
            out["out_a"], out["fea_a"] = d_a(data["images_a"])[:2]
            out["out_b"], out["fea_b"] = d_b(data["images_b"])[:2]
        if gan_recon:
            out["out_aa"], out["fea_aa"] = d_a(net_G_output["images_aa"])[:2]
            out["out_bb"], out["fea_bb"] = d_b(net_G_output["images_bb"])[:2]
        return out
