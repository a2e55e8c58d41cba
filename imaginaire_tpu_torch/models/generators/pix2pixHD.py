"""pix2pixHD coarse-to-fine generator (port of
``imaginaire_tpu/models/generators/pix2pixHD.py``).

A ``GlobalGenerator`` (conv7, a stride-2 ladder, a 'CNACN' residual
trunk, a nearest-upsample ladder, conv7 with tanh), an optional pyramid
of ``LocalEnhancer`` stages that refine at twice the resolution each,
and an optional instance-feature ``Encoder`` whose pooled features are
concatenated to the label (multi-modal synthesis; ``feature_maps`` may be
passed in instead, e.g. sampled cluster centers). Plain instance norms:
no SPADE branch, so no kernel of the port runs here. NCHW; submodule
names follow the JAX parameter tree (``global``, a Python keyword, is
registered with ``add_module``), so ``bridge.py`` loads a JAX ``init``
path for path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import Conv2dBlock, Res2dBlock
from imaginaire_tpu_torch.model_utils.pix2pixHD import instance_average
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy
from imaginaire_tpu_torch.utils.data import (
    get_paired_input_image_channel_number,
    get_paired_input_label_channel_number,
)
from imaginaire_tpu_torch.utils.misc import upsample_2x


def downsample2x_avg(x):
    """3x3 average pool, stride 2, padding 1, the padding not counted."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


def _res_trunk(module, channels, num_res_blocks, common):
    for i in range(num_res_blocks):
        module.add_module(f"res_{i}", Res2dBlock(
            channels, channels, kernel_size=3, padding=1, order="CNACN", **common))


class GlobalGenerator(nn.Module):
    """The coarse generator; ``output_img=False`` stops before the final
    conv7 + tanh (its features feed the first enhancer)."""

    def __init__(self, in_channels, num_filters=64, num_downsamples=4,
                 num_res_blocks=9, num_img_channels=3, padding_mode="reflect",
                 weight_norm_type="", activation_norm_type="instance",
                 activation_norm_params=None, output_img=True, remat="none"):
        super().__init__()
        self.num_downsamples, self.num_res_blocks = num_downsamples, num_res_blocks
        self.output_img = output_img
        self.remat = resolve_policy(remat, where="gen.remat")
        common = dict(padding_mode=padding_mode, weight_norm_type=weight_norm_type,
                      activation_norm_type=activation_norm_type,
                      activation_norm_params=activation_norm_params,
                      nonlinearity="relu")
        self.conv_in = Conv2dBlock(in_channels, num_filters, 7, padding=3, **common)
        for i in range(num_downsamples):
            ch = num_filters * 2 ** i
            self.add_module(f"down_{i}", Conv2dBlock(ch, ch * 2, 3, stride=2,
                                                     padding=1, **common))
        _res_trunk(self, num_filters * 2 ** num_downsamples, num_res_blocks, common)
        for i in reversed(range(num_downsamples)):
            ch = num_filters * 2 ** i
            self.add_module(f"up_{i}", Conv2dBlock(ch * 2, ch, 3, padding=1, **common))
        if output_img:
            self.conv_out = Conv2dBlock(num_filters, num_img_channels, 7, padding=3,
                                        padding_mode=padding_mode, nonlinearity="tanh")

    def forward(self, x):
        x = self.conv_in(x)
        for i in range(self.num_downsamples):
            x = getattr(self, f"down_{i}")(x)
        for i in range(self.num_res_blocks):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x)
        for i in reversed(range(self.num_downsamples)):
            x = getattr(self, f"up_{i}")(upsample_2x(x))
        if self.output_img:
            x = self.conv_out(x)
        return x


class LocalEnhancer(nn.Module):
    """A refinement stage at twice the resolution: downsample the fine
    input, add the coarser stage's features, residual blocks, upsample;
    the last enhancer emits the image."""

    def __init__(self, in_channels, num_filters, num_res_blocks=3, num_img_channels=3,
                 padding_mode="reflect", weight_norm_type="",
                 activation_norm_type="instance", activation_norm_params=None,
                 output_img=False, remat="none"):
        super().__init__()
        self.num_res_blocks, self.output_img = num_res_blocks, output_img
        self.remat = resolve_policy(remat, where="gen.remat")
        common = dict(padding_mode=padding_mode, weight_norm_type=weight_norm_type,
                      activation_norm_type=activation_norm_type,
                      activation_norm_params=activation_norm_params,
                      nonlinearity="relu")
        self.down_0 = Conv2dBlock(in_channels, num_filters, 7, padding=3, **common)
        self.down_1 = Conv2dBlock(num_filters, num_filters * 2, 3, stride=2, padding=1,
                                  **common)
        _res_trunk(self, num_filters * 2, num_res_blocks, common)
        self.up_0 = Conv2dBlock(num_filters * 2, num_filters, 3, padding=1, **common)
        if output_img:
            self.conv_out = Conv2dBlock(num_filters, num_img_channels, 7, padding=3,
                                        padding_mode=padding_mode, nonlinearity="tanh")

    def forward(self, output_coarse, input_fine):
        x = self.down_1(self.down_0(input_fine)) + output_coarse
        for i in range(self.num_res_blocks):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x)
        x = self.up_0(upsample_2x(x))
        if self.output_img:
            x = self.conv_out(x)
        return x


class Encoder(nn.Module):
    """Instance-feature encoder: a conv autoencoder over the real image,
    then instance-wise average pooling (``instance_average``)."""

    def __init__(self, in_channels, num_feat_channels=3, num_filters=16,
                 num_downsamples=4, padding_mode="reflect", weight_norm_type="none",
                 activation_norm_type="instance", max_instances=64):
        super().__init__()
        self.num_downsamples, self.max_instances = num_downsamples, max_instances
        common = dict(padding_mode=padding_mode, weight_norm_type=weight_norm_type,
                      activation_norm_type=activation_norm_type, nonlinearity="relu")
        self.conv_in = Conv2dBlock(in_channels, num_filters, 7, padding=3, **common)
        for i in range(num_downsamples):
            ch = num_filters * 2 ** i
            self.add_module(f"down_{i}", Conv2dBlock(ch, ch * 2, 3, stride=2,
                                                     padding=1, **common))
        for i in reversed(range(num_downsamples)):
            ch = num_filters * 2 ** i
            self.add_module(f"up_{i}", Conv2dBlock(ch * 2, ch, 3, padding=1, **common))
        self.conv_out = Conv2dBlock(num_filters, num_feat_channels, 7, padding=3,
                                    padding_mode=padding_mode, nonlinearity="tanh")

    def forward(self, images, instance_map):
        x = self.conv_in(images)
        for i in range(self.num_downsamples):
            x = getattr(self, f"down_{i}")(x)
        for i in reversed(range(self.num_downsamples)):
            x = getattr(self, f"up_{i}")(upsample_2x(x))
        return instance_average(self.conv_out(x), instance_map,
                                max_instances=self.max_instances)


class Generator(nn.Module):
    """The config-driven pix2pixHD generator.

    data: ``label`` (B, C, H, W: the one-hot segmentation and the edge
    map that replaced the instance channel), ``images`` and
    ``instance_maps`` (B, 1, H, W raw ids) for the encoder, or
    ``feature_maps`` (B, feat_nc, H, W) in their place. Returns
    {"fake_images"[, "feature_maps"]}."""

    use_style_encoder = False  # no style code: no G noise

    def __init__(self, gen_cfg, data_cfg):
        super().__init__()
        gen_cfg = as_attrdict(gen_cfg)
        data_cfg = as_attrdict(data_cfg)
        g = cfg_get(gen_cfg, "global_generator", None) or {}
        le = cfg_get(gen_cfg, "local_enhancer", None) or {}
        self.num_enhancers = cfg_get(le, "num_enhancers", 1)
        nf_global = cfg_get(g, "num_filters", 64)
        padding_mode = cfg_get(gen_cfg, "padding_mode", "reflect")
        common = dict(padding_mode=padding_mode,
                      weight_norm_type=cfg_get(gen_cfg, "weight_norm_type", ""),
                      activation_norm_type=cfg_get(gen_cfg, "activation_norm_type",
                                                   "instance"),
                      activation_norm_params=cfg_get(gen_cfg, "activation_norm_params",
                                                     None),
                      remat=cfg_get(gen_cfg, "remat", "none"))
        num_img = get_paired_input_image_channel_number(data_cfg)
        num_in = get_paired_input_label_channel_number(data_cfg)

        input_labels = list(cfg_get(data_cfg, "input_labels", []) or [])
        self.contain_instance_map = bool(input_labels) and \
            input_labels[-1] == "instance_maps"
        enc_cfg = cfg_get(gen_cfg, "enc", None)
        self.concat_features = False
        if enc_cfg is not None and self.contain_instance_map \
                and cfg_get(enc_cfg, "num_feat_channels", 0) > 0:
            self.concat_features = True
            feat_nc = cfg_get(enc_cfg, "num_feat_channels", 0)
            self.encoder = Encoder(
                num_img, num_feat_channels=feat_nc,
                num_filters=cfg_get(enc_cfg, "num_filters", 16),
                num_downsamples=cfg_get(enc_cfg, "num_downsamples", 4),
                padding_mode=cfg_get(enc_cfg, "padding_mode", "reflect"),
                weight_norm_type=cfg_get(enc_cfg, "weight_norm_type", "none"),
                activation_norm_type=cfg_get(enc_cfg, "activation_norm_type", "instance"),
                max_instances=cfg_get(enc_cfg, "max_instances", 64))
            num_in += feat_nc
        self.add_module("global", GlobalGenerator(
            num_in, num_filters=nf_global,
            num_downsamples=cfg_get(g, "num_downsamples", 4),
            num_res_blocks=cfg_get(g, "num_res_blocks", 9), num_img_channels=num_img,
            output_img=self.num_enhancers == 0, **common))
        for n in range(self.num_enhancers):
            self.add_module(f"enhancer_{n}", LocalEnhancer(
                num_in, nf_global // 2 ** (n + 1),
                num_res_blocks=cfg_get(le, "num_res_blocks", 3), num_img_channels=num_img,
                output_img=n == self.num_enhancers - 1, **common))

    def forward(self, data, random_style=False, noise=None, generator=None):
        """The style arguments of the trainer's calls are accepted and
        unused: pix2pixHD draws no noise."""
        label = data["label"]
        output = {}
        if self.concat_features:
            features = data.get("feature_maps")
            if features is None:
                features = self.encoder(data["images"], data["instance_maps"])
            label = torch.cat([label, features.to(label.dtype)], dim=1)
            output["feature_maps"] = features
        pyramid = [label]
        for _ in range(self.num_enhancers):
            pyramid.append(downsample2x_avg(pyramid[-1]))
        x = getattr(self, "global")(pyramid[-1])
        for n in range(self.num_enhancers):
            x = getattr(self, f"enhancer_{n}")(x, pyramid[self.num_enhancers - n - 1])
        output["fake_images"] = x
        return output
