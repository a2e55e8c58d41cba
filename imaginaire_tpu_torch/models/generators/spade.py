"""SPADE / GauGAN generator (port of ``imaginaire_tpu/models/generators/spade.py``).

Label map (+ a style code) -> image. A start at 1/16 of the output side
(16x16 for a 256 output), a nearest-upsample ladder of SPADE residual
blocks conditioned on the full-resolution label map, global AdaIN
("cbn") blocks conditioned on the style code, and output heads summed
under tanh for the 512/1024 ladders. NCHW tensors; submodule names
mirror the JAX package's parameter tree.

Noise: the style code is a (B, style_dims) standard-normal draw. With
``random_style`` it is z itself, else the VAE's reparameterisation eps.
Callers pass it as ``noise`` (the serving engine draws one row per
request from that request's own ``torch.Generator``), or pass a
``generator`` to draw it here.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import Conv2dBlock, LinearBlock, Res2dBlock
from imaginaire_tpu_torch.layers.activation_norm import default_fused_modulation
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy
from imaginaire_tpu_torch.utils.data import (
    get_crop_or_resize_h_w,
    get_paired_input_image_channel_number,
    get_paired_input_label_channel_number,
)
from imaginaire_tpu_torch.utils.misc import (
    resize_bilinear,
    resize_cubic,
    resize_nearest,
    upsample_2x,
)


def _style_noise(shape, noise, generator, device):
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise must be {tuple(shape)}, got "
                             f"{tuple(noise.shape)}")
        return noise.to(device=device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=device)


class Generator(nn.Module):
    """Config-driven wrapper: style encoder + SPADE generator."""

    def __init__(self, gen_cfg, data_cfg):
        super().__init__()
        gen_cfg = as_attrdict(gen_cfg)
        data_cfg = as_attrdict(data_cfg)
        image_channels = get_paired_input_image_channel_number(data_cfg)
        num_labels = get_paired_input_label_channel_number(data_cfg)
        crop_h, crop_w = get_crop_or_resize_h_w(data_cfg.train.augmentations)

        num_filters = cfg_get(gen_cfg, "num_filters", 128)
        kernel_size = cfg_get(gen_cfg, "kernel_size", 3)
        weight_norm_type = cfg_get(gen_cfg, "weight_norm_type", "spectral")
        self.style_dims = cfg_get(gen_cfg, "style_dims", None)
        self.use_style = self.style_dims is not None
        attribute_dims = cfg_get(gen_cfg, "attribute_dims", None)
        self.use_attribute = attribute_dims is not None
        self.use_style_encoder = self.use_style or self.use_attribute
        cond_dims = (self.style_dims or 0) + (attribute_dims or 0)
        if dict(cfg_get(gen_cfg, "non_local", None) or {}).get("enabled"):
            raise NotImplementedError("the non-local block is not in the "
                                      "port yet (ROADMAP.md)")

        anp = dict(cfg_get(gen_cfg, "activation_norm_params", None) or {})
        anp.setdefault("num_filters", 128)
        anp.setdefault("kernel_size", 3)
        anp.setdefault("activation_norm_type", "sync_batch")
        anp.setdefault("separate_projection", False)
        anp.setdefault("weight_norm_type", weight_norm_type)
        remat = cfg_get(gen_cfg, "remat", "none")
        anp = default_fused_modulation(anp, remat)

        self.spade_generator = SPADEGenerator(
            num_labels=num_labels,
            out_image_small_side_size=min(crop_h, crop_w),
            image_channels=image_channels,
            num_filters=num_filters,
            kernel_size=kernel_size,
            style_dims=cond_dims,
            activation_norm_params=anp,
            weight_norm_type=weight_norm_type,
            global_adaptive_norm_type=cfg_get(
                gen_cfg, "global_adaptive_norm_type", "sync_batch"),
            skip_activation_norm=cfg_get(gen_cfg, "skip_activation_norm", True),
            use_posenc_in_input_layer=cfg_get(
                gen_cfg, "use_posenc_in_input_layer", True),
            use_style_encoder=self.use_style_encoder, remat=remat)
        if self.use_style:
            se_cfg = dict(cfg_get(gen_cfg, "style_enc", None) or {})
            self.style_encoder = StyleEncoder(
                image_channels=image_channels,
                num_filters=se_cfg.get("num_filters", 128),
                kernel_size=se_cfg.get("kernel_size", 3),
                style_dims=self.style_dims,
                weight_norm_type=se_cfg.get("weight_norm_type", weight_norm_type))

    def forward(self, data, random_style=False, noise=None, generator=None):
        """data: {'label': (N, C_l, H, W), 'images': (N, C, H, W), ...} ->
        {'fake_images', 'mu', 'logvar'}."""
        mu = logvar = z = None
        if self.use_style_encoder:
            label = data["label"]
            shape = (label.shape[0], self.style_dims)
            if random_style:
                z = _style_noise(shape, noise, generator, label.device)
            else:
                eps = _style_noise(shape, noise, generator, label.device)
                mu, logvar, z = self.style_encoder(data["images"], eps)
            if self.use_attribute:
                z = torch.cat([z, data["attributes"].reshape(z.shape[0], -1)],
                              dim=1)
        output = self.spade_generator(data["label"], z)
        if self.use_style_encoder:
            output["mu"] = mu
            output["logvar"] = logvar
        return output

    def inference(self, data, random_style=False, noise=None, generator=None):
        """The eval forward returning fake images."""
        return self(data, random_style=random_style, noise=noise,
                    generator=generator)["fake_images"]


class SPADEGenerator(nn.Module):
    """The up-ladder core."""

    def __init__(self, num_labels, out_image_small_side_size, image_channels,
                 num_filters, kernel_size, style_dims, activation_norm_params,
                 weight_norm_type, global_adaptive_norm_type,
                 skip_activation_norm, use_posenc_in_input_layer,
                 use_style_encoder, remat="none"):
        super().__init__()
        self.remat = resolve_policy(remat, where="gen.remat")
        size = out_image_small_side_size
        if size not in (256, 512, 1024):
            raise ValueError(f"Generation image size {size} not supported")
        self.out_image_small_side_size = size
        self.base = {256: 16, 512: 32, 1024: 64}[size]
        self.use_posenc_in_input_layer = use_posenc_in_input_layer
        self.use_style_encoder = use_style_encoder
        nf, ks = num_filters, kernel_size
        pad = int(math.ceil((ks - 1.0) / 2))
        anp = dict(activation_norm_params, cond_dims=num_labels)

        def res_block(cin, cout):
            return Res2dBlock(
                cin, cout, kernel_size=ks, padding=pad, bias=[True, True, False],
                weight_norm_type=weight_norm_type,
                activation_norm_type="spatially_adaptive",
                activation_norm_params=anp,
                skip_activation_norm=skip_activation_norm,
                nonlinearity="leakyrelu", order="NACNAC")

        def cbn_block(cin, cout):
            return Conv2dBlock(
                cin, cout, kernel_size=ks, stride=1, padding=pad, bias=True,
                weight_norm_type=weight_norm_type,
                activation_norm_type="adaptive",
                activation_norm_params={
                    "activation_norm_type": global_adaptive_norm_type,
                    "weight_norm_type": anp.get("weight_norm_type", ""),
                    "separate_projection": anp.get("separate_projection", False),
                    "cond_dims": 2 * style_dims},
                nonlinearity="leakyrelu", order="NAC")

        def plain_block(cin, cout):
            return Conv2dBlock(
                cin, cout, kernel_size=ks, stride=1, padding=pad, bias=True,
                weight_norm_type=weight_norm_type,
                nonlinearity="leakyrelu", order="NAC")

        def mid_block(cin, cout):
            return cbn_block(cin, cout) if use_style_encoder else plain_block(cin, cout)

        def img_head(cin):
            return Conv2dBlock(
                cin, image_channels, 5, stride=1, padding=2,
                weight_norm_type=weight_norm_type, activation_norm_type="none",
                nonlinearity="leakyrelu", order="ANC")

        if use_style_encoder:
            self.fc_0 = LinearBlock(style_dims, 2 * style_dims,
                                    weight_norm_type=weight_norm_type,
                                    nonlinearity="relu", order="CAN")
            self.fc_1 = LinearBlock(2 * style_dims, 2 * style_dims,
                                    weight_norm_type=weight_norm_type,
                                    nonlinearity="relu", order="CAN")
        in_ch = num_labels + (2 if use_posenc_in_input_layer else 0)
        self.head_0 = Conv2dBlock(in_ch, 8 * nf, kernel_size=ks, stride=1,
                                  padding=pad, weight_norm_type=weight_norm_type,
                                  activation_norm_type="none",
                                  nonlinearity="leakyrelu")
        mid = "cbn" if use_style_encoder else "conv"
        self.add_module(f"{mid}_head_0", mid_block(8 * nf, 16 * nf))
        self.head_1 = res_block(16 * nf, 16 * nf)
        self.head_2 = res_block(16 * nf, 16 * nf)
        self.up_0a = res_block(16 * nf, 8 * nf)
        self.add_module(f"{mid}_up_0a", mid_block(8 * nf, 8 * nf))
        self.up_0b = res_block(8 * nf, 8 * nf)
        self.up_1a = res_block(8 * nf, 4 * nf)
        self.add_module(f"{mid}_up_1a", mid_block(4 * nf, 4 * nf))
        self.up_1b = res_block(4 * nf, 4 * nf)
        self.up_2a = res_block(4 * nf, 4 * nf)
        self.add_module(f"{mid}_up_2a", mid_block(4 * nf, 4 * nf))
        self.up_2b = res_block(4 * nf, 2 * nf)
        self.conv_img256 = img_head(2 * nf)
        if size >= 512:
            self.up_3a = res_block(2 * nf, nf)
            self.up_3b = res_block(nf, nf)
            self.conv_img512 = img_head(nf)
        if size == 1024:
            self.up_4a = res_block(nf, nf // 2)
            self.up_4b = res_block(nf // 2, nf // 2)
            self.conv_img1024 = img_head(nf // 2)
        self._mid = mid

    def _posenc(self, sy, sx, device, dtype):
        """The xy ramp in [-1, 1], Keys-cubic resized from 16x16."""
        lin = torch.linspace(-1, 1, 16, device=device)
        xv, yv = torch.meshgrid(lin, lin, indexing="ij")
        xy = torch.stack([xv, yv])[None]
        return resize_cubic(xy, (sy, sx)).to(dtype)

    def forward(self, seg, z=None):
        mid = self._mid
        if self.use_style_encoder:
            z = self.fc_1(self.fc_0(z))
        n, _, h, w = seg.shape
        sy, sx = h // self.base, w // self.base
        in_seg = resize_nearest(seg, (sy, sx))
        if self.use_posenc_in_input_layer:
            xy = self._posenc(sy, sx, seg.device, seg.dtype)
            in_seg = torch.cat([in_seg, xy.expand(n, -1, -1, -1)], dim=1)

        def mid_block(name, x):
            block = getattr(self, f"{mid}_{name}")
            return block(x, z) if self.use_style_encoder else block(x)

        def res_block(name, x):
            return call_block(getattr(self, name), self.remat, x, seg)

        x = self.head_0(in_seg)
        x = mid_block("head_0", x)
        x = res_block("head_1", x)
        x = res_block("head_2", x)
        x = upsample_2x(x)
        x = res_block("up_0a", x)
        x = mid_block("up_0a", x)
        x = res_block("up_0b", x)
        x = upsample_2x(x)
        x = res_block("up_1a", x)
        x = mid_block("up_1a", x)
        x = res_block("up_1b", x)
        x = upsample_2x(x)
        x = res_block("up_2a", x)
        x = mid_block("up_2a", x)
        x = res_block("up_2b", x)
        x = upsample_2x(x)

        size = self.out_image_small_side_size
        if size == 256:
            return {"fake_images": torch.tanh(self.conv_img256(x))}
        x256 = self.conv_img256(x)
        x = res_block("up_3b", res_block("up_3a", x))
        x = upsample_2x(x)
        x512 = self.conv_img512(x)
        if size == 512:
            return {"fake_images": torch.tanh(upsample_2x(x256) + x512)}
        x = res_block("up_4b", res_block("up_4a", x))
        x = upsample_2x(x)
        x1024 = self.conv_img1024(x)
        return {"fake_images": torch.tanh(
            upsample_2x(upsample_2x(x256)) + upsample_2x(x512) + x1024)}


class StyleEncoder(nn.Module):
    """VAE-style encoder: 6 stride-2 convs + fc_mu/fc_var + reparam."""

    def __init__(self, image_channels=3, num_filters=128, kernel_size=3,
                 style_dims=256, weight_norm_type="spectral"):
        super().__init__()
        nf, ks = num_filters, kernel_size
        pad = int(math.ceil((ks - 1.0) / 2))
        chans = [image_channels, nf, 2 * nf, 4 * nf, 8 * nf, 8 * nf, 8 * nf]
        for i in range(6):
            self.add_module(f"layer{i + 1}", Conv2dBlock(
                chans[i], chans[i + 1], kernel_size=ks, stride=2, padding=pad,
                weight_norm_type=weight_norm_type, activation_norm_type="none",
                nonlinearity="leakyrelu"))
        # 256 input / 2**6 = 4x4 spatial at the flatten
        flat = 8 * nf * 4 * 4
        self.fc_mu = LinearBlock(flat, style_dims)
        self.fc_var = LinearBlock(flat, style_dims)

    def forward(self, x, eps):
        """x: (N, C, H, W) images; eps: (N, style_dims) standard normal,
        taken in the type of ``exp(logvar / 2)`` as the JAX encoder draws
        it. Returns (mu, logvar, z = eps * exp(logvar / 2) + mu)."""
        x = resize_bilinear(x, (256, 256))
        for i in range(6):
            x = getattr(self, f"layer{i + 1}")(x)
        # flatten in the JAX package's NHWC order so fc weights bridge as-is
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        mu = self.fc_mu(x)
        logvar = self.fc_var(x)
        std = torch.exp(0.5 * logvar)
        z = eps.to(std.dtype) * std + mu
        return mu, logvar, z
