"""vid2vid discriminator (port of
``imaginaire_tpu/models/discriminators/fs_vid2vid.py:42-165``).

An image patch discriminator ``net_D`` over concat(label, frame), and
one temporal patch discriminator ``net_DT{s}`` a scale over stacks of
tD frames ``tD**s`` apart, folded into channels (time-major, channel
t * C + c). The trainer hands each active scale its past real and fake
frames (``past_stacks``); the current frame is appended here, so the G
step's gradient reaches it. A generator's raw output
(``fake_raw_images``) goes through ``net_D`` too, masked by the
foreground. With few-shot data (fs-vid2vid) the image discriminator's
condition also holds the reference label and image the generator picked
(``ref_idx``). ``additional_discriminators`` (pose data: ``net_D_face``,
``net_D_hand``, sorted by name) each judge a region of the real and the
fake frame, cut by the config's ``crop_func`` (``module::function``,
resolved to the port's twin: ``model_utils/fs_vid2vid.py``) from the
current frame's pose label; a crop that comes with a validity mask (the
hands) passes it on as ``valid``. A few-shot D's region D sees the real
or fake crop beside the crop of the reference image the generator picked,
cut at the same box (the current frame's label's), so its input has 6
channels. NCHW; frame stacks are (B, T, C, H, W), reference stacks (B, K, C, H,
W).
"""

from __future__ import annotations

import torch
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.model_utils.fs_vid2vid import fold_time, get_fg_mask, pick_image
from imaginaire_tpu_torch.models.discriminators.multires_patch import (
    MultiResPatchDiscriminator,
)
from imaginaire_tpu_torch.registry import resolve_function
from imaginaire_tpu_torch.utils.data import (
    get_paired_input_image_channel_number,
    get_paired_input_label_channel_number,
)


def _make_patch_dis(dis_cfg, in_channels):
    dis_cfg = as_attrdict(dis_cfg or {})
    return MultiResPatchDiscriminator(
        in_channels,
        num_discriminators=cfg_get(dis_cfg, "num_discriminators", 2),
        kernel_size=cfg_get(dis_cfg, "kernel_size", 4),
        num_filters=cfg_get(dis_cfg, "num_filters", 64),
        num_layers=cfg_get(dis_cfg, "num_layers", 3),
        max_num_filters=cfg_get(dis_cfg, "max_num_filters", 512),
        activation_norm_type=cfg_get(dis_cfg, "activation_norm_type", "none"),
        weight_norm_type=cfg_get(dis_cfg, "weight_norm_type", "spectral"),
        remat=cfg_get(dis_cfg, "remat", "none"))


class Discriminator(nn.Module):
    def __init__(self, dis_cfg, data_cfg):
        super().__init__()
        dis_cfg = as_attrdict(dis_cfg)
        data_cfg = as_attrdict(data_cfg)
        self.data_cfg = data_cfg
        self.use_few_shot = "few_shot" in str(cfg_get(data_cfg, "type", ""))
        add_cfg = as_attrdict(cfg_get(dis_cfg, "additional_discriminators", None) or {})
        self.add_dis_names = sorted(add_cfg.keys())
        self.add_crop_funcs = [
            resolve_function(*str(cfg_get(add_cfg[n], "crop_func", "")).split("::"))
            for n in self.add_dis_names]
        self.num_frames_D = cfg_get(data_cfg, "num_frames_D", 3)
        temporal_cfg = cfg_get(dis_cfg, "temporal", None)
        self.num_scales = (cfg_get(temporal_cfg, "num_scales", 0)
                           if temporal_cfg is not None else 0)
        self.has_fg = cfg_get(data_cfg, "has_foreground", False)
        num_labels = get_paired_input_label_channel_number(data_cfg)
        num_img = get_paired_input_image_channel_number(data_cfg)
        cond = num_labels + (num_labels + num_img if self.use_few_shot else 0)
        self.net_D = _make_patch_dis(cfg_get(dis_cfg, "image", None), cond + num_img)
        for s in range(self.num_scales):
            self.add_module(f"net_DT{s}", _make_patch_dis(
                temporal_cfg, self.num_frames_D * num_img))
        # region crops: the frame's last 3 channels, and the reference's
        for name in self.add_dis_names:
            self.add_module(f"net_D_{name}", _make_patch_dis(
                add_cfg[name], 6 if self.use_few_shot else 3))

    @staticmethod
    def _discriminate_image(net_D, real_A, real_B, fake_B):
        if real_A is not None:
            real_in = torch.cat([real_A, real_B], dim=1)
            fake_in = torch.cat([real_A, fake_B], dim=1)
        else:
            real_in, fake_in = real_B, fake_B
        real_out, real_feat = net_D(real_in)
        fake_out, fake_feat = net_D(fake_in)
        return {"pred_real": {"outputs": real_out, "features": real_feat},
                "pred_fake": {"outputs": fake_out, "features": fake_feat}}

    def forward(self, data, net_G_output, past_stacks=None):
        """past_stacks: a list a scale of (real, fake) stacks of past
        frames (B, tD - 1, C, H, W), or None for a scale not active yet.
        Returns {'indv', [each region's name], ['raw'], ['temporal_{s}']}:
        each holds pred_real / pred_fake outputs and features a pyramid
        scale, a region's also ``valid`` where its crop gives one."""
        label, real_image = data["label"], data["image"]
        if label is not None and label.dim() == 5:
            label = label[:, -1]
        if self.use_few_shot:
            ref_idx = net_G_output.get("ref_idx")
            ref_image = pick_image(data["ref_images"], ref_idx)
            label = torch.cat([label, pick_image(data["ref_labels"], ref_idx), ref_image],
                              dim=1)
        fake_image = net_G_output["fake_images"]
        output = {"indv": self._discriminate_image(self.net_D, label,
                                                   real_image, fake_image)}
        pose_label = data["label"]
        for name, crop_fn in zip(self.add_dis_names, self.add_crop_funcs):
            real_crop = crop_fn(self.data_cfg, real_image, pose_label)
            fake_crop = crop_fn(self.data_cfg, fake_image, pose_label)
            valid = None
            if isinstance(real_crop, tuple):
                (real_crop, valid), (fake_crop, _) = real_crop, fake_crop
            if self.use_few_shot:
                ref_crop = crop_fn(self.data_cfg, ref_image, pose_label)
                if isinstance(ref_crop, tuple):
                    ref_crop = ref_crop[0]
                real_crop = torch.cat([real_crop, ref_crop], dim=1)
                fake_crop = torch.cat([fake_crop, ref_crop], dim=1)
            output[name] = self._discriminate_image(
                getattr(self, f"net_D_{name}"), None, real_crop, fake_crop)
            if valid is not None:
                output[name]["valid"] = valid
        if net_G_output.get("fake_raw_images") is not None:
            fg_mask = get_fg_mask(data["label"], self.has_fg)
            output["raw"] = self._discriminate_image(
                self.net_D, label, real_image * fg_mask,
                net_G_output["fake_raw_images"] * fg_mask)
        for s in range(self.num_scales):
            if past_stacks is None or past_stacks[s] is None:
                continue
            past_real, past_fake = past_stacks[s]
            real_stack = torch.cat([past_real, real_image.unsqueeze(1)], dim=1)
            fake_stack = torch.cat([past_fake, fake_image.unsqueeze(1)], dim=1)
            output[f"temporal_{s}"] = self._discriminate_image(
                getattr(self, f"net_DT{s}"), None, fold_time(real_stack),
                fold_time(fake_stack))
        return output
