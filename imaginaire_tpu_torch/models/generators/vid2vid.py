"""vid2vid generator (port of ``imaginaire_tpu/models/generators/vid2vid.py``).

Per frame: embed the current label map into a feature pyramid; start
from the label map (or a code) on the first frame, or from an encoding
of the previous output frame on later frames; run a SPADE-conditioned
residual up-ladder; and, once ``num_frames_G - 1`` previous frames are
known, estimate flow and an occlusion mask from them, warp the previous
output frame (``resample2d``, the CUDA kernel on the card) and feed the
warped frame into the last ``num_multi_spade_layers`` SPADE layers
(multi-SPADE combine).

Every submodule, the temporal path included, is built at construction,
as the JAX package's ``init_all`` materializes them, and registered
under the JAX names (``up_{i}``, ``down_{i}``, ``res_{i}``...), so
``bridge.load_flax_variables`` maps the flax tree path for path. NCHW
tensors; frame histories are (B, T, C, H, W).

Training mode (``.train()``) normalizes the BatchNorms with the batch
statistics and takes spectral-norm power steps; each layer writes its
running statistics and ``u`` only in its own network's step
(``layers/state.py``). ``gen.remat`` checkpoints the blocks the JAX
generator wraps (``optim/remat.py``): the up, down and residual SPADE
blocks and the flow network's residual trunk. The warp sits outside
every wrapped block, so a checkpointed backward never repeats it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import Conv2dBlock, LinearBlock, Res2dBlock
from imaginaire_tpu_torch.layers.activation_norm import default_fused_modulation
from imaginaire_tpu_torch.model_utils.fs_vid2vid import fold_time, resample
from imaginaire_tpu_torch.models.generators.embedders import LabelEmbedder
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy
from imaginaire_tpu_torch.utils.data import (
    get_crop_or_resize_h_w,
    get_paired_input_image_channel_number,
    get_paired_input_label_channel_number,
)
from imaginaire_tpu_torch.utils.misc import resize_bilinear, upsample_2x


def _avgpool3s2(x):
    # flax's avg_pool divides by the full window, padding included
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


class FlowGenerator(nn.Module):
    """Flow + occlusion-mask estimator: separate label and previous-image
    downsample trails summed at the bottleneck, a residual trunk, an
    upsample trail, and flow and sigmoid-mask heads."""

    def __init__(self, flow_cfg, num_input_channels, num_prev_img_channels,
                 num_frames, remat="none"):
        super().__init__()
        cfg = as_attrdict(flow_cfg)
        self.remat = resolve_policy(remat, where="gen.remat")
        num_filters = cfg_get(cfg, "num_filters", 32)
        max_num_filters = cfg_get(cfg, "max_num_filters", 1024)
        self.num_downsamples = nd = cfg_get(cfg, "num_downsamples", 5)
        ks = cfg_get(cfg, "kernel_size", 3)
        num_res_blocks = cfg_get(cfg, "num_res_blocks", 6)
        self.multiplier = cfg_get(cfg, "flow_output_multiplier", 20)
        an = cfg_get(cfg, "activation_norm_type", "sync_batch")
        wn = cfg_get(cfg, "weight_norm_type", "spectral")
        self.num_res_blocks = num_res_blocks

        def nf(i):
            return min(max_num_filters, num_filters * (2 ** i))

        def conv(cin, cout, stride=1):
            return Conv2dBlock(cin, cout, kernel_size=ks, stride=stride,
                               padding=ks // 2, weight_norm_type=wn,
                               activation_norm_type=an,
                               nonlinearity="leakyrelu")

        # the label input holds the previous labels and the current one,
        # the image input the previous frames, each folded into channels
        self.down_lbl_in = conv(num_frames * num_input_channels, num_filters)
        self.down_img_in = conv((num_frames - 1) * num_prev_img_channels,
                                num_filters)
        cin = num_filters
        for i in range(nd):
            self.add_module(f"down_lbl_{i}", conv(cin, nf(i + 1), stride=2))
            self.add_module(f"down_img_{i}", conv(cin, nf(i + 1), stride=2))
            cin = nf(i + 1)
        for i in range(num_res_blocks):
            self.add_module(f"res_{i}", Res2dBlock(
                nf(nd), nf(nd), kernel_size=ks, padding=ks // 2,
                weight_norm_type=wn, activation_norm_type=an, order="CNACN"))
        for i in reversed(range(nd)):
            self.add_module(f"up_{i}", conv(nf(i + 1), nf(i)))
        self.conv_flow = Conv2dBlock(nf(0), 2, kernel_size=ks, padding=ks // 2)
        self.conv_mask = Conv2dBlock(nf(0), 1, kernel_size=ks, padding=ks // 2,
                                     nonlinearity="sigmoid")

    def forward(self, label, img_prev):
        """label: (B, T*C_l, H, W), img_prev: (B, (T-1)*C_i, H, W) ->
        flow (B, 2, H, W) in pixels (channel 0 = dx), mask (B, 1, H, W)."""
        lbl = self.down_lbl_in(label)
        img = self.down_img_in(img_prev)
        for i in range(self.num_downsamples):
            lbl = getattr(self, f"down_lbl_{i}")(lbl)
            img = getattr(self, f"down_img_{i}")(img)
        x = lbl + img
        for i in range(self.num_res_blocks):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x)
        for i in reversed(range(self.num_downsamples)):
            x = getattr(self, f"up_{i}")(upsample_2x(x))
        return self.conv_flow(x) * self.multiplier, self.conv_mask(x)


class Generator(nn.Module):
    """Config-driven vid2vid generator (see the module doc)."""

    def __init__(self, gen_cfg, data_cfg):
        super().__init__()
        gen_cfg = as_attrdict(gen_cfg)
        data_cfg = as_attrdict(data_cfg)
        self.num_frames_G = cfg_get(data_cfg, "num_frames_G", 3)
        self.num_layers = cfg_get(gen_cfg, "num_layers", 7)
        self.num_downsamples_img = cfg_get(gen_cfg, "num_downsamples_img", 4)
        num_filters = cfg_get(gen_cfg, "num_filters", 32)
        max_num_filters = cfg_get(gen_cfg, "max_num_filters", 1024)
        ks = cfg_get(gen_cfg, "kernel_size", 3)
        padding = ks // 2
        self.num_input_channels = get_paired_input_label_channel_number(data_cfg)
        self.num_img_channels = get_paired_input_image_channel_number(data_cfg)

        aug = cfg_get(cfg_get(data_cfg, "val", {}) or {}, "augmentations", {}) or {}
        try:
            crop_h, crop_w = get_crop_or_resize_h_w(aug)
        except ValueError:
            raise ValueError(
                "Need data.val.augmentations center_crop_h_w or resize_h_w "
                "to size the generator bottleneck.") from None
        self.sh = crop_h // (2 ** self.num_layers)
        self.sw = crop_w // (2 ** self.num_layers)
        # the one frame size this generator produces, whatever its input
        self.frame_hw = (self.sh * 2 ** self.num_layers,
                         self.sw * 2 ** self.num_layers)
        self.z_dim = cfg_get(gen_cfg, "style_dims", 256)
        self.use_segmap_as_input = cfg_get(gen_cfg, "use_segmap_as_input", False)

        emb_cfg = cfg_get(gen_cfg, "embed", None)
        self.use_embed = (cfg_get(emb_cfg, "use_embed", True)
                          if emb_cfg is not None else False)
        self.num_downsamples_embed = (cfg_get(emb_cfg, "num_downsamples", 5)
                                      if emb_cfg is not None else 0)
        n_scales = self.num_layers + 1
        label_dims = [self.num_input_channels] * n_scales
        if self.use_embed:
            self.label_embedding = LabelEmbedder(emb_cfg, self.num_input_channels)
            label_dims = self.label_embedding.out_channels

        flow_cfg = cfg_get(gen_cfg, "flow", None)
        self.has_flow = flow_cfg is not None
        msc = cfg_get(flow_cfg, "multi_spade_combine", None) if self.has_flow else None
        self.spade_combine = self.has_flow and msc is not False
        if self.has_flow and not self.spade_combine:
            raise NotImplementedError(
                "gen.flow.multi_spade_combine: False (the mask blend of the "
                "warped and generated frames) is not in the port yet "
                "(ROADMAP.md)")
        if self.has_flow and cfg_get(flow_cfg, "generate_raw_output", False):
            raise NotImplementedError(
                "gen.flow.generate_raw_output is not in the port yet "
                "(ROADMAP.md)")
        msc = as_attrdict(msc or {})
        self.num_multi_spade_layers = cfg_get(msc, "num_layers", 3)

        wn = cfg_get(gen_cfg, "weight_norm_type", "spectral")
        an = cfg_get(gen_cfg, "activation_norm_type", "spatially_adaptive")
        anp = dict(as_attrdict(cfg_get(gen_cfg, "activation_norm_params", {}) or {}))
        anp.pop("num_filters_embed", None)
        remat = cfg_get(gen_cfg, "remat", "none")
        self.remat = resolve_policy(remat, where="gen.remat")
        anp = default_fused_modulation(anp, remat)

        def nf(i):
            return min(max_num_filters, num_filters * (2 ** i))

        def res_block(cin, cout, cond_dims):
            return Res2dBlock(
                cin, cout, kernel_size=ks, padding=padding,
                weight_norm_type=wn, activation_norm_type=an,
                activation_norm_params=dict(anp, cond_dims=cond_dims),
                nonlinearity="leakyrelu", order="NACNAC")

        def scale(i):  # the embedding scale that conditions layer i
            return min(self.num_downsamples_embed, i)

        img_dims = None
        if self.spade_combine:
            img_in = self.num_img_channels + 1  # warped frame + mask
            img_dims = [img_in] * n_scales
            if self.use_embed:
                self.img_prev_embedding = LabelEmbedder(
                    cfg_get(msc, "embed", None) or emb_cfg, img_in)
                img_dims = self.img_prev_embedding.out_channels

        # main up branch: one block per scale, index i = scale i
        for i in range(self.num_layers + 1):
            cond = [label_dims[scale(i)]]
            if self.spade_combine and i < self.num_multi_spade_layers:
                cond.append(img_dims[scale(i)])
            self.add_module(f"up_{i}", res_block(nf(i + 1), nf(i), cond))
        self.conv_img = Conv2dBlock(nf(0), self.num_img_channels, ks,
                                    padding=padding, nonlinearity="leakyrelu",
                                    order="AC")
        nf_bottleneck = nf(self.num_layers + 1)
        if self.use_segmap_as_input:
            self.fc = Conv2dBlock(self.num_input_channels, nf_bottleneck,
                                  kernel_size=3, padding=1)
        else:
            self.fc = LinearBlock(self.z_dim, nf_bottleneck * self.sh * self.sw)

        # previous-frame encoder
        self.num_res_blocks = int(math.ceil(
            (self.num_layers - self.num_downsamples_img) / 2.0) * 2)
        self.down_first = Conv2dBlock(self.num_img_channels, num_filters, ks,
                                      padding=padding)
        for i in range(self.num_downsamples_img + 1):
            self.add_module(f"down_{i}", res_block(
                nf(i), nf(i + 1), [label_dims[scale(i)]]))
        res_ch = nf(self.num_downsamples_img + 1)
        for i in range(self.num_res_blocks):
            self.add_module(f"res_{i}", res_block(
                res_ch, res_ch, [label_dims[scale(self.num_downsamples_img + 1)]]))

        if self.has_flow:
            self.flow_network_temp = FlowGenerator(
                flow_cfg, self.num_input_channels, self.num_img_channels,
                self.num_frames_G, remat=remat)

    # ------------------------------------------------------------- helpers

    def _block(self, name, x, *cond):
        """SPADE residual block ``name``, checkpointed under ``gen.remat``."""
        return call_block(getattr(self, name), self.remat, x, *cond)

    def get_cond_maps(self, label, embedder):
        """One conditioning list per scale."""
        if not self.use_embed:
            return [[label]] * (self.num_layers + 1)
        return [[e] for e in embedder(label)]

    def _first_frame_trunk(self, data, cond_maps_now):
        """Segmap (or code) start + the coarse up layers."""
        label = data["label"]
        b = label.shape[0]
        if self.use_segmap_as_input:
            x = self.fc(resize_bilinear(label, (self.sh, self.sw)))
        else:
            z = data.get("z")
            if z is None:
                z = torch.zeros((b, self.z_dim), dtype=label.dtype,
                                device=label.device)
            # the dense output is laid out (sh, sw, C) as in the JAX package
            x = self.fc(z).view(b, self.sh, self.sw, -1).permute(0, 3, 1, 2)
        for i in range(self.num_layers, self.num_downsamples_img, -1):
            j = min(self.num_downsamples_embed, i)
            x = upsample_2x(self._block(f"up_{i}", x, *cond_maps_now[j]))
        return x

    def _prev_frame_trunk(self, label_prev, img_prev, cond_maps_now):
        """Encode the previous output frame."""
        x = self.down_first(img_prev[:, -1])
        cond_maps_prev = self.get_cond_maps(
            label_prev[:, -1], getattr(self, "label_embedding", None))
        for i in range(self.num_downsamples_img + 1):
            j = min(self.num_downsamples_embed, i)
            x = self._block(f"down_{i}", x, *cond_maps_prev[j])
            if i != self.num_downsamples_img:
                x = _avgpool3s2(x)
        j = min(self.num_downsamples_embed, self.num_downsamples_img + 1)
        for i in range(self.num_res_blocks):
            cond = (cond_maps_prev[j] if i < self.num_res_blocks // 2
                    else cond_maps_now[j])
            x = self._block(f"res_{i}", x, *cond)
        return x

    def _flow_warp(self, label, label_prev, img_prev):
        lbl_concat = torch.cat([fold_time(label_prev), label], dim=1)
        flow, mask = self.flow_network_temp(lbl_concat, fold_time(img_prev))
        return flow, mask, resample(img_prev[:, -1], flow)

    # ------------------------------------------------------------- forward

    def forward(self, data):
        """data: label (B, C, H, W); prev_labels / prev_images
        (B, T, C, H, W) or absent; optional z. Returns the JAX
        generator's output dict (absent outputs are None)."""
        label = data["label"]
        label_prev = data.get("prev_labels")
        img_prev = data.get("prev_images")
        cond_maps_now = self.get_cond_maps(
            label, getattr(self, "label_embedding", None))

        flow = mask = img_warp = None
        warp_prev = False
        if img_prev is None:
            x_img = self._first_frame_trunk(data, cond_maps_now)
        else:
            x_img = self._prev_frame_trunk(label_prev, img_prev, cond_maps_now)
            warp_prev = (self.has_flow
                         and label_prev.shape[1] == self.num_frames_G - 1)
            if warp_prev:
                flow, mask, img_warp = self._flow_warp(label, label_prev,
                                                       img_prev)
                cond_maps_img = self.get_cond_maps(
                    torch.cat([img_warp, mask], dim=1),
                    getattr(self, "img_prev_embedding", None))

        for i in range(self.num_downsamples_img, -1, -1):
            j = min(i, self.num_downsamples_embed)
            cond_maps = list(cond_maps_now[j])
            if warp_prev and i < self.num_multi_spade_layers:
                cond_maps += cond_maps_img[j]
            x_img = self._block(f"up_{i}", x_img, *cond_maps)
            if i != 0:
                x_img = upsample_2x(x_img)

        return {"fake_images": torch.tanh(self.conv_img(x_img)),
                "fake_flow_maps": flow, "fake_occlusion_masks": mask,
                "fake_raw_images": None, "warped_images": img_warp}

    def inference(self, data):
        return self(data)["fake_images"]
