"""Few-shot vid2vid generator (port of
``imaginaire_tpu/models/generators/fs_vid2vid.py``).

Each frame: a ``WeightGenerator`` encodes the K reference frames (with
K > 1 an ``AttentionModule`` combines them, keyed by the labels, and
picks the reference that ``ref_idx`` names) and predicts per-sample
("hyper") weights: the label embedding's decoder kernels and, for the
first ``num_hyper_layers`` up blocks, the first SPADE condition's conv
(and, with ``is_hyper_conv``, the blocks' conv kernels). Two flow
networks warp the reference frame (from the first frame on) and the
previous output frame (once ``num_frames_G - 1`` are known), with the
CUDA ``resample2d`` kernel on the card; the warped frames and their
occlusion masks, embedded, condition the first
``num_multi_spade_layers`` up blocks. The up ladder starts from the
reference encoding.

Every submodule is built at construction, named as the JAX package's
``init_all`` tree, so ``bridge.load_flax_variables`` maps it path for
path. A layer that the JAX package creates only when called without
predicted weights (a ``HyperConv2dBlock``'s ``conv``, a hyper norm's
``gb_0``) does not exist here either. Shared modules (the temporal flow
network and the previous-frame embedding when the config shares them)
are registered once, under the reference branch's name. As in the JAX
generator, the reference is re-encoded and every hyper weight predicted
at every frame, the norm weights that a ``spatially_adaptive`` norm
ignores included (their layers still take spectral-norm steps). NCHW;
reference stacks are (B, K, C, H, W), histories (B, T, C, H, W).

On pose data (``data.for_pose_dataset``) the labels are cut to the
channels the networks read first (``extract_valid_pose_labels``):
OpenPose alone under ``pose_type: open``, else DensePose and OpenPose,
the DensePose face parts of the frame's and the previous labels set to
-1 under ``remove_face_labels`` (the reference labels keep theirs).
"""

from __future__ import annotations

import torch
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import Conv2dBlock, HyperRes2dBlock, LinearBlock, Res2dBlock
from imaginaire_tpu_torch.layers.activation_norm import default_fused_modulation
from imaginaire_tpu_torch.model_utils.fs_vid2vid import (
    extract_valid_pose_labels,
    fold_time,
    pick_image,
    resample,
)
from imaginaire_tpu_torch.models.generators.embedders import LabelEmbedder
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy
from imaginaire_tpu_torch.utils.data import (
    get_crop_or_resize_h_w,
    get_paired_input_image_channel_number,
    get_paired_input_label_channel_number,
)
from imaginaire_tpu_torch.utils.misc import resize_bilinear, upsample_2x


def _conv(cin, cout, kernel_size, wn, an, stride=1):
    return Conv2dBlock(cin, cout, kernel_size=kernel_size, stride=stride,
                       padding=kernel_size // 2, weight_norm_type=wn,
                       activation_norm_type=an, nonlinearity="leakyrelu")


class FSFlowGenerator(nn.Module):
    """Flow and occlusion mask from (label, source labels, source
    images), all concatenated on channels: a downsample trail, a
    residual trunk, an upsample trail, and a flow head (pixels, channel
    0 = dx, times ``flow_output_multiplier``) and a sigmoid mask head."""

    def __init__(self, flow_cfg, num_input_channels, num_img_channels,
                 num_frames, remat="none"):
        super().__init__()
        cfg = as_attrdict(flow_cfg)
        self.num_downsamples = nd = cfg_get(cfg, "num_downsamples", 3)
        ks = cfg_get(cfg, "kernel_size", 3)
        self.num_blocks = cfg_get(cfg, "num_blocks", 6)
        num_filters = cfg_get(cfg, "num_filters", 32)
        max_num_filters = cfg_get(cfg, "max_num_filters", 1024)
        self.multiplier = cfg_get(cfg, "flow_output_multiplier", 20)
        self.sep_up_mask = cfg_get(cfg, "sep_up_mask", False)
        an = cfg_get(cfg, "activation_norm_type", "sync_batch")
        wn = cfg_get(cfg, "weight_norm_type", "spectral")
        self.remat = resolve_policy(remat, where="gen.remat")

        def nf(i):
            return min(max_num_filters, num_filters * (2 ** i))

        cin = num_input_channels + (num_frames - 1) * (num_input_channels
                                                       + num_img_channels)
        self.down_in = _conv(cin, num_filters, ks, wn, an)
        for i in range(nd):
            self.add_module(f"down_{i}", _conv(nf(i) if i else num_filters,
                                               nf(i + 1), ks, wn, an, stride=2))
        for i in range(self.num_blocks):
            self.add_module(f"res_{i}", Res2dBlock(
                nf(nd), nf(nd), kernel_size=ks, padding=ks // 2,
                weight_norm_type=wn, activation_norm_type=an, order="NACNAC"))
        for i in reversed(range(nd)):
            self.add_module(f"up_{i}", _conv(nf(i + 1), nf(i), ks, wn, an))
        self.conv_flow = Conv2dBlock(nf(0), 2, kernel_size=ks, padding=ks // 2)
        if self.sep_up_mask:
            for i in reversed(range(nd)):
                self.add_module(f"up_mask_{i}", _conv(nf(i + 1), nf(i), ks, wn, an))
        self.conv_mask = Conv2dBlock(nf(0), 1, kernel_size=ks, padding=ks // 2,
                                     nonlinearity="sigmoid")

    def forward(self, label, src_label, src_image):
        x = self.down_in(torch.cat([label, src_label, src_image], dim=1))
        for i in range(self.num_downsamples):
            x = getattr(self, f"down_{i}")(x)
        for i in range(self.num_blocks):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x)
        res = x
        for i in reversed(range(self.num_downsamples)):
            x = getattr(self, f"up_{i}")(upsample_2x(x))
        flow = self.conv_flow(x) * self.multiplier
        m = x
        if self.sep_up_mask:
            m = res
            for i in reversed(range(self.num_downsamples)):
                m = getattr(self, f"up_mask_{i}")(upsample_2x(m))
        return flow, self.conv_mask(m)


class AttentionModule(nn.Module):
    """Combine K reference features by attention keyed on the reference
    labels (keys) against the current label (queries), both encoded
    down to the features' resolution."""

    def __init__(self, atn_cfg, num_input_channels, few_shot_K, num_filters_each_layer):
        super().__init__()
        cfg = as_attrdict(atn_cfg)
        num_filters = cfg_get(cfg, "num_filters", 32)
        self.num_downsample_atn = cfg_get(cfg, "num_downsamples", 2)
        wn = cfg_get(cfg, "weight_norm_type", "spectral")
        an = cfg_get(cfg, "activation_norm_type", "instance")
        self.few_shot_K = few_shot_K
        self.atn_query_first = _conv(num_input_channels, num_filters, 3, wn, an)
        self.atn_key_first = _conv(num_input_channels, num_filters, 3, wn, an)
        cin = num_filters
        for i in range(self.num_downsample_atn):
            cout = num_filters_each_layer[i + 1]
            self.add_module(f"atn_key_{i}", _conv(cin, cout, 3, wn, an, stride=2))
            self.add_module(f"atn_query_{i}", _conv(cin, cout, 3, wn, an, stride=2))
            cin = cout

    def _encode(self, x, kind):
        x = getattr(self, f"atn_{kind}_first")(x)
        for i in range(self.num_downsample_atn):
            x = getattr(self, f"atn_{kind}_{i}")(x)
        return x

    @staticmethod
    def _rows(x, b):
        """(B*K, C, h, w) -> (B, K*h*w, C), rows in (k, h, w) order."""
        bk, c, h, w = x.shape
        return x.reshape(b, bk // b, c, h, w).permute(0, 1, 3, 4, 2).reshape(b, -1, c)

    def forward(self, in_features, label, ref_label, attention=None):
        """in_features: (B*K, C, h, w). Returns (combined (B, C, h, w),
        attention (B, K*h*w, h*w), the last sample's first reference's
        attention map (1, 1, h, w))."""
        bk, c, h, w = in_features.shape
        k = self.few_shot_K
        b = bk // k
        if attention is None:
            atn_key = self._rows(self._encode(ref_label, "key"), b)
            atn_query = self._rows(self._encode(label, "query"), b)
            energy = torch.einsum("bkc,bqc->bkq", atn_key, atn_query)
            attention = torch.softmax(energy, dim=1)
        out = torch.einsum("bkc,bkq->bqc", self._rows(in_features, b), attention)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        atn_vis = attention.reshape(b, k, h * w, h * w).sum(dim=2).reshape(b, k, h, w)
        return out, attention, atn_vis[-1:, 0:1]


class WeightGenerator(nn.Module):
    """Encode the reference frames; predict the per-sample weights of the
    hyper layers from them through fully connected stacks."""

    def __init__(self, gen_cfg, data_cfg):
        super().__init__()
        gen_cfg = as_attrdict(gen_cfg)
        data_cfg = as_attrdict(data_cfg)
        num_filters = cfg_get(gen_cfg, "num_filters", 32)
        self.num_downsamples = nd = cfg_get(gen_cfg, "num_downsamples", 5)
        max_num_filters = min(cfg_get(gen_cfg, "max_num_filters", 1024),
                              num_filters * (2 ** nd))
        self.nf = nf = tuple(min(max_num_filters, num_filters * (2 ** i))
                             for i in range(nd + 2))
        hyper_cfg = as_attrdict(cfg_get(gen_cfg, "hyper", {}) or {})
        self.use_hyper_spade = cfg_get(hyper_cfg, "is_hyper_spade", False)
        self.use_hyper_embed = cfg_get(hyper_cfg, "is_hyper_embed", False)
        self.use_hyper_conv = cfg_get(hyper_cfg, "is_hyper_conv", False)
        self.num_hyper_layers = cfg_get(hyper_cfg, "num_hyper_layers", 4)
        if self.num_hyper_layers == -1:
            self.num_hyper_layers = nd
        order = cfg_get(hyper_cfg, "hyper_block_order", "NAC")
        self.conv_before_norm = order.find("C") < order.find("N")
        method = cfg_get(hyper_cfg, "method_to_use_ref_labels", "concat")
        self.concat_ref_label = "concat" in method
        self.mul_ref_label = "mul" in method
        self.sh_fix = self.sw_fix = 32
        num_fc_layers = cfg_get(hyper_cfg, "num_fc_layers", 2)
        embed_cfg = cfg_get(gen_cfg, "embed", None)
        self.embed_arch = cfg_get(embed_cfg, "arch", "encoderdecoder")
        self.embed_kernel_size = cfg_get(embed_cfg, "kernel_size", 3)
        self.spade_kernel_size = cfg_get(
            cfg_get(gen_cfg, "activation_norm_params", {}) or {}, "kernel_size", 1)
        self.conv_kernel_size = cfg_get(gen_cfg, "kernel_size", 3)

        nl = get_paired_input_label_channel_number(data_cfg)
        pose_cfg = as_attrdict(cfg_get(data_cfg, "for_pose_dataset", None) or {})
        if cfg_get(pose_cfg, "pose_type", "both") == "open":
            nl -= 3  # the DensePose channels are dropped before the networks
        self.num_input_channels = nl
        ni = get_paired_input_image_channel_number(data_cfg)
        ks = cfg_get(hyper_cfg, "kernel_size", 3)
        wn = cfg_get(hyper_cfg, "weight_norm_type", "spectral")
        an = cfg_get(hyper_cfg, "activation_norm_type", "instance")

        def encoder(prefix, cin):
            self.add_module(f"{prefix}_first", _conv(cin, num_filters, ks, wn, an))
            for i in range(nd):
                self.add_module(f"{prefix}_down_{i}",
                                _conv(nf[i], nf[i + 1], ks, wn, an, stride=2))
            for i in range(nd):
                self.add_module(f"{prefix}_up_{i}", _conv(nf[i + 1], nf[i], ks, wn, an))

        encoder("ref_img", ni + (nl if self.concat_ref_label else 0))
        if self.mul_ref_label:
            encoder("ref_label", nl)

        # the rows an FC stack reads from encoded level j: the channel
        # correlation's C' columns, or a 32x32 pooled plane
        def rows_dim(j):
            return nf[j] if self.mul_ref_label else self.sh_fix * self.sw_fix

        self.fc_stacks = {}

        def fc_stack(key, in_dim, out_dim, ch_out, name):
            names = []
            for k in range(num_fc_layers):
                self.add_module(f"{name}_fc{k}", LinearBlock(
                    in_dim if k == 0 else ch_out, ch_out, weight_norm_type="spectral",
                    nonlinearity="leakyrelu"))
                names.append(f"{name}_fc{k}")
            self.add_module(f"{name}_out", LinearBlock(
                ch_out if num_fc_layers else in_dim, out_dim, weight_norm_type="spectral"))
            self.fc_stacks[key] = names + [f"{name}_out"]

        sks2, cks2 = self.spade_kernel_size ** 2, self.conv_kernel_size ** 2
        eks2 = self.embed_kernel_size ** 2
        if self.use_hyper_spade or self.use_hyper_conv:
            for i in range(self.num_hyper_layers):
                ch_in, ch_out = nf[i], nf[i + 1]
                spade_ch = nf[i]
                d_norm, d_conv = rows_dim(min(nd, i + 1)), rows_dim(min(nd, i))
                if self.use_hyper_spade:
                    mult0 = 1 if self.conv_before_norm else 2
                    mult1 = 1 if ch_in != ch_out else 2
                    fc_stack(f"spade_0_{i}", d_norm, (spade_ch * sks2 + 1) * mult0,
                             ch_out, f"fc_spade_0_{i}")
                    fc_stack(f"spade_1_{i}", d_norm, (spade_ch * sks2 + 1) * mult1,
                             ch_out, f"fc_spade_1_{i}")
                    fc_stack(f"spade_s_{i}", d_norm, (spade_ch * sks2 + 1) * mult0,
                             ch_out, f"fc_spade_s_{i}")
                    if self.use_hyper_embed:
                        fc_stack(f"spade_e_{i}", d_norm, ch_in * eks2 + 1, ch_out,
                                 f"fc_spade_e_{i}")
                if self.use_hyper_conv:
                    fc_stack(f"conv_0_{i}", d_conv, ch_out * cks2 + 1, ch_out,
                             f"fc_conv_0_{i}")
                    fc_stack(f"conv_1_{i}", d_conv, ch_in * cks2 + 1, ch_out,
                             f"fc_conv_1_{i}")
                    fc_stack(f"conv_s_{i}", d_conv, ch_out + 1, ch_out, f"fc_conv_s_{i}")

        self.label_embedding = LabelEmbedder(
            embed_cfg, nl,
            num_hyper_layers=self.num_hyper_layers if self.use_hyper_embed else 0)
        self.few_shot_K = cfg_get(data_cfg, "initial_few_shot_K", 1)
        atn_cfg = cfg_get(hyper_cfg, "attention", None)
        self.num_downsample_atn = (cfg_get(atn_cfg, "num_downsamples", 2)
                                   if atn_cfg is not None else 0)
        if atn_cfg is not None and self.few_shot_K > 1:
            self.attention_module = AttentionModule(atn_cfg, nl, self.few_shot_K, nf)

    # ------------------------------------------------------------- weights

    def _pool_rows(self, feat):
        """(B, C, C') correlation rows, or (B, C, h, w) resized to 32x32
        (antialiased bilinear, as ``jax.image.resize``) and flattened:
        (B*C, D) rows, B, C."""
        if feat.dim() == 3:
            b, c, d = feat.shape
            return feat.reshape(b * c, d), b, c
        b, c = feat.shape[:2]
        feat = resize_bilinear(feat, (self.sh_fix, self.sw_fix))
        return feat.reshape(b * c, self.sh_fix * self.sw_fix), b, c

    def _predict(self, name, feat, weight_shape):
        """FC stack -> per-sample (kh, kw, cin, cout) kernels and biases:
        each sample's flat vector is read as HWIO, as in the JAX package."""
        rows, b, _ = self._pool_rows(feat)
        for layer in self.fc_stacks[name]:
            rows = getattr(self, layer)(rows)
        flat = rows.reshape(b, -1)
        kh, kw, cin, cout = weight_shape
        numel = kh * kw * cin * cout
        return (flat[:, :numel].reshape(b, kh, kw, cin, cout),
                flat[:, numel:numel + cout])

    def get_norm_weights(self, feat, i):
        ch_in, ch_out = self.nf[i], self.nf[i + 1]
        sks, eks = self.spade_kernel_size, self.embed_kernel_size
        embedding_weights = None
        if self.use_hyper_embed:
            shape = ((eks, eks, ch_out, ch_in) if "decoder" in self.embed_arch
                     else (eks, eks, ch_in, ch_out))
            embedding_weights = self._predict(f"spade_e_{i}", feat, shape)
        out_ch = ch_in if self.conv_before_norm else ch_out
        w0 = self._predict(f"spade_0_{i}", feat, (sks, sks, ch_in, out_ch * 2))
        w1 = self._predict(f"spade_1_{i}", feat, (sks, sks, ch_in, ch_in * 2))
        ws = self._predict(f"spade_s_{i}", feat, (sks, sks, ch_in, out_ch * 2))
        return embedding_weights, [w0, w1, ws]

    def get_conv_weights(self, feat, i):
        ch_in, ch_out = self.nf[i], self.nf[i + 1]
        cks = self.conv_kernel_size
        return [self._predict(f"conv_0_{i}", feat, (cks, cks, ch_out, ch_in)),
                self._predict(f"conv_1_{i}", feat, (cks, cks, ch_in, ch_in)),
                self._predict(f"conv_s_{i}", feat, (1, 1, ch_out, ch_in))]

    # ------------------------------------------------------------- forward

    def encode_reference(self, ref_image, ref_label, label, k):
        if self.concat_ref_label:
            x = self.ref_img_first(torch.cat([ref_image, ref_label], dim=1))
            x_label = None
        else:
            x = self.ref_img_first(ref_image)
            x_label = self.ref_label_first(ref_label) if self.mul_ref_label else None
        atn = atn_vis = ref_idx = None
        for i in range(self.num_downsamples):
            x = getattr(self, f"ref_img_down_{i}")(x)
            if self.mul_ref_label:
                x_label = getattr(self, f"ref_label_down_{i}")(x_label)
            if k > 1 and i == self.num_downsample_atn - 1:
                x, atn, atn_vis = self.attention_module(x, label, ref_label)
                if self.mul_ref_label:
                    x_label, _, _ = self.attention_module(x_label, None, None,
                                                          attention=atn)
                ref_idx = torch.argmax(atn.reshape(label.shape[0], k, -1).sum(dim=2),
                                       dim=1)
        encoded_image_ref = [x]
        encoded_label_ref = [x_label]
        for i in reversed(range(self.num_downsamples)):
            encoded_image_ref.append(getattr(self, f"ref_img_up_{i}")(encoded_image_ref[-1]))
            if self.mul_ref_label:
                encoded_label_ref.append(
                    getattr(self, f"ref_label_up_{i}")(encoded_label_ref[-1]))
        if self.mul_ref_label:
            # (B, C, C') channel correlation pooled over space, the label
            # features softmaxed over their channels
            encoded_ref = [torch.einsum("bchw,bdhw->bcd", conv, torch.softmax(lab, dim=1))
                           for conv, lab in zip(encoded_image_ref, encoded_label_ref)]
        else:
            encoded_ref = encoded_image_ref
        return x, encoded_ref[::-1], atn, atn_vis, ref_idx

    def forward(self, ref_image, ref_label, label):
        b, k = ref_image.shape[:2]
        ref_image_flat = ref_image.reshape((b * k,) + ref_image.shape[2:])
        ref_label_flat = (ref_label.reshape((b * k,) + ref_label.shape[2:])
                          if ref_label is not None else None)
        x, encoded_ref, atn, atn_vis, ref_idx = self.encode_reference(
            ref_image_flat, ref_label_flat, label, k)
        embedding_weights, norm_weights, conv_weights = [], [], []
        last = len(encoded_ref) - 1
        for i in range(self.num_hyper_layers):
            if self.use_hyper_spade:
                ew, nw = self.get_norm_weights(encoded_ref[min(last, i + 1)], i)
                embedding_weights.append(ew)
                norm_weights.append(nw)
            if self.use_hyper_conv:
                conv_weights.append(self.get_conv_weights(encoded_ref[min(last, i)], i))
        encoded_label = self.label_embedding(
            label, weights=embedding_weights if self.use_hyper_embed else None)
        return x, encoded_label, conv_weights, norm_weights, atn, atn_vis, ref_idx


class Generator(nn.Module):
    """Config-driven fs-vid2vid generator (see the module doc)."""

    def __init__(self, gen_cfg, data_cfg):
        super().__init__()
        gen_cfg = as_attrdict(gen_cfg)
        data_cfg = as_attrdict(data_cfg)
        pose_cfg = cfg_get(data_cfg, "for_pose_dataset", None)
        self.is_pose_data = pose_cfg is not None
        self.pose_type = cfg_get(pose_cfg, "pose_type", "both") if self.is_pose_data else "both"
        self.remove_face_labels = (cfg_get(pose_cfg, "remove_face_labels", False)
                                   if self.is_pose_data else False)
        self.num_frames_G = cfg_get(data_cfg, "num_frames_G", 2)
        flow_cfg = as_attrdict(cfg_get(gen_cfg, "flow", {}) or {})
        if cfg_get(flow_cfg, "generate_raw_output", False):
            raise NotImplementedError(
                "gen.flow.generate_raw_output is not in the port yet (ROADMAP.md)")
        self.num_img_channels = ni = get_paired_input_image_channel_number(data_cfg)
        self.num_downsamples = nd = cfg_get(gen_cfg, "num_downsamples", 5)
        ks = cfg_get(gen_cfg, "kernel_size", 3)
        num_filters = cfg_get(gen_cfg, "num_filters", 32)
        max_num_filters = min(cfg_get(gen_cfg, "max_num_filters", 1024),
                              num_filters * (2 ** nd))
        nf = [min(max_num_filters, num_filters * (2 ** i)) for i in range(nd + 2)]
        hyper_cfg = as_attrdict(cfg_get(gen_cfg, "hyper", {}) or {})
        self.use_hyper_spade = cfg_get(hyper_cfg, "is_hyper_spade", False)
        self.use_hyper_conv = cfg_get(hyper_cfg, "is_hyper_conv", False)
        self.num_hyper_layers = cfg_get(hyper_cfg, "num_hyper_layers", 4)
        if self.num_hyper_layers == -1:
            self.num_hyper_layers = nd

        self.weight_generator = WeightGenerator(gen_cfg, data_cfg)
        self.num_input_channels = nl = self.weight_generator.num_input_channels
        msc = as_attrdict(cfg_get(flow_cfg, "multi_spade_combine", {}) or {})
        self.num_multi_spade_layers = cfg_get(msc, "num_layers", 3)
        wn = cfg_get(gen_cfg, "weight_norm_type", "spectral")
        an = cfg_get(gen_cfg, "activation_norm_type", "hyper_spatially_adaptive")
        anp = dict(as_attrdict(cfg_get(gen_cfg, "activation_norm_params", {}) or {}))
        order = cfg_get(hyper_cfg, "hyper_block_order", "NAC")
        remat = cfg_get(gen_cfg, "remat", "none")
        self.remat = resolve_policy(remat, where="gen.remat")
        anp = default_fused_modulation(anp, remat)

        self.warp_ref = cfg_get(flow_cfg, "warp_ref", True)
        img_embed_cfg = cfg_get(msc, "embed", None)
        if self.warp_ref:
            self.flow_network_ref = FSFlowGenerator(flow_cfg, nl, ni, 2, remat=remat)
            self.ref_image_embedding = LabelEmbedder(img_embed_cfg, ni + 1)
        self.sep_prev_flownet = (cfg_get(flow_cfg, "sep_prev_flow", False)
                                 or self.num_frames_G != 2 or not self.warp_ref)
        if self.sep_prev_flownet:
            self.flow_network_temp = FSFlowGenerator(flow_cfg, nl, ni, self.num_frames_G,
                                                     remat=remat)
        self.sep_prev_embedding = (cfg_get(msc, "sep_warp_embed", False)
                                   or not self.warp_ref)
        if self.sep_prev_embedding:
            self.prev_image_embedding = LabelEmbedder(img_embed_cfg, ni + 1)

        label_dims = self.weight_generator.label_embedding.out_channels
        ref_dims = self.ref_image_embedding.out_channels if self.warp_ref else None
        prev_dims = self._prev_embedding().out_channels
        for i in range(nd + 1):
            cond = [label_dims[i]]
            if i < self.num_multi_spade_layers:
                cond += [ref_dims[i] if ref_dims else None, prev_dims[i]]
            hyper = i < self.num_hyper_layers
            self.add_module(f"up_{i}", HyperRes2dBlock(
                nf[i + 1], nf[i], kernel_size=ks, weight_norm_type=wn,
                activation_norm_type=an,
                activation_norm_params=dict(anp, cond_dims=cond), order=order * 2,
                hyper_conv=self.use_hyper_conv and hyper,
                hyper_norm=(self.use_hyper_spade and hyper
                            and an == "hyper_spatially_adaptive")))
        self.conv_img = Conv2dBlock(nf[0], ni, ks, padding=ks // 2,
                                    nonlinearity="leakyrelu", order="AC")
        out_hw = cfg_get(data_cfg, "output_h_w", None)
        if out_hw is not None:
            self.frame_hw = tuple(int(v) for v in str(out_hw).split(","))
        else:
            aug = cfg_get(cfg_get(data_cfg, "val", {}) or {}, "augmentations", {}) or {}
            self.frame_hw = tuple(get_crop_or_resize_h_w(aug))

    def _flow_temp(self):
        return self.flow_network_temp if self.sep_prev_flownet else self.flow_network_ref

    def _prev_embedding(self):
        return (self.prev_image_embedding if self.sep_prev_embedding
                else self.ref_image_embedding)

    def flow_generation(self, label, ref_labels, ref_images, prev_labels,
                        prev_images, ref_idx):
        """Warp the (picked) reference frame and, with a full history, the
        previous output frame: ([flow_ref, flow_prev], [occ_ref,
        occ_prev], [warp_ref, warp_prev], the (warp, mask) conditions),
        None where a branch did not run."""
        ref_label, ref_image = pick_image([ref_labels, ref_images], ref_idx)
        has_prev = (prev_labels is not None
                    and prev_labels.shape[1] == self.num_frames_G - 1)
        flow, occ_mask, img_warp, cond_inputs = [None, None], [None, None], \
            [None, None], [None, None]
        if self.warp_ref:
            flow[0], occ_mask[0] = self.flow_network_ref(label, ref_label, ref_image)
            img_warp[0] = resample(ref_image, flow[0])[:, :3]
            cond_inputs[0] = torch.cat([img_warp[0], occ_mask[0]], dim=1)
        if has_prev:
            flow[1], occ_mask[1] = self._flow_temp()(label, fold_time(prev_labels),
                                                     fold_time(prev_images))
            img_warp[1] = resample(prev_images[:, -1], flow[1])
            cond_inputs[1] = torch.cat([img_warp[1], occ_mask[1]], dim=1)
        return flow, occ_mask, img_warp, cond_inputs

    def forward(self, data):
        """data: label (B, C, H, W); ref_labels / ref_images (B, K, C, H,
        W); prev_labels / prev_images (B, T, C, H, W) or absent. Returns
        the JAX generator's output dict (absent outputs are None)."""
        label = data["label"]
        ref_labels, ref_images = data.get("ref_labels"), data["ref_images"]
        prev_labels, prev_images = data.get("prev_labels"), data.get("prev_images")
        if self.is_pose_data:
            label, prev_labels = extract_valid_pose_labels(
                [label, prev_labels], self.pose_type, self.remove_face_labels)
            ref_labels = extract_valid_pose_labels(
                ref_labels, self.pose_type, self.remove_face_labels, do_remove=False)
        x, encoded_label, conv_weights, norm_weights, _, atn_vis, ref_idx = \
            self.weight_generator(ref_images, ref_labels, label)
        flow, occ_mask, img_warp, cond_inputs = self.flow_generation(
            label, ref_labels, ref_images, prev_labels, prev_images, ref_idx)
        embedded = [self.ref_image_embedding(cond_inputs[0])
                    if cond_inputs[0] is not None else None,
                    self._prev_embedding()(cond_inputs[1])
                    if cond_inputs[1] is not None else None]
        conds = [[e] for e in encoded_label]
        for i in range(self.num_multi_spade_layers):
            conds[i] = conds[i] + [e[i] if e is not None else None for e in embedded]
        for i in range(self.num_downsamples, -1, -1):
            hyper = i < self.num_hyper_layers
            conv_w = (conv_weights[i] if self.use_hyper_conv and hyper
                      else (None, None, None))
            norm_w = (norm_weights[i] if self.use_hyper_spade and hyper
                      else (None, None, None))
            # checkpointed with the predicted weights riding the call: the
            # recompute reads the same tensors, whose gradient reaches the
            # weight generator
            x = call_block(getattr(self, f"up_{i}"), self.remat, x, *conds[i],
                           conv_weights=conv_w, norm_weights=norm_w)
            if i != 0:
                x = upsample_2x(x)
        return {"fake_images": torch.tanh(self.conv_img(x)),
                "fake_flow_maps": flow, "fake_occlusion_masks": occ_mask,
                "fake_raw_images": None, "warped_images": img_warp,
                "attention_visualization": atn_vis, "ref_idx": ref_idx}

    def inference(self, data):
        return self(data)["fake_images"]
