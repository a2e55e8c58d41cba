"""FlowNet2 (port of ``imaginaire_tpu/flow/flownet2.py``).

The full cascade: FlowNetC (correlation cost volume) -> FlowNetS1 ->
FlowNetS2 on warped concats, FlowNetSD on the raw pair, and a fusion net
combining both flow branches. Its three primitives are the port's
kernels: ``correlation`` (1 call per forward), ``channelnorm`` (6) and
``resample2d`` (4), each a hand-written CUDA kernel on the card.

NCHW throughout; submodules carry the flax names, so
``bridge.load_flax_variables`` loads a JAX parameter tree (or a
converted ``flownet2.npz``) path for path. Flax infers input widths;
here each layer is built with its input width written out. The channel
orders of every concat and the reference's quirks are kept: FlowNetSD's
flow is divided by ``div_flow`` where the other branches multiply.
``use_batch_norm`` is set by no config and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.ops.channelnorm import channelnorm
from imaginaire_tpu_torch.ops.correlation import correlation
from imaginaire_tpu_torch.ops.resample2d import resample2d
from imaginaire_tpu_torch.utils.misc import (
    fp32_matmuls,
    resize_bilinear,
    resize_nearest,
)


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _refuse_batch_norm(use_batch_norm):
    if use_batch_norm:
        raise NotImplementedError(
            "FlowNet2 with use_batch_norm=True is not in the port (no config "
            "sets it; ROADMAP.md)")


class ConvBlock(nn.Module):
    """conv + leaky ReLU (ref: submodules.py:12-34)."""

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 use_batch_norm=False, activate=True):
        super().__init__()
        _refuse_batch_norm(use_batch_norm)
        pad = (kernel_size - 1) // 2
        self.conv = nn.Conv2d(in_features, features, kernel_size, stride, pad)
        self.activate = activate

    def forward(self, x):
        x = self.conv(x)
        return _leaky(x) if self.activate else x


def _upconv(in_features, features, bias=True):
    # flax ConvTranspose(k4, s2, padding ((2, 2), (2, 2))) == this (the
    # bridge rotates the kernel)
    return nn.ConvTranspose2d(in_features, features, 4, 2, 1, bias=bias)


class Deconv(nn.Module):
    """ConvTranspose k4 s2 p1 + leaky ReLU (ref: submodules.py:69-75)."""

    def __init__(self, in_features, features, use_bias=True, activate=True):
        super().__init__()
        self.deconv = _upconv(in_features, features, use_bias)
        self.activate = activate

    def forward(self, x):
        x = self.deconv(x)
        return _leaky(x) if self.activate else x


class PredictFlow(nn.Module):
    """3x3 conv to 2 channels (ref: submodules.py:64-66)."""

    def __init__(self, in_features):
        super().__init__()
        self.conv = nn.Conv2d(in_features, 2, 3, 1, 1)

    def forward(self, x):
        return self.conv(x)


class _Refine(nn.Module):
    """Shared S/C decoder rung: predict flow, upsample it, deconv the
    features, concat (ref: flownet_s.py:96-117)."""

    def __init__(self, in_features, deconv_features, upflow_bias=True):
        super().__init__()
        self.predict = PredictFlow(in_features)
        self.upflow = _upconv(2, 2, upflow_bias)
        self.deconv = Deconv(in_features, deconv_features)

    def forward(self, feat, skip):
        flow = self.predict(feat)
        return flow, torch.cat([skip, self.deconv(feat), self.upflow(flow)], 1)


class FlowNetC(nn.Module):
    """(ref: flownet_c.py:14-160)."""

    def __init__(self, use_batch_norm=False):
        super().__init__()
        _refuse_batch_norm(use_batch_norm)
        self.conv1 = ConvBlock(3, 64, 7, 2)
        self.conv2 = ConvBlock(64, 128, 5, 2)
        self.conv3 = ConvBlock(128, 256, 5, 2)
        self.conv_redir = ConvBlock(256, 32, 1, 1)
        self.conv3_1 = ConvBlock(32 + 441, 256)
        self.conv4 = ConvBlock(256, 512, 3, 2)
        self.conv4_1 = ConvBlock(512, 512)
        self.conv5 = ConvBlock(512, 512, 3, 2)
        self.conv5_1 = ConvBlock(512, 512)
        self.conv6 = ConvBlock(512, 1024, 3, 2)
        self.conv6_1 = ConvBlock(1024, 1024)
        self.refine5 = _Refine(1024, 512)
        self.refine4 = _Refine(1026, 256)
        self.refine3 = _Refine(770, 128)
        self.refine2 = _Refine(386, 64)
        self.predict_flow2 = PredictFlow(194)

    def forward(self, x):
        x1, x2 = x[:, 0:3], x[:, 3:]
        out_conv2a = self.conv2(self.conv1(x1))
        out_conv3a = self.conv3(out_conv2a)
        out_conv3b = self.conv3(self.conv2(self.conv1(x2)))
        out_corr = _leaky(correlation(
            out_conv3a.contiguous(), out_conv3b.contiguous(), pad_size=20,
            kernel_size=1, max_displacement=20, stride1=1, stride2=2))
        x = torch.cat([self.conv_redir(out_conv3a), out_corr], 1)
        out_conv3_1 = self.conv3_1(x)
        out_conv4 = self.conv4_1(self.conv4(out_conv3_1))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        flow6, concat5 = self.refine5(out_conv6, out_conv5)
        flow5, concat4 = self.refine4(concat5, out_conv4)
        flow4, concat3 = self.refine3(concat4, out_conv3_1)
        flow3, concat2 = self.refine2(concat3, out_conv2a)
        return self.predict_flow2(concat2), flow3, flow4, flow5, flow6


class FlowNetS(nn.Module):
    """(ref: flownet_s.py:16-121)."""

    def __init__(self, input_channels=12, use_batch_norm=False):
        super().__init__()
        _refuse_batch_norm(use_batch_norm)
        self.conv1 = ConvBlock(input_channels, 64, 7, 2)
        self.conv2 = ConvBlock(64, 128, 5, 2)
        self.conv3 = ConvBlock(128, 256, 5, 2)
        self.conv3_1 = ConvBlock(256, 256)
        self.conv4 = ConvBlock(256, 512, 3, 2)
        self.conv4_1 = ConvBlock(512, 512)
        self.conv5 = ConvBlock(512, 512, 3, 2)
        self.conv5_1 = ConvBlock(512, 512)
        self.conv6 = ConvBlock(512, 1024, 3, 2)
        self.conv6_1 = ConvBlock(1024, 1024)
        # the S variant's flow upsamplers have no bias (ref: flownet_s.py:58-66)
        self.refine5 = _Refine(1024, 512, upflow_bias=False)
        self.refine4 = _Refine(1026, 256, upflow_bias=False)
        self.refine3 = _Refine(770, 128, upflow_bias=False)
        self.refine2 = _Refine(386, 64, upflow_bias=False)
        self.predict_flow2 = PredictFlow(194)

    def forward(self, x):
        out_conv2 = self.conv2(self.conv1(x))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        flow6, concat5 = self.refine5(out_conv6, out_conv5)
        flow5, concat4 = self.refine4(concat5, out_conv4)
        flow4, concat3 = self.refine3(concat4, out_conv3)
        flow3, concat2 = self.refine2(concat3, out_conv2)
        return self.predict_flow2(concat2), flow3, flow4, flow5, flow6


class _RefineSD(nn.Module):
    """SD/fusion rung with an intermediate conv before flow prediction
    (ref: flownet_sd.py:100-118)."""

    def __init__(self, in_features, inter_features, deconv_features):
        super().__init__()
        self.inter = ConvBlock(in_features, inter_features, activate=False)
        self.predict = PredictFlow(inter_features)
        self.upflow = _upconv(2, 2)
        self.deconv = Deconv(in_features, deconv_features)

    def forward(self, feat, skip):
        flow = self.predict(self.inter(feat))
        return flow, torch.cat([skip, self.deconv(feat), self.upflow(flow)], 1)


class FlowNetSD(nn.Module):
    """(ref: flownet_sd.py:13-121)."""

    def __init__(self, use_batch_norm=False):
        super().__init__()
        _refuse_batch_norm(use_batch_norm)
        self.conv0 = ConvBlock(6, 64)
        self.conv1 = ConvBlock(64, 64, 3, 2)
        self.conv1_1 = ConvBlock(64, 128)
        self.conv2 = ConvBlock(128, 128, 3, 2)
        self.conv2_1 = ConvBlock(128, 128)
        self.conv3 = ConvBlock(128, 256, 3, 2)
        self.conv3_1 = ConvBlock(256, 256)
        self.conv4 = ConvBlock(256, 512, 3, 2)
        self.conv4_1 = ConvBlock(512, 512)
        self.conv5 = ConvBlock(512, 512, 3, 2)
        self.conv5_1 = ConvBlock(512, 512)
        self.conv6 = ConvBlock(512, 1024, 3, 2)
        self.conv6_1 = ConvBlock(1024, 1024)
        self.predict_flow6 = PredictFlow(1024)
        self.upflow6 = _upconv(2, 2)
        self.deconv5 = Deconv(1024, 512)
        self.refine4 = _RefineSD(1026, 512, 256)
        self.refine3 = _RefineSD(770, 256, 128)
        self.refine2 = _RefineSD(386, 128, 64)
        self.inter_conv2 = ConvBlock(194, 64, activate=False)
        self.predict_flow2 = PredictFlow(64)

    def forward(self, x):
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        flow6 = self.predict_flow6(out_conv6)
        concat5 = torch.cat([out_conv5, self.deconv5(out_conv6),
                             self.upflow6(flow6)], 1)
        flow5, concat4 = self.refine4(concat5, out_conv4)
        flow4, concat3 = self.refine3(concat4, out_conv3)
        flow3, concat2 = self.refine2(concat3, out_conv2)
        flow2 = self.predict_flow2(self.inter_conv2(concat2))
        return flow2, flow3, flow4, flow5, flow6


class FlowNetFusion(nn.Module):
    """(ref: flownet_fusion.py:13-85)."""

    def __init__(self, use_batch_norm=False):
        super().__init__()
        _refuse_batch_norm(use_batch_norm)
        self.conv0 = ConvBlock(11, 64)
        self.conv1 = ConvBlock(64, 64, 3, 2)
        self.conv1_1 = ConvBlock(64, 128)
        self.conv2 = ConvBlock(128, 128, 3, 2)
        self.conv2_1 = ConvBlock(128, 128)
        self.predict_flow2 = PredictFlow(128)
        self.upflow2 = _upconv(2, 2)
        self.deconv1 = Deconv(128, 32)
        self.inter_conv1 = ConvBlock(162, 32, activate=False)
        self.predict_flow1 = PredictFlow(32)
        self.upflow1 = _upconv(2, 2)
        self.deconv0 = Deconv(162, 16)
        self.inter_conv0 = ConvBlock(82, 16, activate=False)
        self.predict_flow0 = PredictFlow(16)

    def forward(self, x):
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        flow2 = self.predict_flow2(out_conv2)
        concat1 = torch.cat([out_conv1, self.deconv1(out_conv2),
                             self.upflow2(flow2)], 1)
        flow1 = self.predict_flow1(self.inter_conv1(concat1))
        concat0 = torch.cat([out_conv0, self.deconv0(concat1),
                             self.upflow1(flow1)], 1)
        return self.predict_flow0(self.inter_conv0(concat0))


def _up4(x, method="bilinear"):
    h, w = x.shape[-2:]
    if method == "nearest":
        return resize_nearest(x, (4 * h, 4 * w))
    # full fp32 resize matmuls: TF32 moves flows of tens of pixels ~0.05 px
    with fp32_matmuls():
        return resize_bilinear(x, (4 * h, 4 * w)).contiguous()


class FlowNet2(nn.Module):
    """The full cascade (ref: models.py:20-173). Input: two images
    stacked on a time axis, (B, 2, 3, H, W) in [0, rgb_max], H and W
    multiples of 64; output: pixel-unit flow (B, 2, H, W), channel 0 = x."""

    def __init__(self, rgb_max=1.0, div_flow=20.0, use_batch_norm=False):
        super().__init__()
        _refuse_batch_norm(use_batch_norm)
        self.rgb_max = rgb_max
        self.div_flow = div_flow
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS(12)
        self.flownets_2 = FlowNetS(12)
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    def forward(self, inputs):
        rgb_mean = inputs.mean(dim=(1, 3, 4), keepdim=True)
        x = (inputs - rgb_mean) / self.rgb_max
        x1, x2 = x[:, 0].contiguous(), x[:, 1].contiguous()
        x = torch.cat([x1, x2], 1)
        div = self.div_flow

        flownetc_flow = _up4(self.flownetc(x)[0] * div)
        resampled_img1 = resample2d(x2, flownetc_flow)
        norm_diff_img0 = channelnorm(x1 - resampled_img1)
        concat1 = torch.cat([x, resampled_img1, flownetc_flow / div,
                             norm_diff_img0], 1)

        flownets1_flow = _up4(self.flownets_1(concat1)[0] * div)
        resampled_img1 = resample2d(x2, flownets1_flow)
        norm_diff_img0 = channelnorm(x1 - resampled_img1)
        concat2 = torch.cat([x, resampled_img1, flownets1_flow / div,
                             norm_diff_img0], 1)

        flownets2_flow = _up4(self.flownets_2(concat2)[0] * div, "nearest")
        norm_flownets2_flow = channelnorm(flownets2_flow)
        diff_flownets2_img1 = channelnorm(x1 - resample2d(x2, flownets2_flow))

        flownetsd_flow = _up4(self.flownets_d(x)[0] / div, "nearest")
        norm_flownetsd_flow = channelnorm(flownetsd_flow)
        diff_flownetsd_img1 = channelnorm(x1 - resample2d(x2, flownetsd_flow))

        concat3 = torch.cat([x1, flownetsd_flow, flownets2_flow,
                             norm_flownetsd_flow, norm_flownets2_flow,
                             diff_flownetsd_img1, diff_flownets2_img1], 1)
        return self.flownetfusion(concat3)
