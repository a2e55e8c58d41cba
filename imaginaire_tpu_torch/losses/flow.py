"""Flow and occlusion-mask losses (port of
``imaginaire_tpu/losses/flow.py:27-142``).

``masked_l1_loss`` is the reference's MaskedL1Loss, which the vid2vid
trainer uses alone when it has no teacher (warp consistency).
``FlowLoss`` is the full version: ground-truth flow and confidence come
from a frozen flow network called inside the loss (an injected callable
``flow_net(im_a, im_b) -> (flow, conf)``, run under ``torch.no_grad()``)
or arrive with the data (``flow_gt`` / ``conf_gt``, from the teacher's
cache), then an L1 on the flow weighted by the confidence, an L1 of the
warped frame against the target, and the occlusion mask's loss.

NCHW; flows are (B, 2, H, W) in pixels. ``warp_ref`` (reference-to-target
warping) belongs to fs-vid2vid and raises.
"""

from __future__ import annotations

import torch


def masked_l1_loss(x, target, mask, normalize_over_valid=False):
    """L1 of mask-weighted tensors; the mask broadcasts against x. The
    mean is over all elements unless ``normalize_over_valid``, which
    rescales by numel / sum(mask)."""
    mask = torch.broadcast_to(torch.as_tensor(mask, device=x.device), x.shape)
    loss = (x * mask - target * mask).abs().mean()
    if normalize_over_valid:
        loss = loss * mask.numel() / (mask.sum() + 1e-6)
    return loss


def _l1(a, b):
    return (a - b).abs().mean()


class FlowLoss:
    """Flow supervision: ``flow_net`` is the frozen ``(im_a, im_b) ->
    (flow, conf)`` estimator, or None when the ground truth comes with
    the data (``flow_gt`` / ``conf_gt``) or there is none. ``has_fg``
    weights the flow L1 by ``data['fg_mask']``."""

    def __init__(self, flow_net, warp_ref=False, has_fg=False):
        if warp_ref:
            raise NotImplementedError(
                "FlowLoss(warp_ref=True), the reference-to-target warp of "
                "fs-vid2vid, is not in the port yet (ROADMAP.md)")
        self.flow_net = flow_net
        self.has_fg = has_fg

    def __call__(self, data, net_G_output, compute_prev=True):
        """(loss_flow_L1, loss_flow_warp, loss_mask). data: 'image' (the
        target), optional 'real_prev_image', 'flow_gt' / 'conf_gt',
        'fg_mask'; net_G_output: 'warped_images', 'fake_flow_maps',
        'fake_occlusion_masks'."""
        tgt_image = data["image"]
        warped = net_G_output["warped_images"]
        flow = net_G_output["fake_flow_maps"]
        occ_mask = net_G_output["fake_occlusion_masks"]
        fg_mask = data.get("fg_mask", 1.0) if self.has_fg else 1.0

        flow_gt = conf_gt = None
        if compute_prev and data.get("flow_gt") is not None:
            flow_gt, conf_gt = data["flow_gt"].detach(), data["conf_gt"].detach()
        elif compute_prev and data.get("real_prev_image") is not None \
                and self.flow_net is not None:
            flow_gt, conf_gt = self._gt(tgt_image, data["real_prev_image"])

        device = tgt_image.device
        loss_flow_l1 = torch.zeros((), device=device)
        loss_flow_warp = torch.zeros((), device=device)
        # the L1 and warp terms come with a ground-truth pair (the JAX
        # loss zips them with its ground truths: none, no terms)
        if flow_gt is not None:
            if flow is not None:
                loss_flow_l1 = loss_flow_l1 + masked_l1_loss(flow, flow_gt,
                                                             conf_gt * fg_mask)
            if warped is not None:
                loss_flow_warp = loss_flow_warp + _l1(warped, tgt_image)
        # the terms accumulate onto fp32 zeros, as in the JAX loss
        loss_mask = torch.zeros((), device=device) + self._mask_loss(
            occ_mask, warped, tgt_image)
        return loss_flow_l1, loss_flow_warp, loss_mask

    def _gt(self, im_a, im_b):
        with torch.no_grad():
            flow, conf = self.flow_net(im_a, im_b)
        return flow.detach(), conf.detach()

    @staticmethod
    def _mask_loss(occ_mask, warped_image, tgt_image):
        """The occlusion mask pushed towards 0 where the warp already
        matches the target and towards 1 where it does not."""
        if occ_mask is None:
            return torch.zeros((), device=tgt_image.device)
        img_diff = (warped_image - tgt_image).abs().sum(dim=1, keepdim=True)
        conf = torch.clamp(1.0 - img_diff, 0.0, 1.0)
        loss = masked_l1_loss(occ_mask, torch.zeros_like(occ_mask), conf)
        return loss + masked_l1_loss(occ_mask, torch.ones_like(occ_mask), 1.0 - conf)
