"""GAN objectives (port of ``imaginaire_tpu/losses/gan.py``).

Four modes: hinge, least_square, non_saturated and wasserstein. A
multi-scale discriminator passes a list of per-scale logits; the loss
is averaged per scale first, then across scales. ``sample_weight`` (B,)
turns each mean into a per-sample weighted mean, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GAN_MODES = ("hinge", "least_square", "non_saturated", "wasserstein")


def _weighted_mean(loss, sample_weight):
    """Mean over all elements, or the per-sample means weighted by
    ``sample_weight`` over their sum (floored at 1e-6)."""
    if sample_weight is None:
        return loss.mean()
    per_sample = loss.reshape(loss.shape[0], -1).mean(dim=-1)
    return (per_sample * sample_weight).sum() / torch.clamp_min(sample_weight.sum(), 1e-6)


def _single_gan_loss(logits, t_real, mode, dis_update, real_label, fake_label,
                     sample_weight=None):
    if not dis_update and not t_real:
        raise ValueError("The target should be real when updating the generator.")
    if mode == "non_saturated":
        target = torch.full_like(logits, real_label if t_real else fake_label)
        loss = F.binary_cross_entropy_with_logits(logits, target, reduction="none")
        return _weighted_mean(loss, sample_weight)
    if mode == "least_square":
        target = real_label if t_real else fake_label
        return 0.5 * _weighted_mean((logits - target) ** 2, sample_weight)
    if mode == "hinge":
        if not dis_update:
            return -_weighted_mean(logits, sample_weight)
        if t_real:
            return -_weighted_mean(torch.clamp_max(logits - 1.0, 0.0), sample_weight)
        return -_weighted_mean(torch.clamp_max(-logits - 1.0, 0.0), sample_weight)
    if mode == "wasserstein":
        m = _weighted_mean(logits, sample_weight)
        return -m if t_real else m
    raise ValueError(f"Unexpected gan_mode {mode!r}")


def gan_loss(dis_output, t_real, gan_mode="hinge", dis_update=True,
             target_real_label=1.0, target_fake_label=0.0, sample_weight=None):
    """The GAN loss of a logits tensor or a list of per-scale tensors: the
    discriminator's form with ``dis_update``, else the generator's (whose
    target must be real)."""
    if isinstance(dis_output, (list, tuple)):
        per_scale = [_single_gan_loss(o, t_real, gan_mode, dis_update, target_real_label,
                                      target_fake_label, sample_weight)
                     for o in dis_output]
        return sum(per_scale) / len(per_scale)
    return _single_gan_loss(dis_output, t_real, gan_mode, dis_update, target_real_label,
                            target_fake_label, sample_weight)


def dis_accuracy(real_outputs, fake_outputs, gan_mode="hinge",
                 target_real_label=1.0, target_fake_label=0.0):
    """(real_acc, fake_acc): the fraction of logits on the correct side
    of the boundary (real above it, fake at or below it), scales and
    nested lists averaged equally. The boundary is 0, and the labels'
    midpoint for least_square."""
    thr = (0.5 * (target_real_label + target_fake_label)
           if gan_mode == "least_square" else 0.0)

    def frac(out, is_real):
        if isinstance(out, (list, tuple)):
            per_scale = [frac(o, is_real) for o in out]
            return sum(per_scale) / len(per_scale)
        correct = (out > thr) if is_real else (out <= thr)
        return correct.float().mean()

    return frac(real_outputs, True), frac(fake_outputs, False)
