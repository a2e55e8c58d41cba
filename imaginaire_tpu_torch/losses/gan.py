"""GAN objectives (port of ``imaginaire_tpu/losses/gan.py``), hinge mode.

A multi-scale discriminator passes a list of per-scale logits; the loss
is averaged per scale first, then across scales. The JAX package's other
modes (least_square, non_saturated, wasserstein) raise here.
"""

from __future__ import annotations

import torch


def _check_mode(mode):
    if mode != "hinge":
        raise NotImplementedError(f"gan_mode {mode!r} is not in the port yet "
                                  f"(ROADMAP.md); it has 'hinge'")


def _single_gan_loss(logits, t_real, dis_update):
    if not dis_update and not t_real:
        raise ValueError("The target should be real when updating the generator.")
    if not dis_update:
        return -logits.mean()
    if t_real:
        return -torch.clamp_max(logits - 1.0, 0.0).mean()
    return -torch.clamp_max(-logits - 1.0, 0.0).mean()


def gan_loss(dis_output, t_real, gan_mode="hinge", dis_update=True):
    """Hinge loss over a logits tensor or a list of per-scale tensors:
    ``-mean(min(x - 1, 0))`` for real and ``-mean(min(-x - 1, 0))`` for
    fake logits in the D step, ``-mean(x)`` in the G step."""
    _check_mode(gan_mode)
    if isinstance(dis_output, (list, tuple)):
        per_scale = [_single_gan_loss(o, t_real, dis_update) for o in dis_output]
        return sum(per_scale) / len(per_scale)
    return _single_gan_loss(dis_output, t_real, dis_update)


def dis_accuracy(real_outputs, fake_outputs, gan_mode="hinge"):
    """(real_acc, fake_acc): the fraction of logits on the correct side
    of 0 (real > 0, fake <= 0), scales averaged equally."""
    _check_mode(gan_mode)

    def frac(out, is_real):
        if isinstance(out, (list, tuple)):
            per_scale = [frac(o, is_real) for o in out]
            return sum(per_scale) / len(per_scale)
        correct = (out > 0.0) if is_real else (out <= 0.0)
        return correct.float().mean()

    return frac(real_outputs, True), frac(fake_outputs, False)
