"""Gaussian KL divergence (port of ``imaginaire_tpu/losses/kl.py``).

KL(N(mu, e^logvar) || N(0, 1)) = -0.5 * sum(1 + logvar - mu^2 - e^logvar),
summed as the reference does.
"""

from __future__ import annotations

import torch


def gaussian_kl_loss(mu, logvar=None):
    if logvar is None:
        logvar = torch.zeros_like(mu)
    return -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar))
