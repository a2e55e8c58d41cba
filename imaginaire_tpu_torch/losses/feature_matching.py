"""Feature-matching loss (port of ``imaginaire_tpu/losses/feature_matching.py``).

L1 (or L2) between the discriminator features of the fake and the real
images, summed over layers and weighted 1 / (number of discriminators);
the real features are detached. ``sample_weight`` (B,) turns each
layer's mean into a per-sample weighted mean, as the GAN loss's
(``losses/gan.py:_weighted_mean``): region discriminators weight out the
samples whose region is absent.
"""

from __future__ import annotations

import torch

from imaginaire_tpu_torch.losses.gan import _weighted_mean


def feature_matching_loss(fake_features, real_features, criterion="l1",
                          sample_weight=None):
    """fake_features / real_features: list (per D) of lists (per layer)."""
    dis_weight = 1.0 / len(fake_features)
    loss = torch.zeros((), device=fake_features[0][0].device)
    for fake_per_d, real_per_d in zip(fake_features, real_features):
        for fake_f, real_f in zip(fake_per_d, real_per_d):
            if criterion == "l1":
                diff = (fake_f - real_f.detach()).abs()
            elif criterion in ("l2", "mse"):
                diff = (fake_f - real_f.detach()) ** 2
            else:
                raise ValueError(f"Criterion {criterion} is not recognized")
            loss = loss + dis_weight * _weighted_mean(diff, sample_weight)
    return loss
