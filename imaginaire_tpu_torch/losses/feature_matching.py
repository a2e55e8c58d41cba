"""Feature-matching loss (port of ``imaginaire_tpu/losses/feature_matching.py``).

L1 between the discriminator features of the fake and the real images,
summed over layers and weighted 1 / (number of discriminators); the real
features are detached.
"""

from __future__ import annotations

import torch


def feature_matching_loss(fake_features, real_features):
    """fake_features / real_features: list (per D) of lists (per layer)."""
    dis_weight = 1.0 / len(fake_features)
    loss = torch.zeros((), device=fake_features[0][0].device)
    for fake_per_d, real_per_d in zip(fake_features, real_features):
        for fake_f, real_f in zip(fake_per_d, real_per_d):
            loss = loss + dis_weight * (fake_f - real_f.detach()).abs().mean()
    return loss
