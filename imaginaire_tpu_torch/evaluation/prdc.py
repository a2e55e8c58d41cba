"""PRDC: precision, recall, density and coverage from k-NN radii (port of
``imaginaire_tpu/evaluation/prdc.py``; Naeem et al. 2020).

precision: the share of fake samples inside any real k-NN ball; recall:
of real samples inside any fake ball; density: the mean count of real
balls holding a fake sample, over k; coverage: the share of real balls
holding at least one fake sample.
"""

from __future__ import annotations

import numpy as np


def _pairwise_distances(a, b):
    aa = np.sum(a * a, axis=1, keepdims=True)
    bb = np.sum(b * b, axis=1, keepdims=True)
    d2 = aa + bb.T - 2 * (a @ b.T)
    return np.sqrt(np.maximum(d2, 0.0))


def _kth_nn_radius(x, k):
    d = _pairwise_distances(x, x)
    np.fill_diagonal(d, np.inf)
    return np.sort(d, axis=1)[:, k - 1]


def prdc_from_activations(act_real, act_fake, nearest_k=5):
    # n points have at most n - 1 neighbours: k is clamped for tiny sets
    nearest_k = max(1, min(nearest_k, act_real.shape[0] - 1, act_fake.shape[0] - 1))
    radii_real = _kth_nn_radius(act_real, nearest_k)
    radii_fake = _kth_nn_radius(act_fake, nearest_k)
    d_rf = _pairwise_distances(act_real, act_fake)  # (Nr, Nf)
    in_real_ball = d_rf < radii_real[:, None]
    precision = float(in_real_ball.any(axis=0).mean())
    recall = float((d_rf < radii_fake[None, :]).any(axis=1).mean())
    density = float(in_real_ball.sum(axis=0).mean() / nearest_k)
    coverage = float((d_rf.min(axis=1) < radii_real).mean())
    return {"precision": precision, "recall": recall,
            "density": density, "coverage": coverage}
