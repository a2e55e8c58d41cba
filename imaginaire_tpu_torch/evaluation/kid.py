"""KID: the unbiased polynomial-kernel MMD^2 over Inception activations,
k(x, y) = (x.y / d + 1)^3, averaged over random subsets (port of
``imaginaire_tpu/evaluation/kid.py``). The subsets are drawn from
``np.random.RandomState(seed)``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def polynomial_kernel(x, y, degree=3, gamma=None, coef0=1.0):
    d = x.shape[1]
    gamma = gamma if gamma is not None else 1.0 / d
    return (x @ y.T * gamma + coef0) ** degree


def polynomial_mmd(x, y, degree=3, gamma=None, coef0=1.0):
    """Unbiased MMD^2 estimate."""
    kxx = polynomial_kernel(x, x, degree, gamma, coef0)
    kyy = polynomial_kernel(y, y, degree, gamma, coef0)
    kxy = polynomial_kernel(x, y, degree, gamma, coef0)
    m, n = x.shape[0], y.shape[0]
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    return sum_xx + sum_yy - 2 * kxy.mean()


def kid_from_activations(act_real, act_fake, num_subsets=100,
                         subset_size=1000, seed=0):
    rng = np.random.RandomState(seed)
    n = min(subset_size, act_real.shape[0], act_fake.shape[0])
    vals = []
    for _ in range(num_subsets):
        r = act_real[rng.choice(act_real.shape[0], n, replace=False)]
        f = act_fake[rng.choice(act_fake.shape[0], n, replace=False)]
        vals.append(polynomial_mmd(r, f))
    return float(np.mean(vals))
