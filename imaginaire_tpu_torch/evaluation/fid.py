"""FID (port of ``imaginaire_tpu/evaluation/fid.py``).

Activations come from ``common.get_activations``; the mean and
covariance and the Frechet distance are computed on the host in numpy
and ``scipy.linalg.sqrtm``, as in the JAX package. The real set's
statistics are cached in an ``.npz`` tagged with the feature graph's
version; a cache of another version is recomputed.
"""

from __future__ import annotations

import os

import numpy as np

from imaginaire_tpu_torch.evaluation.common import get_activations

# the version of the Inception feature graph a cache was computed with
# (the JAX package's constant: the two graphs are the same)
FEATURE_GRAPH_VERSION = 2


def activation_stats(acts):
    mu = np.mean(acts, axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)). A non-finite
    ``sqrtm`` is retried with ``eps`` on both diagonals; an imaginary
    part is dropped (reported when its diagonal is not ~0). ``sqrtm`` is
    called without the ``disp`` argument the JAX package passes: newer
    SciPy has removed it, and it changes no value."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            print(f"FID: imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def load_or_compute_stats(path, data_loader, key_real, key_fake, extractor,
                          generator_fn=None, max_batches=None):
    """(mu, sigma) of a sweep. Fake statistics (``generator_fn``) are
    always computed; real ones load from ``path`` when it holds this
    graph version's, else are computed and written there."""
    if path and os.path.exists(path) and generator_fn is None:
        npz = np.load(path)
        version = int(npz["graph_version"]) if "graph_version" in npz else 0
        if version == FEATURE_GRAPH_VERSION:
            return npz["mu"], npz["sigma"]
        print(f"FID: stale real-stat cache at {path} (feature graph "
              f"v{version} != v{FEATURE_GRAPH_VERSION}), recomputing")
    acts = get_activations(data_loader, key_real, key_fake, extractor,
                           generator_fn=generator_fn, max_batches=max_batches)
    mu, sigma = activation_stats(acts)
    if path and generator_fn is None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, mu=mu, sigma=sigma, graph_version=FEATURE_GRAPH_VERSION)
        print(f"FID: cached real stats to {path}")
    return mu, sigma


def compute_fid(fid_path, data_loader, extractor, generator_fn,
                key_real="images", key_fake="fake_images", max_batches=None):
    """FID of ``generator_fn``'s images over ``data_loader`` against the
    loader's real images (their statistics cached at ``fid_path``)."""
    mu_fake, sigma_fake = load_or_compute_stats(
        None, data_loader, key_real, key_fake, extractor,
        generator_fn=generator_fn, max_batches=max_batches)
    mu_real, sigma_real = load_or_compute_stats(
        fid_path, data_loader, key_real, key_fake, extractor,
        max_batches=max_batches)
    return calculate_frechet_distance(mu_fake, sigma_fake, mu_real, sigma_real)
