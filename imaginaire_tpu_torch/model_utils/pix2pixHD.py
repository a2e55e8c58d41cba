"""pix2pixHD model utilities (port of ``imaginaire_tpu/model_utils/pix2pixHD.py``).

- ``instance_average``: every pixel's feature replaced by its instance's
  mean, on the device (``torch.unique`` + ``index_add``, one segment an
  id of the ``max_instances`` smallest, one overflow segment for the
  rest), differentiable, NCHW.
- ``get_edges``: the instance-boundary map of an id map, host numpy
  (NHWC), computed before any cast: in bf16 neighbouring Cityscapes ids
  such as 26001 and 26002 are the same number.
- ``instance_labels``, ``collect_instance_features``: per-instance
  (feature, area share) rows grouped by label, host numpy.
- ``kmeans``: the port's own K-means (k-means++ seeding, Lloyd
  iterations, ``n_init`` restarts keeping the lowest inertia, from an
  explicit seed), numpy on the host, where the JAX package calls
  ``sklearn.cluster.KMeans(random_state=0, n_init=10)``; the card's
  machine has no scikit-learn.
- ``cluster_features``: K-means over an encoder's instance features,
  label by label.
- ``sample_feature_map``: a random cluster center of its label painted
  over each instance, from ``np.random.RandomState(seed)``; the JAX
  function draws that integer seed from its key.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# K-means: restarts, Lloyd iterations at most, and the convergence bound
# on the centers' summed squared shift relative to the data's mean
# per-feature variance (scikit-learn's defaults)
KMEANS_RESTARTS, KMEANS_MAX_ITER, KMEANS_TOL = 10, 300, 1e-4


def instance_average(features, instance_map, max_instances=64):
    """Replace each pixel's feature with its instance's mean feature.

    features: (B, C, H, W); instance_map: (B, H, W) or (B, 1, H, W) of
    integer-valued ids (any range). The ``max_instances`` smallest ids of
    a sample keep their own segment; any other id shares one overflow
    segment, never a real instance's mean. The sums run in fp32 at least
    and the result takes the features' type."""
    if instance_map.dim() == 4:
        instance_map = instance_map[:, 0]
    b, c, h, w = features.shape
    ids = instance_map.reshape(b, -1).long()
    segments = max_instances + 1
    seg = torch.empty_like(ids)
    for n in range(b):
        kept = torch.unique(ids[n])[:max_instances]
        pos = torch.searchsorted(kept, ids[n]).clamp_max(kept.numel() - 1)
        seg[n] = torch.where(kept[pos] == ids[n], pos,
                             torch.full_like(pos, max_instances))
    seg = seg + torch.arange(b, device=ids.device)[:, None] * segments
    acc = torch.promote_types(features.dtype, torch.float32)
    flat = features.to(acc).permute(0, 2, 3, 1).reshape(b * h * w, c)
    seg = seg.reshape(-1)
    sums = flat.new_zeros(b * segments, c).index_add(0, seg, flat)
    counts = flat.new_zeros(b * segments).index_add(0, seg, flat.new_ones(seg.numel()))
    means = sums / counts.clamp_min(1.0)[:, None]
    out = means[seg].reshape(b, h, w, c).permute(0, 3, 1, 2)
    return out.to(features.dtype)


def get_edges(instance_map):
    """Instance-boundary map: (B, H, W, 1) ids (numpy, any integer or
    exact float type) -> float32 (B, H, W, 1), 1.0 where a horizontal or
    vertical neighbour has another id."""
    t = np.asarray(instance_map)
    dw = t[:, :, 1:] != t[:, :, :-1]
    dh = t[:, 1:, :] != t[:, :-1, :]
    edge = np.zeros(t.shape, bool)
    edge[:, :, 1:] |= dw
    edge[:, :, :-1] |= dw
    edge[:, 1:, :] |= dh
    edge[:, :-1, :] |= dh
    return edge.astype(np.float32)


def instance_labels(instance_ids, is_cityscapes=True):
    """Raw instance ids -> semantic label ids (Cityscapes packs things as
    label x 1000 + k and keeps stuff ids below 1000)."""
    ids = np.asarray(instance_ids, np.int64)
    if is_cityscapes:
        return np.where(ids >= 1000, ids // 1000, ids)
    return ids


def collect_instance_features(feat_map, instance_map, label_nc, is_cityscapes=True):
    """Per-instance (feature, area share) rows grouped by label, host numpy.

    feat_map: (B, C, H, W) instance-pooled features (constant inside an
    instance); instance_map: (B, 1, H, W) raw ids. Returns {label:
    (N, C + 1) array}, an empty (0, C + 1) one for a label with no
    instance."""
    feat_map = np.asarray(feat_map, np.float32)
    instance_map = np.asarray(instance_map)
    b, c, h, w = feat_map.shape
    out = {label: [] for label in range(label_nc)}
    for n in range(b):
        inst = instance_map[n, 0].astype(np.int64)
        for i in np.unique(inst):
            label = int(instance_labels(i, is_cityscapes))
            if not 0 <= label < label_nc:
                continue
            mask = inst == i
            ys, xs = np.nonzero(mask)
            row = np.concatenate([feat_map[n, :, ys[0], xs[0]], [mask.sum() / (h * w)]])
            out[label].append(row)
    return {k: np.stack(v) if v else np.zeros((0, c + 1), np.float32)
            for k, v in out.items()}


# ------------------------------------------------------------------ K-means


def _sq_dist(x, centers):
    """(N, K) squared Euclidean distances, clipped at 0."""
    d = (np.einsum("ij,ij->i", x, x)[:, None] - 2.0 * x @ centers.T
         + np.einsum("ij,ij->i", centers, centers)[None, :])
    return np.maximum(d, 0.0)


def _kmeans_plus_plus(x, k, rng):
    """Greedy k-means++ seeding: the first center uniform, each next one
    the best (least potential) of 2 + log(k) candidates drawn in
    proportion to the squared distance to the nearest center so far."""
    n = x.shape[0]
    trials = 2 + int(math.log(k))
    centers = np.empty((k, x.shape[1]))
    centers[0] = x[rng.randint(n)]
    closest = _sq_dist(x, centers[:1])[:, 0]
    for c in range(1, k):
        total = closest.sum()
        if total > 0:
            cand = np.searchsorted(np.cumsum(closest), rng.uniform(size=trials) * total)
            cand = np.minimum(cand, n - 1)
        else:  # every point sits on a center: any point will do
            cand = rng.randint(n, size=trials)
        dist = np.minimum(closest[None, :], _sq_dist(x, x[cand]).T)
        best = int(np.argmin(dist.sum(axis=1)))
        centers[c] = x[cand[best]]
        closest = dist[best]
    return centers


def _lloyd(x, centers, max_iter, tol):
    """Lloyd iterations from ``centers`` until the centers move less than
    ``tol`` (summed squared shift) or the assignment stops changing. An
    empty cluster takes the point farthest from its own center. Returns
    (centers, labels, inertia) of the final centers."""
    labels = None
    for _ in range(max_iter):
        dist = _sq_dist(x, centers)
        new_labels = np.argmin(dist, axis=1)
        if labels is not None and np.array_equal(new_labels, labels):
            break
        labels = new_labels
        counts = np.bincount(labels, minlength=len(centers))
        new = np.zeros_like(centers)
        np.add.at(new, labels, x)
        empty = np.nonzero(counts == 0)[0]
        if empty.size:
            far = np.argsort(-dist[np.arange(len(x)), labels], kind="stable")
            for e, p in zip(empty, far):
                new[e], counts[e] = x[p], 1
        new /= counts[:, None]
        shift = float(((new - centers) ** 2).sum())
        centers = new
        if shift <= tol:
            break
    dist = _sq_dist(x, centers)
    labels = np.argmin(dist, axis=1)
    return centers, labels, float(dist[np.arange(len(x)), labels].sum())


def kmeans(x, n_clusters, seed=0):
    """K-means of the rows of ``x``: ``KMEANS_RESTARTS`` runs of k-means++
    seeding and Lloyd iterations, from one ``np.random.RandomState(seed)``,
    the run of the lowest inertia kept. Returns (centers (k, D) float64,
    inertia)."""
    x = np.asarray(x, np.float64)
    if not 1 <= n_clusters <= len(x):
        raise ValueError(f"kmeans of {len(x)} points into {n_clusters} clusters")
    mean = x.mean(axis=0)
    xc = x - mean
    tol = float(np.mean(np.var(x, axis=0))) * KMEANS_TOL
    rng = np.random.RandomState(seed)
    best = None
    for _ in range(KMEANS_RESTARTS):
        centers, _, inertia = _lloyd(xc, _kmeans_plus_plus(xc, n_clusters, rng),
                                     KMEANS_MAX_ITER, tol)
        if best is None or inertia < best[1]:
            best = (centers, inertia)
    return best[0] + mean, best[1]


def cluster_features(encode_fn, data_loader, label_nc, feat_nc, n_clusters=10,
                     small_ratio=0.0625, is_cityscapes=True):
    """K-means over instance features, label by label.

    encode_fn: a batch -> (B, feat_nc, H, W) pooled features; each batch
    carries ``instance_maps`` (B, 1, H, W). An instance whose area share
    is not above ``small_ratio`` is left out. Returns (label_nc,
    n_clusters, feat_nc) float32, zero rows where a label has fewer
    instances than clusters or none; K-means from seed 0."""
    per_label = {label: [] for label in range(label_nc)}
    for data in data_loader:
        feats = encode_fn(data)
        inst = data["instance_maps"]
        if torch.is_tensor(feats):
            feats = feats.detach().float().cpu().numpy()
        if torch.is_tensor(inst):
            inst = inst.cpu().numpy()
        for label, rows in collect_instance_features(
                feats, inst, label_nc, is_cityscapes).items():
            if rows.size:
                per_label[label].append(rows)
    centers = np.zeros((label_nc, n_clusters, feat_nc), np.float32)
    for label in range(label_nc):
        if not per_label[label]:
            continue
        rows = np.concatenate(per_label[label], axis=0)
        rows = rows[rows[:, -1] > small_ratio, :-1]
        if not rows.shape[0]:
            continue
        k = min(rows.shape[0], n_clusters)
        centers[label, :k] = kmeans(rows, k)[0]
    return centers


def sample_feature_map(cluster_centers, instance_map, seed, is_cityscapes=True):
    """Multi-modal inference: a random nonzero cluster center of its label
    painted over each instance. instance_map: (B, 1, H, W) raw ids;
    ``seed``: the integer of ``np.random.RandomState``, drawn from in the
    order of the instances' ids, sample by sample. Returns (B, feat_nc,
    H, W) float32 numpy."""
    centers = np.asarray(cluster_centers, np.float32)
    label_nc, _, feat_nc = centers.shape
    inst_np = np.asarray(instance_map)
    b, _, h, w = inst_np.shape
    rng = np.random.RandomState(int(seed))
    out = np.zeros((b, h, w, feat_nc), np.float32)
    for n in range(b):
        inst = inst_np[n, 0].astype(np.int64)
        for i in np.unique(inst):
            label = int(instance_labels(i, is_cityscapes))
            if not 0 <= label < label_nc:
                continue
            valid = np.nonzero(np.abs(centers[label]).sum(axis=1) > 0)[0]
            if valid.size == 0:
                continue
            out[n][inst == i] = centers[label, rng.choice(valid)]
    return np.ascontiguousarray(out.transpose(0, 3, 1, 2))
