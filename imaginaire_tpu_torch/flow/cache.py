"""Teacher-output amortization for the frozen FlowNet2 flow supervision
(port of ``imaginaire_tpu/flow/cache.py``).

The vid2vid flow loss's teacher only ever sees real frames, so its
``(flow, conf)`` output is a function of the data batch alone. Two
layers keep it off the training step:

1. **Off-step execution** (``TeacherFlowCache.attach``): the teacher runs
   in whatever thread prepares the batch, and its outputs ride the batch
   as ``flow_gt`` / ``conf_gt`` tensors on the device.
2. **On-disk content-addressed cache** (``FlowCacheStore``): outputs are
   persisted under keys of the dataset identity, the frame-pair stems,
   the canonical resolution and the teacher's identity, or, for batches
   without dataset metadata, of the batch's own bytes. Keys, shard
   format (NHWC, float16 flow, uint8 conf) and directory layout are the
   JAX package's, so one cache directory serves both packages. Its
   dataset half (``DatasetFlowCacheHook``) runs in the loader's threads:
   a training item whose frame pairs all hit carries their canonical
   ``(flow, conf)``, one with a miss its canonical frames for the
   teacher; ``attach`` replays the item's crop and flip on either.

Config group ``flow_cache``: ``enabled``, ``mode`` (auto | producer |
disk), ``dir``, ``store_dtype``. The port's tensors are NCHW: images
(B, T, 3, H, W) give ``flow_gt`` (B, T-1, 2, H, W) and ``conf_gt``
(B, T-1, 1, H, W); the host copies the store needs are NHWC numpy.
Not ported yet (ROADMAP.md A.9): the store's bounded retries and chaos
sites, and the ``flow_cache/*`` telemetry spans and counters (the
``drain_stats`` meters are here).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
import uuid
import zipfile

import numpy as np
import torch

from imaginaire_tpu_torch.config import AttrDict, cfg_get

logger = logging.getLogger(__name__)

# Bump when the teacher definition changes incompatibly (cascade
# architecture, confidence threshold); stale shards then simply miss.
TEACHER_VERSION = "flownet2-v1"


def flow_cache_settings(cfg):
    """Parse the ``flow_cache`` config group (missing -> disabled)."""
    fcfg = cfg_get(cfg or {}, "flow_cache", None) or {}
    return AttrDict(
        enabled=bool(cfg_get(fcfg, "enabled", False)),
        mode=str(cfg_get(fcfg, "mode", "auto")),
        dir=cfg_get(fcfg, "dir", None),
        store_dtype=str(cfg_get(fcfg, "store_dtype", "float16")),
    )


def resolve_cache_dir(cfg):
    """The on-disk cache directory: ``flow_cache.dir`` > ``<logdir>/
    flow_cache`` > None (mode 'auto' then degrades to producer-only)."""
    settings = flow_cache_settings(cfg)
    if settings.dir:
        return str(settings.dir)
    logdir = cfg_get(cfg or {}, "logdir", None)
    if logdir:
        return os.path.join(str(logdir), "flow_cache")
    return None


def teacher_id(weights_path=None):
    """Identity of the teacher weights baked into every cache key: a
    converted checkpoint is identified by (name, size, mtime); absent
    weights (allow_random_init, tests) get a per-process tag so a random
    teacher never poisons a shared cache."""
    if weights_path and os.path.exists(weights_path):
        st = os.stat(weights_path)
        return (f"{TEACHER_VERSION}:{os.path.basename(weights_path)}"
                f":{st.st_size}:{int(st.st_mtime)}")
    return f"{TEACHER_VERSION}:random-init:{os.getpid()}"


def pair_key(dataset_name, root_idx, seq, stem_a, stem_b, canonical_hw,
             teacher):
    """Content-addressed key for one (frame_a -> frame_b) teacher
    evaluation at canonical resolution. ``stem_a`` is the target frame
    (t), ``stem_b`` the previous frame (t-1)."""
    payload = "|".join([
        str(dataset_name), str(root_idx), str(seq), str(stem_a),
        str(stem_b), f"{int(canonical_hw[0])}x{int(canonical_hw[1])}",
        str(teacher),
    ])
    return hashlib.sha1(payload.encode()).hexdigest()


def content_key(images, teacher):
    """Whole-batch key for batches without dataset metadata: hash of the
    raw image bytes + shape + dtype (of an NHWC host array, as the JAX
    package hashes its batches)."""
    arr = np.ascontiguousarray(np.asarray(images))
    digest = hashlib.sha1()
    digest.update(str(arr.shape).encode())
    digest.update(str(arr.dtype).encode())
    digest.update(arr.tobytes())
    digest.update(str(teacher).encode())
    return digest.hexdigest()


def transform_flow(flow, conf, record):
    """Apply a sample's spatial augmentation to canonical-resolution
    ``(flow, conf)`` equivariantly (NHWC numpy).

    flow: (..., H, W, 2) in pixel units (u = x, v = y); conf: (..., H, W,
    1). Crop is a pure slice (pixel units are crop-invariant); horizontal
    flip mirrors the width axis and negates u; conf mirrors without
    negation.
    """
    crop = record.get("crop")
    if crop is not None:
        top, left, ch, cw = crop
        flow = flow[..., top:top + ch, left:left + cw, :]
        conf = conf[..., top:top + ch, left:left + cw, :]
    if record.get("hflip"):
        flow = flow[..., ::-1, :] * np.asarray([-1.0, 1.0], flow.dtype)
        conf = conf[..., ::-1, :]
    return np.ascontiguousarray(flow), np.ascontiguousarray(conf)


def _to_nhwc_host(t):
    """(..., C, H, W) tensor -> (..., H, W, C) float32 numpy (transposed
    on the tensor's device; ``.cpu()`` keeps a permuted layout, which the
    host would then copy element by element)."""
    return torch.movedim(t, -3, -1).float().contiguous().cpu().numpy()


def _to_nchw_device(a, device):
    """(..., H, W, C) array -> (..., C, H, W) contiguous float32 tensor."""
    t = torch.as_tensor(np.asarray(a, np.float32), device=device)
    return torch.movedim(t, -1, -3).contiguous()


class FlowCacheStore:
    """Content-addressed (flow, conf) shards on disk.

    One ``.npz`` per key under ``<root>/<key[:2]>/<key>.npz``, NHWC, with
    flow stored at ``store_dtype`` (float16 by default: |flow| <= ~40 px,
    so the quantization error is < 0.05 px) and conf as uint8 (a binary
    mask). Writes are atomic (tmp + rename), so concurrent writers never
    leave a torn shard; a shard that fails to read is renamed
    ``*.corrupt`` once and counts as a miss.
    """

    def __init__(self, root, store_dtype="float16"):
        self.root = str(root)
        self.store_dtype = np.dtype(store_dtype)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.corrupt_shards = 0

    def path(self, key):
        return os.path.join(self.root, key[:2], key + ".npz")

    def has(self, key):
        return os.path.exists(self.path(key))

    def _quarantine(self, path, error):
        with self._lock:
            self.corrupt_shards += 1
        try:
            os.replace(path, path + ".corrupt")
        except FileNotFoundError:
            pass  # another writer of a shared store already quarantined it
        except OSError:
            try:
                os.remove(path)
            except OSError:
                pass
        logger.warning("flow cache: quarantined corrupt shard %s (%s)",
                       path, error)

    def get(self, key):
        """(flow float32, conf float32) NHWC numpy, or None."""
        path = self.path(key)
        if not os.path.exists(path):
            with self._lock:
                self.misses += 1
            return None
        try:
            with np.load(path) as npz:
                flow = npz["flow"].astype(np.float32)
                conf = npz["conf"].astype(np.float32)
        except (OSError, KeyError, ValueError, EOFError,
                zipfile.BadZipFile) as e:
            self._quarantine(path, e)
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        return flow, conf

    def put(self, key, flow, conf):
        """Write one shard (NHWC arrays) unless it exists already."""
        path = self.path(key)
        if os.path.exists(path):
            # content-addressed: another writer's shard holds the same bytes
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # unique across threads and hosts sharing a filesystem (np.savez
        # appends '.npz' unless the name ends with it)
        tmp = (f"{path}.{os.getpid()}.{threading.get_ident()}."
               f"{uuid.uuid4().hex[:8]}.tmp.npz")
        try:
            np.savez(tmp, flow=np.asarray(flow).astype(self.store_dtype),
                     conf=np.asarray(conf).astype(np.uint8))
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("flow cache write failed for %s: %s", path, e)
            try:
                os.remove(tmp)
            except OSError:
                pass

    def count_miss(self, n=1):
        with self._lock:
            self.misses += n

    def stats(self):
        with self._lock:
            total = self.hits + self.misses
            return {"hits": self.hits, "misses": self.misses,
                    "corrupt_shards": self.corrupt_shards,
                    "hit_rate": (self.hits / total) if total else 0.0}


class TeacherFlowCache:
    """The trainer's facade: runs the frozen teacher off the step path and
    attaches ``flow_gt`` / ``conf_gt`` to batches.

    Args:
        flow_net_wrapper: the ``flow.FlowNet`` teacher (weights filled).
        settings: parsed ``flow_cache`` config group.
        cache_dir: resolved on-disk cache directory (None degrades
            'auto' to producer-only).
    """

    def __init__(self, flow_net_wrapper, settings=None, cache_dir=None):
        self.wrapper = flow_net_wrapper
        self.settings = settings or flow_cache_settings({})
        self.requested_mode = str(self.settings.mode)
        mode = self.requested_mode
        if mode == "auto":
            mode = "disk" if cache_dir else "producer"
        if mode == "disk" and not cache_dir:
            logger.warning("flow_cache.mode=disk but no cache dir resolves "
                           "(set flow_cache.dir or logdir); falling back to "
                           "producer mode")
            mode = "producer"
        self.mode = mode
        self.store = (FlowCacheStore(cache_dir, self.settings.store_dtype)
                      if mode == "disk" else None)
        self.teacher = teacher_id(getattr(flow_net_wrapper, "weights_path",
                                          None))
        self._stats_lock = threading.Lock()
        self._stats = {}
        # per-pair hit/miss accounting over both halves of the disk path
        self.pair_hits = 0
        self.pair_misses = 0

    @property
    def device(self):
        return self.wrapper.device

    def hit_rate(self):
        total = self.pair_hits + self.pair_misses
        return (self.pair_hits / total) if total else 0.0

    def _record_stat(self, name, value):
        with self._stats_lock:
            self._stats.setdefault(name, []).append(float(value))

    def drain_stats(self):
        """Pop accumulated {meter_name: [values]} (plain host floats)."""
        with self._stats_lock:
            out, self._stats = self._stats, {}
        return out

    def attach(self, batch):
        """Attach ``flow_gt`` (B, T-1, 2, H, W) and ``conf_gt``
        (B, T-1, 1, H, W) tensors on the teacher's device to a video
        batch, consuming any per-sample ``_flow_cache`` payloads.
        ``images`` is a host batch of the loader's (B, T, H, W, C) arrays,
        as the trainer's host hook sees it, or a (B, T, C, H, W) tensor.
        ``flow_gt[:, t-1]`` supervises frame t against frame t-1.
        Non-video batches (or T < 2) pass through."""
        if not isinstance(batch, dict):
            return batch
        images = batch.get("images")
        metas = batch.pop("_flow_cache", None)
        if images is None or getattr(images, "ndim", 0) != 5 \
                or images.shape[1] < 2 or "flow_gt" in batch:
            return batch
        if isinstance(images, np.ndarray):
            images = _to_nchw_device(images, self.device)
        else:
            images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        t0 = time.perf_counter()
        if isinstance(metas, (list, tuple)) and len(metas) == images.shape[0] \
                and all(isinstance(m, dict) for m in metas):
            flow, conf = self._attach_from_meta(metas, images)
        else:
            flow, conf = self._attach_from_content(images)
        if flow.device.type == "cuda":
            torch.cuda.synchronize(flow.device)  # time the work, not the enqueue
        compute_ms = (time.perf_counter() - t0) * 1e3
        batch["flow_gt"] = flow
        batch["conf_gt"] = conf
        self._record_stat("flow_cache/compute_ms", compute_ms)
        self._record_stat("flow_cache/pairs",
                          images.shape[0] * (images.shape[1] - 1))
        if self.mode == "disk":
            self._record_stat("flow_cache/hit_rate", self.hit_rate())
        return batch

    def _attach_from_content(self, images):
        """No dataset metadata: compute on the batch's frames directly,
        under a whole-batch content key when the disk mode was asked for
        explicitly (randomly augmented batches would otherwise write a
        never-hit shard per batch)."""
        b, t = images.shape[:2]
        n_pairs = b * (t - 1)
        key = None
        if self.store is not None and self.requested_mode == "disk":
            key = content_key(_to_nhwc_host(images), self.teacher)
            cached = self.store.get(key)
            if cached is not None:
                self.pair_hits += n_pairs
                return tuple(_to_nchw_device(a, self.device) for a in cached)
        self.pair_misses += n_pairs
        frame = images.shape[2:]
        # the teacher's flow from each target frame to the one before it
        flow, conf = self.wrapper(images[:, 1:].reshape((-1,) + frame),
                                  images[:, :-1].reshape((-1,) + frame))
        flow = flow.reshape((b, t - 1) + flow.shape[1:])
        conf = conf.reshape((b, t - 1) + conf.shape[1:])
        if key is not None:
            self.store.put(key, _to_nhwc_host(flow), _to_nhwc_host(conf))
        return flow, conf

    def _attach_from_meta(self, metas, images):
        """Canonical-resolution path: per-sample payloads (NHWC numpy, the
        dataset hook's layout) carry either the cached canonical
        (flow, conf) or the canonical source frames (T, Hc, Wc, 3). Misses
        are batched per canonical shape, computed once, written back to
        the store, and every sample's canonical flow is transformed to
        its augmentation draw."""
        b, t = images.shape[:2]
        hw = tuple(images.shape[3:5])
        per_sample = [None] * b
        pending = {}  # canonical shape -> [(sample_idx, meta)]
        for i, meta in enumerate(metas):
            if meta.get("flow") is not None:
                self.pair_hits += t - 1
                per_sample[i] = (meta["flow"], meta["conf"])
            elif meta.get("src") is not None:
                self.pair_misses += t - 1
                src = np.asarray(meta["src"], np.float32)
                pending.setdefault(src.shape, []).append((i, meta))
            else:
                # an augmentation the canonical path cannot replay:
                # compute on this sample's own frames
                self.pair_misses += t - 1
                per_sample[i] = self._host_pairs(images[i, 1:], images[i, :-1])
        for group in pending.values():
            srcs = _to_nchw_device(np.stack([m["src"] for _, m in group]),
                                   self.device)  # (G, T, 3, Hc, Wc)
            g, tt = srcs.shape[:2]
            frame = srcs.shape[2:]
            flow, conf = self._host_pairs(srcs[:, 1:].reshape((-1,) + frame),
                                          srcs[:, :-1].reshape((-1,) + frame))
            flow = flow.reshape((g, tt - 1) + flow.shape[1:])
            conf = conf.reshape((g, tt - 1) + conf.shape[1:])
            for j, (i, meta) in enumerate(group):
                if self.store is not None:
                    for p, key in enumerate(meta.get("keys") or []):
                        self.store.put(key, flow[j, p], conf[j, p])
                per_sample[i] = (flow[j], conf[j])
        flows, confs = [], []
        for i, meta in enumerate(metas):
            flow_i, conf_i = per_sample[i]
            record = meta.get("record") or {}
            if meta.get("flow") is not None or meta.get("src") is not None:
                flow_i, conf_i = transform_flow(flow_i, conf_i, record)
            if tuple(flow_i.shape[1:3]) != hw:
                # never train on misaligned supervision
                logger.warning(
                    "flow cache: transformed flow %s does not match the "
                    "augmented batch %s; recomputing sample %d in-place",
                    flow_i.shape, hw, i)
                flow_i, conf_i = self._host_pairs(images[i, 1:], images[i, :-1])
            flows.append(flow_i)
            confs.append(conf_i)
        return (_to_nchw_device(np.stack(flows), self.device),
                _to_nchw_device(np.stack(confs), self.device))

    def _host_pairs(self, im_a, im_b):
        """The teacher on device pairs (target, previous frame), returned
        as NHWC host arrays."""
        flow, conf = self.wrapper(im_a, im_b)
        return _to_nhwc_host(flow), _to_nhwc_host(conf)


class DatasetFlowCacheHook:
    """The disk path's dataset half, owned by a video dataset.

    On every training item of two frames or more it builds the item's
    ``_flow_cache`` payload: the augmentation record, the cache key of
    each frame pair, and either the pairs' canonical ``(flow, conf)``
    read from the store in the loader's thread (every pair hit) or the
    canonical frames for the teacher (a miss); a record that is not
    ``canonical_ok`` ships alone. ``TeacherFlowCache.attach`` consumes
    the payloads. Active for ``mode`` auto or disk with a cache
    directory.
    """

    def __init__(self, cfg, dataset_name, image_type, normalize,
                 weights_path=None):
        from imaginaire_tpu_torch.flow.flow_net import DEFAULT_WEIGHTS

        # the teacher wrapper's default, so these keys match its writes
        weights_path = weights_path or DEFAULT_WEIGHTS
        self.settings = flow_cache_settings(cfg)
        cache_dir = resolve_cache_dir(cfg)
        self.active = (self.settings.enabled
                       and self.settings.mode in ("auto", "disk")
                       and cache_dir is not None)
        self.store = (FlowCacheStore(cache_dir, self.settings.store_dtype)
                      if self.active else None)
        self.image_type = image_type
        self.normalize = bool(normalize)
        self.dataset_name = dataset_name
        self.teacher = teacher_id(weights_path)

    def _canonical_src(self, canonical_frames):
        """Captured canonical frames -> (T, Hc, Wc, C) float32 in the
        teacher's input range (the dataset's own /255 and normalize)."""
        frames = []
        for f in canonical_frames:
            arr = np.asarray(f)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            was_uint8 = arr.dtype == np.uint8
            arr = arr.astype(np.float32)
            if was_uint8:
                arr = arr / 255.0
            if self.normalize:
                arr = arr * 2.0 - 1.0
            frames.append(arr)
        return np.stack(frames, axis=0)

    def attach_item(self, out, root_idx, seq, stems, record, canonical):
        """Attach the payload of the item of frames ``stems`` to ``out``."""
        if not self.active or len(stems) < 2:
            return out
        if not record or not record.get("canonical_ok") or canonical is None:
            out["_flow_cache"] = {"record": dict(record or {})}
            return out
        hw = record["canonical_hw"]
        keys = [pair_key(self.dataset_name, root_idx, seq, stems[p + 1],
                         stems[p], hw, self.teacher)
                for p in range(len(stems) - 1)]
        cached = [self.store.get(k) if self.store.has(k) else None for k in keys]
        payload = {"record": dict(record), "keys": keys}
        if all(c is not None for c in cached):
            payload["flow"] = np.stack([c[0] for c in cached])
            payload["conf"] = np.stack([c[1] for c in cached])
        else:
            # one miss recomputes the whole window (the teacher batches
            # by item anyway)
            payload["src"] = self._canonical_src(canonical)
        out["_flow_cache"] = payload
        return out
