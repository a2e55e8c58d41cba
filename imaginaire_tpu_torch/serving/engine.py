"""Serving engine, core (port of ``imaginaire_tpu/serving/engine.py``).

Requests carry NHWC numpy arrays with a lane dimension of 1
(``{"label": (1, H, W, C)}``), as in the JAX package. A
:class:`RequestQueue` groups them by resolution; the engine chunks each
group to the configured batch sizes, zero-pads the last partial chunk
AFTER the real lanes, runs the generator on the device (NCHW inside)
and slices the pad lanes off before return.

Pad lanes cannot reach real lanes: every layer on the inference path is
per-sample (instance norm, BatchNorm on running statistics, convs), and
each lane's style noise comes from its own request's seed through a
``torch.Generator`` of its own, so a lane's noise does not depend on its
batch-mates. This replaces the JAX engine's vmap over lanes.

Frame-recurrent families (vid2vid) are served as streams instead:
``engine.stream(stream_id).step({"label": (1, H, W, C)})`` returns the
stream's next frame. Each :class:`StreamSession` keeps its own history
rings on the device, so many streams interleave on one engine.

Weights: ``initialize`` draws fresh seeded weights; ``load_weights``
restores a checkpoint through the trainer's verified path and serves it.
The forward runs ``torch.func.functional_call`` of the trainer's
``net_G`` on ``trainer.inference_params()`` (the averaged weights with
the BatchNorm statistics re-estimated for them, when the checkpoint
carries them), as the JAX engine applies the trainer's module to its
inference variables. Still to be ported (ROADMAP.md): the CUDA-graph
executable pool, tracing, SLO budgets and telemetry.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict, deque
from collections.abc import Mapping
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.func import functional_call

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.model_utils.fs_vid2vid import concat_frames
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.utils.misc import nchw_to_nhwc, nhwc_to_nchw, numeric_only


class ServingError(RuntimeError):
    """The engine cannot (or refuses to) serve."""


@dataclass(frozen=True)
class BucketCfg:
    """One configured resolution bucket."""

    height: int
    width: int
    batch_sizes: tuple = (1,)

    @property
    def hw(self):
        return (self.height, self.width)


_BUCKET_OVERRIDES = ("compute_dtype", "remat", "fused_modulation")


def serving_settings(cfg):
    """Parse ``cfg.serving`` into engine settings (plain dict). Bucket
    entries are ``[H, W]`` or ``{hw: [H, W], batch_sizes: [...]}``. The
    per-bucket and global compute_dtype / remat / fused_modulation
    overrides of the JAX engine are not in the port yet and are refused."""
    scfg = cfg_get(cfg or {}, "serving", None) or {}
    for knob in _BUCKET_OVERRIDES:
        if cfg_get(scfg, knob, None) is not None:
            raise ServingError(f"serving.{knob} is not in the port yet "
                               f"(ROADMAP.md)")
    global_bs = tuple(int(b) for b in
                      (cfg_get(scfg, "batch_sizes", None) or (1, 4)))
    buckets = []
    for entry in (cfg_get(scfg, "buckets", None) or [[256, 256]]):
        if isinstance(entry, Mapping):
            for knob in _BUCKET_OVERRIDES:
                if cfg_get(entry, knob, None) is not None:
                    raise ServingError(f"serving bucket {knob} is not in the "
                                       f"port yet (ROADMAP.md)")
            hw = cfg_get(entry, "hw", None) or cfg_get(entry, "size", None)
            buckets.append(BucketCfg(
                int(hw[0]), int(hw[1]),
                tuple(int(b) for b in
                      (cfg_get(entry, "batch_sizes", None) or global_bs))))
        else:
            buckets.append(BucketCfg(int(entry[0]), int(entry[1]), global_bs))
    return {
        "buckets": buckets,
        "batch_sizes": global_bs,
        "queue_timeout_ms": float(cfg_get(scfg, "queue_timeout_ms", 5.0)),
        "max_queue": int(cfg_get(scfg, "max_queue", 64)),
        "seed": int(cfg_get(scfg, "seed", 0)),
    }


_REQUEST_IDS = itertools.count(1)


@dataclass
class ServeRequest:
    """One inference request: a data dict of NHWC numpy arrays with a lane
    dimension of 1 (``{"label": (1, H, W, C), ...}``)."""

    data: dict
    seed: int = 0
    id: int = field(default_factory=lambda: next(_REQUEST_IDS))
    t_submit: float = field(default_factory=time.perf_counter)

    @property
    def hw(self):
        for v in self.data.values():
            shape = getattr(v, "shape", ())
            if len(shape) == 4:
                return (int(shape[1]), int(shape[2]))
        raise ServingError("request carries no rank-4 (B,H,W,C) array")


class RequestQueue:
    """Pending requests, drained when some resolution group can fill its
    largest batch size or the oldest request has waited past
    ``timeout_ms`` (``due``), or unconditionally (``drain``). No threads:
    the caller pumps."""

    def __init__(self, engine, max_depth=64, timeout_ms=5.0):
        self.engine = engine
        self.max_depth = int(max_depth)
        self.timeout_ms = float(timeout_ms)
        self._pending = []

    @property
    def depth(self):
        return len(self._pending)

    def submit(self, request):
        if len(self._pending) >= self.max_depth:
            raise ServingError(
                f"queue overflow: {len(self._pending)} pending >= "
                f"max_queue {self.max_depth} (backpressure, not OOM)")
        self._pending.append(request)
        return request.id

    def _groups(self):
        groups = OrderedDict()
        for req in self._pending:
            groups.setdefault(req.hw, []).append(req)
        return groups

    def due(self, now=None):
        if not self._pending:
            return False
        now = time.perf_counter() if now is None else now
        oldest = min(r.t_submit for r in self._pending)
        if (now - oldest) * 1e3 >= self.timeout_ms:
            return True
        return any(len(reqs) >= self.engine.max_batch_for(hw)
                   for hw, reqs in self._groups().items())

    def drain(self):
        groups = self._groups()
        self._pending = []
        return groups


def _percentile(samples, q):
    if not samples:
        return None
    ordered = sorted(samples)
    pos = q * (len(ordered) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def _family_of(cfg):
    """'imaginaire_tpu.trainers.spade' -> 'spade'."""
    return str(cfg_get(cfg_get(cfg, "trainer", {}) or {}, "type",
                       "unknown")).rsplit(".", 1)[-1]


class ServingEngine:
    """The serving frontend for one model family, on one device."""

    def __init__(self, cfg, trainer=None, device=None):
        self.cfg = as_attrdict(cfg)
        self.settings = serving_settings(self.cfg)
        self.family = _family_of(self.cfg)
        if trainer is None:
            trainer = resolve(self.cfg.trainer.type, "Trainer")(self.cfg,
                                                                device=device)
        self.trainer = trainer
        self.device = trainer.device
        # a frame-recurrent generator conditions each frame on its own
        # previous outputs and produces one frame size, fixed by its
        # config: it is served as streams at that size
        self.frame_recurrent = hasattr(trainer, "_get_data_t")
        if self.frame_recurrent:
            self.settings["buckets"] = [
                BucketCfg(*trainer.net_G.frame_hw, batch_sizes=(1,))]
        self.queue = RequestQueue(self, self.settings["max_queue"],
                                  self.settings["queue_timeout_ms"])
        # the only inference argument the generator reads (the others,
        # e.g. keep_original_size, concern the data-loader entry point)
        self.random_style = bool(cfg_get(
            cfg_get(self.cfg, "inference_args", None) or {}, "random_style",
            False))
        self._variables = None
        self._example = None
        self._latencies = deque(maxlen=2048)
        self._exec_ms = {}  # label -> deque of chunk forward ms
        self._lane_total = 0
        self._lane_padded = 0
        self._batches = 0
        self._sessions = {}

    # ------------------------------------------------------- lifecycle

    def initialize(self, example_batch=None, seed=None):
        """Draw fresh seeded weights (unless the trainer has state) and
        remember ``example_batch`` as the shape template for ``warm``."""
        if example_batch is not None:
            self.register_example(example_batch)
        if self.trainer.state is None:
            self.trainer.init_state(self.settings["seed"] if seed is None
                                    else int(seed))
        self.refresh_weights()
        return self

    def load_weights(self, checkpoint=None, require=True):
        """Restore the weights to serve, only through the verified path:
        with no ``checkpoint`` the trainer's logdir pointer (corrupt
        candidates quarantined, falling back to the newest that
        verifies); an explicit path is verified, and quarantined on a
        mismatch with a fallback to the newest verifiable checkpoint
        beside it. With ``require`` (the serving default) it raises
        ``ServingError`` when nothing verifiable restored: a server never
        runs weights training would refuse. Returns whether a checkpoint
        restored."""
        if self.trainer.state is None:
            raise ServingError("initialize() before load_weights()")
        loaded = self.trainer.load_checkpoint(checkpoint or None,
                                              fallback=bool(checkpoint))
        if not loaded:
            if require:
                raise ServingError(
                    "no verifiable checkpoint to serve (refusing to serve "
                    "fresh or unverified weights; pass require=False for "
                    "smoke tests)")
            print("WARNING: serving with fresh weights (require=False)")
        self.refresh_weights()
        return loaded

    def refresh_weights(self):
        """Re-read the inference weights (the averaged copy with its
        statistics when model averaging is on) from the trainer."""
        self._variables = self.trainer.inference_params()
        return self._variables

    def register_example(self, batch):
        """One NHWC batch whose rank-4 arrays re-shape to each bucket's
        (H, W) and whose other arrays tile along the lane dim in warm()."""
        self._example = {k: np.asarray(v)[:1]
                         for k, v in numeric_only(dict(batch)).items()}
        return self

    def _bucket_for(self, hw):
        for b in self.settings["buckets"]:
            if b.hw == tuple(hw):
                return b
        return None

    def max_batch_for(self, hw):
        b = self._bucket_for(hw)
        return max(b.batch_sizes) if b else 1

    def label(self, h, w, bs, tag=None):
        parts = ["serve", self.family] + ([tag] if tag else [])
        return "/".join(parts + [f"{h}x{w}", f"bs{bs}"])

    def warm(self):
        """One forward per configured (bucket, batch size) on a zero
        batch; returns {label: forward ms}. A frame-recurrent family
        steps a throwaway stream through ``num_frames_G`` zero frames at
        each bucket instead (the first-frame, continuation and warp
        forwards); returns {label: [ms per frame]}."""
        if self._variables is None:
            raise ServingError("initialize() before warm()")
        if self.frame_recurrent:
            return self._warm_streams()
        if self._example is None:
            raise ServingError("no example lane registered; initialize() with "
                               "an example batch or call register_example()")
        report = {}
        for bucket in self.settings["buckets"]:
            for bs in bucket.batch_sizes:
                host = {}
                for k, v in self._example.items():
                    shape = list(v.shape)
                    if len(shape) == 4:
                        shape[1], shape[2] = bucket.height, bucket.width
                    shape[0] = bs
                    host[k] = np.zeros(shape, v.dtype)
                t0 = time.perf_counter()
                self._run(host, [None] * bs)
                report[self.label(bucket.height, bucket.width, bs)] = (
                    time.perf_counter() - t0) * 1e3
        return report

    def _warm_streams(self):
        channels = self.trainer.net_G.num_input_channels
        report = {}
        for bucket in self.settings["buckets"]:
            session = StreamSession(self)
            frame = {"label": np.zeros((1, bucket.height, bucket.width,
                                        channels), np.float32)}
            times = report[self.label(*bucket.hw, 1, tag="stream")] = []
            for _ in range(self.trainer.num_frames_G):
                t0 = time.perf_counter()
                session._advance(frame)
                times.append((time.perf_counter() - t0) * 1e3)
        return report

    # -------------------------------------------------------- serving

    def submit(self, request):
        if self.frame_recurrent:
            raise ServingError(
                f"the {self.family} family is frame-recurrent and is served "
                f"as streams: engine.stream(stream_id).step(frame) (batched "
                f"serving of frame streams is queued in ROADMAP.md)")
        return self.queue.submit(request)

    def pump(self, now=None):
        """Execute pending requests if a batch is due; {id: image}."""
        if not self.queue.due(now=now):
            return {}
        return self.flush()

    def flush(self):
        results = {}
        for hw, reqs in self.queue.drain().items():
            results.update(self._serve_group(hw, reqs))
        return results

    def serve(self, requests):
        """Submit + flush; images in request order."""
        for req in requests:
            self.submit(req)
        results = self.flush()
        return [results[req.id] for req in requests]

    def _serve_group(self, hw, reqs):
        bucket = self._bucket_for(hw)
        sizes = (sorted(bucket.batch_sizes) if bucket
                 else [min(len(reqs), max(self.settings["batch_sizes"]))])
        results = {}
        i = 0
        while i < len(reqs):
            remaining = len(reqs) - i
            bs = next((s for s in sizes if s >= remaining), sizes[-1])
            chunk = reqs[i:i + bs]
            i += len(chunk)
            results.update(self._execute_chunk(hw, chunk, bs))
        return results

    def _execute_chunk(self, hw, chunk, bs):
        if self._variables is None:
            raise ServingError("initialize() before serving")
        pad = bs - len(chunk)
        host = {}
        for name in chunk[0].data:
            stacked = np.concatenate([np.asarray(r.data[name]) for r in chunk])
            if pad:
                stacked = np.concatenate(
                    [stacked, np.zeros((pad,) + stacked.shape[1:], stacked.dtype)])
            host[name] = stacked
        t0 = time.perf_counter()
        images = self._run(host, [r.seed for r in chunk] + [None] * pad)
        self._account(self.label(hw[0], hw[1], bs), t0,
                      [r.t_submit for r in chunk], lanes=bs, padded=pad)
        images = images[:len(chunk)]
        return {req.id: images[j] for j, req in enumerate(chunk)}

    def _account(self, label, t_exec, submit_times, lanes, padded):
        """Record one executed batch (or stream frame) that started
        executing at ``t_exec``."""
        now = time.perf_counter()
        self._exec_ms.setdefault(label, deque(maxlen=512)).append(
            (now - t_exec) * 1e3)
        self._latencies.extend((now - t) * 1e3 for t in submit_times)
        self._lane_total += lanes
        self._lane_padded += padded
        self._batches += 1

    def _lane_noise(self, seeds):
        """(B, style_dims) style noise: one row per lane from that lane's
        own seeded generator; pad lanes (seed None) get zeros."""
        dims = getattr(self.trainer.net_G, "style_dims", None)
        if dims is None:
            return None
        rows = []
        for seed in seeds:
            if seed is None:
                rows.append(torch.zeros((1, dims), device=self.device))
            else:
                gen = torch.Generator(device=self.device).manual_seed(int(seed))
                rows.append(torch.randn((1, dims), generator=gen,
                                        device=self.device))
        return torch.cat(rows)

    def _to_device(self, host):
        """NHWC host arrays -> tensors on the device, rank-4 ones NCHW."""
        data = {}
        for name, arr in host.items():
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
            data[name] = nhwc_to_nchw(t) if t.dim() == 4 else t
        return data

    @torch.inference_mode()
    def _run(self, host, seeds):
        """One generator forward on NHWC host arrays; NHWC numpy out."""
        data = self._to_device(host)
        out = functional_call(
            self.trainer.net_G, self._variables, (data,),
            {"random_style": self.random_style,
             "noise": self._lane_noise(seeds)}, strict=True)
        return nchw_to_nhwc(out["fake_images"]).cpu().numpy()

    # -------------------------------------------------------- streams

    def stream(self, stream_id):
        """Get (or open) the :class:`StreamSession` of ``stream_id``."""
        session = self._sessions.get(stream_id)
        if session is None:
            session = self._sessions[stream_id] = StreamSession(self)
        return session

    def close_stream(self, stream_id):
        """Close a stream and free its history rings."""
        self._sessions.pop(stream_id, None)

    # ---------------------------------------------------------- stats

    def stats(self):
        lat = list(self._latencies)
        return {
            "family": self.family,
            "batches": self._batches,
            "requests": len(lat),
            "p50_ms": _percentile(lat, 0.50),
            "p99_ms": _percentile(lat, 0.99),
            "pad_waste_frac": (self._lane_padded / self._lane_total
                               if self._lane_total else None),
            "queue_depth": self.queue.depth,
            "exec_ms": {label: list(ring) for label, ring in self._exec_ms.items()},
        }


class StreamSession:
    """Per-stream vid2vid conditioning state, kept on the device across
    frames: the (1, T, C, H, W) rings of the stream's last
    ``num_frames_G - 1`` labels and generated frames. ``step(frame)``
    builds the frame's data from THIS stream's rings (no host upload of
    the history), runs the generator, and rolls the rings forward with
    the device output. ``reset()`` starts a new shot. The vid2vid
    generator draws no noise, so a stream has no seed."""

    def __init__(self, engine):
        if not engine.frame_recurrent:
            raise ServingError(
                f"family {engine.family!r} has no frame-recurrent trainer "
                f"(_get_data_t); streaming sessions need the vid2vid family")
        self.engine = engine
        self.history = max(int(engine.trainer.num_frames_G) - 1, 1)
        self.reset()

    def reset(self):
        self.prev_labels = None
        self.prev_images = None
        self.t = 0

    @torch.inference_mode()
    def _advance(self, frame):
        """Generate this stream's next frame from one NHWC host frame
        (``{"label": (1, H, W, C)}``) and roll the rings; (1, H, W, C)
        numpy out."""
        engine = self.engine
        trainer = engine.trainer
        if engine._variables is None:
            raise ServingError("initialize() before streaming")
        data = trainer._start_of_iteration(
            engine._to_device(numeric_only(dict(frame))), -1)
        data_t = trainer._get_data_t(data, 0, self.prev_labels,
                                     self.prev_images)
        hw = tuple(data_t["label"].shape[-2:])
        if engine._bucket_for(hw) is None:
            raise ServingError(
                f"frame of {hw[0]}x{hw[1]}: this generator produces "
                f"{trainer.net_G.frame_hw[0]}x{trainer.net_G.frame_hw[1]} "
                f"frames")
        fake = trainer._apply_G(engine._variables, data_t)["fake_images"]
        # the rings advance with the DEVICE tensors
        self.prev_labels = concat_frames(self.prev_labels, data_t["label"],
                                         self.history)
        self.prev_images = concat_frames(self.prev_images, fake, self.history)
        self.t += 1
        return nchw_to_nhwc(fake).cpu().numpy()

    def step(self, frame):
        """The stream's next frame for ``frame`` = {"label": (1, H, W, C)
        numpy}; accounted under ``serve/<family>/stream/<H>x<W>/bs1``."""
        t0 = time.perf_counter()
        out = self._advance(frame)
        self.engine._account(self.engine.label(*out.shape[1:3], 1, tag="stream"),
                             t0, [t0], lanes=1, padded=0)
        return out


def engine_from_config(cfg, trainer=None, device=None):
    """Build (without initializing) a :class:`ServingEngine`."""
    return ServingEngine(cfg, trainer=trainer, device=device)
