"""Trainer base (port of ``imaginaire_tpu/trainers/base.py``): the
serving half and the D+G training step.

Serving: it builds ``net_G`` from the config on an explicit device,
draws fresh weights from a seed, and hands out the inference weights
(the averaged copy when ``trainer.model_average``).

Training (``train=True``): it also builds ``net_D``, the losses
(``_init_loss`` of the family trainer), one Adam a network with its lr
policy, and the averaged copy's update, and runs the JAX trainer's two
steps eagerly:

- ``dis_update(data)``: G's output under ``torch.no_grad()``, then D's
  loss, backward and Adam. Only D's spectral-norm ``u`` and BatchNorm
  running statistics advance.
- ``gen_update(data)``: G and D forward, G's loss, backward, Adam, and
  the EMA of G. Only G's state advances; D's forward takes a fresh
  power step but stores nothing.

The compute policy is the JAX trainer's (``_cast_net_vars``): in each
step both networks' parameters are rounded to the compute dtype (the
cast is differentiable, so the grads land on the fp32 masters) and the
data's floating tensors are cast to it; the norm statistics, the
spectral-norm power iteration and the loss sum (``_total``) stay fp32.
``torch.autocast`` is not used: it picks types op by op, which is not
the JAX policy. The compute dtype is ``trainer.mixed_precision`` when
enabled, else the legacy ``trainer.compute_dtype``, else fp32.

A non-finite total loss or gradient norm leaves the parameters, the
optimizer state and the network's state as they were
(``diagnostics.on_nonfinite``: ``halt`` raises ``NonFiniteLossError``,
``skip`` goes on); the JAX package's ``rollback`` is not ported.

The loop (``train.py``): ``start_of_epoch``, ``start_of_iteration`` (the
loader's NHWC numpy to NCHW tensors on the device, through pinned host
memory and non-blocking copies), ``end_of_iteration`` and
``end_of_epoch`` with the JAX package's ``logging_iter``,
``snapshot_save_iter``, ``snapshot_save_epoch`` and ``image_save_iter``
cadences, the losses' meters (``utils/meters.py``, written to
``<logdir>/meters.jsonl``), checkpoints (``utils/checkpoint.py``) and
``test``. A checkpoint holds everything the next step reads: G, D and the
averaged copy with their buffers (spectral-norm ``u``, BatchNorm
statistics), the loss networks' weights, both optimizers' moments and
update counts (the lr schedules are functions of the count), the noise
generators' states, the EMA's update count, and the loop's
epoch, iteration and batch within the epoch.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers.state import (
    param_compute_dtype,
    state_buffers,
    state_updates,
)
from imaginaire_tpu_torch.optim.optimizers import get_optimizer_for_params
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.utils.init_weight import init_weights
from imaginaire_tpu_torch.utils.meters import Meter, ScalarWriter
from imaginaire_tpu_torch.utils.misc import resolve_device
from imaginaire_tpu_torch.utils.model_average import ema_init, ema_update
from imaginaire_tpu_torch.utils.visualization import (
    save_image_grid,
    save_tensor_strip,
    tensor2im,
)

NONFINITE_POLICIES = ("halt", "skip")


class NonFiniteLossError(RuntimeError):
    """Raised by ``diagnostics.on_nonfinite: halt`` on a non-finite step."""


def compute_dtype_of(cfg):
    """The step's compute dtype: ``trainer.mixed_precision.compute_dtype``
    when ``mixed_precision.enabled``, else ``trainer.compute_dtype``,
    else fp32 (``imaginaire_tpu/trainers/base.py:101-107``)."""
    tcfg = cfg_get(cfg, "trainer", None) or {}
    mp = cfg_get(tcfg, "mixed_precision", None) or {}
    if cfg_get(mp, "enabled", False):
        name = cfg_get(mp, "compute_dtype", "bfloat16")
    else:
        name = cfg_get(tcfg, "compute_dtype", "float32")
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


def _global_norm(tensors):
    """fp32 L2 norm of a list of tensors (the leaves are upcast first)."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


class BaseTrainer:
    def __init__(self, cfg, device=None, train=False, iters_per_epoch=1):
        self.cfg = cfg = as_attrdict(cfg)
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.net_G = resolve(cfg.gen.type, "Generator")(cfg.gen, cfg.data)
        self.net_G.eval().requires_grad_(False)
        tcfg = cfg_get(cfg, "trainer", None) or {}
        self.model_average = cfg_get(tcfg, "model_average", False)
        self.model_average_remove_sn = cfg_get(tcfg, "model_average_remove_sn", True)
        self.model_average_beta = cfg_get(tcfg, "model_average_beta", 0.9999)
        self.model_average_start = cfg_get(tcfg, "model_average_start_iteration", 1000)
        init = cfg_get(tcfg, "init", None) or {}
        self.init_type = cfg_get(init, "type", "xavier")
        self.init_gain = cfg_get(init, "gain", 0.02)
        self.compute_dtype = compute_dtype_of(cfg)
        self.speed_benchmark = cfg_get(tcfg, "speed_benchmark", False)
        self.state = None
        self.ema_G = None
        self.net_D = None
        self.train = bool(train)
        self.timings = {"gen_step": [], "dis_step": [], "loader_wait": [],
                        "data_wait": [], "iteration": []}
        self.current_epoch = 0
        self.current_iteration = 0
        # batches of the current epoch consumed before a resume: the loop
        # fast-forwards the loader past them
        self.resume_batch_in_epoch = 0
        self._epoch_start_iteration = 0
        self.start_iteration_time = self.start_epoch_time = time.perf_counter()
        logdir = cfg_get(cfg, "logdir", None)
        self.writer = ScalarWriter(logdir) if logdir else None
        self.meters = {}
        if self.train:
            self._init_training(cfg, iters_per_epoch)

    # ---------------------------------------------------------- training

    def _init_training(self, cfg, iters_per_epoch):
        if cfg_get(cfg, "dis", None) is not None:
            with torch.device(self.device):
                self.net_D = resolve(cfg.dis.type, "Discriminator")(cfg.dis, cfg.data)
            self.net_D.eval().requires_grad_(False)
        self.weights = {}
        self._init_loss(cfg)
        self.opt_G = get_optimizer_for_params(
            cfg.gen_opt, self.net_G.parameters(), iters_per_epoch)
        self.opt_D = (get_optimizer_for_params(
            cfg.dis_opt, self.net_D.parameters(), iters_per_epoch)
            if self.net_D is not None else None)
        self.clip_grad_norm_G = cfg_get(cfg_get(cfg, "gen_opt", {}), "clip_grad_norm", None)
        self.clip_grad_norm_D = cfg_get(cfg_get(cfg, "dis_opt", {}), "clip_grad_norm", None)
        dcfg = cfg_get(cfg, "diagnostics", None) or {}
        self.guard = bool(cfg_get(dcfg, "enabled", True))
        self.on_nonfinite = str(cfg_get(dcfg, "on_nonfinite", "halt")).lower()
        if self.on_nonfinite not in NONFINITE_POLICIES:
            raise NotImplementedError(
                f"diagnostics.on_nonfinite={self.on_nonfinite!r} is not in the "
                f"port yet (ROADMAP.md); it has {NONFINITE_POLICIES}")
        self.nonfinite_events = 0
        self.num_ema_updates = 0
        self.gen_rng = torch.Generator(device=self.device)
        self.dis_rng = torch.Generator(device=self.device)

    def _init_loss(self, cfg):
        raise NotImplementedError(
            f"training of {type(self).__module__} is not in the port yet "
            f"(ROADMAP.md)")

    def init_loss_params(self, generator):
        """Weights of the loss networks (VGG19): frozen."""

    def init_state(self, seed=0):
        """Fresh weights from ``seed``: every kernel drawn on the device
        from one ``torch.Generator`` (G, then D, then the loss networks);
        the averaged copy starts as the sigma-collapsed weights, as the
        JAX trainer's ``ema_init`` does."""
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        init_weights(self.net_G, generator, self.init_type, self.init_gain)
        if self.net_D is not None:
            init_weights(self.net_D, generator, self.init_type, self.init_gain)
        if self.train:
            self.init_loss_params(generator)
            self.gen_rng.manual_seed(int(seed) + 1)
            self.dis_rng.manual_seed(int(seed) + 2)
        if self.model_average:
            self.ema_G = ema_init(self.net_G, self.model_average_remove_sn)
        self.state = {"seed": int(seed)}
        return self.state

    def inference_params(self):
        """{name: tensor} for ``torch.func.functional_call(net_G, ...)``:
        the averaged parameters when model averaging is on, else the
        live ones, plus the buffers (``u``, running statistics)."""
        if self.state is None:
            raise RuntimeError("init_state() before inference_params()")
        params = dict(self.net_G.named_parameters())
        if self.model_average:
            params.update(self.ema_G)
        params.update(self.net_G.named_buffers())
        return params

    def _get_outputs(self, net_D_output, real=True):
        """D's outputs for a target (differences of the real and fake
        outputs with ``trainer.gan_relativistic``)."""
        relativistic = cfg_get(cfg_get(self.cfg, "trainer", {}),
                               "gan_relativistic", False)

        def diff(a, b):
            return [diff(x, y) if isinstance(x, list) else x - y
                    for x, y in zip(a, b)]

        first, second = (("real_outputs", "fake_outputs") if real
                         else ("fake_outputs", "real_outputs"))
        if relativistic:
            return diff(net_D_output[first], net_D_output[second])
        return net_D_output[first]

    def _to_compute_dtype(self, data):
        """The data's fp32 tensors cast to the compute dtype."""
        if self.compute_dtype == torch.float32:
            return dict(data)
        return {k: (v.to(self.compute_dtype)
                    if torch.is_tensor(v) and v.dtype == torch.float32 else v)
                for k, v in data.items()}

    def _total(self, losses):
        """Weighted sum of the registered losses, in fp32."""
        total = torch.zeros((), device=self.device)
        for name, w in self.weights.items():
            if name in losses:
                total = total + losses[name].float() * w
        return total

    def gen_forward(self, data, noise):
        """(losses, G's output) of the G step."""
        raise NotImplementedError

    def dis_forward(self, data, noise):
        """Losses of the D step."""
        raise NotImplementedError

    def _draw_noise(self, data, generator):
        """The G noise of a step (the style code's eps), from ``generator``."""
        return None

    def _step(self, net, opt, forward, clip, key):
        """One update of ``net`` (G or D) by ``opt``. Returns the losses
        (fp32 scalars, ``total`` included)."""
        t0 = time.perf_counter() if self.speed_benchmark else None
        other = self.net_D if net is self.net_G else self.net_G
        params = list(net.parameters())
        kept_state = ([b.clone() for b in state_buffers(net)]
                      if self.guard else None)
        self.net_G.train()
        if self.net_D is not None:
            self.net_D.train()
        net.requires_grad_(True)
        opt.zero_grad()
        dtype = None if self.compute_dtype == torch.float32 else self.compute_dtype
        try:
            with contextlib.ExitStack() as policy:
                for n in (net, other):
                    if n is not None:
                        policy.enter_context(param_compute_dtype(n, dtype))
                        policy.enter_context(state_updates(n, n is net))
                losses = {k: v.float() for k, v in forward().items()}
                losses["total"] = total = self._total(losses)
                total.backward()
        finally:
            net.requires_grad_(False)
            self.net_G.eval()
            if self.net_D is not None:
                self.net_D.eval()
        grads = [p.grad for p in params if p.grad is not None]
        if clip:
            torch.nn.utils.clip_grad_norm_(params, clip)
        if self.guard:
            losses["grad_norm"] = grad_norm = _global_norm(grads)
            ok = bool(torch.isfinite(total) & torch.isfinite(grad_norm))
        else:
            ok = True
        if ok:
            opt.step()
        else:
            with torch.no_grad():
                for b, v in zip(state_buffers(net), kept_state):
                    b.copy_(v)
            self.nonfinite_events += 1
            if self.on_nonfinite == "halt":
                raise NonFiniteLossError(
                    f"non-finite {key} update after {opt.count} updates: total "
                    f"{float(total.detach())}, grad norm "
                    f"{float(losses['grad_norm'])}; set "
                    "diagnostics.on_nonfinite: skip to keep running")
        if net is self.net_G and self.model_average:
            self.num_ema_updates += 1
            ema_update(self.ema_G, self.net_G, self.num_ema_updates,
                       beta=self.model_average_beta,
                       start_iteration=self.model_average_start,
                       remove_sn=self.model_average_remove_sn)
        if self.speed_benchmark:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[key].append(time.perf_counter() - t0)
        return {k: v.detach() for k, v in losses.items()}

    def _prepare(self, data):
        return self._to_compute_dtype(data)

    def gen_update(self, data, noise=None):
        """The G step on ``data`` ({"label", "images"}: NCHW tensors on
        the trainer's device); ``noise`` (the style code's eps, else
        drawn from ``gen_rng``) may be injected."""
        if self.state is None:
            raise RuntimeError("init_state() before gen_update()")
        data = self._prepare(data)
        if noise is None:
            noise = self._draw_noise(data, self.gen_rng)
        losses = self._step(self.net_G, self.opt_G,
                            lambda: self.gen_forward(data, noise)[0],
                            self.clip_grad_norm_G, "gen_step")
        self._log_losses("gen_update", losses)
        return losses

    def dis_update(self, data, noise=None):
        """The D step on ``data``; ``noise`` as for ``gen_update``."""
        if self.state is None:
            raise RuntimeError("init_state() before dis_update()")
        if self.net_D is None:
            return None
        data = self._prepare(data)
        if noise is None:
            noise = self._draw_noise(data, self.dis_rng)
        losses = self._step(self.net_D, self.opt_D,
                            lambda: self.dis_forward(data, noise),
                            self.clip_grad_norm_D, "dis_step")
        self._log_losses("dis_update", losses)
        return losses

    # ------------------------------------------------------------- the loop

    def start_of_epoch(self, current_epoch):
        self.current_epoch = current_epoch
        self.start_epoch_time = time.perf_counter()
        # after a mid-epoch resume the epoch began resume_batch_in_epoch
        # iterations before this one
        self._epoch_start_iteration = (self.current_iteration
                                       - int(self.resume_batch_in_epoch or 0))
        self.resume_batch_in_epoch = 0

    def start_of_iteration(self, data, current_iteration):
        """The host hook (``_start_of_iteration``), then the batch's
        arrays to tensors on the device, NHWC arrays as NCHW, through
        pinned host memory and non-blocking copies on a CUDA device.
        Entries that are not arrays (sample keys) pass through. The
        iteration's time (``end_of_iteration``) starts after the copies
        are queued."""
        data = self._to_device(self._start_of_iteration(data, current_iteration))
        self.current_iteration = current_iteration
        self.start_iteration_time = time.perf_counter()
        return data

    def _to_device(self, data):
        cuda = self.device.type == "cuda"
        out = {}
        for key, value in data.items():
            if not isinstance(value, np.ndarray) or value.dtype == object:
                out[key] = value
                continue
            t = torch.from_numpy(np.ascontiguousarray(value))
            if cuda:
                t = t.pin_memory()
            t = t.to(self.device, non_blocking=cuda)
            if t.ndim == 4:
                t = t.permute(0, 3, 1, 2).contiguous()
            out[key] = t
        return out

    def end_of_iteration(self, data, current_epoch, current_iteration):
        self.current_epoch = current_epoch
        self.current_iteration = current_iteration
        self.time_iteration = time.perf_counter() - self.start_iteration_time
        if self.speed_benchmark:
            self.timings["iteration"].append(self.time_iteration)
        cfg = self.cfg
        if current_iteration % cfg_get(cfg, "logging_iter", 100) == 0:
            self._meter("time/iteration").write(self.time_iteration)
            self._flush_meters(current_iteration)
        if current_iteration % cfg_get(cfg, "snapshot_save_iter", 10000) == 0:
            self.save_checkpoint(current_epoch, current_iteration)
        if current_iteration % cfg_get(cfg, "image_save_iter", 10000) == 0:
            self.save_image(self._image_path(current_iteration), data)

    def end_of_epoch(self, data, current_epoch, current_iteration):
        self.current_epoch = current_epoch
        self.current_iteration = current_iteration
        self.time_epoch = time.perf_counter() - self.start_epoch_time
        print(f"Epoch: {current_epoch}, total time: {self.time_epoch:6f}.")
        if current_epoch % cfg_get(self.cfg, "snapshot_save_epoch", 20) == 0:
            self.save_checkpoint(current_epoch, current_iteration)

    def _start_of_iteration(self, data, current_iteration):
        """Host-side batch hook (numpy in, numpy out)."""
        return data

    def _get_visualizations(self, data):
        return None

    # ---------------------------------------------------------- checkpoints

    def _optimizers(self):
        return [(key, opt, net) for key, opt, net in
                (("opt_G", getattr(self, "opt_G", None), self.net_G),
                 ("opt_D", getattr(self, "opt_D", None), self.net_D))
                if opt is not None]

    def state_tensors(self):
        """The flat {path: tensor} state a checkpoint holds."""
        out = {}
        for prefix, module in (("net_G", self.net_G), ("net_D", self.net_D)):
            if module is not None:
                out.update({f"{prefix}/{k}": v for k, v in module.state_dict().items()})
        if self.ema_G is not None:
            out.update({f"ema_G/{k}": v for k, v in self.ema_G.items()})
        if not self.train:
            return out
        if getattr(self, "perceptual", None) is not None:
            out.update({f"loss/perceptual/{k}": v
                        for k, v in self.perceptual.module.state_dict().items()})
        for key, opt, net in self._optimizers():
            names = [n for n, _ in net.named_parameters()]
            out.update({f"{key}/mu/{n}": t for n, t in zip(names, opt.mu)})
            out.update({f"{key}/nu/{n}": t for n, t in zip(names, opt.nu)})
            out[f"{key}/count"] = torch.tensor(opt.count, dtype=torch.int64)
        out["gen_rng"] = self.gen_rng.get_state()
        out["dis_rng"] = self.dis_rng.get_state()
        out["num_ema_updates"] = torch.tensor(self.num_ema_updates, dtype=torch.int64)
        return out

    @torch.no_grad()
    def load_state_tensors(self, state, resume=True):
        """Copy a checkpoint's tensors into the trainer: the networks and
        the averaged copy always; with ``resume`` (on a training trainer)
        also the loss networks, the optimizers, the generators' states and
        the counters. Every tensor the trainer expects is matched first:
        one the checkpoint lacks, or holds in another shape, raises before
        anything is copied."""
        pairs = []

        def match(prefix, named):
            for name, t in named.items():
                src = state.get(f"{prefix}/{name}")
                if src is None or tuple(src.shape) != tuple(t.shape):
                    raise KeyError(f"checkpoint has no {prefix}/{name} of shape "
                                   f"{tuple(t.shape)}")
                pairs.append((t, src))

        match("net_G", self.net_G.state_dict())
        if self.net_D is not None and any(k.startswith("net_D/") for k in state):
            match("net_D", self.net_D.state_dict())
        if self.ema_G is not None:
            match("ema_G", self.ema_G)
        resume = resume and self.train
        if resume:
            if getattr(self, "perceptual", None) is not None:
                match("loss/perceptual", self.perceptual.module.state_dict())
            for key, opt, net in self._optimizers():
                names = [n for n, _ in net.named_parameters()]
                match(f"{key}/mu", dict(zip(names, opt.mu)))
                match(f"{key}/nu", dict(zip(names, opt.nu)))
            counters = ["gen_rng", "dis_rng", "num_ema_updates"]
            counters += [f"{key}/count" for key, _, _ in self._optimizers()]
            missing = [k for k in counters if k not in state]
            if missing:
                raise KeyError(f"checkpoint has no {missing}")
        for dst, src in pairs:
            dst.copy_(src)
        if not resume:
            return
        for key, opt, _ in self._optimizers():
            opt.count = int(state[f"{key}/count"])
        self.gen_rng.set_state(state["gen_rng"].cpu())
        self.dis_rng.set_state(state["dis_rng"].cpu())
        self.num_ema_updates = int(state["num_ema_updates"])

    def save_checkpoint(self, current_epoch, current_iteration):
        logdir = cfg_get(self.cfg, "logdir", ".")
        meta = {"epoch": int(current_epoch), "iteration": int(current_iteration),
                "batch_in_epoch": int(current_iteration - self._epoch_start_iteration)}
        path = ckpt_lib.save_checkpoint(
            logdir, self.state_tensors(), meta, current_epoch, current_iteration,
            max_to_keep=cfg_get(self.cfg, "checkpoints_to_keep", None))
        print(f"Save checkpoint to {path}")
        return path

    def load_checkpoint(self, checkpoint_path=None, fallback=False):
        """An explicit path loads the weights only; with no path, the
        logdir's pointer resumes the run (verified, with fallback to the
        newest checkpoint that verifies). ``fallback`` lets an explicit
        path whose bytes are corrupt be quarantined and the newest
        verifiable checkpoint in its directory load instead. Returns
        False when there is nothing to load."""
        if self.state is None:
            raise RuntimeError("init_state() before load_checkpoint()")
        logdir = cfg_get(self.cfg, "logdir", ".")
        resume = checkpoint_path is None
        if resume:
            payload, checkpoint_path, fallbacks = ckpt_lib.load_latest_verified(
                logdir, map_location=self.device)
            if payload is None:
                print("No checkpoint found.")
                return False
            if fallbacks:
                print(f"Checkpoint fallback: restored {checkpoint_path} after "
                      f"quarantining {fallbacks} corrupt checkpoint(s)")
        else:
            try:
                payload = ckpt_lib.load_checkpoint(checkpoint_path,
                                                   map_location=self.device)
            except Exception as e:
                if not fallback or not ckpt_lib.is_corrupt_checkpoint_error(e):
                    raise
                print(f"WARNING: checkpoint {checkpoint_path} failed to restore "
                      f"({type(e).__name__}: {str(e)[:200]}); falling back to the "
                      "newest verifiable checkpoint in its directory")
                ckpt_lib.quarantine_checkpoint(checkpoint_path,
                                               reason=type(e).__name__)
                payload, checkpoint_path, _ = ckpt_lib.load_latest_verified(
                    os.path.dirname(os.path.abspath(str(checkpoint_path))),
                    map_location=self.device)
                if payload is None:
                    raise RuntimeError("no verifiable fallback checkpoint beside "
                                       f"{checkpoint_path}") from e
        self.load_state_tensors(payload["state"], resume=resume)
        if resume:
            meta = payload["meta"]
            self.current_epoch = int(meta["epoch"])
            self.current_iteration = int(meta["iteration"])
            self.resume_batch_in_epoch = int(meta.get("batch_in_epoch", 0))
        self.checkpoint_path = checkpoint_path
        print(f"Done with loading the checkpoint {checkpoint_path} "
              f"(resume={resume}).")
        return True

    # ---------------------------------------------------------- inference

    def _inference_data(self, data):
        return data

    def _generate(self, data, params, generator, random_style):
        """G's fake images for ``data`` under ``params`` (None: G's own
        parameters and buffers), the noise drawn from ``generator``."""
        kwargs = {"random_style": random_style, "generator": generator}
        if params is None:
            return self.net_G(data, **kwargs)["fake_images"]
        return torch.func.functional_call(self.net_G, params, (data,), kwargs)["fake_images"]

    @torch.no_grad()
    def test(self, data_loader, output_dir, inference_args=None):
        """One image a test item, ``<output_dir>/<key>.png``, from the
        inference weights; batch ``it``'s noise is drawn from a generator
        seeded with ``it``."""
        os.makedirs(output_dir, exist_ok=True)
        inference_args = dict(inference_args or {})
        random_style = bool(inference_args.get("random_style", False))
        params = self.inference_params()
        for it, data in enumerate(data_loader):
            data = self._inference_data(self.start_of_iteration(data, -1))
            generator = torch.Generator(device=self.device).manual_seed(it)
            images = self._generate(data, params, generator, random_style)
            images = images.float().permute(0, 2, 3, 1).cpu().numpy()
            keys = data.get("key", [f"{it:06d}_{i}" for i in range(images.shape[0])])
            for img, name in zip(images, keys):
                path = os.path.join(output_dir, f"{name}.png")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                save_image_grid([tensor2im(img)], path)

    def save_image(self, path, data):
        vis = self._get_visualizations(data)
        if vis is None:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_tensor_strip(vis, path)
        print(f"Save output images to {path}")

    def _image_path(self, iteration):
        return os.path.join(cfg_get(self.cfg, "logdir", "."), "images",
                            f"{iteration:09d}.png")

    # ------------------------------------------------------------- meters

    def _meter(self, name):
        if name not in self.meters:
            self.meters[name] = Meter(name, self.writer)
        return self.meters[name]

    def _log_losses(self, update_type, losses):
        # values stay on the device until the meters flush
        for name, value in losses.items():
            self._meter(f"{update_type}/{name}").write(value)

    def _flush_meters(self, step):
        for meter in self.meters.values():
            meter.flush(step)
