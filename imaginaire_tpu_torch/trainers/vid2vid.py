"""vid2vid trainer (port of ``imaginaire_tpu/trainers/vid2vid.py``).

Training is a per-frame rollout (``gen_update``): at each frame t of the
sequence one D step, then one G step, the generator fed its own detached
previous outputs. The history rings hold the last ``num_frames_G - 1``
labels and generated frames; the temporal discriminator's rings hold the
past real and fake frames, sliced per scale with strides tD**s
(``_past_stacks``). The next frame's history takes the G step's own
output, not a second forward after the update. Each step goes through
``BaseTrainer._step``: the compute policy, which network advances its
BatchNorm statistics and spectral-norm ``u`` (the D step runs G in
training mode without advancing G's state), the non-finite guard and the
EMA after every G step. The losses of the frames are averaged per key.
``dis_update`` is a no-op: the D steps run inside the rollout.

The losses: hinge GAN and feature matching of the image discriminator
and of each temporal scale, VGG19 perceptual, optional L1, and the flow
loss: with the FlowNet2 teacher (``flow_network``), ``FlowLoss`` on the
teacher's flow computed in the G step (or on ``flow_gt`` / ``conf_gt``
when the teacher's cache attached them to the batch), else the
warp-consistency masked L1. The teacher's weights are not in a
checkpoint: they come from its weights file or from seed 0.

The sequence-length curriculum (``_start_of_epoch``): one frame until
``single_frame_epoch``, then ``initial_sequence_length``, doubled every
``num_epochs_temporal_step`` epochs up to ``max_sequence_length`` and
the dataset's longest sequence; the dataset (``train_data_loader``) is
told each new length before the epoch's loader starts reading ahead.

Not ported: the whole-rollout scan (``trainer.rollout_scan`` raises) and
the pipelined dispatch (``trainer.pipeline``, which the JAX package
defines as bit-identical to the sequential loop: the port runs the
sequential loop and says so once), the per-frame hooks of wc-vid2vid,
DensePose preprocessing, and video inference from disk (ROADMAP.md).

Video inference is frame-recurrent: each frame conditions on the
trainer's own previous outputs, which ``_generate_frame`` keeps in
(B, T, C, H, W) rings; ``reset()`` starts a new sequence. Data dicts
hold NCHW tensors (5-d with time at dim 1 for whole sequences).
"""

from __future__ import annotations

import logging

import torch
from torch.func import functional_call

from imaginaire_tpu_torch.config import cfg_get
from imaginaire_tpu_torch.flow import (
    FlowNet,
    TeacherFlowCache,
    flow_cache_settings,
    resolve_cache_dir,
)
from imaginaire_tpu_torch.losses import (
    PerceptualLoss,
    dis_accuracy,
    feature_matching_loss,
    gan_loss,
)
from imaginaire_tpu_torch.losses.flow import FlowLoss, masked_l1_loss
from imaginaire_tpu_torch.model_utils.fs_vid2vid import (
    concat_frames,
    get_fg_mask,
    skip_stride_span,
)
from imaginaire_tpu_torch.trainers.base import BaseTrainer
from imaginaire_tpu_torch.utils.misc import numeric_only

logger = logging.getLogger(__name__)


class Trainer(BaseTrainer):
    def __init__(self, cfg, device=None, train=False, iters_per_epoch=1,
                 train_data_loader=None, val_data_loader=None):
        super().__init__(cfg, device=device, train=train,
                         iters_per_epoch=iters_per_epoch,
                         train_data_loader=train_data_loader,
                         val_data_loader=val_data_loader)
        cfg = self.cfg
        self.num_frames_G = cfg_get(cfg.data, "num_frames_G", 3)
        self.num_frames_D = cfg_get(cfg.data, "num_frames_D", 3)
        self.has_fg = cfg_get(cfg.data, "has_foreground", False)
        self.sequence_length = 1
        self.sequence_length_max = cfg_get(
            cfg_get(cfg.data, "train", {}) or {}, "max_sequence_length", 16)
        dataset = self._train_dataset()
        if dataset is not None and hasattr(dataset, "sequence_length_max"):
            self.sequence_length_max = min(self.sequence_length_max,
                                           dataset.sequence_length_max)
        if not self.train:
            self._init_teacher(cfg)
        self.reset()

    # ---------------------------------------------------------------- loss

    def _init_loss(self, cfg):
        tcfg = cfg.trainer
        if cfg_get(tcfg, "rollout_scan", False):
            raise NotImplementedError(
                "trainer.rollout_scan (the whole rollout as one scan) is not "
                "in the port yet (ROADMAP.md); it runs the per-frame rollout")
        if cfg_get(cfg_get(tcfg, "pipeline", None) or {}, "enabled", False):
            print("trainer.pipeline: the pipelined rollout dispatch is not in "
                  "the port yet (ROADMAP.md); running the sequential rollout, "
                  "which the JAX package defines as bit-identical to it")
        lw = tcfg.loss_weight
        self.gan_mode = cfg_get(tcfg, "gan_mode", "hinge")
        if self.gan_mode != "hinge":
            raise NotImplementedError(f"gan_mode {self.gan_mode!r} is not in "
                                      f"the port yet (ROADMAP.md)")
        self.weights["GAN"] = lw.gan
        self.weights["FeatureMatching"] = lw.feature_matching
        self.perceptual = None
        if cfg_get(tcfg, "perceptual_loss", None) is not None:
            p = tcfg.perceptual_loss
            self.perceptual = PerceptualLoss(
                network=p.mode, layers=list(p.layers),
                weights=list(cfg_get(p, "weights", None) or []) or None,
                weights_path=cfg_get(p, "weights_path", None),
                allow_random_init=cfg_get(p, "allow_random_init", False),
                device=self.device)
            self.weights["Perceptual"] = lw.perceptual
        if cfg_get(lw, "L1", 0) > 0:
            self.weights["L1"] = lw.L1
        self.use_flow = cfg_get(cfg.gen, "flow", None) is not None
        if self.use_flow:
            self.weights["Flow"] = lw.flow
        self._init_teacher(cfg)
        if self.flow_net_wrapper is not None:
            self.weights["Flow_L1"] = self.weights["Flow_Warp"] = \
                self.weights["Flow_Mask"] = lw.flow
        self.num_temporal_scales = cfg_get(
            cfg_get(cfg.dis, "temporal", {}) or {}, "num_scales", 0)
        for s in range(self.num_temporal_scales):
            self.weights[f"GAN_T{s}"] = cfg_get(lw, "temporal_gan", 0)
            self.weights[f"FeatureMatching_T{s}"] = lw.feature_matching

    def init_loss_params(self, generator):
        if self.perceptual is not None:
            self.perceptual.init_params(generator)

    def _init_teacher(self, cfg):
        """The frozen FlowNet2 teacher and its off-step cache."""
        self.flow_net_wrapper = None
        self.flow_cache = None
        fn_cfg = cfg_get(cfg, "flow_network", None)
        if cfg_get(cfg.gen, "flow", None) is None or fn_cfg is None:
            return
        try:
            self.flow_net_wrapper = FlowNet(
                weights_path=cfg_get(fn_cfg, "weights_path", None),
                allow_random_init=cfg_get(fn_cfg, "allow_random_init", False),
                device=self.device)
            self.flow_net_wrapper.init_params(0)
        except FileNotFoundError as e:
            logger.warning("FlowNet2 teacher unavailable (%s); using "
                           "warp-consistency flow loss.", e)
            self.flow_net_wrapper = None
            return
        settings = flow_cache_settings(cfg)
        if settings.enabled:
            self.flow_cache = TeacherFlowCache(
                self.flow_net_wrapper, settings,
                cache_dir=resolve_cache_dir(cfg))

    def _teacher_flow(self, im_a, im_b):
        """The teacher's (flow, conf) from ``im_a`` to ``im_b`` in fp32
        (the G step's in-graph teacher; FlowLoss runs it without grad)."""
        return self.flow_net_wrapper._flow_fn(im_a.float(), im_b.float())

    # ---------------------------------------------------------- data hooks

    def _start_of_iteration(self, data, current_iteration):
        """Data hook before a frame or sequence. Training iterations
        (``current_iteration >= 0``) get the teacher's ``flow_gt`` /
        ``conf_gt`` when the flow cache is on; a dataset's
        ``_flow_cache`` payload that no cache consumes is dropped. Pose
        datasets need DensePose preprocessing, which is not in the port
        yet."""
        if self.flow_cache is not None and current_iteration >= 0:
            data = self.flow_cache.attach(dict(data))
        elif isinstance(data, dict) and "_flow_cache" in data:
            data = dict(data)
            data.pop("_flow_cache")
        pose_cfg = cfg_get(self.cfg.data, "for_pose_dataset", None)
        if pose_cfg is not None and "pose_maps-densepose" in (
                cfg_get(self.cfg.data, "input_labels", []) or []):
            raise NotImplementedError(
                "DensePose preprocessing for pose datasets is not in the "
                "port yet (ROADMAP.md)")
        return data

    def _end_of_iteration(self, data, current_epoch, current_iteration):
        """The teacher cache's stats into the meters."""
        if self.flow_cache is not None:
            for name, value in self.flow_cache.drain_stats().items():
                self._meter(name).write(value)

    def _get_data_t(self, data, t, prev_labels, prev_images):
        """Frame ``t`` of ``data`` plus the history rings and, from the
        second frame of a sequence, the real previous frame (the teacher's
        input) and the cached teacher flow from frame t to t - 1. Unlike
        the JAX trainer, ``images`` is optional: the generator never reads
        the current real frame, so a stream frame needs only its label."""
        label = data["label"][:, t] if data["label"].dim() == 5 else data["label"]
        data_t = {"label": label}
        images = data.get("images")
        if images is not None:
            data_t["image"] = images[:, t] if images.dim() == 5 else images
        if prev_images is not None:
            data_t["prev_labels"] = prev_labels
            data_t["prev_images"] = prev_images
        if t > 0 and images is not None and images.dim() == 5:
            data_t["real_prev_image"] = images[:, t - 1]
            if data.get("flow_gt") is not None:
                data_t["flow_gt"] = data["flow_gt"][:, t - 1]
                data_t["conf_gt"] = data["conf_gt"][:, t - 1]
        return data_t

    def _past_stacks(self, past_real, past_fake):
        """{'s<scale>': (real, fake)} strided stacks of past frames from the
        rings, for each temporal scale whose span the rings cover (the
        rings exclude the current frame, which the discriminator
        appends)."""
        stacks = {}
        if past_real is None:
            return stacks
        length = past_real.shape[1]
        for s in range(self.num_temporal_scales):
            t_step, t_span = skip_stride_span(self.num_frames_D, s)
            if length >= t_span:
                stacks[f"s{s}"] = (past_real[:, -t_span::t_step],
                                   past_fake[:, -t_span::t_step])
        return stacks

    def _stacks_list(self, stacks):
        return [stacks.get(f"s{s}") for s in range(self.num_temporal_scales)]

    # ------------------------------------------------------------ forwards

    def _gan_fm_losses(self, d_out_part, dis_update):
        """(GAN, feature matching) of one discriminator's outputs; the D
        step's GAN is the mean of its fake and real hinge terms."""
        fake, real = d_out_part["pred_fake"], d_out_part["pred_real"]
        if dis_update:
            gan = 0.5 * (gan_loss(fake["outputs"], False, self.gan_mode, True)
                         + gan_loss(real["outputs"], True, self.gan_mode, True))
            return gan, None
        gan = gan_loss(fake["outputs"], True, self.gan_mode, False)
        return gan, feature_matching_loss(fake["features"], real["features"])

    @staticmethod
    def _split_data_t(data):
        data = dict(data)
        return data, data.pop("past_stacks", {})

    def gen_forward(self, data):
        """(losses, G's output) of one frame's G step."""
        data_t, stacks = self._split_data_t(data)
        out = self.net_G(data_t)
        d_out = self.net_D(data_t, out, past_stacks=self._stacks_list(stacks))
        losses = {}
        losses["GAN"], losses["FeatureMatching"] = self._gan_fm_losses(
            d_out["indv"], dis_update=False)
        if self.perceptual is not None:
            losses["Perceptual"] = self.perceptual(out["fake_images"],
                                                   data_t["image"])
        if "L1" in self.weights:
            losses["L1"] = (out["fake_images"] - data_t["image"]).abs().mean()
        if "raw" in d_out:
            raw_gan, raw_fm = self._gan_fm_losses(d_out["raw"], dis_update=False)
            losses["GAN"] = losses["GAN"] + raw_gan
            losses["FeatureMatching"] = losses["FeatureMatching"] + raw_fm
            if self.perceptual is not None:
                fg = get_fg_mask(data_t["label"], self.has_fg)
                losses["Perceptual"] = losses["Perceptual"] + self.perceptual(
                    out["fake_raw_images"] * fg, data_t["image"] * fg)
        if self.use_flow and out.get("warped_images") is not None:
            cached_gt = data_t.get("flow_gt") is not None
            if self.flow_net_wrapper is not None and (
                    cached_gt or data_t.get("real_prev_image") is not None):
                if cached_gt:
                    flow_loss = FlowLoss(None, has_fg=self.has_fg)
                    loss_data = {"image": data_t["image"],
                                 "flow_gt": data_t["flow_gt"],
                                 "conf_gt": data_t["conf_gt"]}
                else:
                    flow_loss = FlowLoss(self._teacher_flow, has_fg=self.has_fg)
                    loss_data = {"image": data_t["image"],
                                 "real_prev_image": data_t["real_prev_image"]}
                (losses["Flow_L1"], losses["Flow_Warp"],
                 losses["Flow_Mask"]) = flow_loss(loss_data, out)
            else:
                # warp consistency; the occlusion mask weights its own loss,
                # so it is held constant there
                losses["Flow"] = masked_l1_loss(
                    out["fake_images"], out["warped_images"],
                    out["fake_occlusion_masks"].detach())
        for s in range(self.num_temporal_scales):
            if f"temporal_{s}" in d_out:
                losses[f"GAN_T{s}"], losses[f"FeatureMatching_T{s}"] = \
                    self._gan_fm_losses(d_out[f"temporal_{s}"], dis_update=False)
        return losses, out

    def dis_forward(self, data):
        """Losses of one frame's D step (G's output without gradient)."""
        data_t, stacks = self._split_data_t(data)
        with torch.no_grad():
            out = {k: v for k, v in self.net_G(data_t).items() if v is not None}
        d_out = self.net_D(data_t, out, past_stacks=self._stacks_list(stacks))
        losses = {}
        losses["GAN"], _ = self._gan_fm_losses(d_out["indv"], dis_update=True)
        losses["D_real_acc"], losses["D_fake_acc"] = dis_accuracy(
            d_out["indv"]["pred_real"]["outputs"],
            d_out["indv"]["pred_fake"]["outputs"], self.gan_mode)
        if "raw" in d_out:
            losses["GAN"] = losses["GAN"] + self._gan_fm_losses(
                d_out["raw"], dis_update=True)[0]
        for s in range(self.num_temporal_scales):
            if f"temporal_{s}" in d_out:
                losses[f"GAN_T{s}"], _ = self._gan_fm_losses(
                    d_out[f"temporal_{s}"], dis_update=True)
        return losses

    def _scratch_state_nets(self, net):
        """The JAX trainer applies G with its state mutable in the D step
        too, and drops the update (``_apply_G``): the label embedder's two
        calls in a continuation frame see one power step each."""
        return (self.net_G,) if net is self.net_D else ()

    # ------------------------------------------------------------- rollout

    def dis_update(self, data, noise=None):
        """No-op: the D steps run inside ``gen_update``'s rollout."""
        return None

    def gen_update(self, data, noise=None):
        """The per-frame D-then-G rollout over ``data`` ({"label",
        "images"[, "flow_gt", "conf_gt"]}: (B, T, C, H, W) tensors on the
        trainer's device, or one (B, C, H, W) frame). Returns the G
        losses averaged over the frames."""
        if self.state is None:
            raise RuntimeError("init_state() before gen_update()")
        data = self._prepare(numeric_only(dict(data)))
        images = data["images"]
        seq_len = images.shape[1] if images.dim() == 5 else 1
        tD = self.num_frames_D
        max_prev = (tD ** max(self.num_temporal_scales - 1, 0)) * (tD - 1)
        prev_labels = prev_images = past_real = past_fake = None
        d_hist, g_hist = [], []
        for t in range(seq_len):
            data_t = self._get_data_t(data, t, prev_labels, prev_images)
            data_t["past_stacks"] = self._past_stacks(past_real, past_fake)
            d_hist.append(self._step(self.net_D, self.opt_D,
                                     lambda: self.dis_forward(data_t),
                                     self.clip_grad_norm_D, "dis_step"))
            held = {}

            def g_forward():
                losses, out = self.gen_forward(data_t)
                held["fake"] = out["fake_images"].detach()
                return losses

            g_hist.append(self._step(self.net_G, self.opt_G, g_forward,
                                     self.clip_grad_norm_G, "gen_step"))
            fake = held["fake"]
            if self.num_temporal_scales > 0:
                past_real = concat_frames(past_real, data_t["image"], max_prev)
                past_fake = concat_frames(past_fake, fake, max_prev)
            prev_labels = concat_frames(prev_labels, data_t["label"],
                                        self.num_frames_G - 1)
            prev_images = concat_frames(prev_images, fake, self.num_frames_G - 1)
        d_losses, g_losses = _mean_losses(d_hist), _mean_losses(g_hist)
        self._log_losses("dis_update", d_losses)
        self._log_losses("gen_update", g_losses)
        return g_losses

    def recalculate_model_average_batch_norm_statistics(self, data_loader=None):
        """No-op for the video family, as in the JAX package: its EMA copy
        keeps the live network's running statistics."""
        return

    # ----------------------------------------------------------- curriculum

    def _train_dataset(self):
        return getattr(self.train_data_loader, "dataset", None)

    def _set_dataset_sequence_length(self, length):
        dataset = self._train_dataset()
        if dataset is not None:
            dataset.set_sequence_length(length)

    def _start_of_epoch(self, current_epoch):
        """The sequence-length curriculum."""
        cfg = self.cfg
        single_frame_epoch = cfg_get(cfg, "single_frame_epoch", 0)
        if current_epoch < single_frame_epoch:
            self._set_dataset_sequence_length(1)
            self.sequence_length = 1
            return
        if current_epoch == single_frame_epoch:
            self.init_temporal_network()
        temp_epoch = current_epoch - single_frame_epoch
        if temp_epoch > 0:
            initial = cfg_get(cfg_get(cfg.data, "train", {}) or {},
                              "initial_sequence_length", 4)
            step = cfg_get(cfg, "num_epochs_temporal_step", 1)
            seq = min(initial * (2 ** (temp_epoch // step)),
                      self.sequence_length_max)
            if seq > self.sequence_length:
                self.sequence_length = seq
                self._set_dataset_sequence_length(seq)
                print(f"------- Updating sequence length to {seq} -------")

    def init_temporal_network(self):
        """Start temporal training: ``initial_sequence_length`` frames
        (the generator's temporal modules exist from construction)."""
        self.sequence_length = min(
            cfg_get(cfg_get(self.cfg.data, "train", {}) or {},
                    "initial_sequence_length", 4), self.sequence_length_max)
        self._set_dataset_sequence_length(self.sequence_length)
        print(f"------ Now start training {self.sequence_length} frames -------")

    # ---------------------------------------------------------- checkpoints

    def state_tensors(self):
        out = super().state_tensors()
        if self.train:
            out["sequence_length"] = torch.tensor(self.sequence_length,
                                                  dtype=torch.int64)
        return out

    def load_state_tensors(self, state, resume=True):
        resume = resume and self.train
        if resume and "sequence_length" not in state:
            raise KeyError("checkpoint has no ['sequence_length']")
        super().load_state_tensors(state, resume=resume)
        if resume:
            self.sequence_length = int(state["sequence_length"])
            self._set_dataset_sequence_length(self.sequence_length)

    # -------------------------------------------------------- visualization

    @torch.no_grad()
    def _get_visualizations(self, data):
        """(last real frame, its label's first 3 channels, last generated
        frame) as NHWC numpy: the sequence rolled out with the inference
        weights."""
        data = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
                for k, v in numeric_only(dict(data)).items()}
        params = self.inference_params()
        seq_len = data["images"].shape[1] if data["images"].dim() == 5 else 1
        prev_labels = prev_images = None
        fake = None
        for t in range(seq_len):
            data_t = self._get_data_t(data, t, prev_labels, prev_images)
            fake = self._apply_G(params, data_t)["fake_images"]
            prev_labels = concat_frames(prev_labels, data_t["label"],
                                        self.num_frames_G - 1)
            prev_images = concat_frames(prev_images, fake, self.num_frames_G - 1)
        label = data["label"][:, -1] if data["label"].dim() == 5 else data["label"]
        image = data["images"][:, -1] if data["images"].dim() == 5 else data["images"]
        return [v.float().permute(0, 2, 3, 1).cpu().numpy()
                for v in (image, label[:, :3], fake)]

    # ------------------------------------------------------------ inference

    def _apply_G(self, params, data_t):
        """The generator's output dict for one frame under ``params``
        (``inference_params()``)."""
        return functional_call(self.net_G, params, (data_t,), strict=True)

    def reset(self):
        """Start a new test sequence: forget the rollout history."""
        self._test_prev_labels = None
        self._test_prev_images = None

    @torch.no_grad()
    def _generate_frame(self, data, t):
        """Generate frame ``t`` of ``data`` from the stored history and
        advance the history rings."""
        data_t = self._get_data_t(data, t, self._test_prev_labels,
                                  self._test_prev_images)
        fake = self._apply_G(self.inference_params(), data_t)["fake_images"]
        self._test_prev_labels = concat_frames(
            self._test_prev_labels, data_t["label"], self.num_frames_G - 1)
        self._test_prev_images = concat_frames(
            self._test_prev_images, fake, self.num_frames_G - 1)
        return fake

    def test(self, data_loader, output_dir, inference_args=None):
        """Video inference from disk (pinned sequences rolled out frame by
        frame) is not ported yet."""
        raise NotImplementedError(
            "vid2vid inference from disk (trainer.test, the pinned-sequence "
            "rollout) is not in the port yet (ROADMAP.md); stream frames "
            "through the serving engine or test_single()")

    def test_single(self, data):
        """Generate the next frame of the current test sequence from one
        frame's data (NCHW tensors or arrays). Call ``reset()`` at each
        sequence start."""
        data = {k: torch.as_tensor(v, device=self.device)
                for k, v in numeric_only(dict(data)).items()}
        data = self._start_of_iteration(data, -1)
        return {"fake_images": self._generate_frame(data, 0)}


def _mean_losses(hist):
    """Each key's mean over the frames that have it."""
    keys = dict.fromkeys(k for h in hist for k in h)
    out = {}
    for k in keys:
        values = [h[k] for h in hist if k in h]
        out[k] = sum(values) / len(values)
    return out
