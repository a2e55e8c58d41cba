"""vid2vid trainer, serving half (port of the inference parts of
``imaginaire_tpu/trainers/vid2vid.py``).

Video inference is frame-recurrent: each frame conditions on the
trainer's own previous outputs, which ``_generate_frame`` keeps in
(B, T, C, H, W) rings of the last ``num_frames_G - 1`` labels and
frames; ``reset()`` starts a new sequence. Data dicts hold NCHW tensors
(5-d with time at dim 1 for whole sequences).

The FlowNet2 teacher (``flow_network``) is built when the generator has
a flow branch (``gen.flow``), and with ``flow_cache.enabled`` it runs off
the step in ``_start_of_iteration``, attaching ``flow_gt`` / ``conf_gt``
to training batches (the teacher half of the JAX trainer's
``_init_loss``). The rollout training step, the discriminators and the
losses come with the vid2vid training slice (ROADMAP.md).
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
from imaginaire_tpu_torch.model_utils.fs_vid2vid import concat_frames
from imaginaire_tpu_torch.trainers.base import BaseTrainer
from imaginaire_tpu_torch.utils.misc import numeric_only

logger = logging.getLogger(__name__)


class Trainer(BaseTrainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device=device)
        self.num_frames_G = cfg_get(self.cfg.data, "num_frames_G", 3)
        self._init_teacher(self.cfg)
        self.reset()

    def _init_teacher(self, cfg):
        """The frozen FlowNet2 teacher and its off-step cache (ref:
        trainers/vid2vid.py:128-178 of the JAX package)."""
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

    def _get_data_t(self, data, t, prev_labels, prev_images):
        """Frame ``t`` of ``data`` plus the history rings. Unlike the JAX
        trainer, ``images`` is optional: the generator never reads the
        current real frame, so a stream frame needs only its label. The
        training targets of later frames (the real previous frame, the
        cached teacher flow) come with the training slice."""
        label = data["label"][:, t] if data["label"].dim() == 5 else data["label"]
        data_t = {"label": label}
        images = data.get("images")
        if images is not None:
            data_t["image"] = images[:, t] if images.dim() == 5 else images
        if prev_images is not None:
            data_t["prev_labels"] = prev_labels
            data_t["prev_images"] = prev_images
        return data_t

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

    def test_single(self, data):
        """Generate the next frame of the current test sequence from one
        frame's data (NCHW tensors or arrays). Call ``reset()`` at each
        sequence start."""
        data = {k: torch.as_tensor(v, device=self.device)
                for k, v in numeric_only(dict(data)).items()}
        data = self._start_of_iteration(data, -1)
        return {"fake_images": self._generate_frame(data, 0)}
