"""vid2vid trainer, serving half (port of the inference parts of
``imaginaire_tpu/trainers/vid2vid.py``).

Video inference is frame-recurrent: each frame conditions on the
trainer's own previous outputs, which ``_generate_frame`` keeps in
(B, T, C, H, W) rings of the last ``num_frames_G - 1`` labels and
frames; ``reset()`` starts a new sequence. Data dicts hold NCHW tensors
(5-d with time at dim 1 for whole sequences). The FlowNet2 teacher
(``flow_network``) supervises training only and is not built here; the
rollout training step, the discriminators and the losses come with the
vid2vid training slice (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from imaginaire_tpu_torch.config import cfg_get
from imaginaire_tpu_torch.model_utils.fs_vid2vid import concat_frames
from imaginaire_tpu_torch.trainers.base import BaseTrainer
from imaginaire_tpu_torch.utils.misc import numeric_only


class Trainer(BaseTrainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device=device)
        self.num_frames_G = cfg_get(self.cfg.data, "num_frames_G", 3)
        self.reset()

    def _start_of_iteration(self, data, current_iteration):
        """Data hook before a frame or sequence. Pose datasets need
        DensePose preprocessing, which is not in the port yet; other
        data passes through (the flow-cache attachment of the JAX
        trainer serves training only)."""
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
