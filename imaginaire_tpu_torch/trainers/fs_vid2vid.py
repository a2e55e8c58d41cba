"""Few-shot vid2vid trainer (port of ``imaginaire_tpu/trainers/fs_vid2vid.py``).

The vid2vid trainer's per-frame D-then-G rollout, inference and
checkpoints, with the K reference frames (``ref_images``,
``ref_labels``: (B, K, C, H, W)) carried into every frame's data. The
generator's flow outputs are [reference, previous] pairs: the G step's
``Flow`` loss is the mean, over the warps that ran, of the masked L1
between the generated frame and the warped frame, the occlusion mask
held constant. No FlowNet2 teacher runs in the G step (as in the JAX
package): ``Flow_L1`` is computed only from a cached ``flow_gt`` /
``conf_gt`` (the teacher cache, ``flow_cache``), on the previous-frame
flow. A configured ``flow_network`` is still built, as the JAX trainer
builds it.

The G step also takes the region discriminators' losses
(``GAN_<name>``, ``FeatureMatching_<name>``) of pose data, whose
few-shot region Ds see the reference frame's crop beside the frame's.

Inference pins the driving sequence (``inference_args.driving_seq_index``,
else every sequence) and its reference (``few_shot_seq_index``,
``few_shot_frame_index``). With ``inference_args.finetune`` the model is
first adapted to the reference frames of the test loader's first batch
(``finetune``): ``finetune_iter`` one-frame D+G iterations, each on one
reference frame, rolled and flipped, as the target, G's update limited to
the parameters under ``finetune_param_prefixes`` (default
``weight_generator``, ``conv_img``, ``up``), both optimizers fresh at
the config's learning rates. Its draws come from a ``RandomState`` of
the run's seed (the JAX package draws from ``np.random``). The trainer
must be built for training (``train=True``; the inference entry does so
when the config asks for the finetune), since the finetune steps D and
G. Not in the port yet (ROADMAP.md): the video FID/KID/PRDC of this
family: ``evaluate`` raises, and a training snapshot skips FID with a
message.
"""

from __future__ import annotations

import numpy as np
import torch

from imaginaire_tpu_torch.bridge import flax_path
from imaginaire_tpu_torch.config import cfg_get
from imaginaire_tpu_torch.losses.flow import masked_l1_loss
from imaginaire_tpu_torch.model_utils.fs_vid2vid import concat_frames, random_roll
from imaginaire_tpu_torch.optim.optimizers import get_optimizer_for_params
from imaginaire_tpu_torch.trainers.vid2vid import Trainer as Vid2VidTrainer
from imaginaire_tpu_torch.utils.misc import numeric_only

FINETUNE_PREFIXES = ("weight_generator", "conv_img", "up")

_NO_FID = ("the video FID/KID/PRDC of fs-vid2vid are not in the port yet "
           "(ROADMAP.md)")


class Trainer(Vid2VidTrainer):
    def _get_data_t(self, data, t, prev_labels, prev_images):
        """The vid2vid frame data plus the reference frames, the same at
        every frame of a clip."""
        data_t = super()._get_data_t(data, t, prev_labels, prev_images)
        data_t["ref_images"] = data["ref_images"]
        if "ref_labels" in data:
            data_t["ref_labels"] = data["ref_labels"]
        return data_t

    def gen_forward(self, data):
        """(losses, G's output) of one frame's G step."""
        data_t, stacks = self._split_data_t(data)
        out = self.net_G(data_t)
        d_out = self.net_D(data_t, out, past_stacks=self._stacks_list(stacks))
        losses = {}
        losses["GAN"], losses["FeatureMatching"] = self._gan_fm_losses(
            d_out["indv"], dis_update=False)
        if self.perceptual is not None:
            losses["Perceptual"] = self.perceptual(out["fake_images"], data_t["image"])
        if "L1" in self.weights:
            losses["L1"] = (out["fake_images"] - data_t["image"]).abs().mean()
        if self.use_flow:
            terms = [masked_l1_loss(out["fake_images"], warp, occ.detach())
                     for warp, occ in zip(out["warped_images"],
                                          out["fake_occlusion_masks"])
                     if warp is not None]
            if terms:
                losses["Flow"] = sum(terms) / len(terms)
            if "Flow_L1" in self.weights and data_t.get("flow_gt") is not None \
                    and out["fake_flow_maps"][-1] is not None:
                losses["Flow_L1"] = masked_l1_loss(
                    out["fake_flow_maps"][-1], data_t["flow_gt"].detach(),
                    data_t["conf_gt"].detach())
        for s in range(self.num_temporal_scales):
            if f"temporal_{s}" in d_out:
                losses[f"GAN_T{s}"], losses[f"FeatureMatching_T{s}"] = \
                    self._gan_fm_losses(d_out[f"temporal_{s}"], dis_update=False)
        return self._region_d_losses(d_out, losses, dis_update=False), out

    # ------------------------------------------------------------ inference

    def finetune_mask(self, prefixes=FINETUNE_PREFIXES):
        """{G parameter name: trainable in the finetune}: a parameter
        trains when a segment of its JAX path (the port names its modules
        as the JAX package does: ``bridge.flax_path``) starts with one of
        ``prefixes``, as the JAX finetune's mask reads the path."""
        return {name: any(seg.startswith(pref) for seg in flax_path(name)
                          for pref in prefixes)
                for name, _ in self.net_G.named_parameters()}

    def finetune(self, data, inference_args=None):
        """Adapt the model to the reference frames of ``data`` (a batch
        on the device, after ``start_of_iteration(.., -1)``): fresh
        optimizers, G's over the masked parameters alone, then
        ``finetune_iter`` D+G iterations, each a one-frame sequence whose
        label and image are one reference frame, picked at random, rolled
        and flipped (``random_roll``); the references stay as they are."""
        if not self.train:
            raise RuntimeError("the finetune steps D and G: build the trainer "
                               "with train=True")
        inference_args = dict(inference_args or {})
        prefixes = tuple(cfg_get(inference_args, "finetune_param_prefixes", None)
                         or FINETUNE_PREFIXES)
        iterations = int(cfg_get(inference_args, "finetune_iter", 100))
        mask = self.finetune_mask(prefixes)
        self.opt_G = get_optimizer_for_params(
            self.cfg.gen_opt, [p for n, p in self.net_G.named_parameters() if mask[n]])
        self.opt_D = get_optimizer_for_params(self.cfg.dis_opt, self.net_D.parameters())
        rng = np.random.RandomState(self.state["seed"])
        ref_labels, ref_images = data["ref_labels"], data["ref_images"]
        k = ref_images.shape[1]
        for _ in range(iterations):
            idx = int(rng.randint(k))
            label, image = random_roll([ref_labels[:, idx], ref_images[:, idx]], rng)
            self.gen_update(dict(data, label=label[:, None], images=image[:, None]))
        self.has_finetuned = True

    def _optimizers(self):
        """Raises once the finetune replaced G's optimizer by one over a
        subset of G's parameters: no checkpoint holds that state."""
        if getattr(self, "has_finetuned", False):
            raise RuntimeError("a finetuned trainer saves no checkpoint: its G "
                               "optimizer covers the finetune's parameters alone")
        return super()._optimizers()

    def test(self, data_loader, output_dir, inference_args=None):
        """Optionally finetune on the first batch of ``data_loader`` (once),
        then the vid2vid test loop."""
        inference_args = dict(inference_args or {})
        if inference_args.pop("finetune", False) \
                and not getattr(self, "has_finetuned", False):
            first = self.start_of_iteration(next(iter(data_loader)), current_iteration=-1)
            self.finetune(first, inference_args)
        inference_args.pop("finetune_iter", None)
        inference_args.pop("finetune_param_prefixes", None)
        return super().test(data_loader, output_dir, inference_args)

    def _inference_sequence_indices(self, dataset, inference_args):
        """An explicit ``driving_seq_index`` tests that sequence alone."""
        if "driving_seq_index" in inference_args:
            return [int(inference_args["driving_seq_index"])]
        return super()._inference_sequence_indices(dataset, inference_args)

    def _pin_inference_sequence(self, dataset, seq_idx, inference_args):
        dataset.set_inference_sequence_idx(
            seq_idx, inference_args.get("few_shot_seq_index"),
            inference_args.get("few_shot_frame_index", 0))

    @torch.no_grad()
    def _get_visualizations(self, data):
        """(the first reference, the last real frame, the last generated
        frame[, its warped reference]) as NHWC numpy, the sequence rolled
        out with the inference weights."""
        data = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
                for k, v in numeric_only(dict(data)).items()}
        params = self.inference_params()
        seq_len = data["images"].shape[1] if data["images"].dim() == 5 else 1
        prev_labels = prev_images = out = None
        for t in range(seq_len):
            data_t = self._get_data_t(data, t, prev_labels, prev_images)
            out = self._apply_G(params, data_t)
            prev_labels = concat_frames(prev_labels, data_t["label"],
                                        self.num_frames_G - 1)
            prev_images = concat_frames(prev_images, out["fake_images"],
                                        self.num_frames_G - 1)
        image = data["images"][:, -1] if data["images"].dim() == 5 else data["images"]
        vis = [data["ref_images"][:, 0], image, out["fake_images"]]
        if out["warped_images"][0] is not None:
            vis.append(out["warped_images"][0])
        return [v.float().permute(0, 2, 3, 1).cpu().numpy() for v in vis]

    # ----------------------------------------------------------- evaluation

    def write_metrics(self):
        """In training, a snapshot's FID is skipped with a message; the
        ``evaluate`` entry's call raises (``_compute_fid``)."""
        if self.train:
            print(f"FID skipped: {_NO_FID}")
            return None
        return super().write_metrics()

    def _compute_fid(self):
        raise NotImplementedError(_NO_FID)

    def _extra_metric_activations(self, extractor):
        raise NotImplementedError(_NO_FID)
