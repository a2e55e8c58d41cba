"""pix2pixHD trainer (port of ``imaginaire_tpu/trainers/pix2pixHD.py``).

The SPADE trainer's steps and losses (no ``kl`` weight: GAN, feature
matching and perceptual only) with three additions:

- ``pre_process``, on the host in ``_start_of_iteration`` (the training
  loop, ``test``, the evaluation sweeps and the image snapshots all reach
  it), replaces the label's trailing instance channel by its edge map and
  adds the raw ids as an int32 ``instance_maps``. It runs in numpy before
  the step casts the floating tensors to the compute dtype: in bf16,
  neighbouring Cityscapes ids (26001, 26002) are one number, and their
  edge would vanish. The int32 map rides through the cast untouched.
- With an instance-feature encoder (``gen.enc``), ``cluster_centers``
  (label_nc, num_clusters, feat_nc), reserved as zeros at ``init_state``,
  is part of the checkpointed state; ``_pre_save_checkpoint`` fills it
  before each save with the port's K-means over the averaged
  generator's encoder features on the validation loader.
- ``_get_visualizations``: image, label channel 0, fake (and the
  averaged weights' fake).

``data.one_hot_on_device`` with ``instance_maps`` is refused: the label is
then an index map, and the JAX package's ``pre_process`` slices its last
column as if it were the instance channel (ROADMAP.md C10).
"""

from __future__ import annotations

import numpy as np
import torch

from imaginaire_tpu_torch.config import cfg_get
from imaginaire_tpu_torch.model_utils.pix2pixHD import cluster_features, get_edges
from imaginaire_tpu_torch.trainers.spade import Trainer as SPADETrainer
from imaginaire_tpu_torch.utils.data import get_paired_input_label_channel_number

CENTERS_KEY = "cluster_centers"


class Trainer(SPADETrainer):
    # the serving engine feeds the request's label as it comes, the raw
    # instance ids in place of the edge map that pre_process makes
    serves_requests = False
    serves_requests_reason = ("requests would need the trainer's instance-edge "
                              "pre_process")

    def __init__(self, cfg, device=None, train=False, iters_per_epoch=1,
                 train_data_loader=None, val_data_loader=None):
        super().__init__(cfg, device=device, train=train, iters_per_epoch=iters_per_epoch,
                         train_data_loader=train_data_loader,
                         val_data_loader=val_data_loader)
        self.contain_instance_map = self.net_G.contain_instance_map
        if self.contain_instance_map and cfg_get(self.cfg.data, "one_hot_on_device", False):
            raise NotImplementedError(
                "data.one_hot_on_device with instance_maps is not in the port "
                "(ROADMAP.md C10): the label would be an index map with no "
                "instance channel to take the edges from")
        self.cluster_centers = None

    # ------------------------------------------------------- preprocessing

    def pre_process(self, data):
        """Host NHWC numpy: the label's last channel (raw instance ids)
        becomes ``instance_maps`` (int32) and its edge map takes its place
        in the label. A batch that already has ``instance_maps`` passes
        through unchanged."""
        if not self.contain_instance_map or "instance_maps" in data:
            return data
        label = np.asarray(data["label"])
        inst = label[..., -1:]
        out = dict(data)
        out["instance_maps"] = inst.astype(np.int32)
        out["label"] = np.concatenate([label[..., :-1], get_edges(inst)], axis=-1)
        return out

    def _start_of_iteration(self, data, current_iteration):
        return self.pre_process(super()._start_of_iteration(data, current_iteration))

    # --------------------------------------------------------- checkpoints

    def init_state(self, seed=0):
        state = super().init_state(seed)
        if self.net_G.concat_features:
            enc_cfg = self.cfg.gen.enc
            self.cluster_centers = torch.zeros(
                (get_paired_input_label_channel_number(self.cfg.data),
                 cfg_get(enc_cfg, "num_clusters", 10), enc_cfg.num_feat_channels),
                dtype=torch.float32, device=self.device)
        return state

    def state_tensors(self):
        out = super().state_tensors()
        if self.cluster_centers is not None:
            out[CENTERS_KEY] = self.cluster_centers
        return out

    @torch.no_grad()
    def load_state_tensors(self, state, resume=True):
        src = None
        if self.cluster_centers is not None:
            src = state.get(CENTERS_KEY)
            if src is None or tuple(src.shape) != tuple(self.cluster_centers.shape):
                raise KeyError(f"checkpoint has no {CENTERS_KEY} of shape "
                               f"{tuple(self.cluster_centers.shape)}")
        super().load_state_tensors(state, resume=resume)
        if src is not None:
            self.cluster_centers.copy_(src)

    @torch.no_grad()
    def _pre_save_checkpoint(self):
        """K-means over the encoder's instance features of the validation
        loader, under the inference weights, into ``cluster_centers``."""
        if not self.net_G.concat_features or self.val_data_loader is None:
            return
        enc_cfg = self.cfg.gen.enc
        prefix = "encoder."
        params = {k[len(prefix):]: v for k, v in self.inference_params().items()
                  if k.startswith(prefix)}
        encoder = self.net_G.encoder

        def encode_fn(data):
            return torch.func.functional_call(
                encoder, params, (data["images"], data["instance_maps"]))

        centers = cluster_features(
            encode_fn, self._eval_loader(self.val_data_loader),
            get_paired_input_label_channel_number(self.cfg.data),
            enc_cfg.num_feat_channels, n_clusters=cfg_get(enc_cfg, "num_clusters", 10),
            is_cityscapes=cfg_get(self.cfg.gen, "is_cityscapes", False))
        self.cluster_centers = torch.from_numpy(centers).to(self.device)

    # ------------------------------------------------------ visualizations

    @torch.no_grad()
    def _get_visualizations(self, data):
        """(image, label channel 0, fake[, fake of the averaged weights])
        as NHWC numpy."""
        data = self._inference_data(data)
        vis = [data["images"][:, :3], data["label"][:, :1],
               self._generate(data, None, None, False)[:, :3]]
        if self.model_average:
            vis.append(self._generate(data, self.inference_params(), None, False)[:, :3])
        return [v.float().permute(0, 2, 3, 1).cpu().numpy() for v in vis]
