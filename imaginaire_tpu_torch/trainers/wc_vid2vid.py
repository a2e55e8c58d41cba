"""World-consistent vid2vid trainer (port of
``imaginaire_tpu/trainers/wc_vid2vid.py``).

The vid2vid trainer plus:

- the renderer's lifecycle. One ``SplatRenderer`` a batch element, on
  the host: reset at each training clip (``gen_update``), each test
  sequence (``_start_of_test_sequence``) and ``reset()``; before each
  frame the point cloud is rendered into the frame's guidance (``B, 4,
  H, W``, copied to the card; ``_get_data_t``), and once the frame exists
  it colors the points it sees first (``_after_gen_frame``: the frame is
  read back, as uint8, in one copy). The pixel-to-point mappings come
  from the data's ``unprojections`` (``_point_info``) and stay on the
  host under the frame's ``_point_infos`` key, which no step reads;
- the single-image takeover (``gen.single_image_model``): a frozen SPADE
  generator, built from the config the entry names, produces every frame
  the wc generator would start from scratch (no warp yet:
  ``_frame_override``); those frames take no D or G step but color the
  point cloud and feed the history. Its weights come from a checkpoint of
  the port's SPADE trainer (``state.pt``'s ``net_G/`` tensors, through
  the verified load), or are drawn from seed 0 under
  ``allow_random_init``. Its style code z is drawn once a sequence from
  a ``torch.Generator`` seeded ``77321 + sequence`` (the JAX package
  keys it the same way; the draws differ) and runs in fp32, as the JAX
  package's fp32 variables do;
- the ``Guidance`` loss (``trainer.loss_weight.guidance``): the masked L1
  between the generated frame and the guidance's colors, normalized over
  the valid pixels.

Video FID, KID and PRDC are vid2vid's: their rollout goes through both
hooks and ``reset()`` starts each sequence. The serving engine's streams
run neither hook and refuse this family (``serves_streams``).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from imaginaire_tpu_torch.config import Config, as_attrdict, cfg_get
from imaginaire_tpu_torch.losses.flow import masked_l1_loss
from imaginaire_tpu_torch.model_utils.wc_vid2vid import SplatRenderer, guidance_tensor
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.trainers.vid2vid import Trainer as Vid2VidTrainer
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.utils.init_weight import init_weights

SINGLE_Z_SEED = 77321


class Trainer(Vid2VidTrainer):
    # the serving engine's streams run no per-frame hooks (ROADMAP.md A.6)
    serves_streams = False

    def __init__(self, cfg, device=None, train=False, iters_per_epoch=1,
                 train_data_loader=None, val_data_loader=None):
        self.renderers = {}  # batch element -> SplatRenderer
        self.is_flipped_input = False
        self._single_seq = -1
        self._single_z = None
        super().__init__(cfg, device=device, train=train,
                         iters_per_epoch=iters_per_epoch,
                         train_data_loader=train_data_loader,
                         val_data_loader=val_data_loader)
        self.single_image_model = self._init_single_image_model(self.cfg)

    # ------------------------------------------------------ single-image model

    def _init_single_image_model(self, cfg):
        """The frozen single-image generator of ``gen.single_image_model``
        (None without that section): ``config`` names its yaml,
        ``checkpoint`` a checkpoint directory or a logdir with a
        ``latest_checkpoint.txt``; without a checkpoint,
        ``allow_random_init`` permits seeded random weights (tests)."""
        sim_cfg = cfg_get(cfg.gen, "single_image_model", None)
        if sim_cfg is None:
            return None
        sim_cfg = as_attrdict(sim_cfg)
        cfg_path = cfg_get(sim_cfg, "config", None)
        if cfg_path is None:
            raise ValueError("gen.single_image_model needs a 'config' key naming the "
                             "single-image stage's yaml")
        cfg_path = self._resolve_config_path(cfg_path, cfg_get(cfg, "source_filename", None))
        single_cfg = Config(cfg_path)
        with torch.device(self.device):
            model = resolve(single_cfg.gen.type, "Generator")(single_cfg.gen, single_cfg.data)
        model.eval().requires_grad_(False)
        ckpt = cfg_get(sim_cfg, "checkpoint", None)
        if ckpt:
            path = ckpt
            if os.path.isdir(ckpt) and os.path.exists(os.path.join(ckpt, ckpt_lib.POINTER)):
                path = ckpt_lib.latest_checkpoint_path(ckpt)
            if path is None or not os.path.exists(path):
                raise FileNotFoundError(
                    f"gen.single_image_model.checkpoint={ckpt!r} does not resolve to "
                    f"a checkpoint; train the single-image stage ({cfg_path}) first")
            state = ckpt_lib.load_checkpoint(path)["state"]
            weights = {k[len("net_G/"):]: v for k, v in state.items()
                       if k.startswith("net_G/")}
            if not weights:
                raise ValueError(f"checkpoint {path} has no generator tensors "
                                 "('net_G/'); is it a training checkpoint?")
            model.load_state_dict(weights, strict=True)
            print(f"Loaded single image model from {path}")
        elif not cfg_get(sim_cfg, "allow_random_init", False):
            raise ValueError(
                "gen.single_image_model needs a 'checkpoint' key (or "
                "allow_random_init: True for tests): without trained weights the "
                "early-sequence takeover would emit noise")
        else:
            print("single_image_model: RANDOM weights (allow_random_init), test use only")
            init = cfg_get(cfg_get(single_cfg, "trainer", None) or {}, "init", None) or {}
            init_weights(model, torch.Generator(device=self.device).manual_seed(0),
                         cfg_get(init, "type", "xavier"), cfg_get(init, "gain", 0.02))
        return model

    @staticmethod
    def _resolve_config_path(path, parent_config_path):
        """The single-image config's path: as given when it exists (or is
        absolute), else found by walking up from the parent config's
        directory (the configs name repository-relative paths)."""
        if os.path.isabs(path) or os.path.exists(path):
            return path
        base = (os.path.dirname(os.path.abspath(parent_config_path))
                if parent_config_path else None)
        while base:
            candidate = os.path.join(base, path)
            if os.path.exists(candidate):
                return candidate
            parent = os.path.dirname(base)
            if parent == base:
                break
            base = parent
        return path  # Config() raises its own FileNotFoundError

    def _single_image_z(self, batch):
        """This sequence's style code, (batch, style_dims): drawn on the
        sequence's first takeover from a generator seeded ``77321 +
        sequence``, and redrawn from the same seed if the batch changes."""
        if self._single_z is None:
            self._single_seq += 1
        z = self._single_z
        if z is None or z.shape[0] != batch:
            gen = torch.Generator(device=self.device).manual_seed(
                SINGLE_Z_SEED + self._single_seq)
            z = torch.randn((batch, self.single_image_model.style_dims), generator=gen,
                            device=self.device)
            self._single_z = z
        return z

    @torch.no_grad()
    def _frame_override(self, data_t):
        """The single-image generator's frame where the wc generator
        would not warp (no full history yet), else None. The fp32 frame
        is kept under ``_override`` for the renderer."""
        if self.single_image_model is None:
            return None
        prev = data_t.get("prev_images")
        if self.net_G.has_flow and prev is not None \
                and prev.shape[1] == self.num_frames_G - 1:
            return None
        label = data_t["label"].float()
        out = self.single_image_model({"label": label}, random_style=True,
                                      noise=self._single_image_z(label.shape[0]))
        fake = out["fake_images"]
        data_t["_override"] = fake
        return fake.to(data_t.get("image", data_t["label"]).dtype)

    # --------------------------------------------------------------- losses

    def _init_loss(self, cfg):
        """vid2vid's losses plus ``Guidance``."""
        super()._init_loss(cfg)
        lw = cfg.trainer.loss_weight
        if cfg_get(lw, "guidance", None) is not None:
            self.weights["Guidance"] = lw.guidance

    def gen_forward(self, data):
        losses, out = super().gen_forward(data)
        if "Guidance" in self.weights:
            guidance = data.get("guidance")
            if guidance is not None:
                losses["Guidance"] = masked_l1_loss(
                    out["fake_images"], guidance[:, :3], guidance[:, 3:],
                    normalize_over_valid=True)
            else:
                losses["Guidance"] = torch.zeros((), device=self.device)
        return losses, out

    # ------------------------------------------------------------- renderer

    def reset_renderer(self, is_flipped_input=False):
        """Forget the point clouds and this sequence's style code."""
        self.renderers = {}
        self.is_flipped_input = is_flipped_input
        self._single_z = None

    def _renderer(self, b):
        if b not in self.renderers:
            self.renderers[b] = SplatRenderer()
        return self.renderers[b]

    @staticmethod
    def _resolution_hw(key):
        """(H, W) of a resolution key, ``w{W}xh{H}`` (the reference's
        pickles) or ``{H}x{W}``, else None."""
        m = re.fullmatch(r"w(\d+)xh(\d+)", str(key).lower())
        if m:
            return int(m.group(2)), int(m.group(1))
        m = re.fullmatch(r"(\d+)x(\d+)", str(key).lower())
        if m:
            return int(m.group(1)), int(m.group(2))
        return None

    @staticmethod
    def _finest_resolution(mapping, target_hw=None):
        """The entry whose key is ``target_hw`` (the guidance canvas),
        else the one of the most pixels; None for an empty mapping."""
        if not mapping:
            return None
        if target_hw is not None:
            for key in mapping:
                if Trainer._resolution_hw(key) == tuple(target_hw):
                    return mapping[key]

        def pixel_count(key):
            hw = Trainer._resolution_hw(key)
            return hw[0] * hw[1] if hw else -1

        return mapping[max(mapping.keys(), key=pixel_count)]

    def _point_info(self, data, t, b, target_hw=None):
        """Batch element ``b``'s (N, 3) pixel-to-point mapping of frame
        ``t``, or None. ``data["unprojection(s)"]`` may be a [batch][frame]
        list of (N, 3) arrays or a (B, T, N, 3) array; one sample's
        ``decode_unprojections`` output ``{resolution: (T, N, 3)}`` (b must
        be 0); or, collated, a list of such dicts or a dict of (B, T, N, 3)
        stacks. A decoded mapping is taken at ``target_hw`` (else the
        finest) and its padding stripped by the count row."""
        unproj = data.get("unprojection")
        if unproj is None:
            unproj = data.get("unprojections")
        if unproj is None:
            return None
        decoded = False
        if isinstance(unproj, dict):
            unproj = self._finest_resolution(unproj, target_hw)
            decoded = True
            if hasattr(unproj, "ndim") and unproj.ndim == 4:
                entry = unproj[b]
            elif b == 0:
                entry = unproj
            else:
                raise ValueError(
                    "wc_vid2vid: got a single-sample unprojection dict but was asked "
                    f"for batch element {b}; collate per-sample dicts into a list "
                    "(or stack) before handing them to the trainer")
        else:
            entry = unproj[b]
            if isinstance(entry, dict):
                entry = self._finest_resolution(entry, target_hw)
                decoded = True
        if isinstance(entry, (list, tuple)):
            entry = entry[t] if t < len(entry) else None
        elif hasattr(entry, "ndim") and entry.ndim >= 3:
            entry = entry[t] if t < entry.shape[0] else None
        if entry is None:
            return None
        entry = np.asarray(entry)
        if decoded and entry.ndim == 2 and entry.shape[0]:
            n = int(entry[-1, 0])
            entry = entry[:max(n, 0)]
        return entry

    def _get_data_t(self, data, t, prev_labels, prev_images):
        """vid2vid's frame data plus, where the data maps the frame's pixels
        to points, the rendered ``guidance`` (on the label's device and
        type) and the mappings under ``_point_infos``."""
        data_t = super()._get_data_t(data, t, prev_labels, prev_images)
        label = data_t["label"]
        b, _, h, w = label.shape
        infos = [self._point_info(data, t, bi, target_hw=(h, w)) for bi in range(b)]
        if any(info is not None for info in infos):
            guidance = np.stack([
                guidance_tensor(self._renderer(bi), info, w, h,
                                flipped=self.is_flipped_input)
                if info is not None else np.zeros((h, w, 4), np.float32)
                for bi, info in enumerate(infos)])
            data_t["guidance"] = torch.from_numpy(guidance).permute(0, 3, 1, 2).to(
                device=label.device, dtype=label.dtype)
            data_t["_point_infos"] = infos
        return data_t

    def _after_gen_frame(self, data_t, fake):
        """Color each batch element's point cloud with the frame (the
        takeover's at fp32), read back as uint8 in one copy."""
        infos = data_t.get("_point_infos")
        if not infos:
            return
        fake = data_t.get("_override", fake)
        images = ((fake * 0.5 + 0.5) * 255).clamp(0, 255).to(torch.uint8)
        images = images.permute(0, 2, 3, 1).cpu().numpy()
        for bi, info in enumerate(infos):
            if info is None:
                continue
            img = images[bi]
            if self.is_flipped_input:
                img = np.fliplr(img).copy()
            self._renderer(bi).update_point_cloud(img, info)

    @staticmethod
    def _any_flipped(data):
        flipped = data.get("is_flipped")
        return bool(torch.as_tensor(flipped).any()) if flipped is not None else False

    def gen_update(self, data, noise=None):
        """A clip's rollout from a fresh point cloud."""
        self.reset_renderer(self._any_flipped(data))
        return super().gen_update(data, noise)

    def _start_of_test_sequence(self, data):
        """A fresh point cloud a test sequence."""
        self.reset_renderer(self._any_flipped(data))

    def reset(self):
        """A new test sequence: the history and the point clouds go, and
        a flip flag left from training does not carry over."""
        super().reset()
        self.reset_renderer(False)
