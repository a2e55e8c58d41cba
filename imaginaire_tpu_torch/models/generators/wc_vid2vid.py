"""World-consistent vid2vid generator (port of
``imaginaire_tpu/models/generators/wc_vid2vid.py``).

The vid2vid generator plus one more SPADE condition on warp frames: the
guidance, colors splatted from a persistent point cloud rendered into a
dense (B, 4, H, W) tensor of RGB in [-1, 1] and a validity mask
(``data["guidance"]``, built by the trainer's host-side
``SplatRenderer``). Which up-layers take it (``gen.guidance``):

- ``only_with_flow``: the multi-SPADE layers alone, as their third
  condition after the label's and the warped frame's;
- otherwise every layer of the up loop: the third condition in the
  multi-SPADE layers, the second in the others.

With ``partial_conv`` the guidance arrives as an (image, mask) pair,
which a SPADE norm built with ``activation_norm_params.partial`` turns
into gamma/beta through a ``PartialConv2d``. First and continuation
frames take no guidance. The JAX package creates the guidance's SPADE
convs when the condition first arrives (its ``init_all`` materializes
them); the port builds them at construction from the same three
settings and ``num_multi_spade_layers``.
"""

from __future__ import annotations

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.models.generators.vid2vid import Generator as Vid2VidGenerator

GUIDANCE_CHANNELS = 4  # RGB and the validity mask


def _guidance_settings(gen_cfg):
    guidance = as_attrdict(cfg_get(gen_cfg, "guidance", {}) or {})
    return (bool(cfg_get(guidance, "only_with_flow", False)),
            bool(cfg_get(guidance, "partial_conv", False)))


class Generator(Vid2VidGenerator):
    def __init__(self, gen_cfg, data_cfg):
        super().__init__(gen_cfg, data_cfg)
        self.guidance_only_with_flow, self.guidance_partial_conv = \
            _guidance_settings(gen_cfg)

    def _takes_guidance(self, i, only_with_flow):
        """Whether up-layer ``i`` takes the guidance on a warp frame."""
        return (self.has_flow and i <= self.num_downsamples_img
                and (i < self.num_multi_spade_layers or not only_with_flow))

    def _up_layer_conds(self, gen_cfg, i, label_dim, img_dim):
        cond = super()._up_layer_conds(gen_cfg, i, label_dim, img_dim)
        only_with_flow, partial_conv = _guidance_settings(gen_cfg)
        if self._takes_guidance(i, only_with_flow):
            cond.append((GUIDANCE_CHANNELS - 1, 1) if partial_conv else GUIDANCE_CHANNELS)
        return cond

    def _guidance_cond(self, data):
        g = data.get("guidance")
        if g is None:
            return None
        if self.guidance_partial_conv:
            return (g[:, :GUIDANCE_CHANNELS - 1], g[:, GUIDANCE_CHANNELS - 1:])
        return g

    def _layer_conds(self, i, j, cond_maps_now, cond_maps_img, data):
        cond_maps = super()._layer_conds(i, j, cond_maps_now, cond_maps_img, data)
        guidance = self._guidance_cond(data)
        if cond_maps_img is not None and guidance is not None \
                and self._takes_guidance(i, self.guidance_only_with_flow):
            cond_maps.append(guidance)
        return cond_maps

    def forward(self, data):
        """The vid2vid output dict plus ``guidance_images_and_masks``."""
        out = super().forward(data)
        out["guidance_images_and_masks"] = data.get("guidance")
        return out
