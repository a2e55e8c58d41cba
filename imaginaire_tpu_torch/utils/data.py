"""Config-driven data-shape helpers (port of ``imaginaire_tpu/utils/data.py``).

They read the ``data:`` config section the same way: ``input_types`` is a
list of single-key mappings ``{name: {num_channels: N, ...}}``;
``input_image`` / ``input_labels`` name which types feed the image and
label tensors.
"""

from __future__ import annotations

from imaginaire_tpu_torch.config import as_attrdict, cfg_get


def _iter_input_types(data_cfg):
    for data_type in as_attrdict(data_cfg).input_types:
        for name, props in data_type.items():
            yield name, props


def get_paired_input_image_channel_number(data_cfg):
    """Sum of channels over the types listed in ``input_image``."""
    data_cfg = as_attrdict(data_cfg)
    num_channels = 0
    for name, props in _iter_input_types(data_cfg):
        if name in data_cfg.input_image:
            num_channels += props.num_channels
    return num_channels


def get_paired_input_label_channel_number(data_cfg, video=False):
    """Sum of channels over the types listed in ``input_labels``, +1 per
    type with ``use_dont_care``; video mode multiplies by
    ``initial_sequence_length`` and adds the previous frames' image
    channels."""
    data_cfg = as_attrdict(data_cfg)
    num_labels = 0
    if cfg_get(data_cfg, "input_labels", None) is None:
        return num_labels
    for name, props in _iter_input_types(data_cfg):
        if name in data_cfg.input_labels:
            num_labels += props.num_channels
            if cfg_get(props, "use_dont_care", False):
                num_labels += 1
    if video:
        num_time_steps = cfg_get(data_cfg.train, "initial_sequence_length", None)
        num_labels *= num_time_steps
        num_labels += (get_paired_input_image_channel_number(data_cfg)
                       * (num_time_steps - 1))
    return num_labels


def get_class_number(data_cfg):
    """``num_classes`` of the data config."""
    return data_cfg.num_classes


def get_crop_h_w(augmentation):
    """Find the '*crop_h_w' augmentation key and parse 'H,W'."""
    augmentation = as_attrdict(augmentation)
    for k in augmentation.keys():
        if "crop_h_w" in k:
            crop_h, crop_w = str(augmentation[k]).split(",")
            return int(crop_h), int(crop_w)
    raise AttributeError("no *crop_h_w augmentation in config")


def get_crop_or_resize_h_w(augmentation):
    """Output size of the augmentation pipeline: the '*crop_h_w' key when
    one exists, else the fixed 'resize_h_w'."""
    augmentation = as_attrdict(augmentation)
    try:
        return get_crop_h_w(augmentation)
    except AttributeError:
        resize = cfg_get(augmentation, "resize_h_w", None)
        if resize is None:
            raise ValueError(
                "augmentations must carry a '*crop_h_w' or 'resize_h_w' "
                f"entry to size the model; got {sorted(augmentation)}"
            ) from None
        h, w = str(resize).split(",")
        return int(h), int(w)
