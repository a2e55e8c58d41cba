"""Config system: YAML overlaid on a defaults tree, attribute access.

The port's own copy of ``imaginaire_tpu/config.py``: the same
attribute-accessible nested dict, the same recursive overlay rule, the
same YAML float resolver (``1e-4`` parses as a float) and the same
``common:`` broadcast into ``gen`` and ``dis``, so the repository's YAML
files load unchanged. The defaults tree holds only the keys the port
reads; the JAX package's runtime knobs (mesh, telemetry, resilience...)
are carried through untouched when a YAML file sets them.
"""

from __future__ import annotations

import copy
import re
from collections.abc import Mapping

import yaml


class AttrDict(dict):
    """Dict with attribute access and recursive construction."""

    def __init__(self, mapping=None, **kwargs):
        super().__init__()
        mapping = dict(mapping or {}, **kwargs)
        for key, value in mapping.items():
            self[key] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __deepcopy__(self, memo):
        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(value):
    if isinstance(value, AttrDict):
        return value
    if isinstance(value, dict):
        return AttrDict(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def as_attrdict(obj):
    """Recursively convert any Mapping back to AttrDict."""
    if isinstance(obj, Mapping):
        return AttrDict({k: as_attrdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return [as_attrdict(v) for v in obj]
    return obj


def recursive_update(base, overlay):
    """Recursively overlay ``overlay`` onto AttrDict ``base`` in place:
    dicts merge recursively; any other value (including lists) replaces."""
    for key, value in overlay.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            recursive_update(base[key], value)
        else:
            base[key] = _wrap(value)
    return base


# YAML 1.1 fails to parse `1e-4` (no dot) as a float; accept full
# scientific notation.
class _ConfigLoader(yaml.SafeLoader):
    pass


_ConfigLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:
            [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
           |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
           |\.[0-9_]+(?:[eE][-+][0-9]+)?
           |[-+]?\.(?:inf|Inf|INF)
           |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def load_yaml(path_or_stream):
    if hasattr(path_or_stream, "read"):
        return yaml.load(path_or_stream, Loader=_ConfigLoader)
    with open(path_or_stream, "r") as f:
        return yaml.load(f, Loader=_ConfigLoader)


def default_config():
    """The defaults tree every experiment config is overlaid on: the
    JAX package's values for every key the port reads."""
    return AttrDict(
        trainer=AttrDict(
            type="imaginaire_tpu.trainers.base",
            model_average=False,
            model_average_remove_sn=True,
            init=AttrDict(type="xavier", gain=0.02),
        ),
        gen=AttrDict(type="imaginaire_tpu.models.generators.dummy"),
        dis=AttrDict(type="imaginaire_tpu.models.discriminators.dummy"),
        data=AttrDict(name="dummy", type="imaginaire_tpu.data.images"),
        serving=AttrDict(
            buckets=[[256, 256]],
            batch_sizes=[1, 4],
            queue_timeout_ms=5.0,
            max_queue=64,
            seed=0,
        ),
        inference_args=AttrDict(),
        # the FlowNet2 teacher's amortization (flow/cache.py): 'producer'
        # runs it off the step on every batch, 'disk' adds the
        # content-addressed on-disk cache, 'auto' uses disk when a cache
        # dir resolves (flow_cache.dir or <logdir>/flow_cache)
        flow_cache=AttrDict(
            enabled=False,
            mode="auto",  # auto | producer | disk
            dir=None,  # None -> <logdir>/flow_cache
            store_dtype="float16",  # on-disk flow dtype (conf is uint8)
        ),
    )


class Config(AttrDict):
    """Load an experiment config: defaults <- yaml overlay (+ ``common``
    broadcast into ``gen`` and ``dis``)."""

    def __init__(self, filename=None, overrides=None):
        super().__init__(default_config())
        if filename is not None:
            user = load_yaml(filename)
            if user:
                recursive_update(self, user)
        if overrides:
            recursive_update(self, overrides)
        if "common" in self:
            common = self["common"]
            for section in ("gen", "dis"):
                if section in self:
                    for key, value in common.items():
                        if key not in self[section]:
                            self[section][key] = copy.deepcopy(value)
        self["source_filename"] = str(filename) if filename is not None else None


def cfg_get(cfg, key, default=None):
    """``getattr(cfg, key, default)`` over AttrDicts and plain mappings."""
    if isinstance(cfg, Mapping) and not isinstance(cfg, AttrDict):
        return cfg.get(key, default)
    try:
        return cfg[key]
    except (KeyError, TypeError):
        return default
