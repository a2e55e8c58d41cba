"""Config ``type:`` resolver for the port.

The repository's YAML files name JAX-package modules
(``imaginaire_tpu.models.generators.spade``). The port mirrors that
package's module paths, so each type string maps onto its twin under
``imaginaire_tpu_torch`` and the configs are shared, never forked. The
reference project's own module names (``imaginaire.generators.spade``)
are accepted too, as the JAX package accepts them.
"""

from __future__ import annotations

import importlib

_JAX_PACKAGE = "imaginaire_tpu."
_PORT_PACKAGE = "imaginaire_tpu_torch."

_REFERENCE_NAMES = {
    "imaginaire.generators.": "imaginaire_tpu.models.generators.",
    "imaginaire.discriminators.": "imaginaire_tpu.models.discriminators.",
    "imaginaire.trainers.": "imaginaire_tpu.trainers.",
    "imaginaire.datasets.": "imaginaire_tpu.data.",
    "imaginaire.optimizers.": "imaginaire_tpu.optim.",
}


def port_module_name(type_string):
    """Map a config type string to the port's module path."""
    name = str(type_string)
    for old, new in _REFERENCE_NAMES.items():
        if name.startswith(old):
            name = new + name[len(old):]
            break
    if name.startswith(_PORT_PACKAGE):
        return name
    if name.startswith(_JAX_PACKAGE):
        return _PORT_PACKAGE + name[len(_JAX_PACKAGE):]
    raise ValueError(f"config type {type_string!r} names no module of "
                     f"{_JAX_PACKAGE.rstrip('.')} or its port")


def resolve(type_string, attr):
    """Resolve a config ``type`` string to the port's class named ``attr``."""
    module_name = port_module_name(type_string)
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as exc:
        if not exc.name or not module_name.startswith(exc.name):
            raise  # a missing dependency, not a missing port module
        raise ModuleNotFoundError(
            f"config type {type_string!r} maps to {module_name!r}, which "
            f"the port does not have yet (see ROADMAP.md)",
            name=module_name) from None
    if not hasattr(module, attr):
        raise AttributeError(
            f"module {module_name!r} (from config type {type_string!r}) "
            f"has no {attr!r}")
    return getattr(module, attr)


def resolve_function(module, fn_name):
    """A ``module::function`` spec's parts (a data op's, a region crop's),
    the module named in either package -> the port's function."""
    return getattr(importlib.import_module(port_module_name(module)), fn_name)
