"""Plugin discovery of methods and dataparsers (torch port of
`neurad_tpu/plugins/registry.py`). Another package registers factories in the
entry-point groups `neurad_tpu_torch.method_configs` and
`neurad_tpu_torch.dataparser_configs`, or names method factories in the
environment variable NEURAD_TPU_TORCH_METHOD_CONFIGS as comma-separated
`name=module:function` specs. The groups and the variable are the port's own,
so a factory that builds a JAX package configuration is never loaded here. A
plugin that fails to load is reported and skipped.
"""

from __future__ import annotations

import importlib
import os
from typing import Callable, Dict

METHOD_ENTRYPOINT_GROUP = "neurad_tpu_torch.method_configs"
DATAPARSER_ENTRYPOINT_GROUP = "neurad_tpu_torch.dataparser_configs"
METHOD_ENV_VAR = "NEURAD_TPU_TORCH_METHOD_CONFIGS"


def _load_env_specs(env_var: str) -> Dict[str, Callable]:
    """`name=module:function` specs, comma-separated, from an environment variable."""
    out: Dict[str, Callable] = {}
    for item in filter(None, (s.strip() for s in os.environ.get(env_var, "").split(","))):
        name, _, target = item.partition("=")
        module, _, attr = target.partition(":")
        try:
            out[name] = getattr(importlib.import_module(module), attr)
        except Exception as e:  # a broken plugin must not stop start-up
            print(f"[plugins] failed to load {item!r}: {e}")
    return out


def _load_entry_points(group: str) -> Dict[str, Callable]:
    from importlib.metadata import entry_points

    out: Dict[str, Callable] = {}
    for ep in entry_points(group=group):
        try:
            out[ep.name] = ep.load()
        except Exception as e:
            print(f"[plugins] failed to load entry point {ep.name!r}: {e}")
    return out


def discover_methods() -> Dict[str, Callable]:
    """Every method factory registered from outside (the variable's win)."""
    methods = _load_entry_points(METHOD_ENTRYPOINT_GROUP)
    methods.update(_load_env_specs(METHOD_ENV_VAR))
    return methods


def discover_dataparsers() -> Dict[str, Callable]:
    return _load_entry_points(DATAPARSER_ENTRYPOINT_GROUP)


def register_discovered_methods() -> None:
    """Add the discovered methods to `method_configs.METHODS` (the train
    script calls this at start-up)."""
    from neurad_tpu_torch.configs.method_configs import register_method

    for name, factory in discover_methods().items():
        register_method(name, factory)
