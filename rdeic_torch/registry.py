"""YAML `target:` / `params:` configs -> port classes.

The model YAMLs name rdeic_tpu classes; a target under `rdeic_tpu.` maps to
the same path under `rdeic_torch.` (so `configs/model/rdeic.yaml` loads
unmodified). The port imports nothing of rdeic_tpu: the name is rewritten,
never imported.
"""
from __future__ import annotations

import importlib
from typing import Any, Mapping

_PREFIX = ("rdeic_tpu.", "rdeic_torch.")


def get_obj_from_str(path: str) -> Any:
    if path.startswith(_PREFIX[0]):
        path = _PREFIX[1] + path[len(_PREFIX[0]):]
    if not path.startswith(_PREFIX[1]):
        raise ValueError(f"target {path!r} is outside rdeic_torch")
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def instantiate_from_config(config: Mapping[str, Any], **extra: Any) -> Any:
    """The target class called with `params` and `extra` (e.g. device)."""
    if "target" not in config:
        raise KeyError("expected key `target` to instantiate")
    params = dict(config.get("params") or {})
    return get_obj_from_str(config["target"])(**params, **extra)


def load_yaml(path: str) -> dict:
    import yaml  # noqa: PLC0415 (only the CLI reads YAML)

    with open(path) as f:
        return yaml.safe_load(f)
