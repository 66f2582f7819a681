"""YAML config IO helpers.

Own copy of `curobo_tpu/util/config_io.py` (load/write/merge).
"""

from __future__ import annotations

import os

import yaml


def load_yaml(path_or_dict):
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict, "r") as f:
        return yaml.safe_load(f)


def write_yaml(data: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(data, f, default_flow_style=None, sort_keys=False)


def dataclass_from_dict(cls_or_default, d: dict):
    """Build a (possibly nested) frozen config dataclass from a dict.

    Nested dataclass fields recurse using the field default's type; lists
    become tuples (hashable). Unknown keys raise.
    Parity: the reference's YAML-to-Cfg factories (`solver_core_cfg.py`).
    """
    import dataclasses

    if dataclasses.is_dataclass(cls_or_default) and not isinstance(cls_or_default, type):
        cls = type(cls_or_default)
        base = cls_or_default
    else:
        cls = cls_or_default
        base = cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise ValueError(f"unknown config key {k!r} for {cls.__name__}")
        default = getattr(base, k)
        if default is None and isinstance(v, dict):
            # Optional[SomeConfig] field left at None: resolve the target
            # dataclass from the Optional[...] annotation
            import typing

            hints = typing.get_type_hints(cls)
            args = [
                t for t in typing.get_args(hints.get(k))
                if dataclasses.is_dataclass(t)
            ]
            if not args:
                raise ValueError(
                    f"cannot build dict value for non-dataclass field {k!r}"
                )
            kwargs[k] = dataclass_from_dict(args[0], v)
        elif dataclasses.is_dataclass(default) and isinstance(v, dict):
            kwargs[k] = dataclass_from_dict(default, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(
                tuple(x) if isinstance(x, list) else x for x in v
            )
        else:
            kwargs[k] = v
    return dataclasses.replace(base, **kwargs)


def merge_dict_a_into_b(a: dict, b: dict) -> dict:
    """Recursively merge ``a`` on top of ``b`` (a wins), returning ``b``."""
    for k, v in a.items():
        if isinstance(v, dict) and isinstance(b.get(k), dict):
            merge_dict_a_into_b(v, b[k])
        else:
            b[k] = v
    return b
