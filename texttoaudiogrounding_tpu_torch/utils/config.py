"""Configs: a dict, a JSON file or a YAML file, with ``inherit_from`` and
overrides.

Port of ``texttoaudiogrounding_tpu/utils/config.py:24-97`` (reference
utils/train_util.py:120-194): ``inherit_from`` names a base YAML relative
to the file, deep-merged with the child winning; overrides are
``a.b.c=value`` strings with YAML-typed values, or keyword arguments.
``yaml`` is imported only to read a YAML file or to type an override
string.  The run's config is written as JSON beside its checkpoints
(``config.json``), which :func:`load_config` reads back without ``yaml``.
"""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path
from typing import Any


def merge_a_into_b(a: dict, b: dict) -> None:
    """Deep-merge ``a`` into ``b`` in place; values in ``a`` win."""
    for k, v in a.items():
        if isinstance(v, dict) and k in b:
            if not isinstance(b[k], dict):
                raise ValueError(f"Cannot inherit key '{k}' from base!")
            merge_a_into_b(v, b[k])
        else:
            b[k] = v


def load_config(config: str | Path | dict) -> dict:
    """A copy of a config dict, or a JSON or YAML file's contents with its
    ``inherit_from`` chain resolved."""
    if isinstance(config, dict):
        return copy.deepcopy(config)
    config_file = Path(config)
    if config_file.suffix == ".json":
        with open(config_file) as reader:
            return json.load(reader)
    import yaml

    with open(config_file) as reader:
        config = yaml.safe_load(reader) or {}
    if "inherit_from" in config:
        base_file = config_file.parent / config["inherit_from"]
        if os.path.samefile(config_file, base_file):
            raise ValueError("config inherits from itself")
        base_config = load_config(base_file)
        del config["inherit_from"]
        merge_a_into_b(config, base_config)
        return base_config
    return config


def _set_dotted(cfg: dict, dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"override path '{dotted_key}' hits non-dict")
    node[keys[-1]] = value


def parse_overrides(overrides: list[str]) -> dict:
    """``["a.b=1", "c=foo"]`` → nested dict, values YAML-typed."""
    out: dict = {}
    if not overrides:
        return out
    import yaml

    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override '{item}' is not of the form key=value")
        key, raw = item.split("=", 1)
        _set_dotted(out, key.strip(), yaml.safe_load(raw))
    return out


def parse_config_or_kwargs(config: str | Path | dict,
                           overrides: list[str] | None = None,
                           **kwargs) -> dict:
    """Load a config (dict or file) and apply the overrides, then the
    keyword arguments; both win over the file."""
    config = load_config(config)
    if overrides:
        merge_a_into_b(parse_overrides(overrides), config)
    if kwargs:
        merge_a_into_b(copy.deepcopy(kwargs), config)
    return config


def dump_config(config: dict, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as writer:
        json.dump(config, writer, indent=1, default=str)
