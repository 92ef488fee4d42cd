"""Configs: a dict, or a YAML file (``yaml`` imported only to read one).

The run's config is written as JSON beside its checkpoints.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path


def load_config(config: str | Path | dict) -> dict:
    """A copy of a config dict, or the contents of a YAML file."""
    if isinstance(config, dict):
        return copy.deepcopy(config)
    import yaml

    with open(config) as reader:
        return yaml.safe_load(reader) or {}


def dump_config(config: dict, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as writer:
        json.dump(config, writer, indent=1, default=str)
