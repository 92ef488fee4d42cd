"""Component registry: config names → builders.

The short names of ``texttoaudiogrounding_tpu/utils/registry.py`` that the
strong-supervision config (``configs/strong/biencoder_train.yaml``) and
the phrase-level WSTAG training configs (``configs/weak_phrase/``) use,
resolved to the port's classes, and ``instantiate``, which builds
``{"type": name, "args": {...}}`` trees as the JAX package does: keys
beside ``type``/``args`` that are dicts (sub-models) and ``type``-tagged
dicts inside ``args`` (a collate's tokenizer) are built first, and a
string ``dtype`` in ``args`` becomes a torch dtype (``dtype: bfloat16``
selects the mixed-precision mode, ``registry.py:78-81``).  The table is
filled on first use, so importing this module imports no model.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

_REGISTRY: dict[str, Callable] = {}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _fill() -> None:
    from texttoaudiogrounding_tpu_torch import losses
    from texttoaudiogrounding_tpu_torch.data import collate, datasets
    from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
    from texttoaudiogrounding_tpu_torch.models import (
        BiEncoder,
        Cnn8Rnn,
        DotProduct,
        EmbeddingAgg,
        ExpNegL2,
        MultiTextBiEncoder,
    )
    from texttoaudiogrounding_tpu_torch.training import optim
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseRunner,
    )
    _REGISTRY.update({
        "BiEncoder": BiEncoder, "MultiTextBiEncoder": MultiTextBiEncoder,
        "Cnn8Rnn": Cnn8Rnn, "Cnn8_Rnn": Cnn8Rnn,
        "EmbeddingAgg": EmbeddingAgg, "ExpNegL2": ExpNegL2,
        "MatchExpNegL2": ExpNegL2, "DotProduct": DotProduct,
        "MatchDotProduct": DotProduct, "FrameBceLoss": losses.FrameBceLoss,
        "ClipBceLoss": losses.ClipBceLoss,
        "AudioPhraseDataset": datasets.AudioPhraseDataset,
        "AudioPhraseEvalDataset": datasets.AudioPhraseEvalDataset,
        "AudioSamplePhrasesDataset": datasets.AudioSamplePhrasesDataset,
        "TextCollate": collate.TextCollate, "DictTokenizer": DictTokenizer,
        "ReduceLROnPlateau": optim.ReduceLROnPlateau,
        "torch.optim.lr_scheduler.ReduceLROnPlateau":
            optim.ReduceLROnPlateau,
        "WeakPhraseRunner": WeakPhraseRunner,
    })


def resolve(name: str) -> Callable:
    if not _REGISTRY:
        _fill()
    if name not in _REGISTRY:
        raise KeyError(f"'{name}' is not registered; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _is_component_cfg(value: Any) -> bool:
    return isinstance(value, dict) and "type" in value


def _arg(key: str, value: Any) -> Any:
    if _is_component_cfg(value):
        return instantiate(value)
    if key == "dtype" and isinstance(value, str):
        if value not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        return _DTYPES[value]
    return value


def instantiate(config: dict, **kwargs) -> Any:
    """Build an object from a ``type``/``args`` dict; ``kwargs`` are passed
    to the top-level builder and win."""
    if "type" not in config:
        raise ValueError(f"component config missing 'type': {config}")
    obj_args = {key: _arg(key, value)
                for key, value in config.get("args", {}).items()}
    for key, value in config.items():
        if key not in ("type", "args") and key not in kwargs \
                and isinstance(value, dict):
            obj_args[key] = instantiate(value)
    obj_args.update(kwargs)
    return resolve(config["type"])(**obj_args)
