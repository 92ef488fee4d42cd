"""Component registry: config names → builders.

The short names of ``texttoaudiogrounding_tpu/utils/registry.py`` that the
strong-supervision configs (``configs/strong/biencoder_train.yaml``,
``cdur_w2vmean.yaml``), the WSTAG configs (``configs/weak_phrase/``,
``configs/weak_sentence/``) and the models, datasets and runners of
WSTAG (the cross encoder, align functions and sim poolings) and the
class-mapping configs (``configs/class_mapping/``: ``AudioTagging``, the
eight class-mapping datasets, ``VarLenPadCollate``, both runners) use,
every loss class, and the rest of the model zoo (the text towers and
encoders, the cross and retrieval models, the released model's factory,
``HuggingFaceTokenizer``, ``Vocabulary``, ``CosineWithWarmup``,
``MetricImprover``, ``StrongRunner``), resolved to the port's classes
(every JAX name but ``DataLoader``: its arguments ``seed``, ``prefetch``,
``worker_type``, ``shard_index`` and ``num_shards`` are not
``torch.utils.data.DataLoader``'s; the runners build theirs with
``data/loader.py:build_loader``), and ``instantiate``, which builds
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
    from texttoaudiogrounding_tpu_torch import losses, models
    from texttoaudiogrounding_tpu_torch.data import (
        class_mapping,
        collate,
        datasets,
    )
    from texttoaudiogrounding_tpu_torch.data.tokenizer import (
        DictTokenizer,
        HuggingFaceTokenizer,
    )
    from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary
    from texttoaudiogrounding_tpu_torch.models.sim_pooling import (
        MULTI_TEXT_POOLINGS,
        SIM_POOLINGS,
    )
    from texttoaudiogrounding_tpu_torch.training import optim
    from texttoaudiogrounding_tpu_torch.training.runner_class_mapping import (
        ClassMappingStrongRunner,
        ClassMappingWeakRunner,
    )
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseRunner,
        WeakPhraseSelfSupervisionRunner,
    )
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner,
    )
    from texttoaudiogrounding_tpu_torch.training.runner_weak_sentence import (
        WeakSentenceRunner,
    )
    _REGISTRY.update({
        **{name: getattr(models, name) for name in models.__all__
           if not name[0].islower()},
        "Cnn8_Rnn": models.Cnn8Rnn, "CrossCnn8_Rnn": models.CrossCnn8Rnn,
        "LaionClapEncoder": models.ClapTextEncoder,
        "AST": models.AudioSpectrogramTransformer,
        "Wavegram_Logmel_Cnn14": models.WavegramLogmelCnn14,
        "Cnn8RnnLaionClapGroundingModel":
            models.cnn8rnn_laionclap_grounding_model,
        "MatchExpNegL2": models.ExpNegL2,
        "MatchDotProduct": models.DotProduct,
        "MatchCrossAttention": models.CrossAttention,
        **SIM_POOLINGS, **MULTI_TEXT_POOLINGS,
        **{name: getattr(losses, name) for name in losses.__all__},
        **{name: getattr(datasets, name) for name in (
            "AudioPhraseDataset", "AudioPhraseEvalDataset",
            "AudioSamplePhrasesDataset", "SamplePhrasesCountDataset",
            "AudioCaptionPhrasesEvalDataset", "AudioCaptionPhrasesDataset",
            "SinglePhraseEvalDataset", "AudioCaptionDataset",
            "AudioCaptionPhraseIndicesDataset")},
        **{name: getattr(class_mapping, name) for name in (
            "ASMappingEvalDataset", "ASMappingWeakDataset",
            "ASMappingEvalLabelSimDataset", "ASMappingStrongDataset",
            "KmeansMappingEvalDataset", "KmeansMappingDataset",
            "SpectralMappingEvalDataset", "SpectralMappingDataset")},
        "VarLenPadCollate": collate.VarLenPadCollate,
        "TextCollate": collate.TextCollate,
        "VarNumTextCollate": collate.VarNumTextCollate,
        "DictTokenizer": DictTokenizer,
        "HuggingFaceTokenizer": HuggingFaceTokenizer,
        "Vocabulary": Vocabulary,
        "CosineWithWarmup": optim.CosineWithWarmup,
        "MetricImprover": optim.MetricImprover,
        "StrongRunner": StrongRunner,
        "ReduceLROnPlateau": optim.ReduceLROnPlateau,
        "torch.optim.lr_scheduler.ReduceLROnPlateau":
            optim.ReduceLROnPlateau,
        "WeakPhraseRunner": WeakPhraseRunner,
        "WeakPhraseSelfSupervisionRunner": WeakPhraseSelfSupervisionRunner,
        "WeakSentenceRunner": WeakSentenceRunner,
        "ClassMappingStrongRunner": ClassMappingStrongRunner,
        "ClassMappingWeakRunner": ClassMappingWeakRunner,
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
