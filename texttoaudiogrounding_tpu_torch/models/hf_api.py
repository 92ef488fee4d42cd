"""The released grounding model, as a named factory, and the import of its
deployment checkpoint.

Port of ``texttoaudiogrounding_tpu/models/hf_api.py`` and of
``training/torch_import.py:151 import_hf_grounding`` (reference
models/hf_modeling_grounding.py:305-352): ``Cnn8RnnLaionClapGroundingModel``
is a ``BiEncoder`` of ``Cnn8Rnn``, the text tower of
``laion/clap-htsat-fused`` (RoBERTa-base, 768→512→512 projection), 512-d
projections and ``DotProduct``.  Its forward takes ``{waveform,
waveform_len, input_ids, attention_mask}``: the bi-encoder passes the whole
input dict to the text tower (JAX ``audio_text_model.py:129-131``).
``GroundingPredictor.predict`` tokenizes into ``text`` in both packages
(JAX ``inference.py:155-156``), so the model is served through its forward.
"""

from __future__ import annotations

import numpy as np
import torch

from texttoaudiogrounding_tpu_torch.models.audio_text_model import (
    BiEncoder,
    grounding_cnn8rnn,
)
from texttoaudiogrounding_tpu_torch.models.match import DotProduct
from texttoaudiogrounding_tpu_torch.models.pretrained_text import (
    ClapTextEncoder,
    TextTowerConfig,
    _tensor,
    import_hf_bert_params,
)
from texttoaudiogrounding_tpu_torch.weights import random_state_dict

# HF buffers a RoBERTa checkpoint may carry, which no parameter holds
_HF_BUFFERS = ("embeddings.position_ids", "embeddings.token_type_ids")
# the reference deployment's module names (hf_modeling_grounding.py) that
# differ from the port's; the audio encoder's and projections' are alike
_DEPLOYMENT = {"text_encoder.model.": "text_encoder.tower.",
               "text_encoder.projection.linear1.": "text_encoder.proj_hidden.",
               "text_encoder.projection.linear2.": "text_encoder.proj_out."}


def clap_text_config() -> TextTowerConfig:
    """laion/clap-htsat-fused text tower (RoBERTa-base shape)."""
    return TextTowerConfig(
        vocab_size=50265, hidden_size=768, num_layers=12, num_heads=12,
        intermediate_size=3072, max_position_embeddings=514,
        type_vocab_size=1, layer_norm_eps=1e-5, dropout=0.1,
        pad_token_id=1, position_offset=2)


def cnn8rnn_laionclap_grounding_model(
        sample_rate: int = 32000, shared_dim: int = 512,
        projection_dim: int = 512, serving: bool = False,
        text_config: TextTowerConfig | None = None, device="cuda",
        gru_kernel: bool | None = None, block1_quant: str = "conv1",
        block1_tc: int = 48, block1_mode: str = "triple") -> BiEncoder:
    """The released grounding model's architecture on ``device``.  The
    audio tower is ``audio_text_model.grounding_cnn8rnn``'s, whose
    arguments ``serving``, ``gru_kernel`` and ``block1_*`` are, as in
    ``flagship_model``: ``serving=True`` is bf16 with the int8 conv blocks.
    The text tower runs in f32 either way, as in the JAX package."""
    audio = grounding_cnn8rnn(serving, sample_rate, gru_kernel=gru_kernel,
                              block1_quant=block1_quant,
                              block1_tc=block1_tc, block1_mode=block1_mode)
    text = ClapTextEncoder(text_config or clap_text_config(),
                           projection_dim=projection_dim, device=None)
    return BiEncoder(audio, text, DotProduct(), shared_dim=shared_dim,
                     add_proj=True, device=device)


def import_hf_grounding(state_dict: dict, text_cfg: TextTowerConfig) -> dict:
    """The reference deployment checkpoint (``audio_encoder.*``,
    ``text_encoder.model.*``, ``text_encoder.projection.linear1`` /
    ``linear2``, ``audio_proj``, ``text_proj``; tensors or numpy arrays) →
    the state dict of :func:`cnn8rnn_laionclap_grounding_model`'s model.
    The audio encoder's keys are the port's already (the reference GRU's
    r/z recurrent biases fold into the input bias there, as the JAX
    importer folds them); the text tower goes through
    :func:`import_hf_bert_params` (shapes checked, the identity pooler
    where there is none).  A key that maps onto nothing raises
    ``ValueError``; ``load_state_dict`` (strict) then checks what is
    missing."""
    tower_prefix = "text_encoder.model."
    out = {f"text_encoder.tower.{k}": v for k, v in import_hf_bert_params(
        state_dict, text_cfg, prefix=tower_prefix).items()}
    renames = {**_DEPLOYMENT, "audio_encoder.": "audio_encoder.",
               "audio_proj.": "audio_proj.", "text_proj.": "text_proj."}
    unused = []
    for key, value in state_dict.items():
        if key.startswith(tower_prefix):
            rest = key[len(tower_prefix):]
            if f"text_encoder.tower.{rest}" not in out and \
                    rest not in _HF_BUFFERS:
                unused.append(key)
            continue
        theirs = next((p for p in renames if key.startswith(p)), None)
        if theirs is None:
            unused.append(key)
            continue
        name = renames[theirs] + key[len(theirs):]
        out[name] = (torch.as_tensor(value).detach().cpu()
                     if key.endswith("num_batches_tracked")
                     else _tensor(value))
    if unused:
        raise ValueError(f"keys of the checkpoint that map onto nothing: "
                         f"{unused[:8]}")
    return out


def random_reference_checkpoint(model: torch.nn.Module, seed: int) -> dict:
    """A reference-format deployment state dict of the released ``model``
    (:func:`export_hf_grounding`'s names) drawn with numpy from ``seed``
    (``weights.random_state_dict``), the GRU's r/z recurrent biases
    non-zero as a reference checkpoint has them: weights to try the
    import on where no released checkpoint is at hand."""
    rng = np.random.default_rng(seed + 1)
    sd = random_state_dict(model, seed=seed)
    for key, value in sd.items():
        if "bias_hh" in key:
            sd[key] = torch.from_numpy(rng.normal(
                0, 0.05, tuple(value.shape)).astype(np.float32))
    return export_hf_grounding(sd)


def export_hf_grounding(state_dict: dict) -> dict:
    """The released model's state dict under the reference deployment's
    names: what :func:`import_hf_grounding` reads."""
    out = {}
    for key, value in state_dict.items():
        for theirs, ours in _DEPLOYMENT.items():
            if key.startswith(ours):
                key = theirs + key[len(ours):]
        out[key] = value
    return out
