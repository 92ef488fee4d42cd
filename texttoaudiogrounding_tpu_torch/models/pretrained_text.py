"""Pretrained-style transformer text towers: BERT / RoBERTa encoders, the
[CLS]-pooled ``Bert``, the mean-pooled ``SentenceBert`` and the CLAP text
encoder, with the importers of HF checkpoints.

Port of ``texttoaudiogrounding_tpu/models/pretrained_text.py`` (reference
models/text_encoder.py:271-327).  The tower's submodules carry the names of
HF's ``BertModel`` / ``RobertaModel`` (``embeddings.word_embeddings``,
``encoder.layer.{i}.attention.self.query``, ``pooler.dense``, ...), so a
reference checkpoint loads with ``load_state_dict`` once its prefix is
stripped; :func:`import_hf_bert_params` does that, checks every key's
shape and supplies the identity pooler where the checkpoint has none, as
the JAX importer does (``pretrained_text.py:264-269``).  The arithmetic is
the JAX package's, not HF's, in four places:

* position ids are ``arange(L) + position_offset`` for every position,
  padded ones included (``:81-82``; HF RoBERTa numbers the valid tokens
  only);
* the attention mask acts on the keys only, masked scores are the
  dtype's lowest value (flax's fill): a row with no valid key attends
  uniformly;
* GELU is exact;
* ``layer_norm_eps`` comes from the config (1e-12 BERT, 1e-5 RoBERTa,
  1e-6 in the AST).

No Pallas kernel computes attention in the JAX package: it is plain
PyTorch here.  Dropout (train mode) draws its masks from the tower's
generator.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.device import place
from texttoaudiogrounding_tpu_torch.models.layers import Seeded, dropout
from texttoaudiogrounding_tpu_torch.models.match import l2_normalize


@dataclasses.dataclass(frozen=True)
class TextTowerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    pad_token_id: int = 0
    # RoBERTa offsets position ids by pad_token_id + 1
    position_offset: int = 0


def tiny_text_tower_config(vocab_size: int = 100) -> TextTowerConfig:
    """Small config for tests."""
    return TextTowerConfig(vocab_size=vocab_size, hidden_size=32,
                           num_layers=2, num_heads=2,
                           intermediate_size=64,
                           max_position_embeddings=64, type_vocab_size=2)


class _Holder(nn.Module):
    """A named container of submodules (HF's key layout, where one of them
    is named ``self``)."""

    def __init__(holder, **modules):
        super().__init__()
        for name, module in modules.items():
            setattr(holder, name, module)


class TransformerLayer(nn.Module):
    """Post-LN encoder layer (JAX ``pretrained_text.py:48-68``): flax's
    multi-head attention (``attention.self.query`` / ``key`` / ``value``,
    ``attention.output.dense``), dropout, residual and
    ``attention.output.LayerNorm``, then the exact-GELU feed-forward
    (``intermediate.dense``, ``output.dense``), dropout, residual and
    ``output.LayerNorm``."""

    def __init__(self, cfg: TextTowerConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        if h % cfg.num_heads:
            raise ValueError("hidden_size must be a multiple of num_heads")
        self.num_heads, self.p = cfg.num_heads, cfg.dropout
        self.attention = _Holder(
            self=_Holder(query=nn.Linear(h, h), key=nn.Linear(h, h),
                         value=nn.Linear(h, h)),
            output=_Holder(dense=nn.Linear(h, h),
                           LayerNorm=nn.LayerNorm(h, eps=eps)))
        self.intermediate = _Holder(dense=nn.Linear(h, cfg.intermediate_size))
        self.output = _Holder(dense=nn.Linear(cfg.intermediate_size, h),
                              LayerNorm=nn.LayerNorm(h, eps=eps))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x [B, L, H]``, ``mask [B, L]`` (True: a valid key)."""
        p = self.p if self.training else 0.0
        b, n, d = x.shape
        nh = self.num_heads
        att = self.attention.self

        def heads(y):
            return y.reshape(b, n, nh, d // nh).transpose(1, 2)

        q = heads(att.query(x)) / math.sqrt(d // nh)
        k, v = heads(att.key(x)), heads(att.value(x))
        score = q @ k.transpose(-1, -2)                       # [B, h, L, L]
        score = torch.where(mask[:, None, None, :], score,
                            torch.finfo(score.dtype).min)
        weight = dropout(torch.softmax(score, dim=-1), p, generator)
        out = (weight @ v).transpose(1, 2).reshape(b, n, d)
        out = dropout(self.attention.output.dense(out), p, generator)
        x = self.attention.output.LayerNorm(x + out)
        hid = F.gelu(self.intermediate.dense(x))
        hid = dropout(self.output.dense(hid), p, generator)
        return self.output.LayerNorm(x + hid)


class TextTower(Seeded):
    """BERT / RoBERTa encoder (JAX ``pretrained_text.py:71-103``):
    ``(input_ids [B, L], attention_mask [B, L], token_type_ids)`` →
    ``(last_hidden [B, L, H], pooled [B, H])``, the pooled vector
    ``tanh(pooler.dense(hidden[:, 0]))``.  On ``device`` (the card unless
    ``"cpu"``), in eval mode."""

    def __init__(self, cfg: TextTowerConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        emb = dict(word_embeddings=nn.Embedding(cfg.vocab_size, h),
                   position_embeddings=nn.Embedding(
                       cfg.max_position_embeddings, h))
        if cfg.type_vocab_size:
            emb["token_type_embeddings"] = nn.Embedding(cfg.type_vocab_size,
                                                        h)
        emb["LayerNorm"] = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.embeddings = _Holder(**emb)
        self.encoder = _Holder(layer=nn.ModuleList(
            TransformerLayer(cfg) for _ in range(cfg.num_layers)))
        self.pooler = _Holder(dense=nn.Linear(h, h))
        with torch.no_grad():
            for module in self.embeddings.children():
                if isinstance(module, nn.Embedding):
                    module.weight.normal_(0.0, 0.02)
        place(self, device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> tuple:
        cfg, emb = self.cfg, self.embeddings
        ids = input_ids.long()
        mask = attention_mask.bool()
        positions = torch.arange(ids.shape[1], device=ids.device)[None] \
            + cfg.position_offset
        x = emb.word_embeddings(ids) + emb.position_embeddings(positions)
        if cfg.type_vocab_size:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(ids)
            x = x + emb.token_type_embeddings(token_type_ids.long())
        x = emb.LayerNorm(x)
        gen = self._dropout_generator(x.device) if self.training else None
        x = dropout(x, cfg.dropout if self.training else 0.0, gen)
        for layer in self.encoder.layer:
            x = layer(x, mask, gen)
        pooled = torch.tanh(self.pooler.dense(x[:, 0]))
        return x, pooled


def _tower_forward(tower: TextTower, input_dict: dict) -> tuple:
    return tower(input_dict["input_ids"], input_dict["attention_mask"],
                 input_dict.get("token_type_ids"))


class _TowerEncoder(nn.Module):
    """A text encoder around one :class:`TextTower` named ``tower``."""

    def __init__(self, cfg: TextTowerConfig):
        super().__init__()
        self.cfg = cfg
        self.tower = TextTower(cfg, device=None)
        self.embed_dim = cfg.hidden_size


class Bert(_TowerEncoder):
    """[CLS]-pooling BERT text encoder (JAX ``pretrained_text.py:106-127``,
    reference models/text_encoder.py:271-293): ``{"seq_emb": hidden[:, 0],
    "token_emb": hidden, "attention_mask"}``."""

    def __init__(self, cfg: TextTowerConfig, device="cuda"):
        super().__init__(cfg)
        place(self, device)

    def forward(self, input_dict: dict) -> dict:
        hidden, _ = _tower_forward(self.tower, input_dict)
        return {"seq_emb": hidden[:, 0], "token_emb": hidden,
                "attention_mask": input_dict["attention_mask"]}


class SentenceBert(_TowerEncoder):
    """Mean-pooling sentence encoder (JAX ``pretrained_text.py:130-150``):
    the attention-masked token mean."""

    def __init__(self, cfg: TextTowerConfig, device="cuda"):
        super().__init__(cfg)
        place(self, device)

    def forward(self, input_dict: dict) -> dict:
        hidden, _ = _tower_forward(self.tower, input_dict)
        mask = input_dict["attention_mask"][..., None].to(hidden.dtype)
        seq_emb = (hidden * mask).sum(1) / torch.clamp_min(mask.sum(1), 1e-9)
        return {"seq_emb": seq_emb, "token_emb": hidden}


class ClapTextEncoder(_TowerEncoder):
    """CLAP text tower (JAX ``pretrained_text.py:153-185``): RoBERTa, the
    projection ``proj_out(relu(proj_hidden(·)))`` of the tokens and of the
    pooled vector, the latter L2-normalised: ``{"seq_emb" [B, P],
    "token_emb" [B, L, P]}``."""

    def __init__(self, cfg: TextTowerConfig, projection_dim: int = 512,
                 device="cuda"):
        super().__init__(cfg)
        self.projection_dim = self.embed_dim = projection_dim
        self.proj_hidden = nn.Linear(cfg.hidden_size, projection_dim)
        self.proj_out = nn.Linear(projection_dim, projection_dim)
        place(self, device)

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(torch.relu(self.proj_hidden(x)))

    def forward(self, input_dict: dict) -> dict:
        hidden, pooled = _tower_forward(self.tower, input_dict)
        return {"seq_emb": l2_normalize(self._project(pooled)),
                "token_emb": self._project(hidden)}


# --------------------------------------------------------------------------
# HF torch checkpoint import


def config_from_hf(hf_config) -> TextTowerConfig:
    """Map a transformers Bert/Roberta config onto TextTowerConfig."""
    is_roberta = getattr(hf_config, "model_type", "bert") == "roberta"
    return TextTowerConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=getattr(hf_config, "type_vocab_size", 0),
        layer_norm_eps=hf_config.layer_norm_eps,
        dropout=hf_config.hidden_dropout_prob,
        pad_token_id=getattr(hf_config, "pad_token_id", 0) or 0,
        position_offset=(hf_config.pad_token_id + 1) if is_roberta else 0,
    )


def tower_shapes(cfg: TextTowerConfig) -> dict:
    """``{state-dict key: shape}`` of a :class:`TextTower` of ``cfg``."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    out = {"embeddings.word_embeddings.weight": (cfg.vocab_size, h),
           "embeddings.position_embeddings.weight":
               (cfg.max_position_embeddings, h)}
    if cfg.type_vocab_size:
        out["embeddings.token_type_embeddings.weight"] = (
            cfg.type_vocab_size, h)
    out["embeddings.LayerNorm.weight"] = (h,)
    out["embeddings.LayerNorm.bias"] = (h,)
    for n in range(cfg.num_layers):
        lp = f"encoder.layer.{n}."
        for name, shape in (("attention.self.query", (h, h)),
                            ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)),
                            ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (i, h)),
                            ("output.dense", (h, i))):
            out[lp + name + ".weight"] = shape
            out[lp + name + ".bias"] = (shape[0],)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            out[lp + name + ".weight"] = (h,)
            out[lp + name + ".bias"] = (h,)
    out["pooler.dense.weight"] = (h, h)
    out["pooler.dense.bias"] = (h,)
    return out


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(value, np.float32))


def import_hf_bert_params(state_dict: dict, cfg: TextTowerConfig,
                          prefix: str = "") -> dict:
    """A torch BERT / RoBERTa state dict (tensors or numpy arrays) → the
    state dict of a :class:`TextTower` of ``cfg``: the keys under
    ``prefix`` (``"text_model."`` in a CLAP checkpoint, ``"bert."`` /
    ``"roberta."`` in MLM ones) with the prefix stripped, each checked for
    its shape; the identity pooler where the checkpoint has none.  A
    missing key raises ``KeyError``, a wrong shape ``ValueError``."""
    h = cfg.hidden_size
    out = {}
    for key, shape in tower_shapes(cfg).items():
        if key.startswith("pooler.") and \
                prefix + "pooler.dense.weight" not in state_dict:
            out["pooler.dense.weight"] = torch.eye(h)
            out["pooler.dense.bias"] = torch.zeros(h)
            continue
        if prefix + key not in state_dict:
            raise KeyError(f"the checkpoint has no {prefix + key}")
        value = _tensor(state_dict[prefix + key])
        if tuple(value.shape) != shape:
            raise ValueError(f"{prefix + key}: shape {tuple(value.shape)}, "
                             f"the config's is {shape}")
        out[key] = value
    return out


def import_clap_text_params(state_dict: dict, cfg: TextTowerConfig) -> dict:
    """A HF ``ClapModel`` state dict (``text_model.*`` and
    ``text_projection.linear1`` / ``linear2``) → the state dict of a
    :class:`ClapTextEncoder` of ``cfg``."""
    out = {f"tower.{k}": v for k, v in import_hf_bert_params(
        state_dict, cfg, prefix="text_model.").items()}
    for ours, theirs in (("proj_hidden", "linear1"), ("proj_out", "linear2")):
        for leaf in ("weight", "bias"):
            out[f"{ours}.{leaf}"] = _tensor(
                state_dict[f"text_projection.{theirs}.{leaf}"])
    return out
