"""Sentence-level alignment models: every audio against every caption,
``sim [B, B]`` for the ranking losses.

Port of ``texttoaudiogrounding_tpu/models/align_models.py`` (reference
models/audio_text_model.py:843-1073).  The word-wise model aligns the
frames with the caption's tokens; the phrase-wise models with a variable
number of phrases a caption, which ``VarNumTextCollate`` flattens to
``{key} [ΣN, L]`` with ``{key}_num [B]`` and the gather map
``{key}_pad_index [B, max N]`` (:func:`pack_phrases`).  ``match_fn`` is
an align function (``models/align.py``) for the first two and a match
function after a cross encoder for :class:`AudioTextCrossAlignByPhrase`.
``output_matrix`` in the input adds ``sim_matrix [B, B, T, N]``.

On several ranks (``parallel/kernel_shard.py``) a rank's audio rows meet
the captions of the whole global batch: ``whole_batch_inputs`` names the
text keys, which the feed gives every rank whole (``parallel/mesh.py``),
and the text tower runs on all of them outside the ``data`` axis (its
dropout drawn as one rank draws it, no statistics summed over ranks).  A
rank then computes its block ``sim [b, B]`` of the matrix, and the loss
gathers the blocks.  Each rank's graph holds the text tower's share of
its own block only, so the gradients summed over the ranks are the
global ones, and no collective runs on the text side.  (Gathering the
rank's text embeddings instead would need a backward that sums over the
``data`` axis: ``gather_rows`` keeps a rank's own rows, right only where
every rank computes the same function of the gathered tensor.)  The
text tower runs N times, for the shipped word2vec-mean towers a table
lookup and a mean.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.models.audio_text_model import _Grounding
from texttoaudiogrounding_tpu_torch.parallel import kernel_shard


def pack_phrases(flat: torch.Tensor, pad_index: torch.Tensor,
                 nums: torch.Tensor) -> torch.Tensor:
    """``[ΣN, ...]`` → ``[B, max N, ...]`` by the collate's gather map, the
    padding rows zeroed (the reference's ``pad_sequence``)."""
    packed = flat[pad_index]
    mask = (torch.arange(pad_index.shape[1], device=nums.device)[None, :]
            < nums[:, None])
    return packed * mask.reshape(*mask.shape, *([1] * (packed.dim() - 2))
                                 ).to(packed.dtype)


def _phrase_keys(key: str) -> tuple:
    """A ``VarNumTextCollate`` group's keys under ``key``."""
    return (key, f"{key}_len", f"{key}_num", f"{key}_pad_index")


class _Align(_Grounding):
    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, sim_pooling: nn.Module,
                 shared_dim: int, add_proj: bool,
                 cross_encoder: nn.Module | None,
                 freeze_audio_encoder: bool, freeze_text_encoder: bool,
                 device, project: bool = True):
        super().__init__(audio_encoder, text_encoder, match_fn, shared_dim,
                         add_proj, cross_encoder, False,
                         freeze_audio_encoder, freeze_text_encoder, project)
        self.sim_pooling = sim_pooling
        self._place(device)

    @staticmethod
    def text_side():
        """The context the text tower runs in: outside the ``data`` axis,
        on the whole batch's texts (see the module's docstring)."""
        return kernel_shard.data_parallel(None)

    def _pooled(self, input_dict: dict, sim_matrix: torch.Tensor,
                audio_len: torch.Tensor, text_len: torch.Tensor) -> dict:
        out = {"sim": self.sim_pooling({"sim": sim_matrix,
                                        "audio_len": audio_len,
                                        "text_len": text_len})}
        if input_dict.get("output_matrix", False):
            out["sim_matrix"] = sim_matrix
        return out


class AudioTextAlignByWord(_Align):
    """The frames against the caption's tokens (``text``, ``text_len``):
    ``sim_matrix [B, B, T, L]``."""

    whole_batch_inputs = ("text", "text_len")

    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, sim_pooling: nn.Module,
                 shared_dim: int = 512, add_proj: bool = False,
                 freeze_audio_encoder: bool = False,
                 freeze_text_encoder: bool = False, device="cuda"):
        super().__init__(audio_encoder, text_encoder, match_fn, sim_pooling,
                         shared_dim, add_proj, None, freeze_audio_encoder,
                         freeze_text_encoder, device)

    def forward(self, input_dict: dict) -> dict:
        audio_out = self.audio_encoder(input_dict)
        audio_emb = audio_out["embedding"]
        with self.text_side():
            word_emb = self.text_encoder(input_dict)["token_emb"]
        if self.needs_proj:
            audio_emb = self.audio_proj(audio_emb)
            word_emb = self.text_proj(word_emb)
        return self._pooled(input_dict, self.match_fn(audio_emb, word_emb),
                            audio_out["length"], input_dict["text_len"])


class AudioTextAlignByPhrase(_Align):
    """The frames against each caption's phrases (``phrases`` under
    ``text_key``): their sequence embeddings packed to ``[B, max N, D]``,
    ``sim_matrix [B, B, T, max N]``.  ``cross_encoder`` is taken and
    unused, as in the JAX model."""

    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, sim_pooling: nn.Module,
                 shared_dim: int = 512,
                 cross_encoder: nn.Module | None = None,
                 add_proj: bool = False, freeze_audio_encoder: bool = False,
                 freeze_text_encoder: bool = False,
                 text_key: str = "phrases", device="cuda"):
        super().__init__(audio_encoder, text_encoder, match_fn, sim_pooling,
                         shared_dim, add_proj, None, freeze_audio_encoder,
                         freeze_text_encoder, device)
        self.text_key = text_key

    @property
    def whole_batch_inputs(self) -> tuple:
        return _phrase_keys(self.text_key)

    def forward(self, input_dict: dict) -> dict:
        audio_out = self.audio_encoder(input_dict)
        audio_emb = audio_out["embedding"]
        key = self.text_key
        with self.text_side():
            seq_emb = self.text_encoder({
                "text": input_dict[key],
                "text_len": input_dict[f"{key}_len"]})["seq_emb"]
        nums = input_dict[f"{key}_num"]
        seq_emb = pack_phrases(seq_emb, input_dict[f"{key}_pad_index"], nums)
        if self.needs_proj:
            audio_emb = self.audio_proj(audio_emb)
            seq_emb = self.text_proj(seq_emb)
        return self._pooled(input_dict, self.match_fn(audio_emb, seq_emb),
                            audio_out["length"], nums)


class AudioTextCrossAlignByPhrase(_Align):
    """Every (audio, phrase) pair of the batch through the cross encoder in
    one flat batch of ``B·ΣN`` rows, scored by ``match_fn``, then packed
    to ``sim_matrix [B, B, T, max N]``.  No projections, as in the JAX
    package.  Always returns ``sim_matrix``."""

    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, sim_pooling: nn.Module,
                 cross_encoder: nn.Module, shared_dim: int = 512,
                 add_proj: bool = False, freeze_audio_encoder: bool = False,
                 freeze_text_encoder: bool = False,
                 text_key: str = "phrases", device="cuda"):
        super().__init__(audio_encoder, text_encoder, match_fn, sim_pooling,
                         shared_dim, add_proj, cross_encoder,
                         freeze_audio_encoder, freeze_text_encoder, device,
                         project=False)
        self.text_key = text_key

    @property
    def whole_batch_inputs(self) -> tuple:
        return _phrase_keys(self.text_key)

    def forward(self, input_dict: dict) -> dict:
        audio_out = self.audio_encoder(input_dict)
        audio_emb, audio_len = audio_out["embedding"], audio_out["length"]
        key = self.text_key
        text_len = input_dict[f"{key}_len"]
        with self.text_side():
            token_emb = self.text_encoder({"text": input_dict[key],
                                           "text_len": text_len}
                                          )["token_emb"]
        nums = input_dict[f"{key}_num"]
        b, t, d = audio_emb.shape
        s = token_emb.shape[0]                                 # ΣN
        fwd = {"audio_emb": audio_emb[:, None].expand(b, s, t, d)
               .reshape(b * s, t, d),
               "text_emb": {"token_emb": token_emb[None].expand(
                   b, *token_emb.shape).reshape(b * s, *token_emb.shape[1:])},
               "audio_len": audio_len.repeat_interleave(s),
               "text_len": text_len.repeat(b)}
        fwd.update(self.cross_encoder(fwd))
        sim = self.match_fn(fwd["audio_emb"], fwd["text_emb"],
                            fwd["text_len"]).reshape(b, s, -1)
        # [B, ΣN, T] → [B, B, max N, T] → [B, B, T, max N]
        sim_matrix = pack_phrases(sim.transpose(0, 1),
                                  input_dict[f"{key}_pad_index"], nums)
        sim_matrix = sim_matrix.permute(2, 0, 3, 1)
        out = self._pooled({}, sim_matrix, audio_len, nums)
        out["sim_matrix"] = sim_matrix
        return out
