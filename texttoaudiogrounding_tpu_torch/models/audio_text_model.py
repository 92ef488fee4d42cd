"""Audio-text grounding models: audio encoder + text encoder +
projections + match.

Ports of ``texttoaudiogrounding_tpu/models/audio_text_model.py:105-154``
(``BiEncoder``, reference models/audio_text_model.py:16-98), ``:57-102,
157-214`` (``MultiTextBiEncoder``, the phrase-level WSTAG model, reference
:101-229), ``:217-297`` (``MultiTextBiEncoderWithAlign``, reference
:232-402) and ``:301-317`` (``AudioTagging``, the class-mapping
model).  ``BiEncoder`` gives ``{"frame_sim" [B, T], "length" [B]}``,
and ``"logit" [B, T]``, the pre-sigmoid score, for a match function that
has one (``DotProduct``) when nothing is upsampled;
``MultiTextBiEncoder`` gives ``{"frame_sim" [B, T, N], "clip_sim" [B, N],
"length" [B]}``.  A sequence-level match function with a ``pairwise``
form scores one audio against its N phrases in one product; with a cross
encoder or a token-level match function the audio is repeated to
``[B·N, T, D]`` (the broadcast branch).  ``upsample=True`` interpolates
``frame_sim`` linearly over time by the encoder's ``downsample_ratio``
(``F.interpolate``, ``align_corners=False``, as ``jax.image.resize``) and
multiplies the length by it.  ``model.train()`` puts a model in train mode
(batch-statistics BN, dropout), as the JAX model's ``train=True``.
``freeze_audio_encoder`` / ``freeze_text_encoder`` are read by the
optimizer's freeze mask (``training/optim.py:freeze_mask_from_model``), as
in the JAX package (``audio_text_model.py:110-122``), not by the module.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.device import resolve_device
from texttoaudiogrounding_tpu_torch.models.audio_encoder import Cnn8Rnn
from texttoaudiogrounding_tpu_torch.models.match import DotProduct
from texttoaudiogrounding_tpu_torch.models.text_encoder import EmbeddingAgg
from texttoaudiogrounding_tpu_torch.ops.masking import POOLINGS


def linear_upsample(frame_sim: torch.Tensor, ratio: int) -> torch.Tensor:
    """``[B, T, ...]`` → ``[B, T·ratio, ...]``, linear over time with
    half-pixel centres (the edges held)."""
    x = frame_sim.reshape(frame_sim.shape[0], frame_sim.shape[1], -1)
    x = F.interpolate(x.transpose(1, 2), size=x.shape[1] * ratio,
                      mode="linear", align_corners=False).transpose(1, 2)
    return x.reshape(x.shape[0], x.shape[1], *frame_sim.shape[2:])


def project_text(text_emb: dict, text_proj) -> dict:
    """The text dict's ``seq_emb`` / ``token_emb`` through ``text_proj``."""
    if text_proj is None:
        return text_emb
    return {k: text_proj(v) if k in ("seq_emb", "token_emb") else v
            for k, v in text_emb.items()}


class _Grounding(nn.Module):
    """What the grounding models share: the towers, the projections to
    ``shared_dim`` where the widths differ (or ``add_proj``; none without
    ``project``), the device."""

    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, shared_dim: int, add_proj: bool,
                 cross_encoder: nn.Module | None, upsample: bool,
                 freeze_audio_encoder: bool, freeze_text_encoder: bool,
                 project: bool = True):
        super().__init__()
        self.freeze_audio_encoder = freeze_audio_encoder
        self.freeze_text_encoder = freeze_text_encoder
        self.audio_encoder = audio_encoder
        self.text_encoder = text_encoder
        self.match_fn = match_fn
        self.cross_encoder = cross_encoder
        self.upsample = upsample
        self.needs_proj = project and (add_proj or audio_encoder.embed_dim
                                       != text_encoder.embed_dim)
        if self.needs_proj:
            self.audio_proj = nn.Linear(audio_encoder.embed_dim, shared_dim)
            self.text_proj = nn.Linear(text_encoder.embed_dim, shared_dim)

    def _place(self, device) -> None:
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _upsampled(self, frame_sim: torch.Tensor, length: torch.Tensor
                   ) -> tuple:
        ratio = self.audio_encoder.downsample_ratio
        if ratio == 1 or not self.upsample:
            return frame_sim, length
        return linear_upsample(frame_sim, ratio), length * ratio


class BiEncoder(_Grounding):
    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, shared_dim: int = 512,
                 add_proj: bool = False, upsample: bool = False,
                 freeze_audio_encoder: bool = False,
                 freeze_text_encoder: bool = False, device="cuda"):
        super().__init__(audio_encoder, text_encoder, match_fn, shared_dim,
                         add_proj, None, upsample, freeze_audio_encoder,
                         freeze_text_encoder)
        self._place(device)

    def forward(self, input_dict: dict) -> dict:
        audio_out = self.audio_encoder(input_dict)
        text_emb = self.text_encoder(input_dict)
        audio_emb = audio_out["embedding"]
        if self.needs_proj:
            audio_emb = self.audio_proj(audio_emb)
            text_emb = project_text(text_emb, self.text_proj)
        out = {"length": audio_out["length"]}
        if hasattr(self.match_fn, "logits"):
            out["logit"] = self.match_fn.logits(audio_emb, text_emb)
            out["frame_sim"] = torch.clamp(torch.sigmoid(out["logit"]),
                                           1e-7, 1.0)
        else:
            out["frame_sim"] = self.match_fn(audio_emb, text_emb,
                                             input_dict.get("text_len"))
        frame_sim, length = self._upsampled(out["frame_sim"], out["length"])
        if frame_sim is not out["frame_sim"]:    # no logit at the new rate
            return {"frame_sim": frame_sim, "length": length}
        return out


class MultiTextBiEncoder(_Grounding):
    """One audio against N phrases: ``frame_sim [B, T, N]`` and
    ``clip_sim [B, N]``, the frames pooled over the valid length by
    ``pooling`` (``linear_softmax``, ``max``, ``mean`` or ``exp_softmax``).
    The text keys ``[B, N, L]`` of ``text_forward_keys`` (``text_len``
    always among them) go through the text encoder as ``[B·N, L]``."""

    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, shared_dim: int = 512,
                 text_forward_keys=("text", "text_len"),
                 cross_encoder: nn.Module | None = None,
                 pooling: str = "linear_softmax", add_proj: bool = False,
                 upsample: bool = False, freeze_audio_encoder: bool = False,
                 freeze_text_encoder: bool = False, device="cuda"):
        super().__init__(audio_encoder, text_encoder, match_fn, shared_dim,
                         add_proj, cross_encoder, upsample,
                         freeze_audio_encoder, freeze_text_encoder)
        if pooling not in POOLINGS:
            raise ValueError(f"pooling must be one of {sorted(POOLINGS)}")
        self.pooling = pooling
        self.text_forward_keys = tuple(text_forward_keys)
        self._place(device)

    def _phrases(self, input_dict: dict) -> dict:
        """The phrase branch: ``frame_sim [B, T, N]`` and ``clip_sim`` (at
        the encoder's rate), the projected audio, the text encoder's
        output ``[B·N, ...]`` (before projection) and the audio length."""
        audio_out = self.audio_encoder(input_dict)
        audio_emb = audio_out["embedding"]
        audio_len = audio_out["length"]
        if self.needs_proj:
            audio_emb = self.audio_proj(audio_emb)
        keys = list(self.text_forward_keys)
        if "text_len" not in keys:
            keys.append("text_len")
        b, n = input_dict[keys[0]].shape[:2]
        text_forward = {k: input_dict[k].reshape(-1, *input_dict[k].shape[2:])
                        for k in keys}
        text_emb = self.text_encoder(text_forward)
        text_proj = self.text_proj if self.needs_proj else None
        if (self.cross_encoder is None and hasattr(self.match_fn, "pairwise")
                and getattr(self.match_fn, "text_level", "seq") == "seq"):
            seq_emb = project_text(text_emb, text_proj)["seq_emb"]
            frame_sim = self.match_fn.pairwise(
                audio_emb, seq_emb.reshape(b, n, -1))         # [B, N, T]
        else:                                      # the broadcast branch
            t, d = audio_emb.shape[1:]
            fwd = {"audio_emb": audio_emb[:, None].expand(b, n, t, d)
                   .reshape(b * n, t, d),
                   "text_emb": text_emb,
                   "audio_len": audio_len.repeat_interleave(n),
                   "text_len": text_forward["text_len"]}
            if self.cross_encoder is not None:
                fwd.update(self.cross_encoder(fwd))
            frame_sim = self.match_fn(
                fwd["audio_emb"], project_text(fwd["text_emb"], text_proj),
                fwd["text_len"]).reshape(b, n, -1)
        frame_sim = frame_sim.transpose(1, 2)                  # [B, T, N]
        return {"frame_sim": frame_sim, "audio_emb": audio_emb,
                "text_emb": text_emb, "length": audio_len,
                "clip_sim": POOLINGS[self.pooling](frame_sim, audio_len),
                "shape": (b, n)}

    def forward(self, input_dict: dict) -> dict:
        out = self._phrases(input_dict)
        frame_sim, length = self._upsampled(out["frame_sim"], out["length"])
        return {"frame_sim": frame_sim, "clip_sim": out["clip_sim"],
                "length": length}


class MultiTextBiEncoderWithAlign(MultiTextBiEncoder):
    """``MultiTextBiEncoder`` (its ``pooling`` named ``phrase_pooling``)
    with a sentence-level branch: every audio against every clip's
    phrases through ``align_fn`` (``sim_matrix [B, B, T, N]``, on the
    projected audio and the unprojected phrase embeddings, as in the JAX
    package), pooled by ``sentence_pooling`` over the positive phrases to
    ``sentence_sim [B, B]``.  The positives come first in each clip, so
    the branch runs over all N phrases with ``text_len = label.sum(1)``,
    as in JAX.  In eval mode without a ``label`` the branch is skipped;
    ``output_matrix`` in the input adds ``sim_matrix``."""

    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, align_fn: nn.Module,
                 sentence_pooling: nn.Module, shared_dim: int = 512,
                 text_forward_keys=("text", "text_len"),
                 cross_encoder: nn.Module | None = None,
                 phrase_pooling: str = "linear_softmax",
                 add_proj: bool = False, upsample: bool = False,
                 freeze_audio_encoder: bool = False,
                 freeze_text_encoder: bool = False, device="cuda"):
        super().__init__(audio_encoder, text_encoder, match_fn, shared_dim,
                         text_forward_keys, cross_encoder, phrase_pooling,
                         add_proj, upsample, freeze_audio_encoder,
                         freeze_text_encoder, device)
        self.align_fn = align_fn
        self.sentence_pooling = sentence_pooling
        self._place(device)

    def forward(self, input_dict: dict) -> dict:
        out = self._phrases(input_dict)
        frame_sim, length = self._upsampled(out["frame_sim"], out["length"])
        output = {"frame_sim": frame_sim, "clip_sim": out["clip_sim"],
                  "length": length}
        if not self.training and "label" not in input_dict:
            return output
        b, n = out["shape"]
        sim_matrix = self.align_fn(out["audio_emb"],
                                   out["text_emb"]["seq_emb"].reshape(
                                       b, n, -1))
        output["sentence_sim"] = self.sentence_pooling({
            "sim": sim_matrix, "audio_len": out["length"],
            "text_len": input_dict["label"].sum(1).long()})
        if input_dict.get("output_matrix", False):
            output["sim_matrix"] = sim_matrix
        return output


class AudioTagging(nn.Module):
    """The class-mapping model (JAX ``audio_text_model.py:301-317``,
    reference models/audio_text_model.py:405-458): the audio encoder, a
    ``Linear(embed_dim, classes_num)`` (``fc_output``), the sigmoid, and
    the MIL pooling ``pooling`` over the valid length: ``{"frame_sim"
    [B, T, C], "clip_sim" [B, C], "length" [B]}`` (under mixup in train
    mode B is half the input's and the length is float)."""

    def __init__(self, audio_encoder: nn.Module, classes_num: int,
                 pooling: str = "linear_softmax", device="cuda"):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"pooling must be one of {sorted(POOLINGS)}")
        self.audio_encoder = audio_encoder
        self.classes_num = classes_num
        self.pooling = pooling
        self.fc_output = nn.Linear(audio_encoder.embed_dim, classes_num)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, input_dict: dict) -> dict:
        output = self.audio_encoder(input_dict)
        prob = torch.sigmoid(self.fc_output(output["embedding"]))
        return {"frame_sim": prob,
                "clip_sim": POOLINGS[self.pooling](prob, output["length"]),
                "length": output["length"]}


def flagship_model(serving: bool = True, device="cuda",
                   vocab_size: int = 5000, embed_dim: int = 512,
                   shared_dim: int = 512,
                   gru_kernel: bool | None = None,
                   block1_quant: str = "conv1",
                   block1_tc: int = 48,
                   block1_mode: str = "triple") -> BiEncoder:
    """The flagship grounding model (the JAX package's
    ``__graft_entry__._flagship_model``): ``BiEncoder(Cnn8Rnn,
    EmbeddingAgg(5000, 512), DotProduct, shared_dim=512, add_proj=True)``.
    ``serving=True`` is the int8 serving path (bf16 dtype, int8 conv
    blocks), ``False`` the f32 path; ``gru_kernel`` as in ``BiGRU``
    (``False`` with ``serving=False`` is the all-plain path);
    ``block1_quant``, ``block1_tc`` and ``block1_mode`` as in ``Cnn8Rnn``
    (the JAX ``TTG_B1_QUANT`` / ``TTG_B1_TC`` / ``TTG_B1_MODE``, read only
    by the serving path)."""
    audio = (Cnn8Rnn(dtype=torch.bfloat16, conv_mode="int8",
                     gru_kernel=gru_kernel, block1_quant=block1_quant,
                     block1_tc=block1_tc, block1_mode=block1_mode)
             if serving
             else Cnn8Rnn(gru_kernel=gru_kernel))
    return BiEncoder(audio, EmbeddingAgg(vocab_size, embed_dim),
                     DotProduct(), shared_dim=shared_dim, add_proj=True,
                     device=device)
