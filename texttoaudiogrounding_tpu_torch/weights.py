"""Weights for the port: from the JAX package's variables, or random from
a numpy seed.

``from_jax_variables`` maps the JAX ``{"params", "batch_stats"}`` tree of
a grounding model (``BiEncoder``, ``MultiTextBiEncoder`` and
``MultiTextBiEncoderWithAlign``, the align models of
``models/align_models.py``, and the class-mapping ``AudioTagging``, whose
tree is ``audio_encoder`` and ``fc_output``; audio tower ``Cnn8Rnn`` or
``CrnnEncoder``, text tower ``EmbeddingAgg``, with a
``CrossAttentionGating`` cross encoder
or a ``CrossAttention`` match function) onto the port's state dict,
whose names and layouts are the reference torch ones: conv kernels
``[kH, kW, Cin, Cout] → [Cout, Cin, kH, kW]``, dense kernels transposed,
BatchNorm ``scale`` → ``weight`` with the running statistics as buffers,
and each GRU direction's six flax gate modules stacked into ``nn.GRU``'s
``weight_ih_l0`` / ``weight_hh_l0`` / ``bias_ih_l0`` / ``bias_hh_l0``
(the flax ``hr``/``hz`` gates carry no bias: their biases live in the
``ir``/``iz`` ones, so ``bias_hh_l0`` is zero there), and flax's
attention ``DenseGeneral`` kernels flattened over their heads
(``[D, H, Dh]`` → ``[H·Dh, D]``, ``[H, Dh, E]`` → ``[E, H·Dh]``).  The layout logic is
a copy of ``texttoaudiogrounding_tpu/training/torch_import.py:176-294``.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p) -> torch.Tensor:
    return _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _bn(sd: dict, name: str, params: dict, stats: dict) -> None:
    sd[f"{name}.weight"] = _t(params["scale"])
    sd[f"{name}.bias"] = _t(params["bias"])
    sd[f"{name}.running_mean"] = _t(stats["mean"])
    sd[f"{name}.running_var"] = _t(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _dense(sd: dict, name: str, params: dict) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(params["kernel"]).T)
    if "bias" in params:
        sd[f"{name}.bias"] = _t(params["bias"])


def _gru(sd: dict, prefix: str, cell: dict, suffix: str) -> None:
    def k(name):
        return np.asarray(cell[name]["kernel"]).T

    h = k("hr").shape[0]
    zeros = np.zeros(h, np.float32)
    sd[f"{prefix}.weight_ih_l0{suffix}"] = _t(
        np.concatenate([k("ir"), k("iz"), k("in")]))
    sd[f"{prefix}.weight_hh_l0{suffix}"] = _t(
        np.concatenate([k("hr"), k("hz"), k("hn")]))
    sd[f"{prefix}.bias_ih_l0{suffix}"] = _t(np.concatenate(
        [cell["ir"]["bias"], cell["iz"]["bias"], cell["in"]["bias"]]))
    sd[f"{prefix}.bias_hh_l0{suffix}"] = _t(
        np.concatenate([zeros, zeros, cell["hn"]["bias"]]))


def _crnn(sd: dict, a: str, ap: dict, ast: dict) -> None:
    """A ``CrnnEncoder`` tower: flax's auto-named ``CDurBlock_0..4``
    (``BatchNorm_0``, ``Conv_0``) → ``block1..5`` (``bn``, ``conv``), and
    the BiGRU ``gru``."""
    for i in range(5):
        blk, jblk = f"{a}.block{i + 1}", f"CDurBlock_{i}"
        _bn(sd, f"{blk}.bn", ap[jblk]["BatchNorm_0"], ast[jblk]["BatchNorm_0"])
        sd[f"{blk}.conv.weight"] = _conv(ap[jblk]["Conv_0"])
    _gru(sd, f"{a}.gru", ap["gru"]["GRUCell_0"], "")
    _gru(sd, f"{a}.gru", ap["gru"]["GRUCell_1"], "_reverse")


def _cross(sd: dict, params: dict) -> None:
    """A ``CrossAttentionGating`` cross encoder and a ``CrossAttention``
    match function, where the model has them."""
    if "cross_encoder" in params:
        c = params["cross_encoder"]
        _dense(sd, "cross_encoder.attn.h2attn_q", c["attn"]["h2attn_q"])
        _dense(sd, "cross_encoder.attn.h2attn_k", c["attn"]["h2attn_k"])
        sd["cross_encoder.attn.v"] = _t(c["attn"]["v"])
        for fc in ("fc_u", "fc_s"):
            _dense(sd, f"cross_encoder.gating.{fc}", c["gating"][fc])
    if "match_fn" in params:
        m = params["match_fn"]
        for name in ("query", "key", "value"):
            kernel = np.asarray(m["attn"][name]["kernel"])     # [D, H, Dh]
            sd[f"match_fn.attn.{name}.weight"] = _t(
                kernel.reshape(kernel.shape[0], -1).T)
            sd[f"match_fn.attn.{name}.bias"] = _t(
                np.asarray(m["attn"][name]["bias"]).reshape(-1))
        kernel = np.asarray(m["attn"]["out"]["kernel"])        # [H, Dh, E]
        sd["match_fn.attn.out.weight"] = _t(
            kernel.reshape(-1, kernel.shape[-1]).T)
        sd["match_fn.attn.out.bias"] = _t(m["attn"]["out"]["bias"])
        sd["match_fn.norm.weight"] = _t(m["norm"]["scale"])
        sd["match_fn.norm.bias"] = _t(m["norm"]["bias"])
        _dense(sd, "match_fn.linear", m["linear"])


def from_jax_variables(variables: dict) -> dict:
    """JAX grounding-model variables (nested dicts of arrays) → the port's
    state dict of CPU f32 tensors for the same model."""
    params, stats = variables["params"], variables["batch_stats"]
    ap, ast = params["audio_encoder"], stats["audio_encoder"]
    sd: dict = {}
    a = "audio_encoder"
    _cross(sd, params)
    if "CDurBlock_0" in ap:
        _crnn(sd, a, ap, ast)
        _text(sd, params)
        return sd
    _bn(sd, f"{a}.bn0", ap["bn0"], ast["bn0"])
    for i in range(1, 5):
        blk = f"conv_block{i}"
        sd[f"{a}.{blk}.conv1.weight"] = _conv(ap[blk]["conv1"])
        sd[f"{a}.{blk}.conv2.weight"] = _conv(ap[blk]["conv2"])
        for bn in ("bn1", "bn2"):
            _bn(sd, f"{a}.{blk}.{bn}", ap[blk][bn], ast[blk][bn])
    _dense(sd, f"{a}.fc1", ap["fc1"])
    _gru(sd, f"{a}.rnn", ap["rnn"]["GRUCell_0"], "")
    _gru(sd, f"{a}.rnn", ap["rnn"]["GRUCell_1"], "_reverse")
    _text(sd, params)
    return sd


def _text(sd: dict, params: dict) -> None:
    """The ``EmbeddingAgg`` tower and the projections, or the tagging
    head ``fc_output`` of a model without a text tower."""
    if "text_encoder" not in params:
        _dense(sd, "fc_output", params["fc_output"])
        return
    text = params["text_encoder"]
    sd["text_encoder.embedding.core.weight"] = _t(
        text["embedding"]["embed"]["embedding"])
    if "attn" in text:
        _dense(sd, "text_encoder.attn.fc", text["attn"]["Dense_0"])
    for proj in ("audio_proj", "text_proj"):
        if proj in params:
            _dense(sd, proj, params[proj])


def random_state_dict(model: torch.nn.Module, seed: int = 0) -> dict:
    """Random weights for every entry of ``model``'s state dict, made with
    numpy from ``seed``: xavier-uniform convs and dense layers,
    1/sqrt(fan-in) GRU weights (r/z recurrent biases zero, as in the JAX
    parameter tree), BatchNorm affines near identity, and the running
    statistics of the BatchNorms over the log-mel (``bn0``, CDur's
    ``block1.bn``) at the scale of log-mel dB values."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        if name.endswith("num_batches_tracked"):
            out[name] = torch.tensor(0)
            continue
        # the BatchNorms over the log-mel: Cnn8Rnn's bn0, CDur's block 1
        if name.endswith(("bn0.running_mean", "block1.bn.running_mean")):
            v = rng.uniform(-40.0, -20.0, shape)
        elif name.endswith(("bn0.running_var", "block1.bn.running_var")):
            v = rng.uniform(100.0, 400.0, shape)
        elif name.endswith("running_mean"):
            v = rng.normal(0.0, 0.1, shape)
        elif name.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif ".bn" in name and name.endswith("weight"):
            v = rng.uniform(0.5, 1.5, shape)
        elif "weight_ih" in name or "weight_hh" in name:
            v = rng.normal(0.0, 1.0 / np.sqrt(shape[1]), shape)
        elif name.endswith("core.weight"):
            v = rng.normal(0.0, 0.1, shape)
        elif name.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            fan_out = shape[0] * int(np.prod(shape[2:]))
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            v = rng.uniform(-lim, lim, shape)
        else:                                   # biases
            v = rng.normal(0.0, 0.05, shape)
            if "bias_hh" in name:
                # the JAX tree has no r/z recurrent biases (see _gru)
                v[:2 * shape[0] // 3] = 0.0
        out[name] = torch.from_numpy(np.asarray(v, np.float32))
    return out
