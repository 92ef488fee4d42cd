"""Weights for the port: from the JAX package's variables, or random from
a numpy seed.

``from_jax_variables`` maps the JAX ``{"params", "batch_stats"}`` tree of
a ``BiEncoder(Cnn8Rnn, EmbeddingAgg, …)`` onto the port's state dict,
whose names and layouts are the reference torch ones: conv kernels
``[kH, kW, Cin, Cout] → [Cout, Cin, kH, kW]``, dense kernels transposed,
BatchNorm ``scale`` → ``weight`` with the running statistics as buffers,
and each GRU direction's six flax gate modules stacked into ``nn.GRU``'s
``weight_ih_l0`` / ``weight_hh_l0`` / ``bias_ih_l0`` / ``bias_hh_l0``
(the flax ``hr``/``hz`` gates carry no bias: their biases live in the
``ir``/``iz`` ones, so ``bias_hh_l0`` is zero there).  The layout logic is
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


def from_jax_variables(variables: dict) -> dict:
    """JAX BiEncoder variables (nested dicts of arrays) → the port's
    ``BiEncoder`` state dict of CPU f32 tensors."""
    params, stats = variables["params"], variables["batch_stats"]
    ap, ast = params["audio_encoder"], stats["audio_encoder"]
    sd: dict = {}
    a = "audio_encoder"
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
    text = params["text_encoder"]
    sd["text_encoder.embedding.core.weight"] = _t(
        text["embedding"]["embed"]["embedding"])
    if "attn" in text:
        _dense(sd, "text_encoder.attn.fc", text["attn"]["Dense_0"])
    for proj in ("audio_proj", "text_proj"):
        if proj in params:
            _dense(sd, proj, params[proj])
    return sd


def random_state_dict(model: torch.nn.Module, seed: int = 0) -> dict:
    """Random weights for every entry of ``model``'s state dict, made with
    numpy from ``seed``: xavier-uniform convs and dense layers,
    1/sqrt(fan-in) GRU weights (r/z recurrent biases zero, as in the JAX
    parameter tree), BatchNorm affines near identity, and bn0
    running statistics at the scale of log-mel dB values."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        if name.endswith("num_batches_tracked"):
            out[name] = torch.tensor(0)
            continue
        if name.endswith("bn0.running_mean"):
            v = rng.uniform(-40.0, -20.0, shape)
        elif name.endswith("bn0.running_var"):
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
