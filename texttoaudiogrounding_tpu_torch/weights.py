"""Weights for the port: from the JAX package's variables, or random from
a numpy seed.

``from_jax_variables(variables, model)`` maps the JAX ``{"params",
"batch_stats"}`` tree of the module that the port's ``model`` ports (a
grounding, tagging, align, cross, retrieval or released model, a text
tower or encoder, or any layer of them) onto ``model``'s state dict,
whose names and layouts are the reference torch ones, entry by entry
from the flax path that :func:`flax_leaf` gives each name: conv kernels
``[kH, kW, Cin, Cout] → [Cout, Cin, kH, kW]``, dense kernels transposed,
BatchNorm ``scale`` → ``weight`` with the running statistics as buffers,
and each GRU direction's six flax gate modules stacked into ``nn.GRU``'s
``weight_ih_l0`` / ``weight_hh_l0`` / ``bias_ih_l0`` / ``bias_hh_l0``
(the flax ``hr``/``hz`` gates carry no bias: their biases live in the
``ir``/``iz`` ones, so ``bias_hh_l0`` is zero there), and flax's
attention ``DenseGeneral`` kernels flattened over their heads
(``[D, H, Dh]`` → ``[H·Dh, D]``, ``[H, Dh, E]`` → ``[E, H·Dh]``).  The
layouts are those of
``texttoaudiogrounding_tpu/training/torch_import.py:176-294``.
A model sharded by ``parallel.rules`` takes these full tensors before
``parallel/tensor_parallel.py:shard_model`` cuts it, or cut to its slices
by ``tensor_parallel.shard_state_dict`` after.  The rules match
:func:`flax_leaf`'s paths too.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax_variables(variables: dict, model: torch.nn.Module) -> dict:
    """JAX variables (nested dicts of arrays: ``params`` and, where the
    model has BatchNorms, ``batch_stats``) of the module that ``model``
    ports → ``model``'s state dict of CPU f32 tensors, each entry found by
    its flax path (:func:`flax_leaf`); BatchNorm running statistics from
    ``batch_stats``.  A gradient tree converts as the weights do."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}
    for name, ref in model.state_dict().items():
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if leaf == "num_batches_tracked":
            sd[name] = torch.tensor(0)
        elif leaf in ("running_mean", "running_var"):
            path = flax_leaf(model, f"{owner}.weight")[0][0][:-1]
            sd[name] = _t(_get(stats, path + (leaf[len("running_"):],)))
        else:
            sd[name] = _t(_flax_value(model, name, params, tuple(ref.shape)))
        if tuple(sd[name].shape) != tuple(ref.shape):
            raise ValueError(f"{name}: the flax leaf gives "
                             f"{tuple(sd[name].shape)}, the model has "
                             f"{tuple(ref.shape)}")
    return sd


# module names that differ between the two trees: the port's name → flax's
_MODULE_NAMES = {"EmbeddingLayer": {"core": "embed"},
                 "AttentionPooling": {"fc": "Dense_0"},
                 "CDurBlock": {"bn": "BatchNorm_0", "conv": "Conv_0"}}
# runs of the port's module names (HF's layout) that make one flax name
_SPANS = {
    "TextTower": ((r"embeddings\.(word_embeddings|position_embeddings|"
                   r"token_type_embeddings)", r"\1"),
                  (r"embeddings\.LayerNorm", "embeddings_norm"),
                  (r"encoder\.layer\.(\d+)", r"layer_\1"),
                  (r"pooler\.dense", "pooler")),
    "TransformerLayer": ((r"attention\.self\.(query|key|value)",
                          r"attention/\1"),
                         (r"attention\.output\.dense", "attention/out"),
                         (r"attention\.output\.LayerNorm", "attention_norm"),
                         (r"intermediate\.dense", "intermediate"),
                         (r"output\.dense", "output"),
                         (r"output\.LayerNorm", "output_norm")),
}
_GATES = {"weight_ih": ("ir", "iz", "in"), "weight_hh": ("hr", "hz", "hn"),
          "bias_ih": ("ir", "iz", "in"), "bias_hh": ("hn",)}
_LSTM_GATES = {"weight_ih": (("ii", "if", "ig", "io"), "kernel"),
               "weight_hh": (("hi", "hf", "hg", "ho"), "kernel"),
               "bias_hh": (("hi", "hf", "hg", "ho"), "bias"),
               "bias_ih": ((), "bias")}
_RNN_SIDES = {"weight_ih": ("ih", "kernel"), "bias_ih": ("ih", "bias"),
              "weight_hh": ("hh", "kernel"), "bias_hh": ("hh", "bias")}


def _module_path(model: torch.nn.Module, parts: list) -> tuple:
    """(flax path, module) of the port's module ``parts``."""
    path, module, i = [], model, 0
    while i < len(parts):
        kind = type(module).__name__
        rest = ".".join(parts[i:])
        span = next(((m, repl) for pat, repl in _SPANS.get(kind, ())
                     if (m := re.match(pat + r"(?=\.|$)", rest))), None)
        if span is not None:
            m, repl = span
            path += m.expand(repl).split("/")
            module = module.get_submodule(m.group(0))
            i += m.group(0).count(".") + 1
            continue
        part = parts[i]
        parent, module = module, getattr(module, part)
        if kind == "CrnnEncoder" and part.startswith("block"):
            path.append(f"CDurBlock_{int(part[5:]) - 1}")
        elif kind == "LSTM":
            k = int(part[3:])
            cell = 2 * k + (part[:3] == "bwd") if parent.bidirectional else k
            path.append(f"OptimizedLSTMCell_{cell}")
        else:
            path.append(_MODULE_NAMES.get(kind, {}).get(part, part))
        i += 1
    return path, module


def flax_leaf(model: torch.nn.Module, name: str) -> tuple:
    """``(paths, perm)`` of the port's parameter ``name`` in the JAX
    package's parameter tree, the inverse of :func:`from_jax_variables`'s
    naming: ``paths`` the flax paths (tuples of keys) it comes from (the
    gates of a GRU or LSTM matrix, else one; none for an LSTM's
    ``bias_ih``, which flax's cell lacks), ``perm`` the flax dim of each
    torch dim (``(1, 0)`` where a dense kernel is transposed, ``(3, 2, 0,
    1)`` for a conv kernel), or None where the layouts differ by more than
    a transposition (flax's attention ``DenseGeneral`` kernels, the
    recurrent layers' stacked gates)."""
    parts = name.split(".")
    path, module = _module_path(model, parts[:-1])
    leaf = parts[-1]
    kind = type(module).__name__
    if kind in ("BiGRU", "GRUSeq"):
        base, sfx = leaf.rsplit("_l0", 1)
        cell = (["GRUCell_1" if sfx == "_reverse" else "GRUCell_0"]
                if kind == "BiGRU" else [])
        key = "kernel" if base.startswith("weight") else "bias"
        return ([tuple(path + cell + [gate, key]) for gate in _GATES[base]],
                None)
    if kind == "LSTMSeq":
        gates, key = _LSTM_GATES[leaf[:-3]]
        return [tuple(path + [gate, key]) for gate in gates], None
    if kind == "RNNSeq":
        side, key = _RNN_SIDES[leaf[:-3]]
        return ([tuple(path + [side, key])],
                (1, 0) if key == "kernel" else (0,))
    parent = model.get_submodule(".".join(parts[:-2]))
    if type(parent).__name__ == "DotProductAttention" or path[-2:-1] == [
            "attention"]:
        return [tuple(path + ["kernel" if leaf == "weight" else leaf])], None
    if leaf == "weight" and kind in ("Linear", "Conv2d", "Conv1d"):
        return ([tuple(path + ["kernel"])],
                {"Linear": (1, 0), "Conv2d": (3, 2, 0, 1),
                 "Conv1d": (2, 1, 0)}[kind])
    if leaf == "weight" and kind.startswith(("BatchNorm", "LayerNorm")):
        return [tuple(path + ["scale"])], (0,)
    if leaf == "weight" and kind == "Embedding":
        return [tuple(path + ["embedding"])], (0, 1)
    return [tuple(path + [leaf])], tuple(range(getattr(module, leaf).dim()))


def _get(tree: dict, path: tuple) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return np.asarray(tree, np.float32)


def _flax_value(model: torch.nn.Module, name: str, params: dict,
                shape: tuple) -> np.ndarray:
    paths, perm = flax_leaf(model, name)
    if perm is not None:
        return _get(params, paths[0]).transpose(perm)
    leaf = name.rsplit(".", 1)[-1]
    if not paths:                                 # an LSTM's bias_ih
        return np.zeros(shape, np.float32)
    parts = [_get(params, p) for p in paths]
    if "_l0" in leaf:                             # stacked recurrent gates
        if leaf.startswith("weight"):
            return np.concatenate([p.T for p in parts])
        if leaf.startswith("bias_hh") and len(parts) == 1:   # GRU: hn only
            return np.concatenate([np.zeros(2 * parts[0].shape[0],
                                            np.float32), parts[0]])
        return np.concatenate(parts)
    value = parts[0]                              # flax DenseGeneral
    if leaf == "weight" and paths[0][-2] == "out":
        return value.reshape(-1, value.shape[-1]).T
    if leaf == "weight":
        return value.reshape(value.shape[0], -1).T
    return value.reshape(-1)


def random_state_dict(model: torch.nn.Module, seed: int = 0) -> dict:
    """Random weights for every entry of ``model``'s state dict, made with
    numpy from ``seed``: xavier-uniform convs and dense layers,
    1/sqrt(fan-in) GRU weights (r/z recurrent biases zero, as in the JAX
    parameter tree), BatchNorm and (HF-named) LayerNorm affines near
    identity, and the running
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
        elif (".bn" in name or "LayerNorm" in name) and name.endswith(
                "weight"):
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
