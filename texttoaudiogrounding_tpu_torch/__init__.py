"""PyTorch / CUDA port of the text-to-audio grounding system.

The JAX package ``texttoaudiogrounding_tpu`` is the reference; this package
imports none of it (nor JAX).  Its serving path — ``GroundingPredictor`` →
``BiEncoder`` → ``Cnn8Rnn(dtype=torch.bfloat16, conv_mode="int8")`` — runs
four hand-written CUDA kernels for the H100 (``csrc/``), and its
strong-supervision trainer (``training/runner_strong.py:StrongRunner``)
runs the f32 model with the BiGRU recurrence kernels, forward and
backward (``csrc/gru.cu``).  Each kernel has a plain PyTorch version of
the same arithmetic beside it (``ops/kernels/``); the plain versions run
for tensors on the CPU.
"""

from texttoaudiogrounding_tpu_torch.device import resolve_device
from texttoaudiogrounding_tpu_torch.inference import GroundingPredictor
from texttoaudiogrounding_tpu_torch.models import (
    BiEncoder,
    Cnn8Rnn,
    DotProduct,
    EmbeddingAgg,
    flagship_model,
)
from texttoaudiogrounding_tpu_torch.weights import (
    from_jax_variables,
    random_state_dict,
)

__all__ = ["BiEncoder", "Cnn8Rnn", "DotProduct", "EmbeddingAgg",
           "GroundingPredictor", "flagship_model", "from_jax_variables",
           "random_state_dict", "resolve_device"]
