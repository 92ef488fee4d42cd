from texttoaudiogrounding_tpu_torch.ops.masking import (
    generate_length_mask,
    sum_with_lens,
    mean_with_lens,
    max_with_lens,
    linear_softmax_with_lens,
    exp_softmax_with_lens,
    mean_by_group,
)
from texttoaudiogrounding_tpu_torch.ops.frontend import (
    LogMelConfig,
    log_mel_spectrogram,
    mel_filterbank,
    num_frames,
)

__all__ = [
    "generate_length_mask",
    "sum_with_lens",
    "mean_with_lens",
    "max_with_lens",
    "linear_softmax_with_lens",
    "exp_softmax_with_lens",
    "mean_by_group",
    "LogMelConfig",
    "log_mel_spectrogram",
    "mel_filterbank",
    "num_frames",
]
