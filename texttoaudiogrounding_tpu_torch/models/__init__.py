from texttoaudiogrounding_tpu_torch.models.audio_encoder import (
    Cnn8Rnn,
    CrnnEncoder,
)
from texttoaudiogrounding_tpu_torch.models.audio_text_model import (
    BiEncoder,
    MultiTextBiEncoder,
    flagship_model,
)
from texttoaudiogrounding_tpu_torch.models.match import DotProduct, ExpNegL2
from texttoaudiogrounding_tpu_torch.models.text_encoder import EmbeddingAgg

__all__ = ["BiEncoder", "Cnn8Rnn", "CrnnEncoder", "DotProduct",
           "EmbeddingAgg", "ExpNegL2", "MultiTextBiEncoder", "flagship_model"]
