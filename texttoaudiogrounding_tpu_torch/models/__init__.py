from texttoaudiogrounding_tpu_torch.models.align import (
    AlignDotProduct,
    AlignExpNegL2,
)
from texttoaudiogrounding_tpu_torch.models.align_models import (
    AudioTextAlignByPhrase,
    AudioTextAlignByWord,
    AudioTextCrossAlignByPhrase,
)
from texttoaudiogrounding_tpu_torch.models.audio_encoder import (
    Cnn8Rnn,
    CrnnEncoder,
)
from texttoaudiogrounding_tpu_torch.models.audio_text_model import (
    AudioTagging,
    BiEncoder,
    MultiTextBiEncoder,
    MultiTextBiEncoderWithAlign,
    flagship_model,
)
from texttoaudiogrounding_tpu_torch.models.cross_encoder import (
    CrossAttentionGating,
)
from texttoaudiogrounding_tpu_torch.models.match import (
    CrossAttention,
    DotProduct,
    ExpNegL2,
)
from texttoaudiogrounding_tpu_torch.models.text_encoder import EmbeddingAgg

__all__ = ["AlignDotProduct", "AlignExpNegL2", "AudioTagging",
           "AudioTextAlignByPhrase",
           "AudioTextAlignByWord", "AudioTextCrossAlignByPhrase", "BiEncoder",
           "Cnn8Rnn", "CrnnEncoder", "CrossAttention", "CrossAttentionGating",
           "DotProduct", "EmbeddingAgg", "ExpNegL2", "MultiTextBiEncoder",
           "MultiTextBiEncoderWithAlign", "flagship_model"]
