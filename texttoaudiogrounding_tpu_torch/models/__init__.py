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
from texttoaudiogrounding_tpu_torch.models.cross_models import (
    CrossCDur,
    CrossCnn8Rnn,
)
from texttoaudiogrounding_tpu_torch.models.hf_api import (
    cnn8rnn_laionclap_grounding_model,
)
from texttoaudiogrounding_tpu_torch.models.pretrained_text import (
    Bert,
    ClapTextEncoder,
    SentenceBert,
)
from texttoaudiogrounding_tpu_torch.models.retrieval import (
    AudioSingleTextClip,
    AudioTextClip,
    Cnn14,
)
from texttoaudiogrounding_tpu_torch.models.retrieval_towers import (
    AudioSpectrogramTransformer,
    ResNet38,
    WavegramLogmelCnn14,
)
from texttoaudiogrounding_tpu_torch.models.text_encoder import (
    EmbeddingAgg,
    IntraAttention,
    RnnEncoder,
    SelfAttention,
)

__all__ = ["AlignDotProduct", "AlignExpNegL2", "AudioSingleTextClip",
           "AudioSpectrogramTransformer", "AudioTagging",
           "AudioTextAlignByPhrase", "AudioTextAlignByWord", "AudioTextClip",
           "AudioTextCrossAlignByPhrase", "Bert", "BiEncoder",
           "ClapTextEncoder", "Cnn14", "Cnn8Rnn", "CrnnEncoder",
           "CrossAttention", "CrossAttentionGating", "CrossCDur",
           "CrossCnn8Rnn", "DotProduct", "EmbeddingAgg", "ExpNegL2",
           "IntraAttention", "MultiTextBiEncoder",
           "MultiTextBiEncoderWithAlign", "ResNet38", "RnnEncoder",
           "SelfAttention", "SentenceBert", "WavegramLogmelCnn14",
           "cnn8rnn_laionclap_grounding_model", "flagship_model"]
