"""Vocabulary-lookup tokenizer: ``List[str]`` / ``List[List[str]]`` →
padded id arrays (NumPy, host side).  A copy of ``DictTokenizer`` from
``texttoaudiogrounding_tpu/data/tokenizer.py`` (reference
datasets/text_tokenizer.py:9-58)."""

from __future__ import annotations

import numpy as np

from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary


def _pad_2d(seqs: list[np.ndarray], pad_value=0,
            min_len: int = 1) -> tuple[np.ndarray, np.ndarray]:
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    max_len = max(int(lens.max()) if len(lens) else 1, min_len)
    out = np.full((len(seqs), max_len), pad_value,
                  dtype=seqs[0].dtype if len(seqs) else np.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out, lens


class DictTokenizer:
    """``List[str]`` → ``{"text": [B, L], "text_len": [B]}``;
    ``List[List[str]]`` (equal N per sample) → ``[B, N, L]`` / ``[B, N]``.
    """

    def __init__(self, vocabulary: "str | Vocabulary"):
        if isinstance(vocabulary, Vocabulary):
            self.vocabulary = vocabulary
        else:
            self.vocabulary = Vocabulary.load(vocabulary)

    def _encode(self, text: str) -> np.ndarray:
        ids = [self.vocabulary(token) for token in text.split()]
        return np.array(ids if ids else [self.vocabulary("<unk>")],
                        dtype=np.int64)

    def __call__(self, texts) -> dict:
        if not isinstance(texts, list):
            raise TypeError("input must be List[str] or List[List[str]]")
        if isinstance(texts[0], str):
            tokens, lens = _pad_2d([self._encode(t) for t in texts])
            return {"text": tokens, "text_len": lens}
        text_num = len(texts[0])
        for tl in texts:
            if len(tl) != text_num:
                raise ValueError("each sample must have the same text number")
        flat = [t for tl in texts for t in tl]
        tokens, lens = _pad_2d([self._encode(t) for t in flat])
        return {
            "text": tokens.reshape(len(texts), text_num, -1),
            "text_len": lens.reshape(len(texts), text_num),
        }

    def inverse_transform(self, texts) -> list[str]:
        output = []
        for text in texts:
            words = []
            for idx in text:
                if int(idx) == 0:
                    break
                words.append(self.vocabulary.idx2word[int(idx)])
            output.append(" ".join(words))
        return output


class HuggingFaceTokenizer:
    """HF ``AutoTokenizer`` wrapper, a copy of the JAX one
    (``texttoaudiogrounding_tpu/data/tokenizer.py:74-107``, reference
    datasets/text_tokenizer.py:61-96): ``input_ids`` / ``attention_mask``
    (and ``token_type_ids`` where the tokenizer gives them) as NumPy, plus
    ``text_len`` from the attention mask; ``List[List[str]]`` (equal N a
    sample) → ``[B, N, L]``.  The tokenizer files must be on disk;
    ``transformers`` is imported when one is built."""

    def __init__(self, model_name: str = "laion/clap-htsat-fused"):
        from transformers import AutoTokenizer
        self.core = AutoTokenizer.from_pretrained(model_name)

    def __call__(self, texts) -> dict:
        if not isinstance(texts, list):
            raise TypeError("input must be List[str] or List[List[str]]")
        nested = isinstance(texts[0], list)
        if nested:
            text_num = len(texts[0])
            for tl in texts:
                if len(tl) != text_num:
                    raise ValueError(
                        "each sample must have the same text number")
            flat = [t for tl in texts for t in tl]
        else:
            flat = texts
        token_dict = self.core(flat, padding=True, truncation=True,
                               return_tensors="np")
        out = {k: np.asarray(v) for k, v in token_dict.items()}
        if nested:
            out = {k: v.reshape(len(texts), text_num, *v.shape[1:])
                   for k, v in out.items()}
        out["text_len"] = out["attention_mask"].sum(axis=-1)
        return out
