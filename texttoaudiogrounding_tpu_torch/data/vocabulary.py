"""Word vocabulary with ``<pad>``/``<unk>``, pickle-compatible with the
reference (utils/build_vocab.py:7-68): the pickled state dict is the plain
``word2idx`` mapping, so vocabulary files of either package drop in
unchanged.  A copy of ``texttoaudiogrounding_tpu/data/vocabulary.py``."""

from __future__ import annotations

import pickle
from pathlib import Path


class Vocabulary:
    def __init__(self):
        self.word2idx: dict[str, int] = {}
        self.idx2word: dict[int, str] = {}
        self.idx = 0

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def __call__(self, word: str) -> int:
        return self.word2idx.get(word, self.word2idx["<unk>"])

    def __len__(self) -> int:
        return len(self.word2idx)

    def state_dict(self) -> dict:
        return self.word2idx

    def load_state_dict(self, state_dict: dict) -> None:
        self.word2idx = state_dict
        self.idx2word = {idx: word for word, idx in state_dict.items()}
        self.idx = len(state_dict)

    @classmethod
    def load(cls, path: str | Path) -> "Vocabulary":
        vocab = cls()
        with open(path, "rb") as f:
            vocab.load_state_dict(pickle.load(f))
        return vocab

    def save(self, path: str | Path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.state_dict(), f)
