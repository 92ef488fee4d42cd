"""Word vocabulary with ``<pad>``/``<unk>``, pickle-compatible with the
reference (utils/build_vocab.py:7-68): the pickled state dict is the plain
``word2idx`` mapping, so vocabulary files of either package drop in
unchanged.  A copy of ``texttoaudiogrounding_tpu/data/vocabulary.py``,
its builder and command line included:

    python -m texttoaudiogrounding_tpu_torch.data.vocabulary LABEL.json \
        [LABEL.json ...] OUTPUT.pkl
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Iterable


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


def build_vocab(items: Iterable[dict], output: str | Path | None = None
                ) -> Vocabulary:
    """A vocabulary of ``<pad>``, ``<unk>`` and every whitespace token of
    the items' ``tokens`` (or, without it, ``caption``) in order of first
    use, saved to ``output`` where given (reference
    utils/build_vocab.py:37-55)."""
    vocab = Vocabulary()
    vocab.add_word("<pad>")
    vocab.add_word("<unk>")
    for item in items:
        text = item["tokens"] if "tokens" in item else item["caption"]
        for token in text.split():
            vocab.add_word(token)
    if output is not None:
        vocab.save(output)
    return vocab


def build_vocab_from_files(label_files: list[str],
                           output: str | Path) -> Vocabulary:
    """:func:`build_vocab` over the items of the label JSON files, in
    order."""
    data = []
    for label in label_files:
        with open(label) as f:
            data.extend(json.load(f))
    return build_vocab(data, output)


def main(argv: list[str] | None = None) -> None:
    """The command line of reference utils/build_vocab.py:58-68."""
    import argparse
    ap = argparse.ArgumentParser(
        description="Build a vocabulary pickle from label JSONs")
    ap.add_argument("labels", nargs="+")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    vocab = build_vocab_from_files(args.labels, args.output)
    print(f"Total vocabulary size: {len(vocab)}")
    print(f"Saved vocab to '{args.output}'")


if __name__ == "__main__":
    main()
