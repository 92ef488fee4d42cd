"""Phrase / label embedding extraction + word2vec matrix building.

Reference: utils/data/create_text_embedding/prepare_phrase_clap.py (CLAP
text tower → {phrase: emb} pickle), prepare_phrase_sbert.py, and
utils/word2vec/load_pretrained.py (GoogleNews word2vec → per-vocab-word
embedding matrix ``.npy`` consumed by EmbeddingLayer).

gensim is not needed: the word2vec binary format is read directly (a
simple header + packed float32 records).

The port of ``texttoaudiogrounding_tpu/tools/embeddings.py``: the
word2vec reader and the embedding-matrix function are copies; the phrase
embeddings come from the port's text towers, on the card unless
``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np


def read_word2vec_binary(path: str, restrict_vocab: set | None = None
                         ) -> dict[str, np.ndarray]:
    """Read a word2vec .bin file (GoogleNews format) into {word: vec}."""
    vectors: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8")
        vocab_size, dim = map(int, header.split())
        record = np.dtype(np.float32).itemsize * dim
        for _ in range(vocab_size):
            chars = []
            while True:
                ch = f.read(1)
                if ch == b" ":
                    break
                if ch != b"\n":
                    chars.append(ch)
            word = b"".join(chars).decode("utf-8", errors="replace")
            vec = np.frombuffer(f.read(record), dtype=np.float32)
            if restrict_vocab is None or word in restrict_vocab:
                vectors[word] = vec
    return vectors


_ALPHABET = "abcdefghijklmnopqrstuvwxyz"


def lemma_candidates(word: str) -> list[str]:
    """Rule-based English lemma candidates (suffix stripping), most
    specific first.

    Stands in for the reference's spacy lemmatizer (utils/word2vec/
    load_pretrained.py:23-152 — spacy is absent here); covers the
    regular inflections that dominate caption vocabulary: plurals,
    -ing/-ed (with consonant-doubling and silent-e restoration), -er/-est.
    """
    w = word
    out = []
    if w.endswith("ies") and len(w) > 4:
        out.append(w[:-3] + "y")
    if w.endswith("es") and len(w) > 3:
        out += [w[:-2], w[:-1]]
    elif w.endswith("s") and len(w) > 3 and not w.endswith("ss"):
        out.append(w[:-1])
    for suf in ("ing", "ed", "er", "est"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            stem = w[: -len(suf)]
            out += [stem, stem + "e"]
            if len(stem) > 2 and stem[-1] == stem[-2]:
                out.append(stem[:-1])          # running -> run
    seen, uniq = set(), []
    for c in out:
        if c not in seen and c != word:
            seen.add(c)
            uniq.append(c)
    return uniq


def edit1_candidates(word: str) -> list[str]:
    """All strings at edit distance 1 (the symspell-style spell fallback;
    reference uses symspellpy, absent here)."""
    splits = [(word[:i], word[i:]) for i in range(len(word) + 1)]
    deletes = [a + b[1:] for a, b in splits if b]
    transposes = [a + b[1] + b[0] + b[2:] for a, b in splits if len(b) > 1]
    replaces = [a + ch + b[1:] for a, b in splits if b for ch in _ALPHABET]
    inserts = [a + ch + b for a, b in splits for ch in _ALPHABET]
    return list(dict.fromkeys(deletes + transposes + replaces + inserts))


def build_vocab_embedding_matrix(vocab_path: str, word2vec_bin: str,
                                 output: str,
                                 embed_dim: int | None = None,
                                 seed: int = 0) -> np.ndarray:
    """vocab pickle + word2vec .bin → ``[V, D]`` embedding matrix ``.npy``.

    OOV resolution order mirrors the reference pipeline (utils/word2vec/
    load_pretrained.py:23-152): exact → lowercase → rule-based lemma →
    edit-distance-1 spell fix; words that still miss get the mean of the
    loaded word2vec vectors (the reference's "unknown vector").
    """
    from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary
    vocab = Vocabulary.load(vocab_path)
    words = [vocab.idx2word[i] for i in range(len(vocab))]

    # candidate set per word, generated up front so one .bin pass suffices
    cand_lists: dict[str, list[str]] = {}
    restrict: set[str] = set()
    for word in words:
        lo = word.lower()
        cands = [word, lo] + lemma_candidates(lo) + edit1_candidates(lo)
        cand_lists[word] = cands
        restrict.update(cands)
    vectors = read_word2vec_binary(word2vec_bin, restrict_vocab=restrict)

    dim = embed_dim or (len(next(iter(vectors.values())))
                        if vectors else 300)
    rng = np.random.default_rng(seed)
    unknown = (np.mean([v for v in vectors.values() if len(v) == dim],
                       axis=0)
               if vectors else rng.normal(scale=0.1, size=dim))
    matrix = np.zeros((len(words), dim), np.float32)
    hits = {"exact": 0, "lemma": 0, "spellfix": 0, "unknown": 0}
    for i, word in enumerate(words):
        cands = cand_lists[word]
        vec, kind = None, "unknown"
        for j, c in enumerate(cands):
            v = vectors.get(c)
            if v is not None and len(v) == dim:
                vec = v
                n_lemma = 2 + len(lemma_candidates(word.lower()))
                kind = ("exact" if j < 2
                        else "lemma" if j < n_lemma else "spellfix")
                break
        matrix[i] = vec if vec is not None else unknown
        hits[kind] += 1
    np.save(output, matrix)
    print(f"embedding matrix [{len(words)}, {dim}] → {output}; "
          + ", ".join(f"{k}: {v}" for k, v in hits.items()))
    return matrix


def _collect_phrases(label_files: list[str]) -> list[str]:
    phrases = set()
    for path in label_files:
        with open(path) as f:
            for item in json.load(f):
                for phrase in item["phrases"]:
                    phrases.add(phrase if isinstance(phrase, str)
                                else phrase["phrase"])
    return sorted(phrases)


def hash_tokenize(batch: list[str]) -> dict:
    """The stand-in tokenizer of a tower without tokenizer files: each word
    an id in [1, 9999] by its hash, at most 16 a phrase, padded with 0."""
    ids = [[hash(w) % 9999 + 1 for w in p.split()][:16] or [1]
           for p in batch]
    max_len = max(len(x) for x in ids)
    input_ids = np.zeros((len(ids), max_len), np.int32)
    mask = np.zeros((len(ids), max_len), np.int32)
    for i, x in enumerate(ids):
        input_ids[i, :len(x)] = x
        mask[i, :len(x)] = 1
    return {"input_ids": input_ids, "attention_mask": mask}


def encode_phrases(model, tokenize, phrases: list[str],
                   batch_size: int = 64) -> dict:
    """{phrase: ``seq_emb``} of a port text encoder ``model`` in eval mode,
    ``batch_size`` phrases a call, each batch tokenized by ``tokenize``
    (phrases → arrays of token ids and masks) onto the model's device: the
    encode loop of :func:`extract_phrase_embeddings`."""
    import torch

    dev = next(model.parameters()).device
    model.eval()
    phrase_to_emb = {}
    with torch.no_grad():
        for start in range(0, len(phrases), batch_size):
            batch = phrases[start:start + batch_size]
            tokens = {k: torch.from_numpy(np.asarray(v, np.int64)).to(dev)
                      for k, v in tokenize(batch).items()}
            embs = model(tokens)["seq_emb"].float().cpu().numpy()
            for phrase, emb in zip(batch, embs):
                phrase_to_emb[phrase] = emb
    return phrase_to_emb


def extract_phrase_embeddings(label_files: list[str], output: str,
                              encoder: str = "clap",
                              checkpoint: str | None = None,
                              tokenizer_name: str | None = None,
                              batch_size: int = 64, device="cuda") -> dict:
    """Encode every phrase with a text tower → {phrase: emb} pickle (and
    the dict returned).

    ``encoder``: "clap" (``ClapTextEncoder``, projection + L2 norm —
    reference prepare_phrase_clap.py:51-207) or "sbert" (mean pooling —
    reference prepare_phrase_sbert.py).  ``checkpoint``: local HF torch
    checkpoint dir (``config.json``, ``pytorch_model.bin`` and the
    tokenizer's files; needs ``transformers``); without one, a tiny tower
    with random weights from numpy seed 0 and :func:`hash_tokenize`
    (pipeline tests only).  Runs on ``device``: the card unless
    ``"cpu"``."""
    import torch

    from texttoaudiogrounding_tpu_torch.device import resolve_device
    from texttoaudiogrounding_tpu_torch.models.pretrained_text import (
        ClapTextEncoder,
        SentenceBert,
        config_from_hf,
        import_clap_text_params,
        import_hf_bert_params,
        tiny_text_tower_config,
    )
    from texttoaudiogrounding_tpu_torch.weights import random_state_dict

    dev = resolve_device(device)
    phrases = _collect_phrases(label_files)
    tokenize = hash_tokenize
    if checkpoint is not None:
        from transformers import AutoConfig, AutoTokenizer
        hf_cfg = AutoConfig.from_pretrained(checkpoint)
        text_cfg = config_from_hf(getattr(hf_cfg, "text_config", hf_cfg))
        tok = AutoTokenizer.from_pretrained(tokenizer_name or checkpoint)
        state = torch.load(Path(checkpoint) / "pytorch_model.bin",
                           map_location="cpu")
        if encoder == "clap":
            model = ClapTextEncoder(text_cfg, device=None)
            model.load_state_dict(import_clap_text_params(state, text_cfg))
        else:
            model = SentenceBert(text_cfg, device=None)
            model.tower.load_state_dict(import_hf_bert_params(state,
                                                              text_cfg))

        def tokenize(batch):
            out = tok(batch, padding=True, truncation=True,
                      return_tensors="np")
            return {k: np.asarray(v) for k, v in out.items()}
    else:
        text_cfg = tiny_text_tower_config(vocab_size=10000)
        model = (ClapTextEncoder(text_cfg, device=None) if encoder == "clap"
                 else SentenceBert(text_cfg, device=None))
        model.load_state_dict(random_state_dict(model, seed=0))
    phrase_to_emb = encode_phrases(model.to(dev), tokenize, phrases,
                                   batch_size)
    with open(output, "wb") as f:
        pickle.dump(phrase_to_emb, f)
    print(f"wrote {len(phrase_to_emb)} phrase embeddings to {output}")
    return phrase_to_emb


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("w2v_matrix")
    p.add_argument("vocab")
    p.add_argument("word2vec_bin")
    p.add_argument("output")
    p = sub.add_parser("phrase_emb")
    p.add_argument("labels", nargs="+")
    p.add_argument("--output", required=True)
    p.add_argument("--encoder", default="clap", choices=["clap", "sbert"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.cmd == "w2v_matrix":
        build_vocab_embedding_matrix(args.vocab, args.word2vec_bin,
                                     args.output)
    elif args.cmd == "phrase_emb":
        extract_phrase_embeddings(args.labels, args.output, args.encoder,
                                  args.checkpoint, args.tokenizer,
                                  device=args.device)


if __name__ == "__main__":
    main()
