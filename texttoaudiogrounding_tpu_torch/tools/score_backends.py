"""BERTScore / BLEURT phrase→event scoring backends.

Reference:
utils/data/create_phrase_event_mapping/prepare_phrase_bertscore.py:1-58
(bert_score F1 of every phrase against every AudioSet label, best label
per phrase → TSV ``phrase\tindex\tsim``) and prepare_phrase_bleurt.py
(the same procedure with BLEURT checkpoint scoring).

This module implements the *scoring mechanics* natively so the backends
are selectable even though the pretrained weights are not in the
repository:

* **BERTScore** (Zhang et al., ICLR 2020) = token-level greedy cosine
  matching over contextual embeddings: ``P = mean_i max_j sim(c_i,
  r_j)``, ``R = mean_j max_i sim``, ``F1 = 2PR/(P+R)`` (no IDF
  weighting, no baseline rescaling — the reference calls
  ``bert_score.score`` with defaults, which disables both).
* **BLEURT** = a fine-tuned BERT regression: encode
  ``[CLS] ref [SEP] cand [SEP]``, score = ``dense(1)`` on the [CLS]
  vector.

Both run over the port's :class:`TextTower` (models/pretrained_text.py),
on the card unless ``device="cpu"``; real weights load through
``import_hf_bert_params`` when a checkpoint is available.  The port of
``texttoaudiogrounding_tpu/tools/score_backends.py``: the scoring
mechanics are copies.
"""

from __future__ import annotations

import json
import pickle
from typing import Callable, Sequence

import numpy as np


def greedy_bertscore(cand_emb: np.ndarray, cand_mask: np.ndarray,
                     ref_emb: np.ndarray, ref_mask: np.ndarray):
    """Greedy-matching BERTScore for one (candidate, reference) pair.

    ``*_emb``: [L, D] token embeddings; ``*_mask``: [L] bool with
    special tokens ([CLS]/[SEP]/pad) already False (bert_score strips
    them before matching).  Returns (P, R, F1).
    """
    c = cand_emb[np.asarray(cand_mask, bool)]
    r = ref_emb[np.asarray(ref_mask, bool)]
    if len(c) == 0 or len(r) == 0:
        return 0.0, 0.0, 0.0
    c = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-12)
    r = r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-12)
    sim = c @ r.T
    p = float(sim.max(axis=1).mean())
    rr = float(sim.max(axis=0).mean())
    f1 = 0.0 if p + rr == 0 else 2 * p * rr / (p + rr)
    return p, rr, f1


def bertscore_matrix(phrases: Sequence[str], labels: Sequence[str],
                     encode_fn: Callable, batch_size: int = 64
                     ) -> np.ndarray:
    """F1 of every phrase against every label: ``[n_phrases, n_labels]``.

    ``encode_fn(texts) -> (token_emb [N, L, D], match_mask [N, L])``
    where ``match_mask`` is True on content tokens only.  Labels are
    encoded once; phrases in batches.
    """
    l_emb, l_mask = encode_fn(list(labels))
    out = np.zeros((len(phrases), len(labels)), np.float32)
    for s in range(0, len(phrases), batch_size):
        chunk = list(phrases[s:s + batch_size])
        p_emb, p_mask = encode_fn(chunk)
        for i in range(len(chunk)):
            for j in range(len(labels)):
                out[s + i, j] = greedy_bertscore(
                    p_emb[i], p_mask[i], l_emb[j], l_mask[j])[2]
    return out


def bleurt_matrix(phrases: Sequence[str], labels: Sequence[str],
                  score_fn: Callable, batch_size: int = 64) -> np.ndarray:
    """BLEURT score of every (label=reference, phrase=candidate) pair.

    ``score_fn(references, candidates) -> [N] scores`` (the BLEURT
    convention: reference first — reference prepare_phrase_bleurt.py:37).
    """
    out = np.zeros((len(phrases), len(labels)), np.float32)
    for s in range(0, len(phrases), batch_size):
        chunk = list(phrases[s:s + batch_size])
        cands, refs = [], []
        for phrase in chunk:
            cands += [phrase] * len(labels)
            refs += list(labels)
        scores = np.asarray(score_fn(refs, cands), np.float32)
        out[s:s + len(chunk)] = scores.reshape(len(chunk), len(labels))
    return out


# --------------------------------------------------------------------------
# Tower-backed encoders
# --------------------------------------------------------------------------


def _tower(cfg, state_dict, seed: int, device):
    """A :class:`TextTower` of ``cfg`` (tiny by default) on ``device``, its
    weights ``state_dict`` or random from numpy ``seed``."""
    from texttoaudiogrounding_tpu_torch.models.pretrained_text import (
        TextTower,
        tiny_text_tower_config,
    )
    from texttoaudiogrounding_tpu_torch.weights import random_state_dict

    cfg = cfg or tiny_text_tower_config(vocab_size=512)
    tower = TextTower(cfg, device=device)
    tower.load_state_dict(state_dict if state_dict is not None
                          else random_state_dict(tower, seed=seed))
    return cfg, tower


def _hidden(tower, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
    import torch
    dev = next(tower.parameters()).device
    with torch.no_grad():
        hidden, _ = tower(torch.from_numpy(np.asarray(ids, np.int64)).to(dev),
                          torch.from_numpy(np.asarray(mask)).to(dev))
    return hidden.cpu().numpy()


def make_tower_encoder(cfg=None, state_dict=None, tokenizer=None,
                       seed: int = 0, max_length: int = 32,
                       device="cuda") -> Callable:
    """Build ``encode_fn`` over the port's :class:`TextTower`.

    Without weights (``state_dict=None``) the tower is random — enough for
    the scoring *mechanics*; real use imports HF weights via
    :func:`models.pretrained_text.import_hf_bert_params`.  Without a HF
    tokenizer a whitespace vocabulary is built on the fly."""
    cfg, tower = _tower(cfg, state_dict, seed, device)
    vocab: dict = {}

    def simple_tokenize(texts):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), bool)
        content = np.zeros((len(texts), max_length), bool)
        for i, text in enumerate(texts):
            words = text.lower().split()[:max_length - 2]
            row = [1]  # [CLS]=1
            for w in words:
                if w not in vocab:
                    vocab[w] = 3 + (len(vocab) % (cfg.vocab_size - 3))
                row.append(vocab[w])
            row.append(2)  # [SEP]=2
            ids[i, :len(row)] = row
            mask[i, :len(row)] = True
            content[i, 1:len(row) - 1] = True
        return ids, mask, content

    def encode(texts):
        if tokenizer is not None:
            enc = tokenizer(list(texts), padding=True, truncation=True,
                            max_length=max_length, return_tensors="np")
            ids = enc["input_ids"]
            mask = enc["attention_mask"].astype(bool)
            special = np.isin(ids, [getattr(tokenizer, a) for a in
                                    ("cls_token_id", "sep_token_id",
                                     "pad_token_id")
                                    if getattr(tokenizer, a) is not None])
            content = mask & ~special
        else:
            ids, mask, content = simple_tokenize(texts)
        return _hidden(tower, ids, mask), content

    return encode


def make_tower_bleurt(cfg=None, state_dict=None, head: tuple | None = None,
                      seed: int = 0, max_length: int = 48,
                      device="cuda") -> Callable:
    """Build a BLEURT-style ``score_fn``: [CLS] ref [SEP] cand [SEP] →
    TextTower → dense(1) on the [CLS] hidden state.

    ``head = (w [H], b scalar)``; random from numpy ``seed`` when absent
    (mechanics only — the fine-tuned BLEURT weights are an external
    checkpoint)."""
    cfg, tower = _tower(cfg, state_dict, seed, device)
    if head is None:
        rng = np.random.default_rng(seed)
        head = (rng.normal(size=cfg.hidden_size).astype(np.float32)
                / np.sqrt(cfg.hidden_size), 0.0)
    hw, hb = head

    vocab: dict = {}

    def tokenize_pair(ref, cand):
        row = [1]
        for text in (ref, cand):
            for w in text.lower().split():
                if w not in vocab:
                    vocab[w] = 3 + (len(vocab) % (cfg.vocab_size - 3))
                row.append(vocab[w])
            row.append(2)
        return row[:max_length]

    def score(references, candidates):
        rows = [tokenize_pair(r, c) for r, c in zip(references,
                                                    candidates)]
        ln = max(len(r) for r in rows)
        ids = np.zeros((len(rows), ln), np.int64)
        mask = np.zeros((len(rows), ln), bool)
        for i, row in enumerate(rows):
            ids[i, :len(row)] = row
            mask[i, :len(row)] = True
        cls = _hidden(tower, ids, mask)[:, 0]
        return cls @ np.asarray(hw) + hb

    return score


# --------------------------------------------------------------------------
# command-line entry points after the reference prepare_phrase_* scripts
# --------------------------------------------------------------------------


def _collect_phrases(label_json: str) -> list:
    data = json.load(open(label_json))
    phrases = []
    for audio_item in data:
        for phrase_item in audio_item["phrases"]:
            phrases.append(phrase_item["phrase"])
    return sorted(set(phrases))


def _load_labels(label_encoder: str) -> list:
    """Event-label list from a pickled sklearn LabelEncoder (reference
    format) or a JSON list."""
    if label_encoder.endswith(".json"):
        return list(json.load(open(label_encoder)))
    enc = pickle.load(open(label_encoder, "rb"))
    if hasattr(enc, "classes_"):
        return list(enc.classes_)
    return list(enc)


def prepare_phrase_mapping(input: str, output: str, label_encoder: str,
                           backend: str = "bertscore",
                           batch_size: int = 64, encode_fn=None,
                           score_fn=None, device="cuda") -> None:
    """Phrase → best event label TSV (``phrase\tindex\tsim``), matching
    the reference prepare_phrase_bertscore/bleurt output format; the
    default tower on ``device``."""
    import pandas as pd

    phrases = _collect_phrases(input)
    labels = _load_labels(label_encoder)
    if backend == "bertscore":
        mat = bertscore_matrix(phrases, labels,
                               encode_fn or make_tower_encoder(device=device),
                               batch_size)
    elif backend == "bleurt":
        mat = bleurt_matrix(phrases, labels,
                            score_fn or make_tower_bleurt(device=device),
                            batch_size)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    rows = [{"phrase": p, "index": int(mat[i].argmax()),
             "sim": float(mat[i].max())} for i, p in enumerate(phrases)]
    pd.DataFrame(rows).to_csv(output, sep="\t", index=False)
    print(f"{backend}: mapped {len(phrases)} phrases x {len(labels)} "
          f"labels -> {output}")


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="grounding label JSON")
    ap.add_argument("output", help="output TSV")
    ap.add_argument("label_encoder",
                    help="pickled LabelEncoder or JSON label list")
    ap.add_argument("--backend", default="bertscore",
                    choices=["bertscore", "bleurt"])
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    prepare_phrase_mapping(args.input, args.output, args.label_encoder,
                           args.backend, args.batch_size,
                           device=args.device)


if __name__ == "__main__":
    main()
