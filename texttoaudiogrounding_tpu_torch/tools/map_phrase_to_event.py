"""Phrase → AudioSet event-label mapping by embedding similarity.

Reference: utils/data/map_phrase_to_event.py + create_phrase_event_mapping/
(cosine similarity of phrase embeddings to class-label embeddings).
The bertscore/bleurt mapping backends of the reference's
prepare_phrase_bertscore.py / prepare_phrase_bleurt.py live in
:mod:`texttoaudiogrounding_tpu_torch.tools.score_backends` (native greedy
token-cosine matching / BLEURT-head scoring over the port's text tower,
same TSV output contract); only their pretrained weights are external.

A copy of ``texttoaudiogrounding_tpu/tools/map_phrase_to_event.py``.
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np


def map_phrases(phrase_embed: str, label_embed: str, output: str,
                topk: int = 1, threshold: float | None = None) -> None:
    with open(phrase_embed, "rb") as f:
        phrase_to_emb = pickle.load(f)
    with open(label_embed, "rb") as f:
        label_to_emb = pickle.load(f)
    labels = sorted(label_to_emb)
    lab = np.stack([label_to_emb[name] for name in labels])
    lab = lab / np.maximum(np.linalg.norm(lab, axis=-1, keepdims=True),
                           1e-12)
    mapping = {}
    for phrase, emb in phrase_to_emb.items():
        v = emb / max(np.linalg.norm(emb), 1e-12)
        sims = lab @ v
        order = np.argsort(sims)[::-1][:topk]
        chosen = [(labels[i], float(sims[i])) for i in order
                  if threshold is None or sims[i] >= threshold]
        mapping[phrase] = chosen
    with open(output, "w") as f:
        json.dump(mapping, f)
    print(f"mapped {len(mapping)} phrases → {output}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("phrase_embed")
    ap.add_argument("label_embed")
    ap.add_argument("output")
    ap.add_argument("--topk", type=int, default=1)
    ap.add_argument("--threshold", type=float, default=None)
    args = ap.parse_args()
    map_phrases(args.phrase_embed, args.label_embed, args.output,
                args.topk, args.threshold)


if __name__ == "__main__":
    main()
