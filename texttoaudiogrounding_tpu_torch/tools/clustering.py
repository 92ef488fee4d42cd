"""Phrase-embedding clustering → cluster artifacts for WSTAG sampling.

Reference: python_scripts/clustering/{kmeans,spectral,dbscan,agc}_emb.py —
KMeans produces a joblib model + cluster→phrases JSON (consumed by
clustering-based negative sampling and KmeansMapping datasets); spectral /
DBSCAN / agglomerative produce cluster→phrases JSONs.

A copy of ``texttoaudiogrounding_tpu/tools/clustering.py``.
"""

from __future__ import annotations

import argparse
import json
import pickle
from collections import defaultdict
from pathlib import Path

import numpy as np


def _load_embeddings(phrase_embed: str):
    with open(phrase_embed, "rb") as f:
        phrase_to_emb = pickle.load(f)
    phrases = sorted(phrase_to_emb)
    embs = np.stack([phrase_to_emb[p] for p in phrases])
    return phrases, embs


def _dump_cluster_map(phrases, labels, output: str) -> None:
    cluster_to_phrases = defaultdict(list)
    for phrase, label in zip(phrases, labels):
        if int(label) >= 0:  # DBSCAN noise (-1) excluded
            cluster_to_phrases[int(label)].append(phrase)
    with open(output, "w") as f:
        json.dump({str(k): v for k, v in sorted(cluster_to_phrases.items())},
                  f)
    print(f"{len(cluster_to_phrases)} clusters → {output}")


def kmeans(phrase_embed: str, output_dir: str, n_clusters: int = 32,
           seed: int = 0) -> None:
    import joblib
    from sklearn.cluster import KMeans

    phrases, embs = _load_embeddings(phrase_embed)
    model = KMeans(n_clusters=n_clusters, random_state=seed,
                   n_init=10).fit(embs)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    score = -model.score(embs)
    joblib.dump(model, out / f"{n_clusters}_model.joblib")
    _dump_cluster_map(phrases, model.labels_,
                      str(out / f"{n_clusters}_score={score:.0f}.json"))


def spectral(phrase_embed: str, output: str, n_clusters: int = 32,
             seed: int = 0) -> None:
    from sklearn.cluster import SpectralClustering

    phrases, embs = _load_embeddings(phrase_embed)
    labels = SpectralClustering(n_clusters=n_clusters, random_state=seed,
                                affinity="nearest_neighbors").fit_predict(
                                    embs)
    _dump_cluster_map(phrases, labels, output)


def dbscan(phrase_embed: str, output: str, eps: float = 0.5,
           min_samples: int = 5) -> None:
    from sklearn.cluster import DBSCAN

    phrases, embs = _load_embeddings(phrase_embed)
    labels = DBSCAN(eps=eps, min_samples=min_samples,
                    metric="cosine").fit_predict(embs)
    _dump_cluster_map(phrases, labels, output)


def agglomerative(phrase_embed: str, output: str,
                  n_clusters: int = 32) -> None:
    from sklearn.cluster import AgglomerativeClustering

    phrases, embs = _load_embeddings(phrase_embed)
    labels = AgglomerativeClustering(
        n_clusters=n_clusters).fit_predict(embs)
    _dump_cluster_map(phrases, labels, output)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("kmeans")
    p.add_argument("phrase_embed")
    p.add_argument("output_dir")
    p.add_argument("--n_clusters", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    for name in ("spectral", "dbscan", "agglomerative"):
        p = sub.add_parser(name)
        p.add_argument("phrase_embed")
        p.add_argument("output")
        if name == "dbscan":
            p.add_argument("--eps", type=float, default=0.5)
            p.add_argument("--min_samples", type=int, default=5)
        else:
            p.add_argument("--n_clusters", type=int, default=32)
    args = ap.parse_args()
    if args.cmd == "kmeans":
        kmeans(args.phrase_embed, args.output_dir, args.n_clusters,
               args.seed)
    elif args.cmd == "spectral":
        spectral(args.phrase_embed, args.output, args.n_clusters)
    elif args.cmd == "dbscan":
        dbscan(args.phrase_embed, args.output, args.eps, args.min_samples)
    elif args.cmd == "agglomerative":
        agglomerative(args.phrase_embed, args.output, args.n_clusters)


if __name__ == "__main__":
    main()
