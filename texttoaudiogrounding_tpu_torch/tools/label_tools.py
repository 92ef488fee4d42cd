"""Label JSON manipulation CLIs.

Reference: utils/data/{concat_label, calc_phrase_count,
calc_phrase_sim_count, sample_subset_by_frac, filter_non_trivial_samples,
exclude_overlap_with_test}.py (~300 LoC of small tools).

A copy of ``texttoaudiogrounding_tpu/tools/label_tools.py``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from collections import Counter

import numpy as np


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(data, path):
    with open(path, "w") as f:
        json.dump(data, f)
    print(f"wrote {len(data)} items to {path}")


def concat_label(inputs: list[str], output: str) -> None:
    data = []
    for path in inputs:
        data.extend(_load(path))
    _dump(data, output)


def calc_phrase_count(label: str, output: str) -> None:
    """phrase → occurrence count JSON (for frequency-weighted losses,
    consumed by SamplePhrasesCountDataset)."""
    counter: Counter = Counter()
    for item in _load(label):
        for phrase in item["phrases"]:
            key = phrase if isinstance(phrase, str) else phrase["phrase"]
            counter[key] += 1
    with open(output, "w") as f:
        json.dump(dict(counter), f)
    print(f"wrote {len(counter)} phrase counts to {output}")


def calc_phrase_sim_count(phrase_count: str, embedding: str, output: str,
                          threshold: float = 0.5) -> None:
    """phrase → similarity-weighted count JSON: for each phrase, the sum
    of occurrence counts over all phrases whose embedding cosine
    similarity is >= ``threshold`` (feeds ``ClipBceLossFreqWeight``).

    Reference: utils/data/calc_phrase_sim_count.py.
    """
    import pickle

    import numpy as np

    with open(phrase_count) as f:
        phrase_to_count = json.load(f)
    with open(embedding, "rb") as f:
        phrase_to_emb = pickle.load(f)

    phrases = [p for p in phrase_to_emb if p in phrase_to_count]
    embs = np.stack([np.asarray(phrase_to_emb[p], np.float32)
                     for p in phrases])
    cnts = np.array([phrase_to_count[p] for p in phrases], np.int64)
    norm = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True),
                             1e-12)
    sims = norm @ norm.T                       # [P, P] cosine
    sim_count = {p: int(cnts[sims[i] >= threshold].sum())
                 for i, p in enumerate(phrases)}
    Path(output).parent.mkdir(parents=True, exist_ok=True)
    with open(output, "w") as f:
        json.dump(sim_count, f, indent=4)
    print(f"wrote {len(sim_count)} similarity-weighted counts to {output}")


def sample_subset_by_frac(label: str, output: str, frac: float,
                          seed: int = 0) -> None:
    data = _load(label)
    rng = np.random.default_rng(seed)
    keep = rng.choice(len(data), size=int(len(data) * frac), replace=False)
    _dump([data[i] for i in sorted(keep)], output)


def filter_non_trivial_samples(label: str, output: str,
                               duration_csv: str,
                               max_coverage: float = 0.99) -> None:
    """Drop phrase items whose segments cover ≥ ``max_coverage`` of the clip
    (trivial always-on events)."""
    import pandas as pd
    durations = dict(pd.read_csv(duration_csv, sep="\t")[
        ["audio_id", "duration"]].values)
    data = _load(label)
    out = []
    for item in data:
        duration = durations.get(item["audio_id"])
        phrases = []
        for phrase_item in item["phrases"]:
            if isinstance(phrase_item, str) or duration is None:
                phrases.append(phrase_item)
                continue
            covered = sum(off - on
                          for on, off in phrase_item["segments"])
            if covered / max(duration, 1e-9) < max_coverage:
                phrases.append(phrase_item)
        if phrases:
            out.append({**item, "phrases": phrases})
    _dump(out, output)


def exclude_overlap_with_test(label: str, test_label: str,
                              output: str) -> None:
    """Drop train items whose audio_id appears in the test label JSON."""
    test_ids = {item["audio_id"] for item in _load(test_label)}
    data = [item for item in _load(label)
            if item["audio_id"] not in test_ids]
    _dump(data, output)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("concat")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--output", required=True)
    p = sub.add_parser("phrase_count")
    p.add_argument("label")
    p.add_argument("output")
    p = sub.add_parser("phrase_sim_count")
    p.add_argument("phrase_count")
    p.add_argument("embedding")
    p.add_argument("output")
    p.add_argument("--threshold", type=float, default=0.5)
    p = sub.add_parser("sample_frac")
    p.add_argument("label")
    p.add_argument("output")
    p.add_argument("--frac", type=float, required=True)
    p.add_argument("--seed", type=int, default=0)
    p = sub.add_parser("filter_non_trivial")
    p.add_argument("label")
    p.add_argument("output")
    p.add_argument("--duration_csv", required=True)
    p.add_argument("--max_coverage", type=float, default=0.99)
    p = sub.add_parser("exclude_test_overlap")
    p.add_argument("label")
    p.add_argument("test_label")
    p.add_argument("output")
    args = ap.parse_args()
    if args.cmd == "concat":
        concat_label(args.inputs, args.output)
    elif args.cmd == "phrase_count":
        calc_phrase_count(args.label, args.output)
    elif args.cmd == "phrase_sim_count":
        calc_phrase_sim_count(args.phrase_count, args.embedding,
                              args.output, args.threshold)
    elif args.cmd == "sample_frac":
        sample_subset_by_frac(args.label, args.output, args.frac, args.seed)
    elif args.cmd == "filter_non_trivial":
        filter_non_trivial_samples(args.label, args.output,
                                   args.duration_csv, args.max_coverage)
    elif args.cmd == "exclude_test_overlap":
        exclude_overlap_with_test(args.label, args.test_label, args.output)


if __name__ == "__main__":
    main()
