"""Caption → phrase splitting (the WSTAG data-format generator).

Reference: utils/data/phrase_parser.py:11-334.  The conjunction/preposition
vocabulary and the "-er word" guard (words ending in "er" that are nouns,
not comparatives, so "and" before them is a real separator) are behavioral
data and kept equivalent; the implementation (single compiled pass +
token-index localization) is our own.

A copy of ``texttoaudiogrounding_tpu/tools/phrase_parser.py``.
"""

from __future__ import annotations

import json
import re
from typing import List

# connective phrases that separate event descriptions in captions
CONJUNCTIONS = [
    "and then", "is followed by", "follow by", "followed by",
    "are followed by", "accompanied by", "is accompanied by",
    "are accompanied by", "interrupted by", "is interrupted by",
    "are interrupted by", "meanwhile", "all the while", "before which",
    "after which", "during which time", "while", "which", "as well as",
    "during", "afterward", "afterwards", "before and after",
    "proceeded by", "before", "after", "though", "although",
    "despite that", "simultaneously with", "then", "along with",
    "alongside", "following by", "following", "when", "punctuated by",
    "overlapped by",
]

# nouns ending in "-er"/"-erX": "and" before these is a separator even
# though the generic rule skips "and <comparative>-er"
ER_NOUNS = [
    "another", "there", "thunder", "water", "other", "emergency",
    "several", "chatter", "clatter", "person", "artillery", "camera",
    "ceramic", "cheer", "computer", "convers", "decelerat", "accelerat",
    "laughter", "helicopter", "paper", "propeller", "silver", "rooster",
    "whimper", "drawer", "everyone", "flutter", "hammer", "holler",
    "laser", "later", "member", "mother", "father", "operate",
    "passenger", "patter", "peeper", "percussion", "persistent",
    "photographer", "power", "river", "rubber", "sneaker", "starter",
    "spatter", "splatter", "sputter", "toddler", "twitter", "typewriter",
    "verbaliz", "very", "whisper", "wiper", "wrapper",
]

_FILLER = {"is", "are", "and"}


class PhraseParser:
    """Split a caption into sound-event phrases."""

    def __init__(self):
        mid = "|".join(",? " + c + " " for c in CONJUNCTIONS)
        head = "|".join("^" + c + " " for c in CONJUNCTIONS)
        extra = (r"|,? as well"
                 r"|,? and (?!forth|down|backward|over|out|off|more|\w+er)"
                 r"|,?(?<!play)(?<!playing) with (?!one\sanother|each\sother)"
                 r"|,? ?(?<!w) as (?!a\sresult)"
                 r"|, |; ")
        self.pattern = re.compile(mid + "|" + head + extra, re.IGNORECASE)
        self.er_pattern = re.compile(
            ",? ?and (?=" + "|".join(ER_NOUNS) + ")", re.IGNORECASE)

    @staticmethod
    def _clean_split(pattern: re.Pattern, sentence: str) -> List[str]:
        out = []
        for piece in pattern.split(sentence):
            piece = piece.strip().lower()
            if piece and piece not in _FILLER:
                out.append(piece)
        return out

    def __call__(self, sentence: str) -> List[str]:
        phrases: List[str] = []
        for phrase in self._clean_split(self.pattern, sentence):
            # second pass: split "and <er-noun>" inside remaining chunks
            parts = self._clean_split(self.er_pattern, phrase)
            if len(parts) > 1:
                phrases.extend(parts)
            elif parts and parts[0] != phrase:
                phrases.append(parts[0])
            else:
                phrases.append(phrase)
        return phrases


def locate_phrase(tokens: str, phrase: str) -> tuple[int, int]:
    """Token start/end indices of ``phrase`` inside the caption ``tokens``
    (reference utils/data/phrase_parser.py:94-107 semantics: ambiguous
    multi-occurrence phrases collapse to (0, 0))."""
    if tokens.count(phrase) > 1:
        words = tokens.split()
        if len(phrase.split()) == 1 and words.count(phrase) == 1:
            idx = words.index(phrase)
            return idx, idx
        return 0, 0
    char_start = tokens.index(phrase)
    start = len(tokens[:char_start].split())
    return start, start + len(phrase.split()) - 1


def extract_phrases(caption_items: list, id_key: str = "audiocap_id",
                    tokens_key: str = "tokens") -> list:
    """caption items → WSTAG label JSON entries with phrase dicts."""
    parser = PhraseParser()
    data = []
    for item in caption_items:
        tokens = re.sub(r"[.()]", "", item[tokens_key].lower())
        out = {
            id_key: item[id_key],
            "audio_id": item["audio_id"],
            "tokens": tokens,
            "phrases": [],
        }
        for phrase in parser(tokens):
            start, end = locate_phrase(tokens, phrase)
            out["phrases"].append({"phrase": phrase, "start_index": start,
                                   "end_index": end, "segments": []})
        data.append(out)
    return data


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("caption_file", help="JSON list with audio_id/tokens")
    ap.add_argument("output")
    args = ap.parse_args()
    with open(args.caption_file) as f:
        items = json.load(f)
    data = extract_phrases(items)
    with open(args.output, "w") as f:
        json.dump(data, f, indent=2)
    print(f"wrote {len(data)} items to {args.output}")


if __name__ == "__main__":
    main()
