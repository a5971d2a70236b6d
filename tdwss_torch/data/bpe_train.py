"""Train a CLIP-format BPE merges vocabulary from a text corpus (twin of
:mod:`tdwss.data.bpe_train`).

The reference tokenizes with CLIP's ``bpe_simple_vocab_16e6.txt.gz``
(dataset/dataset_utils/tokenizer.py:87-160), which the repository does
not ship.  This is the standard BPE training over CLIP's
pre-tokenization (its word pattern, the byte-to-unicode map and the
``</w>`` end-of-word marker), so the merges file it writes loads into
:class:`tdwss_torch.data.tokenizer.BpeTokenizer` as it is.
:func:`scannet_corpus` is the deterministic corpus of the shipped asset,
``assets/bpe_scannet.txt.gz``: ``train_bpe(scannet_corpus(), 2048)``
gives its merges line for line.

Run: ``python -m tdwss_torch.data.bpe_train [--merges 2048] --out PATH``
(``--out`` defaults to the shipped asset).
"""

from __future__ import annotations

import collections
import gzip
import os
from typing import Dict, List, Sequence, Tuple

from tdwss_torch.data.tokenizer import (_WORD_RE, _basic_clean,
                                        _bytes_to_unicode)


def corpus_word_counts(corpus: Sequence[str]) -> Dict[Tuple[str, ...], int]:
    """Pre-tokenize the corpus exactly like BpeTokenizer.encode does."""
    byte_encoder = _bytes_to_unicode()
    counts: Dict[Tuple[str, ...], int] = collections.Counter()
    for text in corpus:
        for tok in _WORD_RE.findall(_basic_clean(text)):
            sym = "".join(byte_encoder[b] for b in tok.encode("utf-8"))
            word = tuple(sym[:-1]) + (sym[-1] + "</w>",)
            counts[word] += 1
    return dict(counts)


def train_bpe(corpus: Sequence[str], num_merges: int) -> List[Tuple[str, str]]:
    """Greedy highest-frequency pair merging (ties break lexicographically
    for determinism).  Returns the ordered merge list."""
    words = corpus_word_counts(corpus)
    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        pair_counts: Dict[Tuple[str, str], int] = collections.Counter()
        for word, cnt in words.items():
            for pair in zip(word[:-1], word[1:]):
                pair_counts[pair] += cnt
        if not pair_counts:
            break
        best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
        if pair_counts[best] < 2:
            break
        merges.append(best)
        first, second = best
        merged = first + second
        new_words: Dict[Tuple[str, ...], int] = {}
        for word, cnt in words.items():
            out: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            key = tuple(out)
            new_words[key] = new_words.get(key, 0) + cnt
        words = new_words
    return merges


def write_merges(merges: Sequence[Tuple[str, str]], path: str) -> None:
    """CLIP file layout: a header line, then one 'first second' per line."""
    opener = gzip.open if path.endswith(".gz") else open
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with opener(path, "wt", encoding="utf-8") as f:
        f.write("#version: tdwss-bpe (CLIP bpe_simple_vocab format)\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")


# ScanNet NYU40-class + ScanRefer-style spatial language: the training
# corpus for the shipped asset.  Deterministic (no RNG) so the asset is
# reproducible bit-for-bit.
_CLASSES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture", "television", "lamp", "pillow", "towel", "mirror",
    "nightstand", "dresser", "stool", "bench", "monitor", "keyboard",
    "whiteboard", "backpack", "trash can", "laundry basket", "microwave",
    "dishwasher", "stove", "oven", "armchair", "coffee table", "ottoman",
]
_COLORS = ["white", "black", "brown", "gray", "red", "blue", "green",
           "beige", "dark", "light", "wooden", "metal", "plastic", "leather"]
_RELATIONS = [
    "to the left of", "to the right of", "in front of", "behind", "next to",
    "on top of", "under", "near", "across from", "in the corner of",
    "against", "between", "beside", "attached to", "close to",
]
_TEMPLATES = [
    "the {c1} {o1} is {r} the {o2}",
    "there is a {c1} {o1} {r} the {c2} {o2}",
    "a {c1} {o1} sits {r} the {o2} in the room",
    "this is the {o1} {r} the {o2}",
    "find the {c1} {o1} that is {r} the {c2} {o2}",
    "it is a {o1} placed {r} the {o2}",
    "the {o1} in the room is {c1} and stands {r} the {o2}",
]


def scannet_corpus() -> List[str]:
    """Deterministic ScanRefer-style sentences over the class vocabulary."""
    corpus: List[str] = []
    for i, o1 in enumerate(_CLASSES):
        for j, o2 in enumerate(_CLASSES):
            if i == j:
                continue
            t = _TEMPLATES[(i * len(_CLASSES) + j) % len(_TEMPLATES)]
            corpus.append(t.format(
                o1=o1, o2=o2,
                c1=_COLORS[(i + j) % len(_COLORS)],
                c2=_COLORS[(i * 3 + j) % len(_COLORS)],
                r=_RELATIONS[(i + 2 * j) % len(_RELATIONS)],
            ))
    return corpus


def main() -> None:
    import argparse

    from tdwss_torch.data.tokenizer import DEFAULT_VOCAB_PATH

    ap = argparse.ArgumentParser()
    ap.add_argument("--merges", type=int, default=2048)
    ap.add_argument("--out", type=str, default=DEFAULT_VOCAB_PATH)
    args = ap.parse_args()
    merges = train_bpe(scannet_corpus(), args.merges)
    write_merges(merges, args.out)
    print(f"wrote {len(merges)} merges -> {args.out}")


if __name__ == "__main__":
    main()
