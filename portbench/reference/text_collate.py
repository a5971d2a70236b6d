"""The token rows of a train batch's descriptions, worked out again from
the raw scenes' texts.

A frozen plain copy of what the program's text collate does (the
reference project's trainMerge with ``clip.tokenize``,
``dataset/data.py:13,195``): the batch's scenes in the epoch's order
(``SeedSequence([seed, epoch])``, as :mod:`portbench.reference.collate`
draws it), each scene's first ``cropped_texts`` descriptions byte-pair
encoded over the repository's merges file, ``[SOT, ids..., EOT]`` cut to
``max_seq_len`` and padded with zeros; the owner of row ``b`` is scene
``b``, and a slot counts in the loss where its scene has texts and the
slot holds a token.  The byte-pair encoding is CLIP's ``SimpleTokenizer``
(its word pattern, its byte map, its merge order); it reads the merges
asset as a data file and imports nothing of the program.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tdwss_torch", "data", "assets",
    "bpe_scannet.txt.gz")

_ASCII_WORD_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE)
try:
    import regex as _regex

    _WORD_RE = _regex.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE)
except ImportError:
    _WORD_RE = _ASCII_WORD_RE


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


def _byte_map() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class Tokenizer:
    """Byte-pair encoding over a CLIP-format merges file; SOT and EOT are
    its two last ids."""

    def __init__(self, path: str = ASSET):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        self.bytes = _byte_map()
        vocab = list(self.bytes.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {v: i for i, v in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.vocab_size = len(vocab)
        self.sot, self.eot = self.vocab_size - 2, self.vocab_size - 1
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            first, second = min(pairs, key=lambda p: self.ranks.get(
                p, float("inf")))
            if (first, second) not in self.ranks:
                break
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for w in _WORD_RE.findall(_clean(text)):
            w = "".join(self.bytes[b] for b in w.encode("utf-8"))
            out.extend(self.ids[t] for t in self._bpe(w) if t in self.ids)
        return out


def tokenize(tok: Tokenizer, texts: Sequence[str], length: int,
             vocab_size: int) -> np.ndarray:
    """(len(texts), length) int64 rows: SOT, the ids, EOT, zeros; ids
    past ``length - 2`` cut.  An embedding smaller than the tokenizer's
    vocabulary folds the ids into it, SOT and EOT its two last rows."""
    sot, eot, fold = tok.sot, tok.eot, vocab_size < tok.vocab_size
    if fold:
        sot, eot = vocab_size - 2, vocab_size - 1
    out = np.zeros((len(texts), length), np.int64)
    for i, text in enumerate(texts):
        ids = tok.encode(text)[: length - 2]
        if fold:
            ids = [1 + t % (vocab_size - 3) for t in ids]
        ids = [sot] + ids + [eot]
        out[i, : len(ids)] = ids
    return out


@dataclass
class TextRows:
    """tokens (B, T, L) int64; valid (B,) bool: the scene has texts;
    mask (B, T) bool: the slots that count in the loss."""

    tokens: np.ndarray
    valid: np.ndarray

    @property
    def mask(self) -> np.ndarray:
        return self.valid[:, None] & (self.tokens != 0).any(-1)


def text_rows(scenes: Sequence, params: dict, seed: int, epoch: int,
              start: int, tok: Tokenizer, rolled: bool = False
              ) -> TextRows:
    """The descriptions of the batch at ``start`` of ``epoch``.
    ``params`` holds ``batch_size``, ``cropped_texts``, ``max_seq_len``
    and ``vocab_size``.  ``rolled`` plants a fault: each scene takes the
    next scene's descriptions in the batch."""
    order = np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(len(scenes))
    sel = [scenes[i] for i in order[start:start + params["batch_size"]]]
    if rolled:
        sel = sel[1:] + sel[:1]
    t, length = params["cropped_texts"], params["max_seq_len"]
    tokens = np.zeros((len(sel), t, length), np.int64)
    for b, scene in enumerate(sel):
        texts = list(scene.texts[:t])
        if texts:
            tokens[b, :len(texts)] = tokenize(tok, texts, length,
                                              params["vocab_size"])
    return TextRows(tokens=tokens,
                    valid=np.array([bool(list(s.texts[:t])) for s in sel]))


def text_params(cfg: dict) -> Dict[str, int]:
    """The text collate's parameters of a configuration."""
    td, tm = cfg["text_data"], cfg["text_model"]
    return {"batch_size": cfg["pointcloud_data"]["batch_size"],
            "cropped_texts": td["cropped_texts"],
            "max_seq_len": td["max_seq_len"],
            "vocab_size": tm["vocab_size"]}

