"""Text tokenization with CLIP's conventions (twin of
``tdwss.data.tokenizer``).

The reference tokenizes ScanRefer descriptions with ``clip.tokenize``
(dataset/data.py:13,195): byte-pair encoding, SOT/EOT wrappers, padding
or truncation to a fixed context length.  Here:

- :class:`BpeTokenizer` reads a CLIP-format merges file (one merge pair
  per line, ``bpe_simple_vocab_16e6.txt.gz`` layout).  The package ships
  one trained on ScanNet's vocabulary (``assets/bpe_scannet.txt.gz``, a
  byte-equal copy of the reference's asset); the real CLIP file can be
  named by ``text_data.bpe_vocab_path`` for ``clip.tokenize``'s ids.
- :class:`HashTokenizer` maps each word to a stable hash, with the same
  SOT/EOT/padding conventions, where no merges file is available.
- :func:`tokenize`: ``clip.tokenize``'s entry point and output layout.

Words are split with CLIP's pattern, which needs ``\\p{L}`` / ``\\p{N}``
from the ``regex`` module.  Without it an ASCII pattern is used: the
same words on ASCII text, different splits for non-ASCII letters and
digits (``"café"`` becomes ``"caf"`` + ``"é"``).
"""

from __future__ import annotations

import gzip
import hashlib
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np

SOT_TOKEN = 49406
EOT_TOKEN = 49407
VOCAB_SIZE = 49408

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

DEFAULT_VOCAB_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "assets",
    "bpe_scannet.txt.gz")


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
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


class HashTokenizer:
    """Word -> ``1 + md5(word) mod (SOT - 1)``: ids in [1, 49406), so
    SOT, EOT and the padding id 0 stay reserved; the same in every
    process (md5, not ``hash()``)."""

    vocab_size = VOCAB_SIZE

    def encode(self, text: str) -> List[int]:
        out = []
        for w in _WORD_RE.findall(_basic_clean(text)):
            h = int(hashlib.md5(w.encode("utf-8")).hexdigest()[:8], 16)
            out.append(1 + h % (SOT_TOKEN - 1))
        return out


class BpeTokenizer:
    """Byte-pair encoding over a CLIP-format merges file: CLIP's own
    (vocab 49,408) or a smaller one; ``vocab_size``, ``sot_id`` and
    ``eot_id`` follow from the file."""

    def __init__(self, merges_path: str):
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.vocab_size = len(vocab)
        self.sot_id = self.encoder["<|startoftext|>"]
        self.eot_id = self.encoder["<|endoftext|>"]
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for tok in _WORD_RE.findall(_basic_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out.extend(self.encoder[t] for t in self._bpe(tok)
                       if t in self.encoder)
        return out

    def decode(self, ids: Sequence[int]) -> str:
        """Inverse of :meth:`encode` on clean text (CLIP's decode)."""
        text = "".join(self.decoder.get(int(i), "") for i in ids
                       if int(i) not in (self.sot_id, self.eot_id))
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace(
            "</w>", " ").strip()


_BPE_CACHE: Dict[str, BpeTokenizer] = {}
_HASH_TOKENIZER = HashTokenizer()


def get_tokenizer(merges_path: Optional[str] = None):
    """BPE over ``merges_path``, else over the shipped asset, else the
    :class:`HashTokenizer`.  One BPE instance per path.

    Collate threads call this at once; two may build the same path's
    tokenizer, and the dict keeps one of the equal instances."""
    path = merges_path or (DEFAULT_VOCAB_PATH
                           if os.path.exists(DEFAULT_VOCAB_PATH) else None)
    if not path:
        return _HASH_TOKENIZER
    tok = _BPE_CACHE.get(path)
    if tok is None:
        tok = _BPE_CACHE.setdefault(path, BpeTokenizer(path))
    return tok


def tokenize(texts: Sequence[str], context_length: int = 77,
             tokenizer=None, vocab_size: int = VOCAB_SIZE) -> np.ndarray:
    """``clip.tokenize``'s layout: (B, context_length) int32, SOT, the
    word ids, EOT, then zeros; words past ``context_length - 2`` are cut.

    With ``vocab_size`` below the tokenizer's vocabulary (a smaller
    embedding table), SOT and EOT become ``vocab_size - 2`` and
    ``vocab_size - 1`` (EOT stays the largest id: the transformer pools
    at the argmax of the ids) and word ids fold into
    [1, vocab_size - 3].
    """
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = tokenizer or get_tokenizer()
    tok_vocab = getattr(tokenizer, "vocab_size", VOCAB_SIZE)
    sot = getattr(tokenizer, "sot_id", SOT_TOKEN)
    eot = getattr(tokenizer, "eot_id", EOT_TOKEN)
    fold = vocab_size < tok_vocab
    if fold:
        if vocab_size < 8:
            raise ValueError(f"vocab_size too small: {vocab_size}")
        sot, eot = vocab_size - 2, vocab_size - 1
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = tokenizer.encode(text)[: context_length - 2]
        if fold:
            ids = [1 + (t % (vocab_size - 3)) for t in ids]
        ids = [sot] + ids + [eot]
        out[i, : len(ids)] = ids
    return out
