"""The benchmark's traffic mixes with descriptions: rooms from the frozen
generator (:func:`portbench.traffic.generate.generate`) and, for each,
``texts_per_scene`` ScanRefer-like descriptions of its objects.

A mix file holds the room generator's parameters (``kind`` ``scenes``)
and ``texts_per_scene``, ``words_mean``, ``words_sigma``.  Each room's
descriptions draw from ``SeedSequence([seed, i, 1])``: one seed gives the
same rooms and texts on every run.  A description has a length in words
drawn from a lognormal of mean ``words_mean`` (``exp(mu + sigma^2 / 2)``;
ScanRefer's descriptions average 20 words, with a tail past 60:
Chen et al., ECCV 2020, arXiv:1912.08830) and at least 3 words.  Its
words are sentences about one target object of the room (a class the
room holds) and its neighbours: colours, sizes and spatial relations,
cut at the drawn length and ended by a full stop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from portbench.traffic.generate import RawScene, generate

# ScanNet's 20 benchmark classes, in the labels' order
CLASSES = ("wall", "floor", "cabinet", "bed", "chair", "sofa", "table",
           "door", "window", "bookshelf", "picture", "counter", "desk",
           "curtain", "refrigerator", "shower curtain", "toilet", "sink",
           "bathtub", "other furniture")
COLOURS = ("brown", "white", "black", "grey", "blue", "red", "green",
           "yellow", "beige", "wooden", "dark", "light")
SIZES = ("small", "large", "tall", "short", "long", "wide", "narrow")
RELATIONS = ("next to", "in front of", "behind", "to the left of",
             "to the right of", "near", "across from", "under", "above",
             "between the wall and")
PLACES = ("in the corner of the room", "against the wall",
          "in the middle of the room", "by the door", "near the window",
          "on the far side of the room")


@dataclass
class TextScene(RawScene):
    """A room and its descriptions."""

    texts: List[str] = field(default_factory=list)


def _sentences(rng: np.random.Generator, target: str, others: List[str]):
    """An endless stream of words about ``target``."""
    def pick(xs):
        return xs[int(rng.integers(len(xs)))]

    first = (f"this is a {pick(COLOURS)} {pick(SIZES)} {target} "
             f"{pick(PLACES)}.")
    yield from first.split()
    while True:
        other = pick(others)
        kind = int(rng.integers(4))
        if kind == 0:
            s = f"it is {pick(RELATIONS)} the {pick(COLOURS)} {other}."
        elif kind == 1:
            s = f"the {target} is {pick(RELATIONS)} a {pick(SIZES)} {other}."
        elif kind == 2:
            s = (f"there is a {pick(COLOURS)} {other} {pick(RELATIONS)} "
                 f"the {target}, {int(rng.integers(1, 4))} m away.")
        else:
            s = f"the {target} is {pick(COLOURS)} and {pick(SIZES)}."
        yield from s.split()


def describe(rng: np.random.Generator, labels: np.ndarray, count: int,
             words_mean: float, words_sigma: float) -> List[str]:
    """``count`` descriptions of a room whose points carry ``labels``."""
    present = sorted({int(c) for c in np.unique(labels) if 0 <= c < 20})
    objects = [CLASSES[c] for c in present if c >= 2] or ["table"]
    others = [CLASSES[c] for c in present] or ["wall"]
    mu = np.log(words_mean) - words_sigma ** 2 / 2
    out = []
    for _ in range(count):
        n = max(3, int(round(rng.lognormal(mu, words_sigma))))
        words = _sentences(rng, objects[int(rng.integers(len(objects)))],
                           others)
        text = " ".join(next(words) for _ in range(n))
        out.append(text.rstrip(".,") + ".")
    return out


def generate_text(mix: dict, seed: int) -> List[TextScene]:
    """The rooms of ``mix`` for ``seed``, each with its descriptions."""
    rooms = generate(dict(mix, kind="scenes"), seed)
    out = []
    for i, r in enumerate(rooms):
        rng = np.random.default_rng(np.random.SeedSequence([seed, i, 1]))
        out.append(TextScene(
            points=r.points, colors=r.colors, labels=r.labels, name=r.name,
            texts=describe(rng, r.labels, mix["texts_per_scene"],
                           mix["words_mean"], mix["words_sigma"])))
    return out
