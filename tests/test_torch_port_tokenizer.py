"""The port's tokenizer against the reference's, id for id.

``HashTokenizer``, ``BpeTokenizer`` over the shipped merges file (the
port's copy byte-equal to the reference's) and ``tokenize``, with the
vocabulary fold (a 1,000-id table) and without it, at the configs'
context 120 and cut at 8, on the synthetic scenes' descriptions and on
ScanRefer-style English sentences; and the ASCII word pattern, which the
port falls back to on a host without the ``regex`` module, equal to the
reference's fallback and to CLIP's pattern on ASCII text.
"""

import filecmp
import inspect

import numpy as np
import pytest

from tdwss.data import tokenizer as ref_tok
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss_torch.data import tokenizer as tok
from tdwss_torch.data.synthetic import CLASS_LABELS

SCANREFER_STYLE = [
    "This is a brown wooden chair. It is placed at the end of the table.",
    "the tall black trash can is to the left of the door.",
    "A white refrigerator stands in the corner; it's next to the counter.",
    "There are 2 pillows on the bed, the one closer to the window is blue.",
    "The bookshelf is against the wall, between the desk and the sofa!!",
    "it is a small square table with four legs . it's in front of the couch",
    "The sink &amp; the mirror are above the cabinet in the bathroom.",
    "you'll see a shower curtain hanging, it's white and   striped.",
    "the 3rd picture from the left, hung over the 1st bed's headboard.",
    "A grey office chair (with wheels) is pushed under the desk.",
    "Toilet paper roll -- right of the toilet, on the wall's holder.",
    "They've put the lamp we'd seen on the night stand by the bed.",
]


def _sentences():
    synthetic = [t for s in ref_make_dataset(3, num_points=2000, seed=5)
                 for t in s.texts]
    classes = [f"there is a {c} in the room" for c in CLASS_LABELS]
    return synthetic + classes + SCANREFER_STYLE


def test_shipped_asset_is_the_references():
    assert filecmp.cmp(tok.DEFAULT_VOCAB_PATH, ref_tok.DEFAULT_VOCAB_PATH,
                       shallow=False)
    assert isinstance(tok.get_tokenizer(), tok.BpeTokenizer)
    assert tok.get_tokenizer() is tok.get_tokenizer(tok.DEFAULT_VOCAB_PATH)


@pytest.mark.parametrize("kind", ["hash", "bpe"])
def test_encode_matches_reference(kind):
    if kind == "hash":
        port, ref = tok.HashTokenizer(), ref_tok.HashTokenizer()
    else:
        port = tok.BpeTokenizer(tok.DEFAULT_VOCAB_PATH)
        ref = ref_tok.BpeTokenizer(ref_tok.DEFAULT_VOCAB_PATH)
        assert (port.vocab_size, port.sot_id, port.eot_id) == (
            ref.vocab_size, ref.sot_id, ref.eot_id)
    for text in _sentences() + ["un café près de la fenêtre"]:
        assert port.encode(text) == ref.encode(text), text
    if kind == "bpe":
        text = SCANREFER_STYLE[0]
        assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))


@pytest.mark.parametrize("kind", ["hash", "bpe"])
@pytest.mark.parametrize("vocab_size", [49408, 1000])
@pytest.mark.parametrize("context", [120, 8])
def test_tokenize_matches_reference(kind, vocab_size, context):
    if kind == "hash":
        port, ref = tok.HashTokenizer(), ref_tok.HashTokenizer()
    else:
        port = tok.get_tokenizer()
        ref = ref_tok.get_tokenizer()
    texts = _sentences()
    got = tok.tokenize(texts, context, tokenizer=port, vocab_size=vocab_size)
    want = ref_tok.tokenize(texts, context, tokenizer=ref,
                            vocab_size=vocab_size)
    assert got.dtype == np.int32 and got.shape == (len(texts), context)
    np.testing.assert_array_equal(got, want)
    # EOT is the largest id of each row: the tower pools there
    eot = got.max(axis=1)
    assert (got[np.arange(len(texts)), got.argmax(axis=1)] == eot).all()
    assert (eot == (vocab_size - 1 if vocab_size < port.vocab_size
                    else getattr(port, "eot_id", tok.EOT_TOKEN))).all()


def test_ascii_fallback_pattern():
    assert tok._ASCII_WORD_RE.pattern in inspect.getsource(ref_tok)
    for text in _sentences():
        clean = tok._basic_clean(text)
        words = tok._ASCII_WORD_RE.findall(clean)
        assert words == tok._WORD_RE.findall(clean)
        assert words == ref_tok._WORD_RE.findall(clean)
    with pytest.raises(ValueError, match="too small"):
        tok.tokenize(["a"], 8, vocab_size=7)
