"""The port's text towers and CLIP converter against the reference's.

- ``TextTransformer`` at context 16, 2 layers, vocab 1,000, widths 64
  (1 head) and 128 (2 heads), on token rows of varied length and one
  all-zero row: seeded numpy parameters carried over by
  ``flax_to_state_dict``; the features within rtol = atol = 1e-5 of the
  flax module's, and every parameter gradient of a random linear
  functional of them within rtol = atol = 1e-4 of ``jax.grad``'s (read
  back through ``state_dict_to_flax``).  The key projection's bias has a
  zero gradient in exact arithmetic (softmax ignores a shift common to a
  query's keys): both sides give rounding noise there, within the atol.
- ``CLIPTransformer`` keeps CLIP's sizes whatever the config says, its
  parameters take no gradient and its output is detached.
- ``convert_text_tower`` and ``convert_checkpoint`` give the reference's
  arrays on a random CLIP-layout state dict, ``load_pretrained_params``
  reads that ``.npz`` back as the reference does, and the tree loaded
  into the port's tower gives the flax tower's features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import _random_variables
from tdwss.models.clip_import import convert_checkpoint as ref_convert_ckpt
from tdwss.models.clip_import import convert_text_tower as ref_convert
from tdwss.models.transformer import CLIPTransformer as RefCLIP
from tdwss.models.transformer import TextTransformer as RefTextTransformer
from tdwss_torch.config import TextModelConfig
from tdwss_torch.convert import flax_to_state_dict, state_dict_to_flax
from tdwss_torch.models.clip_import import (convert_checkpoint,
                                            convert_text_tower)
from tdwss_torch.models.transformer import (CLIPTransformer, TextTransformer,
                                            build_text_encoder)

CONTEXT, LAYERS, VOCAB = 16, 2, 1000
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _leaves(tree, prefix=()):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _tokens(rng, rows, length, vocab):
    """SOT, word ids, EOT (the largest id), zeros; the last row all
    zero (a padded description slot)."""
    tok = np.zeros((rows, length), np.int32)
    for i in range(rows - 1):
        n = int(rng.integers(1, length - 1))
        tok[i, 0] = vocab - 2
        tok[i, 1:n + 1] = rng.integers(1, vocab - 3, n)
        tok[i, n + 1] = vocab - 1
    return tok


@pytest.mark.parametrize("width", [64, 128])
def test_text_transformer_matches_reference(width):
    rng = np.random.default_rng(width)
    tok = _tokens(rng, 6, CONTEXT, VOCAB)
    ref = RefTextTransformer(context_length=CONTEXT, width=width,
                             layers=LAYERS, vocab_size=VOCAB)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            jnp.asarray(tok))
    params = _random_variables(shapes["params"], rng)
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(tok)))
    cot = rng.normal(size=want.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(
        ref.apply({"params": p}, jnp.asarray(tok)) * cot))(params)

    port = TextTransformer(CONTEXT, width, LAYERS, VOCAB)
    port.load_state_dict(flax_to_state_dict(params))
    got = port(torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.shape == (6, width)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    port_grads, _ = state_dict_to_flax(
        {n: p.grad for n, p in port.named_parameters()})
    got_g, want_g = dict(_leaves(port_grads)), dict(_leaves(grads))
    assert got_g.keys() == want_g.keys()
    for path, g in got_g.items():
        np.testing.assert_allclose(g, want_g[path], **GRAD_TOL,
                                   err_msg="/".join(path))


def test_all_zero_row_pools_at_position_zero():
    port = TextTransformer(CONTEXT, 64, 1, VOCAB,
                           generator=torch.Generator().manual_seed(0))
    tok = torch.zeros((1, CONTEXT), dtype=torch.int32)
    feats = port(tok)
    x = (port.token_embedding(tok.long())
         + port.positional_embedding[:CONTEXT][None])
    x = port.ln_final(port.resblock_0(x))
    torch.testing.assert_close(feats, x[:, 0], rtol=0, atol=0)


def test_clip_transformer_is_frozen_and_keeps_clips_sizes():
    cfg = TextModelConfig(name="CLIPTransformer", context_length=16,
                          width=64, layers=2, vocab_size=1000)
    enc = build_text_encoder(cfg, torch.Generator().manual_seed(0))
    assert isinstance(enc, CLIPTransformer)
    inner = enc.clip_text
    assert (inner.positional_embedding.shape, inner.layers,
            inner.token_embedding.num_embeddings) == ((77, 512), 12, 49408)
    assert not any(p.requires_grad for p in enc.parameters())
    tok = torch.from_numpy(_tokens(np.random.default_rng(0), 2, 77, 49408))
    out = enc(tok)
    assert out.shape == (2, 512) and not out.requires_grad
    ref = RefCLIP()
    assert (ref.context_length, ref.width, ref.layers, ref.vocab_size) == (
        77, 512, 12, 49408)


def _clip_state(rng, width=128, layers=2, vocab=500, context=CONTEXT):
    """A random state dict in OpenAI CLIP's text-tower layout."""
    def r(*shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    state = {"token_embedding.weight": r(vocab, width),
             "positional_embedding": r(context, width),
             "ln_final.weight": 1 + r(width), "ln_final.bias": r(width),
             "text_projection": r(width, 64)}
    for n in range(layers):
        p = f"transformer.resblocks.{n}"
        state.update({
            f"{p}.ln_1.weight": 1 + r(width), f"{p}.ln_1.bias": r(width),
            f"{p}.ln_2.weight": 1 + r(width), f"{p}.ln_2.bias": r(width),
            f"{p}.attn.in_proj_weight": r(3 * width, width),
            f"{p}.attn.in_proj_bias": r(3 * width),
            f"{p}.attn.out_proj.weight": r(width, width),
            f"{p}.attn.out_proj.bias": r(width),
            f"{p}.mlp.c_fc.weight": r(4 * width, width),
            f"{p}.mlp.c_fc.bias": r(4 * width),
            f"{p}.mlp.c_proj.weight": r(width, 4 * width),
            f"{p}.mlp.c_proj.bias": r(width)})
    return state


def test_clip_import_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    state = _clip_state(rng)
    flat, ref_flat = convert_text_tower(state, 2), ref_convert(state, 2)
    assert flat.keys() == ref_flat.keys()
    for key, value in flat.items():
        assert value.dtype == np.float32
        np.testing.assert_array_equal(value, ref_flat[key], err_msg=key)

    ckpt = tmp_path / "clip.pt"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, ckpt)
    assert convert_checkpoint(str(ckpt), str(tmp_path / "port.npz")) == \
        ref_convert_ckpt(str(ckpt), str(tmp_path / "ref.npz"))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_load_pretrained_params_round_trips_the_npz(tmp_path):
    rng = np.random.default_rng(6)
    path = tmp_path / "clip_text.npz"
    np.savez(path, **convert_text_tower(_clip_state(rng), 2))
    tree = CLIPTransformer.load_pretrained_params(str(path))
    ref_tree = RefCLIP.load_pretrained_params(str(path))
    got, want = dict(_leaves(tree)), dict(_leaves(ref_tree))
    assert got.keys() == want.keys()
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key])

    # the converted weights in the port's tower and in the flax tower
    tok = _tokens(rng, 4, CONTEXT, 500)
    ref = RefTextTransformer(context_length=CONTEXT, width=128,
                             layers=2, vocab_size=500)
    want_f = np.asarray(ref.apply({"params": ref_tree["clip_text"]},
                                  jnp.asarray(tok)))
    port = TextTransformer(CONTEXT, 128, 2, 500)
    port.load_state_dict(flax_to_state_dict(tree["clip_text"]))
    got_f = port(torch.from_numpy(tok)).detach().numpy()
    np.testing.assert_allclose(got_f, want_f, **FWD_TOL)
