"""``TextContrastive`` against the reference's, value and gradients.

Seeded numpy scene features (B=4) and text features (B'=4 rows of T=5
slots), f32, with a padded scene (``scene_mask``), padded slots (a 2-D
``text_mask``), padded rows (a 1-D ``text_mask``), no mask, and an owner
of -1 (dropped) and of B + 2 (clipped into range).  The value within
rtol 1e-6, the gradients with respect to both feature arrays within
rtol = atol = 1e-5 of ``jax.grad``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss.utils.losses import TextContrastive as ref_text_contrastive
from tdwss_torch.utils.losses import TextContrastive

B, ROWS, SLOTS, WIDTH = 4, 4, 5, 8


def _case(mask_kind, scene_pad, owners, seed=0):
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(B, WIDTH)).astype(np.float32)
    text = rng.normal(size=(ROWS, SLOTS, WIDTH)).astype(np.float32)
    has_text = np.asarray(owners, np.int32)
    text_mask = None
    if mask_kind == "rows":
        text_mask = np.asarray([True, True, False, True])
    elif mask_kind == "slots":
        text_mask = rng.random((ROWS, SLOTS)) < 0.7
        text_mask[2] = False                 # a scene without texts
    scene_mask = None
    if scene_pad:
        scene_mask = np.asarray([True, True, True, False])
        pc[3] = 0.0                          # a padded scene pools to 0
    return pc, text, has_text, text_mask, scene_mask


@pytest.mark.parametrize("mask_kind", [None, "rows", "slots"])
@pytest.mark.parametrize("scene_pad", [False, True])
@pytest.mark.parametrize("owners", [(0, 1, 2, 3), (2, -1, 0, B + 2)],
                         ids=["owners", "bad_owners"])
def test_text_contrastive_matches_reference(mask_kind, scene_pad, owners):
    pc, text, has_text, text_mask, scene_mask = _case(mask_kind, scene_pad,
                                                      owners)

    def ref_loss(p, t):
        return ref_text_contrastive(
            p, t, jnp.asarray(has_text),
            text_mask=None if text_mask is None else jnp.asarray(text_mask),
            scene_mask=None if scene_mask is None
            else jnp.asarray(scene_mask))

    want, (want_gp, want_gt) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(pc), jnp.asarray(text))

    p = torch.from_numpy(pc).requires_grad_()
    t = torch.from_numpy(text).requires_grad_()
    got = TextContrastive(
        p, t, torch.from_numpy(has_text),
        text_mask=None if text_mask is None else torch.from_numpy(text_mask),
        scene_mask=None if scene_mask is None
        else torch.from_numpy(scene_mask))
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_gp),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_gt),
                               rtol=1e-5, atol=1e-5)


def test_text_contrastive_refuses_flat_text_and_mixes_dtypes():
    pc, text, has_text, _, _ = _case(None, False, (0, 1, 2, 3))
    with pytest.raises(ValueError, match="B', T, m"):
        TextContrastive(torch.from_numpy(pc), torch.from_numpy(text[:, 0]),
                        torch.from_numpy(has_text))
    # bf16 scene features with f32 text promote to f32, as jnp.einsum does
    got = TextContrastive(torch.from_numpy(pc).bfloat16(),
                          torch.from_numpy(text), torch.from_numpy(has_text))
    want = ref_text_contrastive(jnp.asarray(pc, jnp.bfloat16),
                                jnp.asarray(text), jnp.asarray(has_text))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
