"""Convert an OpenAI CLIP checkpoint's text tower to the flat ``.npz``
that ``CLIPTransformer.load_pretrained_params`` reads (twin of
:mod:`tdwss.models.clip_import`; the same file layout).

Name mapping (CLIP text tower -> ``TextTransformer`` under
``clip_text``):

    token_embedding.weight                -> token_embedding/embedding
    positional_embedding                  -> positional_embedding
    transformer.resblocks.N.ln_1.{w,b}    -> resblock_N/ln_1/{scale,bias}
    transformer.resblocks.N.attn.in_proj_*-> resblock_N/attn/{query,key,value}
                                             (split thirds; kernels
                                             transposed and reshaped to
                                             (in, heads, head_dim))
    transformer.resblocks.N.attn.out_proj -> resblock_N/attn/out
    transformer.resblocks.N.ln_2.{w,b}    -> resblock_N/ln_2/{scale,bias}
    transformer.resblocks.N.mlp.c_fc      -> resblock_N/c_fc
    transformer.resblocks.N.mlp.c_proj    -> resblock_N/c_proj
    ln_final.{weight,bias}                -> ln_final/{scale,bias}

Usage::

    python -m tdwss_torch.models.clip_import ViT-B-32.pt clip_text.npz
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np


def convert_text_tower(state: Dict[str, np.ndarray],
                       heads: int) -> Dict[str, np.ndarray]:
    """CLIP text-tower state dict (numpy values) -> flat parameter dict,
    keys ``'/'``-joined paths under ``clip_text/``, float32."""
    def npy(key):
        return np.asarray(state[key], np.float32)

    width = npy("ln_final.weight").shape[0]
    head_dim = width // heads
    out: Dict[str, np.ndarray] = {
        "clip_text/token_embedding/embedding": npy("token_embedding.weight"),
        "clip_text/positional_embedding": npy("positional_embedding"),
        "clip_text/ln_final/scale": npy("ln_final.weight"),
        "clip_text/ln_final/bias": npy("ln_final.bias"),
    }
    n = 0
    while f"transformer.resblocks.{n}.ln_1.weight" in state:
        p = f"transformer.resblocks.{n}"
        o = f"clip_text/resblock_{n}"
        for ln in ("ln_1", "ln_2"):
            out[f"{o}/{ln}/scale"] = npy(f"{p}.{ln}.weight")
            out[f"{o}/{ln}/bias"] = npy(f"{p}.{ln}.bias")
        # torch packs q, k, v as one (3 * width, width) y = W x
        w_in = npy(f"{p}.attn.in_proj_weight")
        b_in = npy(f"{p}.attn.in_proj_bias")
        for i, name in enumerate(("query", "key", "value")):
            w = w_in[i * width:(i + 1) * width]
            b = b_in[i * width:(i + 1) * width]
            out[f"{o}/attn/{name}/kernel"] = w.T.reshape(width, heads,
                                                         head_dim)
            out[f"{o}/attn/{name}/bias"] = b.reshape(heads, head_dim)
        out[f"{o}/attn/out/kernel"] = npy(
            f"{p}.attn.out_proj.weight").T.reshape(heads, head_dim, width)
        out[f"{o}/attn/out/bias"] = npy(f"{p}.attn.out_proj.bias")
        for fc in ("c_fc", "c_proj"):
            out[f"{o}/{fc}/kernel"] = npy(f"{p}.mlp.{fc}.weight").T
            out[f"{o}/{fc}/bias"] = npy(f"{p}.mlp.{fc}.bias")
        n += 1
    return out


def convert_checkpoint(in_path: str, out_path: str) -> int:
    """Load a torch CLIP checkpoint on the host, convert its text tower,
    save the ``.npz``; the number of arrays written."""
    import torch

    from tdwss_torch.models.transformer import heads_of

    obj = torch.load(in_path, map_location="cpu")
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    state = {k: v.detach().cpu().numpy() for k, v in obj.items()
             if isinstance(v, torch.Tensor)}
    flat = convert_text_tower(
        state, heads_of(state["ln_final.weight"].shape[0]))
    np.savez(out_path, **flat)
    return len(flat)


if __name__ == "__main__":
    n = convert_checkpoint(sys.argv[1], sys.argv[2])
    print(f"wrote {n} arrays to {sys.argv[2]}")
