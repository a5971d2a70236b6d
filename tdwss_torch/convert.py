"""Flax variables <-> the port's ``state_dict``.

:func:`flax_to_state_dict` takes the reference model's ``params`` and
``batch_stats`` as nested dicts of numpy arrays (``jax.device_get``
output) and names them as the port's modules do;
:func:`state_dict_to_flax` is its inverse.

- Convolution kernels keep their (K, Cin, Cout) layout and tap order.
- Batch-norm and LayerNorm ``scale``/``bias`` become ``weight``/``bias``,
  batch-norm ``mean``/``var`` ``running_mean``/``running_var``.
- Dense kernels (the ``linear`` head, ``text_linear``, the text blocks'
  ``c_fc``/``c_proj``, KPFCNN's unary ``mlp``, the projector's
  ``matting/model``) are (in, out); ``nn.Linear``'s weight is (out, in).
- KPFCNN's kernel-point ``weights`` (K, Cin, Cout) and ``offset_bias``
  keep their names and layouts.
- The attention's ``query``/``key``/``value`` kernels (in, heads,
  head_dim) and biases (heads, head_dim), and its ``out`` kernel (heads,
  head_dim, out), become ``nn.Linear`` weights and biases over
  ``heads * head_dim``; the inverse reshapes with the reference's head
  count, ``max(1, width // 64)``.
- ``token_embedding/embedding`` is ``nn.Embedding``'s weight;
  ``positional_embedding`` keeps its name.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from tdwss_torch.models.transformer import heads_of

_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_DENSE = ("linear", "text_linear", "c_fc", "c_proj", "mlp")
_AS_IS = ("kernel", "bias", "weights", "offset_bias")
_ATTN = ("query", "key", "value", "out")


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _is_attn(owner: Tuple[str, ...]) -> bool:
    return len(owner) >= 2 and owner[-2] == "attn" and owner[-1] in _ATTN


def _is_dense(owner: Tuple[str, ...]) -> bool:
    return bool(owner) and (owner[-1] in _DENSE
                            or owner[-2:] == ("matting", "model"))


def flax_to_state_dict(params: Mapping,
                       batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(params):
        owner, name = path[:-1], path[-1]
        arr = np.asarray(leaf, np.float32)
        if _is_attn(owner) and name in ("kernel", "bias"):
            key = {"kernel": "weight", "bias": "bias"}[name]
            if name == "bias":
                arr = arr.reshape(-1)
            elif owner[-1] == "out":                 # (H, D, out)
                arr = arr.reshape(-1, arr.shape[-1]).T
            else:                                    # (in, H, D)
                arr = arr.reshape(arr.shape[0], -1).T
        elif _is_dense(owner):
            key = {"kernel": "weight", "bias": "bias"}[name]
            arr = arr.T if name == "kernel" else arr
        elif name == "embedding":
            key = "weight"
        elif name == "positional_embedding":
            key = name
        elif name == "scale":
            key = "weight"
        elif name in _AS_IS:
            key = name
        else:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        out[".".join(owner + (key,))] = torch.from_numpy(
            np.array(arr, order="C"))
    for path, leaf in _walk(batch_stats or {}):
        base = ".".join(path[:-1])
        out[f"{base}.{_BN_STATS[path[-1]]}"] = torch.from_numpy(
            np.array(leaf, np.float32, order="C"))
    return out


_BN_STATS_INV = {v: k for k, v in _BN_STATS.items()}


def _put(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict, Dict]:
    """The port's ``state_dict`` -> (params, batch_stats) as nested dicts
    of float32 numpy arrays in the reference's layout."""
    params: Dict = {}
    stats: Dict = {}
    for name, tensor in sd.items():
        owner, key = tuple(name.split(".")[:-1]), name.split(".")[-1]
        arr = tensor.detach().to("cpu", torch.float32).numpy().copy()
        if key in _BN_STATS_INV:
            _put(stats, owner + (_BN_STATS_INV[key],), arr)
        elif _is_attn(owner) and key == "bias":
            if owner[-1] != "out":                   # (H*D,) -> (H, D)
                arr = arr.reshape(heads_of(arr.shape[0]), -1)
            _put(params, owner + ("bias",), arr)
        elif _is_attn(owner) and key == "weight":
            if owner[-1] == "out":                   # (out, H*D)
                arr = arr.T.reshape(heads_of(arr.shape[1]), -1, arr.shape[0])
            else:                                    # (H*D, in)
                arr = arr.T.reshape(arr.shape[1], heads_of(arr.shape[0]), -1)
            _put(params, owner + ("kernel",), arr.copy())
        elif _is_dense(owner):
            _put(params, owner + ({"weight": "kernel", "bias": "bias"}[key],),
                 arr.T.copy() if key == "weight" else arr)
        elif owner and owner[-1] == "token_embedding" and key == "weight":
            _put(params, owner + ("embedding",), arr)
        elif key == "positional_embedding":
            _put(params, owner + (key,), arr)
        elif key == "weight":
            _put(params, owner + ("scale",), arr)
        elif key in _AS_IS:
            _put(params, owner + (key,), arr)
        else:
            raise KeyError(f"unexpected state_dict entry {name}")
    return params, stats
