"""Flax variables <-> the port's ``state_dict``.

:func:`flax_to_state_dict` takes the reference model's ``params`` and
``batch_stats`` as nested dicts of numpy arrays (``jax.device_get``
output) and names them as the port's modules do;
:func:`state_dict_to_flax` is its inverse.  Convolution kernels keep their (K, Cin, Cout) layout
and tap order; batch-norm ``scale``/``bias``/``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var``; the ``linear``
head's (in, out) kernel becomes ``nn.Linear``'s (out, in) weight.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def flax_to_state_dict(params: Mapping,
                       batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(params):
        owner, name = path[:-1], path[-1]
        base = ".".join(owner)
        arr = np.asarray(leaf, np.float32)
        if owner and owner[-1] == "linear":
            key = {"kernel": "weight", "bias": "bias"}[name]
            arr = arr.T if name == "kernel" else arr
        elif name == "scale":
            key = "weight"
        elif name in ("kernel", "bias"):
            key = name
        else:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        out[f"{base}.{key}"] = torch.from_numpy(np.array(arr, order="C"))
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
        elif owner and owner[-1] == "linear":
            _put(params, owner + ({"weight": "kernel", "bias": "bias"}[key],),
                 arr.T.copy() if key == "weight" else arr)
        elif key == "weight":
            _put(params, owner + ("scale",), arr)
        elif key in ("kernel", "bias"):
            _put(params, owner + (key,), arr)
        else:
            raise KeyError(f"unexpected state_dict entry {name}")
    return params, stats
