"""Name -> (object, metadata) registries (twin of :mod:`tdwss.registry`).

A :class:`Registry` maps a name to an object and the keyword metadata it
was registered with (``embed_length=lambda m: ...``,
``reads_point_coords=True``).  Registration is by decorator or by a
direct call; a lookup falls back to ``<name>_3d``; a duplicate or a miss
raises ``KeyError`` with the reference's wording.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple


class Registry:
    """A name -> (obj, meta) mapping that other modules extend.

    Usage::

        MODEL_REGISTRY = Registry("model")

        @MODEL_REGISTRY.register(embed_length=lambda m: m)
        class SparseConvUNet: ...

        cls, meta = MODEL_REGISTRY.get("SparseConvUNet")
    """

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Tuple[Any, Dict[str, Any]]] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Any, suffix: Optional[str],
                     meta: Dict[str, Any]) -> None:
        if isinstance(suffix, str):
            name = f"{name}_{suffix}"
        if name in self._obj_map:
            raise KeyError(f"An object named '{name}' was already registered "
                           f"in '{self._name}' registry!")
        self._obj_map[name] = (obj, meta)

    def register(self, obj: Any = None, suffix: Optional[str] = None,
                 **meta: Any):
        """Register ``obj`` under ``obj.__name__``; decorator or direct
        call."""
        if obj is None:
            def deco(func_or_class):
                self._do_register(func_or_class.__name__, func_or_class,
                                  suffix, meta)
                return func_or_class

            return deco
        self._do_register(obj.__name__, obj, suffix, meta)
        return obj

    def get(self, name: str, suffix: str = "3d") -> Tuple[Any, Dict[str, Any]]:
        ret = self._obj_map.get(name)
        if ret is None:
            ret = self._obj_map.get(f"{name}_{suffix}")
        if ret is None:
            raise KeyError(f"No object named '{name}' found in "
                           f"'{self._name}' registry!")
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Tuple[Any, Dict[str, Any]]]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


DATASET_REGISTRY = Registry("dataset")
ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
