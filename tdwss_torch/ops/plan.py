"""Plan containers (twins of :mod:`tdwss.ops.plan` and ``SparseGrid``).

Plain dataclasses.  The host planner (:mod:`tdwss_torch.ops.host_plan`)
fills them with numpy arrays; :meth:`LevelPlans.to` moves every array
leaf to a torch device once per batch, upcasting the narrow ``rb_local``
dtypes (uint8 / int16, see :func:`tdwss_torch.data.plans._slim_win`) to
int32 on the way.  Field meanings are documented on the reference
classes (``tdwss/ops/plan.py:34,132,176,194``).

The windowed plans carry one field the reference lacks, ``spill_order``
(:class:`SpillOrder`): each spill tier's entries grouped by the output
row they add into, built on the host with the plan by the host planner,
so that the conv routes sum every row's spill contributions in one fixed
order without atomics (:func:`tdwss_torch.ops.sparse_conv._segment_sum`);
for a plan made elsewhere without it, the routes group the entries when
they apply them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _to_tensor(a, device, non_blocking: bool = False):
    """A numpy array or tensor on ``device``.  With ``non_blocking`` a host
    array is first copied into pinned memory, so that the copy to a card
    is asynchronous on the current stream (pinned blocks are freed only
    once that copy is done, by PyTorch's caching host allocator)."""
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if non_blocking and torch.device(device).type == "cuda" \
            and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _rb32(a, device, non_blocking: bool = False):
    """rb_local leaf -> int32 tensor on ``device`` (uint8/int16 upcast)."""
    t = _to_tensor(a, device, non_blocking)
    return t if t.dtype == torch.int32 else t.to(torch.int32)


class _Leaves:
    """``replace`` and ``to`` over array leaves, shared by the plan types."""

    _RB_FIELDS: Tuple[str, ...] = ()

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device, non_blocking: bool = False):
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in self._RB_FIELDS:
                kw[f.name] = (_rb32(v, device, non_blocking)
                              if v is not None else None)
            elif isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
                kw[f.name] = _to_tensor(np.asarray(v)
                                        if isinstance(v, np.generic) else v,
                                        device, non_blocking)
            elif isinstance(v, _Leaves):
                kw[f.name] = v.to(device, non_blocking)
        return dataclasses.replace(self, **kw)


@dataclass
class SparseGrid(_Leaves):
    """Key-sorted static-capacity voxel set (``tdwss/ops/voxelize.py:28``).

    coords (V, 4) int32 [x, y, z, b]; key_hi/key_lo (V,) int32; valid (V,)
    bool; counts (V,) int32; num_valid () int32 (may exceed V on overflow).
    """

    coords: object
    key_hi: object
    key_lo: object
    valid: object
    counts: object
    num_valid: object

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


@dataclass
class SpillOrder(_Leaves):
    """Port-only: the entries of each spill tier of one windowed plan,
    grouped by owner (the output row they add into).

    For a tier, ``<tier>_owner`` (U,) int32 holds its distinct owners in
    ascending order and ``<tier>_index`` (U, D) int32 the rows of the
    tier's entry list that add into each, in entry order; a short group
    is padded with the entry count (one past the last entry, a zero row).
    An entry whose owner is outside the plan's output rows belongs to no
    group.  The tiers are ``ovf`` (``res_ovf``), ``tile``
    (``res_tile``, flattened) and ``heavy`` (``res_tent`` where the
    tap-chunked companion is present, else ``res_hent``); None where the
    plan has no such tier.
    """

    ovf_owner: Optional[object] = None
    ovf_index: Optional[object] = None
    tile_owner: Optional[object] = None
    tile_index: Optional[object] = None
    heavy_owner: Optional[object] = None
    heavy_index: Optional[object] = None


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def owner_groups(owners, v_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(owner (U,), index (U, D)) of an entry list's owner column, as in
    :class:`SpillOrder` (stable: entry order within each owner)."""
    own = _host(owners).reshape(-1).astype(np.int64)
    rows = np.nonzero((own >= 0) & (own < v_out))[0]
    rows = rows[np.argsort(own[rows], kind="stable")]
    uniq, first, count = np.unique(own[rows], return_index=True,
                                   return_counts=True)
    depth = int(count.max()) if count.size else 1
    index = np.full((uniq.size, depth), own.size, np.int32)
    group = np.repeat(np.arange(uniq.size), count)
    index[group, np.arange(rows.size) - first[group]] = rows
    return uniq.astype(np.int32), index


def tile_owners(res_tile, v_out: int) -> np.ndarray:
    """Owner of every slot of a tile-grouped spill tier (T2, R, 3)
    [local, tap, src], flattened; a padding slot gets ``v_out``."""
    rt = _host(res_tile)
    t2 = rt.shape[0]
    t_res = v_out // t2
    local = rt[..., 0].astype(np.int64)
    owners = np.where(local < t_res,
                      np.arange(t2, dtype=np.int64)[:, None] * t_res + local,
                      v_out)
    return owners.reshape(-1)


def spill_order(plan) -> SpillOrder:
    """The :class:`SpillOrder` of a ``Windowed27`` / ``WindowedGather``
    plan, from its host (numpy or CPU tensor) spill tiers."""
    v_out = plan.rb_local.shape[0]
    kw = {}
    if plan.res_ovf is not None:
        kw["ovf_owner"], kw["ovf_index"] = owner_groups(
            _host(plan.res_ovf)[:, 0], v_out)
    if plan.res_tile is not None and plan.res_tile.shape[0]:
        kw["tile_owner"], kw["tile_index"] = owner_groups(
            tile_owners(plan.res_tile, v_out), v_out)
    if plan.res_tent is not None and plan.res_tent.shape[0]:
        kw["heavy_owner"], kw["heavy_index"] = owner_groups(
            _host(plan.res_tent)[:, 1], v_out)
    elif plan.res_hent is not None:
        kw["heavy_owner"], kw["heavy_index"] = owner_groups(
            _host(plan.res_hent)[:, 0], v_out)
    return SpillOrder(**kw)


def with_spill_order(plan):
    """``plan`` with its ``spill_order`` filled in (None passes through)."""
    if plan is None or plan.spill_order is not None:
        return plan
    return plan.replace(spill_order=spill_order(plan))


@dataclass
class Windowed27(_Leaves):
    """27-tap windowed submanifold-conv metadata (``tdwss/ops/plan.py:34``).

    starts (tiles, nwin) window starts; rb_local (V, 27) window-local
    source positions (sentinel == window, or == subwin in the sub form);
    sub_off (V/sub, nwin) sub-window offsets; the res_* / ovf_* arrays
    are the spill tiers, which together with the windows cover the
    rulebook exactly; ``spill_order`` (port-only) groups the spill
    entries by owner.
    """

    _RB_FIELDS = ("rb_local",)

    starts: object
    rb_local: object
    res_ovf: object
    ovf_v: object
    ovf_count: object
    res_tile: Optional[object] = None
    res_hent: Optional[object] = None
    res_htile: Optional[object] = None
    res_tent: Optional[object] = None
    res_ttap: Optional[object] = None
    res_tperm: Optional[object] = None
    window: int = 512
    sub_off: Optional[object] = None
    sub: int = 0
    subwin: int = 0
    v_active: int = 0
    spill_order: Optional[SpillOrder] = None


@dataclass
class WindowedGather(_Leaves):
    """Windowed evaluation of a cross-level (V_out, K) rulebook
    (``tdwss/ops/plan.py:132``); fields as :class:`Windowed27` plus the
    static source capacity ``v_src``."""

    _RB_FIELDS = ("rb_local",)

    starts: object
    rb_local: object
    res_ovf: object
    ovf_v: object
    ovf_count: object
    res_tile: Optional[object] = None
    res_hent: Optional[object] = None
    res_htile: Optional[object] = None
    res_tent: Optional[object] = None
    res_ttap: Optional[object] = None
    res_tperm: Optional[object] = None
    window: int = 512
    v_src: int = 0
    sub_off: Optional[object] = None
    sub: int = 0
    subwin: int = 0
    spill_order: Optional[SpillOrder] = None


@dataclass
class GridLevel(_Leaves):
    grid: SparseGrid
    subm_rb: object                          # (V, 27) neighbour idx or -1
    parent: Optional[object]                 # (V,) idx into next level
    child_offset: Optional[object]           # (V,) offset within parent
    down_rb: Optional[object]                # (V_next, f^3) idx into this
    win: Optional[Windowed27] = None
    wg_down: Optional[WindowedGather] = None
    wg_up: Optional[WindowedGather] = None


@dataclass
class LevelPlans:
    levels: Tuple[GridLevel, ...]
    downsample: Tuple[int, int]

    def __len__(self) -> int:
        return len(self.levels)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device, non_blocking: bool = False) -> "LevelPlans":
        return dataclasses.replace(
            self, levels=tuple(lvl.to(device, non_blocking)
                               for lvl in self.levels))


def level_capacities(
    base_capacity: int,
    num_levels: int,
    shrink: int = 2,
    min_capacity: int = 2048,
    schedule: Optional[Sequence[int]] = None,
) -> Tuple[int, ...]:
    """Static voxel capacity per level (``tdwss/ops/plan.py:258``)."""
    caps = []
    cap = base_capacity
    for lvl in range(num_levels):
        caps.append(max(int(cap), min(min_capacity, base_capacity)))
        div = schedule[min(lvl, len(schedule) - 1)] if schedule else shrink
        cap = cap // max(int(div), 1)
    return tuple(caps)
