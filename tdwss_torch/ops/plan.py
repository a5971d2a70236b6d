"""Plan containers (twins of :mod:`tdwss.ops.plan` and ``SparseGrid``),
and the device planner of the plans-free branch (:func:`build_plans`).

Plain dataclasses.  The host planner (:mod:`tdwss_torch.ops.host_plan`)
fills them with numpy arrays; :meth:`LevelPlans.to` moves every array
leaf to a torch device once per batch, upcasting the narrow ``rb_local``
dtypes (uint8 / int16, see :func:`tdwss_torch.data.plans._slim_win`) to
int32 on the way.  Field meanings are documented on the reference
classes (``tdwss/ops/plan.py:34,132,176,194``).

The windowed plans carry one field the reference lacks, ``spill_order``
(:class:`SpillOrder`): the live entries of every spill tier, laid out by
owner (the output row they add into) and by tap, built on the host with
the plan by the host planner, so that the spill kernels K8 and K9
(:mod:`tdwss_torch.ops.windowed`) sum every row's and every tap's spill
contributions in one fixed order without atomics; for a plan made
elsewhere without it, the routes build it when they apply the plan.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tdwss_torch.ops.coords import lookup_sorted, make_query_keys


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


# Most entries of one dW chunk of K9 (one tap and tier each): the heavy
# tier's tap-chunked companion holds chunks of this many entries
# (tdwss_torch.ops.host_plan._RES_HCHUNK), so its chunks are K9's.
SPILL_CHUNK = 512


@dataclass
class SpillOrder(_Leaves):
    """Port-only: the live entries of every spill tier of one windowed
    plan, laid out for the spill kernels (K8 ``spill_apply`` and K9
    ``spill_dw`` in :mod:`tdwss_torch.ops.windowed`).

    The tiers are read in the order ``ovf`` (``res_ovf``), ``tile``
    (``res_tile``, flattened) and ``heavy`` (``res_hent``, or its
    tap-chunked companion ``res_tent``: the same entries in the same order
    within an owner and within a tap); an entry is live
    where its owner (the output row it adds into) lies in the plan's
    output rows and its tap below the plan's tap count.  All int32.

    By owner (K8): ``owner`` (U,) the distinct owners, ascending;
    ``start`` (U + 1,) the first row of each owner's entries in
    ``entry`` (E, 2) [src, tap], which holds them tier by tier, in entry
    order within a tier.

    By tap (K9): ``tap_entry`` (E, 2) [src, owner], the same entries
    sorted by tap, tier by tier within a tap, in entry order within a
    tier; ``chunk`` (NCH + 1, 2) [first row, tier] of each chunk, a run
    of at most ``SPILL_CHUNK`` entries of one tap and one tier (the last
    row [E, -1]); ``tap_chunk`` (K + 1,) the first chunk of each tap.
    """

    owner: Optional[object] = None
    start: Optional[object] = None
    entry: Optional[object] = None
    tap_entry: Optional[object] = None
    chunk: Optional[object] = None
    tap_chunk: Optional[object] = None

    @property
    def entries(self) -> int:
        return 0 if self.entry is None else int(self.entry.shape[0])


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


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


def _tiers(plan, v_out: int):
    """Each present spill tier's entries as (owner, tap, src) int32
    columns, in tier order.  The heavy tier is read from ``res_hent``
    where present: its live rows are owner-sorted, and the tap-chunked
    companion holds the same rows sorted stably by tap."""
    tiers = []
    if plan.res_ovf is not None:
        ovf = _host(plan.res_ovf)
        tiers.append((ovf[:, 0], ovf[:, 1], ovf[:, 2]))
    if plan.res_tile is not None and plan.res_tile.shape[0]:
        rt = _host(plan.res_tile)
        tiers.append((tile_owners(rt, v_out), rt[..., 1].reshape(-1),
                      rt[..., 2].reshape(-1)))
    if plan.res_hent is not None:
        hent = _host(plan.res_hent)
        tiers.append((hent[:, 0], hent[:, 1], hent[:, 2]))
    elif plan.res_tent is not None and plan.res_tent.shape[0]:
        tent = _host(plan.res_tent)
        ttap = _host(plan.res_ttap)
        per = tent.shape[0] // max(ttap.shape[0], 1)
        tiers.append((tent[:, 1], np.repeat(ttap, per), tent[:, 0]))
    return tiers


def spill_order(plan) -> SpillOrder:
    """The :class:`SpillOrder` of a ``Windowed27`` / ``WindowedGather``
    plan, from its host (numpy or CPU tensor) spill tiers."""
    v_out, k = plan.rb_local.shape
    cols = [[], [], [], []]                       # owner, tap, src, tier
    for tier, (own, tap, src) in enumerate(_tiers(plan, v_out)):
        live = (own >= 0) & (own < v_out) & (tap >= 0) & (tap < k)
        for col, a in zip(cols, (own[live], tap[live], src[live],
                                 np.full(int(live.sum()), tier, np.int8))):
            col.append(a)
    own, tap, src = (np.concatenate(c).astype(np.int32, copy=False) if c
                     else np.zeros(0, np.int32) for c in cols[:3])
    tier = np.concatenate(cols[3]) if cols[3] else np.zeros(0, np.int8)
    # tiers are concatenated in order, so a stable sort keeps each key's
    # entries tier by tier and in entry order within a tier (the
    # planners' tiers are owner-sorted runs, which the stable sort merges
    # in linear time; taps fit int16, which numpy sorts by radix)
    by_own = np.argsort(own, kind="stable")
    sown = own[by_own]
    first = np.flatnonzero(np.diff(sown, prepend=-1))
    by_tap = np.argsort(tap.astype(np.int16), kind="stable")
    ttap, ttier = tap[by_tap], tier[by_tap]
    new_run = np.ones(ttap.size, bool)
    new_run[1:] = (ttap[1:] != ttap[:-1]) | (ttier[1:] != ttier[:-1])
    run_first = np.flatnonzero(new_run)
    run_pos = np.arange(ttap.size) - np.repeat(
        run_first, np.diff(np.append(run_first, ttap.size)))
    heads = np.flatnonzero(new_run | (run_pos % SPILL_CHUNK == 0))
    chunk = np.stack([np.append(heads, ttap.size),
                      np.append(ttier[heads], -1)], 1)
    i32 = functools.partial(np.asarray, dtype=np.int32)
    return SpillOrder(
        owner=sown[first], start=i32(np.append(first, own.size)),
        entry=np.stack([src[by_own], tap[by_own]], 1),
        tap_entry=np.stack([src[by_tap], own[by_tap]], 1),
        chunk=i32(chunk),
        tap_chunk=i32(np.searchsorted(ttap[heads], np.arange(k + 1))))


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


# ---------------------------------------------------------------------------
# The device planner of the plans-free branch (tdwss/ops/plan.py:202-323):
# each level's grid and rulebooks from the input grid, on the grid's
# device, with fixed shapes and no host synchronisation.
# ---------------------------------------------------------------------------


def _offsets4(kernel_size: int, device) -> torch.Tensor:
    """(K, 4) int32 offsets of :func:`tdwss_torch.ops.coords.kernel_offsets`
    (odd sizes centred, x slowest) with a zero scene column, made on ``device`` (no copy from the host,
    which would synchronise)."""
    r = torch.arange(kernel_size, dtype=torch.int32, device=device)
    if kernel_size % 2 == 1:
        r = r - kernel_size // 2
    grids = torch.meshgrid(r, r, r, indexing="ij")
    cols = [g.reshape(-1) for g in grids]
    return torch.stack(cols + [torch.zeros_like(cols[0])], dim=1)


def build_subm_rulebook(grid: SparseGrid, kernel_size: int = 3
                        ) -> torch.Tensor:
    """(V, K) int32 neighbour index per offset of a centred cubic kernel,
    -1 where there is none; the centre tap is the voxel itself (-1 at
    invalid rows).  All V * K queries run as one search."""
    k = kernel_size ** 3
    v = grid.capacity
    dev = grid.valid.device
    q = grid.coords.to(torch.int32)[:, None, :] + _offsets4(kernel_size,
                                                            dev)[None]
    qh, ql = make_query_keys(q.reshape(v * k, 4),
                             grid.valid[:, None].expand(v, k).reshape(-1))
    rb = lookup_sorted(grid.key_hi, grid.key_lo, qh, ql).reshape(v, k)
    # the zero offset: the middle of a centred (odd) kernel, else the first
    centre = k // 2 if kernel_size % 2 else 0
    own = torch.arange(v, dtype=torch.int32, device=dev)
    rb[:, centre] = torch.where(grid.valid, own, torch.full_like(own, -1))
    return rb


def _linear_child_offset(coords: torch.Tensor, stride: int) -> torch.Tensor:
    """Offset of a fine voxel within its parent cell, ``ox * f^2 + oy * f
    + oz`` (the order of :func:`kernel_offsets` for even sizes)."""
    c = coords.to(torch.int32) % stride
    return (c[:, 0] * stride * stride + c[:, 1] * stride
            + c[:, 2]).to(torch.int32)


def downsample_level(grid: SparseGrid, num_voxels: int, filter_size: int,
                     stride: int):
    """The next coarser level and the fine <-> coarse maps:
    ``(coarse_grid, parent (Vf,), child_offset (Vf,), down_rb (Vc, f^3))``
    (int32, -1 where a coarse cell lacks that child).  Only
    ``filter_size == stride``, as in the reference."""
    from tdwss_torch.ops.voxelize import voxelize

    if filter_size != stride:
        raise NotImplementedError(
            "strided conv with filter != stride is not used by the reference "
            "models (downsample=[2,2] or [4,4])")
    coords = grid.coords.to(torch.int32)
    coarse_coords = torch.cat([coords[:, :3] // stride, coords[:, 3:4]], 1)
    coarse_grid, _, parent = voxelize(coarse_coords, None, grid.valid,
                                      num_voxels)
    child_offset = _linear_child_offset(coords, stride)
    k = filter_size ** 3
    vf = grid.capacity
    # parent == num_voxels (an invalid fine row) lands in the dump slot
    flat = torch.where(parent < num_voxels, parent * k + child_offset,
                       torch.full_like(parent, num_voxels * k))
    down = torch.full((num_voxels * k + 1,), -1, dtype=torch.int32,
                      device=coords.device)
    down[flat.long()] = torch.arange(vf, dtype=torch.int32,
                                     device=coords.device)
    return (coarse_grid, parent, child_offset,
            down[:num_voxels * k].reshape(num_voxels, k))


def build_plans(grid0: SparseGrid, num_levels: int,
                capacities: Sequence[int],
                downsample: Tuple[int, int] = (2, 2),
                subm_kernel: int = 3) -> LevelPlans:
    """Every level's grid and rulebooks for an encoder forward, from the
    input grid (rulebook form: no windowed metadata)."""
    f, s = int(downsample[0]), int(downsample[1])
    levels = []
    grid = grid0
    for lvl in range(num_levels):
        subm_rb = build_subm_rulebook(grid, subm_kernel)
        coarse = parent = child_offset = down_rb = None
        if lvl + 1 < num_levels:
            coarse, parent, child_offset, down_rb = downsample_level(
                grid, int(capacities[lvl + 1]), f, s)
        levels.append(GridLevel(grid=grid, subm_rb=subm_rb, parent=parent,
                                child_offset=child_offset, down_rb=down_rb))
        if coarse is not None:
            grid = coarse
    return LevelPlans(levels=tuple(levels), downsample=(f, s))
