"""The traced window: marking the conv layer, and reducing the profiler's
events to what the per-layer metrics read.

:func:`conv_ranges` marks, with public mechanisms only, the host ranges
in which the model's convolutions run:

- forward: a forward pre-hook and hook on each ``SubmConv``,
  ``StridedConv``, ``Deconv`` and ``NetworkInNetwork`` module; and the
  direct up-pool's unpool, from the forward hook of a body's ``inner``
  (which has just returned) to the body's own forward hook (the unpool
  is the only work in between when the body's output is as wide as its
  inner output);
- backward: a pre-hook and a hook on every autograd node between such a
  region's output and its inputs (the weights' accumulation left out).

Each range is a ``torch.profiler.record_function`` named
``portbench:conv`` or ``portbench:unpool``; a device operation belongs
to the layer when the host op that launched it lies inside one.  What
it may miss: a kernel a conv route launches from another thread, and
the work autograd does between nodes.

:func:`reduce_events` reads the profiler's raw event list once.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

CONV, UNPOOL = "portbench:conv", "portbench:unpool"


def _region_nodes(output, inputs, limit: int = 64):
    """The autograd nodes from ``output``'s back to ``inputs``' (not
    included), without the leaves' accumulation nodes."""
    stop = {t.grad_fn for t in inputs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None}
    start = getattr(output, "grad_fn", None)
    seen, todo = [], [start] if start is not None else []
    while todo and len(seen) < limit:
        node = todo.pop()
        if node in stop or node in seen \
                or type(node).__name__ == "AccumulateGrad":
            continue
        seen.append(node)
        todo.extend(n for n, _ in node.next_functions if n is not None)
    return seen


class _Ranges:
    def __init__(self):
        self.open: Dict[int, object] = {}
        self.handles = []

    def enter(self, key, name):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self.open[key] = rf

    def leave(self, key):
        rf = self.open.pop(key, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def backward(self, output, inputs, name):
        for node in _region_nodes(output, inputs):
            key = ("bwd", id(node))

            def pre(grad_outputs, key=key):
                self.enter(key, name)

            def post(grad_inputs, grad_outputs, key=key):
                self.leave(key)

            node.register_prehook(pre)
            node.register_hook(post)


@contextlib.contextmanager
def conv_ranges(model):
    """Mark the conv layer's host ranges in ``model``'s steps (see the
    module docstring) while the block runs."""
    from tdwss_torch.models.layers import (Deconv, NetworkInNetwork,
                                           StridedConv, SubmConv)

    r = _Ranges()
    convs = (SubmConv, StridedConv, Deconv, NetworkInNetwork)
    for mod in model.modules():
        if isinstance(mod, convs):
            def pre(m, args):
                r.enter(("fwd", id(m)), CONV)

            def post(m, args, out):
                r.leave(("fwd", id(m)))
                if torch.is_grad_enabled():
                    r.backward(out, args, CONV)

            r.handles += [mod.register_forward_pre_hook(pre),
                          mod.register_forward_hook(post)]
        inner = getattr(mod, "inner", None)
        if isinstance(inner, torch.nn.Module) and hasattr(mod, "down_conv") \
                and not hasattr(mod, "up_deconv"):
            def after_inner(m, args, out, body=mod):
                body._portbench_inner = out
                r.enter(("unpool", id(body)), UNPOOL)

            def after_body(m, args, out):
                inner_out = getattr(m, "_portbench_inner", None)
                r.leave(("unpool", id(m)))
                m._portbench_inner = None
                if torch.is_grad_enabled() and inner_out is not None \
                        and out.shape[-1] == inner_out.shape[-1]:
                    r.backward(out, (inner_out,), UNPOOL)

            # the body's own hook runs before the one its parent put on
            # it, so that the ranges nest
            r.handles += [inner.register_forward_hook(after_inner),
                          mod.register_forward_hook(after_body,
                                                    prepend=True)]
    try:
        yield
    finally:
        for h in r.handles:
            h.remove()
        for key in list(r.open):
            r.leave(key)


@dataclass
class Reduced:
    """What the trace shows of a window."""

    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: int = 0
    layer_device_s: Dict[str, float] = field(default_factory=dict)
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_by_host: List[Tuple[str, float]] = field(default_factory=list)


def _raw_events(prof):
    """(name, on_device, start_ns, end_ns, thread, id, linked_id) of every
    event of the profile but the device's copies of host ranges."""
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        if dev and e.is_user_annotation():
            continue
        yield (e.name(), dev, e.start_ns(), e.end_ns(),
               e.start_thread_id(), e.correlation_id(),
               e.linked_correlation_id())


def _union(spans):
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, a))
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def reduce_events(prof, max_gaps: int = 4000, top: int = 10) -> Reduced:
    """Busy time (the union of device activity), device operations,
    device time per marked layer, the operations that took most time,
    and idle time by the innermost host op running on a launching thread
    (the longest ``max_gaps`` gaps; the others summed as one entry)."""
    dev, cpu_by_id, ranges = [], {}, defaultdict(list)
    ops, runtime = [], []
    lo, hi = None, None
    for name, on_dev, s, e, tid, cid, linked in _raw_events(prof):
        lo = s if lo is None else min(lo, s)
        hi = e if hi is None else max(hi, e)
        if on_dev:
            dev.append((s, e, name, linked))
        elif linked > 0:
            # a runtime call (launch, copy, synchronise), linked to the op
            # that made it; its own thread id is numbered apart
            runtime.append((s, e, name, linked))
        else:
            cpu_by_id[cid] = (s, tid)
            if name in (CONV, UNPOOL):
                ranges[(tid, name)].append((s, e))
            else:
                ops.append((s, e, name, tid))
    by_thread = defaultdict(list)
    for s, e, name, tid in ops:
        by_thread[tid].append((s, e, name))
    for s, e, name, linked in runtime:
        if linked in cpu_by_id:
            by_thread[cpu_by_id[linked][1]].append((s, e, name))
    launch_threads = {cpu_by_id[linked][1] for _, _, _, linked in dev
                      if linked in cpu_by_id}
    out = Reduced()
    if not dev:
        return out
    out.window_s = (hi - lo) / 1e9
    out.device_ops = len(dev)
    dev.sort()
    busy, gaps = _union((s, e) for s, e, _, _ in dev)
    out.busy_s = busy / 1e9
    per_name = defaultdict(float)
    for s, e, name, _ in dev:
        per_name[name] += (e - s) / 1e9
    out.top_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]

    starts = {k: sorted(v) for k, v in ranges.items()}
    layer = defaultdict(float)
    for s, e, _, linked in dev:
        host = cpu_by_id.get(linked)
        if host is None:
            continue
        t, tid = host
        for name in (CONV, UNPOOL):
            spans = starts.get((tid, name))
            if not spans:
                continue
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                layer[name] += (e - s) / 1e9
                break
    out.layer_device_s = dict(layer)

    threads = {tid: sorted(v) for tid, v in by_thread.items()
               if tid in launch_threads}
    idle = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:max_gaps]:
        mid = (a + b) // 2
        best = None
        for evs in threads.values():
            i = bisect.bisect_right(evs, (mid, float("inf"), "")) - 1
            for j in range(i, max(i - 2000, -1), -1):
                if evs[j][1] >= mid:
                    if best is None or evs[j][0] > best[0]:
                        best = evs[j]
                    break
        idle[best[2] if best else "(no host op)"] += (b - a) / 1e9
    rest = (sum(b - a for a, b in gaps) / 1e9) - sum(idle.values())
    if len(gaps) > max_gaps:
        idle[f"(the {len(gaps) - max_gaps} shorter gaps)"] = rest
    out.idle_by_host = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return out
