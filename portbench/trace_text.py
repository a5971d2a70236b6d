"""The traced window of a text cell: the text tower's device time.

The tower's forward (with ``text_linear``) is the program's own span
``tdwss.text.tower`` (a ``record_function`` on the loop's thread while
the profiler records).  Its backward is marked here as
:mod:`portbench.trace` marks the conv layer's, with public mechanisms
only: a forward hook on the model's ``text_linear`` puts a pre-hook and
a hook on every autograd node between its output and the leaves (the
weights' accumulation left out), each opening and closing a
``record_function`` named ``portbench:text_tower`` (its ``_Ranges``).

:func:`tower_device_s` sums the device time of the operations launched
inside either range, as :func:`portbench.trace.reduce_events` sums the
conv layer's.  A program without the span gives 0 for the forward: the
metric readers read nothing there.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

from portbench import trace

SPAN = "tdwss.text.tower"
BACKWARD = "portbench:text_tower"
# the tower's backward graph: about 30 nodes a layer
MAX_NODES = 4096


@contextlib.contextmanager
def tower_ranges(model):
    """Mark the tower's backward ranges in ``model``'s steps while the
    block runs."""
    r = trace._Ranges()

    def post(m, args, out):
        if not torch.is_grad_enabled():
            return
        for node in trace._region_nodes(out, (), limit=MAX_NODES):
            key = ("bwd", id(node))

            def pre(grad_outputs, key=key):
                r.enter(key, BACKWARD)

            def done(grad_inputs, grad_outputs, key=key):
                r.leave(key)

            node.register_prehook(pre)
            node.register_hook(done)

    r.handles.append(model.text_linear.register_forward_hook(post))
    try:
        yield
    finally:
        for h in r.handles:
            h.remove()
        for key in list(r.open):
            r.leave(key)


def tower_device_s(prof) -> float:
    """Device seconds of the operations launched inside the tower's
    forward span or its backward ranges."""
    dev, cpu_by_id, ranges = [], {}, defaultdict(list)
    for name, on_dev, s, e, tid, cid, linked in trace._raw_events(prof):
        if on_dev:
            dev.append((s, e, linked))
        elif linked <= 0:
            cpu_by_id[cid] = (s, tid)
            if name in (SPAN, BACKWARD):
                ranges[tid].append((s, e))
    spans = {tid: sorted(v) for tid, v in ranges.items()}
    total = 0
    for s, e, linked in dev:
        host = cpu_by_id.get(linked)
        if host is None or host[1] not in spans:
            continue
        t, v = host[0], spans[host[1]]
        i = bisect.bisect_right(v, (t, float("inf"))) - 1
        if i >= 0 and v[i][0] <= t <= v[i][1]:
            total += e - s
    return total / 1e9
