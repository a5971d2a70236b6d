"""The reduction of a trace to what the per-layer metrics read, on a
made-up event list (the CPU's profiler records no device activity), and
the conv layer's ranges marked on a real model step."""

import torch
from torch.autograd import DeviceType

from portbench import trace


class _Ev:
    def __init__(self, name, dev, s, e, tid=1, cid=0, linked=0, ann=False):
        self._v = (name, dev, s, e, tid, cid, linked, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[7]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type(
            "K", (), {"events": lambda s: events})()


def test_reduce_events():
    evs = [
        _Ev("step", False, 0, 1000, cid=1),
        _Ev(trace.CONV, False, 100, 400, cid=2),
        _Ev("aten::mm", False, 110, 150, cid=3),
        _Ev("cudaLaunchKernel", False, 120, 130, tid=99, cid=50, linked=3),
        _Ev("aten::add", False, 500, 520, cid=4),
        _Ev("cudaEventSynchronize", False, 600, 900, tid=99, cid=51, linked=1),
        # device: a conv kernel, an add kernel, the conv range's device copy
        _Ev("gemm", True, 200, 300, cid=60, linked=3),
        _Ev("add_kernel", True, 550, 560, cid=61, linked=4),
        _Ev("add_kernel", True, 950, 960, cid=62, linked=4),
        _Ev(trace.CONV, True, 200, 300, linked=2, ann=True),
    ]
    r = trace.reduce_events(_Prof(evs), max_gaps=1)
    assert r.device_ops == 3
    assert r.window_s == 1000 / 1e9
    assert r.busy_s == 120 / 1e9
    assert r.layer_device_s == {trace.CONV: 100 / 1e9}
    assert [n for n, _ in r.top_ops] == ["gemm", "add_kernel"]
    # the longer gap, while the host waited for an event (the runtime
    # call, filed under its op's thread); the other summed apart
    assert r.idle_by_host == [("cudaEventSynchronize", 390 / 1e9),
                              ("(the 1 shorter gaps)", 250 / 1e9)]


def test_conv_ranges_mark_forward_and_backward():
    from tdwss_torch.models.layers import SubmConv

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = SubmConv(4, 4)

        def forward(self, x, rb):
            return self.a(torch.relu(x), rb).sum()

    net, x = Net(), torch.randn(6, 4, requires_grad=True)
    rb = torch.randint(-1, 6, (6, 27), dtype=torch.int32)
    with trace.conv_ranges(net), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        net(x, rb).backward()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    # one forward range and at least one around the backward's nodes
    assert names.count(trace.CONV) >= 2
    assert not net.a._forward_hooks and not net.a._forward_pre_hooks
