"""The text cell (``text_fcnet.train``) at a tiny size on the CPU: the
loop is correct against the text reference, and not correct with the
program's text tower in bf16, with each scene paired with the next
scene's descriptions, or with half of each batch left out; the text
tower's ranges, its device time, the work count and the metric readers
on made-up inputs."""

import dataclasses
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, trace, trace_text
from portbench.reference.text_model import param_spec
from portbench.work import count
from portbench.work.text import fcn_ops, tower_work
from _tiny import tiny_cell
from test_portbench_trace import _Ev, _Prof
from tdwss_torch.utils import profiling

SEED = 2**31 + 77
NAME = "text_fcnet.train"


def tiny_text():
    """The cell at m=4, 2 rooms of 3,000 points a batch, a 2-layer tower
    of width 64 over 16 tokens, 4 descriptions a room, f32."""
    cell = tiny_cell(NAME)
    c = cell.config["config"]
    c["pointcloud_model"]["full_scale"] = 128
    c["text_model"].update(width=64, layers=2, context_length=16)
    c["text_data"].update(max_seq_len=16, cropped_texts=4)
    cell.mix.update(texts_per_scene=6)
    return cell


def _run(trace_=False):
    torch.set_num_threads(2)
    harness.isolate_caches()
    profiling.reset()
    try:
        return harness.run(tiny_text(), SEED, 0.5, trace_,
                           torch.device("cpu"), time.time())
    finally:
        profiling.reset()


@pytest.mark.parametrize("traced", [False, True])
def test_text_cell_runs_and_is_correct(traced):
    res = _run(traced)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) >= {"text_loss_gap", "text_feature_gap"}
    for c in res["checks"].values():
        assert c["value"] < c["limit"] / 10
    assert res["attempted"] > 0 and res["failed"] == 0
    # on the CPU nothing of the device: the readers read nothing there
    assert set(res["metrics"]) == (set() if traced else
                                   {"train_points_per_s", "setup_s"})


def _broken_step(monkeypatch, fault):
    import tdwss_torch.engine.train as train_mod

    real = train_mod.train_step

    def broken(cfg, model, optimizer, scheduler, batch, group=None):
        if fault == "rolled":
            text = batch.text
            batch = batch.replace(text=dataclasses.replace(
                text, tokens=text.tokens.roll(1, dims=0),
                valid=text.valid.roll(1, dims=0)))
        elif fault == "half_batch":
            mask = batch.scene_mask.clone()
            mask[mask.shape[0] // 2:] = False
            batch = batch.replace(scene_mask=mask)
        return real(cfg, model, optimizer, scheduler, batch, group=group)

    monkeypatch.setattr(train_mod, "train_step", broken)


@pytest.mark.parametrize("fault", ["rolled", "half_batch", "bf16_tower"])
def test_fault_is_not_correct(monkeypatch, fault):
    if fault == "bf16_tower":
        from tdwss_torch.models.transformer import TextTransformer

        real = TextTransformer.forward

        def bf16(self, text):
            with torch.autocast("cpu", dtype=torch.bfloat16):
                return real(self, text).float()

        monkeypatch.setattr(TextTransformer, "forward", bf16)
    else:
        _broken_step(monkeypatch, fault)
    res = _run()
    assert not res["correct"], res["checks"]
    if fault == "bf16_tower":
        c = res["checks"]["text_feature_gap"]
        assert c["value"] > c["limit"]


def test_tower_ranges_mark_the_backward():
    from tdwss_torch.models.transformer import TextTransformer, normal_linear

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.text_encoder = TextTransformer(8, 64, 2, 100)
            self.text_linear = normal_linear(64, 12, 0.1, None)

        def forward(self, tokens):
            with profiling.span(trace_text.SPAN):
                return self.text_linear(self.text_encoder(tokens))

    model = Model()
    tokens = torch.randint(1, 99, (3, 8))
    profiling.reset()
    with trace_text.tower_ranges(model), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        model(tokens).sum().backward()
    profiling.reset()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count(trace_text.SPAN) == 1
    # every node of the tower's backward, the embedding's included
    assert names.count(trace_text.BACKWARD) > 2 * 20
    assert not model.text_linear._forward_hooks


def test_tower_device_time_from_events():
    evs = [
        _Ev("step", False, 0, 1000, cid=1),
        _Ev(trace_text.SPAN, False, 100, 300, cid=2),
        _Ev("aten::mm", False, 110, 150, cid=3),
        _Ev(trace_text.BACKWARD, False, 500, 600, tid=7, cid=4),
        _Ev("aten::mm", False, 510, 520, tid=7, cid=5),
        _Ev("aten::add", False, 700, 710, cid=6),
        _Ev("cudaLaunchKernel", False, 120, 130, tid=99, cid=50, linked=3),
        _Ev("gemm", True, 200, 260, cid=60, linked=3),
        _Ev("gemm", True, 610, 640, cid=61, linked=5),
        _Ev("add", True, 720, 800, cid=62, linked=6),
    ]
    assert trace_text.tower_device_s(_Prof(evs)) == 90 / 1e9


def _ctx(**kw):
    cell = tiny_text()
    from tdwss_torch.config import config_from_dict

    base = dict(on_card=True, cfg=config_from_dict(cell.config["config"]),
                trace=trace.Reduced(busy_s=2.0, device_ops=10),
                tower_device_s=0.5, work={"tower": count.Work(1, 1, 0.05)},
                window_work=count.Work(flops=989e12 * 0.02), window_s=2.0,
                compute_dtype="bfloat16")
    return SimpleNamespace(**dict(base, **kw))


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_readers():
    profiling.reset()
    ctx = _ctx()
    # no program span and no counters (the parent): nothing to read
    for name in ("text_tower_share", "text_tower_roofline",
                 "text_live_token_share"):
        assert _read(name, ctx) is None
    assert _read("text_train_mfu", ctx) == pytest.approx(1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span(trace_text.SPAN):
            pass
        profiling.count("tdwss.text.rows", 10)
        profiling.count("tdwss.text.live_tokens", 40)
    try:
        assert _read("text_tower_share", ctx) == pytest.approx(25.0)
        assert _read("text_tower_roofline", ctx) == pytest.approx(10.0)
        # 40 live of 10 rows x 16 positions
        assert _read("text_live_token_share", ctx) == pytest.approx(25.0)
        off = _ctx(on_card=False, trace=trace.Reduced(),
                   tower_device_s=0.0)
        for name in ("text_tower_share", "text_tower_roofline",
                     "text_live_token_share", "text_train_mfu"):
            assert _read(name, off) is None
    finally:
        profiling.reset()


def test_tower_work_counts():
    tm = {"width": 64, "layers": 1, "context_length": 8}
    w = tower_work(tm, rows=3, embed=12)
    m = 3 * 8
    dense = 3 * 2 * m * (4 * 64 * 64 + 2 * 64 * 256)
    attention = 3 * 2 * 2 * 3 * 1 * (8 * 9 / 2) * 64
    assert w.flops == dense + attention + 3 * 2 * 3 * 64 * 12
    assert w.least_s == max(w.flops / count.PEAK_FLOPS["float32"],
                            w.bytes / count.HBM_BYTES_PER_S)


def test_fcn_ops_are_the_programs_convs():
    from tdwss_torch.config import config_from_dict
    from tdwss_torch.models.layers import StridedConv, SubmConv
    from tdwss_torch.models.meta_arch import build_model

    cfgd = tiny_text().config["config"]
    model = build_model(config_from_dict(cfgd), device="cpu")
    convs = [m for m in model.pc_encoder.modules()
             if isinstance(m, (SubmConv, StridedConv))]
    ops = fcn_ops(cfgd)
    assert len(ops) == len(convs) == 1 + 7 + 6
    assert [o.kind for o in ops].count("down") == 6
    assert set(param_spec(cfgd)) == {n for n, _ in model.named_parameters()}
