"""The program's spans and counters (``tdwss_torch.utils.profiling``) on
the CPU, without JAX, around a tiny ``Trainer`` (SparseConvFCNet, m=4,
depth 2, 4 synthetic scenes of 4,000 points, batches of 2, 4 collate
threads, f32):

- with no profiler, an epoch runs with ``torch.profiler.record_function``
  and ``time.time_ns`` patched to raise, and records nothing;
- under ``torch.profiler.profile`` an epoch records every span of the
  loop: one batch's spans share its key across the collate threads, the
  prefetch thread and the loop's thread; the forward, backward and
  optimizer spans are children of their step; the epoch holds its waits,
  steps and card waits; each span of the loop's thread lies inside the
  profiler's event of the same name (1 ms from its ends at the median),
  and the loader threads' records inside the profiler's window (one
  Unix-ns clock);
- the sticky plan registry counts its ratchets, and no thread's span,
  count or ratchet is lost;
- the profiler flags the recorder reads exist and follow the profiler;
- ``chip_smoke.py``'s profile phase files device time by these spans;
- a windowed subm conv's forward and backward count
  ``tdwss.conv.spill_entries``, the plan's live spill entries once per
  pass (forward, dfeats, dW), and record the spill kernels' spans.
"""

import os
import statistics
import sys
import threading
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tdwss_torch.config import load_config
from tdwss_torch.data.loader import train_batches
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.engine.train import Trainer
from tdwss_torch.ops.host_plan import reset_sticky_plans
from tdwss_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP_SPANS = {"tdwss.train.epoch", "tdwss.train.step", "tdwss.train.forward",
              "tdwss.train.backward", "tdwss.train.optimizer",
              "tdwss.train.card_wait", "tdwss.loader.wait",
              "tdwss.loader.batch", "tdwss.loader.collate",
              "tdwss.loader.plan", "tdwss.loader.copy"}
OP_SPANS = {"tdwss.bn", "tdwss.conv.backward", "tdwss.kernel.spill_apply",
            "tdwss.kernel.spill_dw"}


def _cfg(**engine):
    cfg = load_config(os.path.join(REPO, "configs", "smoke_cpu.yaml"),
                      training_name="tracing")
    cfg.pointcloud_model.depth = 2
    cfg.pointcloud_model.full_scale = 128
    cfg.pointcloud_data.scale = 10
    cfg.engine.max_points = 8192
    cfg.engine.min_level_capacity = 256
    cfg.engine.collate_workers = 4
    for k, v in engine.items():
        setattr(cfg.engine, k, v)
    return cfg


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("tracing"))
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        reset_sticky_plans()
        scenes = make_dataset(4, num_points=4000, seed=31, with_text=False)
        yield Trainer(_cfg(), scenes, [], use_checkpoints=False,
                      verbose=False, device="cpu")


def _boom(*args, **kwargs):
    raise AssertionError("called with no profiler recording")


def test_off_reads_no_clock_and_enters_no_record_function(trainer,
                                                          monkeypatch):
    profiling.reset()
    # the name the recorder calls (PyTorch's optimisers enter
    # torch.autograd.profiler.record_function themselves, profiler or not)
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(time, "time_ns", _boom)
    assert not profiling.recording()
    loss = trainer.run_epoch(1)
    monkeypatch.undo()
    assert loss > 0
    assert profiling.spans() == [] and profiling.span_totals() == {}
    assert profiling.counters() == {}


@pytest.fixture(scope="module")
def traced(trainer):
    profiling.reset()
    lo = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run_epoch(2)
    hi = time.time_ns()
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return dict(spans=profiling.spans(), totals=profiling.span_totals(),
                events=events, window=(lo, hi),
                thread=threading.get_ident())


def test_every_span_recorded(traced):
    names = {s.name for s in traced["spans"]}
    assert LOOP_SPANS | OP_SPANS <= names
    assert any(n.startswith("tdwss.kernel.windowed_") for n in names)
    assert not [s for s in traced["spans"]
                if s.name.startswith("tdwss.") and s.end_ns < s.start_ns]


def test_one_key_per_batch_across_threads(traced):
    spans = traced["spans"]

    def keys(name):
        return Counter(s.key for s in spans if s.name == name)

    steps = keys("tdwss.train.step")
    assert sorted(steps) == [(2, 0), (2, 1)]
    assert set(steps.values()) == {1}
    waits, batches = keys("tdwss.loader.wait"), keys("tdwss.loader.batch")
    for name in ("tdwss.loader.batch", "tdwss.loader.collate",
                 "tdwss.loader.plan", "tdwss.loader.copy"):
        assert keys(name) == steps, name
    # the loop's waits: one per batch, and the one for the epoch's end
    assert waits == steps + Counter({(2, 2): 1})
    main = traced["thread"]
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, set()).add(s.thread)
    assert by_name["tdwss.train.step"] == {main}
    assert by_name["tdwss.loader.wait"] == {main}
    assert main not in by_name["tdwss.loader.batch"]
    assert main not in by_name["tdwss.loader.copy"]
    assert not by_name["tdwss.loader.batch"] & by_name["tdwss.loader.copy"]
    assert batches == steps


def test_step_parts_are_children_of_their_step(traced):
    spans = traced["spans"]
    step_ids = {s.id for s in spans if s.name == "tdwss.train.step"}
    for name in ("tdwss.train.forward", "tdwss.train.backward",
                 "tdwss.train.optimizer"):
        parents = [s.parent for s in spans if s.name == name]
        assert sorted(parents) == sorted(step_ids), name
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("tdwss.loader.collate", "tdwss.loader.plan"):
            assert by_id[s.parent].name == "tdwss.loader.batch"
            assert by_id[s.parent].key == s.key


def test_epoch_holds_its_waits_steps_and_card_waits(traced):
    t = traced["totals"]
    assert t["tdwss.train.epoch"]["count"] == 1
    parts = sum(t[n]["total_s"] for n in ("tdwss.loader.wait",
                                          "tdwss.train.step",
                                          "tdwss.train.card_wait"))
    assert t["tdwss.train.epoch"]["total_s"] >= parts
    for name, tot in t.items():
        assert 0 <= tot["self_s"] <= tot["total_s"], name
    step = t["tdwss.train.step"]
    inner = sum(t[n]["total_s"] for n in ("tdwss.train.forward",
                                          "tdwss.train.backward",
                                          "tdwss.train.optimizer"))
    assert step["self_s"] == pytest.approx(step["total_s"] - inner,
                                           abs=1e-6)


def test_records_share_the_profilers_clock(traced):
    events = {}
    for name, s, e in traced["events"]:
        events.setdefault(name, []).append((s, e))
    main = [s for s in traced["spans"] if s.thread == traced["thread"]]
    assert {s.name for s in main} >= {"tdwss.train.epoch", "tdwss.bn",
                                      "tdwss.loader.wait"}
    # the span's clock reads lie inside its record_function's event (the
    # profiler stamps it first and last); 1 ms apart at the median (one
    # span may wait out a busy host's scheduler between the two)
    gaps = []
    for sp in main:
        s, e = min(events.get(sp.name, [(0, 0)]),
                   key=lambda ev: abs(ev[0] - sp.start_ns))
        assert s <= sp.start_ns <= sp.end_ns <= e, sp
        gaps += [sp.start_ns - s, e - sp.end_ns]
    assert statistics.median(gaps) < 1e6
    lo, hi = traced["window"]
    workers = [s for s in traced["spans"] if s.thread != traced["thread"]]
    assert workers
    for sp in workers:
        assert lo <= sp.start_ns <= sp.end_ns <= hi, sp
        # the profiler follows no thread started inside it
        assert sp.name not in events


def test_plan_registry_counts_its_ratchets():
    scenes = make_dataset(2, num_points=4000, seed=5, with_text=False)
    cfg = _cfg(collate_workers=1)
    reset_sticky_plans()
    counts = []
    for _ in range(2):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            next(iter(train_batches(scenes, cfg, 1, prefetch=False)))
        counts.append(profiling.counters().get("tdwss.plan.ratchets", 0))
    assert counts[0] >= 1 and counts[1] == 0
    reset_sticky_plans()


def test_recorder_loses_no_update_across_threads():
    """More threads than cores, switching often: every span, count and
    ratchet of every thread lands in the totals."""
    from tdwss_torch.ops import host_plan

    nthreads, n = 2 * (os.cpu_count() or 1) + 2, 200
    old = sys.getswitchinterval()
    reset_sticky_plans()
    profiling.reset()

    def work(t):
        for i in range(n):
            with profiling.span("tdwss.stress", (t, i)):
                profiling.count("tdwss.stress")
            host_plan._sticky_raw(("stress", t, i), 1)

    try:
        sys.setswitchinterval(1e-6)
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(nthreads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        reset_sticky_plans()
    assert not any(th.is_alive() for th in threads)
    assert profiling.span_totals()["tdwss.stress"]["count"] == nthreads * n
    assert profiling.counters() == {"tdwss.stress": nthreads * n,
                                    "tdwss.plan.ratchets": nthreads * n}
    assert len({s.id for s in profiling.spans()}) == nthreads * n


def test_profiler_flags_follow_the_profiler():
    """The recorder's switch is the autograd profiler's process-wide flag
    and, for ``record_function``, its thread-local one."""
    flag = torch.autograd.profiler

    def thread_local():
        return torch._C._autograd._profiler_enabled()

    assert flag._is_profiler_enabled is False and not thread_local()
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag._is_profiler_enabled is True and thread_local()
        assert profiling.recording()
        t = threading.Thread(target=lambda: seen.append(
            (profiling.recording(), thread_local())))
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and seen == [(True, False)]
    assert flag._is_profiler_enabled is False and not profiling.recording()


def test_chip_smoke_categories_read_the_spans():
    sys.path.insert(0, REPO)
    import chip_smoke
    from tdwss_torch.models.layers import MaskedBatchNorm

    bn = MaskedBatchNorm(4)
    x, valid = torch.randn(16, 4), torch.ones(16, dtype=torch.bool)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("tdwss.kernel.windowed_matmul_sub"):
            x.float().sum()
        bn(x, valid, use_running_average=False)
    cats = {}
    for e in prof.events():
        if e.name.startswith("aten::") and e.cpu_parent is not None:
            cats.setdefault(chip_smoke._category(e, ""), 0)
    assert {"batch norm forward", "kernel wrappers' own ops"} <= set(cats)


def test_spill_passes_count_their_entries():
    import numpy as np

    from tdwss_torch.ops.host_plan import (build_subm_rulebook_np,
                                           build_windowed_subm27,
                                           voxelize_np)
    from tdwss_torch.ops.sparse_conv import subm_conv_apply

    rng = np.random.default_rng(3)
    n = 2048
    coords = np.concatenate([rng.integers(0, 16, (n, 3)),
                             rng.integers(0, 2, (n, 1))], 1).astype(np.int32)
    grid, _, _ = voxelize_np(coords, None, rng.random(n) > 0.05, n)
    reset_sticky_plans()
    win = build_windowed_subm27(build_subm_rulebook_np(grid, 3), grid,
                                tile=512, window=96).to("cpu")
    reset_sticky_plans()
    entries = win.spill_order.entries
    assert entries > 0
    feats = torch.randn(n, 4, requires_grad=True)
    weight = torch.randn(27, 4, 3, requires_grad=True)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        subm_conv_apply(feats, torch.zeros((n, 27), dtype=torch.int32),
                        weight, win).sum().backward()
    assert profiling.counters()["tdwss.conv.spill_entries"] == 3 * entries
    totals = profiling.span_totals()
    assert totals["tdwss.kernel.spill_apply"]["count"] == 2
    assert totals["tdwss.kernel.spill_dw"]["count"] == 1


# --- the text model's spans and counters ----------------------------------

TEXT_SPANS = {"tdwss.text.tower", "tdwss.text.loss", "tdwss.loader.tokenize",
              "tdwss.unpool"}


def _text_cfg():
    """``MultiLabelContrastive`` over SparseConvFCNet, m=4, depth 7 (the
    text tower maps to its width, 112), a 2-layer tower of width 64 over
    16 tokens, 4 descriptions a scene."""
    cfg = _cfg()
    cfg.model_name = "MultiLabelContrastive"
    cfg.has_text = True
    cfg.pointcloud_model.depth = 7
    cfg.text_model.width, cfg.text_model.layers = 64, 2
    cfg.text_model.context_length = cfg.text_data.max_seq_len = 16
    cfg.text_data.cropped_texts = 4
    cfg.loss.TextContrastive = True
    return cfg


@pytest.fixture(scope="module")
def text_trainer(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("tracing_text"))
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        reset_sticky_plans()
        scenes = make_dataset(4, num_points=4000, seed=37, with_text=True)
        yield Trainer(_text_cfg(), scenes, [], use_checkpoints=False,
                      verbose=False, device="cpu")


def test_text_spans_off_read_no_clock_and_enter_no_record_function(
        text_trainer, monkeypatch):
    profiling.reset()
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(time, "time_ns", _boom)
    loss = text_trainer.run_epoch(1)
    monkeypatch.undo()
    assert loss > 0
    assert profiling.spans() == [] and profiling.counters() == {}


@pytest.fixture(scope="module")
def text_traced(text_trainer):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        text_trainer.run_epoch(2)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    out = dict(spans=profiling.spans(), counters=profiling.counters(),
               events=names, thread=threading.get_ident())
    profiling.reset()
    return out


def test_text_spans_and_counters_recorded(text_traced, text_trainer):
    spans = text_traced["spans"]
    assert TEXT_SPANS <= {s.name for s in spans}
    by_id = {s.id: s for s in spans}
    steps = sorted(s.key for s in spans if s.name == "tdwss.train.step")
    assert steps == [(2, 0), (2, 1)]
    main = text_traced["thread"]
    for name in ("tdwss.text.tower", "tdwss.text.loss"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == len(steps) and {s.thread for s in mine} == {main}
        assert {by_id[s.parent].name for s in mine} == {"tdwss.train.forward"}
        # on the loop's thread the span is a record_function too
        assert name in text_traced["events"]
    tok = [s for s in spans if s.name == "tdwss.loader.tokenize"]
    assert sorted(s.key for s in tok) == steps
    for s in tok:
        parent = by_id[s.parent]
        assert parent.name == "tdwss.loader.collate" and parent.key == s.key
        assert s.thread != main
    # an unpool and its join below each of the FCN's 7 levels but the last
    assert sum(s.name == "tdwss.unpool" for s in spans) == 6 * len(steps)
    cfg = text_trainer.cfg
    rows = len(steps) * cfg.pointcloud_data.batch_size \
        * cfg.text_data.cropped_texts
    assert text_traced["counters"]["tdwss.text.rows"] == rows


def test_live_tokens_count_the_rows_up_to_their_eot(text_traced,
                                                    text_trainer):
    """The counter against a count of the epoch's token rows, each
    non-empty row up to and including its last non-zero id (its EOT)."""
    want = 0
    for batch in train_batches(text_trainer.train_scenes, text_trainer.cfg,
                               2, prefetch=False):
        for row in batch.text.tokens.reshape(
                -1, batch.text.tokens.shape[-1]).tolist():
            nonzero = [i for i, t in enumerate(row) if t != 0]
            want += nonzero[-1] + 1 if nonzero else 0
    assert want > 0
    assert text_traced["counters"]["tdwss.text.live_tokens"] == want
