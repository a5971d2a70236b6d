"""The loop's small utilities, on the CPU and without JAX:
``Checkpointer`` (one file per epoch, written under a temporary name and
renamed, the newest 3 kept, ``restore_latest`` -> (state, next epoch)),
``load_pretrain`` (parameters and buffers only), ``ScalarLogger``
(JSONL records), ``profiling.trace`` (a Chrome trace, plain or gzipped,
and the profiler's events) and ``StepTimer``, ``param_count``, and
``resolve_device`` refusing a card that is not there."""

import gzip
import json
import os

import pytest
import torch

from tdwss_torch.device import resolve_device
from tdwss_torch.utils import profiling
from tdwss_torch.utils.checkpoint import Checkpointer, load_pretrain
from tdwss_torch.utils.flops import param_count
from tdwss_torch.utils.logging_util import ScalarLogger


def _model(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 3),
                               torch.nn.BatchNorm1d(3))


def test_checkpointer_keeps_the_newest_three(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"))
    assert ckpt.restore_latest() == (None, 1)
    assert ckpt.latest_epoch is None
    for epoch in range(1, 6):
        ckpt.save(epoch, {"epoch": epoch, "w": torch.full((2,), epoch)})
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "epoch_3.pt", "epoch_4.pt", "epoch_5.pt"]
    # a write cut short leaves only its temporary file, which is ignored
    (tmp_path / "ck" / "epoch_6.pt.tmp").write_bytes(b"partial")
    state, next_epoch = ckpt.restore_latest()
    assert next_epoch == 6 and state["epoch"] == 5
    assert torch.equal(state["w"], torch.full((2,), 5))
    ckpt.save(6, {"epoch": 6})
    assert ckpt.latest_epoch == 6
    assert not (tmp_path / "ck" / "epoch_6.pt.tmp").exists()


def test_load_pretrain_takes_parameters_and_buffers(tmp_path):
    src = _model(0)
    src[1].running_mean.fill_(0.5)
    Checkpointer(str(tmp_path)).save(2, {"model": src.state_dict(),
                                         "optimizer": {"unused": 1}})
    dst = _model(1)
    load_pretrain(str(tmp_path), dst)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        load_pretrain(str(tmp_path / "empty"), dst)


def test_scalar_logger_writes_jsonl(tmp_path):
    log = ScalarLogger(str(tmp_path), use_tensorboard=False)
    log.scalar("Train Loss", torch.tensor(0.25), 1)
    log.scalar("Validation accuracy", 0.5, 1)
    log.close()
    with open(tmp_path / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [(r["tag"], r["value"], r["step"]) for r in recs] == [
        ("Train Loss", 0.25, 1), ("Validation accuracy", 0.5, 1)]


@pytest.mark.parametrize("name", ["trace.json", "trace.json.gz"])
def test_profiling_trace_writes_a_chrome_trace(tmp_path, name):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), name) as prof:
        (x @ x).sum()
    assert any(e.name == "aten::mm" for e in prof.events())
    path = tmp_path / name
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "rt") as f:
        assert "traceEvents" in json.load(f)


def test_step_timer_and_param_count():
    timer = profiling.StepTimer()
    with pytest.raises(RuntimeError):
        timer.stop()
    for _ in range(2):
        timer.start()
        assert timer.stop() >= 0.0
    assert len(timer.history) == 2 and timer.mean >= 0.0
    assert param_count(_model(0)) == 4 * 3 + 3 + 3 + 3


def test_resolve_device_refuses_a_missing_card():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device()
