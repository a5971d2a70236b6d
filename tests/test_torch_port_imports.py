"""(g) The port and chip_smoke.py import no JAX, flax, optax, yaml or tdwss.

Each module of ``tdwss_torch`` and ``chip_smoke.py`` is imported in a
fresh interpreter whose import system refuses those names, so an import
anywhere in the chain (not only at the top of a file) fails the test.
"""

import os
import pkgutil
import subprocess
import sys

import tdwss_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "tdwss")

_PROBE = r"""
import importlib, importlib.abc, sys
BLOCKED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None
for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)
print("ok", len(sys.argv) - 1)
"""


def _modules():
    names = ["tdwss_torch"]
    for info in pkgutil.walk_packages(tdwss_torch.__path__, "tdwss_torch."):
        names.append(info.name)
    return names


def _run(names):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", _PROBE % (BLOCKED,), *names],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def test_port_modules_import_without_jax_flax_yaml_tdwss():
    names = _modules()
    for mod in ("tdwss_torch.ops.windowed", "tdwss_torch.ops.segment",
                "tdwss_torch.utils.losses", "tdwss_torch.engine.steps",
                "tdwss_torch.ops.plan", "tdwss_torch.models.sparse_encoders",
                "tdwss_torch.tools.step_grads",
                "tdwss_torch.ops.experimental.brick_plan",
                "tdwss_torch.ops.experimental.brick_conv",
                "tdwss_torch.ops.experimental.block_gather",
                "tdwss_torch.ops.voxelize", "tdwss_torch.data.dataset",
                "tdwss_torch.data.loader", "tdwss_torch.engine.train",
                "tdwss_torch.engine.pseudo", "tdwss_torch.utils.pseudo",
                "tdwss_torch.utils.checkpoint",
                "tdwss_torch.utils.logging_util",
                "tdwss_torch.utils.profiling", "tdwss_torch.utils.flops",
                "tdwss_torch.cli.common", "tdwss_torch.cli.train",
                "tdwss_torch.cli.statistics",
                "tdwss_torch.cli.pseudo_label_generation",
                "tdwss_torch.cli.validation", "tdwss_torch.data.tokenizer",
                "tdwss_torch.models.transformer",
                "tdwss_torch.models.clip_import", "tdwss_torch.convert"):
        assert mod in names
    res = _run(names)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == f"ok {len(names)}"


def test_chip_smoke_imports_without_jax_flax_yaml_tdwss():
    res = _run(["chip_smoke"])
    assert res.returncode == 0, res.stderr[-3000:]


def test_probe_blocks_the_names():
    res = _run(["yaml"])
    assert res.returncode != 0 and "blocked import: yaml" in res.stderr
