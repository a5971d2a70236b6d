"""The benchmark of ``tdwss_torch``: one run of one cell.

A cell (``workloads/<name>.json``) names its configuration
(``configs/<name>.json``), its traffic mix (``traffic/<name>.json``),
the loop that runs it (``loops/<name>.py``) and the limits of its
check; ``BENCHMARK.json`` at the root of the checkout lists the metrics
it reports, each a reader ``metrics/<name>.py``.  Everything is found by
name, so that a later cell, mix, configuration or metric is a new file.

A run: the loop sets the program up from ``--seed``, measures a window
of ``--seconds`` (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``
measures a shorter stretch, then traces one: the cell's per-layer
metrics), then holds what the program computed against the plain
reference.  The last line of
standard output is the result; the numbers compared, each beside its
limit, end standard error and the result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from typing import Dict, List

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "tdwss")


def process_start() -> float:
    """The wall-clock time at which this process started."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def load_json(kind: str, name: str) -> dict:
    """The file ``<kind>/<name>.json`` of the benchmark."""
    path = os.path.join(BENCH, kind, name + ".json")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r}: {path} does not exist")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark."""
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: dict             # workloads/<name>.json
    config: dict           # configs/<config>.json
    mix: dict              # traffic/<traffic>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.spec.get("chips", 1))


def load_cell(name: str, bench: dict = None) -> Cell:
    """Cell ``name`` with its configuration, mix and metrics; a name the
    benchmark does not hold raises ``KeyError``."""
    bench = bench if bench is not None else benchmark_spec()
    spec = load_json("workloads", name)

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, spec=spec,
                config=load_json("configs", spec["config"]),
                mix=load_json("traffic", spec["traffic"]),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def read_metrics(specs: List[dict], ctx) -> Dict[str, dict]:
    """Each metric's reader over ``ctx``; one that finds nothing to read
    is left out."""
    out = {}
    for m in specs:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def isolate_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    TensorBoard: the loop's scalar logger would import it (and, where
    TensorFlow is installed, JAX) and write event files."""
    base = os.path.join(ROOT, "build", "portbench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    sys.modules.setdefault("torch.utils.tensorboard", None)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    """One run of ``cell`` on ``device``; the result's dict."""
    loop = load_module("loops", cell.spec["loop"])
    return loop.run(cell, seed, seconds, trace, device, started)


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    isolate_caches()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"this machine has {n}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), started)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded in this process that the port "
              f"must not load: {', '.join(bad)}", file=sys.stderr)
        return 1
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The compared numbers on standard error, then the result's line."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
