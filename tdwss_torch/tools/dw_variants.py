"""Time design variants of the tensor-core dW tile of K2, K3/K5 and K6
(``tdwss_torch/csrc/windowed_mma.cuh``, ``dw_mma_kernel``) against the
committed source, on one card.

    python3 -m tdwss_torch.tools.dw_variants [--variants a,b,...]
                                             [--kernels K2,K3,...]
                                             [--out FILE]

Each variant is a copy of ``tdwss_torch/csrc`` under
``build/tdwss_torch/variants/<name>`` with edits of its sources (see
``VARIANTS``; each edit applies to the one file that holds it): a
constant of the design (ring depth, threads per block), or a loop or a
launch cut out to see what a part costs, in which case the variant
computes wrong values and is timed only; or the committed source with
constants of ``tdwss_torch.ops.windowed``'s dW chunking set otherwise:
``partcap`` caps the partials at 256 MiB, so that wide shapes get more
row chunks (blocks); the ``k3*`` variants set the rows per chunk, the
block target or the partials' cap (every dW kernel reads them; they are
named for the K3/K5 runs, ``--kernels K3,K5``, that measured them).
All libraries are built in parallel; then every case is timed in bf16
for every variant in turns
(forward then reverse order; CUDA events, median of 7 samples of 10 calls
back to back), and also as replays of a CUDA graph of 10 calls (the
device's time alone: at the small shapes the wrappers' host work can
exceed the device's) and as the host's issue time per call.  The cases
are K2, K6 and K3/K5 at level 0 on synthetic plans at
path shapes, with the share of dead (row, tap) entries of the paths they
stand for; "dW only" runs K2 or K6 without dfeats (``need_dfeats=False``),
so the difference to the full call is the dfeats product; K5 runs the
flat form of the K3 case's windows.  With K3 or K5, the cases also hold
every K3 call of the paths on the paths' own plans: one training step
each of the bench UNet and of Narrow on ``chip_smoke.py``'s bench batch
(its configs and helpers; the FCN batch's elastic noise seeded, so that
every checkout gets the same plans), K3's calls recorded, and K5 on the
same windows in the flat form; and K3/K5 at 32 -> 32 on the UNet batch's
level-0 subm plan (``chip_smoke.level_case``), the shape of
``chip_smoke.py``'s K3/K5 rows.  ``--kernels`` keeps the cases of the
named kernels.  Variants that keep the function are held against the
committed source's dW (within 1e-3 of its max|.|).  Prints a table and,
as its last line, one JSON object; ``--out`` writes that object to a
file too.

The sources and the wrappers are those of the ``tdwss_torch`` package
that Python imports, so the same cases can be timed on another checkout
(an earlier commit, unpacked with ``git archive``) by running this file
with that checkout first on ``PYTHONPATH``:

    PYTHONPATH=<checkout> python3 tdwss_torch/tools/dw_variants.py \
        --variants committed --kernels K3,K5
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tdwss_torch.ops import windowed as W

# this tool's own checkout, whose chip_smoke.py gives the paths' configs
_HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_NO_MMA = {"for (int gi = ks; gi < groups; gi += KS) {":
           "for (int gi = ks; gi < 0 * groups; gi += KS) {"}
_NO_GATHER = {"    for (int i = tid; i < slots; i += DW_THREADS) {":
              "    for (int i = tid; i < 0 * slots; i += DW_THREADS) {"}
# K3/K5 without the second pass (the partials' reduction)
_NO_REDUCE = {"  if (err != 0) return err;\n  return tdwss::reduce_partials("
              "pp, nchunk, k,\n                                "
              "static_cast<int64_t>(c) * cout, 0,":
              "  if (err != 0 || 1) return err;\n  return "
              "tdwss::reduce_partials(pp, nchunk, k,\n"
              "                                static_cast<int64_t>(c) * "
              "cout, 0,"}

# name -> (edits of the sources, keeps the function, constants of
# tdwss_torch.ops.windowed set for the variant)
VARIANTS = {
    "committed": ({}, True, {}),
    "stages3": ({"DW_STAGES = 2;": "DW_STAGES = 3;"}, True, {}),
    "threads256": ({"DW_THREADS = 128;": "DW_THREADS = 256;"}, True, {}),
    "partcap": ({}, True, {"_PART_BYTES": 256 << 20}),
    "k3rows128": ({}, True, {"_MIN_CHUNK_ROWS": 128}),
    "k3rows512": ({}, True, {"_MIN_CHUNK_ROWS": 512}),
    "k3blocks2": ({}, True, {"_TARGET_BLOCKS": 2 * 132}),
    "k3blocks8": ({}, True, {"_TARGET_BLOCKS": 8 * 132}),
    "k3part32": ({}, True, {"_PART_BYTES": 32 << 20}),
    "no_reduce": (_NO_REDUCE, False, {}),
    "no_products": (_NO_MMA, False, {}),
    "no_gathers": (_NO_GATHER, False, {}),
    "neither": ({**_NO_MMA, **_NO_GATHER}, False, {}),
}
# kernel, label, V_out, V_src, K, Cin, Cout, dead share, need_dfeats (K2
# and K6; K3/K5 compute dW alone).  The paths' K3 calls are added by
# _path_cases.
CASES = [
    (W.K2, "32->32 (level 0)", 638976, 786432, 27, 32, 32, 0.83, True),
    (W.K2, "32->32 (level 0) dW only", 638976, 786432, 27, 32, 32, 0.83,
     False),
    (W.K2, "3->32 (stem) dW only", 638976, 786432, 27, 3, 32, 0.83, False),
    (W.K2, "128->64", 356352, 393216, 27, 128, 64, 0.57, True),
    (W.K2, "128->64 dW only", 356352, 393216, 27, 128, 64, 0.57, False),
    (W.K2, "64->64", 356352, 393216, 27, 64, 64, 0.5, True),
    (W.K2, "64->64 dW only", 356352, 393216, 27, 64, 64, 0.5, False),
    (W.K6, "192->96", 108544, 131072, 27, 192, 96, 0.5, True),
    (W.K6, "192->96 dW only", 108544, 131072, 27, 192, 96, 0.5, False),
    (W.K6, "384->192", 2048, 4096, 27, 384, 192, 0.3, True),
    (W.K6, "256->256", 2048, 49152, 27, 256, 256, 0.3, True),
    (W.K3, "32->32 (level 0)", 638976, 786432, 27, 32, 32, 0.83, False),
    (W.K5, "32->32 (level 0)", 638976, 786432, 27, 32, 32, 0.83, False),
]
_SHORT = {"K2": W.K2, "K3": W.K3, "K5": W.K5, "K6": W.K6}


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its configs, plan
    helpers and recorders import the ``tdwss_torch`` that Python finds
    first)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _path_cases(cs, device):
    """(label, call) of every distinct K3 call of one training step of the
    bench UNet and of Narrow on chip_smoke.py's bench batch (recorded by
    its ``record_dw_shapes``), on seeded random features and cotangents,
    and of K5 on the same windows (``flat_locals``); first K3 and K5 at
    32 -> 32 on the UNet batch's level-0 subm plan."""
    from tdwss_torch.data.synthetic import make_dataset
    from tdwss_torch.engine.steps import make_optimizer, train_step
    from tdwss_torch.models.meta_arch import build_model

    scenes = make_dataset(cs.NUM_SCENES, num_points=cs.POINTS_PER_SCENE,
                          seed=7, with_text=False)
    unseeded = np.random.default_rng
    calls, gen = [], torch.Generator().manual_seed(1)
    for name, cfg in (("UNet", cs.bench_config()),
                      ("Narrow", cs.cut_to_bench_batch(cs.narrow_config()))):
        np.random.default_rng = (lambda seed=None: unseeded(
            0 if seed is None else seed))
        try:
            _, host, _ = cs.plan_train_batch(cfg, scenes, name)
        finally:
            np.random.default_rng = unseeded
        if name == "UNet":
            lc = cs.level_case(host.plans, 0, 32, 32, device, gen)
            st, so = lc["starts"].reshape(-1), lc["soff"].reshape(-1)
            geo = (lc["window"], lc["tile"], lc["sub"], lc["subwin"])
            calls += [
                (f"{W.K3} UNet level 0 32->32 K=27", lambda lc=lc, st=st,
                 so=so, geo=geo: (None, W.windowed_dw_sub(
                     lc["x"], st, so, lc["rb"].t(), lc["dout"], *geo))),
                (f"{W.K5} UNet level 0 32->32 K=27", lambda lc=lc, st=st: (
                    None, W.windowed_dw(lc["x"], st, lc["rb_flat"].t(),
                                        lc["dout"], lc["window"],
                                        lc["tile"])))]
        model = build_model(cfg, seed=0, device=device)
        opt, sched = make_optimizer(cfg, model, cs.STEPS_PER_EPOCH)
        shapes = {}
        with cs.record_dw_shapes(shapes):
            train_step(cfg, model, opt, sched, host.to(device))
        del model, opt, sched
        for (kern, c, cout, k), a in sorted(shapes.items()):
            kw = a["kwargs"]
            v_out = a["rb_t"].shape[1]
            x = torch.randn((a["v_src"], c), generator=gen).to(
                device, torch.bfloat16)
            dout = torch.randn((v_out, cout), generator=gen).to(
                device, torch.bfloat16)
            label = f"{name} {c}->{cout} V_out={v_out}"
            calls.append((f"{W.K3} {label}", lambda x=x, d=dout, a=a, kw=kw: (
                None, W.windowed_dw_sub(x, a["starts"], a["soff"],
                                        a["rb_t"], d, **kw))))
            calls.append((f"{W.K5} {label}", lambda x=x, d=dout, a=a, kw=kw,
                          rb=cs.flat_locals(a, k): (None, W.windowed_dw(
                              x, a["starts"], rb, d, kw["window"],
                              kw["tile"]))))
    return calls


def _make_variant(name, root):
    edits = VARIANTS[name][0]
    dst = os.path.join(W.BUILD_DIR, "variants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "tdwss_torch", "csrc"), dst)
    texts = {}
    for fn in sorted(os.listdir(dst)):
        with open(os.path.join(dst, fn)) as f:
            texts[fn] = f.read()
    for old, new in edits.items():
        holders = [fn for fn, text in texts.items() if old in text]
        if len(holders) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is in {holders}, "
                               "not in one source")
        texts[holders[0]] = texts[holders[0]].replace(old, new)
    for fn, text in texts.items():
        with open(os.path.join(dst, fn), "w") as f:
            f.write(text)
    return dst


@contextlib.contextmanager
def _using(name, csrc):
    """The wrappers of ``windowed`` on the libraries of variant ``name``,
    with its constants set."""
    consts = VARIANTS[name][2]
    saved = (W.SOURCES, W.HEADERS, dict(W._libs),
             {c: getattr(W, c) for c in consts})
    W.SOURCES = {**W.SOURCES,
                 "bwd": os.path.join(csrc, "windowed_bwd.cu"),
                 "bwd_sub": os.path.join(csrc, "windowed_bwd_sub.cu")}
    W.HEADERS = tuple(os.path.join(csrc, os.path.basename(h))
                      for h in W.HEADERS)
    W._libs.clear()
    for c, v in consts.items():
        setattr(W, c, v)
    try:
        yield
    finally:
        W.SOURCES, W.HEADERS, libs, old = saved
        for c, v in old.items():
            setattr(W, c, v)
        W._libs.clear()
        W._libs.update(libs)


def _build_all(dirs):
    """nvcc of every variant's two backward libraries, all at once."""
    jobs, paths = [], set()
    for name, csrc in dirs.items():
        with _using(name, csrc):
            for part in ("bwd", "bwd_sub"):
                # variants with the same source share one library
                path = W.lib_path(part)
                if not os.path.exists(path) and path not in paths:
                    paths.add(path)
                    cmd = [W._nvcc(), *W.NVCC_FLAGS, "-o", path,
                           W.SOURCES[part]]
                    jobs.append((name, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True)))
    for name, proc in jobs:
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n"
                               f"{out[-4000:]}")


def _plan(gen, device, v_out, v_src, k, dead, tile=64, sub=8, window=64,
          subwin=16):
    starts = torch.randint(-8, max(1, v_src - window + 8), (v_out // tile,),
                           generator=gen, dtype=torch.int32)
    soff = torch.randint(0, window - subwin + 1, (v_out // sub,),
                         generator=gen, dtype=torch.int32)
    rb = torch.randint(0, subwin, (v_out, k), generator=gen,
                       dtype=torch.int32)
    rb = torch.where(torch.rand((v_out, k), generator=gen) < dead,
                     torch.full_like(rb, subwin), rb)
    return (starts.to(device), soff.to(device),
            rb.t().contiguous().to(device),
            dict(window=window, tile=tile, sub=sub, subwin=subwin))


def _graph_ms(fn, iters=7, window=10):
    """Milliseconds per call of ``fn`` as replays of one CUDA graph that
    captured ``window`` calls (median of ``iters`` replays): the device's
    time without the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(window):
            fn()
    graph.replay()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / window)
    del graph
    return statistics.median(times)


def _host_us(fn, calls=50):
    """Microseconds of host time per call of ``fn`` issued back to back
    (the device queue absorbs the launches)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _time_ms(fn, iters=7, window=10):
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(window):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / window)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kernels", default=",".join(_SHORT))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if "committed" not in names:
        names.insert(0, "committed")
    kernels = {_SHORT[n] for n in args.kernels.split(",")}
    if not torch.cuda.is_available():
        print("dw_variants: no CUDA device", file=sys.stderr)
        return 2
    root = W._REPO_ROOT
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}; sources of {root}",
          flush=True)
    t0 = time.perf_counter()
    dirs = {n: _make_variant(n, root) for n in names}
    _build_all(dirs)
    print(f"built the libraries of {len(dirs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cs = _chip_smoke()
    calls, plans = [], {}
    for kern, label, v_out, v_src, k, cin, cout, dead, need in CASES:
        if kern not in kernels:
            continue
        # cases of one geometry share their plan (K5: K3's windows)
        key = (v_out, v_src, k, dead)
        if key not in plans:
            plans[key] = _plan(gen, device, v_out, v_src, k, dead)
        st, so, rb_t, geo = plans[key]
        feats = torch.randn((v_out if kern == W.K2 else v_src, cin),
                            generator=gen).to(device, torch.bfloat16)
        dout = torch.randn((v_out if kern in (W.K3, W.K5) else v_src, cout),
                           generator=gen).to(device, torch.bfloat16)
        fn = getattr(W, kern)
        if kern == W.K3:
            call = (lambda fn=fn, f=feats, d=dout, st=st, so=so, rb=rb_t,
                    geo=geo: (None, fn(f, st, so, rb, d, **geo)))
        elif kern == W.K5:
            flat = cs.flat_locals(dict(kwargs=geo, rb_t=rb_t, starts=st,
                                       soff=so), k)
            call = (lambda fn=fn, f=feats, d=dout, st=st, rb=flat,
                    geo=geo: (None, fn(f, st, rb, d, geo["window"],
                                       geo["tile"])))
        else:
            wt = (torch.randn((k, cout, cin), generator=gen)
                  * (2.0 / (k * cout)) ** 0.5).to(device, torch.bfloat16)
            args_ = ((dout, feats) if kern == W.K2 else (feats, dout))
            call = (lambda fn=fn, a=args_, st=st, so=so, rb=rb_t, wt=wt,
                    geo=geo, need=need: fn(*a, st, so, rb, wt,
                                           need_dfeats=need, **geo))
        calls.append((f"{kern} {label}", call))
    if kernels & {W.K3, W.K5}:
        calls += [(label, call) for label, call in _path_cases(cs, device)
                  if label.split()[0] in kernels]

    times = {n: {c: [] for c, _ in calls} for n in names}
    graph = {n: {c: [] for c, _ in calls} for n in names}
    host = {n: {c: [] for c, _ in calls} for n in names}
    ref, errors = {}, []
    for name in names + names[::-1]:
        with _using(name, dirs[name]):
            for label, call in calls:
                _, dw = call()
                torch.cuda.synchronize()
                if name == "committed" and label not in ref:
                    ref[label] = dw
                elif VARIANTS[name][1]:
                    scale = ref[label].abs().max().item()
                    err = (dw - ref[label]).abs().max().item()
                    if err > 1e-3 * scale:
                        errors.append(f"{name} {label}: {err / scale:.3g}")
                times[name][label].append(_time_ms(call))
                graph[name][label].append(_graph_ms(call))
                host[name][label].append(_host_us(call))
    for title, table, digits in (
            ("bf16 ms per call back to back", times, 4),
            ("bf16 ms per call, CUDA graph replays", graph, 4),
            ("host us per call issued", host, 1)):
        print(f"{title}, two turns (order: "
              + " ".join(names + names[::-1]) + ")")
        print(f"{'case':44s}" + "".join(f"{n:>20s}" for n in names))
        for label, _ in calls:
            print(f"{label:44s}" + "".join(
                f"{table[n][label][0]:10.{digits}f}/"
                f"{table[n][label][1]:8.{digits}f}" for n in names))
    result = {"device": smi, "times_ms": times, "graph_ms": graph,
              "host_us": host, "errors": errors}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
