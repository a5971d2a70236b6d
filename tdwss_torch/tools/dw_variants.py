"""Time design variants of the tensor-core dW tile of K2 and K6
(``tdwss_torch/csrc/windowed_mma.cuh``, ``dw_mma_kernel``) against the
committed source, on one card.

    python3 -m tdwss_torch.tools.dw_variants [--variants a,b,...]
                                             [--out FILE]

Each variant is a copy of ``tdwss_torch/csrc`` under
``build/tdwss_torch/variants/<name>`` with edits of ``windowed_mma.cuh``
(see ``VARIANTS``): a constant of the design (ring depth, threads per
block), or a loop cut out to see what a part costs, in which case the
variant computes wrong values and is timed only.  ``partcap`` is the
committed source with the partials' memory cap at 256 MiB, so that wide
shapes get more row chunks (blocks).  All libraries are built in
parallel; then every case is timed in bf16 for every variant in turns
(forward then reverse order; CUDA events, median of 7 samples of 10 calls
back to back).  The cases are K2 and K6 on synthetic sub-form plans at
path shapes, with the share of dead (row, tap) entries of the paths they
stand for; "dW only" runs without dfeats (``need_dfeats=False``), so the
difference to the full call is the dfeats product.  Variants that keep
the function are held against the committed source's dW (within 1e-3 of
its max|.|).  Prints a table and, as its last line, one JSON object;
``--out`` writes that object to a file too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

from tdwss_torch.ops import windowed as W

_NO_MMA = {"for (int gi = ks; gi < groups; gi += KS) {":
           "for (int gi = ks; gi < 0 * groups; gi += KS) {"}
_NO_GATHER = {"    for (int i = tid; i < slots; i += DW_THREADS) {":
              "    for (int i = tid; i < 0 * slots; i += DW_THREADS) {"}
# name -> (edits of windowed_mma.cuh, keeps the function, partial cap)
VARIANTS = {
    "committed": ({}, True, None),
    "stages3": ({"DW_STAGES = 2;": "DW_STAGES = 3;"}, True, None),
    "threads256": ({"DW_THREADS = 128;": "DW_THREADS = 256;"}, True, None),
    "partcap": ({}, True, 256 << 20),
    "no_products": (_NO_MMA, False, None),
    "no_gathers": (_NO_GATHER, False, None),
    "neither": ({**_NO_MMA, **_NO_GATHER}, False, None),
}
# kernel, label, V_out, V_src, K, Cin, Cout, dead share, need_dfeats
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
]


def _make_variant(name, root):
    edits = VARIANTS[name][0]
    dst = os.path.join(W.BUILD_DIR, "variants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "tdwss_torch", "csrc"), dst)
    path = os.path.join(dst, "windowed_mma.cuh")
    with open(path) as f:
        text = f.read()
    for old, new in edits.items():
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return dst


@contextlib.contextmanager
def _using(name, csrc):
    """The wrappers of ``windowed`` on the libraries of variant ``name``."""
    saved = (W.SOURCES, W.HEADERS, dict(W._libs), W._PART_BYTES)
    W.SOURCES = {**W.SOURCES,
                 "bwd": os.path.join(csrc, "windowed_bwd.cu"),
                 "bwd_sub": os.path.join(csrc, "windowed_bwd_sub.cu")}
    W.HEADERS = tuple(os.path.join(csrc, os.path.basename(h))
                      for h in W.HEADERS)
    W._libs.clear()
    if VARIANTS[name][2] is not None:
        W._PART_BYTES = VARIANTS[name][2]
    try:
        yield
    finally:
        W.SOURCES, W.HEADERS, libs, W._PART_BYTES = saved
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
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if "committed" not in names:
        names.insert(0, "committed")
    if not torch.cuda.is_available():
        print("dw_variants: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    dirs = {n: _make_variant(n, root) for n in names}
    _build_all(dirs)
    print(f"built the libraries of {len(dirs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    calls = []
    for kern, label, v_out, v_src, k, cin, cout, dead, need in CASES:
        st, so, rb_t, geo = _plan(gen, device, v_out, v_src, k, dead)
        feats = torch.randn((v_out if kern == W.K2 else v_src, cin),
                            generator=gen).to(device, torch.bfloat16)
        dout = torch.randn((v_src, cout), generator=gen).to(device,
                                                            torch.bfloat16)
        wt = (torch.randn((k, cout, cin), generator=gen)
              * (2.0 / (k * cout)) ** 0.5).to(device, torch.bfloat16)
        args_ = ((dout, feats) if kern == W.K2 else (feats, dout))
        fn = getattr(W, kern)
        calls.append((f"{kern} {label}", lambda fn=fn, a=args_, st=st,
                       so=so, rb=rb_t, wt=wt, geo=geo, need=need: fn(
                           *a, st, so, rb, wt, need_dfeats=need, **geo)))

    times = {n: {c: [] for c, _ in calls} for n in names}
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
    print("bf16 ms per call, two turns (order: "
          + " ".join(names + names[::-1]) + ")")
    print(f"{'case':34s}" + "".join(f"{n:>20s}" for n in names))
    for label, _ in calls:
        print(f"{label:34s}" + "".join(
            f"{times[n][label][0]:10.4f}/{times[n][label][1]:8.4f}"
            for n in names))
    result = {"device": smi, "times_ms": times, "errors": errors}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
