"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 [--control]

For each seed, in one process: the program's first steps as a run takes
them (:func:`first_steps` of the cell's loop, the same set-up a run
makes), then the reference's in f32; with ``--control``, also the
control (the reference in fp8, in the program's place) and a planted
fault (the reference with half of each batch left out of the loss).
Prints one JSON line per seed with each side's numbers.  Not part of a
run: the benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args()
    cell = harness.load_cell(args.workload)
    harness.isolate_caches()
    import torch

    from portbench.reference import check

    loop = harness.load_module("loops", cell.spec["loop"])
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    steps = int(cell.spec["check_steps"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        scenes, trainer, cfgd, weights, program = loop.first_steps(
            cell, seed, device)
        del trainer
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = check.reference_steps(scenes, cfgd, seed, weights, steps,
                                    device)
        out = {"seed": seed, "program": check.readings(program, ref),
               "losses": [program.losses, ref.losses]}
        if args.control:
            fp8 = check.reference_steps(scenes, cfgd, seed, weights, steps,
                                        device, precision="fp8")
            half = check.reference_steps(scenes, cfgd, seed, weights, steps,
                                         device, half_batch=True)
            out["control_fp8"] = check.readings(fp8, ref)
            out["fault_half_batch"] = check.readings(half, ref)
        out["seconds"] = time.time() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
