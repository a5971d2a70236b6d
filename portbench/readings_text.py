"""The readings that a text cell's limits are set from, at the cell's own
size.

    python3 portbench/readings_text.py --workload <cell> --seeds 11,12 [--control]

For each seed, in one process: the program's first steps as a run takes
them (:func:`first_steps` of the cell's loop), then the text reference's
in f32; with ``--control``, also the control (the reference with its 3D
tower in fp8 and its text tower in bf16, in the program's place) and
two planted faults (the reference with half of each batch left out of
the loss; the reference with each scene paired with the next scene's
descriptions).  Prints one JSON line per seed with each side's numbers.
Not part of a run: the benchmark's own runs never run the control.
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

    from portbench.reference import text_check

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

        def ref(**kw):
            return text_check.reference_steps(scenes, cfgd, seed, weights,
                                              steps, device, **kw)

        base = ref()
        out = {"seed": seed, "program": text_check.readings(program, base),
               "losses": [program.losses, base.losses]}
        if args.control:
            for name, kw in (("control", dict(pc_precision="fp8",
                                              text_precision="bf16")),
                             ("fault_half_batch", dict(half_batch=True)),
                             ("fault_rolled", dict(rolled=True))):
                out[name] = text_check.readings(ref(**kw), base)
        out["seconds"] = time.time() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
