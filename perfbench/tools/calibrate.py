"""Readings that the checks' limits are set from. For each seed: the
cell's set-up, a short window at the cell's own sizes and load, and the
numbers compared against the plain reference (the lower readings); for
each control seed also the control, the reference put in the program's
place at the next lower precision, against the same reference (the upper
readings). One JSON line a reading.

    python3 perfbench/tools/calibrate.py --workload appc-select-beam \
        --seconds 1 --seeds 1,2,3 --control-seeds 1
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.cell(args.workload, seed, "cuda")
        drv = harness.driver(cell.traffic["driver"])
        st = drv.setup(cell)
        win = drv.window(st, args.seconds)
        out = drv.outputs(st)
        drv.release(st)
        gc.collect()
        torch.cuda.empty_cache()
        ref = drv.reference(st, program=out)
        rec = {"seed": seed, "kind": "program", "e2e": win["e2e"],
               "units": win["units"],
               "checks": {c.name: c.value for c in drv.check(st, out, ref)}}
        print(json.dumps(rec), flush=True)
        if seed in controls:
            dtype = harness.control_dtype(cell)
            low = harness.CONTROL[cell.config["dtype"]]
            try:
                ctrl = drv.reference(st, dtype=dtype, program=out)
                ref_c = drv.reference(st, program=ctrl) \
                    if "supports" in ctrl else ref
                vals = {c.name: c.value for c in drv.check(st, ctrl, ref_c)}
            except Exception as e:  # a control that crashes has failed
                vals = {"error": f"{type(e).__name__}: {e}"}
            print(json.dumps({"seed": seed, "kind": f"control:{low}",
                              "checks": vals}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        del st
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
