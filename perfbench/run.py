"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics. ``--trace 1``
reports its per-layer metrics, read from a window of ``--seconds`` with
the program's spans on and then a window of at most the workload's
``trace_seconds`` under torch.profiler, with the device's busy and window
seconds and a breakdown of that profiled window. Every run checks the
window's outputs against the plain reference and prints each number
compared beside its limit, last on standard error and last in the
result's line. Refuses to run without the CUDA cards the cell asks for.
Compile and kernel caches stay in ``build/`` of the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness  # noqa: E402


def environment() -> None:
    """Fixed cache directories inside the checkout, and one intra-op
    thread for the host's own operators, set before torch loads; the
    program's own switches (tracing, events, profiles, shards, the tuning
    cache) are the benchmark's to set, not the environment's."""
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    for k in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[k]
    os.environ["REPRO_TUNE_CACHE"] = str(CACHE / "tuned_blocks.json")


def steady() -> None:
    """Hold the host steady for the window: the cells on the coordinate
    path are bound by this one thread's dispatch, so it gets a core of its
    own (the highest this process may use) and every other thread of the
    process (the card's runtime's) the rest; set-up's objects leave the
    collector's generations so no full collection walks them in the
    window."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 1:
        me = threading.get_native_id()
        for tid in map(int, os.listdir("/proc/self/task")):
            if tid != me:
                try:
                    os.sched_setaffinity(tid, cores[:-1])
                except OSError:          # the thread has ended
                    pass
        os.sched_setaffinity(0, cores[-1:])
    gc.collect()
    gc.freeze()


def _spans_over(fn):
    """(fn(), the program's spans and kernel launch counts while it ran)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import trace

    fd, path = tempfile.mkstemp(suffix=".spans.jsonl")
    os.close(fd)
    trace.configure(path)
    ops.reset_launch_counts()
    try:
        out = fn()
    finally:
        trace.configure(None)
        launches = ops.launch_counts()
        spans = harness.read_spans(path)
        os.unlink(path)
    return out, spans, launches


def execute(cell: harness.Cell, seconds: float, bench: dict) -> dict:
    """Set up, run the window, read the metrics, check the outputs against
    the reference; returns the result's line.

    A traced run (``cell.trace``) runs the window of ``seconds`` with the
    program's spans on, then a window of at most the workload's
    ``trace_seconds`` under torch.profiler (on a card), and reads the
    per-layer metrics from both; its checks are of the second window's
    outputs."""
    import torch

    on_card = cell.device == "cuda"
    drv = harness.driver(cell.traffic["driver"], cell.base)
    st = drv.setup(cell)
    if on_card:
        torch.cuda.synchronize()
        # the peak is the window's: set-up's inputs and scratch are freed
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        steady()
        print(f"set-up: {t - T0:.3f} s, then steady() "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    setup_s = time.perf_counter() - T0

    prof = traced = None
    if not cell.trace:
        win = drv.window(st, seconds)
    else:
        win, spans, launches = _spans_over(lambda: drv.window(st, seconds))
        main = harness.Window(win, spans, launches)
        short = min(seconds, float(cell.workload["trace_seconds"]))
        prof = harness.Profile() if on_card else None

        def profiled():
            if prof is None:
                return drv.window(st, short)
            with prof:
                return drv.window(st, short)

        twin, tspans, tlaunches = _spans_over(profiled)
        traced = harness.Window(twin, tspans, tlaunches, prof)

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    out = drv.outputs(st)
    drv.release(st)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = drv.check(st, out, drv.reference(st, program=out))

    metrics = {}
    if not cell.trace:
        for m in harness.cell_metrics(bench, cell.name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else \
                win["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = harness.Context(cell, main, traced, base=cell.base)
        for m in harness.cell_metrics(bench, cell.name, "per_layer"):
            value = harness.metric_reader(m["name"], cell.base).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    line = {"correct": all(c.ok for c in checks),
            "attempted": win["attempted"], "failed": win["failed"],
            "metrics": metrics, "device": device}
    if prof is not None:
        device["busy_s"] = prof.busy_s
        device["window_s"] = prof.window_s
        line["breakdown"] = prof.breakdown()
    line["window"] = {k: win[k] for k in ("window_s", "units", "unit_s")
                      if k in win}
    if on_card:
        line["card"] = harness.card_info()
    line["checks"] = harness.checks_line(checks)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()

    bench = harness.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(entry["chips"])):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload, args.seed, "cuda", bool(args.trace))
    line = execute(cell, args.seconds, bench)
    banned = harness.banned_modules()
    if banned:
        print(f"the run loaded modules it must not: {banned}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
