"""Tables from the port's dry-run records, its roofline, the autotuner's
cache and a span trace.

    PYTHONPATH=src python -m repro_torch.analysis.report [--dir ...]
        [--tune-cache ...] [--trace ...]

The PyTorch port's counterpart of the JAX package's
``analysis/report.py``. The dry run (``launch/dryrun.py``) runs on the
meta device for one H100: its table shows the bytes a cell holds and
whether they fit on the card, and has no compile time and no collective
count, which one card on the meta device has none of. Its records on the
production meshes (``--mesh``) get a table of their own beside it: one
device's bytes, ``fits``, collective bytes and the roofline's terms.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from . import roofline as rl
from ..obs import events as obs_events

GB = 1e9


def fmt_s(x):
    return f"{x:.2e}"


def load(d):
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def dryrun_table(recs):
    """One row a cell: the bytes of weights, optimizer state (gradients and
    the two float32 moments of a train step), cache and inputs in GB, their
    sum, and whether that state fits in the card's memory (activations
    and temporaries are not counted, so fitting is necessary, not
    sufficient)."""
    rows = ["| arch | shape | status | params GB | opt GB | cache GB "
            "| inputs GB | state GB | fits |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] == "ok":
            b = r["bytes"]
            rows.append(
                f"| {r['arch']} | {r['shape']} | ok "
                f"| {b['params'] / GB:.2f} | {b['opt'] / GB:.2f} "
                f"| {b['cache'] / GB:.2f} | {b['inputs'] / GB:.2f} "
                f"| {b['state'] / GB:.2f} "
                f"| {'yes' if r['fits'] else 'no'} |")
        else:
            reason = r.get("reason", "error")
            if not reason.startswith(r["status"]):
                reason = f"{r['status']}: {reason}"
            rows.append(f"| {r['arch']} | {r['shape']} | {reason} "
                        f"| - | - | - | - | - | - |")
    return "\n".join(rows)


def one_card(recs):
    """The one-card records (those without a ``mesh``)."""
    return [r for r in recs if "mesh" not in r]


def mesh_table(recs):
    """One row a cell on a production mesh: one device's bytes of weights,
    optimizer state, cache and inputs and their sum in GB, whether that
    fits one card, the collective bytes a device moves a step and the
    roofline's terms with the link term at the cross-node rate."""
    rows = ["| arch | shape | mesh | status | params GB | opt GB | cache GB "
            "| state GB | fits | collective GB | compute s | collective s "
            "| bottleneck |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if "mesh" not in r:
            continue
        if r["status"] != "ok":
            reason = r.get("reason") or r.get("traceback", "error") \
                .strip().splitlines()[-1][:80]
            if not reason.startswith(r["status"]):
                reason = f"{r['status']}: {reason}"
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                        f"| {reason} "
                        f"| - | - | - | - | - | - | - | - | - |")
            continue
        b, ro = r["bytes"], r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {b['params'] / GB:.3f} | {b['opt'] / GB:.3f} "
            f"| {b['cache'] / GB:.3f} | {b['state'] / GB:.3f} "
            f"| {'yes' if r['fits'] else 'no'} "
            f"| {ro['collective_bytes'] / GB:.3f} | {fmt_s(ro['compute_s'])} "
            f"| {fmt_s(ro['collective_s'])} | {ro['bottleneck']} |")
    return "\n".join(rows)


def roofline_table(recs):
    """Per-step roofline of every ``ok`` cell on one card; the memory term
    is a floor (the state the step reads and writes once)."""
    rows = ["| arch | shape | compute s | memory s (floor) | collective s | "
            "bottleneck | useful/counted flops | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok":
            continue
        ro = r["roofline"]
        dom = max(ro["compute_s"], ro["memory_s"], ro["collective_s"])
        # fraction of roofline: ideal time (compute term at 100% useful
        # flops) over the dominating term
        ideal = ro["model_flops"] / rl.PEAK_FLOPS
        frac = ideal / dom if dom > 0 else 0.0
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(ro['compute_s'])} "
            f"| {fmt_s(ro['memory_s'])} | {fmt_s(ro['collective_s'])} "
            f"| {ro['bottleneck']} | {ro['useful_flops_ratio']:.2f} "
            f"| {frac:.3f} |")
    return "\n".join(rows)


def serving_kernel_table():
    """Roofline of the serving scoring kernels at canonical QPS shapes."""
    shapes = [
        ("survival_curves", {"batch": 64, "grid": 128}),
        ("survival_curves", {"batch": 1024, "grid": 128}),
        ("risk_dense", {"batch": 64, "p": 10000}),
        ("risk_sparse", {"batch": 64, "k": 10}),
        ("risk_sparse", {"batch": 1024, "k": 10}),
    ]
    rows = ["| kernel | shape | flops | bytes | flops/byte | compute s | "
            "memory s | bottleneck |",
            "|---|---|---|---|---|---|---|---|"]
    for name, shape in shapes:
        k = rl.kernel_roofline(name, **shape)
        sh = ",".join(f"{a}={v}" for a, v in shape.items())
        rows.append(
            f"| {name} | {sh} | {k.flops:.2e} | {k.bytes_accessed:.2e} "
            f"| {k.intensity:.2f} | {fmt_s(k.compute_s)} "
            f"| {fmt_s(k.memory_s)} | {k.bottleneck} |")
    return "\n".join(rows)


def latency_breakdown_table(trace_path):
    """Per-stage latency breakdown from a span JSONL file (obs.trace).

    One row per span name: call count, total/mean/p50/p99 milliseconds,
    and share of the summed root-span time — the table that attributes
    serving p99 to queueing vs batch formation vs dispatch.
    """
    spans = [r for r in obs_events.read_jsonl(trace_path)
             if r.get("kind") == "span" and "dur_s" in r]
    rows = ["| stage | count | total ms | mean ms | p50 ms | p99 ms | "
            "% of root |",
            "|---|---|---|---|---|---|---|"]
    if not spans:
        rows.append(f"| (no spans in {os.path.basename(str(trace_path))} — "
                    "set $REPRO_TRACE_FILE and re-run) | | | | | | |")
        return "\n".join(rows)
    root_total = sum(s["dur_s"] for s in spans if s.get("parent_id") is None)
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s["dur_s"] * 1e3)
    for name in sorted(by_name,
                       key=lambda n: -float(np.sum(by_name[n]))):
        d = np.asarray(by_name[name])
        pct = (d.sum() / (root_total * 1e3) * 100.0) if root_total > 0 \
            else 0.0
        rows.append(f"| {name} | {len(d)} | {d.sum():.2f} "
                    f"| {d.mean():.3f} | {np.percentile(d, 50):.3f} "
                    f"| {np.percentile(d, 99):.3f} | {pct:.1f} |")
    return "\n".join(rows)


def tuned_blocks_table(cache_path=None):
    """Autotune winners vs the static default blocks, per backend/bucket.

    Reads the tuned_blocks.json cache written by kernels/autotune.py (plus
    anything already registered in-process via roofline.register_tuned).
    """
    if cache_path:
        rl.load_tuned(cache_path)
    rows = ["| kernel | backend | bucket | tuned blocks | tuned us | "
            "default blocks | default us | speedup |",
            "|---|---|---|---|---|---|---|---|"]
    if not rl.TUNED_KERNELS:
        rows.append("| (no autotune winners recorded — run "
                    "`python -m repro_torch.kernels.autotune`) "
                    "| | | | | | | |")
        return "\n".join(rows)

    def blk(cfg):
        return ",".join(f"{k}={v}" for k, v in sorted((cfg or {}).items()))

    for key in sorted(rl.TUNED_KERNELS):
        e = rl.TUNED_KERNELS[key]
        backend, _, rest = key.partition("/")
        _, _, bucket = rest.partition("/")
        us, dus = e.get("us"), e.get("default_us")
        rows.append("| {} | {} | {} | {} | {} | {} | {} | {} |".format(
            e.get("kernel", key), backend, bucket, blk(e.get("config")),
            f"{us:.3f}" if us else "-", blk(e.get("default_config")),
            f"{dus:.3f}" if dus else "-",
            f"{dus / us:.2f}x" if us and dus else "-"))
    return "\n".join(rows)


def main(argv=None):
    from ..kernels import autotune
    from ..launch import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=dryrun.OUT_DIR)
    ap.add_argument("--tune-cache", default=autotune.cache_path())
    ap.add_argument("--trace", default=os.environ.get("REPRO_TRACE_FILE"),
                    help="span JSONL (obs.trace) to summarize into the "
                         "latency-breakdown table")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## Dry-run (one H100, meta device)\n")
    print(dryrun_table(one_card(recs)))
    print("\n## Roofline (one H100, per step)\n")
    print(roofline_table(one_card(recs)))
    if len(one_card(recs)) < len(recs):
        print("\n## Dry-run on the production meshes (per device, a fake "
              "world on meta)\n")
        print(mesh_table(recs))
    print("\n## Serving kernel roofline (scoring hot path, per call)\n")
    print(serving_kernel_table())
    print("\n## Tuned kernel blocks (autotune winners vs defaults)\n")
    print(tuned_blocks_table(args.tune_cache))
    if args.trace and os.path.exists(args.trace):
        print("\n## Per-stage latency breakdown (telemetry spans)\n")
        print(latency_breakdown_table(args.trace))


if __name__ == "__main__":
    main()
