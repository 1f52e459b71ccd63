#!/usr/bin/env python3
"""Time the scan kernels (cox_coord, revcumsum, cox_batch, lipschitz) and
the survival-curve kernels of one checkout on a card.

    python3 scripts/time_scan_kernels.py [--src DIR] [--label NAME]
                                         [--only NAME[,NAME...]]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its kernels, and prints one JSON line: for each kernel the device time a
call (torch.profiler's sum of the call's device operations, and that time
by operation) and the median time a call by CUDA events, at the main
path's shapes:

  - cox_coord at n = 262,144 with ties in groups of ~64, a new feature row
    each call out of 64 (64 MB, more than the L2 holds), order 2; given its
    per-fit group counts where the wrapper takes them;
  - revcumsum on the streaming fit's (65,536, 1,000) panel, float32 and
    bfloat16, on (65,536, m) float32 panels of m = 32 (the narrowest that
    takes the panel layout), 256 and 512, and on the (65,536,) hazard
    vector; beside them a device
    copy of the float32 panel (``clone``), which moves the bytes the scan
    must move;
  - cox_batch on the same (65,536, 1,000) panel, float32 and bfloat16, with
    the five vectors the chunk-mode fit forms, and lipschitz at
    (262,144, 1,000) float32 given the fit's group counts; beside each a
    read-only yardstick of the same panel, its column sum ``x.sum(0)``;
  - survival_curves and survival_curves_stratified (8 strata) at the
    scoring path's batches, b = 1, 64 and 4,096, g = 128, eta ~ 3 N(0, 1);
    beside them a device ``fill_`` of the (b, 128) float32 panel, which
    writes the bytes the kernels write;

the SHA-256 of the revcumsum, cox_batch, lipschitz and curve outputs (two
checkouts whose digests agree gave the same bits); and the wall time (host
clock, ended by a synchronise) of the paths they serve, cut in depth: a
``cd_quad`` sweep of ``fit_cd`` at n = 262,144, p = 1,000 (x ~ N(0, 1)
made on the card, times with ties in groups of ~64; the median of 3
one-sweep fits after a warm-up fit, each fit's Lipschitz pass included),
and one ``fit_stream`` epoch over 16 chunks of (65,536, 1,000) in global
and in chunk mode (the median of 3 after a warm-up).

``--only`` keeps the kernel cases and digests whose names contain one of
the given strings (``--only survival_curves,fill_``) and skips the wall
times. To compare two versions on one card, run it on both in one
command, in turns (parent, change, change, parent), the parent unpacked
with ``git archive`` into a directory that .gitignore lists.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def by_kernel_us(fn, reps: int) -> dict:
    """Device microseconds a call of ``fn`` spends in each of its device
    operations, by torch.profiler, after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = (e.name.replace("void (anonymous namespace)::", "")
                   .split("(")[0])
            out[key] = out.get(key, 0.0) + e.device_time_total / reps
    return out


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("time_scan_kernels.py: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import batch_vectors, device_ms, events_ms
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.cox_batch import cox_batch
    from repro_torch.kernels.cox_coord import cox_coord
    from repro_torch.kernels.lipschitz import lipschitz
    from repro_torch.kernels.revcumsum import revcumsum
    from repro_torch.kernels.survival_curves import (
        survival_curves, survival_curves_stratified)

    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n, rows = 262_144, 64
    eta = torch.randn(n, device="cuda", generator=gen) * 0.8
    xs = torch.randn(rows, n, device="cuda", generator=gen)
    d = (torch.rand(n, device="cuda", generator=gen) < 0.7).float()
    t = torch.sort(torch.randint(0, n // 64, (n,), device="cuda",
                                 generator=gen)).values
    rs = torch.searchsorted(t, t, side="left").to(torch.int32)
    kw = {}
    if "group_events" in inspect.signature(cox_coord).parameters:
        kw["group_events"] = ops.group_events(d, rs)

    def coord(i):
        return cox_coord(eta, xs[i % rows], d, rs, **kw)

    panel = torch.randn(65_536, 1_000, device="cuda", generator=gen) * 0.5
    panel16 = panel.to(torch.bfloat16)
    vector = torch.rand(65_536, device="cuda", generator=gen)
    narrow = panel[:, :32].contiguous()
    mid = panel[:, :256].contiguous()
    half = panel[:, :512].contiguous()
    cases = {"cox_coord n=262144": (coord, 400),
             "revcumsum (65536, 1000) float32": (lambda i: revcumsum(panel),
                                                 50),
             "copy (65536, 1000) float32": (lambda i: panel.clone(), 50),
             "revcumsum (65536, 32) float32": (lambda i: revcumsum(narrow),
                                               200),
             "revcumsum (65536, 256) float32": (lambda i: revcumsum(mid),
                                                100),
             "revcumsum (65536, 512) float32": (lambda i: revcumsum(half),
                                                100),
             "revcumsum (65536, 1000) bfloat16": (
                 lambda i: revcumsum(panel16), 50),
             "revcumsum (65536,)": (lambda i: revcumsum(vector), 400)}
    vecs = batch_vectors(torch.randn(65_536, device="cuda", generator=gen)
                         * 0.5, (torch.rand(65_536, device="cuda",
                                            generator=gen) < 0.5).float())
    tall = torch.randn(n, 1_000, device="cuda", generator=gen)
    tall_groups = ops.group_events(d, rs)
    cases.update({
        "cox_batch (65536, 1000) float32": (
            lambda i: cox_batch(panel, *vecs), 50),
        "cox_batch (65536, 1000) bfloat16": (
            lambda i: cox_batch(panel16, *vecs), 50),
        "x.sum(0) (65536, 1000) float32": (lambda i: panel.sum(0), 50),
        "x.sum(0) (65536, 1000) bfloat16": (lambda i: panel16.sum(0), 50),
        "lipschitz (262144, 1000) float32, given D": (
            lambda i: lipschitz(tall, d, rs, group_events=tall_groups), 20),
        "x.sum(0) (262144, 1000) float32": (lambda i: tall.sum(0), 20)})
    h0 = torch.cumsum(torch.rand(8, 128, device="cuda", generator=gen),
                      1) * 0.05
    curves_in = {}
    for b in (1, 64, 4_096):
        e = torch.randn(b, device="cuda", generator=gen) * 3.0
        sb = torch.randint(0, 8, (b,), device="cuda", generator=gen,
                           dtype=torch.int32)
        fill = torch.empty(b, 128, device="cuda")
        curves_in[b] = (e, sb)
        cases.update({
            f"survival_curves ({b}, 128)": (
                lambda i, e=e: survival_curves(e, h0[0]), 400),
            f"survival_curves_stratified ({b}, 128) s=8": (
                lambda i, e=e, sb=sb: survival_curves_stratified(e, h0, sb),
                400),
            f"fill_ ({b}, 128) float32": (lambda i, f=fill: f.fill_(0.5),
                                          400)})
    only = [s for s in args.only.split(",") if s]

    def kept(name):
        return not only or any(s in name for s in only)
    cases = {name: case for name, case in cases.items() if kept(name)}
    out = {"label": args.label, "torch": torch.__version__,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip()}
    for name, (fn, reps) in cases.items():
        dev_ms, _ = device_ms(fn, reps)
        out[name] = {"device_us": dev_ms * 1e3,
                     "events_us": events_ms(fn, reps) * 1e3,
                     "by_kernel_us": by_kernel_us(fn, reps)}
    out["inputs_sha256"] = digest([panel, *vecs, tall, d, rs, tall_groups])
    out["sha256"] = {
        "revcumsum (65536, 1000) float32": digest([revcumsum(panel)]),
        "revcumsum (65536, 1000) bfloat16": digest([revcumsum(panel16)]),
        "revcumsum (65536, 33) float32": digest(
            [revcumsum(panel[:, :33].contiguous())]),
        "revcumsum (65536,)": digest([revcumsum(vector)]),
        "cox_batch (65536, 1000) float32": digest(cox_batch(panel, *vecs)),
        "cox_batch (65536, 1000) bfloat16": digest(
            cox_batch(panel16, *vecs)),
        "lipschitz (262144, 1000) float32": digest(
            lipschitz(tall, d, rs, group_events=tall_groups))}
    for b, (e, sb) in curves_in.items():
        out["sha256"][f"survival_curves ({b}, 128)"] = digest(
            [survival_curves(e, h0[0])])
        out["sha256"][f"survival_curves_stratified ({b}, 128) s=8"] = digest(
            [survival_curves_stratified(e, h0, sb)])
    out["sha256"] = {k: v for k, v in out["sha256"].items() if kept(k)}
    del xs, panel, panel16, narrow, mid, half, tall
    torch.cuda.empty_cache()
    if only:
        print(json.dumps(out), flush=True)
        return 0

    from repro_torch.core import cox, solvers
    from repro_torch.core.streaming import Chunk

    def wall_s(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    data = cox.prepare(torch.randn(n, 1_000, device="cuda", generator=gen),
                       t.float(), d, device="cuda")
    out["cd_quad sweep n=262144 p=1000 s"] = wall_s(
        lambda: solvers.fit_cd(data, lam1=1.0, lam2=1.0, n_iters=1))
    del data
    torch.cuda.empty_cache()
    chunks = [Chunk(x=torch.randn(65_536, 1_000, device="cuda",
                                  generator=gen) * 0.5,
                    delta=(torch.rand(65_536, device="cuda", generator=gen)
                           < 0.5).float()) for _ in range(16)]
    for mode in ("global", "chunk"):
        out[f"{mode} epoch 16 x (65536, 1000) s"] = wall_s(
            lambda: solvers.fit_stream(chunks, lam2=0.01, n_epochs=1,
                                       mode=mode))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
