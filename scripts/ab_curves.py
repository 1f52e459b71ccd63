#!/usr/bin/env python3
"""Variants of the survival-curve panel (``csrc/curves.cuh``) timed against
each other on one card.

    python3 scripts/ab_curves.py

Copies ``src/repro_torch/kernels/csrc`` into ``build/ab_curves/<variant>/``,
changes one thing in ``curves.cuh`` there, builds each copy with the
package's nvcc flags into a library of its own, and calls its two launchers
(``survival_curves``, ``survival_curves_stratified``) directly with plans
from ``kernels/survival_curves.py::plan``:

  - package: the sources as they are (one row a warp at a time; the
    single-baseline panel stored evict-first, the stratified one with
    plain stores; the 8-strata table staged in shared memory);
  - read_only: the package with the stratified table read a row at a time
    through ``__ldg`` (the plan's ``staged`` turned off);
  - rows_4, rows_8: the row loop unrolled by 4 or 8, so a warp has that
    many rows' exps and stores in flight;
  - plain_stores, evict_first_stores: both panels stored plainly, or both
    evict-first (``__stcs``);
  - flat_stage: the table staged as a flat copy, slot i from its i-th 16
    bytes, with no index arithmetic (right for the path's (8, 128) table
    alone, which is all the script runs);
  - staged_16: up to 16 strata staged (a thread's four loads), not 8 (two);

each at 1, 2, 4 and 8 blocks an SM (the plan's ``blocks_per_sm``, which
sets the rows a warp takes). Shapes: the scoring path's, b = 1, 64 and
4,096, g = 128, 8 strata. Each number is torch.profiler's device time a
call (the sum of the call's device operations over 100 calls), for the
kernel alone and, at b = 4,096, for the kernel followed by the engine's
``median_of`` pass over the panel; two rounds in opposite orders. Beside
them a device ``fill_`` of each panel (the bytes the kernels write),
before and after. Every variant's output is held against the plain
version (|err| <= 1e-6) and against the package's bits. Prints one JSON
line.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ab_curves"
REPORT: dict = {}  # variant -> ptxas register and spill lines

ROWS = "    for (int row = 0; row < rows; ++row) {  // the same in every lane"
STORE = "store_cols<VEC, !STRATIFIED>("
# the staging as a flat copy, slot i from the table's i-th VEC columns:
# right for a table whose chunk is all of it (g = 32 x VEC, the path's
# g = 128) and whose s x 32 slots fill a thread's loads (the path's s = 8)
LOADS = """    if (t < s && j * VEC < width)
      q[u] = __ldg(reinterpret_cast<const Cols<VEC>*>(
                       h0 + static_cast<size_t>(t) * g + c0) + j);"""
FLAT_LOADS = """    q[u] = __ldg(reinterpret_cast<const Cols<VEC>*>(h0) + i);"""
STRATA = "constexpr int kStagedStrata = 8;"
VARIANTS = {"package": [],
            "rows_4": [(ROWS, "#pragma unroll 4\n" + ROWS)],
            "rows_8": [(ROWS, "#pragma unroll 8\n" + ROWS)],
            "plain_stores": [(STORE, "store_cols<VEC, false>(")],
            "evict_first_stores": [(STORE, "store_cols<VEC, true>(")],
            "flat_stage": [(LOADS, FLAT_LOADS)],
            "staged_16": [(STRATA, STRATA.replace("8", "16"))]}
# the package's library with the stratified table read by __ldg
READ_ONLY = "read_only"
BLOCKS_PER_SM = (1, 2, 4, 8)
BATCHES, G, STRATA = (1, 64, 4096), 128, 8


def build(name: str, edits) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    path = dst / "curves.cuh"
    text = path.read_text()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path.write_text(text)
    objs, procs = [], []
    for fname in ("survival_curves.cu", "survival_curves_stratified.cu",
                  "errors.cu"):
        obj = dst / (Path(fname).stem + ".o")
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(dst / fname),
             "-o", str(obj)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{out}")
        REPORT.setdefault(name, []).extend(
            line.strip() for line in out.splitlines()
            if "registers" in line or "spill" in line)
    lib_path = dst / f"lib{name}.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib_path), *objs],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("repro_survival_curves", "repro_survival_curves_stratified"):
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = \
            _build._SIGNATURES[fn]
    return lib


def device_us(fn, reps: int = 100) -> float:
    """torch.profiler's device time a call of ``fn``, after a warm-up; NaN
    when three windows in a row record no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
        if busy > 0:
            return busy / reps
    return float("nan")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_curves.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    from repro_torch.kernels.survival_curves import plan

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    libs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    st = torch.cuda.current_stream().cuda_stream

    gen = torch.Generator(device="cuda").manual_seed(7)
    h0 = torch.cumsum(torch.rand(STRATA, G, device="cuda", generator=gen),
                      1) * 0.05
    grid = torch.linspace(0.0, 10.0, G, device="cuda")
    inputs = {}
    for b in BATCHES:
        eta = torch.randn(b, device="cuda", generator=gen) * 3.0
        eta[0] = 50.0
        if b > 1:
            eta[1] = -50.0
        strata = torch.randint(0, STRATA, (b,), device="cuda", generator=gen,
                               dtype=torch.int32)
        inputs[b] = (eta, strata, torch.empty(b, G, device="cuda"))

    def median_of(s):
        below = s <= 0.5
        hit = torch.any(below, dim=1)
        idx = torch.argmax(below.to(torch.uint8), dim=1)
        return torch.where(hit, grid[idx], torch.inf)

    def call(variant, kernel, b, bps):
        lib = libs["package" if variant == READ_ONLY else variant]
        eta, strata, out = inputs[b]
        if kernel == "survival_curves":
            pl = plan(b, G, sms, blocks_per_sm=bps)
            err = lib.repro_survival_curves(
                eta.data_ptr(), h0[0].data_ptr(), b, G, pl.blocks, pl.slab,
                pl.vec, pl.tail, out.data_ptr(), st)
        else:
            pl = plan(b, G, sms, STRATA, stratified=True, blocks_per_sm=bps)
            staged = pl.staged and variant != READ_ONLY
            err = lib.repro_survival_curves_stratified(
                eta.data_ptr(), h0.data_ptr(), strata.data_ptr(), b, G,
                STRATA, pl.blocks, pl.slab, pl.vec, pl.tail, int(staged),
                out.data_ptr(), st)
        assert err == 0, err
        return out

    configs = [(v, k, b, bps) for v in (*VARIANTS, READ_ONLY)
               for k in ("survival_curves", "survival_curves_stratified")
               if not (v == READ_ONLY and k == "survival_curves")
               for b in BATCHES for bps in BLOCKS_PER_SM]
    result = {"card": card, "torch": torch.__version__, "sms": sms,
              "ptxas": REPORT, "fill_us": {}, "plans": {}, "checks": {},
              "kernel_us": {}, "with_median_of_us": {}}
    for b in BATCHES:
        out = inputs[b][2]
        result["fill_us"][b] = [device_us(lambda: out.fill_(0.5))]
        result["plans"][b] = {bps: plan(b, G, sms, blocks_per_sm=bps)
                              for bps in BLOCKS_PER_SM}
    # every variant against the plain version and the package's bits
    for cfg in configs:
        v, k, b, bps = cfg
        eta, strata = inputs[b][:2]
        got = call(v, k, b, bps).clone()
        want = (ref.survival_curves_ref(eta, h0[0]) if k == "survival_curves"
                else ref.survival_curves_stratified_ref(eta, h0, strata))
        base = call("package", k, b, 4).clone()
        torch.cuda.synchronize()
        key = " ".join(map(str, cfg))
        result["checks"][key] = {
            "max_abs_err": float((got - want).abs().max()),
            "same_bits_as_package": bool(torch.equal(got, base))}
        assert result["checks"][key]["max_abs_err"] <= 1e-6, key
    for order in (configs, configs[::-1]):
        for cfg in order:
            v, k, b, bps = cfg
            key = " ".join(map(str, cfg))
            result["kernel_us"].setdefault(key, []).append(device_us(
                lambda: call(v, k, b, bps)))
            if b == BATCHES[-1]:
                result["with_median_of_us"].setdefault(key, []).append(
                    device_us(lambda: median_of(call(v, k, b, bps))))
    for b in BATCHES:
        out = inputs[b][2]
        result["fill_us"][b].append(device_us(lambda: out.fill_(0.5)))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
