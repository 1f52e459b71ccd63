#!/usr/bin/env python3
"""Where the time of the strip-tile kernels (cox_batch, lipschitz) goes,
and whether they repeat their bits, on one card.

    python3 scripts/ab_strip_kernels.py

Copies ``src/repro_torch/kernels/csrc`` into ``build/ab_strip/<variant>/``,
takes one step out of ``cox_batch.cu`` and ``lipschitz.cu`` there, builds
each copy with the package's nvcc flags into a library of its own, and
times each kernel by CUDA events at the main path's shapes, cox_batch on a
(65,536, 1,000) panel in float32 and bfloat16 and lipschitz on
(262,144, 1,000) float32, in two rounds in opposite orders:

  - package: the sources as they are;
  - no_sum: each tile writes its float64 partials and ends, with no fence,
    counter or fixed-order sum (grad, hess, L2, L3 are not written);
  - no_carry: no tile waits for the later segments: the carry is the
    identity (the results are wrong);
  - no_sum_no_carry: both;
  - l2_256: the panel loads ask the L2 for 256 bytes (the line the
    neighbouring strip's tile reads next), the rest as the package;
  - serial_wait: a thread that waits on two carry words (a bfloat16 pair,
    lipschitz's max and min) polls them one after the other;
  - blocks_5, blocks_6: launch bounds of 5 or 6 blocks an SM in place of
    4 (more bytes in flight, fewer registers a thread).

Beside them, ``x.sum(0)`` and a device copy of each panel. The inputs are
made on the host from a seed, so two processes give the kernels the same
bits; the package build's outputs are called 30 times, interleaved with
the other kernels, and their SHA-256 is printed, so two runs of this
script (or two cards) can be compared. Prints one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ab_strip"
REPORT: dict = {}  # variant -> ptxas register and spill lines

SUM_CALL = """  if (!strip::sum_partials<kParts>(parts, mine, strips, tile, nseg, epoch,
                                   &sum))
    return;"""
NO_SUM = """  if (threadIdx.x < kParts * kCols)
    parts.tiles[(static_cast<size_t>(tile.seg) * strips + tile.strip) *
                    kParts * kCols + threadIdx.x] = mine;
  return;"""
CARRY = {
    "cox_batch.cu": ("""  strip::carry_from_below<strip::Sum, L::kWindow, SLOTS>(
      words, col, total, strips, tile, nseg, grp, c, epoch, carry);""",
                     """  for (int u = 0; u < W; ++u) carry[u] = 0.f;"""),
    "lipschitz.cu": ("""  strip::carry_from_below<strip::MaxMin, L::kWindow, SLOTS>(
      words, col, total, strips, tile, nseg, grp, c, epoch, carry);""",
                     """  carry[0] = -INFINITY;
  carry[1] = INFINITY;"""),
}
# the panel loads of strip.cuh with a 256-byte L2 prefetch
LOADS = {
    """    return x[o];""": """    float v;
    asm("ld.global.nc.L2::256B.f32 %0, [%1];" : "=f"(v) : "l"(x + o));
    return v;""",
    """    return *reinterpret_cast<const __nv_bfloat162*>(x + o);""": """    unsigned u;
    asm("ld.global.nc.L2::256B.b32 %0, [%1];" : "=r"(u) : "l"(x + o));
    return *reinterpret_cast<__nv_bfloat162*>(&u);""",
}
# the carry words of strip.cuh polled one after another, not together
POLL = ("""      wait_for(src, epoch, in);""",
        """      for (int v = 0; v < NV; ++v) {
        const unsigned long long* one[1] = {src[v]};
        float got[1];
        wait_for(one, epoch, got);
        in[v] = got[0];
      }""")
# more blocks an SM, fewer registers a thread (ptxas spills what is left)
BOUNDS = "__launch_bounds__(strip::kThreads, 4)"
VARIANTS = {"package": (), "no_sum": ("sum",), "no_carry": ("carry",),
            "no_sum_no_carry": ("sum", "carry"), "l2_256": ("l2",),
            "serial_wait": ("serial",), "blocks_5": ("5",),
            "blocks_6": ("6",)}


def build(name: str, steps) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    path = dst / "strip.cuh"
    text = path.read_text()
    for old, new in ((list(LOADS.items()) if "l2" in steps else [])
                     + ([POLL] if "serial" in steps else [])):
        assert old in text
        text = text.replace(old, new)
    path.write_text(text)
    for fname in ("cox_batch.cu", "lipschitz.cu"):
        path = dst / fname
        text = path.read_text()
        if "sum" in steps:
            assert SUM_CALL in text, fname
            text = text.replace(SUM_CALL, NO_SUM)
        if "carry" in steps:
            old, new = CARRY[fname]
            assert old in text, fname
            text = text.replace(old, new)
        for blocks in ("5", "6"):
            if blocks in steps:
                assert BOUNDS in text, fname
                text = text.replace(BOUNDS, BOUNDS.replace("4", blocks))
        path.write_text(text)
    objs, procs = [], []
    for fname in ("cox_batch.cu", "lipschitz.cu", "errors.cu"):
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
    for fn in ("repro_cox_batch_scratch_bytes", "repro_cox_batch",
               "repro_lipschitz_scratch_bytes", "repro_lipschitz"):
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = \
            _build._SIGNATURES[fn]
    return lib


class Runner:
    """Calls one library's kernels as the package's wrappers do."""

    def __init__(self, lib):
        import torch

        self.lib, self.epoch, self.scratch = lib, 0, {}
        self.torch = torch

    def _buf(self, key, nbytes):
        buf = self.scratch.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = self.torch.zeros(nbytes, dtype=self.torch.uint8,
                                   device="cuda")
            self.scratch[key] = buf
        return buf

    def cox_batch(self, x, vecs, out):
        n, p = x.shape
        bf16 = int(x.dtype == self.torch.bfloat16)
        tagged, part = (self._buf(("cb", k), self.lib
                                  .repro_cox_batch_scratch_bytes(n, p, bf16,
                                                                 k))
                        for k in (0, 1))
        self.epoch += 1
        st = self.torch.cuda.current_stream().cuda_stream
        err = self.lib.repro_cox_batch(
            x.data_ptr(), *(v.data_ptr() for v in vecs), n, p, bf16,
            tagged.data_ptr(), part.data_ptr(), self.epoch,
            out[0].data_ptr(), out[1].data_ptr(), st)
        assert err == 0, err

    def lipschitz(self, x, dsum, out):
        n, p = x.shape
        tagged, part = (self._buf(("lip", k), self.lib
                                  .repro_lipschitz_scratch_bytes(n, p, k))
                        for k in (0, 1))
        self.epoch += 1
        st = self.torch.cuda.current_stream().cuda_stream
        err = self.lib.repro_lipschitz(
            x.data_ptr(), dsum.data_ptr(), n, p, tagged.data_ptr(),
            part.data_ptr(), self.epoch, out[0].data_ptr(),
            out[1].data_ptr(), st)
        assert err == 0, err


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_strip_kernels.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import events_ms
    from time_scan_kernels import digest

    def events_us(fn, reps: int) -> float:
        return events_ms(lambda i: fn(), reps) * 1e3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    libs = {name: build(name, steps) for name, steps in VARIANTS.items()}

    # inputs made on the host, so every process hands the kernels the
    # same bits
    rng = np.random.default_rng(11)
    n, p, tall_n = 65_536, 1_000, 262_144
    x = torch.from_numpy(rng.standard_normal((n, p), np.float32) * 0.5)
    eta = rng.standard_normal(n) * 0.5
    d = (rng.uniform(size=n) < 0.5).astype(np.float64)
    w = np.exp(eta - eta.max())
    inv_s0 = 1.0 / np.cumsum(w[::-1])[::-1]
    wa = w * np.cumsum(d * inv_s0)
    vecs = [torch.from_numpy(v.astype(np.float32)).cuda()
            for v in (w, wa - d, wa, d, inv_s0)]
    x = x.cuda()
    x16 = x.to(torch.bfloat16)
    tall = torch.from_numpy(
        rng.standard_normal((tall_n, p), np.float32)).cuda()
    starts = np.sort(rng.integers(0, tall_n // 64, tall_n))
    first = np.searchsorted(starts, starts, side="left")
    dl = (rng.uniform(size=tall_n) < 0.7).astype(np.float64)
    dsum = np.zeros(tall_n)
    np.add.at(dsum, first, dl)
    dsum = torch.from_numpy(dsum.astype(np.float32)).cuda()
    outs = torch.empty(2, p, device="cuda")

    runners = {name: Runner(lib) for name, lib in libs.items()}
    cases = {
        "cox_batch (65536, 1000) float32": lambda r: r.cox_batch(x, vecs,
                                                                 outs),
        "cox_batch (65536, 1000) bfloat16": lambda r: r.cox_batch(x16, vecs,
                                                                  outs),
        "lipschitz (262144, 1000) float32": lambda r: r.lipschitz(tall, dsum,
                                                                  outs),
    }
    reps = {"cox_batch (65536, 1000) float32": 50,
            "cox_batch (65536, 1000) bfloat16": 50,
            "lipschitz (262144, 1000) float32": 20}
    result = {"card": card, "torch": torch.__version__,
              "yardsticks_us": {
                  "x.sum(0) (65536, 1000) float32": events_us(
                      lambda: x.sum(0), 50),
                  "x.sum(0) (65536, 1000) bfloat16": events_us(
                      lambda: x16.sum(0), 50),
                  "x.sum(0) (262144, 1000) float32": events_us(
                      lambda: tall.sum(0), 20),
                  "copy (65536, 1000) float32": events_us(
                      lambda: x.clone(), 50),
                  "copy (262144, 1000) float32": events_us(
                      lambda: tall.clone(), 20)}}
    order = list(VARIANTS)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            for case, fn in cases.items():
                result.setdefault(case, {}).setdefault(name, []).append(
                    events_us(lambda: fn(runners[name]), reps[case]))

    # bits: the package's outputs over 30 interleaved calls
    pkg = runners["package"]
    seen = {case: set() for case in cases}
    for _ in range(30):
        for case, fn in cases.items():
            fn(pkg)
            seen[case].add(digest([outs]))
    result["sha256"] = {case: sorted(s) for case, s in seen.items()}
    result["inputs_sha256"] = digest([x, *vecs, tall, dsum])
    result["ptxas"] = REPORT
    print(json.dumps(result), flush=True)
    (OUT / "result.json").write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
