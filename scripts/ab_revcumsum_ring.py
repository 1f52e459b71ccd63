#!/usr/bin/env python3
"""Compare the package's revcumsum panel kernel with the TMA-ring designs
of ``scripts/revcumsum_ring.cu`` on one card.

    python3 scripts/ab_revcumsum_ring.py

Builds the ring's variants (one library, ``nvcc`` with the package's
flags) into ``build/ab_ring/``, holds each against the plain version on the
streaming fit's (65,536, 1,000) panel and on a ragged (65,437, 1,000) one
(error over suffix(|x|), float32 and bfloat16) and checks that two calls
give the same bits; then times the package's kernel, every ring variant
(with and without 256-byte L2 promotion) and a device copy of the panel
(``clone``, the same bytes moved), in two rounds, the second in the reverse
order. Device time is torch.profiler's sum of a call's device operations;
beside it the CUDA-events median. Prints one JSON line and writes it to
``build/ab_ring/result.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "scripts" / "revcumsum_ring.cu"
ROWS, COLS = 65_536, 1_000
RAGGED = 65_437
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "ab_ring" / "libring.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(SRC), "-o",
           str(out)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.ring_variants.restype = ctypes.c_int
    lib.ring_variant_name.restype = ctypes.c_char_p
    lib.ring_variant_name.argtypes = [ctypes.c_int]
    lib.ring_revcumsum.restype = ctypes.c_int
    lib.ring_scratch_bytes.restype = ctypes.c_longlong
    lib.ring_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.ring_revcumsum.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_uint,
                                   ctypes.c_void_p, ctypes.c_void_p]
    return lib


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("ab_revcumsum_ring.py: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import device_ms, events_ms
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.revcumsum import revcumsum

    _build.library()
    lib = build()
    names = [lib.ring_variant_name(v).decode()
             for v in range(lib.ring_variants())]
    gen = torch.Generator(device="cuda").manual_seed(7)
    panels = {"float32": torch.randn(ROWS, COLS, device="cuda",
                                     generator=gen) * 0.5}
    panels["bfloat16"] = panels["float32"].to(torch.bfloat16)

    scratch = {}
    epoch = [0]

    def ring(v, x, promote):
        out = torch.empty_like(x)
        size = max(lib.ring_scratch_bytes(v, ROWS, COLS), 16)
        if v not in scratch:
            scratch[v] = torch.zeros(size, dtype=torch.uint8, device="cuda")
        epoch[0] += 1
        err = lib.ring_revcumsum(v, x.data_ptr(), x.shape[0], x.shape[1],
                                 promote, scratch[v].data_ptr(), epoch[0],
                                 out.data_ptr(), _build.stream())
        if err:
            raise RuntimeError(f"{names[v]}: CUDA error {err}")
        return out

    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "torch": torch.__version__,
        "checks": {}, "rounds": []}
    ok = True
    for v, name in enumerate(names):
        dtype = "bfloat16" if name.startswith("bf16") else "float32"
        for rows in (ROWS, RAGGED):
            x = panels[dtype][:rows]
            got = ring(v, x, 1)
            again = ring(v, x, 0)
            want = ref._suffix(x.double())
            scale = ref._suffix(x.double().abs()).clamp_min(1e-30)
            err = float(((got.double() - want).abs() / scale).max())
            same = bool(torch.equal(got, again))
            result["checks"][f"{name} n={rows}"] = {"err": err,
                                                    "same_bits": same}
            ok &= err <= TOL[dtype] and same
    torch.cuda.synchronize()

    cases = {}
    for dtype, x in panels.items():
        cases[f"package {dtype}"] = (lambda i, x=x: revcumsum(x))
        for v, name in enumerate(names):
            if name.startswith("bf16") == (dtype == "bfloat16"):
                for promote in (0, 1):
                    cases[f"ring {name} promote={promote}"] = (
                        lambda i, v=v, x=x, p=promote: ring(v, x, p))
    cases["copy float32"] = lambda i: panels["float32"].clone()
    order = list(cases)
    for rnd in (order, order[::-1]):
        row = {}
        for key in rnd:
            dev, _ = device_ms(cases[key], 50)
            row[key] = {"device_us": dev * 1e3,
                        "events_us": events_ms(cases[key], 50) * 1e3}
        result["rounds"].append(row)
    result["ok"] = ok
    line = json.dumps(result)
    print(line, flush=True)
    (ROOT / "build" / "ab_ring" / "result.json").write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
