"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by ``nvcc`` into an
object file, all sources at once in parallel, and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
is rebuilt on first use and an unchanged one is loaded as it is.

Nothing is built at import: ``library()`` builds on its first call. A
failed build raises ``KernelBuildError`` with the compiler's output; there
is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> (restype, argtypes) of every C entry point
_SIGNATURES = {
    "repro_error_string": (ctypes.c_char_p, [_I]),
    "repro_cox_coord_scratch_floats": (ctypes.c_longlong, [_I, _I, _I]),
    "repro_cox_coord": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]),
    "repro_cox_coord_step": (_I, [_P, _P, _P, ctypes.c_longlong, _P, _P, _I,
                                  _I, _P, _P, _I, ctypes.c_float, _P, _P,
                                  _P, _P, _P]),
    "repro_lipschitz_scratch_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    "repro_lipschitz": (_I, [_P, _P, _I, _I, _P, _P, ctypes.c_uint, _P, _P,
                             _P]),
    "repro_survival_curves": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
    "repro_revcumsum_scratch_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    "repro_revcumsum": (_I, [_P, _I, _I, _I, _P, ctypes.c_uint, _P, _P]),
    "repro_cox_batch_scratch_bytes": (ctypes.c_longlong, [_I, _I, _I, _I]),
    "repro_cox_batch": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                             ctypes.c_uint, _P, _P, _P]),
    "repro_survival_curves_stratified": (_I, [_P, _P, _P, _I, _I, _I, _I, _I,
                                              _I, _I, _I, _P, _P]),
    "repro_ssd_scan": (_I, [_P, ctypes.c_longlong, _I, _P, _P,
                            ctypes.c_longlong, _I, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _P]),
    "repro_flash_attn": (_I, [_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _LL,
                              _LL, _LL, _P, _I, _I, _I, _I, _I, _I, _P]),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# (owner, device, stream) -> a buffer that a wrapper keeps (scratch())
_SCRATCH: dict = {}
# seconds the build took in this process (0.0 when an existing library was
# loaded), and the compiler's -Xptxas -v report
build_seconds = 0.0
build_log = ""


class LaunchCounts:
    """Calls that launched each kernel, by kernel name. A wrapper adds one
    after its launch and nowhere else (a batched ``cox_coord`` call adds
    one a candidate coordinate); the serving threads launch from several
    host threads at once, so every read and write holds a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict = {}

    def add(self, kernel: str, count: int = 1) -> None:
        with self._lock:
            self._counts[kernel] = self._counts.get(kernel, 0) + count

    def read(self, kernels) -> dict:
        with self._lock:
            return {k: self._counts.get(k, 0) for k in kernels}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


# the process's counts, read by ops.launch_counts()
LAUNCHES = LaunchCounts()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A launcher returned a CUDA error."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found on PATH or under $CUDA_HOME/bin")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> str:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n{log}")
        staged = Path(tmp) / target.name
        link = [nvcc, "-shared", "-o", str(staged),
                *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{res.stdout}")
        # atomic: a concurrent loader sees all of the library or none
        os.replace(staged, target)
    (target.parent / (target.stem + ".log")).write_text(log)
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _LIB, build_seconds, build_log
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
        if not target.exists():
            t0 = time.perf_counter()
            build_log = _compile(target)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise ``KernelLaunchError`` for a nonzero CUDA error code."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise KernelLaunchError(f"{what}: CUDA error {err} ({msg})")


def stream() -> int:
    """Handle of PyTorch's current CUDA stream, for a launcher."""
    return torch.cuda.current_stream().cuda_stream


def scratch(owner: str, numel: int, dtype: torch.dtype,
            device: torch.device, stream_handle: int) -> torch.Tensor:
    """A wrapper's own buffer of at least ``numel`` elements on ``device``,
    kept for the stream ``stream_handle`` (``stream()``) and handed back by
    every later call there, so a call allocates nothing. Zeroed when first
    made or grown; what the kernels leave in it between calls is theirs to
    keep consistent."""
    key = (owner, device, stream_handle)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.zeros(numel, dtype=dtype, device=device)
        _SCRATCH[key] = buf
    return buf


def require(what: str, tensors: dict, shapes: dict, cuda_dtypes: dict) -> bool:
    """Validate a wrapper's arguments; True when they lie on a CUDA card.

    Every tensor must have the shape given in ``shapes`` (a tuple of ints),
    be contiguous and lie on the device of the first. On a card each must
    have the dtype the kernel takes (``cuda_dtypes``); on the CPU, where the
    plain version runs, floating tensors may be any float type and integer
    ones any integer type. Any other device raises."""
    first = next(iter(tensors.values()))
    device = first.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {device} are not supported")
    on_card = device.type == "cuda"
    for name, t in tensors.items():
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[name])}")
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        want = cuda_dtypes[name]
        if on_card:
            ok = t.dtype == want
        elif want.is_floating_point:
            ok = t.dtype.is_floating_point
        else:
            ok = not t.dtype.is_floating_point and t.dtype != torch.bool
        if not ok:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; the kernel "
                            f"takes {want}")
    return on_card
