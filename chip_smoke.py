#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it puts ``src`` on ``sys.path`` itself.
Phases, each printed as it runs; any failed check raises:

  1. device: the card's name and power limit (nvidia-smi), then the build
     of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
  2. kernels against their plain PyTorch versions on the card, on tie-free
     data, on small tie groups and with one group of a quarter of the rows,
     each maximum error beside its tolerance;
  3. fit: Appendix-C data at n = 262,144, p = 1,000 (rho 0.9, k 15, seed 0),
     ``fit_cd`` with cd_quad for 10 sweeps and cd_cubic for 3; the
     objective must not rise; cox_coord must launch p x sweeps times and
     lipschitz once per fit;
  4. artifact: ``fit_survival_model``, then save / load with checksums;
  5. serving: ``ScoringEngine.score(with_curves=True)`` on 1, 64 and 4,096
     requests against the closed form;
  then, with the main path's launch counts read, the fit's kernel path
  against its plain path over the first 2 sweeps of each method: the same
  kernel fit again must give the same bits, and the plain fit the same
  objective and beta within tolerance;
  6. timings: each kernel's median time (CUDA events) and device time
     (torch.profiler) at the main path's shapes, beside its bound and its
     plain version's; the host time of the cox_coord wrapper's checks and
     counters; the device's idle share over one sweep of each method.

Kernel launch counts are zeroed just before phase 3 and read just after
phase 5. The line before the last is one JSON object with every kernel's
numbers; the last is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository beside it, the script exits nonzero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N, P, RHO, K, SEED = 262_144, 1_000, 0.9, 15, 0
QUAD_SWEEPS, CUBIC_SWEEPS, COMPARE_SWEEPS = 10, 3, 2
BATCHES = (1, 64, 4096)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM, non-tensor float32

# tolerances, with their reasons
COORD_TOL = 1e-6     # |kernel - plain| <= COORD_TOL * sum_i |term_i|: float32
                     # sums over n in two orders, scaled by the terms' size
LIPSCHITZ_RTOL = 1e-5  # same ranges; float32 (plain) vs float64 (kernel) sums
CURVES_ATOL = 1e-6   # probabilities in [0, 1]; expf vs exp, a few ulp
FIT_DTOL = 1e-3      # |objective, kernel path - plain path| over the first
                     # sweeps, in units of the plain path's second-sweep
                     # decrease; the objective is ~4e5 with a float32 ulp of
                     # 0.03, a sweep's decrease ~1e3
BETA_RTOL = 1e-4     # max |beta, kernel - plain| / max |beta| after those
                     # sweeps: (g, h) agree to ~2e-7 of sum|terms| (phase 2)
                     # and each step is (g, h)'s ratio, over 2 x p dependent
                     # steps
MONO_RTOL = 1e-6     # allowed objective rise per sweep, float32 round-off
ARTIFACT_RTOL = 1e-4  # float32 baseline, card vs CPU cumulative sums

# the TPU kernel each CUDA kernel replaces (its pallas_call)
REPLACES = {
    "cox_coord": "src/repro/kernels/cox_coord.py:101",
    "lipschitz": "src/repro/kernels/lipschitz.py:78",
    "survival_curves": "src/repro/kernels/survival_curves.py:47",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def events_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up call. When the host issues the
    calls more slowly than the device runs them, this is the host's rate."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int):
    """(device ms, wall ms) per call of ``fn`` after a warm-up call.

    Device time is the sum of the CUDA activity (kernels, memsets, copies)
    that torch.profiler records over ``reps`` calls; wall time is the host
    clock around them, ended by a synchronise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    check(busy_us > 0, "torch.profiler recorded no device activity")
    return busy_us / reps / 1e3, wall / reps * 1e3


def kernel_ms(fn, reps: int, rounds: int = 5):
    """(CUDA-events median ms, profiler device ms) per call."""
    return events_ms(fn, reps, rounds), device_ms(fn, reps)[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

TIES = ("none", "small", "quarter")


def _risk_start(n: int, ties: str, gen):
    """Sorted tie-group starts: each sample's own index ("none"), groups of
    ~64 ("small"), or groups of ~64 and the last quarter of the rows in one
    group, as administrative censoring at one date gives ("quarter")."""
    import torch

    if ties == "none":
        return torch.arange(n, dtype=torch.int32, device="cuda")
    t = torch.sort(torch.randint(0, max(n // 64, 1), (n,), device="cuda",
                                 generator=gen)).values
    if ties == "quarter":
        t[n - max(n // 4, 1):] = t[-1] + 1
    return torch.searchsorted(t, t, side="left").to(torch.int32)


def _coord_scales(eta, x, d, rs, order):
    """sum_i delta_i |each part of term_i| for g, h, c3, in float64."""
    import torch

    from repro_torch.kernels import ref

    e, xx, dd = eta.double(), x.double(), d.double()
    w = torch.exp(e - e.max())
    s = [ref._at(ref._suffix(w * xx ** r), rs) for r in range(4)]
    m = [s[r] / s[0] for r in range(4)]
    sg = torch.sum(dd * (m[1].abs() + xx.abs()))
    sh = torch.sum(dd * (m[2].abs() + m[1] ** 2))
    sc = torch.sum(dd * (m[3].abs() + 2 * m[1].abs() ** 3
                         + 3 * (m[2] * m[1]).abs()))
    return [float(sg), float(sh), float(sc) if order == 3 else 1.0]


def check_kernels(coord_ns=(1, 1000, N), lip_ps=(1, 37, P), lip_n=N,
                  curve_bs=(1, 37, 4096), curve_gs=(128, 257)) -> dict:
    """Every kernel against its plain version on the card; returns the
    largest absolute error of each."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.cox_coord import cox_coord
    from repro_torch.kernels.lipschitz import lipschitz
    from repro_torch.kernels.survival_curves import survival_curves

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {"cox_coord": 0.0, "lipschitz": 0.0, "survival_curves": 0.0}

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    for n in coord_ns:
        for ties in TIES:
            eta, x = randn(n) * 0.8, randn(n)
            d = (torch.rand(n, device="cuda", generator=gen) < 0.7).float()
            rs = _risk_start(n, ties, gen)
            for order in (2, 3):
                got = cox_coord(eta, x, d, rs, order=order)
                want = torch.stack(ref.cox_coord_ref(eta, x, d, rs, order))
                torch.cuda.synchronize()
                err = (got - want).abs().double().cpu().tolist()
                scales = _coord_scales(eta, x, d, rs, order)
                worst = max(e / s for e, s in zip(err, scales))
                log(f"  cox_coord n={n} ties={ties} order={order}: "
                    f"max |err| {max(err):.3e}, max |err|/sum|terms| "
                    f"{worst:.3e} (tol {COORD_TOL:.0e})")
                check(worst <= COORD_TOL and torch.isfinite(got).all(),
                      f"cox_coord n={n} ties={ties} order={order}")
                errs["cox_coord"] = max(errs["cox_coord"], max(err))

    for p in lip_ps:
        for ties in TIES:
            x = randn(lip_n, p)
            d = (torch.rand(lip_n, device="cuda", generator=gen) < 0.7).float()
            rs = _risk_start(lip_n, ties, gen)
            got = lipschitz(x, d, rs)
            want = ref.lipschitz_ref(x, d, rs)
            del x
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            rel = max(float(((g - w).abs() / w.abs()).max())
                      for g, w in zip(got, want))
            log(f"  lipschitz n={lip_n} p={p} ties={ties}: max |err| "
                f"{err:.3e}, max rel err {rel:.3e} (tol {LIPSCHITZ_RTOL:.0e})")
            check(rel <= LIPSCHITZ_RTOL, f"lipschitz p={p} ties={ties}")
            errs["lipschitz"] = max(errs["lipschitz"], err)
            torch.cuda.empty_cache()

    for b in curve_bs:
        for g in curve_gs:
            eta = randn(b) * 3.0
            eta[0] = 50.0
            if b > 1:
                eta[1] = -50.0
            h0 = torch.cumsum(torch.rand(g, device="cuda", generator=gen),
                              0) * 0.05
            got = survival_curves(eta, h0)
            want = ref.survival_curves_ref(eta, h0)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            log(f"  survival_curves b={b} g={g}: max |err| {err:.3e} "
                f"(tol {CURVES_ATOL:.0e})")
            check(err <= CURVES_ATOL and bool(torch.isfinite(got).all()),
                  f"survival_curves b={b} g={g}")
            errs["survival_curves"] = max(errs["survival_curves"], err)
    return errs


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------

def run_fit(data, lam1, lam2, method, sweeps):
    import torch

    from repro_torch.core import solvers
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solvers.fit_cd(data, lam1=lam1, lam2=lam2, n_iters=sweeps,
                         method=method)
    obj = res.objective.cpu().double()
    seconds = time.perf_counter() - t0
    after = ops.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    log(f"  {method}: {sweeps} sweeps in {seconds:.3f} s "
        f"({seconds / sweeps:.4f} s per sweep); objective "
        f"{obj[0]:.6f} -> {obj[-1]:.6f}; launches {launched}")
    check(bool(torch.isfinite(obj).all()), f"{method}: objective finite")
    rises = obj[1:] - obj[:-1]
    check(bool((rises <= MONO_RTOL * obj[:-1].abs()).all()),
          f"{method}: objective rose: {obj.tolist()}")
    check(launched["cox_coord"] == data.p * sweeps,
          f"{method}: cox_coord launched {launched['cox_coord']} times, "
          f"expected p x sweeps = {data.p * sweeps}")
    check(launched["lipschitz"] == 1, f"{method}: lipschitz launched "
          f"{launched['lipschitz']} times, expected 1")
    return res, seconds / sweeps


def compare_fits(data, lam1, lam2, fits) -> None:
    """The fit's kernel path against its plain path over the first
    COMPARE_SWEEPS sweeps of each method. Run after the main path's launch
    counts are read: these launches only compare."""
    import torch

    from repro_torch.core import solvers

    log("fit: kernel path against the plain path")
    for method, main in fits.items():
        kern, plain = (solvers.fit_cd(data, lam1=lam1, lam2=lam2,
                                      n_iters=COMPARE_SWEEPS, method=method,
                                      use_kernel=use)
                       for use in (True, False))
        kobj = kern.objective.cpu().double()
        pobj = plain.objective.cpu().double()
        same = torch.equal(kobj,
                           main.objective[:COMPARE_SWEEPS].cpu().double())
        decrease = float(pobj[0] - pobj[1])
        dobj = float((kobj - pobj).abs().max())
        dbeta = float((kern.beta - plain.beta).abs().max())
        bmax = float(plain.beta.abs().max())
        log(f"  {method}, {COMPARE_SWEEPS} sweeps: plain objective "
            f"{pobj.tolist()}, second-sweep decrease {decrease:.6f}; "
            f"max |objective diff| {dobj:.6f} = {dobj / decrease:.3e} of it "
            f"(tol {FIT_DTOL:.0e}); max |beta diff| {dbeta:.3e} of max "
            f"|beta| {bmax:.4f} = {dbeta / bmax:.3e} (tol {BETA_RTOL:.0e}); "
            f"kernel fit repeats the main fit's objective bit for bit: {same}")
        check(same, f"{method}: the kernel fit did not repeat its bits")
        check(decrease > 0 and dobj <= FIT_DTOL * decrease,
              f"{method}: kernel path's objective left the plain path's")
        check(dbeta <= BETA_RTOL * bmax,
              f"{method}: kernel path's beta left the plain path's")


def main_path(x, t, delta) -> dict:
    """Fit, artifact, serving at full size; returns what timings need."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.core import cox
    from repro_torch.kernels import ops
    from repro_torch.serving import ScoringEngine, SurvivalModel
    from repro_torch.serving import fit_survival_model

    log("phase 3: fit")
    data = convert.cox_data_from_numpy(x, t, delta, device="cuda")
    n_ties = data.n - int(torch.unique(data.risk_start).numel())
    grad0 = cox.grad_all(data, torch.zeros(data.n, device="cuda"))
    lam1, lam2 = 0.1 * float(grad0.abs().max()), 1.0
    log(f"  n={data.n} p={data.p} events={int(data.delta.sum())} "
        f"tied samples={n_ties} lam1={lam1:.4f} lam2={lam2}")
    quad, quad_sweep_s = run_fit(data, lam1, lam2, "cd_quad", QUAD_SWEEPS)
    cubic, cubic_sweep_s = run_fit(data, lam1, lam2, "cd_cubic",
                                   CUBIC_SWEEPS)

    log("phase 4: artifact")
    beta = quad.beta.cpu().numpy()
    model = fit_survival_model(x, t, delta, beta)
    h0 = model.base_cumhaz[0]
    check(bool(np.all(np.isfinite(h0)) and np.all(np.diff(h0) >= 0)
               and h0[0] >= 0), "baseline hazard finite and nondecreasing")
    cpu_model = fit_survival_model(x, t, delta, beta, device="cpu")
    rel = float(np.max(np.abs(h0 - cpu_model.base_cumhaz[0])
                       / np.maximum(np.abs(cpu_model.base_cumhaz[0]), 1e-30)))
    log(f"  grid {model.n_grid}, support {model.k}, H0 {h0[0]:.4g}.."
        f"{h0[-1]:.4g}; card vs CPU max rel diff {rel:.3e} "
        f"(tol {ARTIFACT_RTOL:.0e})")
    check(rel <= ARTIFACT_RTOL, "artifact: card and CPU baselines differ")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        loaded = SurvivalModel.load(model.save(str(Path(tmp) / "model")),
                                    verify=True)
    for name in ("beta", "time_grid", "base_cumhaz", "support",
                 "beta_support"):
        a, b = getattr(model, name), getattr(loaded, name)
        check((a is None and b is None) or np.array_equal(a, b),
              f"artifact round trip: {name}")
    log("  save/load round trip with sha256 checks: arrays equal")

    log("phase 5: serving")
    engine = ScoringEngine(model)
    rng = np.random.default_rng(SEED + 1)
    batch_s = {}
    before = ops.launch_counts()["survival_curves"]
    for b in BATCHES:
        q = x[rng.integers(0, x.shape[0], b)]
        risk, med, curves = engine.score(q, with_curves=True)
        bt = torch.as_tensor(engine._beta)
        qt = torch.as_tensor(q, device="cuda")
        if engine.use_sparse:
            qt = qt[:, torch.as_tensor(model.support, device="cuda").long()]
        eta = torch.clamp(qt @ bt, -30.0, 30.0)
        s_ref = torch.exp(-engine._h0[None, :] * torch.exp(eta)[:, None])
        s_ref = s_ref.cpu().numpy()
        err_c = float(np.max(np.abs(curves - s_ref)))
        err_r = float(np.max(np.abs(risk - torch.exp(eta).cpu().numpy())
                             / torch.exp(eta).cpu().numpy()))
        below = s_ref <= 0.5
        med_ref = np.where(below.any(1), model.time_grid[below.argmax(1)],
                           np.inf)
        check(curves.shape == (b, model.n_grid) and np.isfinite(curves).all()
              and err_c <= CURVES_ATOL and err_r <= 1e-5
              and np.array_equal(med, med_ref), f"serving batch {b}")
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.score(q, with_curves=True)
        batch_s[b] = (time.perf_counter() - t0) / reps
        log(f"  batch {b}: curves max |err| {err_c:.3e} (tol "
            f"{CURVES_ATOL:.0e}), risk rel err {err_r:.3e}; "
            f"{batch_s[b] * 1e3:.3f} ms per scored batch "
            f"(sparse={engine.use_sparse})")
    curve_launches = ops.launch_counts()["survival_curves"] - before
    check(curve_launches >= 21 * len(BATCHES),
          f"survival_curves launched {curve_launches} times")
    return {"data": data, "model": model, "engine": engine,
            "lam1": lam1, "lam2": lam2,
            "fits": {"cd_quad": quad, "cd_cubic": cubic},
            "quad_sweep_s": quad_sweep_s, "cubic_sweep_s": cubic_sweep_s,
            "batch_s": batch_s}


# ---------------------------------------------------------------------------
# Phase 6: timings at the main path's shapes
# ---------------------------------------------------------------------------

def _bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wrapper_overhead_us(data, reps: int = 2000) -> float:
    """Host microseconds a cox_coord call spends in its wrapper's argument
    checks, library lookup and dispatch counter, without launching."""
    from repro_torch.kernels import _build, ops

    args = {"eta": data.delta, "x": data.xT[0], "delta": data.delta,
            "risk_start": data.risk_start}
    shapes = dict.fromkeys(args, (data.n,))
    dtypes = {name: t.dtype for name, t in args.items()}
    t0 = time.perf_counter()
    for _ in range(reps):
        _build.require("cox_coord", args, shapes, dtypes)
        _build.library()
        ops._count("cox_coord", data.delta)
    return (time.perf_counter() - t0) / reps * 1e6


def timings(state) -> dict:
    import torch

    from repro_torch.core import solvers
    from repro_torch.kernels import ref
    from repro_torch.kernels.cox_coord import cox_coord
    from repro_torch.kernels.lipschitz import lipschitz
    from repro_torch.kernels.survival_curves import survival_curves

    data, engine = state["data"], state["engine"]
    n, p = data.n, data.p
    eta = data.x @ torch.as_tensor(state["model"].beta, device="cuda")
    rows = data.xT
    out = {}

    # cox_coord, as CD calls it: a new feature row each call (cold in L2)
    out["cox_coord"] = (
        kernel_ms(lambda i: cox_coord(eta, rows[i % p], data.delta,
                                      data.risk_start), reps=200),
        kernel_ms(lambda i: ref.cox_coord_ref(eta, rows[i % p], data.delta,
                                              data.risk_start), reps=50),
        _bound(16.0 * n + 12, 20.0 * n))
    out["lipschitz"] = (
        kernel_ms(lambda i: lipschitz(data.x, data.delta, data.risk_start),
                  reps=3),
        kernel_ms(lambda i: ref.lipschitz_ref(data.x, data.delta,
                                              data.risk_start),
                  reps=1, rounds=3),
        _bound(4.0 * n * p + 8.0 * n + 8.0 * p, 8.0 * n * p))
    quarter = _risk_start(n, "quarter",
                          torch.Generator(device="cuda").manual_seed(2))
    log(f"  lipschitz with the last quarter of the rows in one tie group: "
        f"{events_ms(lambda i: lipschitz(data.x, data.delta, quarter), 3):.4f}"
        f" ms a call by CUDA events")
    b, g = BATCHES[-1], engine._h0.shape[0]
    e = torch.randn(b, device="cuda")
    out["survival_curves"] = (
        kernel_ms(lambda i: survival_curves(e, engine._h0), reps=200),
        kernel_ms(lambda i: ref.survival_curves_ref(e, engine._h0), reps=200),
        _bound(4.0 * (b + g + b * g), 3.0 * b * g))
    log(f"  cox_coord wrapper checks and counters: "
        f"{wrapper_overhead_us(data):.2f} us of host time a call")
    for method in ("cd_quad", "cd_cubic"):
        busy, wall = device_ms(lambda i: solvers.fit_cd(
            data, lam1=state["lam1"], lam2=state["lam2"], n_iters=1,
            method=method), reps=1)
        log(f"  one {method} sweep: wall {wall / 1e3:.4f} s, device busy "
            f"{busy / 1e3:.4f} s -> device idle {1 - busy / wall:.1%}")
    for name, ((ms, dev), (plain, plain_dev), (bound, by)) in out.items():
        log(f"  {name}: median {ms * 1e3:.2f} us a call by CUDA events, "
            f"device time {dev * 1e3:.2f} us; plain version "
            f"{plain * 1e3:.2f} us, device {plain_dev * 1e3:.2f} us; bound "
            f"{bound * 1e3:.2f} us by {by} (3.35 TB/s) -> device time at "
            f"{bound / dev:.1%} of bound")
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: no src/repro_torch beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data.synthetic import (SyntheticSpec,
                                            make_correlated_survival)
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
    log("phase 1: device")
    smi = nvidia_smi()
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    _build.library()
    log(f"  built the kernels in {_build.build_seconds:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or line.startswith("=="):
            log("   " + line.strip())

    log("phase 2: kernels against their plain versions")
    errs = check_kernels()

    t0 = time.perf_counter()
    x, t, delta, _ = make_correlated_survival(
        SyntheticSpec(n=N, p=P, k=K, rho=RHO, seed=SEED))
    log(f"  Appendix-C data made in {time.perf_counter() - t0:.1f} s")
    ops.reset_launch_counts()
    state = main_path(x, t, delta)
    launches = ops.launch_counts()
    log(f"  main path launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} did not launch on the main path")
    compare_fits(state["data"], state["lam1"], state["lam2"], state["fits"])

    log("phase 6: timings")
    times = timings(state)
    log(f"  seconds per CD sweep: cd_quad {state['quad_sweep_s']:.4f}, "
        f"cd_cubic {state['cubic_sweep_s']:.4f}; seconds per scored batch: "
        + ", ".join(f"b={b} {s:.6f}" for b, s in state["batch_s"].items()))
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, ((ms, dev), (plain, _), (bound, by)) in times.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "device_ms": dev})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
