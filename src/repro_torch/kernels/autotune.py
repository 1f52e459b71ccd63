"""Launch-knob autotuner for the curve kernels.

The PyTorch port's counterpart of the JAX package's
``kernels/autotune.py``. The reference tunes Pallas block sizes, which the
port's kernels do not take; the port has one launch knob,
``blocks_per_sm`` of the curve panel's launch plan
(``survival_curves.plan``), for ``survival_curves`` and
``survival_curves_strat`` (the stratified kernel). Per kernel and
power-of-two shape bucket, ``autotune()`` times the candidates on the
card, picks the winner and persists it to a JSON cache keyed by
``cuda/kernel/bucket``. Both curve wrappers call ``knob()`` on every
dispatch to the card: a dict read that falls back to the default
(``survival_curves.BLOCKS_PER_SM``) when a bucket is untuned, so with no
cache the kernels launch as they always have. Winners are registered
into ``analysis/roofline.py``'s registry for the report's table.

Timing is on the card only: CUDA events around ``reps`` back-to-back
calls, queued behind a device sleep so that the events see the device's
time and not the host's enqueue rate, in ``rounds`` rounds taken in turns
over the candidates. On the CPU the plain version runs, which has no knob
to time, and ``autotune`` raises.

Cache location: ``$REPRO_TUNE_CACHE`` when set, else
``~/.cache/repro_torch/tuned_blocks.json``.

    python -m repro_torch.kernels.autotune [--cache PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..obs import events as obs_events

CACHE_ENV = "REPRO_TUNE_CACHE"
CACHE_VERSION = 1
BACKEND = "cuda"
KNOB = "blocks_per_sm"
H100_SMS = 132         # SMs of an H100 SXM5, for pruning without a card
STRATA = 8             # strata of the stratified kernel's timing table

# survival_curves.BLOCKS_PER_SM, the plan's default (kept equal by a test)
DEFAULT_CONFIGS: Dict[str, Dict[str, int]] = {
    "survival_curves": {KNOB: 2},
    "survival_curves_strat": {KNOB: 2},
}

# shape axes that key a bucket, in display order
SHAPE_AXES: Dict[str, Tuple[str, ...]] = {
    "survival_curves": ("b", "g"),
    "survival_curves_strat": ("b", "g"),
}

CANDIDATES: Dict[str, List[Dict[str, int]]] = {
    k: [{KNOB: v} for v in (1, 2, 4, 8)] for k in DEFAULT_CONFIGS}

# the reference's serving curve shapes (engine grid_size=128)
DEFAULT_SWEEP: List[Tuple[str, Dict[str, int]]] = [
    (kernel, {"b": b, "g": 128})
    for kernel in ("survival_curves", "survival_curves_strat")
    for b in (256, 1024)]


# -- buckets and cache keys -------------------------------------------------

def bucket(v: int) -> int:
    """Next power of two >= v (>= 1), same policy as the engine's batches."""
    return 1 << (max(int(v), 1) - 1).bit_length()


def bucket_key(kernel: str, shape: Dict[str, int],
               backend: Optional[str] = None) -> str:
    dims = ",".join(f"{a}={bucket(shape[a])}" for a in SHAPE_AXES[kernel])
    return f"{backend or BACKEND}/{kernel}/{dims}"


# -- JSON cache -------------------------------------------------------------

def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "tuned_blocks.json")


_LOADED: Dict[str, Dict[str, dict]] = {}   # path -> entries (lazy, per file)
# ($REPRO_TUNE_CACHE, kernel, bucket of b, bucket of g) -> the knob's value
# on dispatch; emptied whenever a cache is loaded or saved
_KNOBS: Dict[tuple, int] = {}


def load_cache(path: Optional[str] = None,
               refresh: bool = False) -> Dict[str, dict]:
    path = path or cache_path()
    if refresh or path not in _LOADED:
        try:
            with open(path) as f:
                data = json.load(f)
            entries = data.get("entries", {}) if isinstance(data, dict) else {}
        except (OSError, ValueError):
            entries = {}
        _LOADED[path] = entries
        _KNOBS.clear()
    return _LOADED[path]


def save_cache(entries: Dict[str, dict], path: Optional[str] = None) -> str:
    path = path or cache_path()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": CACHE_VERSION, "entries": entries}, f,
                  indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    _LOADED[path] = entries
    _KNOBS.clear()
    return path


def lookup_tagged(kernel: str, cache_file: Optional[str] = None,
                  **shape: int) -> Tuple[Dict[str, int], str]:
    """(config, provenance) for ``kernel`` at ``shape``: the dispatch read.

    Provenance is ``"tuned"`` when the bucket has a cached winner and
    ``"default"`` on the static fallback. Never times anything."""
    entry = load_cache(cache_file).get(bucket_key(kernel, shape))
    if entry and isinstance(entry.get("config"), dict):
        return dict(entry["config"]), "tuned"
    return dict(DEFAULT_CONFIGS[kernel]), "default"


def lookup(kernel: str, cache_file: Optional[str] = None,
           **shape: int) -> Dict[str, int]:
    """Tuned config (``DEFAULT_CONFIGS`` fallback); see lookup_tagged."""
    return lookup_tagged(kernel, cache_file, **shape)[0]


def knob(kernel: str, b: int, g: int) -> int:
    """``lookup(kernel, b=b, g=g)[KNOB]`` from the default cache, as the
    curve wrappers read it on every dispatch: one dict read once the
    bucket has been looked up."""
    key = (os.environ.get(CACHE_ENV), kernel, bucket(b), bucket(g))
    value = _KNOBS.get(key)
    if value is None:
        value = _KNOBS[key] = lookup(kernel, b=b, g=g)[KNOB]
    return value


# -- candidates -------------------------------------------------------------

def _plan(kernel: str, shape: Dict[str, int], sms: int, config):
    from . import survival_curves as curves

    strat = kernel == "survival_curves_strat"
    return curves.plan(bucket(shape["b"]), bucket(shape["g"]), sms,
                       STRATA if strat else 1, stratified=strat,
                       blocks_per_sm=config[KNOB])


def candidates_for(kernel: str, shape: Dict[str, int],
                   sms: int = H100_SMS) -> List[Dict[str, int]]:
    """The default first, then every candidate whose launch plan at the
    shape's bucket on ``sms`` SMs differs from all kept so far: where two
    values of the knob give the same grid (a batch too small to fill the
    card), timing both would time one launch twice."""
    default = DEFAULT_CONFIGS[kernel]
    out = [dict(default)]
    plans = {_plan(kernel, shape, sms, default)}
    for cfg in CANDIDATES[kernel]:
        pl = _plan(kernel, shape, sms, cfg)
        if pl not in plans:
            plans.add(pl)
            out.append(dict(cfg))
    return out


# -- timing -----------------------------------------------------------------

def _build_inputs(kernel: str, shape: Dict[str, int], seed: int = 0,
                  device="cuda"):
    """The wrapper's inputs at ``shape`` on ``device``, from ``seed``."""
    rng = np.random.default_rng(seed)
    b, g = shape["b"], shape["g"]
    eta = torch.as_tensor(rng.standard_normal(b) * 0.5, dtype=torch.float32,
                          device=device)
    if kernel == "survival_curves":
        return (eta, torch.linspace(0.0, 2.0, g, dtype=torch.float32,
                                    device=device))
    if kernel == "survival_curves_strat":
        h0 = np.cumsum(rng.uniform(0.0, 0.05, size=(STRATA, g)), axis=1)
        return (eta, torch.as_tensor(h0, dtype=torch.float32, device=device),
                torch.as_tensor(rng.integers(0, STRATA, size=b),
                                dtype=torch.int32, device=device))
    raise KeyError(f"unknown kernel {kernel!r}")


def run_config(kernel: str, inputs: tuple, config: Dict[str, int]):
    """One wrapper call with an explicit knob (tuning and checks)."""
    from . import survival_curves as curves

    fn = (curves.survival_curves if kernel == "survival_curves"
          else curves.survival_curves_stratified)
    return fn(*inputs, blocks_per_sm=config[KNOB])


def _card(device) -> Tuple[torch.device, int, str]:
    """(the card, its SM count, its name); raises on anything but a
    card."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        raise ValueError(
            f"autotune times the kernels on a card, not on {dev}: the "
            f"plain version that runs there has no launch knob")
    props = torch.cuda.get_device_properties(dev)
    return dev, props.multi_processor_count, props.name


def _events_us(fn, reps: int) -> float:
    """Mean device microseconds a call over ``reps`` back-to-back calls,
    by CUDA events. The calls are queued behind a device sleep, so the
    device runs them back to back whatever the host's rate; when the
    sleep ends before the host has queued them all, it doubles and the
    round is taken again."""
    cycles = int(reps * 100e-6 * 2e9)     # ~100 us of host a call at 2 GHz
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) * 1e3 / reps
        cycles *= 2


def _time_candidates(kernel: str, inputs: tuple, configs, reps: int,
                     rounds: int) -> Dict[str, List[float]]:
    """{config key: device us a call in each round}, the candidates taken
    in turns within each round after one warm-up call each."""
    for cfg in configs:
        run_config(kernel, inputs, cfg)
    torch.cuda.synchronize()
    out: Dict[str, List[float]] = {_cfg_key(c): [] for c in configs}
    for _ in range(rounds):
        for cfg in configs:
            out[_cfg_key(cfg)].append(_events_us(
                lambda cfg=cfg: run_config(kernel, inputs, cfg), reps))
    return out


def _cfg_key(cfg: Dict[str, int]) -> str:
    return ",".join(f"{k}={cfg[k]}" for k in sorted(cfg))


def _register(key: str, entry: dict) -> None:
    from ..analysis import roofline
    roofline.register_tuned(key, entry)


def autotune(kernel: str, shape: Dict[str, int], *,
             cache_file: Optional[str] = None, reps: int = 200,
             rounds: int = 5, force: bool = False, device="cuda",
             verbose: bool = False) -> Dict[str, int]:
    """Tune one (kernel, bucket) on the card: time the candidates, persist
    and return the winner (the least median over the rounds).

    A cached bucket is returned without re-timing unless ``force``. The
    entry keeps every candidate's median and spread (max - min over the
    rounds) in microseconds a call."""
    dev, sms, name = _card(device)
    path = cache_file or cache_path()
    key = bucket_key(kernel, shape)
    entries = load_cache(path, refresh=True)
    cached = entries.get(key)
    if cached is not None and not force and isinstance(
            cached.get("config"), dict):
        _register(key, cached)
        return dict(cached["config"])

    inputs = _build_inputs(kernel, shape, device=dev)
    configs = candidates_for(kernel, shape, sms)
    times = _time_candidates(kernel, inputs, configs, reps, rounds)
    med = {k: statistics.median(v) for k, v in times.items()}
    spread = {k: max(v) - min(v) for k, v in times.items()}
    best = min(configs, key=lambda c: med[_cfg_key(c)])
    dkey = _cfg_key(DEFAULT_CONFIGS[kernel])
    entry = {
        "kernel": kernel,
        "backend": BACKEND,
        "device": name,
        "shape": {a: int(shape[a]) for a in SHAPE_AXES[kernel]},
        "config": dict(best),
        "us": med[_cfg_key(best)],
        "spread_us": spread[_cfg_key(best)],
        "default_config": dict(DEFAULT_CONFIGS[kernel]),
        "default_us": med[dkey],
        "default_spread_us": spread[dkey],
        "candidates": med,
        "candidate_spread_us": spread,
        "reps": reps,
        "rounds": rounds,
    }
    entries[key] = entry
    save_cache(entries, path)
    _register(key, entry)
    obs_events.emit("autotune.winner", key=key, config=best,
                    us=entry["us"], default_us=entry["default_us"])
    if verbose:
        print(f"[autotune] {key} winner {_cfg_key(best)} "
              f"({entry['us']:.3f}us vs default "
              f"{entry['default_us']:.3f}us)", flush=True)
    return dict(best)


def sweep(shapes: Optional[Sequence[Tuple[str, Dict[str, int]]]] = None,
          **kwargs) -> Dict[str, Dict[str, int]]:
    """Autotune a list of (kernel, shape) pairs; defaults to DEFAULT_SWEEP."""
    winners: Dict[str, Dict[str, int]] = {}
    for kernel, shape in (shapes if shapes is not None else DEFAULT_SWEEP):
        winners[bucket_key(kernel, shape)] = autotune(kernel, shape, **kwargs)
    return winners


def main(argv=None) -> Dict[str, Dict[str, int]]:
    from ..analysis import report

    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default ${CACHE_ENV}, else "
                         "~/.cache/repro_torch/tuned_blocks.json)")
    ap.add_argument("--force", action="store_true",
                    help="time buckets that the cache already holds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    winners = sweep(cache_file=args.cache, force=args.force,
                    device=args.device, verbose=True)
    print(report.tuned_blocks_table(args.cache or cache_path()))
    return winners


if __name__ == "__main__":
    main()
