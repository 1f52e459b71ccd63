"""Reusable host-side training loop.

The PyTorch port's counterpart of the JAX package's ``train/loop.py``:
iterate a ``step_fn`` over a deterministic stream, keep the loss history,
optionally heartbeat + straggler-monitor + async-checkpoint.
``stream.batch_for_step(step)`` in, ``(state, metrics)`` out, losses
recorded per step. The production launcher (``launch/train.py``) keeps its
own loop because it also owns resume.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

from . import fault_tolerance as ft


def run_loop(step_fn: Callable, state: Any, stream: Any, steps: int, *,
             start_step: int = 0,
             log_every: int = 25, log_prefix: str = "[train]",
             checkpointer=None, ckpt_every: int = 0,
             heartbeat_path: str = "",
             on_step: Optional[Callable[[int, dict], None]] = None,
             ) -> Tuple[Any, List[float]]:
    """Run ``steps - start_step`` steps; returns (final state, losses).

    ``checkpointer``: a ``train.checkpoint.AsyncCheckpointer`` (saved every
    ``ckpt_every`` steps and once at the end, then waited on).
    ``on_step(step, metrics)`` fires after every step, once its loss has
    been read on the host.
    """
    hb = ft.Heartbeat(heartbeat_path) if heartbeat_path else None
    mon = ft.StragglerMonitor()
    losses: List[float] = []
    for step in range(start_step, steps):
        t0 = time.time()
        state, metrics = step_fn(state, stream.batch_for_step(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        straggler = mon.record(time.time() - t0)
        if hb is not None:
            hb.beat(step, {"loss": loss})
        if log_every and (step % log_every == 0 or straggler):
            tag = " STRAGGLER" if straggler else ""
            print(f"{log_prefix} step {step} loss {loss:.4f}{tag}",
                  flush=True)
        if on_step is not None:
            on_step(step, metrics)
        if checkpointer is not None and ckpt_every \
                and (step + 1) % ckpt_every == 0:
            checkpointer.save(step + 1, state)
    if checkpointer is not None:
        checkpointer.save(steps, state)
        checkpointer.wait()
    return state, losses
