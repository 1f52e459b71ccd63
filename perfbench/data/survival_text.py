"""Token sequences of the deep-survival task, made on the host from a seed
and a batch index: uniform tokens with a few marker tokens planted at a
per-sequence intensity (the hazard would count them). A copy of the
program's survival-text stream, seeded by (seed, batch index) alone so
that any batch of a run can be made again for the check."""
from __future__ import annotations

import numpy as np

N_MARKERS = 4


def batch(seed: int, index: int, rows: int, seq: int,
          vocab: int) -> np.ndarray:
    """(rows, seq) int32 tokens of batch ``index``."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 7, int(index)])
    toks = rng.integers(0, vocab, size=(rows, seq))
    markers = np.arange(1, 1 + N_MARKERS)
    intensity = rng.random((rows, 1)) * 0.2
    plant = rng.random(toks.shape) < intensity
    which = rng.integers(0, N_MARKERS, size=toks.shape)
    return np.where(plant, markers[which], toks).astype(np.int32)
