"""Beam search over supports of an (n, p) float32 cohort.

Scoring a beam takes ``steps`` surrogate steps on every column and then
its loss: each of the steps + 1 rounds reads the (n, p) panel once (with
eta, delta and the risk-set starts), about 12 operations an element.
Finetuning a candidate of s columns is ``sweeps`` * s coordinate steps
and its constants over the (n, s) panel. A coordinate step depends on the
one before it through eta, so each is a pass over the O(n) state: it reads
the column, eta, delta and the tie groups' event counts and writes eta
(5 n float32), with about 20 operations a sample. The constants read the
panel, delta and the groups' counts and write L2 and L3 (s each), with
about 8 operations an element."""
from __future__ import annotations

from perfbench.roofline import _least


def coordinate_s(peaks: dict, n: int) -> float:
    return _least.least_s(peaks, 20 * n, 5 * n * 4)


def constants_s(peaks: dict, n: int, s: int) -> float:
    return _least.least_s(peaks, 8 * n * s, (n * s + 2 * n) * 4 + 2 * s * 4)


def score_s(peaks: dict, n: int, p: int, steps: int) -> float:
    per_round = _least.least_s(peaks, 12 * n * p, (n * p + 3 * n) * 4)
    return (steps + 1) * per_round


def finetune_s(peaks: dict, n: int, s: int, sweeps: int) -> float:
    return sweeps * s * coordinate_s(peaks, n) + constants_s(peaks, n, s)


def scans_bytes(n: int, p: int, steps: int) -> float:
    """Bytes of the suffix sums that scoring one beam needs: two a step
    (of the hazards and of hazards times the column) and one for the
    loss, each over the (n, p) panel, read and written once."""
    return (2 * steps + 1) * 2 * n * p * 4
