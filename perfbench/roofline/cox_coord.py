"""One coordinate's (g, h) of the Cox loss (``cox_coord``): reads eta,
the column x, delta and the tie groups' event counts (n float32 each),
writes three floats; about 16 float32 operations a sample (the hazard's
exp, two products, three suffix sums, the ratios at group starts)."""
from __future__ import annotations

from perfbench.roofline._least import least_s


def nbytes(n: int) -> float:
    return 4 * n * 4 + 3 * 4


def flops(n: int) -> float:
    return 16 * n


def bound_s(peaks: dict, n: int) -> float:
    return least_s(peaks, flops(n), nbytes(n))
