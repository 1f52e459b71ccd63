"""Suffix sums of an (n, m) float32 panel along n (``revcumsum``): reads
the panel, writes the panel; one addition an element."""
from __future__ import annotations

from perfbench.roofline._least import least_s


def nbytes(n: int, m: int = 1) -> float:
    return 2 * n * m * 4


def bound_s(peaks: dict, n: int, m: int = 1) -> float:
    return least_s(peaks, n * m, nbytes(n, m))
