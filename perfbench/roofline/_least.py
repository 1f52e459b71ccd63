"""The least time of some work on the card: the larger of its operations
over the peak rate of their type and its bytes over the HBM bandwidth.
Counts read each input byte once and write each output byte once,
whatever implementation does the work."""
from __future__ import annotations


def least_s(peaks: dict, flops: float, nbytes: float,
            rate: str = "fp32_flop_per_s") -> float:
    return max(flops / peaks[rate], nbytes / peaks["hbm_byte_per_s"])
