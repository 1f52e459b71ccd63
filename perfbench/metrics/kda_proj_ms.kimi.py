"""Milliseconds of the card's time around the KDA layers' recurrence a
batch: the ``kda.in`` (input projection, conv, L2 norms, decays, beta)
and ``kda.out`` (norm, gate, output projection) spans' device time (CUDA
events) summed over the window's ``featurize.batch`` spans, in the
window with spans on."""
from perfbench import spans


def read(ctx):
    return spans.dev_ms_per(ctx.main, ("kda.in", "kda.out"),
                            "featurize.batch")
