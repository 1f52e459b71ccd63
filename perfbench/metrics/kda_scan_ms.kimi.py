"""Milliseconds of the card's time in the KDA layers' chunked delta rule a
batch: the ``kda.scan`` spans' device time (CUDA events) summed over the
window's ``featurize.batch`` spans, in the window with spans on."""
from perfbench import spans


def read(ctx):
    return spans.dev_ms_per(ctx.main, ("kda.scan",), "featurize.batch")
