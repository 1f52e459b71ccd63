"""Milliseconds of the card's time in the SSD scan of the Mamba2 layers a
batch: the ``ssm.scan`` spans' device time (CUDA events) summed over the
window's ``featurize.batch`` spans, in the window with spans on."""
from perfbench import spans


def read(ctx):
    return spans.dev_ms_per(ctx.main, ("ssm.scan",), "featurize.batch")
