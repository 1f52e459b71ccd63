"""Milliseconds of the card's time in the latent-attention (MLA) layers a
batch: the ``mla.mix`` spans' device time (CUDA events; projections,
the KV decompression and causal attention) summed over the window's
``featurize.batch`` spans, in the window with spans on."""
from perfbench import spans


def read(ctx):
    return spans.dev_ms_per(ctx.main, ("mla.mix",), "featurize.batch")
