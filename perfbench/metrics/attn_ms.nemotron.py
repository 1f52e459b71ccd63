"""Milliseconds of the card's time in the attention layers a batch: the
``attn.mix`` spans' device time (CUDA events; projections and causal
GQA) summed over the window's ``featurize.batch`` spans, in the window
with spans on."""
from perfbench import spans


def read(ctx):
    return spans.dev_ms_per(ctx.main, ("attn.mix",), "featurize.batch")
