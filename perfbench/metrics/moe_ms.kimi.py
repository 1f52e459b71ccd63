"""Milliseconds of the card's time in the sparse-expert layers a batch:
the ``moe.route`` (router, choice, loads), ``moe.experts`` (the held
pairs' sort, the grouped GEMMs, the combine) and ``moe.shared`` spans'
device time (CUDA events) summed over the window's ``featurize.batch``
spans, in the window with spans on."""
from perfbench import spans


def read(ctx):
    return spans.dev_ms_per(ctx.main, ("moe.route", "moe.experts",
                                       "moe.shared"), "featurize.batch")
