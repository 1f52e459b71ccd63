"""Milliseconds of candidate scoring a beam: the ``beam.score`` spans over
the beams they scored."""


def read(ctx):
    spans = ctx.main.spans_named("beam.score")
    beams = sum(s["attrs"]["n_beams"] for s in spans)
    if not beams:
        return None
    return 1e3 * sum(s["dur_s"] for s in spans) / beams
