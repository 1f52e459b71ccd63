"""The searches' share of the card's peak: the least time of the scoring
and finetuning that the window's searches did (``roofline/beam_search.py``,
counted from the ``beam.*`` spans: beams scored and candidates finetuned
at each support size) over the window, on the host clock."""


def read(ctx):
    rf = ctx.roofline("beam_search")
    tr, w = ctx.cell.traffic, ctx.main
    sizes = {s["span_id"]: s["attrs"]["size"]
             for s in w.spans_named("beam.size")}
    least = 0.0
    for s in w.spans_named("beam.score"):
        least += s["attrs"]["n_beams"] * rf.score_s(
            ctx.peaks, w.work["n"], w.work["p"], int(tr["score_steps"]))
    for s in w.spans_named("beam.finetune"):
        size = sizes.get(s["parent_id"])
        if size is None:
            return None
        least += s["attrs"]["n_candidates"] * rf.finetune_s(
            ctx.peaks, w.work["n"], size, int(tr["finetune_sweeps"]))
    if least <= 0:
        return None
    return 100.0 * least / w.window_s
