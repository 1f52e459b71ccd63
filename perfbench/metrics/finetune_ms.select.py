"""Milliseconds of finetuning a candidate support: the ``beam.finetune``
spans over the candidates they finetuned."""


def read(ctx):
    spans = ctx.main.spans_named("beam.finetune")
    cands = sum(s["attrs"]["n_candidates"] for s in spans)
    if not cands:
        return None
    return 1e3 * sum(s["dur_s"] for s in spans) / cands
