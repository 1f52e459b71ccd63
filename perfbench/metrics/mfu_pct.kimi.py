"""The backbone's share of the card's bfloat16 peak: the forward's
operations a token at the cell's sequence length, with this card's share
of the experts (``roofline/kimi_linear_forward.py``), times the tokens
the window featurized, over the window, on the host clock."""


def read(ctx):
    per_token = ctx.roofline("kimi_linear_forward").flops_per_token(
        ctx.cell.config, int(ctx.cell.traffic["seq"]))
    w = ctx.main
    return 100.0 * per_token * w.work["tokens"] / w.window_s \
        / ctx.peaks["bf16_flop_per_s"]
