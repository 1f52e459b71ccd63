"""Share of the traced window in which no kernel, copy or memset ran on
the card (torch.profiler)."""


def read(ctx):
    return ctx.traced.idle_pct()
