"""Microseconds of host time a finetune coordinate step: the
``finetune.sweeps`` spans' seconds over the coordinate steps they ran
(their ``steps``), in the window with spans on."""


def read(ctx):
    spans = ctx.main.spans_named("finetune.sweeps")
    steps = sum(s["attrs"]["steps"] for s in spans)
    if not steps:
        return None
    return 1e6 * sum(s["dur_s"] for s in spans) / steps
