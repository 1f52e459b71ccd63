"""``cox_coord``'s share of its roofline: the bound of a call at the
cohort's n (``roofline/cox_coord.py``) over the device time of a call,
both of its kernels, in the profiled window (calls from the program's
launch counter)."""


def read(ctx):
    w = ctx.traced
    calls = w.launches.get("cox_coord", 0)
    t = w.kernel_s("coord_tile_aggregates", "coord_terms")
    if not calls or t <= 0:
        return None
    bound = ctx.roofline("cox_coord").bound_s(ctx.peaks, w.work["n"])
    return 100.0 * calls * bound / t
