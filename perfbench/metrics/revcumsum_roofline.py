"""``revcumsum``'s share of its roofline over candidate scoring: the bytes
of the suffix sums that the beams scored in the profiled window need
(``roofline/beam_search.py``: two a step and one for the loss, over the
(n, p) panel) at HBM bandwidth, over the device time of the ``rcs_*``
kernels there."""


def read(ctx):
    w = ctx.traced
    beams = sum(s["attrs"]["n_beams"] for s in w.spans_named("beam.score"))
    t = w.kernel_s("rcs_panel", "rcs_vec_")
    if not beams or t <= 0:
        return None
    steps = int(ctx.cell.traffic["score_steps"])
    nbytes = ctx.roofline("beam_search").scans_bytes(w.work["n"],
                                                      w.work["p"], steps)
    return 100.0 * beams * nbytes / ctx.peaks["hbm_byte_per_s"] / t
