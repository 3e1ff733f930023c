"""K1 (the rest trace, kRest) against its roofline, in %: the least time
an H100 needs for one traced frame's work (the reference's count of the
evaluations and bytes that frame's rays need, at the published fp32 and
HBM3 peaks) over K1's device time in that frame."""

TAG = "k1"


def read(r):
    times = r.kernel_times(TAG)
    if not times or TAG not in r.bound_s:
        return None
    return 100.0 * r.bound_s[TAG] / times[0]
