"""K4 (the biharmonic-deformed trace) in the coupled frame against its
roofline, in %: the least time an H100 needs for the first traced
frame (the reference's count of the evaluations and bytes that frame's
rays need for the weights it works out from the program's state, at the
published fp32 and HBM3 peaks) over K4's device time in that frame."""

TAG = "k4"


def read(r):
    times = r.kernel_times(TAG)
    if not times or TAG not in r.bound_s:
        return None
    return 100.0 * r.bound_s[TAG] / times[0]
