"""``kernels_roofline``: the port's kernels that the traced window
launched, each timed alone on the cell's level-0 layout after the window:
their bytes (inputs read once, outputs written once) over their summed
device time, as a share of the card's peak bandwidth, %."""

from portbench.yardstick import HBM_BYTES_PER_S


def read(rec):
    timings = rec.kernel_timings()
    if not timings:
        return None
    nbytes = sum(b for b, _ in timings.values())
    ms = sum(t for _, t in timings.values())
    return 100.0 * nbytes / (ms * 1e-3 * HBM_BYTES_PER_S)
