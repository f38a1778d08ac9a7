"""``device_idle_pct``: the share of the traced window in which no
operation ran on the device, %: 1 − the union of the device operations'
intervals over the window's length. The window is traced with device
activity only (no host ranges, no phase synchronisations), so the host
runs as in an untraced window, short of CUPTI's cost a launch."""

from portbench.yardstick import busy_us


def read(rec):
    dev = rec.trace["device"] if rec.trace else []
    if not dev:
        return None
    busy, _, _ = busy_us([(s, e) for _, s, e in dev])
    return 100.0 * (1.0 - busy / (rec.window_s * 1e6))
