"""Share of the traced window in which no kernel, copy or memset ran on the
device: 100 (1 - busy / window), busy the union of the device intervals. Nothing is read where the
window ran nothing on the device."""


def read(trace, work):
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
