"""K1's share of its roofline: the least time the card could take for the
ADMM loops of the traced window (counted from the problems' shapes,
`roofline.admm_work`) over K1's summed device time there. Nothing is read
where the window ran no K1 launch."""

from portbench import roofline

KERNEL = "fused_admm_kernel"


def read(trace, work):
    shape = work.get("admm_shape")
    if trace is None or shape is None:
        return None
    seconds, launches = trace.device_time(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    nbytes, ops = roofline.admm_work(*shape)
    least, _ = roofline.bound_s(nbytes, ops)
    return 100.0 * least * launches / seconds
