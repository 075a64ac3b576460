"""Host launch calls (kernel launches, graph launches counting one each)
made inside the traced ticks, over the ticks: what a CUDA graph or a fused
kernel would lower. `work["ticks_per_unit"]` converts units (a segment of
ticks, or one tick) to ticks."""


def read(trace, work):
    ticks_per_unit = work.get("ticks_per_unit")
    if trace is None or not ticks_per_unit or trace.units == 0:
        return None
    launches = trace.launches_in_units()
    if launches == 0:
        return None
    return launches / (trace.units * ticks_per_unit)
