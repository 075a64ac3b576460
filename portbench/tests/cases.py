"""Tiny CPU sizes of each cell's traffic for the rehearsals."""

SMALL = {
    "a1-h10.sweep-b2048": dict(batch=4, segment_ticks=10, warmup_ticks=2,
                               check_segments=2, check_ticks=8),
    "aliengo-wbc-h5.sweep-b1024": dict(batch=4, segment_ticks=10,
                                       warmup_ticks=2, check_segments=2,
                                       check_ticks=8),
    "a1-h10.update-b8192": dict(batch=8, check_within=4, check_updates=3,
                                trace_units=3),
    "a1-h10.tick-b1": dict(warmup_ticks=2, check_within=10, check_starts=2,
                           check_ticks=8, trace_units=5),
}
