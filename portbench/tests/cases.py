"""Tiny CPU sizes of the cells' traffic for the rehearsals, one for each
driver: a cell added by new files and entries alone gets its driver's."""

from portbench import harness

BY_DRIVER = {
    "sweep": dict(batch=4, segment_ticks=10, warmup_ticks=2,
                  check_segments=2, check_ticks=8),
    "update": dict(batch=8, check_within=4, check_updates=3, trace_units=3),
    "tick": dict(warmup_ticks=2, check_within=10, check_starts=2,
                 check_ticks=8, trace_units=5),
}


def driver(name: str) -> str:
    """The driver of the cell `name`, as its traffic file names it."""
    return harness.cell_files(name)["traffic"]["driver"]


def small(name: str) -> dict:
    """The traffic overrides of the cell `name`'s CPU rehearsals."""
    return dict(BY_DRIVER[driver(name)])
