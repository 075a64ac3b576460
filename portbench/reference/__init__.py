"""Plain reference of the benchmark's configurations: plain torch, no kernel.

A frozen copy of the port's plain-torch closed loop and MPC update, taken
when the benchmark was defined, so that a later change to the port is held
to the arithmetic it had then. It imports nothing of the port and builds
every parameter from a configuration file's numbers (`params.from_config`).
"""
