"""The port's runnable examples: one module per JAX example under the same
file name (examples/*.py of the repo), each a Python loop over ticks on
the card unless `--device cpu` is given.

    python -m quadruped_tpu_torch.examples.example_a1_trot [--steps 1000]

Each module has `run(...)`, which takes the JAX script's parameters with
its defaults plus `device` and returns the traces the script prints or
renders as numpy arrays (with `ticks` and `loop_s`, the wall seconds of
the tick loop), and `main(argv=None)`, the script's command line plus
`--device`, which prints the script's lines and one line with the device
(the card's name and power limit), ms a tick and the tick count.
"""
