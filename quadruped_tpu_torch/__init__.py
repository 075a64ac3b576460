"""quadruped_tpu_torch — the PyTorch/CUDA port of quadruped_tpu.

The JAX package `quadruped_tpu/` is the reference; this package mirrors its
subpackages and module names (core/, robots/, dynamics/, solvers/, gait/,
control/, planner/, sim/) so every function's counterpart is found by path.

Conventions of the port:

  * batch-first: every state, observation and command tensor carries a
    leading scenario axis [B, ...] written out (the JAX code writes one
    scenario and `jax.vmap`s it). Robot parameters are one robot model
    shared by the batch, as in the JAX rollouts that close over them, and
    broadcast against the scenario axis; a gait table is shared ([4]
    fields) or, under online gait transitions, one per scenario ([B, 4]);
  * float32 throughout; the device is taken from the input tensors;
  * plain functions on tensors, dataclasses for state and config
    (`dataclasses.replace` stands in for flax's `.replace`);
  * the MPC solve's ADMM loop is a hand-written CUDA kernel
    (solvers/fused_admm.py, csrc/fused_admm.cu). On CPU tensors the
    kernel's plain torch version runs; on CUDA tensors the kernel launches
    or the call raises.

Importing the package builds nothing: the kernel compiles with nvcc at its
first launch.
"""

__version__ = "0.1.0"
