from quadruped_tpu_torch.robots.params import (  # noqa: F401
    RobotParams,
    a1_params,
    aliengo_params,
    go1_params,
    lite2_params,
    lite3_params,
    named_params,
    stack,
    stack_params,
)
