from quadruped_tpu_torch.robots.params import RobotParams, a1_params  # noqa: F401
