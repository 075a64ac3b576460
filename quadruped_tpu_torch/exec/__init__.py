from quadruped_tpu_torch.exec.runner import (  # noqa: F401
    RunnerConfig,
    RunnerState,
    runner_init,
    runner_step,
)
