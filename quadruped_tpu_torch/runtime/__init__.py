from quadruped_tpu_torch.runtime.bridge import (  # noqa: F401
    FleetBridge,
    RobotBridge,
    LoopTimer,
    build_native,
    native_available,
)
