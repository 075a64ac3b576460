from quadruped_tpu_torch.gait.scheduler import (  # noqa: F401
    ADVANCED_TROT,
    GaitConfig,
    GaitState,
    LegState,
    gait_init,
    gait_update,
    predicted_contact_table,
    stance_contact_mask,
)
