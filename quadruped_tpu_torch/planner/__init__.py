from quadruped_tpu_torch.planner import com_adjuster  # noqa: F401
