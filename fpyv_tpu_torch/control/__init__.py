"""Controllers (mirrors ``fpyv_tpu.control``): the scalar PID and the
pixel-guidance autopilots. The rates controller and the self-level flight
modes belong to a later slice."""

from fpyv_tpu_torch.control.pid import PidParams, PidState, pid_init, pid_step  # noqa: F401
