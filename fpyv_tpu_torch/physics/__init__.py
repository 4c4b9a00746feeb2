"""Physics: drone step, motor model, collisions, world SDFs, and the
torque-based racer (mirrors ``fpyv_tpu.physics``)."""

from fpyv_tpu_torch.physics.motor import ThrustCurve, fit_thrust_curve  # noqa: F401
from fpyv_tpu_torch.physics.drone import DroneParams, DroneState, drone_reset, drone_step  # noqa: F401
from fpyv_tpu_torch.physics.world import World  # noqa: F401
from fpyv_tpu_torch.physics.racer import RacerParams, RacerState, racer_reset, racer_step  # noqa: F401
