"""Controllers (mirrors ``fpyv_tpu.control``): the scalar PID, the
attitude rates controller, the pixel-guidance autopilots, and the
ANGLE/HORIZON self-level flight modes."""

from fpyv_tpu_torch.control.flight_modes import (  # noqa: F401
    FlightModeParams,
    FlightModeState,
    angle_mode_action,
    flight_mode_init,
    horizon_mode_action,
    rates_to_action,
)
from fpyv_tpu_torch.control.pid import PidParams, PidState, pid_init, pid_step  # noqa: F401
from fpyv_tpu_torch.control.rates_controller import (  # noqa: F401
    RatesControllerParams,
    RatesControllerState,
    rates_controller_init,
    rates_controller_step,
)
