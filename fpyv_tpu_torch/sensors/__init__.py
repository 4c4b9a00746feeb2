"""Sensor models (mirrors ``fpyv_tpu.sensors``): gyro noise, the barometric
altimeter, the IMU observation and the UWB range, as batched functions over
tensors that compose with any env (BASELINE config #3: "sensor-model
envs"). Their noise comes from a ``torch.Generator``, through one named
draw function in each module that the tests replace with JAX's draws."""

from fpyv_tpu_torch.sensors.gyro import gyro_noise_rotation, perturb_attitude  # noqa: F401
from fpyv_tpu_torch.sensors.baro import (  # noqa: F401
    BaroParams,
    altitude_from_pressure,
    baro_measure,
    is_peak_altitude,
    pressure_from_altitude,
    quadratic_fit_reference,
)
from fpyv_tpu_torch.sensors.uwb import uwb_range  # noqa: F401
from fpyv_tpu_torch.sensors.imu import imu_observation  # noqa: F401
