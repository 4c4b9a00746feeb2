"""Sensor models (mirrors ``fpyv_tpu.sensors``): the UWB range sensor. The
gyro, barometer and IMU models belong to a later slice."""

from fpyv_tpu_torch.sensors.uwb import uwb_range  # noqa: F401
