"""Typed configuration mirroring the reference's ``config/params.yaml``
(the port's own copy of ``fpyv_tpu.config``).

Same keys, same units (grams, centimeters, degrees/second, degrees); unit
conversions happen exactly where the reference does them (at Drone/Camera
construction, src/utils/components.py:96-100), so the same params.yaml
drives identical physics constants.

The reference loads the YAML into nested dicts with hard-coded Windows
paths (src/core/simulator.py:9); here :func:`FpyvConfig.from_yaml` accepts
any path and unknown keys are preserved in ``extras`` rather than dropped.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from fpyv_tpu_torch.io.files import yaml_reader


@dataclass(frozen=True)
class SimulatorConfig:
    """`simulator:` block (config/params.yaml:1-35)."""

    fps: float = 60.0
    gravity: float = 9.81
    render_dim: int = 2
    frame_transition_rate: float = 0.2
    ground: Dict[str, Any] = field(
        default_factory=lambda: {"size": 60, "resolution": 50, "random": True}
    )
    targets: Dict[str, Any] = field(
        default_factory=lambda: {
            "count": 1,
            "center": [0, 0, 3.0],
            "std": 0.1,
            "size": 1.0,
            "variation": 0.1,
            "nu": 5,
            "path": {"radius": 25, "resolution": 5500},
        }
    )
    obstacles: Dict[str, Any] = field(
        default_factory=lambda: {
            "count": 5,
            "center": [0, 0, 0],
            "center_std": [10, 10, 0],
            "radius": 2,
            "radius_std": 0.5,
            "height": 10.0,
            "height_std": 5,
            "angle_resolution": 10,
            "height_resolution": 25,
            "random": True,
        }
    )
    track: Dict[str, Any] = field(
        default_factory=lambda: {
            "count": 0,
            "radius": 12,
            "gate_size": 5,
            "gate_resolution": 17,
        }
    )

    @property
    def dt(self) -> float:
        return 1.0 / self.fps


@dataclass(frozen=True)
class PidConfig:
    """`drone.force_multiplier_pid:` block (config/params.yaml:55-62).

    min/max output are overwritten at Drone init with the thrust-curve force
    limits (components.py:143-144) — mirrored in DroneParams construction.
    """

    kP: float = 0.1
    kI: float = 2.0
    kD: float = 0.05
    integral_clip: float = 100.0
    min_output: float = 0.05
    max_output: float = 40.0
    derivative_transition_rate: float = 0.2


@dataclass(frozen=True)
class DroneConfig:
    """`drone:` block (config/params.yaml:38-62)."""

    initial_position: Tuple[float, float, float] = (0.0, 0.0, 10.0)
    initial_orientation: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # ypr, degrees
    initial_velocity: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    max_rates: float = 200.0  # deg/s
    mass: float = 750.0  # grams
    drag_coefficients: Tuple[float, float, float] = (1.8, 1.8, 1.2)
    dimensions: Tuple[float, float, float] = (26.0, 30.0, 5.0)  # cm
    rates_transition_rate: float = 0.7
    thrust_transition_rate: float = 0.5
    trail_length: int = 0
    keep_distance: float = 6.0  # m
    UWB_sensor_max_range: float = 13.0  # m
    motor_test_report_path: Optional[str] = None  # None -> baked F80 bench tables
    motor_test_report_idx: int = 0
    joystick_calib_path: Optional[str] = None
    force_multiplier_pid: PidConfig = field(default_factory=PidConfig)


@dataclass(frozen=True)
class CameraConfig:
    """`camera:` block (config/params.yaml:64-68)."""

    camera_angle: float = 35.0  # pitch, degrees
    position_relative_to_frame: Tuple[float, float, float] = (0.1, 0.0, 0.0)  # m
    fov: float = 120.0  # degrees (focal length from width: components.py:470-472)
    resolution: Tuple[int, int] = (640, 480)  # (W, H)


@dataclass(frozen=True)
class PointAndShootConfig:
    """`point_and_shoot:` block (config/params.yaml:71-76)."""

    ref_frame: str = "world"
    mode: str = "level"
    virtual_drag_coefficient: float = 0.5
    virtual_lift_coefficient: float = 0.1
    tof_effective_distance: float = 2.0


@dataclass(frozen=True)
class FpyvConfig:
    simulator: SimulatorConfig = field(default_factory=SimulatorConfig)
    drone: DroneConfig = field(default_factory=DroneConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    point_and_shoot: PointAndShootConfig = field(default_factory=PointAndShootConfig)
    extras: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path) -> "FpyvConfig":
        return cls.from_dict(yaml_reader(path))

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "FpyvConfig":
        raw = dict(raw or {})

        def build(dc_cls, section: Dict[str, Any]):
            names = {f.name for f in dataclasses.fields(dc_cls)}
            known = {k: v for k, v in section.items() if k in names}
            if dc_cls is DroneConfig and "force_multiplier_pid" in known:
                known["force_multiplier_pid"] = PidConfig(**known["force_multiplier_pid"])
            for key in ("initial_position", "initial_orientation", "initial_velocity",
                        "drag_coefficients", "dimensions", "position_relative_to_frame",
                        "resolution"):
                if key in known and isinstance(known[key], (list, tuple)):
                    known[key] = tuple(known[key])
            return dc_cls(**known)

        known_sections = {"simulator", "drone", "camera", "point_and_shoot",
                          "calculate_needed_force_orientation"}
        extras = {k: v for k, v in raw.items() if k not in known_sections}
        if "calculate_needed_force_orientation" in raw:
            extras["calculate_needed_force_orientation"] = raw["calculate_needed_force_orientation"]
        return cls(
            simulator=build(SimulatorConfig, raw.get("simulator", {})),
            drone=build(DroneConfig, raw.get("drone", {})),
            camera=build(CameraConfig, raw.get("camera", {})),
            point_and_shoot=build(PointAndShootConfig, raw.get("point_and_shoot", {})),
            extras=extras,
        )
