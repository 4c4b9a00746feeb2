"""The interactive simulator app — the rebuild of src/core/simulator.py
(mirrors ``fpyv_tpu.apps.simulator``).

Same loop shape (simulator.py:83-177): world build -> per-step target
update -> render the chased target's depth image -> extract its pixel
centroid -> pixel-guidance override -> physics step -> render. The step is
eager PyTorch on ``device`` (CUDA unless told); both views are the splat
renderer's (:mod:`fpyv_tpu_torch.vision.renderer`), as in the JAX package.

The scripted path keeps the JAX function's chunks: ``chunk`` steps (60 with
frames, 512 headless) run whole, their positions, velocities, crash flags
and target centres stack on the device, and the host reads them once a
chunk. The first crash in a chunk sets ``steps``, ``crashed`` and the final
state; the frames at t % 2 == 0 up to it go through the HUD to the sink,
the 3d view draws at t % 3 == 0. Only the shown frames are rendered. The
guided step computes both physics steps (guidance override and free) and
selects with the device's ``found`` flag, as JAX's ``tree_where`` does. The
joystick and virtual-target paths stay per step: a human in the loop needs
per-step host reads.

Rendering modes are 'none' (headless), '2d' (FPV depth + HUD via cv2 when
a display exists, else frames to ``frame_sink``), '3d' (matplotlib world
view); input is the native Linux joystick when present, else a scripted
action (the reference's hard-coded ``[-0.1, 0, 0, 0]``, simulator.py:89).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from fpyv_tpu_torch.config import FpyvConfig
from fpyv_tpu_torch.control.guidance import (
    GuidanceParams,
    guidance_init,
    needed_force_orientation,
)
from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.base import tree_where
from fpyv_tpu_torch.physics.drone import DroneParams, _att_to_rotmat, drone_reset, drone_step
from fpyv_tpu_torch.physics.world import update_targets
from fpyv_tpu_torch.vision.camera import CameraRig, camera_pose
from fpyv_tpu_torch.vision.renderer import render_depth_image, target_pixel_centroid
from fpyv_tpu_torch.world.generators import WorldSpec, build_world
from fpyv_tpu_torch.world.render_bank import bank_subset, build_render_bank

TARGET_IDX = 0  # simulator.py:55 target_chase_idx


def run_simulator(
    cfg: Optional[FpyvConfig] = None,
    steps: int = 10000,
    render: str = "none",  # 'none' | '2d' | '3d'
    guided: bool = True,
    use_joystick: bool = False,
    seed: int = 0,
    max_depth: float = 25.0,
    frame_sink=None,  # callable(np.uint8 frame) for testing/recording
    chunk: Optional[int] = None,  # steps between host reads; None = auto
    virtual_target: bool = False,  # mouse-drag target (simulator.py:15-31)
    target_events=None,  # callable(t) -> iterable of (event, x, y) tuples
    device=None,  # CUDA unless "cpu"
) -> dict:
    device = resolve_device(device)
    cfg = cfg or FpyvConfig()
    params = DroneParams.from_config(cfg)
    rig = CameraRig.from_config(cfg.camera)
    g = GuidanceParams.from_config(cfg, params)

    spec = WorldSpec.from_config(cfg.simulator, seed=seed)
    world = build_world(spec, device=device)
    bank = build_render_bank(spec, rng=np.random.default_rng(seed))
    target_bank = bank_subset(bank, [TARGET_IDX]) if spec.targets else None

    kw = dict(dtype=torch.float32, device=device)
    state = drone_reset(params, torch.tensor(cfg.drone.initial_position, **kw),
                        torch.tensor(cfg.drone.initial_velocity, **kw),
                        torch.tensor(cfg.drone.initial_orientation, **kw))
    gs = guidance_init((), torch.float32, device)
    wind = torch.zeros(3, **kw)

    joystick = None
    if use_joystick:
        from fpyv_tpu_torch.inputs.rc import Joystick

        joystick = Joystick()
        if joystick.status and cfg.drone.joystick_calib_path:
            joystick.calibrate(cfg.drone.joystick_calib_path, True)
        elif not joystick.status:
            print("Joystick device was not found")  # components.py:80
            joystick = None

    def guidance(state, gs, world, pixel):
        R = _att_to_rotmat(params, state.att)
        _, cam_R = camera_pose(rig, state.pos, R)
        dist = (torch.linalg.vector_norm(world.sphere_center[TARGET_IDX] - state.pos)
                - world.sphere_radius[TARGET_IDX])
        return needed_force_orientation(g, gs, rig, cam_R, pixel, state.pos, state.vel, dist,
                                        params.mass)

    def sim_step(state, gs, world, action):
        world = update_targets(world)
        if target_bank is not None and guided:
            R = _att_to_rotmat(params, state.att)
            cam_pos, cam_R = camera_pose(rig, state.pos, R)
            timg = render_depth_image(rig, cam_pos, cam_R, target_bank, world=world,
                                      max_depth=max_depth)
            pixel, found = target_pixel_centroid(timg)
            gs2, R_des, f_des = guidance(state, gs, world, pixel)
            # guidance only when the target is visible (simulator.py:104-110),
            # selected on the device
            state_g, _ = drone_step(params, state, action, world, wind,
                                    att_override=R_des, thrust_override=f_des)
            state_f, _ = drone_step(params, state, action, world, wind)
            state = tree_where(found, state_g, state_f)
            gs = tree_where(found, gs2, gs)
        else:
            state, _ = drone_step(params, state, action, world, wind)
        return state, gs, world

    def sim_step_virtual(state, gs, world, action, pixel):
        """One step steered at a user-supplied pixel: the reference's
        mouse-target path (target_pixels = [ix, iy], simulator.py:131)
        replaces the rendered centroid; overrides only when guided."""
        world = update_targets(world)
        if not (guided and spec.targets):  # respect the guided flag
            state, _ = drone_step(params, state, action, world, wind)
            return state, gs, world
        gs, R_des, f_des = guidance(state, gs, world, pixel)
        state, _ = drone_step(params, state, action, world, wind,
                              att_override=R_des, thrust_override=f_des)
        return state, gs, world

    def render_frame(state, world):
        R = _att_to_rotmat(params, state.att)
        cam_pos, cam_R = camera_pose(rig, state.pos, R)
        return render_depth_image(rig, cam_pos, cam_R, bank, world=world, max_depth=max_depth)

    vt = None
    if virtual_target:
        if not spec.targets:
            # the guidance law keeps distance to the chased target
            raise ValueError("virtual_target requires a world with targets "
                             "(simulator.targets in params.yaml)")
        from fpyv_tpu_torch.inputs.mouse import VirtualTarget

        vt = VirtualTarget(rig.resolution)

    cv2 = None
    if render == "2d":
        # cv2.namedWindow aborts (uncatchable) without a display server;
        # only attempt the GUI when one exists, else frames go to frame_sink.
        if os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"):
            try:
                import cv2 as _cv2

                _cv2.namedWindow("img")
                cv2 = _cv2
                if vt is not None:  # the reference's setMouseCallback wiring
                    _cv2.setMouseCallback("img", vt.cv2_callback)
            except Exception:
                cv2 = None
    ax = fig = None
    if render == "3d":
        from fpyv_tpu_torch.viz.render3d import init_3d_axis

        ax, fig = init_3d_axis()

    def show_2d(frame_u8, pos, vel, target_center):
        from fpyv_tpu_torch.viz.hud import hud_overlay

        frame = hud_overlay(frame_u8, dist_to_target=float(np.linalg.norm(target_center - pos)),
                            speed_ms=float(np.linalg.norm(vel)), height_m=float(pos[2]))
        if frame_sink is not None:
            frame_sink(frame)
        if cv2 is not None:
            cv2.imshow("img", frame)
            return cv2.waitKey(1) & 0xFF == ord("q")
        return False

    default_action = torch.tensor([-0.1, 0.0, 0.0, 0.0], **kw)  # :89

    done_steps = 0
    crashed = False
    final_pos = state.pos.cpu().numpy()
    final_vel = state.vel.cpu().numpy()

    with torch.no_grad():
        if joystick is not None or vt is not None:
            # interactive: per-step host loop (stick reads and mouse state)
            for t in range(steps):
                action = (torch.tensor(joystick.read_action(), **kw)
                          if joystick is not None else default_action)
                if vt is not None:
                    if target_events is not None:
                        for ev in (target_events(t) or ()):
                            vt.on_event(*ev)
                    pixel = torch.tensor(vt.pixel(), **kw)
                    state, gs, world = sim_step_virtual(state, gs, world, action, pixel)
                else:
                    state, gs, world = sim_step(state, gs, world, action)
                done_steps = t + 1
                if bool(state.done):
                    crashed = True
                    print("Crashed")  # simulator.py:92
                    break
                if render == "2d" and t % 2 == 0:  # :164
                    frame = render_frame(state, world).cpu().numpy()
                    if show_2d(frame, state.pos.cpu().numpy(), state.vel.cpu().numpy(),
                               world.sphere_center[TARGET_IDX].cpu().numpy()):
                        break
                elif render == "3d" and t % 3 == 0:  # :113
                    from fpyv_tpu_torch.viz.render3d import render_drone, show_plot

                    ax.clear()
                    render_drone(ax, state, params)
                    show_plot(ax, fig, middle=state.pos.cpu().numpy(), edge=5)
            final_pos = state.pos.cpu().numpy()
            final_vel = state.vel.cpu().numpy()
        else:
            # scripted: whole chunks, one host read each
            if chunk is None:
                chunk = 60 if render != "none" else 512
            t0 = 0
            while t0 < steps and not crashed:
                n = min(chunk, steps - t0)
                rows, frames = [], []
                for i in range(n):
                    state, gs, world = sim_step(state, gs, world, default_action)
                    rows.append(torch.cat([state.pos, state.vel, state.done[None].float()]))
                    if render == "2d" and (t0 + i) % 2 == 0:
                        frames.append(render_frame(state, world))
                # the HUD's range reads the chunk's last world, as JAX's does
                rows.append(torch.cat([world.sphere_center[TARGET_IDX],
                                       torch.zeros(4, **kw)]) if spec.targets
                            else torch.zeros(7, **kw))
                host = torch.stack(rows).cpu().numpy()
                frames_h = torch.stack(frames).cpu().numpy() if frames else None
                pos_h, vel_h, done_h = host[:n, :3], host[:n, 3:6], host[:n, 6] > 0
                center = host[n, :3]
                idx = int(np.argmax(done_h)) if bool(done_h.any()) else n - 1
                if bool(done_h[idx]):
                    crashed = True
                    print("Crashed")  # simulator.py:92
                done_steps = t0 + idx + 1
                final_pos, final_vel = pos_h[idx], vel_h[idx]
                for i in range(0, idx + 1):
                    t = t0 + i
                    if render == "2d" and t % 2 == 0:  # :164
                        if show_2d(frames_h[i // 2], pos_h[i], vel_h[i], center):
                            t0 = steps
                            break
                    elif render == "3d" and t % 3 == 0:  # :113
                        from fpyv_tpu_torch.viz.render3d import plot_3d_points, show_plot

                        # the chunk stacks no attitude: draw the position trail
                        ax.clear()
                        plot_3d_points(ax, pos_h[: i + 1])
                        show_plot(ax, fig, middle=pos_h[i], edge=5)
                t0 += n

    return {
        "steps": done_steps,
        "crashed": crashed,
        "final_position": final_pos,
        "final_velocity": final_vel,
    }
