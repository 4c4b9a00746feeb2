"""Matplotlib 3D debug renderer — parity with src/utils/render3d.py.

The port's own copy of ``fpyv_tpu.viz.render3d``. Same function names and
plotting semantics (scatter/line/trisurf/wireframe/
quiver, RGB rotation-matrix triads, the drone-centered fixed-edge viewport of
``show_plot``), taking numpy arrays or torch tensors on any device (converted at the
boundary). The icosphere plot uses :mod:`fpyv_tpu_torch.world.icosphere`
instead of the external package; matplotlib is imported at the call.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def init_3d_axis():
    """render3d.py:10-13."""
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    return ax, fig


def plot_3d_icosphere(ax, t, radius, nu, **kwargs):
    """render3d.py:16-20 via the built-in icosphere mesh."""
    import mpl_toolkits.mplot3d

    from fpyv_tpu_torch.world.icosphere import icosphere

    vertices, faces = icosphere(nu)
    poly = mpl_toolkits.mplot3d.art3d.Poly3DCollection(
        _np(t) + radius * vertices[faces], **kwargs)
    ax.add_collection3d(poly)


def plot_3d_points(ax, points, **kwargs):
    p = _np(points).reshape(-1, 3)
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], **kwargs)


def plot_3d_line(ax, points, **kwargs):
    p = _np(points)
    ax.plot(p[:, 0], p[:, 1], p[:, 2], **kwargs)


def plot_3d_plane(ax, points, **kwargs):
    p = _np(points)
    ax.plot_trisurf(p[:, 0], p[:, 1], p[:, 2], **kwargs)


def plot_3d_grid(ax, points, **kwargs):
    p = _np(points)
    ax.plot_wireframe(p[:, 0], p[:, 1], p[:, 2], **kwargs)


def plot_3d_arrows(ax, points, arrows, **kwargs):
    p = _np(points).reshape(-1, 3)
    a = _np(arrows).reshape(-1, 3)
    ax.quiver(p[:, 0], p[:, 1], p[:, 2], a[:, 0], a[:, 1], a[:, 2], **kwargs)


def plot_3d_rotation_matrix(ax, R, t, scale=1.0, **kwargs):
    """RGB triad of the rotation's columns (render3d.py:61-64)."""
    R = _np(R)
    for dim, color in enumerate(["r", "g", "b"]):
        plot_3d_arrows(ax, t, scale * R[:, dim], color=color, **kwargs)


def plot_3d_grid_func(ax, z_func, limits, resolution, **kwargs):
    """Surface of z_func over a grid (render3d.py:48-58) — e.g. a
    terrain height field."""
    x = np.linspace(limits[0][0] - limits[0][1] / 2,
                    limits[0][0] + limits[0][1] / 2, resolution)
    y = np.linspace(limits[1][0] - limits[1][1] / 2,
                    limits[1][0] + limits[1][1] / 2, resolution)
    X, Y = np.meshgrid(x, y, indexing="ij")
    Z = _np(z_func(np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)))
    ax.plot_surface(X, Y, Z.reshape(resolution, resolution), **kwargs)


def show_plot(ax, fig, middle=None, edge=1.0, **_ignored):
    """Fixed-edge viewport around `middle` (render3d.py:79-93)."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator

    if middle is None:
        middle = np.zeros(3)
    middle = _np(middle)
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    for axis in (ax.xaxis, ax.yaxis, ax.zaxis):
        axis.set_major_locator(MaxNLocator(integer=True))
    lims = np.stack((middle - edge, middle + edge)).T
    ax.set_xlim(*lims[0])
    ax.set_ylim(*lims[1])
    ax.set_zlim(*lims[2])
    fig.tight_layout()
    plt.pause(1e-5)


def render_drone(ax, state, params=None, rpy=True, velocity=False,
                 thrust=False, total_force=False, motors=True):
    """Drone.render parity (components.py:431-446) from a DroneState."""
    from fpyv_tpu_torch.physics.drone import DroneParams, _att_to_rotmat, motor_layout

    params = params or DroneParams()
    pos = _np(state.pos)
    R = _np(_att_to_rotmat(params, torch.as_tensor(state.att)))
    plot_3d_points(ax, pos, color="k")
    if rpy:
        plot_3d_rotation_matrix(ax, R, pos, scale=0.5)
    if velocity:
        plot_3d_arrows(ax, pos, _np(state.vel), color="m", alpha=0.5)
    if thrust:
        plot_3d_arrows(ax, pos, _np(state.thrust) * R[:, 2], color="c", alpha=0.5)
    if total_force:
        plot_3d_arrows(ax, pos, _np(state.accel) * params.mass, color="k",
                       alpha=0.5)
    if motors:
        for m in motor_layout() @ R.T:
            plot_3d_icosphere(ax, pos + m, 0.02, 2, facecolor="k", alpha=0.6)
