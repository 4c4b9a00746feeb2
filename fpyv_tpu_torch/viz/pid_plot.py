"""PID history plotting — parity with PID.plot (components.py:56-69); the
port's own copy of ``fpyv_tpu.viz.pid_plot``.

The vectorised PID (:mod:`fpyv_tpu_torch.control.pid`) keeps no history;
rollouts return the per-step (error, integral, derivative) arrays instead.
This helper renders them in the reference's 3-panel layout (matplotlib,
imported at the call).
"""

from __future__ import annotations

import numpy as np


def plot_pid_history(error, integral, derivative, block: bool = False):
    """3-panel error/integral/derivative plot (components.py:56-69)."""
    import matplotlib.pyplot as plt

    error = np.asarray(error)
    plt.clf()
    plt.subplot(131)
    plt.plot(error, label="error")
    plt.plot(np.asarray(derivative), label="derivative", alpha=0.5)
    plt.title("Error: {:.2f}".format(float(error[-1])))
    plt.subplot(132)
    plt.plot(np.asarray(integral), label="integral")
    plt.title("Integral")
    plt.subplot(133)
    plt.plot(np.asarray(derivative), label="derivative")
    plt.title("Derivative")
    if block:
        plt.show()
    else:
        plt.pause(0.001)
