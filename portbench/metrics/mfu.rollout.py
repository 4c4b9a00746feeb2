"""mfu.rollout: the policy's model FLOPs of the window's launches (one
forward an env-step and one bootstrap forward an env a call;
portbench/counts.py) over the window's seconds, as a share of the H100's
989 TFLOP/s (bf16, dense), in percent."""

from portbench import counts


def read(ctx):
    if ctx["kind"] != "rollout":
        return None
    cfg = ctx["cfg"]
    forwards = ctx["env_steps"] + ctx["calls"] * cfg["num_envs"]
    return 100.0 * forwards * counts.forward_flops(cfg) / ctx["window_s"] / counts.PEAK_BF16_FLOPS
