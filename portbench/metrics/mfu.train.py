"""mfu.train: the policy's model FLOPs of one PPO iteration (the rollout's
forwards, the bootstrap forward, forward and backward over every epoch's
samples; portbench/counts.py) over the median iteration time of the traced
run, as a share of the H100's 989 TFLOP/s (bf16, dense), in percent."""

import statistics

from portbench import counts


def read(ctx):
    ms = ctx.get("iteration_ms") or []
    if ctx["kind"] != "train" or not ms:
        return None
    return 100.0 * counts.iteration_flops(ctx["cfg"]) / (statistics.median(ms) * 1e-3) \
        / counts.PEAK_BF16_FLOPS
