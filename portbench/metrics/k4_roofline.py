"""k4_roofline: the least time of one K4 launch's work for its inputs
(portbench/counts_env.py: operations and bytes against the H100's peaks;
the resets counted from the checked launches' reset flags) over K4's mean
device time a launch in the traced calls (torch.profiler), in percent."""

from portbench import counts, counts_env
from portbench.trace import kernel_time


def read(ctx):
    tr = ctx.get("trace")
    if not tr or ctx["cfg"].get("kernel") != "env_rollout":
        return None
    seconds, launches = kernel_time(tr, "::env_rollout_kernel")
    if not launches:
        return None
    work = counts_env.launch_work(ctx["cfg"], resets=ctx.get("ends_per_launch", 0))
    return 100.0 * counts.least_seconds(work) / (seconds / launches)
