"""k8_roofline: the least time of one K8 launch's work for its inputs
(portbench/counts.py: operations, bf16 flops and bytes against the H100's
peaks; the resets counted from the checked launches' ends) over K8's
mean device time a launch in the traced calls (torch.profiler), in
percent."""

from portbench import counts
from portbench.trace import kernel_time


def read(ctx):
    tr = ctx.get("trace")
    if not tr or ctx["cfg"]["kernel"] != "race_vision_rollout":
        return None
    seconds, launches = kernel_time(tr, "race_vision_rollout_kernel")
    if not launches:
        return None
    work = counts.launch_work(ctx["cfg"], ends=ctx.get("ends_per_launch", 0))
    return 100.0 * counts.least_seconds(work) / (seconds / launches)
