"""megaloop_host_ms: the host time of one ``fused_env_rollout`` call (the
wrapper's checks, its state, world, cylinder and action matrices, the
launch, the state and the world's counter), taken by the driver on the host
clock around each traced call, with no synchronize added; the median over
the traced calls."""

import statistics


def read(ctx):
    times = ctx.get("megaloop_call_ms")
    if not times:
        return None
    return statistics.median(times)
