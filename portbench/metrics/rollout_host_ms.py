"""rollout_host_ms: the host time of one K7 or K8 ``rollout_fn`` call, its
``rollout`` span (the weights, the wrapper's checks, constants and launch,
the bootstrap frame), the median over the traced calls
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.median_of("rollout_host_ms", spans.roots(ctx, "rollout"),
                           lambda recs: spans.ms(recs, "rollout"))
