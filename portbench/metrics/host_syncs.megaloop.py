"""host_syncs.megaloop: the blocking host-device synchronisations that the
program's sync counter counts inside one ``megaloop`` span (a
``fused_env_rollout`` call), the mean over the traced calls
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.mean_of("host_syncs.megaloop", spans.roots(ctx, "megaloop"), spans.syncs)
