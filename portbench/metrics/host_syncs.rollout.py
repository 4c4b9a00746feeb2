"""host_syncs.rollout: the blocking host-device synchronisations inside
one ``rollout`` span (a K7 or K8 ``rollout_fn`` call), the mean over the
traced calls (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.mean_of("host_syncs.rollout", spans.roots(ctx, "rollout"), spans.syncs)
