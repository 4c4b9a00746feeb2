"""host_syncs.train: the blocking host-device synchronisations (a copy
with non_blocking=False, .item(), .cpu(): torch.cuda's sync debug warning,
counted by the program's spans) inside one ``ppo.iteration``, the mean over
the traced iterations (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.mean_of("host_syncs.train", spans.roots(ctx, "ppo.iteration"), spans.syncs)
