"""ppo_step_ms: the host time of an iteration's ``ppo.clip`` and
``ppo.adam`` spans (each minibatch's global-norm clip and Adam step),
summed over the iteration, the median over the traced iterations
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.median_of("ppo_step_ms", spans.roots(ctx, "ppo.iteration"),
                           lambda recs: spans.ms(recs, "ppo.clip", "ppo.adam"))
