"""ppo_backward_ms: the host time of an iteration's ``ppo.backward`` spans
(each minibatch's zero_grad and backward), summed over the iteration, the
median over the traced iterations (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.median_of("ppo_backward_ms", spans.roots(ctx, "ppo.iteration"),
                           lambda recs: spans.ms(recs, "ppo.backward"))
