"""ppo_learn_ms: the learner's host time, an iteration's ``ppo.iteration``
span less its ``ppo.rollout`` (the GAE, shuffles, minibatches and info),
the median over the traced iterations (the program's spans,
portbench/spans.py)."""

from portbench import spans


def _learner(recs):
    return spans.ms(recs, "ppo.iteration") - spans.ms(recs, "ppo.rollout")


def read(ctx):
    return spans.median_of("ppo_learn_ms", spans.roots(ctx, "ppo.iteration"), _learner)
