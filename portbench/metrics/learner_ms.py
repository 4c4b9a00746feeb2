"""learner_ms: an iteration's time less its rollout's (one launch and the
bootstrap frame), each timed alone with CUDA events in the traced run, the
median of the repetitions (chip_smoke.py::trainer_split's method)."""

import statistics


def read(ctx):
    spans = ctx.get("spans")
    if not spans:
        return None
    return statistics.median(w - r for w, r in zip(spans["iteration_ms"], spans["rollout_ms"]))
