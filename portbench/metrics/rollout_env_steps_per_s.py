"""rollout_env_steps_per_s: env-steps of every rollout call completed in
the window (num_envs x T each), over the window's seconds, the closing
synchronize included (host clock)."""


def read(ctx):
    if ctx["kind"] != "rollout":
        return None
    return ctx["env_steps"] / ctx["window_s"]
