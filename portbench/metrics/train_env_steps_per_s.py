"""train_env_steps_per_s: env-steps of every training iteration completed
in the window (num_envs x T each), over the window's seconds, the closing
synchronize included (host clock)."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["env_steps"] / ctx["window_s"]
