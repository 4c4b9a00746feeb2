"""device_idle.train: the share of the traced steady calls' wall time in
which no kernel or copy ran on the device (torch.profiler's device events,
user annotations left out), in percent."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
