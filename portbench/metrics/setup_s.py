"""setup_s: seconds from process start to the first timed call: loading,
building the trainer, the kernels' build on a checkout's first run, the
weights, and the calls that warm every shape (host clock)."""


def read(ctx):
    return ctx["setup_s"]
