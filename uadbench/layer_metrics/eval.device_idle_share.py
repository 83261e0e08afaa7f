"""The share of the traced slice in which no kernel, copy or set ran on the
device (the union of their intervals), in percent."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.busy_s > 0 else None
