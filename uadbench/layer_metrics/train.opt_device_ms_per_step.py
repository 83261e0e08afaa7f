"""Device ms a step of the kernels launched inside the optimizer's step, in
the traced slice."""


def read(ctx):
    ms = ctx.trace.device_ms_under(lambda name: name == "uadbench.opt")
    steps = ctx.traced_units / ctx.driver.p["batch"]
    return ms / steps if ms > 0 else None
