"""Device ms a step of the kernels launched inside ``task.loss`` and the
autograd engine's backward ops, in the traced slice."""


def read(ctx):
    ms = ctx.trace.device_ms_under(
        lambda name: name == "uadbench.loss"
        or name.startswith("autograd::engine::evaluate_function"))
    steps = ctx.traced_units / ctx.driver.p["batch"]
    return ms / steps if ms > 0 else None
