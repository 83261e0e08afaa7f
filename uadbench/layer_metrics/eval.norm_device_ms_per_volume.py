"""Device ms a volume of the kernels launched inside the UNet's GroupNorm32
calls, in the traced slice."""


def read(ctx):
    ms = ctx.trace.device_ms_under(lambda name: name == "uadbench.norm")
    return ms / ctx.traced_units if ms > 0 else None
