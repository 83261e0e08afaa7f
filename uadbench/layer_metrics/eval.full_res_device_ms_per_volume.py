"""Device ms a volume of the kernels launched inside the program's
``unet.full_res`` spans (the UNet's blocks that end at the input's
resolution, and its output head), in the traced slice. None where the
program has no such span."""


def read(ctx):
    ms = ctx.trace.device_ms_under(lambda name: name == "unet.full_res")
    return ms / ctx.traced_units if ms > 0 else None
