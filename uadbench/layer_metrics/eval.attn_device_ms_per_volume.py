"""Device ms a volume of the kernels launched inside the UNet's attention
blocks (each block: its norm, qkv projection, K2 and output projection), in
the traced slice: the time ``eval.attn_roofline`` divides by, per volume."""


def read(ctx):
    ms = ctx.trace.device_ms_under(lambda name: name == "uadbench.attn")
    return ms / ctx.traced_units if ms > 0 else None
