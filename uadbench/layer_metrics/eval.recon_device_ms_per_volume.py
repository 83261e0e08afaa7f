"""Device ms a volume of the kernels launched inside the reconstruction
(``task.reconstruct_with_aux``), in the traced slice."""


def read(ctx):
    ms = ctx.trace.device_ms_under(lambda name: name == "uadbench.recon")
    return ms / ctx.traced_units if ms > 0 else None
