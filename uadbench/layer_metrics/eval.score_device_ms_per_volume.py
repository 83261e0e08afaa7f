"""Device ms a volume of the kernels launched inside the scoring core
(``eval/fused.py::group_eval_core``), in the traced slice."""


def read(ctx):
    ms = ctx.trace.device_ms_under(lambda name: name == "uadbench.score")
    return ms / ctx.traced_units if ms > 0 else None
