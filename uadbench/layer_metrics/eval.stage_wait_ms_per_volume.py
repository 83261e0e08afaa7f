"""Milliseconds a volume the stage loop waited for its scorer threads in the
window (``run_stage``'s own 'wait' phase)."""


def read(ctx):
    volumes = ctx.window.units
    return ctx.phases["wait"] * 1e3 / volumes if volumes else None
