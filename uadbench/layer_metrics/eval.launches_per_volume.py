"""Launches a volume: the distinct correlation ids of the device's kernels,
copies and sets launched on the main thread inside the program's
``eval.dispatch`` spans (a group's reconstruction and scoring), a traced
volume. The scorer threads' fetches are not counted."""
from uadbench.harness import program_spans


def read(ctx):
    n = program_spans.launches(ctx.trace, "eval.dispatch")
    return n / ctx.traced_units if n else None
