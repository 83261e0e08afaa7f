"""Launches a step: the distinct correlation ids of the device's kernels,
copies and sets whose runtime call lies inside the program's main-thread
``train.step`` spans or inside the autograd engine's ops (the backward's
thread), over the traced steps. A CUDA-graph replay counts once."""
from uadbench.harness import program_spans


def read(ctx):
    n = program_spans.launches(ctx.trace, "train.step", autograd=True)
    return n / (ctx.traced_units / ctx.driver.p["batch"]) if n else None
