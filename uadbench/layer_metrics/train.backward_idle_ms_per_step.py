"""Device idle ms a step inside the program's main-thread ``train.backward``
spans (the span's time outside the union of the device's intervals), in the
traced slice."""
from uadbench.harness import program_spans


def read(ctx):
    ms = program_spans.idle_ms(ctx.trace, "train.backward")
    return None if ms is None else ms / (ctx.traced_units / ctx.driver.p["batch"])
