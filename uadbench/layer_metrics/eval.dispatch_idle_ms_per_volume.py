"""Device idle ms a volume inside the program's main-thread ``eval.dispatch``
spans, in the traced slice."""
from uadbench.harness import program_spans


def read(ctx):
    ms = program_spans.idle_ms(ctx.trace, "eval.dispatch")
    return None if ms is None else ms / ctx.traced_units
