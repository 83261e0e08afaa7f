"""The share of the traced slice's attention block calls that launched K2,
in percent: the K2 launches (``fused_attention.launches``, counted by the
program's wrappers where they launch a kernel) over the blocks' calls
(counted by the driver's forward hooks), each call launching K2 at most
once. None where the driver counts no attention call."""


def read(ctx):
    counted = getattr(ctx.driver, "traced_attention", None)
    if not counted or not counted["calls"]:
        return None
    return 100.0 * counted["k2"] / counted["calls"]
