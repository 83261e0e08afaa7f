"""The window's encoder and UNet forward operations, counted from the
configuration's shapes, over the window's seconds times the bf16 peak, in
percent."""
from uadbench.harness import flops


def read(ctx):
    w = ctx.window
    return 100.0 * ctx.driver.work_flops(w.units) / (w.elapsed * flops.BF16_PEAK_FLOPS)
