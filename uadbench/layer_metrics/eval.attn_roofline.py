"""The attention blocks' share of their roofline, in percent: the least time
their work needs (the larger of its operations over the bf16 peak and its
bytes over the HBM bandwidth, counted from the shapes) over the device time
of the kernels launched inside them, in the traced slice."""
from uadbench.harness import flops


def read(ctx):
    ms = ctx.trace.device_ms_under(lambda name: name == "uadbench.attn")
    if ms <= 0:
        return None
    least = sum(max(rows * flops.attention_flops(s, c) / flops.BF16_PEAK_FLOPS,
                    flops.attention_bytes(rows, s, c) / flops.HBM_BYTES_PER_S)
                for rows, s, c in ctx.driver.attention_calls(ctx.traced_units))
    return 100.0 * least * 1e3 / ms
