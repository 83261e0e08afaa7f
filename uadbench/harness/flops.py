"""Exact operation counts of the cDDPM's two networks, from the
configuration's shapes: 2 operations a multiply-add of every convolution,
linear layer and attention product (normalisations, activations and
elementwise work are not counted). A training step counts three forwards;
recomputation is not counted. The published peaks of one H100 SXM (NVIDIA's
data sheet, dense): 989e12 bf16 operations/s, 3.35e12 bytes/s."""
from __future__ import annotations

BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _conv_out(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def attention_flops(s: int, c: int) -> float:
    """One attention block on one row of ``s`` tokens of ``c`` channels: the
    qkv and output projections and the two products (4 s^2 c)."""
    return 2.0 * s * c * 3 * c + 2.0 * s * c * c + 4.0 * s * s * c


def attention_bytes(rows: int, s: int, c: int, act_bytes: int = 2) -> float:
    """x in and the block's output once, in the compute dtype, and the
    float32 qkv, projection and GroupNorm weights once."""
    return 2.0 * rows * s * c * act_bytes + (4 * c * c + 6 * c) * 4.0


def unet_forward(model: dict, hw) -> float:
    """Operations of one UNet forward on one row at ``hw``."""
    mc = model["unet_dim"]
    emb, cond = 4 * mc, model["cond_dim"]
    emb_ch = 2 * emb
    h, w = hw
    total = 2.0 * (mc * emb + emb * emb + cond * emb + emb * emb)  # embeddings
    total += _conv(h, w, 1, mc, 3)

    def res(hh, ww, cin, cout):
        t = _conv(hh, ww, cin, cout, 3) + _conv(hh, ww, cout, cout, 3) + 2.0 * emb_ch * 2 * cout
        return t + (_conv(hh, ww, cin, cout, 1) if cin != cout else 0.0)

    def attn(hh, ww, ch):  # heads split the channels: the count is the same
        return attention_flops(hh * ww, ch)

    skips, ch, ds = [mc], mc, 1
    att = set(model["attention_resolutions"])
    mults = list(model["channel_mult"])
    for level, mult in enumerate(mults):
        for _ in range(model["num_res_blocks"]):
            total += res(h, w, ch, mult * mc)
            ch = mult * mc
            if ds in att:
                total += attn(h, w, ch)
            skips.append(ch)
        if level != len(mults) - 1:
            h, w = h // 2, w // 2
            total += res(h, w, ch, ch)
            skips.append(ch)
            ds *= 2
    total += 2 * res(h, w, ch, ch) + attn(h, w, ch)
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(model["num_res_blocks"] + 1):
            total += res(h, w, ch + skips.pop(), mult * mc)
            ch = mult * mc
            if ds in att:
                total += attn(h, w, ch)
            if level and i == model["num_res_blocks"]:
                h, w = 2 * h, 2 * w
                total += res(h, w, ch, ch)
                ds //= 2
    return total + _conv(hw[0], hw[1], ch, 1, 3)


RESNET_STAGES = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet50": ("bottleneck", (3, 4, 6, 3))}


def encoder_forward(model: dict, hw) -> float:
    """Operations of one ResNet encoder forward on one row at ``hw``."""
    kind, sizes = RESNET_STAGES[model["encoder_backbone"]]
    h, w = (_conv_out(n, 7, 2) for n in hw)
    total = _conv(h, w, 1, 64, 7)
    h, w = (_conv_out(n, 3, 2) for n in (h, w))  # max-pool
    cin = 64
    for si, (n, width) in enumerate(zip(sizes, (64, 128, 256, 512))):
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            ho, wo = _conv_out(h, 3, stride), _conv_out(w, 3, stride)
            if kind == "bottleneck":
                out = 4 * width
                total += (_conv(h, w, cin, width, 1) + _conv(ho, wo, width, width, 3)
                          + _conv(ho, wo, width, out, 1))
            else:
                out = width
                total += _conv(ho, wo, cin, width, 3) + _conv(ho, wo, width, width, 3)
            if cin != out or stride != 1:
                total += _conv(ho, wo, cin, out, 1)
            cin, h, w = out, ho, wo
    return total + 2.0 * cin * model["cond_dim"]


def eval_volume_flops(model: dict, hw, padded_depth: int) -> float:
    """A single-shot volume reconstruction: the encoder on its padded slice
    stack and the UNet on each ensemble member's copy of it."""
    members = len(model["step_ensemble"])
    return padded_depth * (encoder_forward(model, hw) + members * unet_forward(model, hw))


def train_step_flops(model: dict, hw, batch: int) -> float:
    return 3.0 * batch * (encoder_forward(model, hw) + unet_forward(model, hw))
