"""The share of the ResBlock output sums that took the program's fused
kernel, in percent: the program's own counter ``ResBlock.residual_calls``
({'fused', 'eager'}), which counts the sums on the card over the whole run
(set-up, window and traced slice). None where the program has no such
counter or counted no call."""
import importlib


def read(ctx):
    unet = importlib.import_module("conditioned_diffusion_models_uad_torch.models.unet")
    calls = getattr(getattr(unet, "ResBlock", None), "residual_calls", None)
    if not calls:
        return None
    total = sum(calls.values())
    return 100.0 * calls.get("fused", 0) / total if total else None
