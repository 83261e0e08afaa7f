"""``eval.resid_fused_share``: the program's ResBlock output-sum counter as a
percentage, and None where there is nothing to read (a program without the
counter, or no call on the card)."""
from types import SimpleNamespace

from conditioned_diffusion_models_uad_torch.models import unet
from uadbench.harness.cell import load_reader


def test_reads_the_counter_and_none_without_it(monkeypatch):
    read = load_reader("eval.resid_fused_share")
    ctx = SimpleNamespace()
    monkeypatch.setattr(unet.ResBlock, "residual_calls", {"fused": 3, "eager": 1})
    assert read(ctx) == 75.0
    monkeypatch.setattr(unet.ResBlock, "residual_calls", {"fused": 0, "eager": 0})
    assert read(ctx) is None
    monkeypatch.delattr(unet.ResBlock, "residual_calls")
    assert read(ctx) is None
