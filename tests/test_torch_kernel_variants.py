"""The kernel-variant tool (``utils/kernel_variants.py``) and the ctypes
binding of the built kernels (``ops/_build.py::bind``), on the CPU: no
kernel is built or launched."""
import ctypes

import pytest

from conditioned_diffusion_models_uad_torch.ops import _build
from conditioned_diffusion_models_uad_torch.utils import kernel_variants as kv

ALL = [(lib, name) for lib, variants in kv.VARIANTS.items() for name in variants]


@pytest.mark.parametrize("library,name", ALL)
def test_variant_is_a_set_of_real_changes_to_a_built_library(library, name):
    assert library in _build.SOURCES
    assert (_build.CSRC / f"{library}.cu").is_file()
    changes = kv.VARIANTS[library][name]
    assert changes
    for old, new in changes:
        assert old and old != new


@pytest.mark.parametrize("src,want", [
    ("a b c", "a B c"),   # the text occurs once: changed
    ("a c", None),        # no longer occurs: the variant is skipped
    ("a b b", None),      # occurs twice: which one is meant is unknown
])
def test_apply_changes_skips_a_change_that_no_longer_applies(src, want):
    assert kv.apply_changes(src, [("b", "B")]) == want


def test_apply_changes_makes_every_change_in_order():
    assert kv.apply_changes("x y", [("x", "xy"), ("xy y", "z")]) == "z"
    assert kv.apply_changes("x y", [("x", "xy"), ("q", "r")]) is None


def test_bind_keeps_each_function_bound_once(monkeypatch):
    fn = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)
    types = [ctypes.c_int, ctypes.c_void_p]
    monkeypatch.setattr(_build, "_bound", {("lib", "f"): (fn, types)})
    # another list with the same types reuses the binding; no library loads
    assert _build.bind("lib", {"f": list(types)}) == {"f": fn}
    with pytest.raises(ValueError):
        _build.bind("lib", {"f": [ctypes.c_float]})
