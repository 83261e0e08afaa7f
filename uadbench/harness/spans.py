"""Spans around the calls into the system's layers, installed at set-up from
the benchmark's side: wrappers of bound methods and module-level functions,
and forward hooks of modules. Nothing in the system is edited. Each span is
a ``torch.profiler.record_function`` range, so the traced slice attributes
the kernels launched inside it."""
from __future__ import annotations

import functools

from torch.profiler import record_function


def wrap(owner, attr: str, name: str) -> None:
    """Replace ``owner.attr`` (a bound method or a module's function) by the
    same call inside span ``name``."""
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    setattr(owner, attr, spanned)


def hook_modules(root, cls, name: str) -> None:
    """A span around every forward of ``root``'s submodules of type ``cls``."""
    for m in root.modules():
        if isinstance(m, cls):
            m.register_forward_pre_hook(_enter(name))
            m.register_forward_hook(_exit)


def _enter(name):
    def pre(module, args):
        rf = record_function(name)
        rf.__enter__()
        module._uadbench_span = rf
    return pre


def _exit(module, args, output):
    module._uadbench_span.__exit__(None, None, None)
