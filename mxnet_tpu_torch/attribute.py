"""AttrScope (reference: ``python/mxnet/attribute.py``); counterpart of
``mxnet_tpu/attribute.py``.

In the reference, ``with mx.AttrScope(ctx_group='dev1'):`` annotates
symbol nodes for manual model parallelism (``group2ctx`` binding). Here
the scope keeps the merged attributes of the enclosing scopes, per thread,
for whatever reads :func:`current_attrs` (the symbol API and the
multi-device slice, not ported yet, are its readers).
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]


class AttrScope:
    _tls = threading.local()

    def __init__(self, **attrs):
        self._attrs = attrs

    def __enter__(self):
        stack = getattr(AttrScope._tls, "stack", None)
        if stack is None:
            stack = AttrScope._tls.stack = []
        merged = dict(stack[-1]) if stack else {}
        merged.update(self._attrs)
        stack.append(merged)
        return self

    def __exit__(self, *exc):
        AttrScope._tls.stack.pop()


def current_attrs() -> dict:
    stack = getattr(AttrScope._tls, "stack", None)
    return dict(stack[-1]) if stack else {}
