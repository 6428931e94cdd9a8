"""What the zoo's constructors share: ``ctx=`` and ``pretrained=``."""
from __future__ import annotations

import contextlib

from ....base import MXNetError


def _on(ctx):
    """Construction on ``ctx`` (a ``Context``; None: the current one)."""
    return contextlib.nullcontext() if ctx is None else ctx


def _no_pretrained(pretrained):
    if pretrained:
        raise MXNetError("pretrained=True: the port ships no weights (load a "
                         ".params file with load_parameters)")
