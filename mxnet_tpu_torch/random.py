"""Random number generation: ``mx.random.seed`` over one explicit
``torch.Generator`` per device.

Counterpart of ``mxnet_tpu/random.py``. The JAX package splits a
threefry key at each draw; here each device has its own Philox (CUDA) or
Mersenne-Twister (CPU) generator, made on first use from seed 0 and reset
by :func:`seed`. The two streams never agree, so parity with the JAX
package runs through carried weights and at dropout 0, and the samplers
are held to the JAX package's by their distributions. Initializers draw
on the CPU generator (so a seed gives the same weights on any device);
``Dropout``, the samplers of ``ops/random_ops.py`` and ``nd.random`` draw
on the generator of their tensor's device. :func:`uniform`,
:func:`normal` and :func:`randint` draw on the current context (the card)
unless given a device.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "uniform", "normal", "randint"]

_LOCK = threading.Lock()
_GENERATORS = {}
_SEED = [0]


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device="cpu") -> torch.Generator:
    """The generator of ``device``, made from the last seed on first use."""
    dev = _key(device)
    with _LOCK:
        gen = _GENERATORS.get(dev)
        if gen is None:
            gen = _GENERATORS[dev] = torch.Generator(device=dev)
            gen.manual_seed(_SEED[0])
        return gen


def seed(seed_state: int, ctx=None):
    """Reset the generators (``mx.random.seed``): every device's, or with
    ``ctx`` only that device's."""
    from .context import as_device

    seed_state = int(seed_state)
    with _LOCK:
        if ctx is None or ctx == "all":
            _SEED[0] = seed_state
            _GENERATORS.clear()
            return
        dev = _key(as_device(ctx))
        gen = _GENERATORS.get(dev)
        if gen is None:
            gen = _GENERATORS[dev] = torch.Generator(device=dev)
        gen.manual_seed(seed_state)


def uniform(low=0.0, high=1.0, shape=(), dtype=torch.float32, device=None):
    from .ops.random_ops import random_uniform

    return random_uniform(low, high, shape, dtype, ctx=device)


def normal(loc=0.0, scale=1.0, shape=(), dtype=torch.float32, device=None):
    from .ops.random_ops import random_normal

    return random_normal(loc, scale, shape, dtype, ctx=device)


def randint(low, high, shape=(), dtype=torch.int32, device=None):
    from .ops.random_ops import random_randint

    return random_randint(low, high, shape, dtype, ctx=device)
