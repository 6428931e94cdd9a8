"""Contrib modules of the port: ``amp`` (mixed precision)."""
from . import amp

__all__ = ["amp"]
