"""Serving: the generation engine, the continuous batcher and the radix
prefix cache."""
from .batcher import FINISH_REASONS, ContinuousBatcher, GenRequest
from .engine import GenerationEngine, SamplingConfig
from .prefix_cache import RadixPrefixCache

__all__ = ["ContinuousBatcher", "GenRequest", "FINISH_REASONS",
           "GenerationEngine", "SamplingConfig", "RadixPrefixCache"]
