"""Serving: the generation engine and the continuous batcher."""
from .batcher import FINISH_REASONS, ContinuousBatcher, GenRequest
from .engine import GenerationEngine, SamplingConfig

__all__ = ["ContinuousBatcher", "GenRequest", "FINISH_REASONS",
           "GenerationEngine", "SamplingConfig"]
