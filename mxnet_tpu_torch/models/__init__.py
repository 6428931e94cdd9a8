"""Model zoo of the port."""
from . import gpt2
from .gpt2 import GPT2Model, get_gpt2, gpt2_configs, lm_loss

__all__ = ["gpt2", "GPT2Model", "get_gpt2", "gpt2_configs", "lm_loss"]
