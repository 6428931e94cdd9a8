"""Model zoo of the port."""
from . import bert, gpt2
from .bert import (BERTForPretrain, BERTModel, bert_configs, get_bert,
                   pretrain_loss)
from .gpt2 import GPT2Model, get_gpt2, gpt2_configs, lm_loss

__all__ = ["bert", "gpt2", "BERTForPretrain", "BERTModel", "bert_configs",
           "get_bert", "pretrain_loss", "GPT2Model", "get_gpt2",
           "gpt2_configs", "lm_loss"]
