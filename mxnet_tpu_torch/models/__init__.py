"""Model zoo of the port."""
from . import bert, gpt2, transformer
from .bert import (BERTForPretrain, BERTModel, bert_configs, get_bert,
                   pretrain_loss)
from .gpt2 import GPT2Model, get_gpt2, gpt2_configs, lm_loss
from .transformer import (Transformer, get_transformer, label_smoothing_loss,
                          transformer_configs)

__all__ = ["bert", "gpt2", "transformer", "BERTForPretrain", "BERTModel",
           "bert_configs", "get_bert", "pretrain_loss", "GPT2Model",
           "get_gpt2", "gpt2_configs", "lm_loss", "Transformer",
           "get_transformer", "label_smoothing_loss", "transformer_configs"]
