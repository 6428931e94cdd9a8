"""Model zoo of the port."""
from . import bert, gpt2, ssd, transformer
from .bert import (BERTForPretrain, BERTModel, bert_configs, get_bert,
                   pretrain_loss)
from .gpt2 import GPT2Model, get_gpt2, gpt2_configs, lm_loss
from .ssd import SSD, get_ssd, ssd_loss, ssd_train_targets
from .transformer import (Transformer, get_transformer, label_smoothing_loss,
                          transformer_configs)

__all__ = ["bert", "gpt2", "ssd", "transformer", "BERTForPretrain", "BERTModel",
           "bert_configs", "get_bert", "pretrain_loss", "GPT2Model",
           "get_gpt2", "gpt2_configs", "lm_loss", "SSD", "get_ssd",
           "ssd_loss", "ssd_train_targets", "Transformer",
           "get_transformer", "label_smoothing_loss", "transformer_configs"]
