"""gluon.rnn: the fused layers and the unfused cells (reference:
``python/mxnet/gluon/rnn/``)."""
from .rnn_layer import GRU, LSTM, RNN
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell, LSTMCell,
                       ModifierCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)

__all__ = ["RNN", "LSTM", "GRU", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "ModifierCell", "DropoutCell",
           "ResidualCell", "ZoneoutCell", "BidirectionalCell"]
