"""Models: LSTM prediction net, transformer blocks, TDNN-Transformer encoder
and the transducer."""

from pika_tpu_torch.models.lstm import LSTM, lstm_cell_step, lstm_stack_step
from pika_tpu_torch.models.transformer import (
    MultiHeadedAttention,
    PositionwiseFeedForward,
    TransformerEncoderLayer,
)
from pika_tpu_torch.models.tdnn_transformer import TDNNTransformerEncoder
from pika_tpu_torch.models.transducer import Transducer, TransducerConfig, init_transducer
