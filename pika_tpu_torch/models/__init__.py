"""Models: LSTM (the prediction net; bidirectional and masked in the LAS),
SRU, transformer blocks, TDNN-Transformer and Conformer encoders, the
conv-transformer prediction net, the transducer and the LAS rescorer."""

from pika_tpu_torch.models.conformer import ConformerEncoder
from pika_tpu_torch.models.conv_transformer_lm import ConvTransformerLM
from pika_tpu_torch.models.las import LAS, LASConfig, PyramidLSTM, init_las
from pika_tpu_torch.models.lstm import LSTM, lstm_cell_step, lstm_stack_step
from pika_tpu_torch.models.sru import SRU, SRUCell
from pika_tpu_torch.models.transformer import (
    MultiHeadedAttention,
    PositionwiseFeedForward,
    TransformerEncoderLayer,
    causal_mask,
    padding_mask,
    relative_positions_matrix,
)
from pika_tpu_torch.models.tdnn_transformer import TDNNTransformerEncoder
from pika_tpu_torch.models.transducer import Transducer, TransducerConfig, init_transducer
