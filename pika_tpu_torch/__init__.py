"""pika_tpu_torch -- the PyTorch + CUDA port of pika_tpu for NVIDIA Hopper.

Module paths mirror ``pika_tpu``.  The port covers the inference path:
waveform -> fbank -> splice/CMVN -> TDNN-Transformer encoder -> LSTM
prediction net -> factorized joint, feeding the forward RNN-T score (through
the hand-written CUDA kernel in ``csrc/joint_channels_fwd.cu``) and greedy
decoding.  The package imports torch and never JAX.
"""

__version__ = "0.1.0"
