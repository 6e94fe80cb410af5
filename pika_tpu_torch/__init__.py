"""pika_tpu_torch -- the PyTorch + CUDA port of pika_tpu for NVIDIA Hopper.

Module paths mirror ``pika_tpu``.  The port covers the inference path and
the flagship training step: waveform -> fbank -> splice/CMVN (and, in
training, dither and SpecAugment) -> TDNN-Transformer encoder -> LSTM
prediction net -> factorized joint, feeding the RNN-T loss -- forward through
the hand-written CUDA kernel in ``csrc/joint_channels_fwd.cu``, backward
through those in ``csrc/joint_channels_bwd.cu`` and
``csrc/joint_channels_bwd_w.cu`` -- then SGD-Nesterov with
inf-norm clipping; and greedy decoding.  With ``attn_flash`` the encoder's
attention core runs through the flash-attention kernels of
``csrc/flash_attention.cu``, forward and backward.  The entry points run on
the CUDA card unless the caller names another device (``device="cpu"``).
The package imports torch and never JAX.
"""

__version__ = "0.1.0"
