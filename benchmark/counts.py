"""The yardstick's arithmetic: the H100's peaks, the training step's
operation count and the joint kernels' operations and bytes, all from
shapes alone.

``train_step_flops`` counts the matmul terms of one training step,
forward times three, as ``bench.py:flop_model`` did: the encoder's and
the prediction net's forward products, each counted by its model part
(``flops`` in ``reference/encoders/``, ``reference/decoders/``), and the
joint's vocab projection, counted here.  It leaves out the FFT, the norms,
the softmax and the elementwise work, so it undercounts a little and a
share of the peak read from it is a lower bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

SAMPLE_RATE = 16000
FRAME_LENGTH = 400   # 25 ms at 16 kHz
FRAME_SHIFT = 160    # 10 ms


def kaldi_frames(samples: int) -> int:
    """Frames of a waveform under Kaldi's snip-edges framing."""
    return max(0, 1 + (samples - FRAME_LENGTH) // FRAME_SHIFT)


def encoder_frames(frames: int, layers: int = 9, kernel: int = 3) -> int:
    """Output frames of the TDNN stack: VALID convolutions of dilations
    1, 1, 1, 3, ..., 3 and stride 4 on the last."""
    dil = [1] * 3 + [3] * (layers - 4) + [3]
    stride = [1] * (layers - 1) + [4]
    for d, s in zip(dil, stride):
        frames = (frames - ((kernel - 1) * d + 1)) // s + 1
    return frames


def train_step_flops(shapes: dict, model: dict) -> float:
    """Training FLOPs of one step of any configuration: the forward
    operations of one utterance through the encoder part and the
    prediction-net part (their ``flops``) and through the joint's vocab
    projection over the encoder's output frames, times three for forward
    and backward, times the batch."""
    from benchmark.reference import model as M

    fwd = M.part("encoders", model["encoder_type"]).flops(shapes, model)
    fwd += M.part("decoders", model["decoder_type"]).flops(shapes, model)
    fwd += joint_product_flops(1, shapes["t_enc"], shapes["u1"], shapes["hid"], shapes["vocab"])
    return 3.0 * fwd * shapes["batch"]


def joint_product_flops(batch: int, t: int, u1: int, hid: int, vocab: int) -> float:
    """Operations of one (B, T', U+1, H) x (H, V) product of the joint."""
    return 2.0 * batch * t * u1 * hid * vocab


def k1_counts(batch: int, t: int, u1: int, hid: int, vocab: int) -> tuple[float, float]:
    """K1 (the joint's forward: h from the four factors, z = h W2 + b2, the
    log-sum-exp over V and the label's logit at every (t, u)): operations
    and bytes.  Bytes: the factors ax, gx (B, T', H) and ay, gy (B, U+1, H)
    and b2 in float32, W2 in bf16, the labels, read once; lse and the
    label's logit (B, T', U+1) in float32 written once."""
    ops = joint_product_flops(batch, t, u1, hid, vocab)
    nbytes = (4 * (2 * batch * t * hid + 2 * batch * u1 * hid + vocab) + 2 * hid * vocab
              + 4 * batch * u1 + 2 * 4 * batch * t * u1)
    return ops, nbytes


def k23_counts(batch: int, t: int, u1: int, hid: int, vocab: int) -> tuple[float, float]:
    """K2 + K3 fused (the joint's backward): z again, dh = dz W2^T and
    dW2 = h^T dz, three products.  Bytes: K1's inputs, lse and the two
    lattice gradients (B, T', U+1) read once; the four factor gradients, dW2
    and db2 in float32 written once."""
    ops = 3 * joint_product_flops(batch, t, u1, hid, vocab)
    nbytes = (4 * (2 * batch * t * hid + 2 * batch * u1 * hid + vocab) + 2 * hid * vocab
              + 4 * batch * u1 + 3 * 4 * batch * t * u1
              + 4 * (2 * batch * t * hid + 2 * batch * u1 * hid + hid * vocab + vocab))
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS,
                  peak_bytes: float = PEAK_HBM_BYTES) -> float:
    """The roofline's least time: the larger of operations at the peak rate
    and bytes at the memory's bandwidth."""
    return max(ops / peak_flops, nbytes / peak_bytes)
