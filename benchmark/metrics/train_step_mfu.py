"""The window's training steps as a share of the H100's dense bf16 peak:
``counts.flop_model`` operations a step, every step of the window over the
window's seconds (host clock)."""

from benchmark import counts


def read(record):
    s = record["shapes"]
    flops = counts.flop_model(s["frames"], s["batch"], s["u1"] - 1, s["vocab"], s["nhid"])
    return 100.0 * flops * record["units"] / record["window_s"] / counts.PEAK_BF16_FLOPS
