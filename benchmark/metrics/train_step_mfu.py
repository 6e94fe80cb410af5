"""The window's training steps as a share of the H100's dense bf16 peak:
``counts.train_step_flops`` operations a step (the model parts' counts
and the joint's), every step of the window over the window's seconds
(host clock)."""

from benchmark import counts


def read(record):
    flops = counts.train_step_flops(record["shapes"], record["config"]["model"])
    return 100.0 * flops * record["units"] / record["window_s"] / counts.PEAK_BF16_FLOPS
