"""Windowed loss/throughput logger (the port's own copy of
``pika_tpu/utils/logger.py``; its lines are the JAX CLI's, character for
character): accumulate (frames, losses); emit per-window average loss per
frame and frames/sec; the final summary returns (total_loss, total_frames).
"""

from __future__ import annotations

import sys
import time
from typing import Sequence


class Logger:
    def __init__(self, log_file=None, log_per_n_frames: int = 1024 * 1024,
                 tags: Sequence[str] = ("Loss",), loss_per_frame: Sequence[float] = (1.0,)):
        self.log_file = log_file or sys.stderr
        self.num_frames = 0
        self.total_frames = 0
        self.tags = list(tags)
        self.loss = [0.0] * len(self.tags)
        self.total_loss = [0.0] * len(self.tags)
        self.log_per_n_frames = log_per_n_frames
        if len(loss_per_frame) != len(self.tags):
            loss_per_frame = [1.0] * len(self.tags)
        self.loss_per_frame = list(loss_per_frame)
        self.start_time = time.time()
        self.log_time = time.time()

    def update_and_log(self, num_frames: int, loss: Sequence[float]) -> None:
        self.num_frames += num_frames
        self.total_frames += num_frames
        for i, l in enumerate(loss):
            self.loss[i] += l
            self.total_loss[i] += l
        if self.num_frames >= self.log_per_n_frames:
            elapsed = max(1e-9, time.time() - self.log_time)
            for i, l in enumerate(self.loss):
                self.log_file.write(
                    "{}: {:.3f} \t".format(self.tags[i], l / self.loss_per_frame[i] / float(self.num_frames))
                )
            self.log_file.write("fps: {:.6f} k\n".format(self.num_frames / elapsed / 1000))
            self.log_file.flush()
            self.num_frames = 0
            self.loss = [0.0] * len(self.tags)
            self.log_time = time.time()

    def summarize_and_log(self):
        for i, l in enumerate(self.total_loss):
            self.log_file.write(
                "Finished, Overall Avg {}: {:.3f}\t".format(
                    self.tags[i], l / self.loss_per_frame[i] / max(1.0, float(self.total_frames))
                )
            )
        elapsed = max(1e-9, time.time() - self.start_time)
        self.log_file.write("Avg fps: {:.6f} k\n".format(self.total_frames / elapsed / 1000))
        self.log_file.flush()
        return self.total_loss[0], self.total_frames
