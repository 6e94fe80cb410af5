"""Dtype helpers shared by the decode paths."""

from pika_tpu_torch.utils.dtypes import resolve_mm_dtype
