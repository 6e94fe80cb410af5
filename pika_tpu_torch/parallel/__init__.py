"""Distributed training on ``torch.distributed``: process groups and the
rows of the global batch, synchronous data parallelism, and BMUF's block
strategies (port of ``pika_tpu/parallel``)."""

from pika_tpu_torch.parallel.bmuf import (
    BMUF,
    BMUFConfig,
    BMUFState,
    block_update,
    bmuf_init,
    bmufadam_update,
)
from pika_tpu_torch.parallel.dp import SumGradients, global_batch_norm
from pika_tpu_torch.parallel.mesh import (
    all_sum,
    barrier,
    local_rows,
    process_group,
    rank,
    replicate,
    world_size,
)
