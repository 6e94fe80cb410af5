"""Throughput entry points of the port, each the counterpart of one of the
repo's JAX tools: ``bench_train`` (``bench.py``), ``bench_decode``
(``tools/bench_decode.py``) and ``bench_cli_train``
(``tools/bench_cli_train.py``).  Run each with ``python -m
pika_tpu_torch.tools.<name>``; they run on the CUDA card."""
