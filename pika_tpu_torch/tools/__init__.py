"""Throughput entry points of the port, each the counterpart of one of the
repo's JAX tools: ``bench_train`` (``bench.py``), ``bench_decode``
(``tools/bench_decode.py``) and ``bench_cli_train``
(``tools/bench_cli_train.py``); and the A/B timers of kernel builds,
``flash_attention_ab`` (K4) and ``joint_bwd_ab`` (K2 and K3).  Run each
with ``python -m pika_tpu_torch.tools.<name>``; they run on the CUDA
card."""
