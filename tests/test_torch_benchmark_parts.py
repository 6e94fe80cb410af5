"""The benchmark's model-part tests (``benchmark/tests/test_benchmark_parts.py``)
in the tier-1 run: every configuration of ``BENCHMARK.json`` resolves its
reference parts and has each ``model`` key read, an encoder added as a new
file alone is taken by the harness, the reference's pinned outputs, the
cells' shapes and operation counts.  The cases are imported, not copied.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_benchmark_parts.py -q
"""

from benchmark.tests.test_benchmark_parts import *  # noqa: F401,F403
