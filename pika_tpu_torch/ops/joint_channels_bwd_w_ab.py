"""A/B timing of builds of K3 (the joint weight gradient) on one card.

    python -m pika_tpu_torch.ops.joint_channels_bwd_w_ab A.cu B.cu [...]

Each argument is a copy of ``csrc/joint_channels_bwd_w.cu`` with one
change; a ``hopper.cuh`` beside it is used, else the package's is copied
there.  Each is built with nvcc, all at once, into a library beside it.
Then K3's wrapper is timed with CUDA events on each build's kernels, in
the order given (list parent, change, change, parent), at the flagship
training shape (B = 32, T' = 239, U+1 = 41, H = 1024, V = 6268), and its
d_w2 and d_b2 are held against the package's build (relative L2).  Last,
one call of the package's K3 under torch.profiler gives each of its
kernels' device time.  Keep the variants in a git-ignored directory.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from pika_tpu_torch.ops import cuda_build, rnnt_kernels
from pika_tpu_torch.ops.flash_attention_ab import build, time_ms

SHAPE = (32, 239, 41, 1024, 6268)  # B, T', U+1, H, V of bench.py's step


def declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pika_joint_channels_bwd_w.argtypes = [i, p] + [p] * 15 + [i] * 6


def inputs(device) -> tuple:
    """Random factors (W2 scaled as the model initializes it), K1's lse and
    random channel cotangents."""
    b, t, u1, h, v = SHAPE
    g = torch.Generator(device).manual_seed(0)

    def randn(*shape, scale):
        return torch.randn(*shape, generator=g, device=device) * scale

    args = (randn(b, t, h, scale=0.5), randn(b, t, h, scale=0.5), randn(b, u1, h, scale=0.5),
            randn(b, u1, h, scale=0.5), randn(h, v, scale=2.0 / h ** 0.5), randn(v, scale=0.1),
            torch.randint(0, v, (b, u1), generator=g, device=device, dtype=torch.int32))
    lse = rnnt_kernels.joint_channels(*args)[0]
    return args + (lse,) + tuple(randn(b, t, u1, scale=0.01) for _ in range(3))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 1
    sources = [Path(a).resolve() for a in argv]
    libs = build(sources, declare)
    device = torch.device("cuda", 0)
    args = inputs(device)
    chunk = rnnt_kernels.k3_chunk_rows(SHAPE[-1])
    ref = rnnt_kernels._bwd_w_cuda(*args, chunk_rows=chunk)
    package = cuda_build.library
    flops = 4.0 * torch.tensor(SHAPE, dtype=torch.float64).prod().item()
    try:
        for src in sources:
            cuda_build.library = lambda lib=libs[src]: lib
            ms = time_ms(lambda: rnnt_kernels._bwd_w_cuda(*args, chunk_rows=chunk), 2, 10)
            got = rnnt_kernels._bwd_w_cuda(*args, chunk_rows=chunk)
            rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(got, ref))
            print(f"{src.parent.name + '/' + src.stem:>36}: {ms:.3f} ms "
                  f"({flops / ms / 1e9:.0f} TFLOP/s); rel L2 vs package {rel:.1e}")
    finally:
        cuda_build.library = package
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rnnt_kernels._bwd_w_cuda(*args, chunk_rows=chunk)
        torch.cuda.synchronize()
    for e in sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total):
        print(f"  package K3: {e.self_device_time_total / 1e3:8.3f} ms {e.count:4d}x  {e.key[:80]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
