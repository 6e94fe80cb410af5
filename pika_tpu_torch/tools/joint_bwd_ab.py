"""A/B timing of builds of the joint's backward (K2 and K3) on one card, and
a profile of the joint kernels.

    python -m pika_tpu_torch.tools.joint_bwd_ab [A.cu B.cu ...]

Each argument is a copy of ``csrc/joint_bwd.cu`` with one change; a header
(``*.cuh``) beside it is used, else the package's is copied there.  Each is
built with nvcc, all at once, into a library beside it.  Then the fused
backward (K2 and K3 from one z) is timed with CUDA events on each build's
kernels, in the order given (list parent, change, change, parent), at the
flagship training shape (B = 32, T' = 239, U+1 = 41, H = 1024, V = 6268),
and its six gradients are held against the package's build (relative L2).
Last, one call each of the package's K1 and fused backward under
torch.profiler gives each of their kernels' device time (h, lse and
combine; h, dz, dW2 and dh).  Keep the variants in a git-ignored directory.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from pika_tpu_torch.ops import cuda_build, rnnt_kernels
from pika_tpu_torch.tools.flash_attention_ab import build, time_ms

SHAPE = (32, 239, 41, 1024, 6268)  # B, T', U+1, H, V of bench.py's step
BOTH = rnnt_kernels.PART_K2 | rnnt_kernels.PART_K3


def declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pika_joint_channels_bwd.argtypes = [i, p] + [p] * 20 + [i] * 7


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


def profile(what: str, fn) -> None:
    """Each device kernel of one call of ``fn``, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for e in sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total):
        print(f"  package {what}: {e.self_device_time_total / 1e3:8.3f} ms {e.count:4d}x  "
              f"{e.key[:80]}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    args = inputs(device)
    fused = lambda: rnnt_kernels._bwd_cuda("fused", *args, parts=BOTH)  # noqa: E731
    if argv:
        sources = [Path(a).resolve() for a in argv]
        libs = build(sources, declare)
        ref = fused()
        package = cuda_build.library
        flops = 6.0 * torch.tensor(SHAPE, dtype=torch.float64).prod().item()
        try:
            for src in sources:
                cuda_build.library = lambda lib=libs[src]: lib
                ms = time_ms(fused, 2, 10)
                rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(fused(), ref))
                print(f"{src.parent.name + '/' + src.stem:>36}: {ms:.3f} ms "
                      f"({flops / ms / 1e9:.0f} TFLOP/s); rel L2 vs package {rel:.1e}")
        finally:
            cuda_build.library = package
    profile("K1", lambda: rnnt_kernels.joint_channels(*args[:7]))
    profile("K2 + K3", fused)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
