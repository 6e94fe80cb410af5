"""A/B timing of builds of K4's kernels on one card.

    python -m pika_tpu_torch.ops.flash_attention_ab A.cu B.cu [...]

Each argument is a copy of ``csrc/flash_attention.cu`` with one change; a
``hopper.cuh`` beside it is used, else the package's is copied there.  Each
is built with nvcc, all at once, into a library beside it (same plain C
interface as the package's).  Then the forward, dk/dv and dq kernels of
each build are timed with CUDA events on the flagship encoder's three
attention layers at the training shape (B = 32; heads, T, d = 16/992/64,
16/974/64, 8/239/128), builds in the order given -- list parent, change,
change, parent -- and each build's outputs are held against the package's
own build (relative L2; 0 when the change keeps the arithmetic).  Keep the
variants in a git-ignored directory.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from pika_tpu_torch.ops import cuda_build
from pika_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_di,
    flash_attention_fwd,
)

LAYERS = ((16, 992, 64), (16, 974, 64), (8, 239, 128))  # (heads, T, d) at 10 s
BATCH = 32


def declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pika_flash_attention_fwd.argtypes = [i, p] + [p] * 5 + [i] * 3
    lib.pika_flash_attention_bwd_dkv.argtypes = [i, p] + [p] * 8 + [i] * 3
    lib.pika_flash_attention_bwd_dq.argtypes = [i, p] + [p] * 7 + [i] * 3


def build(sources: list[Path], declare=declare) -> dict[Path, ctypes.CDLL]:
    """Each source compiled into a library beside it, all at once; the
    libraries, their entry points declared by ``declare``."""
    procs = {}
    for src in dict.fromkeys(sources):
        if not (src.parent / "hopper.cuh").exists():
            shutil.copy(cuda_build.CSRC_DIR / "hopper.cuh", src.parent)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
               str(src.with_suffix(".so")), str(src)]
        procs[src] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for src, proc in procs.items():
        log = proc.communicate()[0]
        notes = [line for line in log.splitlines() if "C75" in line or "bytes spill" in line]
        print(f"{src.name}: nvcc rc {proc.returncode}; " + " | ".join(n[:90] for n in notes))
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(src.with_suffix(".so")))
        declare(lib)
        libs[src] = lib
    return libs


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 1
    sources = [Path(a).resolve() for a in argv]
    libs = build(sources)
    device = torch.device("cuda", 0)
    total = [[0.0, 0.0, 0.0] for _ in sources]
    for h, t, d in LAYERS:
        g = torch.Generator(device).manual_seed(5)
        q, k, v, do = ((torch.randn((BATCH, h, t, d), generator=g, device=device) * scale)
                       .to(torch.bfloat16) for scale in (2.0 / d ** 0.5, 1.0, 1.0, 1.0))
        o, lse = flash_attention_fwd(q, k, v)
        di = flash_attention_di(o, do)
        ref = (*flash_attention_bwd_dkv(q, k, v, o, lse, do, di=di),
               flash_attention_bwd_dq(q, k, v, o, lse, do, di=di), o, lse)
        stream, flops = torch.cuda.current_stream().cuda_stream, BATCH * h * t * t * d
        for n, src in enumerate(sources):
            lib, got = libs[src], tuple(torch.empty_like(x) for x in ref)
            args = (BATCH * h, t, d)

            def fwd():
                rc = lib.pika_flash_attention_fwd(
                    device.index, stream, *(x.data_ptr() for x in (q, k, v, got[3], got[4])),
                    *args)
                assert rc == 0, rc

            def dkv():
                rc = lib.pika_flash_attention_bwd_dkv(
                    device.index, stream,
                    *(x.data_ptr() for x in (q, k, v, do, lse, di, got[0], got[1])), *args)
                assert rc == 0, rc

            def dq():
                rc = lib.pika_flash_attention_bwd_dq(
                    device.index, stream,
                    *(x.data_ptr() for x in (q, k, v, do, lse, di, got[2])), *args)
                assert rc == 0, rc

            ms = (time_ms(dkv), time_ms(dq), time_ms(fwd))
            rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                      for a, b in zip(got, ref))
            name = f"{src.parent.name}/{src.stem}"
            print(f"{name:>24} h={h} T={t} d={d}: fwd {ms[2]:.3f} ms "
                  f"({4 * flops / ms[2] / 1e9:.0f} TFLOP/s), dk/dv {ms[0]:.3f} ms "
                  f"({8 * flops / ms[0] / 1e9:.0f} TFLOP/s), dq {ms[1]:.3f} ms "
                  f"({6 * flops / ms[1] / 1e9:.0f} TFLOP/s); rel L2 vs package {rel:.1e}")
            for j in range(3):
                total[n][j] += ms[j]
    for src, (a, b, f) in zip(sources, total):
        print(f"{src.parent.name + '/' + src.stem:>24} three layers: fwd {f:.3f}; "
              f"dk/dv {a:.3f} + dq {b:.3f} = {a + b:.3f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
