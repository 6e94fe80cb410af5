"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``*.cu`` file under ``pika_tpu_torch/csrc`` is compiled for Hopper
(``sm_90a``), one nvcc process per file, all in parallel, and linked into one
shared library with a plain C interface.  The library
lands in ``pika_tpu_torch/_build/<hash>/``, keyed on a hash of the sources,
the headers they include (``*.cuh``) and the compiler flags, so an unchanged
tree builds once.  The build happens at
first use, never at import, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libpika_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources(csrc: Path = CSRC_DIR) -> list[Path]:
    srcs = sorted(csrc.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    return srcs


def source_digest(csrc: Path = CSRC_DIR, flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    """The build's key: a hash of the compiler flags and of every ``*.cu``
    source and ``*.cuh`` header under ``csrc`` (names and contents)."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        digest.update(path.name.encode() + b"\0")
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    its path.  ``build.log`` beside it keeps nvcc's output (ptxas register
    and shared-memory counts)."""
    srcs = _sources()
    out_dir = BUILD_DIR / source_digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # one nvcc per source, all at once, then one link
    objs = [out_dir / f"{src.stem}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *map(str, objs)]
    if all(proc.returncode == 0 for proc in procs):
        link_proc = subprocess.run(link, capture_output=True, text=True)
        cmds.append(link)
        outs.append(link_proc.stdout + link_proc.stderr)
        procs.append(link_proc)
    (out_dir / "build.log").write_text(
        "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs)))
    failed = [(cmd, out) for cmd, out, proc in zip(cmds, outs, procs) if proc.returncode != 0]
    if failed:
        os.unlink(tmp)
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pika_joint_channels_fwd.argtypes = [i, p] + [p] * 12 + [i] * 6
    lib.pika_joint_channels_fwd.restype = i
    lib.pika_joint_channels_bwd.argtypes = [i, p] + [p] * 20 + [i] * 7
    lib.pika_joint_channels_bwd.restype = i
    lib.pika_flash_attention_fwd.argtypes = [i, p] + [p] * 5 + [i] * 3
    lib.pika_flash_attention_fwd.restype = i
    lib.pika_flash_attention_bwd_dkv.argtypes = [i, p] + [p] * 8 + [i] * 3
    lib.pika_flash_attention_bwd_dkv.restype = i
    lib.pika_flash_attention_bwd_dq.argtypes = [i, p] + [p] * 7 + [i] * 3
    lib.pika_flash_attention_bwd_dq.restype = i
    lib.pika_rnnt_dp_forward.argtypes = [i, p] + [p] * 6 + [i] * 3
    lib.pika_rnnt_dp_forward.restype = i
    lib.pika_rnnt_dp_backward.argtypes = [i, p] + [p] * 10 + [i] * 3
    lib.pika_rnnt_dp_backward.restype = i
    lib.pika_beam_select.argtypes = [i, p, p, p, ctypes.c_float]
    lib.pika_beam_select.restype = i
    for name in ("pika_beam_update", "pika_beam_commit"):
        getattr(lib, name).argtypes = [i, p, p, p]
        getattr(lib, name).restype = i
    lib.pika_cuda_error_string.argtypes = [i]
    lib.pika_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().pika_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
