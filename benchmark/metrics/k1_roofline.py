"""K1 (the joint's forward, ``csrc/joint_fwd.cu``) against its roofline:
the least time of its operations and bytes at this shape over its device
time a step in the traced stretch.  Its kernels: ``lse_kernel`` and
``combine_kernel``, and each ``h_kernel`` (``csrc/joint_gemm.cuh``, shared
with the backward) that the next of them follows."""

from benchmark import counts

OWN = ("lse_kernel", "combine_kernel")
JOINT = OWN + ("dz_kernel", "dw_kernel", "dh_kernel")
SHARED = ("h_kernel",)


def read(record):
    tr = record["trace"]
    if tr is None or not tr.found(OWN):
        return None
    s = record["shapes"]
    least = counts.least_seconds(*counts.k1_counts(s["batch"], s["t_enc"], s["u1"], s["hid"],
                                                   s["vocab"]))
    return 100.0 * least / (tr.kernel_seconds(OWN, JOINT, SHARED) / tr.units)
