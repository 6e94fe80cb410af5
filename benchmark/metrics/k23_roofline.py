"""K2 + K3 (the joint's fused backward, ``csrc/joint_bwd.cu``) against its
roofline: the least time of its three products and its bytes at this
shape over its device time a step in the traced stretch.  Its kernels:
``dz_kernel``, ``dw_kernel`` and ``dh_kernel``, and each ``h_kernel``
that the next of them follows."""

from benchmark import counts

OWN = ("dz_kernel", "dw_kernel", "dh_kernel")
JOINT = OWN + ("lse_kernel", "combine_kernel")
SHARED = ("h_kernel",)


def read(record):
    tr = record["trace"]
    if tr is None or not tr.found(OWN):
        return None
    s = record["shapes"]
    least = counts.least_seconds(*counts.k23_counts(s["batch"], s["t_enc"], s["u1"], s["hid"],
                                                    s["vocab"]))
    return 100.0 * least / (tr.kernel_seconds(OWN, JOINT, SHARED) / tr.units)
