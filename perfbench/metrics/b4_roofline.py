"""B4's share of its roofline: the least time of the window's bf16
scan work (``roofline.py``) over the device time of the ``b4_`` kernels."""

from perfbench.readers import scan_roofline


def read(ctx):
    return scan_roofline(ctx, ("b4_",), "bf16")
