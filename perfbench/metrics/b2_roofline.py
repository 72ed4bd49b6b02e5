"""B2's share of its roofline: the least time of the window's f32
scan work (``roofline.py``) over the device time of the ``b2_`` kernels."""

from perfbench.readers import scan_roofline


def read(ctx):
    return scan_roofline(ctx, ("b2_",), "f32")
