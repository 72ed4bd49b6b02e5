"""Device ms of B1's kernels (``b1_``) per index build."""

from perfbench.readers import kernel_ms_per


def read(ctx):
    return kernel_ms_per(ctx, ("b1_",), "builds")
