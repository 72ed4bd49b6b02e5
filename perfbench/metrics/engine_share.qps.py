"""Percent of the traced window taken by kernels other than the port's
hand-written ones: the probe, the cell inversion, the LUT and the merges
in plain torch."""

from perfbench.readers import engine_share


def read(ctx):
    return engine_share(ctx)
