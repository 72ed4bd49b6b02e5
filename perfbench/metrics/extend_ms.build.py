"""Device ms a build spanned by ``build.extend`` (the rows' assignment
and the packing of the lists; its CUDA event pair)."""

from perfbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, spans.BUILD_ROOTS, ("build.extend",),
                               "builds")
