"""Device ms a build spanned by ``build.train`` (the balanced k-means of
the coarse centres; its CUDA event pair)."""

from perfbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, spans.BUILD_ROOTS, ("build.train",),
                               "builds")
