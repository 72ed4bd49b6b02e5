"""Host syncs a build inside its root span (its ``sync.*`` spans)."""

from perfbench import spans


def read(ctx):
    return spans.syncs_per(ctx, spans.BUILD_ROOTS, "builds")
