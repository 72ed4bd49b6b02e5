"""Host syncs a batch inside the search (its ``sync.*`` spans)."""

from perfbench import spans


def read(ctx):
    return spans.syncs_per(ctx, spans.SEARCH_ROOTS, "batches")
