"""Host ms a batch inside the search's root span (``ivf_flat.search`` /
``ivf_pq.search``), from the port's spans."""

from perfbench import spans


def read(ctx):
    return spans.host_ms_per(ctx, spans.SEARCH_ROOTS, "batches")
