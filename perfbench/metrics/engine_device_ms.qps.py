"""Device ms a batch spanned by the search's stages other than
``search.scan`` (the probe, the cell inversion, the routing, the final
selection; their CUDA event pairs): the port's own view of
``engine_share.qps``."""

from perfbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, spans.SEARCH_ROOTS, (spans.SCAN,),
                               "batches", exclude=True)
