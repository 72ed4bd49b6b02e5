"""Percent of the traced window in which the device idles while the host
is inside a search's root span: each idle gap of the device trace is put
down to the innermost span of the port over its midpoint. The rest of
``idle_share.qps`` is the harness's own."""

from perfbench import spans


def read(ctx):
    return spans.idle_share_in(ctx, spans.SEARCH_ROOTS)
