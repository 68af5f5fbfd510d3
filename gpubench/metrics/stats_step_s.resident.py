"""``stats_step_s.resident``: seconds of ``DistributedTSDF.
withRangeStats`` a chain on the resident path (its host preparation and
the range kernels), from the span ``gpubench.stats``, which ends with
the card synchronised; the mean over the traced chains."""

from gpubench.lib.trace import mean_span_s


def read(ctx):
    return mean_span_s(ctx, "gpubench.stats")
