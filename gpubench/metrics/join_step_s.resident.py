"""``join_step_s.resident``: seconds of ``DistributedTSDF.asofJoin`` a
chain on the resident path (the right planes gathered into the left's
series order and merged on the card), from the span ``gpubench.join``,
which ends with the card synchronised; the mean over the traced
chains."""

from gpubench.lib.trace import mean_span_s


def read(ctx):
    return mean_span_s(ctx, "gpubench.join")
