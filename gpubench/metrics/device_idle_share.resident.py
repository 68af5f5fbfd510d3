"""``device_idle_share.resident``: the share of the traced window on the
resident path in which no kernel, copy or memset ran on the card, in percent
(one minus the union of their intervals over the window)."""

from gpubench.lib.trace import idle_share_pct


def read(ctx):
    return idle_share_pct(ctx)
