"""``kernel_roofline.resident``: the least card time of the traced chains on
the resident path (bytes-minimal at the published H100 peak,
``lib/roofline.py``) over the time of every kernel the card ran in the
traced window, in percent."""

from gpubench.lib.trace import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx)
