"""``mesh_idle_s.resident``: seconds a chain on the resident path the card
sat idle for the mesh frame's host work: the card's idle gaps in the
traced window (no kernel, copy or memset record) whose midpoint has a
``tempo.dist.*`` span as the innermost open ``tempo.*`` span (torch's
``cpu_op`` records do not count for that choice), over the chains.
None without device records or without mesh-frame spans."""

from gpubench.lib.program_spans import mesh_idle_s


def read(ctx):
    return mesh_idle_s(ctx)
