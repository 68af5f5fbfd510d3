"""``mesh_host_s.resident``: seconds a chain on the resident path spent
in the mesh frame's own spans (``tempo.dist.*``, ``dist.py``) less the
kernel launch spans inside them (``tempo.kernel.*``): the union of
those intervals on the chain's thread in the traced window, over the
chains.  None where the program opens no such span."""

from gpubench.lib.program_spans import mesh_host_s


def read(ctx):
    return mesh_host_s(ctx)
