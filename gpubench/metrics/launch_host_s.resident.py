"""``launch_host_s.resident``: seconds a chain on the resident path the
host spent inside the kernel launch wrappers' spans
(``tempo.kernel.<kernel>``, ``ops/cuda_lib.py``: the ctypes call and
its error check), on the chain's thread in the traced window, over the
chains.  None where no such span was opened."""

from gpubench.lib.program_spans import launch_host_s


def read(ctx):
    return launch_host_s(ctx)
