"""``host_waits.resident``: blocking host waits a chain on the resident
path made inside the program: ``cuda_runtime`` records on the chain's
thread in the traced window named ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` or ``cudaMemcpy``
while a ``tempo.*`` span was open, over the chains.  The harness's own
synchronise at each step's end lies under ``gpubench.*`` spans alone and
is left out.  None without runtime records (on the CPU) or without
program spans.

On an NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128) the traced chains show
these names: ``cudaStreamSynchronize``, 9 a chain, each right after the
``cudaMemcpyAsync`` of a pageable upload in ``tempo.dist.asof_join.
align`` (an index, a mask or a scalar fill a gather), and the harness's
``cudaDeviceSynchronize``, 4 a chain, under ``gpubench.*`` only.  No
``cudaEventSynchronize`` or ``cudaMemcpy`` occurs on this path; they are
counted where a later path makes them."""

from gpubench.lib.program_spans import host_waits


def read(ctx):
    return host_waits(ctx)
