"""memory.krylov_basis_gb: the outer FGMRES's V and Z bases a cycle
allocates, in 1e9 bytes: the program's counter `krylov.basis_bytes` over
the `krylov.init` spans of one more solve of a traced run
(`harness/krylov_trace.py`)."""

from perfbench.harness import krylov_trace


def read(ctx):
    got = krylov_trace.read(ctx)
    return None if got is None else got["basis_gb"]
