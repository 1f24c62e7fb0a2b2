"""krylov.orthog_roofline: the outer FGMRES's projections of one more
solve of a traced run against the HBM rate: 100 x (the bytes of each
projection off s + 1 rows, (4 (s + 1) + 16) vectors of 5 n^2 values:
four reads of the basis rows and 16 passes over w and its temporaries,
summed over the steps, at 3.35 TB/s) / the summed device time of their
event pairs, in % (`harness/krylov_trace.py` counts the bytes). Read
where a vector is larger than the card's L2."""

from perfbench.harness import krylov_trace


def read(ctx):
    got = krylov_trace.read(ctx)
    return None if got is None else got["orthog_roofline"]
