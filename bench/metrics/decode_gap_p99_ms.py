"""The 99th percentile of the gaps between two tokens of one request in
the window (server layer).  Above the knee every slot stays busy, so the
tail of the gaps is the prefills the scheduler puts between decode steps:
which burst of them holds the 99th percentile turns on a step's timing,
and the tail swings from run to run, so it is read here and not bounded."""
import math


def read(ctx):
    v = ctx.window["itl_p99_ms"]
    return v if math.isfinite(v) else None
