"""Device span of a decode call (CUDA events around ``Executor.decode``),
as a mean over the window's calls (executor layer)."""


def read(ctx):
    ms = [c["ms"] for c in ctx.calls if c["kind"] == "decode"]
    if not ms or None in ms:
        return None
    return sum(ms) / len(ms)
