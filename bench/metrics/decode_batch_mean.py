"""Tokens a decode step emits, as a mean over the window's decode calls:
each call emits one token per active slot (server layer)."""


def read(ctx):
    calls = [c for c in ctx.calls if c["kind"] == "decode"]
    if not calls:
        return None
    return sum(c["active"] for c in calls) / len(calls)
