"""True prompt tokens over the rows the window's prefill calls forwarded
(batch x padded bucket): what burst padding wastes (server layer)."""


def read(ctx):
    calls = [c for c in ctx.calls if c["kind"] == "prefill"]
    rows = sum(c["rows"] for c in calls)
    if not rows:
        return None
    return 100.0 * sum(sum(c["prompt_lens"]) for c in calls) / rows
