"""Device span of the window's prefill calls (CUDA events around
``Executor.prefill``) per 1000 true prompt tokens (executor layer)."""


def read(ctx):
    calls = [c for c in ctx.calls if c["kind"] == "prefill"]
    toks = sum(sum(c["prompt_lens"]) for c in calls)
    if not toks or any(c["ms"] is None for c in calls):
        return None
    return sum(c["ms"] for c in calls) / (toks / 1000.0)
