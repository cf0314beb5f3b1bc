"""The prefill's share of the card's bf16 peak: the operations the true
prompts need, the lm-head on one row a prompt (``counts.prefill_flops``),
over the prefill calls' device spans (model step)."""


def read(ctx):
    calls = [c for c in ctx.calls if c["kind"] == "prefill"]
    if not calls or any(c["ms"] is None for c in calls):
        return None
    flops = sum(ctx.counts.prefill_flops(ctx.model, c["prompt_lens"])
                for c in calls)
    secs = sum(c["ms"] for c in calls) / 1e3
    return 100.0 * flops / secs / ctx.counts.PEAK_FLOPS
