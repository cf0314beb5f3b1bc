"""The decode step's share of the card's bf16 peak: the operations each
active slot's token needs at its context (``counts.decode_flops``) over
the decode calls' device spans (model step)."""


def read(ctx):
    calls = [c for c in ctx.calls if c["kind"] == "decode"]
    if not calls or any(c["ms"] is None for c in calls):
        return None
    flops = sum(ctx.counts.decode_flops(ctx.model, c["contexts"])
                for c in calls)
    secs = sum(c["ms"] for c in calls) / 1e3
    return 100.0 * flops / secs / ctx.counts.PEAK_FLOPS
