"""The PSI kernels' share of their operation bound in prefill calls: the
projections' operations of the true prompt rows, the lm-head on one row a
prompt (``counts.prefill_psi_flops``), at 989 TFLOP/s, over the device
time of the PSI kernels those calls launched (kernels layer)."""


def read(ctx):
    if ctx.trace is None:
        return None
    calls = [c for c in ctx.calls if c["kind"] == "prefill"
             and c.get("psi_s")]
    if not calls:
        return None
    flops = sum(ctx.counts.prefill_psi_flops(ctx.model, c["prompt_lens"])
                for c in calls)
    return (100.0 * flops / ctx.counts.PEAK_FLOPS
            / sum(c["psi_s"] for c in calls))
