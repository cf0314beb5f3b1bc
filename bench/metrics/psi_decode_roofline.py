"""The PSI kernels' share of their byte bound in decode calls: each traced
decode step reads every PSI weight once (codes and scales,
``counts.decode_weight_bytes``) at 3.35 TB/s, over the device time of the
PSI kernels those calls launched (kernels layer)."""


def read(ctx):
    if ctx.trace is None:
        return None
    calls = [c for c in ctx.calls if c["kind"] == "decode"
             and c.get("psi_s")]
    if not calls:
        return None
    q = ctx.quant
    need = (len(calls) * ctx.counts.decode_weight_bytes(
        ctx.model, q["bits"], q["pack"]) / ctx.counts.PEAK_BYTES)
    return 100.0 * need / sum(c["psi_s"] for c in calls)
