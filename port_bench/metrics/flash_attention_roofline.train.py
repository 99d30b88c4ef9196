"""``flash_attention``'s share of its roofline in the train step: the
least time its launches at the training shape could take (``kernels/
flash_attention.py``, with the log-sum-exp the training forward writes)
over their device time in the trace."""

from port_bench import flops


def read(run):
    if run.summary is None:
        return None
    fa = run.kernel("flash_attention")
    n, secs = run.summary.kernels(fa.LAUNCH)
    if n == 0:
        return None
    _, secs = run.summary.kernels(fa.PARTS)
    c, p = run.cell.port, run.cell.params
    dh = c.get("d_head") or c["d_model"] // c["n_heads"]
    one = fa.bound_s(flops.peaks(), p["batch"], p["seq"], p["seq"],
                     c["n_heads"], c["n_kv_heads"], dh, lse=True)
    return 100.0 * n * one / secs
