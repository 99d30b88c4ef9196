"""``flash_attention``'s share of its roofline in prefill: the least time
its launches at the prompt's shape (batch 1, no log-sum-exp) could take,
over their device time in the trace."""

from port_bench import flops


def read(run):
    if run.summary is None:
        return None
    fa = run.kernel("flash_attention")
    n, _ = run.summary.kernels(fa.LAUNCH)
    if n == 0:
        return None
    _, secs = run.summary.kernels(fa.PARTS)
    c, S = run.cell.port, run.record["prompt_len"]
    dh = c.get("d_head") or c["d_model"] // c["n_heads"]
    one = fa.bound_s(flops.peaks(), 1, S, S, c["n_heads"], c["n_kv_heads"],
                     dh)
    return 100.0 * n * one / secs
