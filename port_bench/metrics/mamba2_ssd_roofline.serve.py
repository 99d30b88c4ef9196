"""``mamba2_ssd``'s share of its roofline in prefill: the least time of
its calls at the prompt's shape over the device time of all their
launches (three a call on the ``wgmma`` route) in the trace."""

from port_bench import flops


def read(run):
    if run.summary is None:
        return None
    k = run.kernel("mamba2_ssd")
    calls, _ = run.summary.kernels(k.CALL)
    if calls == 0:
        return None
    _, secs = run.summary.kernels(k.PARTS)
    c, S = run.cell.port, run.record["prompt_len"]
    din = c["ssm_expand"] * c["d_model"]
    H = c.get("ssm_heads") or max(1, din // 64)
    one = k.bound_s(flops.peaks(), 1, S, H, din // H, c["ssm_state"],
                    c["ssm_chunk"])
    return 100.0 * calls * one / secs
