"""The train step's model operations a second (``flops.train_per_token``
× tokens trained in the window ÷ the window) as a share of the card's
bf16 peak.  The window is the traced run's untraced one, timed before
the profiled one, so the profiler's cost on the host is not in it."""

from port_bench import flops


def read(run):
    r, c = run.record, run.cell.port
    if not r.get("tokens"):
        return None
    rate = flops.train_per_token(c, run.cell.params["seq"]) * r["tokens"] \
        / r["window_s"]
    return 100.0 * rate / flops.peaks()["bf16_flops_per_s"]
