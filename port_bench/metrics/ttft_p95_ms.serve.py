"""Serving engine: the 95th percentile of the time to first token, from
when each request was due to its first token's emission
(``TokenRecord.t_emit``).  Above capacity the queue grows through the
window, so this tail is the queue's, and is a per-layer metric."""

import numpy as np


def read(run):
    t = run.record.get("ttft_s")
    return 1e3 * float(np.percentile(t, 95)) if t else None
