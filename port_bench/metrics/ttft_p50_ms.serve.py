"""Serving engine: the median time to first token, from when each
request was due to its first token's emission (``TokenRecord.t_emit``)."""

import numpy as np


def read(run):
    t = run.record.get("ttft_s")
    return 1e3 * float(np.percentile(t, 50)) if t else None
