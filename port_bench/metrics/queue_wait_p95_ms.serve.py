"""Engine admission: the 95th percentile of a request's wait from when it
was due to its prefill's hand-over to the task runtime (step 0's
``TokenRecord.t_submit``)."""

import numpy as np


def read(run):
    q = run.record.get("queue_s")
    return 1e3 * float(np.percentile(q, 95)) if q else None
