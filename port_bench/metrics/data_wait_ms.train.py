"""Data layer (``data.Prefetcher``): the host's wait in ``Prefetcher.get``
a step, by the benchmark's clock around the call, mean over the steps of
the untraced window."""


def read(run):
    waits = run.record.get("data_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
