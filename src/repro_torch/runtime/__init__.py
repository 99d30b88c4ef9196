"""repro_torch.runtime — the train step builders (``steps``) and the
sharding policy they take (``sharding``)."""
