"""Hand-written Hopper kernels of the port, each beside its plain-PyTorch
version (:mod:`.ref`); :mod:`.ops` is the public dispatch."""
