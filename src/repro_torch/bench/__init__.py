"""The paper's benchmarks on the port (counterparts of ``benchmarks/``)."""
