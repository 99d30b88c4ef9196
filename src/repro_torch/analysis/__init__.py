"""Cost models over the port's eager steps (the port of ``repro/analysis``)."""
