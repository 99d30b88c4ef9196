"""Plain references of the benchmark: plain PyTorch in fp32, importing
nothing of the program under test."""
