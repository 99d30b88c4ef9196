"""Run one cell of the benchmark of the PyTorch/CUDA port on the card.

    python3 port_bench/run.py --workload granite-3-2b.train-4k \\
        --seed 1234 --seconds 30 --trace 0

Prints the result as one JSON line, the last of standard output; with
``--trace 1`` the cell's per-layer metrics from a run under
``torch.profiler`` instead of its end-to-end metrics.  Exits non-zero
with no result where there is no card, where the program is not in the
checkout, or where JAX or the JAX package got loaded.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    # Caches of compilers the program may use, at fixed paths inside the
    # checkout (the CUDA kernels build into src/repro_torch/kernels/_build).
    cache = ROOT / "port_bench" / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from port_bench import harness
    sys.exit(harness.main())
