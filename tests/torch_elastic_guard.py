"""The reference's elastic legs (``benchmarks.<bench>.run_elastic``) in a
guarded subprocess, for the port's tests that compare against them.

The reference's runtime keeps two revoke races that can park its
``taskwait`` forever after an injected death (ROADMAP section 3; the
port's ``core/tac.py`` fixed them), which would otherwise stop a whole
test session.  So a run that has not ended within ``ELASTIC_TIMEOUT``
seconds is killed and started again in a fresh directory, at most
``ELASTIC_ATTEMPTS`` times.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ELASTIC_TIMEOUT, ELASTIC_ATTEMPTS = 120, 3
_SCRIPT = r"""
import importlib, pickle, sys
import numpy as np
bench = importlib.import_module("benchmarks." + sys.argv[1])
out, kw = sys.argv[2], pickle.loads(bytes.fromhex(sys.argv[3]))
result, info = bench.run_elastic(**kw)
with open(out, "wb") as f:
    pickle.dump((np.asarray(result), info), f)
"""


def reference_run_elastic(bench: str, ckpt_dir: str, **kw):
    """``benchmarks.<bench>.run_elastic(ckpt_dir, **kw)`` in a subprocess:
    (its result as an array, its info)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    for attempt in range(ELASTIC_ATTEMPTS):
        d = f"{ckpt_dir}_{attempt}"
        out = d + ".pkl"
        arg = pickle.dumps(dict(kw, ckpt_dir=d)).hex()
        try:
            proc = subprocess.run(
                [sys.executable, "-c", _SCRIPT, bench, out, arg],
                env=env, cwd=str(ROOT), capture_output=True, text=True,
                timeout=ELASTIC_TIMEOUT)
        except subprocess.TimeoutExpired:
            continue
        assert proc.returncode == 0, proc.stderr
        with open(out, "rb") as f:
            return pickle.load(f)
    raise AssertionError(f"the reference's {bench}.run_elastic did not end "
                         f"within {ELASTIC_TIMEOUT} s in {ELASTIC_ATTEMPTS} "
                         f"runs")
