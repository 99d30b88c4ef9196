"""Builder and loader of the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, which is loaded with
``ctypes``.  The build runs at first use, into ``_build/`` beside this file
(listed in ``.gitignore``), under a directory keyed by a hash of the source,
the shared headers ``csrc/*.cuh`` and the flags, so a changed source or
header is rebuilt and an unchanged one is loaded as it is.  Only the
sources in the package are compiled.

Nothing here runs at import: the CPU tests import every module on a host
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
# One entry per kernel library: name -> C functions and their signatures
# (argtypes, restype).  Pointers and the stream are c_void_p, sizes c_int,
# element counts c_longlong.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "gs_stencil": {
        # (H, W, dtype, route)
        "gs_stencil_num_partials": ((_I,) * 4, _I),
        "gs_stencil_num_slots": ((), _I),
        "gs_stencil_pool_words": ((), _I),
        # (block, top, left, bottom, right, out, edges, res, H, W, dtype,
        #  route, ticket slot, offset of the partial words, stream)
        "gs_stencil_fwd": ((_P,) * 8 + (_I,) * 6 + (_P,), _I),
    },
    "collective_stages": {
        # (acc, got, scale or NULL, out, n, acc dtype, got dtype,
        #  accumulate, stream)
        "fused_combine": ((_P, _P, _P, _P, _L, _I, _I, _I, _P), _I),
        # (x, scale, q, n, x dtype, stream)
        "quantize_wire": ((_P, _P, _P, _L, _I, _P), _I),
        # (q, scale, out, n, out dtype, stream)
        "dequantize_wire": ((_P, _P, _P, _L, _I, _P), _I),
    },
    "flash_attention": {
        # (q, k, v, out, lse or null, B, S, T, H, Hkv, D, causal, window or
        #  -1, dtype, stream)
        "flash_attention_fwd": ((_P,) * 5 + (_I,) * 9 + (_P,), _I),
    },
    "mamba2_ssd": {
        # (x, dt, A, B, C, init or NULL, y, final state, b, s, h, p, n,
        #  chunk, dtype, route, chunk states, cums, carried states (the
        #  last three NULL on the fma route), stream)
        "mamba2_ssd_fwd": ((_P,) * 8 + (_I,) * 8 + (_P,) * 4, _I),
    },
    "mlstm_chunk": {
        # (q, k, v, i gate, f gate, y, C, n, m, b, s, h, d, chunk, dtype,
        #  route, fp32 scratch, carried states (the last two NULL on the
        #  fma route), stream)
        "mlstm_chunk_fwd": ((_P,) * 9 + (_I,) * 7 + (_P,) * 3, _I),
    },
    "moe_gmm": {
        # (x, w, out, E, C, K, N, route, stream)
        "moe_gmm_fwd": ((_P,) * 3 + (_I,) * 5 + (_P,), _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _target(name: str) -> Path:
    """The library's path, keyed by its source, every shared header of
    ``csrc/`` (any source may include one) and the flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + b"\0" + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / key.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str, target: Path) -> subprocess.Popen:
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, target: Path, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)       # atomic: a reader never sees half a file
    return out


def build(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together.  Returns each compiled
    library's ``nvcc`` output (``-Xptxas -v``: registers, shared memory,
    spills); already built libraries are absent from it."""
    with _lock:
        targets = {n: _target(n) for n in names}
        procs = {n: _start(n, t) for n, t in targets.items()
                 if not t.exists()}
        try:
            return {n: _finish(n, targets[n], p) for n, p in procs.items()}
        finally:
            for p in procs.values():      # after a failure: stop the rest
                if p.poll() is None:
                    p.kill()
                    p.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    ``argtypes``/``restype`` declared for every C function."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
