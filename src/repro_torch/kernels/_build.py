"""Build, load and count the hand-written CUDA kernels.

The sources in ``csrc/`` are compiled for ``sm_90a`` at first use: one
``nvcc -c`` per ``*.cu``, all started together, with ``csrc/`` on the
include path for the shared headers (``*.cuh``), then one link into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library goes to ``build/repro_torch_kernels/`` at the repository root
(listed in ``.gitignore``) under a name that hashes every file of
``csrc/`` (sources and headers) and the flags, so an edit rebuilds and an
unchanged tree reuses it.  Nothing is built when a module is
imported, and nothing here runs on a machine without ``nvcc``: the CPU paths
never call :func:`library`.

Each kernel wrapper bumps :data:`launches` where it launches its kernel and
nowhere else, so a run can show that it went through the kernels; a kernel
with two routes is counted under its name and under ``<name>/<route>``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# the route argument of the kernels that have two (gmm, flash attention,
# ssd_chunk and the two backwards): its code is the index here.  "wgmma":
# warpgroup products on the tensor cores; "simt": the CUDA cores
ROUTES = ("simt", "wgmma")

# C entry point -> argument types after the pointers (all return cudaError_t)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "rt_segment_sum": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    "rt_class_second_moment": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    # ..., T, M, C, F, then the plan: k, rows, stage_rows, stages, tile, bulk,
    # cols, then the stream route's scratch
    "rt_mahalanobis": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # ..., M, K, N, NB, then the plan: tile_m, chunk, stages, vec
    "rt_int8_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, o, lse (or null), ..., route (0 "simt", 1 "wgmma"), stream
    "rt_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _I, _I, _I, _F, _F, _I, _P),
    # q, k, v, o, lse, dout, dq, dk, dv, delta, ..., need_dq, need_dkv,
    # route (0 "simt", 1 "wgmma"), stream
    "rt_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _I, _I, _I, _F, _F, _I, _I, _I, _P),
    # ..., E, C, D, F, x stored transposed, w stored transposed, route, stream
    "rt_gmm": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "rt_ssd_chunk": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, dt, A, B, C (fp32), gy, gst, gcd, gsd (each or null), gx, gdt, gA,
    # gB, gC, scratch, G, Q, P, N, route (0 "simt", 1 "wgmma"), stream
    "rt_ssd_chunk_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P),
}


class LaunchCounter:
    """Plain integer launch counts per kernel name."""

    def __init__(self):
        self._counts: Dict[str, int] = {}

    def bump(self, name: str) -> None:
        self._counts[name] = self._counts.get(name, 0) + 1

    def reset(self) -> None:
        self._counts.clear()

    def snapshot(self) -> Dict[str, int]:
        return dict(self._counts)


launches = LaunchCounter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_entry: Dict[str, ctypes._CFuncPtr] = {}   # name -> typed entry point


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources():
    """The translation units: every ``csrc/*.cu``."""
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags and of every file in ``csrc/``, headers included,
    so an edit to a header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link one shared
    library; returns its path.  Reuses a library built from identical
    sources.  Raises with the compiler's output on any failure."""
    out = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}-{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed = []
    for src, p in procs:
        log, _ = p.communicate()
        if verbose and log:
            print(f"[nvcc {src.name}]\n{log}", flush=True)
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f".tmp-{os.getpid()}-{out.name}"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                           "-o", str(tmp)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call; its entry points
    get their argument types and go into :data:`_entry` once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _entry[name] = fn
            _lib = lib
        return _lib


def launch(name: str, counter: str, *args, route: Optional[str] = None) -> None:
    """Call C entry point ``name`` and raise if the launch was refused;
    count it under ``counter`` and, given a ``route``, under
    ``counter/route`` too.  After the first call this is one dict lookup
    and the foreign call: no lock, no attribute lookup."""
    fn = _entry.get(name)
    if fn is None:
        library()
        fn = _entry[name]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    launches.bump(counter)
    if route is not None:
        launches.bump(f"{counter}/{route}")
