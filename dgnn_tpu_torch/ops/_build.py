"""Build and load the CUDA kernels of csrc/ at first use.

``nvcc`` compiles each source of ``csrc/`` for Hopper (``sm_90a``), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which is loaded with ctypes.  The
library goes to ``build/dgnn_tpu_torch/<hash>/`` at the root of the checkout
(listed in .gitignore), keyed by a hash of the sources, the headers and the
flags, so a changed source is rebuilt and an unchanged one is loaded as it
is.  ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept beside the library as ``build.log``.

Nothing is built or loaded at import time; a missing ``nvcc`` or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "load", "library_path", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("bin_gat.cu", "dense_gat.cu", "bin_gmm.cu", "dense_gmm.cu")
_HEADERS = ("gat_common.cuh", "dense_common.cuh", "gmm_common.cuh")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dgnn_tpu_torch"
_LIB_NAME = "libdgnn_torch.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the dgnn_tpu_torch CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16] / _LIB_NAME


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{Path(s).stem}.{tag}.o") for s in _SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
            for s, o in zip(_SOURCES, objs)]
    tmp = so.with_name(f"{_LIB_NAME}.{tag}")
    cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)])
    log = []
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds[:-1]]
    results = [(c, p.communicate()[0], p.returncode)
               for c, p in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in results):
        res = subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, check=False)
        results.append((cmds[-1], res.stdout, res.returncode))
    for cmd, out, _ in results:
        log.append(" ".join(cmd) + "\n" + out)
    (so.parent / "build.log").write_text("\n".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(cmd, out, rc) for cmd, out, rc in results if rc != 0]
    if failed:
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed with code {rc} on "
                           f"{cmd[-1]}:\n{out[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dgnn_bin_gat_fwd.argtypes = [
            vp, vp, vp, vp, vp, vp,             # x ac ar nbr row count
            ci, ci, ci, ci,                     # S W H F
            cf, ci, cf, cf, ctypes.c_uint32,    # slope with_pos p inv_keep seed
            vp, vp, vp, vp, vp,                 # m l lpos acc accpos
            vp]                                 # stream
        lib.dgnn_bin_gat_fwd.restype = ci
        lib.dgnn_bin_gat_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp,         # g ar M Linv ws ac x
            vp, vp, vp,                         # nbr row count
            ci, ci, ci, ci,                     # S W H F
            cf, cf, cf, ctypes.c_uint32,        # slope p inv_keep seed
            vp, vp,                             # dx dac
            vp]                                 # stream
        lib.dgnn_bin_gat_bwd.restype = ci
        lib.dgnn_dense_gat_fwd.argtypes = [
            vp, vp, vp, vp,                     # x ac ar acmax
            vp, vp, vp, vp, vp,                 # row_ids col_ids mask ct chunk_ptr
            ci, ci, ci,                         # R H F
            cf, ci, cf, cf, ctypes.c_uint32,    # slope with_pos p inv_keep seed
            ci,                                 # bf16
            vp, vp, vp, vp, vp,                 # m l lpos acc accpos
            vp]                                 # stream
        lib.dgnn_dense_gat_fwd.restype = ci
        lib.dgnn_dense_gat_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp,         # g ar M Linv ws ac x
            vp, vp, vp, vp, vp,                 # row_ids col_ids mask ct chunk_ptr
            ci, ci, ci,                         # R H F
            cf, cf, cf, ctypes.c_uint32,        # slope p inv_keep seed
            ci,                                 # bf16
            vp, vp,                             # dx dac
            vp]                                 # stream
        lib.dgnn_dense_gat_bwd.restype = ci
        lib.dgnn_bin_gmm_fwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp,     # x alpha beta nbr row count mu isig
            ci, ci, ci, ci, ci, ci,             # S W K D F use_tanh
            vp,                                 # acc
            vp]                                 # stream
        lib.dgnn_bin_gmm_fwd.restype = ci
        lib.dgnn_bin_gmm_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp,             # g beta dfeat alpha x sfeat
            vp, vp, vp, vp, vp,                 # nbr row count mu isig
            ci, ci, ci, ci, ci, ci, ci, ci,     # S W K D Dd Ds F use_tanh
            vp, vp,                             # dx st
            vp]                                 # stream
        lib.dgnn_bin_gmm_bwd.restype = ci
        lib.dgnn_dense_gmm_fwd.argtypes = [
            vp, vp, vp,                         # x alpha beta
            vp, vp, vp, vp, vp,                 # row_ids col_ids mask ct chunk_ptr
            vp, vp,                             # mu isig
            ci, ci, ci, ci, ci, ci,             # R K D F use_tanh bf16
            vp,                                 # acc
            vp]                                 # stream
        lib.dgnn_dense_gmm_fwd.restype = ci
        lib.dgnn_dense_gmm_bwd.argtypes = [
            vp, vp, vp, vp, vp,                 # g beta dfeat alpha x
            vp, vp, vp, vp, vp,                 # row_ids col_ids mask ct chunk_ptr
            vp, vp,                             # mu isig
            ci, ci, ci, ci, ci, ci, ci,         # R K D Dd F use_tanh bf16
            vp, vp,                             # dx st
            vp]                                 # stream
        lib.dgnn_dense_gmm_bwd.restype = ci
        _lib = lib
        return lib
