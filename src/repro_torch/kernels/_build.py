"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, to an object for ``sm_90a``; the objects are linked into one
shared library with a plain C interface. The library lands in
``<repo>/build/kernels/<hash>/``, keyed by a hash of the sources and the
flags, so a change to any source rebuilds and an unchanged tree loads what
is there. Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libpfp_kernels.so"

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "pfp_dense_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    "pfp_dense_batched_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _L, _L, _I, _I, _I, _I, _I, _I, _P],
    "pfp_activation_launch": [_I, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    "pfp_glu_launch": [_P, _P, _P, _P, _P, _P, _L, _P],
    "pfp_maxpool2d_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P],
    "pfp_norm_launch": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                        _F, _P],
    "pfp_norm_dense_act_launch": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                  _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _F, _P],
    "pfp_attention_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _F, _I, _P],
    "pfp_attention_kv_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                                _I, _P],
    "pfp_attention_kv_block": [_I, _I, _I, _P, _P],
    "pfp_empty_launch": [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built on this machine")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for path in sources + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """Compile every source in parallel, then link. Returns ptxas' report."""
    nvcc = _nvcc()
    sources, _ = _sources()
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    # One thread drains each process's output (a full pipe would stall
    # it) and notes when it ended, so the log shows each source's time.
    start, done = time.perf_counter(), {}

    def drain(proc):
        done[proc] = (proc.communicate()[0], time.perf_counter() - start)

    threads = [threading.Thread(target=drain, args=(proc,))
               for _, _, proc in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    logs, failed = [], []
    for src, _, proc in procs:
        out, seconds = done[proc]
        logs.append(f"== {src.name} ({seconds:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                           + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernels failed\n" + link.stdout)
    return "\n".join(logs)


def load():
    """The kernels' library, built first if this tree's sources have no
    build yet. Safe to call from several threads and processes: a build is
    made in a private directory and moved into place in one rename."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        final = BUILD_ROOT / source_hash()
        start = time.perf_counter()
        built = False
        if not (final / LIB_NAME).exists():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
            try:
                log = _compile(tmp)
                (tmp / "ptxas.log").write_text(log)
                try:
                    os.rename(tmp, final)
                    built = True
                except OSError:  # another process finished first
                    pass
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        lib = ctypes.CDLL(str(final / LIB_NAME))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pfp_error_string.argtypes = [ctypes.c_int]
        lib.pfp_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(directory=str(final), built=built,
                          seconds=time.perf_counter() - start)
        _LIB = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if status != 0:
        msg = _LIB.pfp_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
