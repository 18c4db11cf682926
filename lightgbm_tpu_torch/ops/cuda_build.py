"""Build and load the port's CUDA kernels (``lightgbm_tpu_torch/csrc``).

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` into position-independent objects, which one more
``nvcc`` links into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). The library is built at first use,
keyed by a hash of the sources and flags, under ``lightgbm_tpu_torch/_build``
(listed in ``.gitignore``), and loaded with ``ctypes``: pointers come from
``Tensor.data_ptr()``, the stream from ``torch.cuda.current_stream()``, and
every pointer argument is declared ``c_void_p`` so ctypes never truncates it
to 32 bits. Each C entry point returns ``cudaGetLastError()`` after its
launch; the wrappers in ``ops/fused_level.py`` and
``ops/pallas_histogram.py`` raise when it is not 0.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
SOURCES = ("level_pass.cu", "route_pass.cu", "table_lookup.cu",
           "epilogue_pass.cu", "hist_pass.cu")
HEADERS = ("fused_level.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "liblgbt_kernels.so"

_c = ctypes
_P = _c.c_void_p
# C signatures: (argtypes, restype int)
SIGNATURES = {
    "lgbt_level_pass": [_P, _c.c_int, _P, _P, _c.c_int, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _c.c_longlong, _c.c_int, _c.c_int,
                        _c.c_longlong, _c.c_int, _c.c_int, _c.c_int,
                        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                        _P, _c.POINTER(_c.c_int)],
    "lgbt_device_limits": [_c.POINTER(_c.c_int), _c.POINTER(_c.c_int)],
    "lgbt_route_pass": [_P, _c.c_int, _P, _P, _P, _P, _P, _P,
                        _c.c_longlong, _c.c_int, _c.c_int, _c.c_longlong,
                        _c.c_int, _P, _c.POINTER(_c.c_int)],
    "lgbt_table_lookup": [_P, _P, _P, _c.c_longlong, _c.c_int, _P],
    "lgbt_epilogue_pass": [_P, _c.c_int, _P, _P, _P, _P, _c.c_int, _P, _P,
                           _P, _P, _P, _P, _P, _P, _c.c_longlong, _c.c_int,
                           _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                           _c.c_float, _c.c_int, _c.c_int, _c.c_int, _P,
                           _c.POINTER(_c.c_int)],
    "lgbt_epilogue_blocks": [_c.c_int, _c.c_int, _c.c_int, _c.c_int,
                             _c.c_longlong, _c.c_int,
                             _c.POINTER(_c.c_longlong),
                             _c.POINTER(_c.c_int)],
    "lgbt_hist_pass": [_P, _P, _P, _P, _c.c_longlong, _c.c_int, _c.c_int,
                       _c.c_int, _c.c_int, _c.c_int, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "lightgbm_tpu_torch are built from source at first use")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels' library if this source hash has none yet;
    returns its path. Fills ``build_info`` (seconds, ptxas report)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        build_info.setdefault("seconds", 0.0)
        report = out_dir / "ptxas.txt"
        if report.is_file():
            build_info.setdefault("ptxas", report.read_text())
        return lib
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report = []
        failed = []
        for name, _, p in procs:
            out, _ = p.communicate()
            report.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed on %s:\n%s"
                               % (", ".join(failed), "\n".join(report)))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib)] + [str(o) for _, o, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "ptxas.txt").write_text("\n".join(report))
        os.replace(tmp_lib, lib)
    build_info.update(seconds=time.perf_counter() - t0,
                      ptxas="\n".join(report))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _lib = lib
    return _lib
