"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, on first use, into
``src/repro_torch/_build/`` (listed in .gitignore), and bound with
``ctypes``.  :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for them.  Importing this module builds nothing; there is
no fallback when ``nvcc`` is missing or a build fails: it raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _LL, _I, _U, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_uint, ctypes.c_float)
# entry point -> (library, C symbol, argtypes); a library is one source,
# csrc/<library>.cu.  Every pointer and the stream as c_void_p (a plain int
# would be cut to 32 bits), every long long as c_longlong.
ENTRY_POINTS = {
    "mix": ("mix", "repro_mix", [_P] * 9 + [_LL] + [_I] * 5 + [_P]),
    "mix_vector": ("mix", "repro_mix_vector",
                   [_P] * 9 + [_LL] + [_I] * 5 + [_P]),
    "cmix": ("cmix", "repro_cmix", [_P] * 8 + [_U, _LL] + [_I] * 5 + [_P]),
    "cmix_vector": ("cmix", "repro_cmix_vector",
                    [_P] * 8 + [_U, _LL] + [_I] * 4 + [_P]),
    "cmix_absmax": ("cmix", "repro_cmix_absmax",
                    [_P] * 4 + [_LL] + [_I] * 3 + [_P]),
    "collective": ("collective", "repro_collective",
                   [_P] * 4 + [_U, _U, _LL] + [_I] * 6 + [_P]),
    "mlstm": ("mlstm", "repro_mlstm", [_P] * 10 + [_I] * 7 + [_P]),
    "mlstm_wgmma": ("mlstm_wgmma", "repro_mlstm_wgmma",
                    [_P] * 10 + [_I] * 5 + [_P]),
    "shard_mix": ("shard_mix", "repro_shard_mix",
                  [_P] * 6 + [_LL] + [_I] * 4 + [_P]),
    "shard_cmix": ("shard_cmix", "repro_shard_cmix",
                   [_P] * 6 + [_LL] + [_I] * 3 + [_P]),
    "flash_attention": ("flash_attention", "repro_flash_attention",
                        [_P] * 5 + [_I] * 6 + [_F, _I, _F] + [_I] * 4
                        + [_P]),
    "flash_attention_wgmma": ("flash_attention_wgmma",
                              "repro_flash_attention_wgmma",
                              [_P] * 5 + [_I] * 6 + [_F, _I, _F] + [_I] * 4
                              + [_P]),
    "rmsnorm": ("rmsnorm", "repro_rmsnorm",
                [_P] * 3 + [_LL, _I, _LL, _F, _F, _I, _I, _I, _P]),
}
# the libraries, one nvcc each
LIBRARIES = tuple(dict.fromkeys(lib for lib, _, _ in ENTRY_POINTS.values()))
# dynamic shared memory a block may opt into on the H100 (227 KB)
MAX_SMEM = 232_448


class _Libs:
    """The loaded kernel libraries (each built at most once per process)."""
    handles: Dict[str, ctypes.CDLL] = {}
    build_seconds: Dict[str, float] = {}
    build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME); "
                           "the CUDA kernels are built on first use")
    return found


def _lib_path(name: str) -> Path:
    """The library's path, named by the hash of its source, the shared
    headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(*names: str) -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load the named libraries — all of
    :data:`LIBRARIES` by default.  ``_Libs.build_log`` keeps each
    ``nvcc -Xptxas -v`` report, ``_Libs.build_seconds`` its wall time."""
    names = names or LIBRARIES
    todo = [n for n in names if n not in _Libs.handles]
    if not todo:
        return {n: _Libs.handles[n] for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    t0 = time.perf_counter()
    for name in todo:
        path = _lib_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        src = CSRC / f"{name}.cu"
        running[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path)
    failed = []
    for name, (proc, tmp, path) in running.items():
        out, _ = proc.communicate()
        _Libs.build_log[name] = out
        _Libs.build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("repro_torch: nvcc failed on " + "\n".join(failed))
    for name in todo:
        lib = ctypes.CDLL(str(_lib_path(name)))
        for library, symbol, argtypes in ENTRY_POINTS.values():
            if library == name:
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _Libs.handles[name] = lib
    return {n: _Libs.handles[n] for n in names}


def entry(name: str):
    """The bound C entry point ``name`` of :data:`ENTRY_POINTS` (its
    library built on first use)."""
    library, symbol, _ = ENTRY_POINTS[name]
    return getattr(build(library)[library], symbol)
