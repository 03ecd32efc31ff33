"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file has a plain C interface (`extern "C" int
kmt_<name>(..., void* stream)` returning `cudaGetLastError()`), is compiled
by `nvcc` for sm_90a into a shared library of its own and is loaded with
ctypes. The build happens at first use, from the sources in this package
and nothing else, into `kimera_multi_tpu_torch/_build/`, keyed by a hash
of the source and its flags (`nvcc_flags`). All sources are compiled at
once, one `nvcc` process each. A failed build raises with the compiler's
output; nothing falls back to another path.

`host_lib` / `host_fn` build host code the same way, with the system C
or C++ compiler (`cc`, `c++`) instead of `nvcc`: `io/csrc/png.c`, the PNG
row filters, and `io/csrc/kmt_native.cpp`, the native wire codec and TCP
transport of the pod tier (io/native.py).

`launches` counts, per kernel, how often a wrapper launched it. `empty`
(csrc/gather.cu, a kernel that does nothing) is launched only to measure
the launch floor and is not counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "kernels", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Flags of one source beside NVCC_FLAGS. -fmad=false: the scoring kernels
# (K7 - K9 in score.cu) decide integers, inlier counts, by comparing f32
# residuals with a threshold. Without FMA contraction their arithmetic is,
# operation for operation, that of the plain PyTorch versions, so a residual
# within rounding of the threshold falls on the same side in both and the
# counts are equal, not merely close; gather.cu and hamming.cu move and
# compare integers and keep the rule so that nothing in them depends on it.
# fivept.cu (K6) contracts: its models are proposals that K7 and K9 then
# judge by exact counts, a fused multiply-add is one instruction where the
# pair was two, and the kernel is held to its plain version by a stated
# tolerance (chip_smoke.py, tests/test_torch_cuda_kernels.py). IEEE division
# and square root stay everywhere: no -use_fast_math, -ftz or -prec-div.
SOURCE_FLAGS = {
    "hamming.cu": ["-fmad=false"],
    "gather.cu": ["-fmad=false"],
    "score.cu": ["-fmad=false"],
    "fivept.cu": ["-fmad=true"],
}

# host sources (no CUDA): C compiled by `cc`, C++ by `c++`
HOST_CSRC_DIR = os.path.join(_PKG, "io", "csrc")
HOST_FLAGS = ["-O2", "-std=c99", "-shared", "-fPIC"]
HOST_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# source file -> {function: argtypes}; every pointer and the stream are
# c_void_p (ctypes would otherwise pass them as 32-bit ints)
SOURCES = {
    "hamming.cu": {
        "kmt_pair_top2": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "kmt_hamming_top2": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "kmt_hamming_top2_smem": [_I],
    },
    "gather.cu": {
        "kmt_sample_gather_t": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "kmt_sample_gather_perm_t": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "kmt_permute_cols": [_P, _P, _P, _I, _I, _I, _I, _P],
        "kmt_empty": [_I, _I, _P],
    },
    "score.cu": {
        "kmt_rigid_counts": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
        "kmt_essential_counts": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
        "kmt_presel_counts": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
    "fivept.cu": {
        "kmt_fivept_models": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    },
}

launches = {
    "pair_top2": 0,
    "hamming_top2": 0,
    "sample_gather_t": 0,
    "sample_gather_perm_t": 0,
    "permute_cols": 0,
    "fivept_models": 0,
    "presel_counts": 0,
    "rigid_counts": 0,
    "essential_counts": 0,
}

_fns: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use and "
        "need the CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def nvcc_flags(src: str) -> list:
    """The nvcc flags `src` is compiled with."""
    return [*NVCC_FLAGS, *SOURCE_FLAGS[src]]


def _lib_path(src: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, src), "rb") as f:
        h.update(f.read())
    h.update(" ".join(nvcc_flags(src)).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"libkmt_{stem}_{h.hexdigest()[:16]}.so")


def build_all(verbose: bool = False) -> dict:
    """Compile every source that has no up-to-date library, all `nvcc`
    processes started together. Returns {source: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {src: _lib_path(src) for src in SOURCES}
    procs = {}
    for src, out in paths.items():
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *nvcc_flags(src)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, os.path.join(CSRC_DIR, src)]
        procs[src] = (tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, cmd, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, paths[src])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def get_fn(name: str):
    """The C function `name`, building and loading its library if needed."""
    if name not in _fns:
        paths = build_all()
        for src, fns in SOURCES.items():
            lib = ctypes.CDLL(paths[src])
            for fn_name, argtypes in fns.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[fn_name] = fn
    return _fns[name]


def launch(kernel: str, *args) -> None:
    """Launch `kmt_<kernel>` on PyTorch's current stream without
    synchronising; raise on a refused launch; count it (all but
    `empty`)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = get_fn("kmt_" + kernel)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel kmt_{kernel} failed to launch "
                           f"(cudaError {err})")
    if kernel != "empty":
        launches[kernel] += 1


def check_cuda(name: str, t, dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, where given; None entries are free)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if shape is not None:
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(
                f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def host_flags(src: str) -> list:
    """The compiler flags of the host source `src`."""
    return HOST_CXX_FLAGS if src.endswith(".cpp") else HOST_FLAGS


_host_libs: dict = {}


def host_lib(src: str):
    """The library of the host source `io/csrc/<src>`, compiled at first
    use by the system C (`.c`) or C++ (`.cpp`) compiler into BUILD_DIR
    (keyed by a hash of the source and its flags; written to a temporary
    file and renamed, so processes building together do not clash) and
    loaded with ctypes. Raises where there is no compiler or the build
    fails."""
    if src in _host_libs:
        return _host_libs[src]
    path = os.path.join(HOST_CSRC_DIR, src)
    flags = host_flags(src)
    with open(path, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(flags).encode())
    out = os.path.join(BUILD_DIR, f"libkmt_{os.path.splitext(src)[0]}_"
                                  f"{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        names = ("c++", "g++") if src.endswith(".cpp") else ("cc", "gcc")
        cc = next((w for w in map(shutil.which, names) if w), None)
        if cc is None:
            raise RuntimeError(f"no compiler ({names[0]}) found to build "
                               f"{path}")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        p = subprocess.run([cc, *flags, "-o", tmp, path],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"{cc} failed on {path}:\n{p.stdout}"
                               f"{p.stderr}")
        os.replace(tmp, out)
    _host_libs[src] = lib = ctypes.CDLL(out)
    return lib


def host_fn(src: str, name: str, argtypes: list):
    """The C function `name` (returning int) of the host source
    `io/csrc/<src>` (`host_lib`)."""
    if name in _fns:
        return _fns[name]
    fn = getattr(host_lib(src), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _fns[name] = fn
    return fn
