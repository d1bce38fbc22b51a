"""Build and load the hand-written CUDA kernels (csrc/*.cu).

At first use, nvcc compiles every source in csrc/ for Hopper (sm_90a),
one process per source, all started together, and links the objects into
one shared library with a plain C interface, under build/ inside this
package; ctypes loads it.  Each C entry launches its kernel(s) on the
stream it is given, allocates nothing, and returns cudaGetLastError() as
an int, which `check` turns into an exception.  A missing nvcc or a
failed build raises: nothing falls back to another implementation.

The library is named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

# The most episodes one launch's grid y dimension holds.  The batched C
# entries that lay episodes along y (K1 batched, K2 batched's two-launch
# path) launch larger batches in chunks of this many.
GRID_Y_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry -> argtypes.  Every pointer and the stream are c_void_p, so
# ctypes never passes one as a 32-bit int.
SIGNATURES = {
    # particles, n, beam table, B, occ, dil, H, W, fparams, iparams, out,
    # raster words (null: shared-memory form), stream
    "mcl_beam_weights": [_P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P,
                         _P],
    # particles, E, N, angles, ranges, mask, B, occ, dil, H, W, fparams,
    # iparams, out, raster words, stream
    "mcl_beam_weights_batched": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                                 _I, _P, _P, _P, _P, _P],
    # particles, E, N, angles, ranges, mask, B, occ, dil, maps, map index,
    # H, W, fparams, iparams, out, raster words, stream
    "mcl_beam_weights_stack": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P,
                               _I, _I, _P, _P, _P, _P, _P],
    # ... out, then the four tallies, raster words, stream
    "mcl_beam_weights_cast_stats": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                                    _P, _I, _I, _P, _P, _P, _P, _P, _P],
    # ... out, then threads a particle, particles a block, item counter,
    # raster words, stream
    "mcl_beam_weights_beamsub": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                                 _I, _P, _P, _P, _I, _I, _P, _P, _P],
    # particles, cdf, u0, E, n, d, out, scratch, stream
    "mcl_systematic_expand": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "mcl_expand_device_launches": [],
    # xy, episode stride, row stride, E, n, centers0, reseed, iters, k,
    # assign, centers, gsum, gflag, one_block, n_groups, threads, stream
    "mcl_kmeans": [_P, _L, _L, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                   _I, _I, _P],
    "mcl_kmeans_device_launches": [],
    # mark index (ops/marks.MARKS), stream
    "mcl_mark": [_I, _P],
    # particles, E x N, N, signed angles, ranges, mask, B, occ, dil, H, W,
    # fparams, iparams, proposals out, then the likelihood, gradient and
    # distances out (null, or all three), raster words, stream
    "mcl_refine_grad": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P,
                        _P, _P, _P, _P, _P, _P],
    # mcl_refine_grad's arguments to the proposals, then the two tallies,
    # raster words, stream
    "mcl_refine_walk_stats": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _I,
                              _P, _P, _P, _P, _P, _P],
    # particles, proposals (null: score the particles), weights, E x N, N,
    # signed angles, ranges, mask, B, occ, dil, H, W, fparams, iparams,
    # raster words, stream
    "mcl_refine_score": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _I,
                         _P, _P, _P, _P],
    # log-odds, out, ray origins, beam table, windows (null: dense), paint
    # (null: every map), maps, H, W, window H, window W, B, fparams, stream
    "mcl_ism_update": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P,
                       _P],
}

_lib = None
build_seconds = None


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def find_nvcc():
    """nvcc from PATH, $CUDA_HOME or the default toolkit root; None if
    there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def _library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmcl_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> list:
    """Run the commands in parallel and return their standard errors;
    raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed, errs = None, []
    for p in procs:
        out, err = p.communicate()
        errs.append(err)
        if p.returncode != 0 and failed is None:
            failed = f"nvcc failed ({p.returncode}):\n{out}\n{err}"
    if failed is not None:
        raise RuntimeError(failed)
    return errs


def _nvcc() -> str:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels are compiled from csrc/ at first use")
    return nvcc


def _compile_all(nvcc, cu, tmpdir, extra=()) -> tuple:
    """Compile each source into an object under tmpdir, all in parallel;
    the objects' paths and nvcc's standard errors."""
    objs = [os.path.join(tmpdir, os.path.basename(c) + ".o") for c in cu]
    return objs, _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", o, c]
                           for c, o in zip(cu, objs)])


def build() -> str:
    """Compile csrc/*.cu into the shared library (if not built yet) and
    return its path.  Raises RuntimeError without nvcc or on a failed
    build."""
    global build_seconds
    out = _library_path()
    if os.path.isfile(out):
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in sources() if s.endswith(".cu")]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, _ = _compile_all(nvcc, cu, tmpdir)
        tmp = os.path.join(tmpdir, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def ptxas_usage(stderr: str) -> dict:
    """{kernel's mangled name: {registers, stack, spill_stores,
    spill_loads}} (bytes but registers) from nvcc's `-Xptxas -v` output."""
    usage, entry, props = {}, None, None
    for ln in stderr.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            usage[entry] = {}
        elif "Function properties for" in ln:
            props = ln.split("Function properties for", 1)[1].strip()
        elif props in usage and "bytes stack frame" in ln:
            n = [int(t) for t in ln.replace(",", " ").split() if t.isdigit()]
            usage[props].update(stack=n[0], spill_stores=n[1],
                                spill_loads=n[2])
        elif entry is not None and "Used" in ln and "registers" in ln:
            usage[entry]["registers"] = int(
                ln.split("Used", 1)[1].split()[0])
    return usage


def ptxas_report() -> dict:
    """{source file: ptxas_usage} of each csrc/*.cu compiled with NVCC_FLAGS
    and `-Xptxas -v` into a temporary directory: the library is neither
    built nor renamed.  Needs nvcc."""
    cu = [s for s in sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory() as tmpdir:
        _, errs = _compile_all(_nvcc(), cu, tmpdir, ("-Xptxas", "-v"))
    return {os.path.basename(c): ptxas_usage(e) for c, e in zip(cu, errs)}


def loaded() -> bool:
    """Whether the kernel library is loaded (built and opened) yet."""
    return _lib is not None


def library():
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch is
    reported only by cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def floats(values):
    return (ctypes.c_float * len(values))(*values)


def ints(values):
    return (ctypes.c_int * len(values))(*values)
