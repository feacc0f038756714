"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``repro_torch/csrc/`` are CUDA C++ with a plain C
interface (no PyTorch headers), so ``nvcc`` compiles each in seconds. At
first use every ``.cu`` file is compiled to an object for ``sm_90a``, all
at once in parallel, and the objects are linked into one shared library
under ``build/repro_torch/`` at the root of the checkout (override with
``REPRO_TORCH_BUILD_DIR``). The library's name carries a hash of the
sources, the ``.cuh`` headers they share and the flags, so an unchanged
checkout reuses its library and a changed source or header builds a new
one. There is no ``--use_fast_math``: the
Jaccard division must stay IEEE-rounded, and flash attention's ``expf``
and division accurate.

The library is loaded with ``ctypes``. Every C entry point takes device
pointers, int64 lengths and the CUDA stream, launches on that stream and
returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0
and counts the launch in :data:`launches`, the per-kernel launch counter a
run reads to show which kernels its path went through (a kernel with more
than one design also under ``"<kernel>.<variant>"``).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# C entry point -> argument types (pointers and the stream as c_void_p,
# lengths and scalars as c_int64)
SIGNATURES = {
    "rt_pack_keys": (_P, _I64, _I64, _P, _P),
    # build, m, probe, n, group, lo, counts, stream
    "rt_probe_sorted": (_P, _I64, _P, _I64, _I64, _P, _P, _P),
    # starts, lo, m, total, tile, li, pos, stream
    "rt_expand_pairs": (_P, _P, _I64, _I64, _I64, _P, _P, _P),
    "rt_gather_rows": (_P, _I64, _P, _I64, _I64, _P, _P),
    # a, q, b, k, w, out, stream
    "rt_jaccard_distance": (_P, _I64, _P, _I64, _I64, _P, _P),
    "rt_jaccard_tile": (_P, _I64, _P, _I64, _I64, _P, _P),
    # q, k, v, o, B, S, T, H, K, D, causal, q_offset, kv_valid_len, dtype,
    # kv_splits, scratch, stream
    "rt_flash_attention_fwd": (_P, _P, _P, _P) + (_I64,) * 11 + (_P, _P),
    # q, k, v, o, B, S, T, H, K, D, causal, q_offset, kv_valid_len, stream
    "rt_flash_attention_tc": (_P, _P, _P, _P) + (_I64,) * 9 + (_P,),
    # q, k, v, o, B, S, T, H, K, D, causal, q_offset, kv_valid_len, dtype,
    # kv_splits, chunk, scratch, stream
    "rt_flash_attention_dec": (_P, _P, _P, _P) + (_I64,) * 12 + (_P, _P),
    # r, k, v, w, u, s0, y, s_out, B, S, H, hd, tile, stream (rt_wkv_tc:
    # no tile)
    "rt_wkv_fwd": (_P,) * 8 + (_I64,) * 5 + (_P,),
    "rt_wkv_tc": (_P,) * 8 + (_I64,) * 4 + (_P,),
    # r, k, v, w, u, s0, y, s_out, B, H, hd, warps per block, stream
    "rt_wkv_dec": (_P,) * 8 + (_I64,) * 4 + (_P,),
    # x, b, c, dt, a, d, s0, y, s_out, B, S, H, hd, N, strides of x, b, c
    # and dt over batch and time, stream (rt_ssd_tc: G's scratch before
    # the stream)
    "rt_ssd_fwd": (_P,) * 9 + (_I64,) * 13 + (_P,),
    "rt_ssd_tc": (_P,) * 9 + (_I64,) * 13 + (_P, _P),
    # q, k, o, dO, stats (pre); q, k, v, dO, stats, dq (dq); q, k, v, dO,
    # stats, dk, dv (dkv); then B, S, T, H, K, D, causal, q_offset,
    # kv_valid_len, dtype, stream (the tc route's three alike)
    "rt_flash_attention_bwd_pre": (_P,) * 5 + (_I64,) * 10 + (_P,),
    "rt_flash_attention_bwd_dq": (_P,) * 6 + (_I64,) * 10 + (_P,),
    "rt_flash_attention_bwd_dkv": (_P,) * 7 + (_I64,) * 10 + (_P,),
    "rt_flash_attention_bwd_tc_pre": (_P,) * 5 + (_I64,) * 10 + (_P,),
    "rt_flash_attention_bwd_tc_dq": (_P,) * 6 + (_I64,) * 10 + (_P,),
    "rt_flash_attention_bwd_tc_dkv": (_P,) * 7 + (_I64,) * 10 + (_P,),
    # r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw, ds0, du's parts, marks,
    # hist, B, S, H, hd, stream; then du's parts, du, B, H * hd, stream
    "rt_wkv_bwd": (_P,) * 16 + (_I64,) * 4 + (_P,),
    "rt_wkv_bwd_sum": (_P, _P, _I64, _I64, _P),
    # r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw, ds0, S_in's and G_out's
    # scratch, the chunks' decays, du's parts, du, B, S, H, hd, which
    # kernel (0 states, 1 passes, 2 gradients, 3 sum), stream
    "rt_wkv_bwd_tc": (_P,) * 18 + (_I64,) * 5 + (_P,),
    # x, b, c, dt, a, d, s0, dy, ds, dx, ddt, ds0, db's and dc's parts, da's
    # and dd's parts, marks, hist, B, S, H, hd, N, strides of x, b, c and
    # dt over batch and time, stream; then the parts, db, dc, da, dd, B,
    # S, H, N, stream
    "rt_ssd_bwd": (_P,) * 17 + (_I64,) * 13 + (_P,),
    "rt_ssd_bwd_sum": (_P,) * 7 + (_I64,) * 4 + (_P,),
    # x, b, c, dt, a, d, s0, dy, ds, dx, ddt, ds0, S_in's and dS_out's
    # scratch, e^{cum_last}, db's and dc's parts, da's and dd's parts, db,
    # dc, da, dd, B, S, H, hd, N, strides of x, b, c and dt over batch and
    # time, which kernel (0 states, 1 passes, 2 gradients, 3 sums), stream
    "rt_ssd_bwd_tc": (_P,) * 22 + (_I64,) * 14 + (_P,),
}

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = collections.Counter()

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches.clear()


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile and link the kernels unless a library of the current sources
    exists; returns its path. The compiler's output (``-Xptxas=-v``:
    registers, shared memory, spills per kernel) lands in ``build.log``
    beside the library."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        # wait for every compiler before acting on any failure
        done = [(src, proc.communicate()[0], proc.returncode)
                for src, _, proc in procs]
        log = [f"== {src.name}\n{text}" for src, text, _ in done]
        for src, text, code in done:
            if code != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        lib_tmp = pathlib.Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(lib_tmp),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out.parent / "build.log").write_text("".join(log))
        os.replace(lib_tmp, out)            # atomic: concurrent builds agree
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, entry: str, device: torch.device, *args,
           variant: Optional[str] = None) -> None:
    """Call C entry point ``entry`` on the current stream of ``device``,
    raise if the launch failed, and count it under ``kernel`` (and, given
    a ``variant``, under ``kernel.variant``). On the meta tier (the dry
    run) nothing is launched, built or counted."""
    if device.type == "meta":
        return
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    if code != 0:
        raise RuntimeError(f"CUDA kernel {kernel} ({entry}) failed to "
                           f"launch: cudaError {code}")
    launches[kernel] += 1
    if variant is not None:
        launches[f"{kernel}.{variant}"] += 1
