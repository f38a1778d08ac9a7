"""Build and load the hand-written CUDA kernels.

The sources under ``iterative_solvers_tpu_torch/csrc/`` have a plain C
interface (one ``extern "C"`` launcher per kernel returning
``cudaGetLastError()``), so they compile with ``nvcc`` alone in seconds and
load with ``ctypes``; nothing includes PyTorch's headers. The library is
built at first use into ``build/torch_kernels/`` at the repository root,
named by a hash of the sources and flags so an edited source never loads a
stale build: one ``nvcc -c`` per source, all started together, then one
link. A failed build raises with nvcc's stderr.

Launch counts live here too: each wrapper adds one to ``launches[name]``
where it launches its kernel, and plain versions add one to
``plain_on_cuda[name]`` when they are handed a CUDA tensor, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

launches: Counter = Counter()
plain_on_cuda: Counter = Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every launcher; the trailing pointer is the CUDA stream
_SIGNATURES = {
    # fused CG: (..., band rows, tile rows, cd, cx, cy)
    "ist_k1": [_P] * 7 + [_I] * 7 + [_F] * 3 + [_P],
    "ist_k2": [_P] * 12 + [_I] * 7 + [_F] * 3 + [_P],
    "ist_k2_pcg": [_P] * 13 + [_I] * 7 + [_F] * 3 + [_P],
    # the V-cycle legs: (..., tile rows, coarse layout), K_up the coarse
    # row stride and row count
    "ist_k_down": [_P] * 2 + [_I] * 8 + [_F] * 4 + [_P],
    "ist_k_up": [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P],
    "ist_k_jacobi": [_P] * 3 + [_I] * 6 + [_F] * 4 + [_P],
    # A1: (x, y, nx, ny, gamma, hp, wp, tile rows, cd, cx, cy)
    "ist_stencil": [_P] * 2 + [_I] * 6 + [_F] * 3 + [_P],
    "ist_k_resid_ff": [_P] * 6 + [_I] * 9 + [_F] * 10 + [_P],
    # custom domains: the int8 mask pointer in the gamma flag's place,
    # (..., mask, nx, ny, hp, wp, by, ...)
    "ist_k1_custom": [_P] * 8 + [_I] * 6 + [_F] * 3 + [_P],
    "ist_k2_custom": [_P] * 13 + [_I] * 6 + [_F] * 3 + [_P],
    "ist_k2_pcg_custom": [_P] * 14 + [_I] * 6 + [_F] * 3 + [_P],
    "ist_k_down_custom": [_P] * 4 + [_I] * 7 + [_F] * 4 + [_P],  # child mask first
    "ist_k_up_custom": [_P] * 5 + [_I] * 7 + [_F] * 4 + [_P],
    "ist_stencil_custom": [_P] * 3 + [_I] * 5 + [_F] * 3 + [_P],
    "ist_k_resid_ff_custom": [_P] * 7 + [_I] * 8 + [_F] * 10 + [_P],
    # 3D (csrc/zstream3d.cuh geometry: nx, ny, nz, d, hp, wp, bz)
    "ist_stencil3d": [_P] * 2 + [_I] * 7 + [_F] * 4 + [_P],
    # the 3D legs: (..., bz, the child's layout dc, ho, wo, ...)
    "ist_k_down3d": [_P] * 2 + [_I] * 10 + [_F] * 5 + [_P],
    "ist_k_up3d": [_P] * 3 + [_I] * 10 + [_F] * 5 + [_P],
    "ist_k_jacobi3d": [_P] * 3 + [_I] * 7 + [_F] * 5 + [_P],
    "ist_k_resid_ff3d": [_P] * 6 + [_I] * 11 + [_F] * 14 + [_P],
    # in-place and pipelined stencils (C4, C5): the 2D geometry with the
    # rows of a range in the band's place, (cd, cx, cy, scale), the depth
    "ist_stencil_inplace": [_P] * 2 + [_I] * 6 + [_F] * 4 + [_I] + [_P],
    "ist_stencil_inplace_custom": [_P] * 3 + [_I] * 5 + [_F] * 4 + [_I] + [_P],
    "ist_stencil_pipelined": [_P] * 3 + [_I] * 6 + [_F] * 4 + [_I] + [_P],
    "ist_stencil_pipelined_custom": [_P] * 4 + [_I] * 5 + [_F] * 4 + [_I] + [_P],
    # mesh blocks (D1–D4): the block and its halo operands, the 2D geometry
    # of the block (D3/D4: the tile rows TJ in the band height's place), its
    # global origin (roff, coff), then the coefficients
    "ist_stencil_block": [_P] * 6 + [_I] * 8 + [_F] * 3 + [_P],
    "ist_stencil3d_block": [_P] * 6 + [_I] * 9 + [_F] * 4 + [_P],
    "ist_k_down_block": [_P] * 6 + [_I] * 8 + [_F] * 4 + [_P],
    "ist_k_up_block": [_P] * 12 + [_I] * 9 + [_F] * 4 + [_P],
    # fused CG on mesh blocks (D5, D6): (..., band rows, tile rows, roff,
    # coff, canvas width, cd, cx, cy)
    "ist_k1_block": [_P] * 11 + [_I] * 10 + [_F] * 3 + [_P],
    "ist_k2_block": [_P] * 14 + [_I] * 10 + [_F] * 3 + [_P],
    "ist_k2_pcg_block": [_P] * 15 + [_I] * 10 + [_F] * 3 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_counts() -> None:
    launches.clear()
    plain_on_cuda.clear()


def note_plain(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        plain_on_cuda[name] += 1


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libist_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels (if this source set was not built yet)."""
    out = library_path()
    if out.exists():
        return out
    objdir = out.with_suffix(f".{os.getpid()}.obj")
    objdir.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    objs = [objdir / f"{c.stem}.o" for c in cu]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(c)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c, o in zip(cu, objs)
    ]
    errors = []
    for c, proc in zip(cu, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{c.name} ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every launcher typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call launcher ``name`` on the current stream and raise on a refused launch."""
    fn = getattr(load(), name)
    code = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")
    launches[name.removeprefix("ist_")] += 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The number of SMs of CUDA ``device`` (the current one if it has no index)."""
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


def ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
