"""Build-on-demand ctypes loader for the native C++ engines.

``assembly.cpp`` (CSR assembly of the masked 5-point and 7-point
operators) and ``textio.cpp`` (bulk ``%.17e`` formatting and parsing for the
results files) are the port's own sources, beside this file. Each compiles
at first use with ``g++ -O3 -shared -fPIC -std=c++17`` (``$CXX`` overrides
the compiler) into ``build/torch_native/`` at the repository root, named by a
hash of its source and flags, so an edited source never loads a stale
build. A failed compile raises with the compiler's stderr: nothing falls
back to another engine. Plain C interface, no pybind11.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = {"assembly": HERE / "assembly.cpp", "textio": HERE / "textio.cpp"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_SHAPE_CODES = {"rect": 0, "gamma": 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where engine ``name``'s library for the current source is built."""
    src = SOURCES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile engine ``name`` unless this source was built already."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCES[name]), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native {name}: cannot run {cmd[0]} ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native {name}: {' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _typed(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int, ctypes.c_double
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pf64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    sigs = {
        "assembly": {
            "ist_num_unknowns": (i64, [i32, i32, i32]),
            "ist_ranks": (None, [i32, i32, i32, pi64]),
            "ist_assemble_csr": (i64, [i32, i32, i32, f64, f64, f64, i64, pi64, pi64, pf64]),
            "ist_assemble_csr3d": (i64, [i32, i32, i32, f64, f64, f64, f64, i64, pi64, pi64,
                                         pf64]),
            "ist_node_coords": (None, [i32, i32, i32, f64, f64, f64, f64, pf64, pf64]),
        },
        "textio": {
            "ist_format_doubles": (i64, [pf64, i64, ctypes.c_void_p, i64]),
            "ist_format_xyz": (i64, [pf64, pf64, pf64, i64, ctypes.c_void_p, i64]),
            "ist_parse_doubles": (i64, [ctypes.c_char_p, i64, pf64, i64,
                                        ctypes.POINTER(i64)]),
        },
    }[name]
    for fn, (restype, argtypes) in sigs.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def load(name: str) -> ctypes.CDLL:
    """Engine ``name`` (``"assembly"`` or ``"textio"``), built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = _typed(name, ctypes.CDLL(str(build(name))))
    return lib


def available() -> bool:
    """Whether both engines build and load here (no compiler: False)."""
    try:
        for name in SOURCES:
            load(name)
    except RuntimeError:
        return False
    return True


def _shape_code(domain) -> Optional[int]:
    return _SHAPE_CODES.get(getattr(domain, "shape", None))


def num_unknowns_native(domain) -> Optional[int]:
    """Unknown count of a gamma/rect domain; None for the others."""
    code = _shape_code(domain)
    if code is None or hasattr(domain, "nz"):
        return None
    return int(load("assembly").ist_num_unknowns(domain.nx, domain.ny, code))


def assemble_csr_native(domain) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(row_map, entries, values) of a gamma/rect domain or a 3D box; None
    for a custom mask, which the engine does not cover."""
    if hasattr(domain, "nz"):
        lib = load("assembly")
        n = (domain.nx - 1) * (domain.ny - 1) * (domain.nz - 1)
        cap = 7 * n
        row_map = np.zeros(n + 1, dtype=np.int64)
        entries = np.zeros(cap, dtype=np.int64)
        values = np.zeros(cap, dtype=np.float64)
        nnz = int(lib.ist_assemble_csr3d(
            domain.nx, domain.ny, domain.nz, float(domain.coeff_diag), float(domain.coeff_x),
            float(domain.coeff_y), float(domain.coeff_z), cap, row_map, entries, values))
    else:
        code = _shape_code(domain)
        if code is None:
            return None
        lib = load("assembly")
        n = int(lib.ist_num_unknowns(domain.nx, domain.ny, code))
        cap = 5 * n
        row_map = np.zeros(n + 1, dtype=np.int64)
        entries = np.zeros(cap, dtype=np.int64)
        values = np.zeros(cap, dtype=np.float64)
        nnz = int(lib.ist_assemble_csr(
            domain.nx, domain.ny, code, float(domain.coeff_diag), float(domain.coeff_x),
            float(domain.coeff_y), cap, row_map, entries, values))
    if nnz < 0:
        raise RuntimeError(f"native assembly overflowed its {cap}-entry buffer")
    return row_map, entries[:nnz], values[:nnz]


def node_coords_native(domain) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(x, y) of each unknown of a gamma/rect domain; None for the others."""
    n = num_unknowns_native(domain)
    if n is None:
        return None
    xs = np.zeros(n, dtype=np.float64)
    ys = np.zeros(n, dtype=np.float64)
    load("assembly").ist_node_coords(
        domain.nx, domain.ny, _shape_code(domain), float(domain.x0), float(domain.x1),
        float(domain.y0), float(domain.y1), xs, ys)
    return xs, ys


# --- bulk text IO (textio.cpp) --------------------------------------------


def format_doubles(values) -> bytes:
    """One ``%.17e`` line per value (the bytes of Python's ``f"{x:.17e}\\n"``)."""
    v = np.ascontiguousarray(np.asarray(values, dtype=np.float64).ravel())
    cap = 32 * max(len(v), 1)
    buf = ctypes.create_string_buffer(cap)
    n = int(load("textio").ist_format_doubles(v, len(v), buf, cap))
    if n < 0:
        raise RuntimeError("native format_doubles overflowed its buffer")
    return buf.raw[:n]


def format_xyz(x, y, z) -> bytes:
    """gnuplot ``x y z`` lines, ``%.17e`` each."""
    xs, ys, zs = (np.ascontiguousarray(np.asarray(a, np.float64).ravel()) for a in (x, y, z))
    n = min(len(xs), len(ys), len(zs))
    cap = 96 * max(n, 1)
    buf = ctypes.create_string_buffer(cap)
    w = int(load("textio").ist_format_xyz(xs, ys, zs, n, buf, cap))
    if w < 0:
        raise RuntimeError("native format_xyz overflowed its buffer")
    return buf.raw[:w]


def parse_doubles(text: bytes, cap: int) -> Tuple[np.ndarray, int]:
    """(values, bytes consumed) parsed from the head of ``text``; stops at the
    first token that is not a number (a section header)."""
    out = np.zeros(max(cap, 1), dtype=np.float64)
    consumed = ctypes.c_int64(0)
    n = int(load("textio").ist_parse_doubles(text, len(text), out, cap, ctypes.byref(consumed)))
    return out[:n], int(consumed.value)
