"""Minimal PLY I/O (twin of :mod:`tdwss.utils.ply`).

Reads the subset ScanNet uses: binary little-endian or ASCII, a vertex
element of scalar properties (float, uchar, ushort, int, ...); face
elements and list properties are skipped.  :func:`write_ply` writes
binary little-endian vertex-only files.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {
    np.dtype(np.int8): "char", np.dtype(np.uint8): "uchar",
    np.dtype(np.int16): "short", np.dtype(np.uint16): "ushort",
    np.dtype(np.int32): "int", np.dtype(np.uint32): "uint",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the vertex element of a PLY file -> {property: array}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        current: List[Tuple[str, str]] = []
        while True:
            line = f.readline().strip().decode("ascii", errors="replace")
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                current = []
                elements.append((name, int(count), current))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    current.append(("list", " ".join(parts[2:])))
                else:
                    current.append((parts[-1], parts[1]))
            elif line == "end_header":
                break
            elif line == "":
                raise ValueError(f"{path}: truncated header")

        if fmt == "ascii":
            return _read_ascii(f, elements)
        endian = "<" if fmt == "binary_little_endian" else ">"
        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                _skip_list_element(f, count, props, endian)
                continue
            dtype = np.dtype([(p, endian + _PLY_DTYPES[t]) for p, t in props])
            data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(data[p])
        return out


def _read_ascii(f, elements) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, count, props in elements:
        rows = [f.readline().split() for _ in range(count)]
        if name != "vertex" or any(p[0] == "list" for p in props):
            continue
        arr = np.asarray(rows, np.float64)
        for j, (p, t) in enumerate(props):
            out[p] = arr[:, j].astype(_PLY_DTYPES[t])
    return out


def _skip_list_element(f, count, props, endian) -> None:
    # faces: (count_type, item_type) list per row — parse row-by-row
    for spec_name, spec in props:
        if spec_name != "list":
            raise ValueError("mixed list/scalar elements unsupported")
        count_t, item_t = spec.split()[:2]
        cdt = np.dtype(endian + _PLY_DTYPES[count_t])
        idt = np.dtype(endian + _PLY_DTYPES[item_t])
        for _ in range(count):
            n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
            f.read(idt.itemsize * n)


def write_ply(path: str, arrays: Sequence[np.ndarray],
              names: Sequence[str]) -> bool:
    """Write vertex arrays as binary-little-endian PLY.

    ``arrays`` are (N,) or (N, K) columns; ``names`` has one name per total
    column (reference utils/ply.py write_ply interface).
    """
    cols: List[np.ndarray] = []
    for arr in arrays:
        arr = np.asarray(arr)
        if arr.ndim == 1:
            cols.append(arr)
        else:
            cols.extend(arr[:, i] for i in range(arr.shape[1]))
    if len(cols) != len(names):
        raise ValueError(f"{len(cols)} columns but {len(names)} names")
    n = cols[0].shape[0]
    dtype = np.dtype([
        (name, "<" + _PLY_DTYPES[_INV_DTYPES[c.dtype]])
        for name, c in zip(names, cols)
    ])
    rec = np.empty(n, dtype)
    for name, c in zip(names, cols):
        rec[name] = c
    if not path.endswith(".ply"):
        path += ".ply"
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name, c in zip(names, cols):
            f.write(f"property {_INV_DTYPES[c.dtype]} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
    return True
