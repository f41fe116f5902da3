"""PLY reading and writing with numpy, in place of ``plyfile``.

``read_ply`` takes the ``ascii``, ``binary_little_endian`` and
``binary_big_endian`` formats, scalar properties of every PLY type and list
properties (ScanNet's ``face`` element: ``property list uchar int
vertex_indices``). It returns, per element, its properties as arrays in the
file's order: a scalar property as (N,), a list property as (N, L) when
every row's list has L items (one read of the whole element), else as an
object array of per-row arrays. ``write_ply`` writes binary little-endian
files of such elements (the synthetic raw scans' meshes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_NAMES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort", "i4": "int",
          "u4": "uint", "f4": "float", "f8": "double"}


def _header(data: bytes, path: str):
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError(f"{path}: not a PLY file")
    body = data.index(b"\n", end) + 1
    fmt, elements = None, []
    for line in data[:end].decode("ascii", "replace").splitlines()[1:]:
        words = line.split()
        if not words or words[0] in ("comment", "obj_info"):
            continue
        if words[0] == "format":
            fmt = words[1]
        elif words[0] == "element":
            elements.append((words[1], int(words[2]), []))
        elif words[0] == "property":
            if not elements:
                raise ValueError(f"{path}: PLY property before any element")
            try:
                if words[1] == "list":
                    prop = (words[4], (_TYPES[words[2]], _TYPES[words[3]]))
                else:
                    prop = (words[2], _TYPES[words[1]])
            except KeyError as e:
                raise ValueError(f"{path}: PLY property type {e.args[0]!r}") from None
            elements[-1][2].append(prop)
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"{path}: PLY format {fmt!r}")
    return fmt, elements, body


def _native(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` in the machine's byte order."""
    return a.astype(a.dtype.newbyteorder("="))


def _binary_element(buf: bytes, pos: int, count: int, props, order: str, path: str):
    """One element's rows from ``buf`` at ``pos``: (arrays, next pos)."""
    lists = [i for i, (_, t) in enumerate(props) if isinstance(t, tuple)]
    scalar_dtype = lambda t: np.dtype(order + t)  # noqa: E731
    if not lists:
        dtype = np.dtype([(name, scalar_dtype(t)) for name, t in props])
        rows = np.frombuffer(buf, dtype, count, pos)
        return {name: _native(rows[name]) for name, _ in props}, pos + count * dtype.itemsize
    # every list as long as the first row's: one structured read, then checked
    fields, off = [], pos
    for name, t in props:
        if isinstance(t, tuple):
            n = int(np.frombuffer(buf, scalar_dtype(t[0]), 1, off)[0]) if count else 0
            fields.append((name + "#n", scalar_dtype(t[0])))
            fields.append((name, scalar_dtype(t[1]), (n,)))
            off += scalar_dtype(t[0]).itemsize + n * scalar_dtype(t[1]).itemsize
        else:
            fields.append((name, scalar_dtype(t)))
            off += scalar_dtype(t).itemsize
    dtype = np.dtype(fields)
    if pos + count * dtype.itemsize <= len(buf):
        rows = np.frombuffer(buf, dtype, count, pos)
        if all((rows[props[i][0] + "#n"] == dtype[props[i][0]].shape[0]).all() for i in lists):
            return ({name: _native(rows[name]) for name, _ in props},
                    pos + count * dtype.itemsize)
    # rows of several list lengths: one row at a time
    cols = {name: [] for name, _ in props}
    for _ in range(count):
        for name, t in props:
            if isinstance(t, tuple):
                ct, it = scalar_dtype(t[0]), scalar_dtype(t[1])
                n = int(np.frombuffer(buf, ct, 1, pos)[0])
                pos += ct.itemsize
                cols[name].append(_native(np.frombuffer(buf, it, n, pos)))
                pos += n * it.itemsize
            else:
                st = scalar_dtype(t)
                cols[name].append(np.frombuffer(buf, st, 1, pos)[0])
                pos += st.itemsize
    if pos > len(buf):
        raise ValueError(f"{path}: PLY data ends inside an element")
    out = {}
    for name, t in props:
        if isinstance(t, tuple):
            arr = np.empty(count, object)
            arr[:] = cols[name]
            out[name] = arr
        else:
            out[name] = np.asarray(cols[name], np.dtype(t))
    return out, pos


def _ascii_elements(text: str, elements):
    lines = iter(text.splitlines())
    out = {}
    for name, count, props in elements:
        rows = [next(lines).split() for _ in range(count)]
        cols = {p: [] for p, _ in props}
        for row in rows:
            i = 0
            for p, t in props:
                if isinstance(t, tuple):
                    n = int(row[i])
                    cols[p].append(np.asarray(row[i + 1:i + 1 + n], np.dtype(t[1])))
                    i += 1 + n
                else:
                    cols[p].append(row[i])
                    i += 1
        el = {}
        for p, t in props:
            if isinstance(t, tuple):
                lens = {len(v) for v in cols[p]}
                if len(lens) <= 1:
                    el[p] = np.asarray(cols[p], np.dtype(t[1])).reshape(count, -1)
                else:
                    arr = np.empty(count, object)
                    arr[:] = cols[p]
                    el[p] = arr
            else:
                el[p] = np.asarray(cols[p], np.float64).astype(np.dtype(t))
        out[name] = el
    return out


def read_ply(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Element name -> property name -> array (the module docstring says
    how list properties come back)."""
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, body = _header(data, path)
    if fmt == "ascii":
        return _ascii_elements(data[body:].decode("ascii"), elements)
    order = "<" if fmt == "binary_little_endian" else ">"
    out, pos = {}, body
    for name, count, props in elements:
        out[name], pos = _binary_element(data, pos, count, props, order, path)
    return out


def write_ply(path: str, elements: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Binary little-endian PLY of ``elements`` (name -> property -> array,
    in order). A 2-D property is written as a list of its row length, its
    count as uchar."""
    header = ["ply", "format binary_little_endian 1.0"]
    blocks = []
    for name, props in elements.items():
        arrays = {p: np.asarray(a) for p, a in props.items()}
        count = len(next(iter(arrays.values())))
        header.append(f"element {name} {count}")
        fields = []
        for p, a in arrays.items():
            t = a.dtype.newbyteorder("<").str[1:]
            if a.ndim == 2:
                header.append(f"property list uchar {_NAMES[t]} {p}")
                fields += [(p + "#n", "u1"), (p, "<" + t, (a.shape[1],))]
            else:
                header.append(f"property {_NAMES[t]} {p}")
                fields.append((p, "<" + t))
        rows = np.empty(count, np.dtype(fields))
        for p, a in arrays.items():
            if a.ndim == 2:
                rows[p + "#n"] = a.shape[1]
            rows[p] = a
        blocks.append(rows.tobytes())
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        for b in blocks:
            f.write(b)
