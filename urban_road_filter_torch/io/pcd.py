"""PCD (Point Cloud Data) file I/O.

Replaces the reference's PCL/rosbag input path (SURVEY.md section 0) with a
dependency-free reader/writer for the PCD v0.7 format (ascii and binary),
plus NPZ scan-sequence helpers for the replay harness.  A native C++ fast
path (runtime.native) parses binary PCD about an order of magnitude faster;
this module transparently uses it when the extension is built.

A copy of the JAX package's io/pcd.py (numpy only) that calls the port's
own runtime.native; tests/test_torch_io.py holds it to the original.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Iterator, Sequence

import numpy as np

__all__ = ["read_pcd", "write_pcd", "write_scan_sequence", "read_scan_sequence"]


# ---- LZF codec (PCL's binary_compressed payload format) ----
#
# liblzf stream: control byte < 32 -> literal run of ctrl+1 bytes; else a
# back-reference of (ctrl >> 5) + 2 bytes (+1 extension byte when the top
# bits saturate at 7) at distance ((ctrl & 0x1f) << 8) + next + 1.

def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run
            run = ctrl + 1
            if i + run > n:
                raise ValueError("LZF literal run past end of input")
            out += data[i:i + run]
            i += run
        else:  # back-reference
            length = ctrl >> 5
            if length == 7:
                if i >= n:
                    raise ValueError("LZF back-reference truncated "
                                     "(missing length-extension byte)")
                length += data[i]
                i += 1
            if i >= n:
                raise ValueError("LZF back-reference truncated "
                                 "(missing distance byte)")
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("LZF back-reference before stream start")
            cnt = length + 2
            if ref + cnt <= len(out):
                # Non-overlapping: one slice extend (ADVICE r2: the
                # byte-by-byte loop made full-size compressed scans cost
                # seconds each; overlap is the rare RLE case).
                out += out[ref:ref + cnt]
            else:
                for _ in range(cnt):  # overlapping: byte-by-byte semantics
                    out.append(out[ref])
                    ref += 1
    if len(out) != expected_size:
        raise ValueError(f"LZF decompressed {len(out)} bytes, "
                         f"header declared {expected_size}")
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """Greedy hash-table LZF compressor (same stream format liblzf emits;
    any conforming decompressor — including PCL's — reads it)."""
    n = len(data)
    out = bytearray()
    lit_start = 0  # start of the pending literal run
    table: dict = {}
    i = 0

    def flush_literals(upto: int) -> None:
        j = lit_start
        while j < upto:
            run = min(32, upto - j)
            out.append(run - 1)
            out.extend(data[j:j + run])
            j += run

    while i < n - 2:
        key = data[i:i + 3]
        cand = table.get(key, -1)
        table[key] = i
        dist = i - cand - 1
        if cand >= 0 and dist < (1 << 13):
            # Extend the match (cap: 7 + 255 + 2 total).
            m = 3
            limit = min(n - i, 264)
            while m < limit and data[cand + m] == data[i + m]:
                m += 1
            flush_literals(i)
            length = m - 2
            if length < 7:
                out.append((length << 5) | (dist >> 8))
            else:
                out.append((7 << 5) | (dist >> 8))
                out.append(length - 7)
            out.append(dist & 0xFF)
            i += m
            lit_start = i
        else:
            i += 1
    flush_literals(n)
    return bytes(out)

_FIELD_DTYPES = {("F", 4): "f4", ("F", 8): "f8",
                 ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
                 ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def _parse_header(f) -> dict:
    hdr: dict = {}
    while True:
        line = f.readline()
        if not line:
            raise ValueError("truncated PCD header")
        if isinstance(line, bytes):
            line = line.decode("ascii", "replace")
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        hdr[key.upper()] = rest.split()
        if key.upper() == "DATA":
            hdr["DATA"] = rest.strip()
            return hdr


def read_pcd(path: str | os.PathLike, use_native: bool = True) -> np.ndarray:
    """Read a PCD file -> (N, 4) float32 [x, y, z, intensity].

    Missing intensity fields are zero-filled.  Supports ascii, binary and
    binary_compressed (LZF, PCL's default save format) DATA."""
    if use_native:
        try:
            from urban_road_filter_torch.runtime.native import read_pcd_native

            out = read_pcd_native(str(path))
            if out is not None:
                return out
        except Exception:
            pass  # fall through to the Python reader

    with open(path, "rb") as f:
        hdr = _parse_header(f)
        fields = hdr.get("FIELDS", [])
        sizes = [int(s) for s in hdr.get("SIZE", [])]
        types = hdr.get("TYPE", [])
        counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(fields))]
        if "POINTS" in hdr:
            n = int(hdr["POINTS"][0])
        else:  # spec-legal: WIDTH x HEIGHT without POINTS
            n = int(hdr.get("WIDTH", ["0"])[0]) * int(hdr.get("HEIGHT", ["1"])[0])
        data_kind = hdr["DATA"]

        dtype_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            base = _FIELD_DTYPES.get((typ, size))
            if base is None:
                raise ValueError(f"unsupported PCD field type {typ}{size}")
            if cnt == 1:
                dtype_fields.append((name, base))
            else:
                dtype_fields.append((name, base, (cnt,)))
        dt = np.dtype(dtype_fields)

        if data_kind == "ascii":
            raw = np.loadtxt(io.StringIO(f.read().decode("ascii", "replace")),
                             dtype=np.float64, ndmin=2)
            rec = np.zeros(raw.shape[0], dt)
            col = 0
            for name, size, typ, cnt in zip(fields, sizes, types, counts):
                take = raw[:, col:col + cnt]
                rec[name] = take[:, 0] if cnt == 1 else take
                col += cnt
        elif data_kind == "binary":
            rec = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
        elif data_kind == "binary_compressed":
            # PCL layout: u32 compressed size, u32 uncompressed size, LZF
            # blob of the cloud in structure-of-arrays order (all x values,
            # then all y values, ...).
            comp_n, raw_n = struct.unpack("<II", f.read(8))
            comp = f.read(comp_n)
            blob = None
            if use_native:
                try:
                    from urban_road_filter_torch.runtime.native import (
                        lzf_decompress_native)

                    blob = lzf_decompress_native(comp, raw_n)
                except Exception:
                    blob = None
            if blob is None:
                blob = lzf_decompress(comp, raw_n)
            rec = np.zeros(n, dt)
            off = 0
            for name, size, typ, cnt in zip(fields, sizes, types, counts):
                base = _FIELD_DTYPES[(typ, size)]
                arr = np.frombuffer(blob, dtype=base, count=n * cnt,
                                    offset=off)
                rec[name] = arr if cnt == 1 else arr.reshape(n, cnt)
                off += size * cnt * n
        else:
            raise ValueError(f"PCD DATA kind {data_kind!r} not supported")

    out = np.zeros((rec.shape[0], 4), np.float32)
    for i, name in enumerate(("x", "y", "z")):
        if name in rec.dtype.names:
            out[:, i] = rec[name].astype(np.float32)
    for cand in ("intensity", "i", "reflectivity"):
        if cand in (rec.dtype.names or ()):
            out[:, 3] = np.asarray(rec[cand], np.float32).reshape(rec.shape[0], -1)[:, 0]
            break
    return out


def write_pcd(path: str | os.PathLike, points: np.ndarray,
              binary: bool = True, compressed: bool = False) -> None:
    """Write (N, >=3) points as PCD v0.7 x/y/z/intensity.

    compressed=True emits DATA binary_compressed (PCL's default save
    format): LZF over the structure-of-arrays layout."""
    pts = np.zeros((len(points), 4), np.float32)
    pts[:, :min(4, points.shape[1])] = points[:, :4]
    n = len(pts)
    kind = "binary_compressed" if compressed else (
        "binary" if binary else "ascii")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
        f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {kind}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if compressed:
            raw = np.ascontiguousarray(pts.T).tobytes()  # SoA field-major
            comp = lzf_compress(raw)
            f.write(struct.pack("<II", len(comp), len(raw)))
            f.write(comp)
        elif binary:
            f.write(np.ascontiguousarray(pts).tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")


def write_scan_sequence(path: str | os.PathLike, scans: Sequence[np.ndarray]) -> None:
    """NPZ scan sequence: the rosbag replacement for the replay harness."""
    np.savez_compressed(path, **{f"scan_{i:06d}": s for i, s in enumerate(scans)})


def read_scan_sequence(path: str | os.PathLike) -> Iterator[np.ndarray]:
    with np.load(path) as z:
        for key in sorted(z.files):
            yield z[key]
