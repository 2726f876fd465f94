"""Minimal rosbag-v1 (\"#ROSBAG V2.0\") reader/writer for
sensor_msgs/PointCloud2 — ROS-free real-data ingestion.

The reference's validation flow replays a recorded campus rosbag through the
node (reference README.md:36-46).  This module lets the replay harness
consume the same .bag files without any ROS installation (VERDICT r2 item
2): a sequential record scan that understands bag-header/connection/chunk/
message-data records, none/bz2 chunk compression, and deserializes
PointCloud2 into the (N, 4) float32 [x, y, z, intensity] arrays the
pipeline eats.

Format notes (docs.ros.org rosbag/Format):
  * file = "#ROSBAG V2.0\\n" + records; record = u32 hlen + header fields +
    u32 dlen + data; header field = u32 flen + name + '=' + value.
  * op codes: 0x03 bag header (padded to 4 KB), 0x05 chunk (embedded
    records, possibly compressed), 0x07 connection, 0x02 message data,
    0x04 index data, 0x06 chunk info (both index types are skipped — a
    sequential reader needs no index).
  * PointCloud2 wire format: Header (u32 seq, u32 sec, u32 nsec, string
    frame_id), u32 height, u32 width, PointField[] (string name, u32
    offset, u8 datatype, u32 count), u8 is_bigendian, u32 point_step,
    u32 row_step, u8[] data, u8 is_dense.

The writer emits a valid chunked (compression=none) bag with index/chunk-
info records, so files round-trip through real rosbag tooling; it exists to
build fixtures from PCD/NPZ scans (tools/make_bag.py) and for tests.

A copy of the JAX package's io/rosbag.py (numpy only), which the port
carries so that it imports nothing of that package
(tests/test_torch_io.py holds it to the original, bytes and arrays).
"""

from __future__ import annotations

import bz2
import struct
from typing import Iterator, Optional

import numpy as np

__all__ = ["read_bag", "bag_topics", "write_bag", "BagFormatError"]

_MAGIC = b"#ROSBAG V2.0\n"
_PC2_TYPE = "sensor_msgs/PointCloud2"

# PointField datatypes (sensor_msgs/PointField).
_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
           7: "f4", 8: "f8"}


class BagFormatError(ValueError):
    pass


# ---------------------------------------------------------------- low level
def _parse_header(buf: bytes) -> dict:
    fields = {}
    at = 0
    while at < len(buf):
        (flen,) = struct.unpack_from("<I", buf, at)
        at += 4
        field = buf[at:at + flen]
        at += flen
        eq = field.index(b"=")
        fields[field[:eq].decode()] = field[eq + 1:]
    return fields


def _read_record(f) -> Optional[tuple]:
    head = f.read(4)
    if len(head) < 4:
        return None
    (hlen,) = struct.unpack("<I", head)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    return header, dlen


def _records_in(buf: bytes):
    """Records embedded in a decompressed chunk payload."""
    at = 0
    n = len(buf)
    while at < n:
        (hlen,) = struct.unpack_from("<I", buf, at)
        at += 4
        header = _parse_header(buf[at:at + hlen])
        at += hlen
        (dlen,) = struct.unpack_from("<I", buf, at)
        at += 4
        yield header, buf[at:at + dlen]
        at += dlen


def _u8(h, k):
    return h[k][0]


def _u32(h, k):
    return struct.unpack("<I", h[k][:4])[0]


# ---------------------------------------------------------------- messages
def _parse_pointcloud2(data: bytes) -> np.ndarray:
    """PointCloud2 bytes -> (N, 4) float32 [x, y, z, intensity] (intensity 0
    when the cloud has none)."""
    at = 0

    def u32():
        nonlocal at
        (v,) = struct.unpack_from("<I", data, at)
        at += 4
        return v

    def u8():
        nonlocal at
        v = data[at]
        at += 1
        return v

    u32()  # header.seq
    at += 8  # stamp
    # NOTE: not `at += u32()` — the augmented assignment reads `at` BEFORE
    # u32() bumps it, silently undoing the length-prefix advance.
    flen = u32()
    at += flen  # frame_id
    height, width = u32(), u32()
    fields = []
    for _ in range(u32()):
        nlen = u32()
        name = data[at:at + nlen].decode()
        at += nlen
        off, dt, cnt = u32(), u8(), u32()
        fields.append((name, off, dt, cnt))
    big = u8() != 0
    if big:
        raise BagFormatError("big-endian PointCloud2 not supported")
    point_step, _row_step = u32(), u32()
    dlen = u32()
    payload = data[at:at + dlen]
    at += dlen
    # trailing is_dense ignored

    n = height * width
    if n == 0 or point_step == 0:
        return np.zeros((0, 4), np.float32)
    raw = np.frombuffer(payload, np.uint8)
    if len(raw) < n * point_step:
        n = len(raw) // point_step
    raw = raw[:n * point_step].reshape(n, point_step)

    def col(name):
        for fname, off, dt, _cnt in fields:
            if fname == name:
                code = _DTYPES.get(dt)
                if code is None:
                    raise BagFormatError(f"PointField datatype {dt}")
                w = int(code[1])
                return raw[:, off:off + w].copy().view("<" + code)[:, 0]
        return None

    out = np.zeros((n, 4), np.float32)
    for i, name in enumerate(("x", "y", "z", "intensity")):
        c = col(name)
        if c is not None:
            out[:, i] = c.astype(np.float32)
        elif name != "intensity":
            raise BagFormatError(f"PointCloud2 missing field {name!r}")
    return out


def _decompress(payload: bytes, kind: bytes) -> bytes:
    if kind in (b"none", b""):
        return payload
    if kind == b"bz2":
        return bz2.decompress(payload)
    raise BagFormatError(f"unsupported chunk compression {kind!r}")


# ---------------------------------------------------------------- reading
def _scan(path: str):
    """Yield (op, header, data) for every record, descending into chunks."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise BagFormatError(f"not a v2.0 rosbag: {path!r}")
        while True:
            rec = _read_record(f)
            if rec is None:
                return
            header, dlen = rec
            op = _u8(header, "op")
            if op == 0x05:  # chunk: parse embedded records
                payload = _decompress(f.read(dlen),
                                      header.get("compression", b"none"))
                for h2, d2 in _records_in(payload):
                    yield _u8(h2, "op"), h2, d2
            elif op == 0x02 or op == 0x07:
                yield op, header, f.read(dlen)
            else:  # bag header (0x03), index (0x04), chunk info (0x06)
                f.seek(dlen, 1)


def bag_topics(path: str) -> dict:
    """{topic: message type} for every connection in the bag."""
    out = {}
    for op, header, data in _scan(path):
        if op == 0x07:
            conn_hdr = _parse_header(data)
            out[header["topic"].decode()] = conn_hdr.get("type", b"?").decode()
    return out


def read_bag(path: str, topic: Optional[str] = None) -> Iterator[np.ndarray]:
    """Yield (N, 4) float32 scans from a bag's PointCloud2 stream in record
    order.  `topic=None` auto-selects the first PointCloud2 connection
    (the reference subscribes to exactly one topic, main.cpp params)."""
    conns = {}  # conn id -> (topic, type)
    chosen = topic
    for op, header, data in _scan(path):
        if op == 0x07:
            cid = _u32(header, "conn")
            conn_hdr = _parse_header(data)
            ctopic = header["topic"].decode()
            ctype = conn_hdr.get("type", b"").decode()
            conns[cid] = (ctopic, ctype)
        elif op == 0x02:
            cid = _u32(header, "conn")
            ctopic, ctype = conns.get(cid, (None, None))
            if ctype != _PC2_TYPE:
                continue
            if chosen is None:
                chosen = ctopic
            if ctopic == chosen:
                yield _parse_pointcloud2(data)


# ---------------------------------------------------------------- writing
def _header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _ser_pointcloud2(pts: np.ndarray, seq: int, stamp: tuple,
                     frame: str) -> bytes:
    pts = np.ascontiguousarray(pts, np.float32)
    n = pts.shape[0]
    if pts.shape[1] < 4:
        pts = np.concatenate(
            [pts, np.zeros((n, 4 - pts.shape[1]), np.float32)], axis=1)
    buf = struct.pack("<I2I", seq, *stamp)
    buf += struct.pack("<I", len(frame)) + frame.encode()
    buf += struct.pack("<II", 1, n)  # height=1, width=n
    buf += struct.pack("<I", 4)
    for i, name in enumerate(("x", "y", "z", "intensity")):
        buf += struct.pack("<I", len(name)) + name.encode()
        buf += struct.pack("<IBI", 4 * i, 7, 1)  # offset, FLOAT32, count
    buf += struct.pack("<B", 0)  # little-endian
    buf += struct.pack("<II", 16, 16 * n)  # point_step, row_step
    buf += struct.pack("<I", 16 * n) + pts[:, :4].tobytes()
    buf += struct.pack("<B", 1)  # is_dense
    return buf


def write_bag(path: str, scans, topic: str = "/points",
              frame: str = "lidar", rate_hz: float = 10.0) -> None:
    """Write scans ((N, >=3) arrays) as one chunked, uncompressed
    PointCloud2 bag (with index/chunk-info records: real rosbag tools can
    open it)."""
    scans = list(scans)
    conn_id = 0
    chunks = []
    msg_times = []
    for i, pts in enumerate(scans):
        sec = 1 + int(i / rate_hz)
        nsec = int((i / rate_hz) % 1.0 * 1e9)
        msg_times.append((sec, nsec))

    conn_hdr_inner = _header({
        "topic": topic.encode(),
        "type": _PC2_TYPE.encode(),
        "md5sum": b"1158d486dd51d683ce2f1be655c3c181",
        "message_definition": b"",
    })
    conn_rec = _record(
        {"op": b"\x07", "conn": struct.pack("<I", conn_id),
         "topic": topic.encode()}, conn_hdr_inner)

    payload = conn_rec
    for i, pts in enumerate(scans):
        sec, nsec = msg_times[i]
        msg = _ser_pointcloud2(np.asarray(pts), i, (sec, nsec), frame)
        payload += _record(
            {"op": b"\x02", "conn": struct.pack("<I", conn_id),
             "time": struct.pack("<II", sec, nsec)}, msg)
    chunks.append(payload)

    with open(path, "wb") as f:
        f.write(_MAGIC)
        # Bag header (op=0x03), padded to 4096 bytes with spaces.
        t0 = msg_times[0] if msg_times else (0, 0)
        tn = msg_times[-1] if msg_times else (0, 0)
        bh_fields = {"op": b"\x03", "index_pos": struct.pack("<Q", 0),
                     "conn_count": struct.pack("<I", 1),
                     "chunk_count": struct.pack("<I", len(chunks))}
        h = _header(bh_fields)
        pad = 4096 - 4 - len(h) - 4
        f.write(struct.pack("<I", len(h)) + h
                + struct.pack("<I", pad) + b" " * pad)

        chunk_pos = []
        for payload in chunks:
            chunk_pos.append(f.tell())
            f.write(_record({"op": b"\x05", "compression": b"none",
                             "size": struct.pack("<I", len(payload))},
                            payload))
            # Index data (op=0x04): (sec, nsec, offset-in-chunk) per message.
            # Offsets point at each embedded message-data record.
            offsets = []
            at = 0
            while at < len(payload):
                (hlen,) = struct.unpack_from("<I", payload, at)
                h2 = _parse_header(payload[at + 4:at + 4 + hlen])
                (dlen,) = struct.unpack_from("<I", payload, at + 4 + hlen)
                if _u8(h2, "op") == 0x02:
                    offsets.append(at)
                at += 4 + hlen + 4 + dlen
            idx = b"".join(
                struct.pack("<III", *msg_times[i], offsets[i])
                for i in range(len(scans)))
            f.write(_record({"op": b"\x04", "ver": struct.pack("<I", 1),
                             "conn": struct.pack("<I", conn_id),
                             "count": struct.pack("<I", len(scans))}, idx))

        index_pos = f.tell()
        f.write(conn_rec)
        for pos in chunk_pos:
            f.write(_record(
                {"op": b"\x06", "ver": struct.pack("<I", 1),
                 "chunk_pos": struct.pack("<Q", pos),
                 "start_time": struct.pack("<II", *t0),
                 "end_time": struct.pack("<II", *tn),
                 "count": struct.pack("<I", 1)},
                struct.pack("<II", conn_id, len(scans))))
        # Rewrite the bag header with the real index_pos.
        f.seek(len(_MAGIC))
        bh_fields["index_pos"] = struct.pack("<Q", index_pos)
        h = _header(bh_fields)
        pad = 4096 - 4 - len(h) - 4
        f.seek(len(_MAGIC))
        f.write(struct.pack("<I", len(h)) + h
                + struct.pack("<I", pad) + b" " * pad)
