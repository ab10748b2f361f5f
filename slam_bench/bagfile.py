"""A plain rosbag V2.0 writer and reader, and the two message types the
benchmark's bags carry: sensor_msgs/PointCloud2 and nav_msgs/Odometry.

The writer lays a bag out as ROS 1 does: the magic line, a bag header record
padded to 4096 bytes, and one uncompressed chunk holding the connection
records and the messages (no index records).  The reader walks the same
records back.  Both are the benchmark's own, so that a change to the
program's bag code can change neither the traffic nor the reference's
decoding of it.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"
OP_MSG, OP_BAG_HEADER, OP_CHUNK, OP_CONNECTION = 0x02, 0x03, 0x05, 0x07
MD5 = {"sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
       "nav_msgs/Odometry": "cd5e73d190d741a2f92e81eda573aca7"}
# sensor_msgs/PointField datatype codes.
FIELD_TYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4", 7: "f4", 8: "f8"}


def ros_time(t: float) -> Tuple[int, int]:
    secs = int(t)
    return secs, int(round((t - secs) * 1e9))


def _header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        body = name + b"=" + value
        out += struct.pack("<I", len(body)) + body
    return out


def _record(fields: Dict[bytes, bytes], data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def std_header(stamp: float, frame_id: str) -> bytes:
    return struct.pack("<III", 0, *ros_time(stamp)) + _string(frame_id)


def pointcloud2(stamp: float, frame_id: str, height: int, width: int,
                fields: List[Tuple[str, int, int]], point_step: int, body: bytes) -> bytes:
    """A PointCloud2 message; ``fields`` are (name, offset, datatype code)."""
    out = bytearray(std_header(stamp, frame_id))
    out += struct.pack("<III", height, width, len(fields))
    for name, offset, code in fields:
        out += _string(name) + struct.pack("<IBI", offset, code, 1)
    out += struct.pack("<BII", 0, point_step, point_step * width)
    out += struct.pack("<I", len(body)) + body + struct.pack("<B", 1)
    return bytes(out)


def odometry(stamp: float, T: np.ndarray, quaternion, frame_id: str = "odom",
             child_frame_id: str = "base") -> bytes:
    """A nav_msgs/Odometry message with the pose T (its translation and the
    quaternion (qx, qy, qz, qw) given) and zero covariances and twist."""
    out = bytearray(std_header(stamp, frame_id))
    out += _string(child_frame_id)
    out += struct.pack("<3d", *[float(v) for v in np.asarray(T, np.float64)[:3, 3]])
    out += struct.pack("<4d", *[float(q) for q in quaternion])
    out += bytes(8 * (36 + 6 + 36))
    return bytes(out)


class BagWriter:
    """Collects messages and writes the bag on ``close``."""

    def __init__(self, path: str):
        self.path = path
        self._conns: Dict[str, int] = {}
        self._chunk: List[bytes] = []

    def write(self, topic: str, datatype: str, stamp: float, payload: bytes) -> None:
        if topic not in self._conns:
            conn = len(self._conns)
            self._conns[topic] = conn
            self._chunk.append(_record(
                {b"op": bytes([OP_CONNECTION]), b"conn": struct.pack("<I", conn),
                 b"topic": topic.encode()},
                _header({b"topic": topic.encode(), b"type": datatype.encode(),
                         b"md5sum": MD5.get(datatype, "*").encode(),
                         b"message_definition": b""})))
        self._chunk.append(_record(
            {b"op": bytes([OP_MSG]), b"conn": struct.pack("<I", self._conns[topic]),
             b"time": struct.pack("<II", *ros_time(stamp))}, payload))

    def close(self) -> None:
        fields = {b"op": bytes([OP_BAG_HEADER]), b"index_pos": struct.pack("<Q", 0),
                  b"conn_count": struct.pack("<I", len(self._conns)),
                  b"chunk_count": struct.pack("<I", 1)}
        pad = 4096 - len(_header(fields)) - 4 - len(b"padding=")
        fields[b"padding"] = b" " * max(pad, 0)
        size = sum(len(p) for p in self._chunk)
        chunk_header = _header({b"op": bytes([OP_CHUNK]), b"compression": b"none",
                                b"size": struct.pack("<I", size)})
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.write(_record(fields, b""))
            f.write(struct.pack("<I", len(chunk_header)) + chunk_header
                    + struct.pack("<I", size))
            f.writelines(self._chunk)
        self._chunk = []


def _parse_header(buf) -> Dict[bytes, bytes]:
    out, pos = {}, 0
    while pos < len(buf):
        (n,) = struct.unpack_from("<I", buf, pos)
        name, _, value = bytes(buf[pos + 4:pos + 4 + n]).partition(b"=")
        out[name] = value
        pos += 4 + n
    return out


def _records(buf, start: int, end: int):
    pos = start
    while pos < end:
        (hl,) = struct.unpack_from("<I", buf, pos)
        header = _parse_header(buf[pos + 4:pos + 4 + hl])
        pos += 4 + hl
        (dl,) = struct.unpack_from("<I", buf, pos)
        yield header, pos + 4, dl
        pos += 4 + dl


def read_messages(path: str, topics=None) -> Iterator[Tuple[str, float, memoryview]]:
    """(topic, record time, raw message) in time order, stable."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise ValueError(f"{path}: not a rosbag V2.0 file")
    buf = memoryview(data)
    conns: Dict[int, str] = {}
    out = []

    def walk(start, end):
        for header, at, n in _records(buf, start, end):
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                conns[struct.unpack("<I", header[b"conn"])[0]] = header[b"topic"].decode()
            elif op == OP_CHUNK:
                if header.get(b"compression", b"none") != b"none":
                    raise ValueError(f"{path}: compressed chunks are not read here")
                walk(at, at + n)
            elif op == OP_MSG:
                topic = conns[struct.unpack("<I", header[b"conn"])[0]]
                if topics is None or topic in topics:
                    secs, nsecs = struct.unpack("<II", header[b"time"])
                    out.append((topic, secs + nsecs * 1e-9, buf[at:at + n]))

    walk(len(MAGIC), len(buf))
    out.sort(key=lambda m: m[1])
    return iter(out)


class _Cursor:
    def __init__(self, buf):
        self.buf, self.pos = buf, 0

    def take(self, fmt: str):
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return vals

    def string(self) -> str:
        (n,) = self.take("<I")
        s = bytes(self.buf[self.pos:self.pos + n]).decode()
        self.pos += n
        return s

    def stamp(self) -> float:
        _, secs, nsecs = self.take("<III")
        self.string()
        return secs + nsecs * 1e-9


def message_stamp(raw) -> float:
    """The header stamp of a message that starts with a std_msgs/Header."""
    return _Cursor(raw).stamp()


def decode_pointcloud2(raw) -> Tuple[float, Dict[str, np.ndarray]]:
    """(header stamp, one array per field)."""
    c = _Cursor(raw)
    stamp = c.stamp()
    height, width, n_fields = c.take("<III")
    fields = []
    for _ in range(n_fields):
        name = c.string()
        offset, code, count = c.take("<IBI")
        fields.append((name, offset, FIELD_TYPES[code], count))
    _, point_step, _ = c.take("<BII")
    (n_bytes,) = c.take("<I")
    body = raw[c.pos:c.pos + n_bytes]
    dt = np.dtype({"names": [f[0] for f in fields], "formats": [f[2] for f in fields],
                   "offsets": [f[1] for f in fields], "itemsize": point_step})
    rec = np.frombuffer(body, dt, count=height * width)
    return stamp, {f[0]: np.ascontiguousarray(rec[f[0]]) for f in fields}


def decode_odometry(raw) -> Tuple[float, np.ndarray, np.ndarray]:
    """(header stamp, position f64[3], quaternion f64[4] as x, y, z, w)."""
    c = _Cursor(raw)
    stamp = c.stamp()
    c.string()
    px, py, pz, qx, qy, qz, qw = c.take("<7d")
    return stamp, np.array([px, py, pz]), np.array([qx, qy, qz, qw])
