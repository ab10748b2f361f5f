"""Pure-Python rosbag (V2.0) reader and writer with ROS1 message codecs.

Counterpart of the JAX package's ``frontends/rosbag.py``, a copy of its
numpy decoding (reference RosbagRangeDataProcessorRos.cpp:28-1162): iterate
a recorded bag, deserialize PointCloud2 / Odometry / PoseStamped /
PoseWithCovarianceStamped / Imu / TFMessage / Clock messages, pair each
cloud with its odometry pose through the interpolation buffer, and feed
the replay runner.  The typed PointCloud2 -> array conversion mirrors
pointmatcher_ros::RosPointCloud2Deserializer
(pointmatcher_ros/src/RosPointCloud2Deserializer.cpp) and
open3d_conversions (open3d_conversions.cpp:21-120).

Decoding stays on the host; a decoded cloud goes to its device in one
pinned copy (``utils/device.to_device``).  No ROS installation is needed:
the bag container and the fixed message layouts are parsed directly
(little-endian, the public ROS1 serialization rules).  Compression: none
and bz2 (stdlib); lz4 where the optional ``lz4`` package is present.
"""
from __future__ import annotations

import bz2
import dataclasses
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import timing
from ..utils.device import to_device
from ..utils.pointcloud import PointCloud, make_cloud
from ..utils.timebuf import TransformInterpolationBuffer

_MAGIC = b"#ROSBAG V2.0\n"

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONNECTION = 0x07

# sensor_msgs/PointField datatype codes -> numpy dtypes.
_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
              7: "f4", 8: "f8"}
_PF_CODES = {v: k for k, v in _PF_DTYPES.items()}


# ---------------------------------------------------------------------------
# Low-level record framing
# ---------------------------------------------------------------------------

def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    pos = 0
    while pos < len(buf):
        (flen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        field = buf[pos:pos + flen]
        pos += flen
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        body = name + b"=" + value
        out += struct.pack("<I", len(body)) + body
    return out


def _read_record(buf: bytes, pos: int) -> Tuple[Dict[bytes, bytes], bytes, int]:
    (hlen,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    header = _parse_header(buf[pos:pos + hlen])
    pos += hlen
    (dlen,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    data = buf[pos:pos + dlen]
    return header, data, pos + dlen


def _ros_time(secs: int, nsecs: int) -> float:
    return secs + nsecs * 1e-9


def _split_ros_time(t: float) -> Tuple[int, int]:
    secs = int(t)
    return secs, int(round((t - secs) * 1e9))


# ---------------------------------------------------------------------------
# Message deserialization (ROS1 little-endian wire format)
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v

    def f64s(self, n):
        v = np.frombuffer(self.buf, "<f8", count=n, offset=self.pos)
        self.pos += 8 * n
        return np.asarray(v)

    def string(self):
        n = self.u32()
        s = self.buf[self.pos:self.pos + n].decode("utf-8", "replace")
        self.pos += n
        return s

    def time(self):
        return _ros_time(self.u32(), self.u32())

    def raw(self, n):
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b


@dataclasses.dataclass
class Header:
    seq: int
    stamp: float
    frame_id: str


def _read_std_header(c: _Cursor) -> Header:
    return Header(seq=c.u32(), stamp=c.time(), frame_id=c.string())


def _read_pose(c: _Cursor) -> np.ndarray:
    """geometry_msgs/Pose -> 4x4 SE(3)."""
    px, py, pz = c.f64(), c.f64(), c.f64()
    qx, qy, qz, qw = c.f64(), c.f64(), c.f64(), c.f64()
    return _pose_to_matrix(px, py, pz, qx, qy, qz, qw)


def _pose_to_matrix(px, py, pz, qx, qy, qz, qw) -> np.ndarray:
    n = qx * qx + qy * qy + qz * qz + qw * qw
    s = 0.0 if n == 0.0 else 2.0 / n
    R = np.array([
        [1 - s * (qy * qy + qz * qz), s * (qx * qy - qz * qw), s * (qx * qz + qy * qw)],
        [s * (qx * qy + qz * qw), 1 - s * (qx * qx + qz * qz), s * (qy * qz - qx * qw)],
        [s * (qx * qz - qy * qw), s * (qy * qz + qx * qw), 1 - s * (qx * qx + qy * qy)],
    ])
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = [px, py, pz]
    return T.astype(np.float32)


def _matrix_to_quat(T: np.ndarray) -> Tuple[float, float, float, float]:
    R = np.asarray(T, np.float64)[:3, :3]
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw, qx, qy, qz = 0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, \
            (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw, qx = (R[2, 1] - R[1, 2]) / s, 0.25 * s
        qy, qz = (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw, qx = (R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s
        qy, qz = 0.25 * s, (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw, qx = (R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s
        qy, qz = (R[1, 2] + R[2, 1]) / s, 0.25 * s
    return qx, qy, qz, qw


@dataclasses.dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


@dataclasses.dataclass
class PointCloud2:
    header: Header
    height: int
    width: int
    fields: List[PointField]
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Per-field float32 columns (≙ RosPointCloud2Deserializer's typed
        field extraction)."""
        n = self.height * self.width
        names, formats, offsets = [], [], []
        for f in self.fields:
            if f.datatype not in _PF_DTYPES:
                continue
            names.append(f.name)
            base = _PF_DTYPES[f.datatype]
            formats.append(base if f.count == 1 else (base, (f.count,)))
            offsets.append(f.offset)
        dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                       "itemsize": self.point_step})
        rec = np.frombuffer(self.data, dt, count=n)
        return {name: np.ascontiguousarray(rec[name]) for name in names}

    def to_pointcloud(self, capacity: Optional[int] = None, device="cuda") -> PointCloud:
        """Typed PointCloud2 -> PointCloud on ``device``, keeping the
        descriptor channels (intensity, rgb color, per-point time) as the
        reference's RosPointCloud2Deserializer does (features + normals +
        colors + intensity + time fields).  The columns go up as one
        [n, 7 + channels] block in one pinned copy; ``make_cloud`` pads it
        to ``capacity`` and raises where the scan holds more points."""
        cols = self.to_arrays()
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
        finite = np.isfinite(xyz).all(-1)
        normals = np.zeros_like(xyz)
        if all(k in cols for k in ("normal_x", "normal_y", "normal_z")):
            normals = np.stack([cols["normal_x"], cols["normal_y"],
                                cols["normal_z"]], -1).astype(np.float32)
        attrs = {}
        if "intensity" in cols:
            attrs["intensity"] = cols["intensity"].astype(np.float32).reshape(-1)
        # Per-point time: sensors name it "t" (Ouster, ns u32), "time"
        # (Velodyne, s f32), or "timestamp"; normalize to seconds from the
        # scan's first point.
        for tname in ("t", "time", "timestamp", "time_offset"):
            if tname in cols:
                t = cols[tname].astype(np.float64).reshape(-1)
                t = t - (t[finite].min() if finite.any() else 0.0)
                if t.max(initial=0.0) > 10.0:  # nanoseconds or microseconds
                    t = t / (1e9 if t.max() > 1e7 else 1e6)
                attrs["t"] = t.astype(np.float32)
                break
        if "rgb" in cols or "rgba" in cols:
            # Packed float RGB (PCL convention): reinterpret as u32.
            packed = cols.get("rgb", cols.get("rgba"))
            u = packed.astype(np.float32).reshape(-1).view(np.uint32)
            attrs["r"] = ((u >> 16) & 0xFF).astype(np.float32) / 255.0
            attrs["g"] = ((u >> 8) & 0xFF).astype(np.float32) / 255.0
            attrs["b"] = (u & 0xFF).astype(np.float32) / 255.0
        elif all(k in cols for k in ("r", "g", "b")):
            for k in ("r", "g", "b"):
                c = cols[k].astype(np.float32).reshape(-1)
                attrs[k] = c / 255.0 if c.max(initial=0.0) > 1.0 else c
        xyz = np.where(finite[:, None], xyz, 0.0)
        block = np.concatenate([xyz, normals, finite[:, None]] + [
            attrs[k][:, None] for k in attrs], axis=1).astype(np.float32)
        block = to_device(block, device)
        return make_cloud(block[:, :3], normals=block[:, 3:6], mask=block[:, 6] > 0.5,
                          capacity=capacity, device=device,
                          attrs={k: block[:, 7 + i] for i, k in enumerate(attrs)} or None)


@dataclasses.dataclass
class Odometry:
    header: Header
    child_frame_id: str
    pose: np.ndarray            # 4x4
    pose_covariance: np.ndarray  # (36,)
    twist_linear: np.ndarray
    twist_angular: np.ndarray
    twist_covariance: np.ndarray


@dataclasses.dataclass
class PoseStamped:
    header: Header
    pose: np.ndarray


@dataclasses.dataclass
class PoseWithCovarianceStamped:
    header: Header
    pose: np.ndarray
    covariance: np.ndarray


@dataclasses.dataclass
class Imu:
    header: Header
    orientation: np.ndarray          # quaternion xyzw
    angular_velocity: np.ndarray
    linear_acceleration: np.ndarray


@dataclasses.dataclass
class TransformStamped:
    header: Header
    child_frame_id: str
    transform: np.ndarray  # 4x4


@dataclasses.dataclass
class Clock:
    clock: float


def _deserialize_pointcloud2(buf: bytes) -> PointCloud2:
    c = _Cursor(buf)
    header = _read_std_header(c)
    height, width = c.u32(), c.u32()
    fields = []
    for _ in range(c.u32()):
        fields.append(PointField(name=c.string(), offset=c.u32(),
                                 datatype=c.u8(), count=c.u32()))
    is_bigendian = bool(c.u8())
    point_step, row_step = c.u32(), c.u32()
    data = c.raw(c.u32())
    is_dense = bool(c.u8())
    return PointCloud2(header, height, width, fields, is_bigendian,
                       point_step, row_step, data, is_dense)


def _deserialize_odometry(buf: bytes) -> Odometry:
    c = _Cursor(buf)
    header = _read_std_header(c)
    child = c.string()
    pose = _read_pose(c)
    pose_cov = c.f64s(36)
    lin = np.array([c.f64(), c.f64(), c.f64()])
    ang = np.array([c.f64(), c.f64(), c.f64()])
    twist_cov = c.f64s(36)
    return Odometry(header, child, pose, pose_cov, lin, ang, twist_cov)


def _deserialize_pose_stamped(buf: bytes) -> PoseStamped:
    c = _Cursor(buf)
    return PoseStamped(_read_std_header(c), _read_pose(c))


def _deserialize_pose_cov_stamped(buf: bytes) -> PoseWithCovarianceStamped:
    c = _Cursor(buf)
    header = _read_std_header(c)
    pose = _read_pose(c)
    return PoseWithCovarianceStamped(header, pose, c.f64s(36))


def _deserialize_imu(buf: bytes) -> Imu:
    c = _Cursor(buf)
    header = _read_std_header(c)
    quat = np.array([c.f64(), c.f64(), c.f64(), c.f64()])
    c.f64s(9)
    ang = np.array([c.f64(), c.f64(), c.f64()])
    c.f64s(9)
    acc = np.array([c.f64(), c.f64(), c.f64()])
    c.f64s(9)
    return Imu(header, quat, ang, acc)


def _deserialize_tf(buf: bytes) -> List[TransformStamped]:
    c = _Cursor(buf)
    out = []
    for _ in range(c.u32()):
        header = _read_std_header(c)
        child = c.string()
        tx, ty, tz = c.f64(), c.f64(), c.f64()
        qx, qy, qz, qw = c.f64(), c.f64(), c.f64(), c.f64()
        out.append(TransformStamped(header, child,
                                    _pose_to_matrix(tx, ty, tz, qx, qy, qz, qw)))
    return out


def _deserialize_clock(buf: bytes) -> Clock:
    c = _Cursor(buf)
    return Clock(c.time())


_DESERIALIZERS = {
    "sensor_msgs/PointCloud2": _deserialize_pointcloud2,
    "nav_msgs/Odometry": _deserialize_odometry,
    "geometry_msgs/PoseStamped": _deserialize_pose_stamped,
    "geometry_msgs/PoseWithCovarianceStamped": _deserialize_pose_cov_stamped,
    "sensor_msgs/Imu": _deserialize_imu,
    "tf2_msgs/TFMessage": _deserialize_tf,
    "tf/tfMessage": _deserialize_tf,
    "rosgraph_msgs/Clock": _deserialize_clock,
}


# ---------------------------------------------------------------------------
# Bag reading
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Connection:
    conn_id: int
    topic: str
    datatype: str
    md5sum: str = ""


@dataclasses.dataclass
class BagMessage:
    topic: str
    datatype: str
    time: float
    message: object  # decoded message, or raw bytes if no codec is known


class RosbagReader:
    """Sequential rosbag V2.0 reader (chunked or unchunked records)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a rosbag V2.0 file")
            self._body = f.read()
        self.connections: Dict[int, Connection] = {}

    def _decompress(self, header: Dict[bytes, bytes], data: bytes) -> bytes:
        comp = header.get(b"compression", b"none").decode()
        if comp == "none":
            return data
        if comp == "bz2":
            return bz2.decompress(data)
        if comp == "lz4":
            try:
                import lz4.frame  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    f"{self.path}: lz4-compressed bag but lz4 is unavailable") from e
            return lz4.frame.decompress(data)
        raise ValueError(f"{self.path}: unknown chunk compression '{comp}'")

    def _scan_records(self, buf: bytes, decode_chunks: bool):
        pos = 0
        while pos < len(buf):
            header, data, pos = _read_record(buf, pos)
            op = header.get(b"op", b"\x00")[0]
            if op == _OP_CONNECTION:
                conn_id = struct.unpack("<I", header[b"conn"])[0]
                fields = _parse_header(data)
                self.connections[conn_id] = Connection(
                    conn_id=conn_id,
                    topic=header.get(b"topic", b"").decode(),
                    datatype=fields.get(b"type", b"").decode(),
                    md5sum=fields.get(b"md5sum", b"").decode())
            elif op == _OP_CHUNK and decode_chunks:
                inner = self._decompress(header, data)
                yield from self._scan_records(inner, decode_chunks=False)
            elif op == _OP_MSG:
                conn_id = struct.unpack("<I", header[b"conn"])[0]
                secs, nsecs = struct.unpack("<II", header[b"time"])
                yield conn_id, _ros_time(secs, nsecs), data

    def read_messages(self, topics: Optional[Sequence[str]] = None,
                      decode: bool = True) -> Iterator[BagMessage]:
        """Yield messages in time order (≙ rosbag::View iteration)."""
        wanted = set(topics) if topics is not None else None
        collected = []
        for conn_id, t, raw in self._scan_records(self._body, decode_chunks=True):
            conn = self.connections.get(conn_id)
            if conn is None:
                continue
            if wanted is not None and conn.topic not in wanted:
                continue
            collected.append((t, conn, raw))
        collected.sort(key=lambda x: x[0])
        for t, conn, raw in collected:
            msg = raw
            if decode:
                codec = _DESERIALIZERS.get(conn.datatype)
                if codec is not None:
                    msg = codec(raw)
            yield BagMessage(topic=conn.topic, datatype=conn.datatype,
                             time=t, message=msg)

    def topics(self) -> Dict[str, str]:
        """topic -> datatype map (forces a full scan for connection records)."""
        for _ in self._scan_records(self._body, decode_chunks=True):
            pass
        return {c.topic: c.datatype for c in self.connections.values()}


# ---------------------------------------------------------------------------
# Bag writing (uncompressed, single-chunk; enough for round-trip + export —
# ≙ the reference's processed output bag, RosbagRangeDataProcessorRos.cpp:279-282)
# ---------------------------------------------------------------------------

def serialize_pointcloud2(cloud: PointCloud, stamp: float,
                          frame_id: str = "lidar") -> bytes:
    """PointCloud x,y,z(,normals) -> sensor_msgs/PointCloud2 wire bytes
    (≙ open3d_conversions.cpp:21-55 preallocated feature+normal layout).
    Every cloud has normals (``PointCloud.has_normals``), so the three
    normal fields are always written, as in the JAX package."""
    mask = cloud.mask.cpu().numpy().astype(bool)
    xyz = cloud.xyz.cpu().numpy().astype(np.float32)[mask]
    nrm = None
    if cloud.has_normals:
        nrm = cloud.normals.cpu().numpy().astype(np.float32)[mask]
    n = xyz.shape[0]
    names = ["x", "y", "z"] + (["normal_x", "normal_y", "normal_z"] if nrm is not None else [])
    # Descriptor channels round-trip as their sensor field names; color goes
    # out as separate float r/g/b columns (lossless vs packed-u8 rgb).
    attr_cols = {}
    if cloud.attrs is not None:
        block = cloud.attrs.cpu().numpy().astype(np.float32)[mask]
        for i, aname in enumerate(cloud.attr_names):
            field = "time" if aname == "t" else aname
            attr_cols[field] = block[:, i]
        names += list(attr_cols)
    point_step = 4 * len(names)
    rec = np.zeros(n, dtype=np.dtype({"names": names,
                                      "formats": ["f4"] * len(names),
                                      "offsets": [4 * i for i in range(len(names))],
                                      "itemsize": point_step}))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if nrm is not None:
        rec["normal_x"], rec["normal_y"], rec["normal_z"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    for field, col in attr_cols.items():
        rec[field] = col
    body = rec.tobytes()

    out = bytearray()
    secs, nsecs = _split_ros_time(stamp)
    out += struct.pack("<I", 0) + struct.pack("<II", secs, nsecs)
    fid = frame_id.encode()
    out += struct.pack("<I", len(fid)) + fid
    out += struct.pack("<II", 1, n)          # height, width
    out += struct.pack("<I", len(names))
    for i, name in enumerate(names):
        nb = name.encode()
        out += struct.pack("<I", len(nb)) + nb
        out += struct.pack("<IBI", 4 * i, _PF_CODES["f4"], 1)
    out += struct.pack("<B", 0)               # is_bigendian
    out += struct.pack("<II", point_step, point_step * n)
    out += struct.pack("<I", len(body)) + body
    out += struct.pack("<B", 1)               # is_dense
    return bytes(out)


def serialize_odometry(T: np.ndarray, stamp: float, frame_id: str = "odom",
                       child_frame_id: str = "base") -> bytes:
    out = bytearray()
    secs, nsecs = _split_ros_time(stamp)
    out += struct.pack("<I", 0) + struct.pack("<II", secs, nsecs)
    fid = frame_id.encode()
    out += struct.pack("<I", len(fid)) + fid
    cid = child_frame_id.encode()
    out += struct.pack("<I", len(cid)) + cid
    T = np.asarray(T, np.float64)
    qx, qy, qz, qw = _matrix_to_quat(T)
    out += struct.pack("<3d", *T[:3, 3])
    out += struct.pack("<4d", qx, qy, qz, qw)
    out += np.zeros(36).tobytes()
    out += np.zeros(6).tobytes()   # twist linear+angular
    out += np.zeros(36).tobytes()
    return bytes(out)


_MSG_MD5 = {
    # Well-known ROS1 md5sums so standard tools accept the connections.
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "nav_msgs/Odometry": "cd5e73d190d741a2f92e81eda573aca7",
    "rosgraph_msgs/Clock": "a9c97c1d230cfc112e270351a944ee47",
}


class RosbagWriter:
    """Minimal rosbag V2.0 writer: one uncompressed chunk, connection records
    repeated after the chunk, chunk-info record (no per-connection indexes;
    `rosbag reindex` can add them)."""

    def __init__(self, path: str):
        self.path = path
        self._conns: Dict[str, Tuple[int, str]] = {}
        self._chunk = bytearray()
        self._count = 0
        self._t_min = None
        self._t_max = None

    def _connection(self, topic: str, datatype: str) -> int:
        if topic in self._conns:
            return self._conns[topic][0]
        conn_id = len(self._conns)
        self._conns[topic] = (conn_id, datatype)
        header = _encode_header({b"op": bytes([_OP_CONNECTION]),
                                 b"conn": struct.pack("<I", conn_id),
                                 b"topic": topic.encode()})
        data = _encode_header({b"topic": topic.encode(),
                               b"type": datatype.encode(),
                               b"md5sum": _MSG_MD5.get(datatype, "*").encode(),
                               b"message_definition": b""})
        self._chunk += struct.pack("<I", len(header)) + header
        self._chunk += struct.pack("<I", len(data)) + data
        return conn_id

    def write(self, topic: str, datatype: str, stamp: float, payload: bytes) -> None:
        conn_id = self._connection(topic, datatype)
        secs, nsecs = _split_ros_time(stamp)
        header = _encode_header({b"op": bytes([_OP_MSG]),
                                 b"conn": struct.pack("<I", conn_id),
                                 b"time": struct.pack("<II", secs, nsecs)})
        self._chunk += struct.pack("<I", len(header)) + header
        self._chunk += struct.pack("<I", len(payload)) + payload
        self._count += 1
        self._t_min = stamp if self._t_min is None else min(self._t_min, stamp)
        self._t_max = stamp if self._t_max is None else max(self._t_max, stamp)

    def write_pointcloud(self, topic: str, cloud: PointCloud, stamp: float,
                         frame_id: str = "lidar") -> None:
        self.write(topic, "sensor_msgs/PointCloud2", stamp,
                   serialize_pointcloud2(cloud, stamp, frame_id))

    def write_odometry(self, topic: str, T: np.ndarray, stamp: float,
                       frame_id: str = "odom", child_frame_id: str = "base") -> None:
        self.write(topic, "nav_msgs/Odometry", stamp,
                   serialize_odometry(T, stamp, frame_id, child_frame_id))

    def close(self) -> None:
        with open(self.path, "wb") as f:
            f.write(_MAGIC)
            # bag header record, header padded to 4096 bytes with a space
            # field (the rosbag convention so index_pos can be patched later)
            fields = {b"op": bytes([_OP_BAGHDR]),
                      b"index_pos": struct.pack("<Q", 0),
                      b"conn_count": struct.pack("<I", len(self._conns)),
                      b"chunk_count": struct.pack("<I", 1)}
            base = _encode_header(fields)
            pad = 4096 - len(base) - 4 - len(b"padding=")
            fields[b"padding"] = b" " * max(0, pad)
            header = _encode_header(fields)
            f.write(struct.pack("<I", len(header)) + header)
            f.write(struct.pack("<I", 0))  # bag header data (empty)
            chunk = bytes(self._chunk)
            chdr = _encode_header({b"op": bytes([_OP_CHUNK]),
                                   b"compression": b"none",
                                   b"size": struct.pack("<I", len(chunk))})
            f.write(struct.pack("<I", len(chdr)) + chdr)
            f.write(struct.pack("<I", len(chunk)) + chunk)


# ---------------------------------------------------------------------------
# Replay adapter
# ---------------------------------------------------------------------------

def rosbag_sequence(bag_path: str, cloud_topic: str,
                    odometry_topic: Optional[str] = None,
                    capacity: int = 32768,
                    odometry_to_cloud_calibration: Optional[np.ndarray] = None,
                    device="cuda"):
    """Yield ReplayFrames from a rosbag, pairing each cloud with the
    interpolated odometry pose at its stamp (≙ RosbagRangeDataProcessorRos'
    cloud/odometry pairing + the static calibration applied from TF,
    reference RosbagRangeDataProcessorRos.cpp:865-905).  Clouds are built
    on ``device`` at ``capacity`` lanes; a scan with more points raises.
    Each frame is read in a ``frontend`` span of the tracer."""
    yield from timing.iterate("frontend", _frames(bag_path, cloud_topic, odometry_topic,
                                                  capacity, odometry_to_cloud_calibration,
                                                  device))


def _frames(bag_path, cloud_topic, odometry_topic, capacity, odometry_to_cloud_calibration,
            device):
    from .replay import ReplayFrame

    reader = RosbagReader(bag_path)
    topics = [cloud_topic] + ([odometry_topic] if odometry_topic else [])
    buf = TransformInterpolationBuffer()
    calib = (np.eye(4, dtype=np.float32) if odometry_to_cloud_calibration is None
             else np.asarray(odometry_to_cloud_calibration, np.float32))
    pending: List[Tuple[float, PointCloud]] = []
    for bm in reader.read_messages(topics=topics):
        if bm.topic == cloud_topic:
            pc2 = bm.message
            stamp = pc2.header.stamp or bm.time
            pending.append((stamp, pc2.to_pointcloud(capacity=capacity, device=device)))
        elif odometry_topic and bm.topic == odometry_topic:
            msg = bm.message
            stamp = msg.header.stamp or bm.time
            buf.push(stamp, np.asarray(msg.pose, np.float32) @ calib)
        # flush clouds once odometry has caught up (or no odometry requested)
        while pending and (odometry_topic is None or
                           (not buf.empty and buf.latest_time() >= pending[0][0])):
            t, cloud = pending.pop(0)
            pose = None
            if odometry_topic is not None:
                pose = buf.lookup(t)
            yield ReplayFrame(time=t, scan=cloud, odom_pose=pose)
    # flush remainder with extrapolated poses
    for t, cloud in pending:
        pose = buf.get_transform(t) if (odometry_topic and not buf.empty) else None
        yield ReplayFrame(time=t, scan=cloud, odom_pose=pose)
