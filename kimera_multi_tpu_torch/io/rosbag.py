"""Minimal rosbag1 (v2.0) reader + fixture writer. A copy of the JAX
package's io/rosbag.py, which is numpy only; the port keeps its own.

Role of the reference's rosbag replay tier: the campus datasets the
north-star acceptance needs are rosbags (reference
examples/1014-example.yaml:92-97 replays mit_rosbag.launch;
README.md:204 links the Kimera-Multi-Data bags;
RosbagDataProvider::parseRosbag, images/kimera-multi.drawio:834-863).
This module parses the self-describing rosbag 2.0 container natively —
no ROS dependency — and converts the sensor streams into the EuRoC ASL
tree that `io/dataset.py` / `io/convert.py` already consume, so a .bag
flows through the exact same VIO -> obs_robot<k>.npz -> replay gate as
an ASL session.

Container format (documented at wiki.ros.org/Bags/Format/2.0):
  file  = "#ROSBAG V2.0\\n" + record*
  record = u32 header_len, header, u32 data_len, data
  header = (u32 field_len, "name=" + value)*
Record kinds by header field op: 0x03 bag header, 0x05 chunk (data =
concatenated records, possibly compressed), 0x07 connection (topic +
type + md5 + message_definition), 0x02 message data (conn id + time +
serialized message), 0x04 index, 0x06 chunk info.

Message types deserialized (little-endian ROS serialization):
  sensor_msgs/Imu        -> (t, gyro[3], accel[3])
  sensor_msgs/Image      -> (t, H, W, encoding, bytes)  [mono8/8UC1]
  sensor_msgs/CameraInfo -> intrinsics (K) + projection (P)
  nav_msgs/Odometry      -> (t, position[3], quaternion[4])  (GT)
Compression: 'none' and 'bz2' chunks (the stdlib codec); 'lz4' raises
with a clear message (the standard library has no lz4 codec).
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import NamedTuple

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


class Connection(NamedTuple):
    conn_id: int
    topic: str
    msg_type: str  # e.g. "sensor_msgs/Imu"


class Message(NamedTuple):
    conn_id: int
    time_ns: int
    data: bytes


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    n = len(buf)
    while off + 4 <= n:
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq].decode()] = field[eq + 1:]
    return fields


def _iter_records(buf: bytes, offset: int = 0):
    """Yields (header_fields, data_bytes) for each record in buf."""
    off = offset
    n = len(buf)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


def read_bag(path: str):
    """Parse a rosbag1 file. Returns (connections: {conn_id: Connection},
    messages: list[Message] in file order)."""
    raw = open(path, "rb").read()
    if not raw.startswith(_MAGIC):
        raise ValueError(f"{path}: not a rosbag 2.0 file "
                         f"(magic {raw[:13]!r})")
    conns: dict[int, Connection] = {}
    msgs: list[Message] = []

    def consume(stream: bytes):
        for h, data in _iter_records(stream):
            op = h["op"][0]
            if op == OP_CONNECTION:
                cid = struct.unpack("<I", h["conn"])[0]
                inner = _parse_header(data)
                conns[cid] = Connection(
                    conn_id=cid,
                    topic=h.get("topic", inner.get("topic", b"")).decode(),
                    msg_type=inner.get("type", b"").decode())
            elif op == OP_MSG:
                cid = struct.unpack("<I", h["conn"])[0]
                sec, nsec = struct.unpack("<II", h["time"])
                msgs.append(Message(cid, sec * 1_000_000_000 + nsec, data))
            elif op == OP_CHUNK:
                comp = h.get("compression", b"none").decode()
                if comp == "none":
                    payload = data
                elif comp == "bz2":
                    payload = bz2.decompress(data)
                else:
                    raise ValueError(
                        f"{path}: chunk compression '{comp}' unsupported "
                        "(only none/bz2: the standard library has no lz4 "
                        "codec)")
                consume(payload)
            # OP_BAG_HEADER / OP_INDEX / OP_CHUNK_INFO: bookkeeping only

    consume(raw[len(_MAGIC):])
    return conns, msgs


def bag_topics(path: str) -> dict:
    """{topic: (msg_type, message_count)} summary of a bag."""
    conns, msgs = read_bag(path)
    out: dict[str, list] = {}
    for c in conns.values():
        out.setdefault(c.topic, [c.msg_type, 0])
    for m in msgs:
        c = conns.get(m.conn_id)
        if c is not None:
            out[c.topic][1] += 1
    return {k: tuple(v) for k, v in out.items()}


# ---------------------------------------------------------------------
# message deserializers (ROS little-endian serialization)
# ---------------------------------------------------------------------


def _read_string(buf: bytes, off: int):
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode(errors="replace"), off + n


def _read_header(buf: bytes, off: int):
    """std_msgs/Header -> (stamp_ns, frame_id, new_off)."""
    seq, sec, nsec = struct.unpack_from("<III", buf, off)
    off += 12
    frame_id, off = _read_string(buf, off)
    return sec * 1_000_000_000 + nsec, frame_id, off


def parse_imu(data: bytes):
    """sensor_msgs/Imu -> (stamp_ns, gyro (3,), accel (3,))."""
    stamp, _frame, off = _read_header(data, 0)
    off += 4 * 8 + 9 * 8  # orientation quat + covariance
    gyro = np.frombuffer(data, "<f8", count=3, offset=off)
    off += 3 * 8 + 9 * 8
    accel = np.frombuffer(data, "<f8", count=3, offset=off)
    return stamp, gyro.astype(np.float32), accel.astype(np.float32)


def parse_image(data: bytes):
    """sensor_msgs/Image -> (stamp_ns, image (H, W) float32).
    Supports mono8/8UC1 and mono16/16UC1 encodings."""
    stamp, _frame, off = _read_header(data, 0)
    h, w = struct.unpack_from("<II", data, off)
    off += 8
    encoding, off = _read_string(data, off)
    off += 1  # is_bigendian
    (step,) = struct.unpack_from("<I", data, off)
    off += 4
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    pix = data[off:off + n]
    if encoding in ("mono8", "8UC1"):
        img = np.frombuffer(pix, np.uint8).reshape(h, step)[:, :w]
    elif encoding in ("mono16", "16UC1"):
        img = np.frombuffer(pix, "<u2").reshape(h, step // 2)[:, :w]
    else:
        raise ValueError(f"image encoding '{encoding}' unsupported "
                         "(mono8/8UC1/mono16/16UC1)")
    return stamp, img.astype(np.float32)


def parse_camera_info(data: bytes):
    """sensor_msgs/CameraInfo -> dict(stamp_ns, width, height, K (3,3),
    P (3,4))."""
    stamp, _frame, off = _read_header(data, 0)
    h, w = struct.unpack_from("<II", data, off)
    off += 8
    _model, off = _read_string(data, off)
    (nd,) = struct.unpack_from("<I", data, off)
    off += 4 + nd * 8  # D
    K = np.frombuffer(data, "<f8", count=9, offset=off).reshape(3, 3)
    off += 9 * 8 + 9 * 8  # K + R
    P = np.frombuffer(data, "<f8", count=12, offset=off).reshape(3, 4)
    return dict(stamp_ns=stamp, width=w, height=h, K=K, P=P)


def parse_odometry(data: bytes):
    """nav_msgs/Odometry -> (stamp_ns, t (3,), q (4,) as qx qy qz qw)."""
    stamp, _frame, off = _read_header(data, 0)
    _child, off = _read_string(data, off)
    pose = np.frombuffer(data, "<f8", count=7, offset=off)
    return stamp, pose[:3].astype(np.float32), pose[3:7].astype(np.float32)


# ---------------------------------------------------------------------
# bag -> EuRoC ASL tree (the existing converter chain's input)
# ---------------------------------------------------------------------


def rosbag_to_asl(bag_path: str, out_root: str,
                  cam_topic: str | None = None,
                  cam1_topic: str | None = None,
                  imu_topic: str | None = None,
                  gt_topic: str | None = None,
                  max_frames: int | None = None,
                  log=lambda m: None) -> str:
    """Extract one robot's streams from a rosbag into an EuRoC ASL tree
    under `out_root` (mav0/cam0, mav0/cam1, mav0/imu0,
    state_groundtruth_estimate0). Topics default to the first
    sensor_msgs/Image topic (cam0), second Image topic (cam1), first
    sensor_msgs/Imu, and first nav_msgs/Odometry (GT). Images land as
    binary PGM (P5), which `io/convert.load_image` reads natively.
    Returns out_root (ready for `io/convert.euroc_to_observations`)."""
    conns, msgs = read_bag(bag_path)
    by_type: dict[str, list] = {}
    for c in conns.values():
        by_type.setdefault(c.msg_type.split("/")[-1], []).append(c.topic)
    img_topics = sorted(by_type.get("Image", []))
    if cam_topic is None and img_topics:
        cam_topic = img_topics[0]
    if cam1_topic is None and len(img_topics) > 1:
        cam1_topic = img_topics[1]
    if imu_topic is None and by_type.get("Imu"):
        imu_topic = sorted(by_type["Imu"])[0]
    if gt_topic is None and by_type.get("Odometry"):
        gt_topic = sorted(by_type["Odometry"])[0]
    if cam_topic is None:
        raise ValueError(f"{bag_path}: no sensor_msgs/Image topic found "
                         f"(topics: {bag_topics(bag_path)})")
    topic_of = {c.conn_id: c.topic for c in conns.values()}
    caminfo_by_topic: dict[str, dict] = {}
    # CameraInfo conventionally lives next to the image topic
    for c in conns.values():
        if c.msg_type.endswith("CameraInfo"):
            caminfo_by_topic[os.path.dirname(c.topic)] = None

    mav = os.path.join(out_root, "mav0")
    cam_dirs = {cam_topic: os.path.join(mav, "cam0")}
    if cam1_topic:
        cam_dirs[cam1_topic] = os.path.join(mav, "cam1")
    for d in cam_dirs.values():
        os.makedirs(os.path.join(d, "data"), exist_ok=True)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)

    cam_rows: dict[str, list] = {t: [] for t in cam_dirs}
    imu_rows: list[str] = []
    gt_rows: list[str] = []
    n_frames = {t: 0 for t in cam_dirs}

    for m in msgs:
        topic = topic_of.get(m.conn_id)
        if topic in cam_dirs:
            if max_frames is not None and n_frames[topic] >= max_frames:
                continue
            stamp, img = parse_image(m.data)
            name = f"{stamp}.pgm"
            _write_pgm(os.path.join(cam_dirs[topic], "data", name), img)
            cam_rows[topic].append(f"{stamp},{name}")
            n_frames[topic] += 1
        elif topic == imu_topic:
            stamp, gyro, accel = parse_imu(m.data)
            imu_rows.append(
                f"{stamp},{gyro[0]},{gyro[1]},{gyro[2]},"
                f"{accel[0]},{accel[1]},{accel[2]}")
        elif topic == gt_topic:
            stamp, t, q = parse_odometry(m.data)
            # EuRoC GT order: ts, t, qw qx qy qz (dataset.py reorders)
            gt_rows.append(f"{stamp},{t[0]},{t[1]},{t[2]},"
                           f"{q[3]},{q[0]},{q[1]},{q[2]}")
        elif topic and os.path.dirname(topic) in caminfo_by_topic \
                and caminfo_by_topic[os.path.dirname(topic)] is None \
                and conns[m.conn_id].msg_type.endswith("CameraInfo"):
            caminfo_by_topic[os.path.dirname(topic)] = \
                parse_camera_info(m.data)

    for topic, d in cam_dirs.items():
        with open(os.path.join(d, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            f.write("\n".join(cam_rows[topic]) + "\n")
        info = caminfo_by_topic.get(os.path.dirname(topic))
        if info is not None:
            K = info["K"]
            # translation of cam1 from the projection matrix baseline
            # (P[0,3] = -fx * baseline for rectified stereo)
            tx = float(-info["P"][0, 3] / max(info["P"][0, 0], 1e-9))
            with open(os.path.join(d, "sensor.yaml"), "w") as f:
                f.write("sensor_type: camera\n")
                f.write(f"intrinsics: [{K[0, 0]}, {K[1, 1]}, "
                        f"{K[0, 2]}, {K[1, 2]}]\n")
                f.write("T_BS:\n  data: [1.0, 0.0, 0.0, %s,\n"
                        "         0.0, 1.0, 0.0, 0.0,\n"
                        "         0.0, 0.0, 1.0, 0.0,\n"
                        "         0.0, 0.0, 0.0, 1.0]\n" % tx)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],wx,wy,wz,ax,ay,az\n")
        f.write("\n".join(imu_rows) + "\n")
    if gt_rows:
        gdir = os.path.join(mav, "state_groundtruth_estimate0")
        os.makedirs(gdir, exist_ok=True)
        with open(os.path.join(gdir, "data.csv"), "w") as f:
            f.write("#timestamp,tx,ty,tz,qw,qx,qy,qz\n")
            f.write("\n".join(gt_rows) + "\n")
    log(f"[rosbag] {bag_path}: {n_frames} frames, {len(imu_rows)} imu, "
        f"{len(gt_rows)} gt rows -> {out_root}")
    return out_root


def _write_pgm(path: str, img: np.ndarray) -> None:
    a = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        f.write(a.tobytes())


# ---------------------------------------------------------------------
# fixture writer (tests + synthetic-bag generation) — writes the same
# container the reader parses, one uncompressed chunk.
# ---------------------------------------------------------------------


class BagWriter:
    """Minimal rosbag1 writer: all records in one uncompressed chunk.
    Enough structure for any rosbag1 reader (including this module's)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._chunk = bytearray()
        self._conns: dict[str, int] = {}
        self._conn_records = bytearray()

    @staticmethod
    def _rec(fields: dict, data: bytes) -> bytes:
        header = bytearray()
        for k, v in fields.items():
            item = k.encode() + b"=" + v
            header += struct.pack("<I", len(item)) + item
        return (struct.pack("<I", len(header)) + bytes(header)
                + struct.pack("<I", len(data)) + data)

    def connection(self, topic: str, msg_type: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        cid = len(self._conns)
        self._conns[topic] = cid
        inner = bytearray()
        for k, v in (("topic", topic.encode()),
                     ("type", msg_type.encode()),
                     ("md5sum", b"0" * 32),
                     ("message_definition", b"")):
            item = k.encode() + b"=" + v
            inner += struct.pack("<I", len(item)) + item
        rec = self._rec({"op": bytes([OP_CONNECTION]),
                         "conn": struct.pack("<I", cid),
                         "topic": topic.encode()}, bytes(inner))
        self._chunk += rec
        return cid

    def write(self, topic: str, msg_type: str, time_ns: int,
              data: bytes) -> None:
        cid = self.connection(topic, msg_type)
        sec, nsec = divmod(int(time_ns), 1_000_000_000)
        self._chunk += self._rec(
            {"op": bytes([OP_MSG]), "conn": struct.pack("<I", cid),
             "time": struct.pack("<II", sec, nsec)}, data)

    # ---- message serializers (inverse of the parsers above) ----------
    @staticmethod
    def ser_header(stamp_ns: int, frame: str = "cam") -> bytes:
        sec, nsec = divmod(int(stamp_ns), 1_000_000_000)
        fb = frame.encode()
        return struct.pack("<III", 0, sec, nsec) + \
            struct.pack("<I", len(fb)) + fb

    @classmethod
    def ser_image(cls, stamp_ns: int, img: np.ndarray) -> bytes:
        a = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        h, w = a.shape
        enc = b"mono8"
        return (cls.ser_header(stamp_ns) + struct.pack("<II", h, w)
                + struct.pack("<I", len(enc)) + enc
                + struct.pack("<BI", 0, w)
                + struct.pack("<I", h * w) + a.tobytes())

    @classmethod
    def ser_imu(cls, stamp_ns: int, gyro, accel) -> bytes:
        z9 = struct.pack("<9d", *([0.0] * 9))
        return (cls.ser_header(stamp_ns, "imu")
                + struct.pack("<4d", 0, 0, 0, 1) + z9
                + struct.pack("<3d", *np.asarray(gyro, float)) + z9
                + struct.pack("<3d", *np.asarray(accel, float)) + z9)

    @classmethod
    def ser_camera_info(cls, stamp_ns: int, w: int, h: int, fx: float,
                        fy: float, cx: float, cy: float,
                        baseline: float = 0.0) -> bytes:
        model = b"plumb_bob"
        K = [fx, 0, cx, 0, fy, cy, 0, 0, 1]
        P = [fx, 0, cx, -fx * baseline, 0, fy, cy, 0, 0, 0, 1, 0]
        return (cls.ser_header(stamp_ns) + struct.pack("<II", h, w)
                + struct.pack("<I", len(model)) + model
                + struct.pack("<I", 0)  # D empty
                + struct.pack("<9d", *K)
                + struct.pack("<9d", *np.eye(3).ravel())
                + struct.pack("<12d", *P)
                + struct.pack("<II", 0, 0) + struct.pack("<IIIIB",
                                                         0, 0, 0, 0, 0))

    @classmethod
    def ser_odometry(cls, stamp_ns: int, t, q_xyzw) -> bytes:
        child = b"base"
        z36 = struct.pack("<36d", *([0.0] * 36))
        pose = struct.pack("<7d", *np.asarray(t, float),
                           *np.asarray(q_xyzw, float))
        twist = struct.pack("<6d", *([0.0] * 6))
        return (cls.ser_header(stamp_ns, "world")
                + struct.pack("<I", len(child)) + child
                + pose + z36 + twist + z36)

    def close(self) -> None:
        rec = self._rec({"op": bytes([OP_CHUNK]),
                         "compression": b"none",
                         "size": struct.pack("<I", len(self._chunk))},
                        bytes(self._chunk))
        # bag header record (op 0x03) padded to 4096 bytes as the spec
        # requires (readers skip it)
        bh = self._rec({"op": bytes([OP_BAG_HEADER]),
                        "index_pos": struct.pack("<Q", 0),
                        "conn_count": struct.pack("<I", len(self._conns)),
                        "chunk_count": struct.pack("<I", 1)},
                       b" " * 4096)
        self._f.write(bh)
        self._f.write(rec)
        self._f.close()
