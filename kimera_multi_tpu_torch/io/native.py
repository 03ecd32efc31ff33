"""ctypes bindings for the native runtime library (the JAX package's
io/native.py, over the port's own copy of its source,
io/csrc/kmt_native.cpp).

The C++ serialization of pose-graph edges and VLC frames (the
pose_graph_tools message layer), the TCP transport of the pod tier
(`Peer`: a listener, outgoing connections, a receive thread per
connection feeding a bounded packet queue, chunked sends, byte counters)
and the background-thread replayer of a packet log. The library is
compiled at first use with the system C++ compiler into
kimera_multi_tpu_torch/_build/ (kernels/_build.host_lib); a failed build
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import _build

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.host_lib("kmt_native.cpp")
    lib.kmt_buffer_new.restype = ctypes.c_void_p
    lib.kmt_buffer_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.kmt_buffer_data.argtypes = [ctypes.c_void_p]
    lib.kmt_buffer_size.restype = ctypes.c_uint64
    lib.kmt_buffer_size.argtypes = [ctypes.c_void_p]
    lib.kmt_buffer_free.argtypes = [ctypes.c_void_p]
    lib.kmt_buffer_load.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
    lib.kmt_buffer_write_file.restype = ctypes.c_int32
    lib.kmt_buffer_write_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.kmt_replayer_open.restype = ctypes.c_void_p
    lib.kmt_replayer_open.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.kmt_replayer_close.argtypes = [ctypes.c_void_p]
    lib.kmt_replayer_pop.restype = ctypes.c_int32
    lib.kmt_replayer_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.kmt_write_raw.argtypes = [ctypes.c_void_p, ctypes.c_uint8,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_uint32]
    lib.kmt_peer_new.restype = ctypes.c_void_p
    lib.kmt_peer_new.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int32]
    lib.kmt_peer_close.argtypes = [ctypes.c_void_p]
    lib.kmt_peer_port.restype = ctypes.c_int32
    lib.kmt_peer_port.argtypes = [ctypes.c_void_p]
    lib.kmt_peer_connect.restype = ctypes.c_int32
    lib.kmt_peer_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int32]
    lib.kmt_peer_n_conns.restype = ctypes.c_int32
    lib.kmt_peer_n_conns.argtypes = [ctypes.c_void_p]
    lib.kmt_peer_send.restype = ctypes.c_int64
    lib.kmt_peer_send.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                  ctypes.c_void_p]
    lib.kmt_peer_recv.restype = ctypes.c_int32
    lib.kmt_peer_recv.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int32]
    lib.kmt_peer_recv_from.restype = ctypes.c_int32
    lib.kmt_peer_recv_from.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int32,
                                       ctypes.POINTER(ctypes.c_int32)]
    lib.kmt_peer_bytes_sent.restype = ctypes.c_int64
    lib.kmt_peer_bytes_sent.argtypes = [ctypes.c_void_p]
    lib.kmt_peer_bytes_received.restype = ctypes.c_int64
    lib.kmt_peer_bytes_received.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _i32(a):
    return np.ascontiguousarray(_np(a), np.int32)


def _f32(a):
    return np.ascontiguousarray(_np(a), np.float32)


def _u8(a):
    return np.ascontiguousarray(_np(a), np.uint8)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class Buffer:
    """Owning wrapper of a native byte buffer."""

    def __init__(self):
        self._lib = _load()
        self._h = ctypes.c_void_p(self._lib.kmt_buffer_new())

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.kmt_buffer_free(self._h)
            self._h = None

    def tobytes(self) -> bytes:
        n = self._lib.kmt_buffer_size(self._h)
        return ctypes.string_at(self._lib.kmt_buffer_data(self._h), n)

    def load(self, data: bytes) -> None:
        arr = np.frombuffer(data, np.uint8)
        self._lib.kmt_buffer_load(self._h, _ptr(arr, ctypes.c_uint8),
                                  len(data))

    def write_file(self, path: str) -> None:
        rc = self._lib.kmt_buffer_write_file(self._h, path.encode())
        if rc != 0:
            raise IOError(f"failed writing {path}")

    def write_raw(self, ptype: int, payload: bytes) -> None:
        """Frame an arbitrary payload (types 3 = control, 4 = tensor are
        defined by dist/dcn.py)."""
        arr = np.frombuffer(payload, np.uint8)
        self._lib.kmt_write_raw(self._h, ptype, _ptr(arr, ctypes.c_uint8),
                                len(payload))

    # ---- edges -------------------------------------------------------
    def write_edges(self, edges) -> None:
        """edges: core.containers.PoseGraphEdges on any device (valid rows
        only is the caller's choice; everything passed is serialized)."""
        n = int(edges.src_robot.shape[0])
        lib = self._lib
        lib.kmt_write_edges(
            self._h, n,
            _ptr(_i32(edges.src_robot), ctypes.c_int32),
            _ptr(_i32(edges.src_pose), ctypes.c_int32),
            _ptr(_i32(edges.dst_robot), ctypes.c_int32),
            _ptr(_i32(edges.dst_pose), ctypes.c_int32),
            _ptr(_i32(edges.etype), ctypes.c_int32),
            _ptr(_f32(edges.kappa), ctypes.c_float),
            _ptr(_f32(edges.tau), ctypes.c_float),
            _ptr(_f32(_np(edges.R).reshape(n, 9)), ctypes.c_float),
            _ptr(_f32(edges.t), ctypes.c_float),
        )

    def read_edges(self, max_n: int):
        lib = self._lib
        sr = np.zeros(max_n, np.int32)
        sp = np.zeros(max_n, np.int32)
        dr = np.zeros(max_n, np.int32)
        dp = np.zeros(max_n, np.int32)
        et = np.zeros(max_n, np.int32)
        ka = np.zeros(max_n, np.float32)
        ta = np.zeros(max_n, np.float32)
        R = np.zeros((max_n, 9), np.float32)
        t3 = np.zeros((max_n, 3), np.float32)
        got = lib.kmt_read_edges(
            self._h, max_n, _ptr(sr, ctypes.c_int32), _ptr(sp, ctypes.c_int32),
            _ptr(dr, ctypes.c_int32), _ptr(dp, ctypes.c_int32),
            _ptr(et, ctypes.c_int32), _ptr(ka, ctypes.c_float),
            _ptr(ta, ctypes.c_float), _ptr(R, ctypes.c_float),
            _ptr(t3, ctypes.c_float))
        from ..core.containers import PoseGraphEdges

        g = slice(0, got)
        t = torch.from_numpy
        return PoseGraphEdges(
            src_robot=t(sr[g]), src_pose=t(sp[g]), dst_robot=t(dr[g]),
            dst_pose=t(dp[g]), R=t(R[g].reshape(-1, 3, 3)), t=t(t3[g]),
            kappa=t(ka[g]), tau=t(ta[g]), etype=t(et[g]))

    # ---- VLC frames --------------------------------------------------
    def write_vlc(self, robot: int, frame: int, desc, bearings, landmarks,
                  valid, has_depth=None) -> None:
        n = int(desc.shape[0])
        if has_depth is None:
            has_depth = np.ones(n, np.uint8)
        self._lib.kmt_write_vlc(
            self._h, robot, frame, n,
            _ptr(_u8(desc), ctypes.c_uint8),
            _ptr(_f32(bearings), ctypes.c_float),
            _ptr(_f32(landmarks), ctypes.c_float),
            _ptr(_u8(valid), ctypes.c_uint8),
            _ptr(_u8(has_depth), ctypes.c_uint8))

    def read_vlc(self, max_feats: int):
        robot = ctypes.c_int32()
        frame = ctypes.c_int32()
        desc = np.zeros((max_feats, 32), np.uint8)
        be = np.zeros((max_feats, 3), np.float32)
        lm = np.zeros((max_feats, 3), np.float32)
        va = np.zeros(max_feats, np.uint8)
        hd = np.zeros(max_feats, np.uint8)
        n = self._lib.kmt_read_vlc(
            self._h, max_feats, ctypes.byref(robot), ctypes.byref(frame),
            _ptr(desc, ctypes.c_uint8), _ptr(be, ctypes.c_float),
            _ptr(lm, ctypes.c_float), _ptr(va, ctypes.c_uint8),
            _ptr(hd, ctypes.c_uint8))
        if n < 0:
            return None
        return dict(robot=robot.value, frame=frame.value, n=n,
                    descriptors=desc[:n], bearings=be[:n], landmarks=lm[:n],
                    valid=va[:n].astype(bool),
                    has_depth=hd[:n].astype(bool))


class Peer:
    """TCP transport endpoint for inter-pod (DCN) packet exchange.

    Wraps the native peer: loopback listener + outgoing connections, a
    background receive thread per connection feeding a bounded packet
    queue (backpressure = flow control), chunked sends, and byte counters
    (dpgo_ros mTotalBytesReceived equivalent)."""

    def __init__(self, port: int = 0, queue_capacity: int = 512,
                 loopback_only: bool = True):
        self._lib = _load()
        h = self._lib.kmt_peer_new(port, queue_capacity,
                                   1 if loopback_only else 0)
        if not h:
            raise OSError(f"failed to bind DCN peer on port {port}")
        self._h = ctypes.c_void_p(h)

    @property
    def port(self) -> int:
        return self._lib.kmt_peer_port(self._h)

    def connect(self, host: str, port: int,
                retries: int = 100, delay_s: float = 0.1) -> int:
        """Connect to a remote peer, retrying while it comes up."""
        import time

        for i in range(retries):
            cid = self._lib.kmt_peer_connect(self._h, host.encode(), port)
            if cid >= 0:
                return cid
            time.sleep(delay_s)
        raise ConnectionError(f"cannot reach {host}:{port}")

    def n_conns(self) -> int:
        return self._lib.kmt_peer_n_conns(self._h)

    def send(self, buf: Buffer, conn: int = -1) -> int:
        """Send the buffer's framed packets (conn -1 = every connection)."""
        n = self._lib.kmt_peer_send(self._h, conn, buf._h)
        if n < 0:
            raise ConnectionError("DCN send failed")
        return n

    def recv(self, timeout_ms: int = -1):
        """Next packet as (type, Buffer); None on timeout; raises once all
        connections have closed and the queue is drained."""
        buf = Buffer()
        rc = self._lib.kmt_peer_recv(self._h, buf._h, timeout_ms)
        if rc == 0:
            return None
        if rc < 0:
            raise ConnectionError("all DCN connections closed")
        return rc, buf

    def recv_from(self, timeout_ms: int = -1):
        """Next packet as (type, Buffer, conn_id); None on timeout. The
        connection id identifies the sender (per-connection TCP FIFO),
        which is what lets the DCN round protocol attribute traffic to
        peers instead of inferring identity from payload contents."""
        buf = Buffer()
        conn = ctypes.c_int32(-1)
        rc = self._lib.kmt_peer_recv_from(self._h, buf._h, timeout_ms,
                                          ctypes.byref(conn))
        if rc == 0:
            return None
        if rc < 0:
            raise ConnectionError("all DCN connections closed")
        return rc, buf, int(conn.value)

    def bytes_sent(self) -> int:
        return self._lib.kmt_peer_bytes_sent(self._h)

    def bytes_received(self) -> int:
        return self._lib.kmt_peer_bytes_received(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.kmt_peer_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class Replayer:
    """Background-thread packet stream over a binary log file."""

    def __init__(self, path: str, queue_capacity: int = 64):
        self._lib = _load()
        self._h = ctypes.c_void_p(
            self._lib.kmt_replayer_open(path.encode(), queue_capacity))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.kmt_replayer_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __iter__(self):
        while True:
            buf = Buffer()
            rc = self._lib.kmt_replayer_pop(self._h, buf._h)
            if rc == 0:
                return
            if rc < 0:
                raise IOError("replayer stream error")
            yield rc, buf
