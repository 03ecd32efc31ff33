"""The port's pod tier on the CPU: its native library
(kimera_multi_tpu_torch/io/csrc/kmt_native.cpp, a copy of the JAX
package's, built by the port into its own build directory), the DCN
fabric (dist/dcn.py) and two `cli.pod` processes.

Checked: the packers and the native codec give the JAX package's bytes
for the same inputs, packet logs too, which the Replayer streams back; a
Peer round trip; the fabric's all-gather between
two pods in threads; two CPU pod processes at tests/test_dcn.py's size
(2 pods x 2 robots, 16 keyframes, 48 features, 8 rounds) pass the hash
barrier, write their robots' logs, and their lifted blocks and rounded
poses equal `make_round_fn`'s rounds over 2 gloo ranks from the same
graph within 1e-6; a fleet with a late robot and skipped, throttled BoW
vectors reaches the same solution as one that streams all
(tests/test_dcn.py's late-join case).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import torch

from kimera_multi_tpu.dist import dcn as jdcn
from kimera_multi_tpu.io import native as jnative
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.core import stiefel
from kimera_multi_tpu_torch.dist import dcn
from kimera_multi_tpu_torch.io import native

import _torch_ranks as ranks

torch.set_num_threads(1)

FIELDS = ("src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
          "kappa", "tau", "etype")


def _port_base(offset: int) -> int:
    """Ports of this process's fabrics: outside tests/test_dcn.py's
    46000 - 48000 and the pod CLI's default 47600."""
    return 50000 + (os.getpid() * 7 + offset) % 8000


def _edges_np(E=5, seed=0):
    rng = np.random.default_rng(seed)
    return dict(src_robot=rng.integers(0, 3, E).astype(np.int32),
                src_pose=rng.integers(0, 9, E).astype(np.int32),
                dst_robot=rng.integers(0, 3, E).astype(np.int32),
                dst_pose=rng.integers(0, 9, E).astype(np.int32),
                R=rng.normal(size=(E, 3, 3)).astype(np.float32),
                t=rng.normal(size=(E, 3)).astype(np.float32),
                kappa=np.ones(E, np.float32), tau=np.full(E, 2.0, np.float32),
                etype=np.ones(E, np.int32))


def test_packers_give_the_jax_bytes():
    rng = np.random.default_rng(1)
    assert dcn.pack_ctrl(2, 7, 1, -5) == jdcn.pack_ctrl(2, 7, 1, -5)
    for arr in (rng.normal(size=(4, 2, 3)).astype(np.float32),
                rng.integers(-9, 9, (5,)).astype(np.int32),
                rng.integers(0, 255, (3, 32)).astype(np.uint8),
                rng.normal(size=(2, 2))):
        b = dcn.pack_tensor(7, 1, arr)
        assert b == jdcn.pack_tensor(7, 1, arr)
        np.testing.assert_array_equal(dcn.unpack_tensor(b).array, arr)
    ids = rng.integers(-1, 500, 128).astype(np.int32)
    w = rng.random(128).astype(np.float32)
    assert dcn.pack_bow(3, 11, ids, w) == jdcn.pack_bow(3, 11, ids, w)
    m = dcn.unpack_bow(dcn.pack_bow(3, 11, ids, w))
    assert (m.robot, m.frame) == (3, 11) and np.array_equal(m.ids, ids)
    pairs = rng.integers(0, 40, (6, 2)).astype(np.int32)
    assert dcn.pack_req(dcn.REQ_VLC, 1, pairs) == jdcn.pack_req(
        jdcn.REQ_VLC, 1, pairs)
    assert np.array_equal(dcn.unpack_req(dcn.pack_req(2, 1, pairs)).pairs,
                          pairs)


def test_native_codec_gives_the_jax_bytes():
    """Buffer.write_edges / write_vlc / write_raw: the same bytes from the
    port's library (port edges) as from the JAX package's (JAX edges);
    read back exactly."""
    import jax.numpy as jnp

    from kimera_multi_tpu.core.containers import PoseGraphEdges as JEdges

    e = _edges_np()
    bp, bj = native.Buffer(), jnative.Buffer()
    bp.write_edges(convert.edges_from_numpy(**e, device="cpu"))
    bj.write_edges(JEdges(**{k: jnp.asarray(v) for k, v in e.items()}))
    assert bp.tobytes() == bj.tobytes()
    rng = np.random.default_rng(2)
    desc = rng.integers(0, 255, (20, 32)).astype(np.uint8)
    be = rng.normal(size=(20, 3)).astype(np.float32)
    lm = rng.normal(size=(20, 3)).astype(np.float32)
    va = rng.random(20) < 0.7
    bp, bj = native.Buffer(), jnative.Buffer()
    bp.write_vlc(1, 4, desc, be, lm, torch.from_numpy(va))
    bj.write_vlc(1, 4, desc, be, lm, va)
    bp.write_raw(dcn.TYPE_CTRL, dcn.pack_ctrl(1, 2, 3, 4))
    bj.write_raw(jdcn.TYPE_CTRL, jdcn.pack_ctrl(1, 2, 3, 4))
    assert bp.tobytes() == bj.tobytes()
    rd = native.Buffer()
    rd.load(bp.tobytes())
    f = rd.read_vlc(32)
    assert (f["robot"], f["frame"], f["n"]) == (1, 4, 20)
    assert np.array_equal(f["descriptors"], desc)
    assert np.array_equal(f["valid"], va)


def test_peer_roundtrip_all_packet_types():
    """Edges, control and tensor packets cross a port Peer connection;
    byte counters move on both ends."""
    a, b = native.Peer(port=0), native.Peer(port=0)
    a.connect("127.0.0.1", b.port)
    e = _edges_np()
    buf = native.Buffer()
    buf.write_edges(convert.edges_from_numpy(**e, device="cpu"))
    a.send(buf)
    buf2 = native.Buffer()
    buf2.write_raw(dcn.TYPE_CTRL, dcn.pack_ctrl(dcn.CTRL_HASH, 3, 1, 42))
    arr = np.random.default_rng(0).normal(size=(4, 2, 3)).astype(np.float32)
    buf2.write_raw(dcn.TYPE_TENSOR, dcn.pack_tensor(7, 0, arr))
    a.send(buf2)
    got_edges, got_ctrl, got_tensor = [], None, None
    for _ in range(5 + 2):
        ptype, rbuf = b.recv(timeout_ms=5000)
        if ptype == dcn.TYPE_EDGE:
            got_edges.append(rbuf.read_edges(4))
        elif ptype == dcn.TYPE_CTRL:
            got_ctrl = dcn.unpack_ctrl(dcn._payload(rbuf))
        elif ptype == dcn.TYPE_TENSOR:
            got_tensor = dcn.unpack_tensor(dcn._payload(rbuf))
    assert len(got_edges) == 5
    for f in FIELDS:
        np.testing.assert_array_equal(
            torch.cat([getattr(x, f) for x in got_edges]).numpy(), e[f])
    assert got_ctrl == dcn.Ctrl(dcn.CTRL_HASH, 3, 1, 42)
    assert got_tensor.tag == 7 and got_tensor.sender == 0
    np.testing.assert_array_equal(got_tensor.array, arr)
    assert a.bytes_sent() > 0 and b.bytes_received() == a.bytes_sent()
    assert b.recv(timeout_ms=50) is None
    a.close()
    b.close()


def test_fabric_allgather_two_pods_in_threads():
    base = _port_base(0)
    R, N = 4, 6
    full_ref = np.arange(R * N * 3, dtype=np.float32).reshape(R, N, 3)
    results = {}

    def pod(rank):
        fab = dcn.DcnFabric(rank, 2, base)
        own = [r for r in range(R) if r % 2 == rank]
        results[rank] = fab.allgather_tensor(
            tag=1, rnd=0, local=full_ref[own], pod_of_part=lambda i: i % 2,
            n_parts=R)
        fab.send_ctrl(dcn.CTRL_HASH, 1, 0)
        fab.end_batch(1)
        fab.collect(1, timeout_s=20)
        fab.close()

    t1 = threading.Thread(target=pod, args=(1,), daemon=True)
    t1.start()
    pod(0)
    t1.join(timeout=30)
    assert not t1.is_alive()
    np.testing.assert_array_equal(results[0], full_ref)
    np.testing.assert_array_equal(results[1], full_ref)


def _launch_pods(tmp_path, base, extra=(), tag="pods"):
    """Start a fleet of two `cli.pod` processes on the CPU (2 pods x 2
    robots, 16 keyframes, 48 features, 8 rounds; logs under
    tmp_path/tag); stdout and stderr go to files, so a pod's stderr never
    fills a pipe while its sibling waits on it."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    procs = []
    for rank in range(2):
        out_f = open(tmp_path / f"{tag}_pod{rank}.out", "w+")
        err_f = open(tmp_path / f"{tag}_pod{rank}.err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "kimera_multi_tpu_torch.cli.pod",
             "--rank", str(rank), "--pods", "2", "--robots", "4",
             "--steps", "16", "--features", "48", "--rounds", "8",
             "--port-base", str(base), "--device", "cpu",
             "--log-dir", str(tmp_path / tag), *extra],
            stdout=out_f, stderr=err_f, env=env), out_f, err_f))
    return procs


def _wait_pods(procs) -> list:
    """Both pods' exit codes (asserted 0) and last JSON lines."""
    outs = []
    for p, out_f, err_f in procs:
        rc = p.wait(timeout=300)
        out_f.seek(0)
        err_f.seek(0)
        assert rc == 0, err_f.read()[-2000:]
        outs.append(json.loads(out_f.read().strip().splitlines()[-1]))
        out_f.close()
        err_f.close()
    return outs


def test_two_cpu_pods_reach_bitwise_consensus(tmp_path):
    """Two `cli.pod` processes (2 pods x 2 robots) on the CPU: the hash
    barrier passes, each pod writes its robots' TUM logs, APE under 0.5 m,
    and the dpgo rounds (`make_round_fn` over the fabric, pod k owning
    every robot r with r % 2 == k) equal 2-rank `make_round_fn` rounds
    over gloo with contiguous blocks (within 1e-6)."""
    outs = _wait_pods(_launch_pods(tmp_path, _port_base(100)))
    tmp_path = tmp_path / "pods"
    assert outs[0]["agree"] and outs[1]["agree"]
    assert outs[0]["digest"] == outs[1]["digest"]
    assert outs[0]["final_cost"] == outs[1]["final_cost"]
    assert outs[0]["dpgo_bytes_per_round"] > 0
    for o in outs:
        for r, v in o["ape_rmse"].items():
            assert v < 0.5, (r, v)
    for r in range(4):
        assert (tmp_path / f"robot{r}" / "distributed" /
                f"kimera_distributed_poses_tum_{r}.tum").exists()
    sol = [np.load(tmp_path / f"pod{k}_solution.npz") for k in range(2)]
    np.testing.assert_array_equal(sol[0]["Y"], sol[1]["Y"])
    data = dict(edges={f: sol[0][f"edges_{f}"] for f in FIELDS}, robots=4,
                ppr=16, seed=0, rounds=8)
    Y = ranks.run_ranks(ranks.pod_rounds_job, data, tmp_path / "ranks")[0]
    np.testing.assert_allclose(Y, sol[0]["Y"], rtol=0, atol=1e-6)
    flat = lambda Y: torch.from_numpy(Y).reshape(-1, 5, 4)  # noqa: E731
    for a, b in zip(stiefel.round_solution(flat(Y), 3),
                    stiefel.round_solution(flat(sol[0]["Y"]), 3)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_pods_recover_a_late_robot_and_skipped_bows(tmp_path):
    """tests/test_dcn.py's late-join case on the port's pods: a fleet
    whose robot 1 joins late (its BoW vectors never streamed), with every
    2nd BoW vector skipped (`--bow-skip 1`) and at most 2 published a
    stream round (`--bow-batch 8`), recovers everything in the gap-fill
    phase: the same loops and the bit-identical solution of a fleet that
    streams all (the default batch of 16). Every stream round but the
    last (the gap-fill entry) stays within its batch's bytes."""
    full_p = _launch_pods(tmp_path, _port_base(300), tag="full")
    late_p = _launch_pods(tmp_path, _port_base(500), ["--bow-skip", "1",
                          "--late-robot", "1", "--bow-batch", "2"], "late")
    full, late = _wait_pods(full_p), _wait_pods(late_p)
    for outs in (full, late):
        assert outs[0]["agree"] and outs[1]["agree"]
        assert outs[0]["digest"] == outs[1]["digest"]
    assert late[0]["digest"] == full[0]["digest"]
    assert late[0]["n_loops"] + late[1]["n_loops"] == \
        full[0]["n_loops"] + full[1]["n_loops"]
    # a BoW packet: 9 B frame header, 12 B robot / frame / W, W = 128 ids
    # (4 B) and weights (4 B); 64 B of slack for the batch's terminator
    per_vec = 21 + 8 * 128
    for outs, batch in ((full, 16), (late, 2)):
        for o in outs:
            rb = o["bow_round_bytes"]
            assert len(rb) >= 2
            assert all(b <= batch * per_vec + 64 for b in rb[:-1]), rb
    assert len(late[0]["bow_round_bytes"]) > len(full[0]["bow_round_bytes"])


def test_packet_log_through_the_replayer(tmp_path):
    """VLC frames written to a packet log by the port's Buffer hold the
    JAX package's file bytes and stream back through the port's
    background-thread Replayer."""
    npr = np.random.default_rng(0)
    K = 64
    buf, jbuf = native.Buffer(), jnative.Buffer()
    frames = []
    for i in range(5):
        desc = npr.integers(0, 256, (K, 32), dtype=np.uint8)
        be = npr.normal(size=(K, 3)).astype(np.float32)
        lm = npr.normal(size=(K, 3)).astype(np.float32)
        va = npr.uniform(size=K) > 0.2
        frames.append((desc, be, lm, va))
        buf.write_vlc(1, i, desc, be, lm, va)
        jbuf.write_vlc(1, i, desc, be, lm, va)
    path, jpath = str(tmp_path / "vlc.kmt"), str(tmp_path / "jvlc.kmt")
    buf.write_file(path)
    jbuf.write_file(jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got = 0
    for ptype, pbuf in native.Replayer(path, queue_capacity=2):
        assert ptype == dcn.TYPE_VLC
        rec = pbuf.read_vlc(K)
        desc, be, lm, va = frames[rec["frame"]]
        assert rec["robot"] == 1
        np.testing.assert_array_equal(rec["descriptors"], desc)
        np.testing.assert_array_equal(rec["bearings"], be)
        np.testing.assert_array_equal(rec["valid"], va)
        got += 1
    assert got == 5
