"""The port's recorded-data readers and writers against the JAX package's
on the CPU: `io/dataset.load_euroc`, `io/convert.load_image`, the rosbag1
reader (`read_bag`, `bag_topics`, the `parse_*` functions,
`rosbag_to_asl`), and the bytes `rosbag.BagWriter` and `png.write_png`
write. The sessions are written from a sequence the port renders (128 x
96, EuRoC's stereo layout) by `io/record.py`; both packages read the same
files.

Tolerances: none. Sessions, images, parsed messages, extracted ASL trees
and written bytes are equal."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from kimera_multi_tpu.io import (convert as jconvert, dataset as jdataset,
                                 png as jpng, rosbag as jrosbag)
from kimera_multi_tpu_torch.io import (convert, dataset, png, record, render,
                                       rosbag)
from kimera_multi_tpu_torch.vio.undistort import CameraModel

torch.set_num_threads(1)

H, W, FX, FY, BASE = 96, 128, 110.0, 109.5, 0.11
INTR = (FX, FY, W / 2 - 0.5, H / 2 + 0.25)
FRAMES = 8


@pytest.fixture(scope="module")
def seq():
    cam = CameraModel(fx=FX, fy=FY, cx=INTR[2], cy=INTR[3])
    rig = render.StereoRig(cam=cam, H=H, W=W, baseline=BASE)
    return render.render_sequence(
        render.make_scene(seed=5, n_points=350), rig, n_frames=FRAMES + 4,
        rate_hz=20.0, imu_rate_hz=200.0, speed=0.6, yaw_rate=0.1,
        device="cpu")


@pytest.fixture(scope="module")
def sessions(seq, tmp_path_factory):
    d = tmp_path_factory.mktemp("sessions")
    return dict(
        pgm=record.write_asl_session(str(d / "pgm"), seq, INTR, BASE,
                                     first=2, n=FRAMES),
        png=record.write_asl_session(str(d / "png"), seq, INTR, BASE,
                                     first=2, n=FRAMES, image_format="png"),
        mono=record.write_asl_session(str(d / "mono"), seq, INTR, BASE,
                                      n=FRAMES, stereo=False, with_gt=False),
        bag=record.write_bag_session(str(d / "s.bag"), seq, INTR, BASE,
                                     first=2, n=FRAMES),
        bag_mono=record.write_bag_session(str(d / "m.bag"), seq, INTR, BASE,
                                          n=FRAMES, stereo=False,
                                          with_gt=False),
        dir=d)


def _assert_sessions_equal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f in ("cam_files", "cam1_files", "intrinsics"):
            assert tuple(x or ()) == tuple(y or ()), f
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("kind", ["pgm", "png", "mono"])
def test_load_euroc_matches_jax(sessions, seq, kind):
    root = sessions[kind]
    got = dataset.load_euroc(root)
    _assert_sessions_equal(got, jdataset.load_euroc(root))
    multi = dataset.load_multi_session([root, root])
    assert len(multi) == 2
    _assert_sessions_equal(multi[1], got)
    assert len(got.cam_files) == FRAMES
    assert got.intrinsics == tuple(float(np.float32(x)) for x in INTR)
    if kind == "mono":
        assert got.cam1_files == () and got.baseline == 0.0
        assert len(got.gt_ts) == 0 and got.gt_q.shape == (0, 4)
    else:
        assert len(got.cam1_files) == FRAMES
        assert abs(got.baseline - BASE) < 1e-6
        # EuRoC's (qw, qx, qy, qz) reordered to (qx, qy, qz, qw): the
        # ground truth's true attitudes, not the identity
        assert len(got.gt_ts) == FRAMES
        from kimera_multi_tpu_torch.core import lie
        R = lie.quat_to_rot(torch.from_numpy(got.gt_q)).numpy()
        np.testing.assert_allclose(R, seq.R_gt[2:2 + FRAMES], atol=1e-6)
        assert np.abs(got.gt_q[:, :3]).max() > 0.4
    # IMU from after the frame before the window to the last frame
    assert got.imu_ts[0] > got.cam_ts[0] - 0.05 - 1e-9
    assert got.imu_ts[-1] <= got.cam_ts[-1] + 1e-9


def _pgm_ascii(path, a):
    with open(path, "w") as f:
        f.write(f"P2\n# a comment\n{a.shape[1]} {a.shape[0]}\n255\n")
        f.write(" ".join(str(int(v)) for v in a.ravel()) + "\n")


def _png_filters(path):
    """The filter type of each row of an 8-bit PNG."""
    raw = open(path, "rb").read()
    off, idat = 8, []
    while off < len(raw):
        n, tag = struct.unpack_from(">I4s", raw, off)
        data = raw[off + 8:off + 8 + n]
        off += 12 + n
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", data[:10])
        elif tag == b"IDAT":
            idat.append(data)
    bpp = 1 if ctype == 0 else 3
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return rows.reshape(h, w * bpp + 1)[:, 0]


def test_load_image_matches_jax(sessions, seq, tmp_path):
    from PIL import Image

    s = dataset.load_euroc(sessions["pgm"])
    sp = dataset.load_euroc(sessions["png"])
    paths = [s.cam_files[0], s.cam1_files[3], sp.cam_files[0],
             sp.cam1_files[5]]
    rs = np.random.default_rng(11)
    # ASCII PGM, .npy
    a = rs.integers(0, 256, (H, W), dtype=np.uint8)
    _pgm_ascii(str(tmp_path / "a.pgm"), a)
    np.save(str(tmp_path / "a.npy"), a.astype(np.float32) * 0.5)
    paths += [str(tmp_path / "a.pgm"), str(tmp_path / "a.npy")]
    # grayscale PNGs written by PIL: noise with `optimize` takes every row
    # filter (None, Sub, Up, Average, Paeth), smooth images Up and Paeth
    noise = rs.integers(0, 256, (40, 50), dtype=np.uint8)
    smooth = (np.add.outer(np.arange(40), np.arange(50)) * 3 % 256
              ).astype(np.uint8)
    grad = (np.outer(np.arange(40), np.arange(50)) % 256).astype(np.uint8)
    seen = np.zeros(5, int)
    for name, img, opt in (("noise", noise, dict(optimize=True)),
                           ("smooth", smooth, {}), ("grad", grad, {}),
                           ("frame", np.asarray(Image.open(sp.cam_files[1])
                                                .convert("L")), {})):
        p = str(tmp_path / f"pil_{name}.png")
        Image.fromarray(img).save(p, format="PNG", **opt)
        seen += np.bincount(_png_filters(p), minlength=5)
        paths.append(p)
    assert (seen > 0).all(), seen
    # an RGB PNG written by PIL with every row filter: three bytes a pixel
    p = str(tmp_path / "pil_rgb.png")
    Image.fromarray(rs.integers(0, 256, (30, 41, 3), dtype=np.uint8)).save(
        p, format="PNG", optimize=True)
    assert len(set(_png_filters(p))) == 5
    paths.append(p)
    # RGB PNGs from the JAX package's write_png: colour reduced by PIL's
    # integer rule
    for i, rgb in enumerate((rs.integers(0, 256, (33, 47, 3), np.uint8),
                             np.stack([a, a[::-1], 255 - a], -1))):
        p = str(tmp_path / f"rgb{i}.png")
        jpng.write_png(p, rgb)
        paths.append(p)
    for p in paths:
        got, ref = convert.load_image(p), jconvert.load_image(p)
        assert got.dtype == ref.dtype == np.float32, p
        np.testing.assert_array_equal(got, ref, err_msg=p)
    # the frames read back as written: 8 bits of gain x the rendering
    want = np.clip(seq.left[2] * record.GAIN, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(convert.load_image(s.cam_files[0]), want)
    np.testing.assert_array_equal(convert.load_image(sp.cam_files[0]), want)


def test_load_image_refuses_other_formats(tmp_path):
    from PIL import Image

    z = np.zeros((4, 5), np.uint8)
    bad = {"la.png": Image.fromarray(np.stack([z, z], -1)),
           "rgba.png": Image.fromarray(np.stack([z, z, z, z], -1)),
           "palette.png": Image.fromarray(z).convert("P"),
           "gray16.png": Image.fromarray(z.astype(np.uint16))}
    for name, img in bad.items():
        img.save(str(tmp_path / name))
        with pytest.raises(ValueError, match="unsupported PNG"):
            convert.load_image(str(tmp_path / name))
    # a row filter type beyond the five
    good = str(tmp_path / "g.png")
    png.write_png(good, np.zeros((3, 4), np.uint8))
    raw = open(good, "rb").read()
    i = raw.index(b"IDAT")
    n = struct.unpack(">I", raw[i - 4:i])[0]
    rows = bytearray(zlib.decompress(raw[i + 4:i + 4 + n]))
    rows[2 * 13] = 5  # row 2's filter byte (1 + 4 * 3 bytes a row)
    idat = zlib.compress(bytes(rows))
    (tmp_path / "f5.png").write_bytes(
        raw[:i - 4] + struct.pack(">I", len(idat)) + b"IDAT" + idat
        + struct.pack(">I", zlib.crc32(b"IDAT" + idat)) + raw[i + 8 + n:])
    with pytest.raises(ValueError, match="row 2 has filter type 5"):
        convert.load_image(str(tmp_path / "f5.png"))
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(ValueError, match="unsupported image format"):
        convert.load_image(str(tmp_path / "x.jpg"))


def _recompressed(raw: bytes, name: str, codec) -> bytes:
    """The bag `raw` with its chunk's data compressed by `codec` and its
    header naming `name`."""
    out = bytearray(raw[:13])
    for h, data in rosbag._iter_records(raw, 13):
        if h["op"][0] == rosbag.OP_CHUNK:
            h, data = dict(h, compression=name.encode()), codec(data)
        out += rosbag.BagWriter._rec(h, data)
    return bytes(out)


def test_bag_parse_matches_jax(sessions):
    for key in ("bag", "bag_mono"):
        path = sessions[key]
        conns, msgs = rosbag.read_bag(path)
        jconns, jmsgs = jrosbag.read_bag(path)
        assert {k: tuple(v) for k, v in conns.items()} == \
            {k: tuple(v) for k, v in jconns.items()}
        assert [tuple(m) for m in msgs] == [tuple(m) for m in jmsgs]
        assert rosbag.bag_topics(path) == jrosbag.bag_topics(path)
        parse = {"Imu": "parse_imu", "Image": "parse_image",
                 "CameraInfo": "parse_camera_info",
                 "Odometry": "parse_odometry"}
        n = {}
        for m in msgs:
            kind = conns[m.conn_id].msg_type.split("/")[-1]
            got = getattr(rosbag, parse[kind])(m.data)
            ref = getattr(jrosbag, parse[kind])(m.data)
            if isinstance(got, dict):
                assert got.keys() == ref.keys()
                got, ref = list(got.values()), list(ref.values())
            for x, y in zip(got, ref):
                np.testing.assert_array_equal(x, y)
            n[kind] = n.get(kind, 0) + 1
        stereo = key == "bag"
        assert n["Image"] == FRAMES * (2 if stereo else 1)
        assert n["CameraInfo"] == (2 if stereo else 1)
        assert n.get("Odometry", 0) == (FRAMES if stereo else 0)
    # a bz2 chunk reads as the uncompressed one; lz4 raises in both
    import bz2

    raw = open(sessions["bag"], "rb").read()
    d = sessions["dir"]
    (d / "bz2.bag").write_bytes(_recompressed(raw, "bz2", bz2.compress))
    (d / "lz4.bag").write_bytes(_recompressed(raw, "lz4", lambda b: b))
    got = rosbag.read_bag(str(d / "bz2.bag"))
    assert [tuple(m) for m in got[1]] == \
        [tuple(m) for m in rosbag.read_bag(sessions["bag"])[1]]
    assert [tuple(m) for m in got[1]] == \
        [tuple(m) for m in jrosbag.read_bag(str(d / "bz2.bag"))[1]]
    for mod in (rosbag, jrosbag):
        with pytest.raises(ValueError, match="lz4"):
            mod.read_bag(str(d / "lz4.bag"))


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("key", ["bag", "bag_mono"])
def test_rosbag_to_asl_matches_jax(sessions, key):
    d = sessions["dir"]
    got = rosbag.rosbag_to_asl(sessions[key], str(d / f"{key}_port"),
                               max_frames=FRAMES - 2)
    ref = jrosbag.rosbag_to_asl(sessions[key], str(d / f"{key}_jax"),
                                max_frames=FRAMES - 2)
    assert _tree(got) == _tree(ref)
    s = dataset.load_euroc(got)
    assert len(s.cam_files) == FRAMES - 2
    if key == "bag":
        # the same session as the ASL tree written from the same frames:
        # intrinsics from CameraInfo, baseline from the projection matrix,
        # ground truth from Odometry
        a = dataset.load_euroc(sessions["pgm"])
        assert s.intrinsics == a.intrinsics
        assert s.baseline == a.baseline
        np.testing.assert_array_equal(s.gt_q, a.gt_q)
        np.testing.assert_array_equal(s.gt_t, a.gt_t)
        np.testing.assert_array_equal(s.cam_ts, a.cam_ts[:FRAMES - 2])
        np.testing.assert_array_equal(s.gyro, a.gyro)
        np.testing.assert_array_equal(s.accel, a.accel)
        for p, q in zip(s.cam1_files, a.cam1_files):
            np.testing.assert_array_equal(convert.load_image(p),
                                          convert.load_image(q))


def test_writers_write_the_jax_bytes(seq, tmp_path):
    rs = np.random.default_rng(3)
    # BagWriter: every serializer, through one bag, byte for byte
    paths, quats = {}, rs.normal(size=(3, 4))
    for name, mod in (("port", rosbag), ("jax", jrosbag)):
        p = str(tmp_path / f"{name}.bag")
        w = mod.BagWriter(p)
        B = mod.BagWriter
        for k in range(3):
            ns = 1_000_000_000 * k + 123_456_789
            w.write("/cam0/image_raw", "sensor_msgs/Image", ns,
                    B.ser_image(ns, seq.left[k] * 130.0))
            w.write("/imu0", "sensor_msgs/Imu", ns,
                    B.ser_imu(ns, seq.gyro[k], seq.accel[k]))
            w.write("/gt", "nav_msgs/Odometry", ns,
                    B.ser_odometry(ns, seq.t_gt[k], quats[k]))
        w.write("/cam0/camera_info", "sensor_msgs/CameraInfo", 7,
                B.ser_camera_info(7, W, H, *INTR, baseline=BASE))
        assert B.ser_header(5, "x") == \
            (jrosbag if mod is rosbag else rosbag).BagWriter.ser_header(5,
                                                                        "x")
        w.close()
        paths[name] = p
    assert open(paths["port"], "rb").read() == open(paths["jax"],
                                                    "rb").read()
    # write_png: grayscale and RGB
    for i, img in enumerate((rs.integers(0, 256, (17, 23), np.uint8),
                             rs.integers(0, 256, (9, 31, 3), np.uint8))):
        a, b = str(tmp_path / f"p{i}.png"), str(tmp_path / f"j{i}.png")
        png.write_png(a, img)
        jpng.write_png(b, img)
        assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
    # the annotation helpers are copies too
    np.testing.assert_array_equal(png.render_text("lc 12.5m", 2),
                                  jpng.render_text("lc 12.5m", 2))
    im = rs.integers(0, 256, (20, 30), np.uint8)
    np.testing.assert_array_equal(
        png.annotate_pair(im, im[:15], "d 3.2"),
        jpng.annotate_pair(im, im[:15], "d 3.2"))
