"""The data layer against the reference and OpenCV: PNG decode / encode
(`utils/png.py`, the port's stand-in for cv2.imread / cv2.imwrite), the
TUM reader (`utils/io_tum.py`), the synthetic world's TUM export, the
native prefetching loader, ATE / RPE (`utils/evaluate.py`),
`se3.quat_to_rotmat`, `camera.BONN` and `config.tum_config` / `load_yaml`.
Tolerances: PNG samples bitwise (a colour image's gray within 1 level,
the reference's own loader tolerance), ATE / RPE / rotations 1e-6."""

import dataclasses
import os
import zlib

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lc_crf_slam_tpu import config as ref_config
from lc_crf_slam_tpu.geometry import camera as ref_camera
from lc_crf_slam_tpu.geometry import se3 as ref_se3
from lc_crf_slam_tpu.utils import evaluate as ref_eval
from lc_crf_slam_tpu.utils import io_tum as ref_io
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import config
from lc_crf_slam_torch.geometry import camera, se3
from lc_crf_slam_torch.utils import evaluate, io_tum, native_loader, png
from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

import torch_parity  # noqa: F401  (thread count)

TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The same 8-frame TUM3 world exported by the reference (cv2) and by
    the port (utils/png.py)."""
    d_ref = str(tmp_path_factory.mktemp("ref_export"))
    d_port = str(tmp_path_factory.mktemp("port_export"))
    RefWorld(cam=ref_camera.TUM3, n_frames=8, n_static=500, n_dynamic=0, seed=13,
             pixel_noise=0.0, depth_noise=0.0).export_tum_sequence(d_ref)
    SyntheticWorld(cam=camera.TUM3, n_frames=8, n_static=500, n_dynamic=0, seed=13,
                   pixel_noise=0.0, depth_noise=0.0).export_tum_sequence(d_port)
    return d_ref, d_port


# ---- PNG ---------------------------------------------------------------

def test_png_decode_equals_cv2_on_both_exports(exports):
    """Gray-replicated RGB and 16-bit depth, written by cv2 and by the
    port: the port's decode is cv2.imread's, bitwise."""
    for d in exports:
        for _, (rel,) in io_tum.read_file_list(os.path.join(d, "rgb.txt"))[:3]:
            path = os.path.join(d, rel)
            np.testing.assert_array_equal(
                png.imread_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
            np.testing.assert_array_equal(
                png.imread(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1])
        for _, (rel,) in io_tum.read_file_list(os.path.join(d, "depth.txt"))[:3]:
            path = os.path.join(d, rel)
            got, want = png.imread(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)
            assert got.dtype == want.dtype == np.uint16
            np.testing.assert_array_equal(got, want)


def test_png_colour_to_gray_within_one_level(tmp_path):
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, bgr)
    np.testing.assert_array_equal(png.imread(path), bgr[..., ::-1])
    diff = png.imread_gray(path).astype(int) - cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert np.abs(diff).max() <= 1
    # RGBA: alpha dropped before the luma, as cv2's grayscale read
    bgra = rng.integers(0, 256, (20, 30, 4), dtype=np.uint8)
    cv2.imwrite(path, bgra)
    diff = png.imread_gray(path).astype(int) - cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert np.abs(diff).max() <= 1


def _filtered_png(img: np.ndarray, filters, colour: int, depth: int) -> bytes:
    """A PNG whose rows cycle through `filters` (PNG spec §9 forward
    filters on the raw bytes)."""
    h = img.shape[0]
    bpp = (img.shape[2] if img.ndim == 3 else 1) * depth // 8
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    x = raw.view(np.uint8).reshape(h, -1).astype(np.int32)
    rows = []
    for r in range(h):
        a = np.concatenate([np.zeros(bpp, np.int32), x[r, :-bpp]])
        b = x[r - 1] if r else np.zeros_like(x[r])
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = filters[r % len(filters)]
        pred = [np.zeros_like(a), a, b, (a + b) // 2, paeth][f]
        rows.append(np.concatenate([[f], (x[r] - pred) & 255]).astype(np.uint8))
    ihdr = np.array([img.shape[1], h], ">u4").tobytes() + bytes([depth, colour, 0, 0, 0])
    return (png._SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes()))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("kind", ["rgb8", "gray8", "rgba8", "gray16"])
def test_png_row_filters(tmp_path, filters, kind):
    """Every row filter, on every decoded format: the stored samples
    back, and what cv2 reads from the same file."""
    rng = np.random.default_rng(len(filters) * 7 + filters[0])
    shape, colour, depth, dtype = {
        "rgb8": ((23, 31, 3), 2, 8, np.uint8), "gray8": ((23, 31), 0, 8, np.uint8),
        "rgba8": ((23, 31, 4), 6, 8, np.uint8), "gray16": ((23, 31), 0, 16, np.uint16),
    }[kind]
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as fh:
        fh.write(_filtered_png(img, filters, colour, depth))
    got = png.imread(path)
    np.testing.assert_array_equal(got, img)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, want[..., [2, 1, 0, 3][:want.shape[2]]]
                                  if want.ndim == 3 else want)


def test_png_encode_reads_back_in_cv2(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (17, 29, 3), dtype=np.uint8)
    d16 = rng.integers(0, 65536, (17, 29), dtype=np.uint16)
    png.imwrite(str(tmp_path / "a.png"), rgb)
    png.imwrite(str(tmp_path / "b.png"), d16)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"))[..., ::-1], rgb)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "b.png"), cv2.IMREAD_UNCHANGED), d16)
    with pytest.raises(ValueError):
        png.encode(rgb.astype(np.float32))
    with pytest.raises(ValueError):
        png.decode(b"not a png")


# ---- TUM sequences -----------------------------------------------------

def test_exports_and_readers_cross(exports):
    """The reference's TUMSequence reads the port's export and the port's
    reads the reference's: equal timestamps, gray images and depth; the
    text files agree (ground-truth quaternions to the printed 1e-6)."""
    d_ref, d_port = exports
    for name in ("rgb.txt", "depth.txt"):
        assert (open(os.path.join(d_ref, name)).read()
                == open(os.path.join(d_port, name)).read())
    t_r, gt_r = ref_io.load_groundtruth(os.path.join(d_ref, "groundtruth.txt"))
    t_p, gt_p = io_tum.load_groundtruth(os.path.join(d_port, "groundtruth.txt"))
    np.testing.assert_array_equal(t_r, t_p)
    np.testing.assert_allclose(gt_r, gt_p, atol=1.5e-6)
    for reader, d in ((ref_io.TUMSequence, d_port), (io_tum.TUMSequence, d_ref)):
        a, b = reader(d), io_tum.TUMSequence(d_port)
        assert a.entries == b.entries and len(a) == 8
        for k in (0, 7):
            (ta, ga, da), (tb, gb, db) = a[k], b[k]
            assert ta == tb and ga.dtype == gb.dtype == np.float32
            np.testing.assert_array_equal(ga, gb)
            np.testing.assert_array_equal(da, db)


def test_file_lists_and_association(exports, tmp_path):
    d = exports[1]
    for name in ("rgb.txt", "groundtruth.txt"):
        assert io_tum.read_file_list(os.path.join(d, name)) == \
            ref_io.read_file_list(os.path.join(d, name))
    a = [(i / 30.0, [f"a{i}"]) for i in range(30)]
    b = [(i / 30.0 + 0.003, [f"b{i}"]) for i in range(0, 30, 2)]
    assert io_tum.associate(a, b) == ref_io.associate(a, b)
    assert io_tum.associate(a, b, offset=0.01) == ref_io.associate(a, b, offset=0.01)
    assoc = tmp_path / "assoc.txt"
    assoc.write_text("# t rgb t depth\n0.1 rgb/a.png 0.11 depth/a.png\n"
                     "0.2 rgb/b.png 0.21 depth/b.png\n")
    assert io_tum.load_association_file(str(assoc)) == \
        ref_io.load_association_file(str(assoc))


def _random_trajectory(rng, n):
    ts = np.arange(n) / 30.0
    poses = np.tile(np.eye(4), (n, 1, 1))
    pos = np.cumsum(rng.normal(0, 0.02, (n, 3)), axis=0)
    for i in range(n):
        w = 0.1 * np.sin(np.array([i / 10.0, i / 7.0, i / 13.0]))
        poses[i, :3, :3] = se3.exp_so3(torch.tensor(w)).numpy()
        poses[i, :3, 3] = pos[i]
    return ts, poses


def test_trajectory_roundtrip_and_quat_to_rotmat(tmp_path):
    rng = np.random.default_rng(3)
    ts, poses = _random_trajectory(rng, 20)
    path = str(tmp_path / "traj.txt")
    io_tum.write_trajectory_tum(path, ts, poses)
    ts2, poses2 = io_tum.read_trajectory_tum(path)
    np.testing.assert_allclose(ts2, ts, atol=TOL)
    np.testing.assert_allclose(poses2, poses, atol=1e-5)     # 7 printed digits
    ts3, poses3 = ref_io.read_trajectory_tum(path)
    np.testing.assert_array_equal(ts2, ts3)
    np.testing.assert_allclose(poses2, poses3, atol=TOL)
    q = rng.normal(size=(50, 4))
    np.testing.assert_allclose(
        se3.quat_to_rotmat(torch.tensor(q)).numpy(),
        np.asarray(ref_se3.quat_to_rotmat(jnp.asarray(q, jnp.float32))), atol=TOL)


# ---- ATE / RPE ---------------------------------------------------------

@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_rpe_match_reference(with_scale):
    """Seeded noisy trajectories, moved rigidly (and scaled), against the
    ground truth, with a timestamp jitter the association must absorb."""
    rng = np.random.default_rng(11)
    ts, gt = _random_trajectory(rng, 120)
    R = se3.exp_so3(torch.tensor([0.3, -0.1, 0.2], dtype=torch.float64)).numpy()
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, [1.0, 2.0, -0.5]
    est = np.einsum("ij,njk->nik", T, gt)
    est[:, :3, 3] *= 0.7 if with_scale else 1.0
    est[:, :3, 3] += rng.normal(0, 0.03, (120, 3))
    ts_est = ts + rng.uniform(-0.005, 0.005, ts.shape)
    got = evaluate.evaluate_ate(ts_est, est, ts, gt, with_scale=with_scale)
    want = ref_eval.evaluate_ate(ts_est, est, ts, gt, with_scale=with_scale)
    assert got.n_pairs == want.n_pairs == 120
    for f in ("rmse", "mean", "median", "max"):
        assert abs(getattr(got, f) - getattr(want, f)) <= TOL, f
    assert 0.02 < got.rmse < 0.07
    for delta in (0.5, 1.0):
        g = evaluate.evaluate_rpe(ts_est, est, ts, gt, delta=delta)
        w = ref_eval.evaluate_rpe(ts_est, est, ts, gt, delta=delta)
        np.testing.assert_allclose(g, w, atol=TOL)
    assert evaluate._associate_timestamps(ts_est, ts) == \
        ref_eval._associate_timestamps(ts_est, ts)
    with pytest.raises(ValueError):
        evaluate.evaluate_ate(ts[:1], est[:1], ts, gt)


# ---- camera and config ------------------------------------------------

def test_bonn_tum_config_and_yaml_match_reference():
    assert camera.BONN == tuple(ref_camera.BONN)
    for preset in (1, 2, 3):
        cfg, cam = config.tum_config(preset, sensor="rgbd")
        ref_cfg, ref_cam = ref_config.tum_config(preset, sensor="rgbd")
        assert cam == tuple(ref_cam)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    with pytest.raises(ValueError):
        config.tum_config(4)
    for name in ("tum_static.yaml", "tum_walking.yaml"):
        path = os.path.join(REPO, "configs", name)
        assert dataclasses.asdict(config.load_yaml(path)) == \
            dataclasses.asdict(ref_config.load_yaml(path))


# ---- the native loader (tests/test_native_dataset.py's) ---------------

def _entries(d):
    return [(t_rgb, os.path.join(d, rp), t_d, os.path.join(d, dp))
            for t_rgb, rp, t_d, dp in io_tum.TUMSequence(d).entries]


def test_native_loader_builds():
    assert native_loader.build_native_runtime(), "native runtime failed to build"


def test_native_loader_matches_python_loader(exports):
    d = exports[1]
    assert native_loader.build_native_runtime()
    seq = io_tum.TUMSequence(d)
    ldr = native_loader.NativeTUMLoader(_entries(d), camera.TUM3.width, camera.TUM3.height)
    n = 0
    for k, (t, gray, depth) in enumerate(ldr):
        t_ref, gray_ref, depth_ref = seq[k]
        assert abs(t - t_ref) < 1e-9
        assert np.abs(gray - gray_ref).max() < 1.0     # float BT.601 vs libpng's
        np.testing.assert_allclose(depth, depth_ref, atol=1e-4)
        n += 1
    assert n == 8
    ldr.close()


def test_native_loader_early_close_does_not_hang(exports):
    d = exports[1]
    assert native_loader.build_native_runtime()
    ldr = native_loader.NativeTUMLoader(_entries(d), camera.TUM3.width,
                                        camera.TUM3.height, n_threads=8)
    it = iter(ldr)
    next(it)            # one frame consumed, the rest still queued
    ldr.close()
    assert list(it) == []      # a closed loader yields nothing more


def test_native_loader_compiles_from_source(tmp_path):
    """The fallback build: runtime/tum_loader.cc with runtime/build.sh's
    flags into a directory of the caller's, loadable with ctypes."""
    out = str(tmp_path / "libtumloader.so")
    assert native_loader.compile_native_runtime(out)
    lib = native_loader._load_lib(out)
    assert lib is not None and hasattr(lib, "tum_loader_next")
    assert native_loader._load_lib(str(tmp_path / "missing.so")) is None
