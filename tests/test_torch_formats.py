"""The port's PNG/JPEG layouts and image codec (``data/formats.py``,
``data/native.py``) against cv2, PIL and the JAX package: the native
library built under ``build/`` decodes as cv2 does, bit for bit; without
it decoding falls back to cv2, then PIL, with the JAX package's pixels,
and with neither raises naming what is missing; each package reads the
other's PNG files with equal pixels; the JPEG layout's files and pose
pickle equal the JAX package's; ``read_png_trajectories(embed_fn=...)``
matches the JAX reader at 1e-3 (f32); prefetch on and off agree."""

import os
import pickle
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from pvr_habitat_tpu.data import formats as jformats
from pvr_habitat_tpu.data import native as jnative
from pvr_habitat_tpu.models.embedding_net import EmbeddingNet as JaxNet
from pvr_habitat_tpu_torch.data import formats, native
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_traj(t_len=5, seed=0, channels=6):
    rng = np.random.RandomState(seed)
    obs = [rng.randint(0, 256, (64, 64, channels), np.uint8)
           for _ in range(t_len)]
    action = rng.randint(0, 3, t_len)
    reward = rng.rand(t_len).astype(np.float32)
    done = np.zeros(t_len, bool)
    done[-1] = True
    true_state = rng.randn(t_len, 12).astype(np.float32)
    return obs, action, reward, done, true_state


def _image(seed, hw=(64, 64)):
    """A frame with smooth regions and noise, so that libpng's adaptive
    filtering picks several filter types."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:hw[0], :hw[1]]
    img = np.stack([x * 3 + y, y * 2, (x * y) % 256], -1) % 256
    img[hw[0] // 2:] = rng.randint(0, 256, (hw[0] - hw[0] // 2, hw[1], 3))
    return img.astype(np.uint8)


@pytest.fixture
def without(monkeypatch):
    """Block modules (cv2, PIL) and, with ``native=True``, the native
    library, so that the fallbacks run."""
    def block(*modules, native_lib=False):
        for name in modules:
            monkeypatch.setitem(sys.modules, name, None)
        if native_lib:
            monkeypatch.setattr(native, "_lib", None)
            monkeypatch.setattr(native, "_tried", True)
    return block


def test_native_codec_builds_under_build_and_matches_cv2(tmp_path):
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    paths = []
    for i in range(4):
        p = str(tmp_path / f"img_{i}.png")
        cv2.imwrite(p, np.random.RandomState(i).randint(
            0, 256, (64, 64, 3), np.uint8))
        paths.append(p)
    assert native.available(), f"native codec failed to build: {native._why}"
    assert native.codec() == "native"
    lib = native.library_path()
    assert lib.is_file() and lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "build"
    got = native.decode_batch(paths, 64, 64, kind="png", bgr=True)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(got[i], cv2.imread(p))
    # the JAX package's own build (its tests run ``make -C native``) may
    # add its library there meanwhile; the port adds nothing
    after = sorted(os.listdir(os.path.join(ROOT, "native")))
    assert set(after) - set(before) <= {"libpvr_codec.so"}


def test_native_jpeg_decode_and_count_frames(tmp_path):
    img = np.random.RandomState(2).randint(0, 256, (64, 64, 3), np.uint8)
    p = str(tmp_path / "img_0.jpeg")
    Image.fromarray(img).save(p)
    got = native.decode_batch([p], 64, 64, kind="jpeg", bgr=False)
    np.testing.assert_array_equal(
        got[0], np.asarray(Image.open(p).convert("RGB")))
    for i in range(7):
        cv2.imwrite(str(tmp_path / f"3_{i}.png"), img)
    assert native.count_frames(str(tmp_path), 3, "png", 500) == 7
    assert native.count_frames(str(tmp_path), 9, "png", 500) == 0


def _libpng_files(tmp_path):
    """PNG files written by cv2 and by PIL (libpng's adaptive filters)."""
    paths = []
    for i in range(3):
        p = str(tmp_path / f"cv2_{i}.png")
        cv2.imwrite(p, _image(10 + i))
        paths.append(p)
        p = str(tmp_path / f"pil_{i}.png")
        Image.fromarray(_image(20 + i)).save(p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("codec,blocked", [("cv2", ()), ("PIL", ("cv2",))])
def test_decode_falls_back_in_the_jax_order(tmp_path, without, codec,
                                            blocked):
    """Without the native library ``decode_batch`` decodes with cv2, and
    without cv2 with PIL, as the JAX package does: the pixels of
    cv2.imread in either channel order, equal to the JAX fallback's."""
    paths = _libpng_files(tmp_path)
    want = np.stack([cv2.imread(p) for p in paths])
    without(*blocked, native_lib=True)
    assert native.codec() == codec
    for bgr in (True, False):
        got = native.decode_batch(paths, 64, 64, kind="png", bgr=bgr)
        np.testing.assert_array_equal(got, want if bgr else want[..., ::-1])
        np.testing.assert_array_equal(got, jnative._decode_fallback(
            paths, np.empty_like(got), "png", bgr))
    if codec == "cv2":
        bad = tmp_path / "bad.png"
        bad.write_bytes(b"not a png")
        with pytest.raises(ValueError, match="bad.png"):
            native.decode_batch([str(bad)], 64, 64)


@pytest.mark.parametrize("kind", ["png", "jpeg"])
def test_decode_without_any_codec_raises(tmp_path, without, kind):
    paths = _libpng_files(tmp_path)[:1]
    without("cv2", "PIL", native_lib=True)
    assert native.codec() is None
    with pytest.raises(RuntimeError, match="native codec.*cv2 or PIL"):
        native.decode_batch(paths, 64, 64, kind=kind)


@pytest.mark.parametrize("layout,library", [("png", "cv2"), ("jpeg", "PIL")])
def test_layout_writer_without_its_library_raises(tmp_path, without, layout,
                                                  library):
    obs, action, reward, done, true_state = _fake_traj(channels=3)
    without(library)
    with pytest.raises(RuntimeError, match="not installed"):
        if layout == "png":
            formats.save_png_trajectory(str(tmp_path), 0, obs, action,
                                        reward, done, true_state)
        else:
            formats.save_jpeg_trajectory(str(tmp_path), 0, obs, true_state)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_png_layout_reads_across_packages(tmp_path, writer):
    """Each package reads the other's PNG layout with equal pixels and
    metadata (ImageNav: the goal frame is its own file)."""
    traj = _fake_traj(channels=6)
    save = (jformats if writer == "jax" else formats).save_png_trajectory
    save(str(tmp_path), 0, *traj)
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["0.pickle", "0_goal.png"] + [f"0_{i}.png" for i in range(5)])
    got = formats.read_png_trajectories(str(tmp_path))
    want = jformats.read_png_trajectories(str(tmp_path))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert got["obs"].shape == (5, 64, 64, 6)
    np.testing.assert_array_equal(got["obs"][..., :3],
                                  np.stack(traj[0])[..., :3])
    np.testing.assert_array_equal(got["obs"][..., 3:],
                                  np.broadcast_to(traj[0][-1][..., 3:],
                                                  (5, 64, 64, 3)))


def test_jpeg_layout_matches_jax(tmp_path):
    obs, _, _, _, true_state = _fake_traj(seed=4, channels=3)
    formats.save_jpeg_trajectory(str(tmp_path / "port"), 2, obs, true_state,
                                 frameskip=3)
    jformats.save_jpeg_trajectory(str(tmp_path / "jax"), 2, obs, true_state,
                                  frameskip=3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == [
        "2.pickle", "2_0.jpeg", "2_3.jpeg"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    with open(tmp_path / "port" / "2.pickle", "rb") as fh:
        assert pickle.load(fh).shape == (5, 8)


def test_png_embed_on_read_matches_jax(tmp_path):
    """ImageNav trajectories embedded as they are read (the goal frame
    embedded alone, N = 1) by the port's and the JAX package's readers
    and encoders, f32, 1e-3."""
    for t in range(2):
        formats.save_png_trajectory(str(tmp_path), t,
                                    *_fake_traj(t_len=3 + t, seed=t))
    net = EmbeddingNet("random", pretrained=False, device="cpu")
    got = formats.read_png_trajectories(str(tmp_path), embed_fn=net)
    want = jformats.read_png_trajectories(
        str(tmp_path), embed_fn=JaxNet("random", pretrained=False))
    assert got["obs"].shape == want["obs"].shape == (7, 2 * net.out_size)
    np.testing.assert_allclose(got["obs"], want["obs"], atol=1e-3, rtol=1e-3)
    for key in ("action", "reward", "done", "true_state"):
        np.testing.assert_array_equal(got[key], want[key])


def test_read_png_prefetch_matches_sync(tmp_path):
    for t in range(3):
        formats.save_png_trajectory(str(tmp_path), t,
                                    *_fake_traj(channels=6, seed=t))
    a = formats.read_png_trajectories(str(tmp_path), prefetch=2)
    b = formats.read_png_trajectories(str(tmp_path), prefetch=0)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    # a decode error on the producer thread surfaces in the consumer
    (tmp_path / "1_2.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="1_2.png"):
        formats.read_png_trajectories(str(tmp_path), prefetch=2)
