"""The port's bulk embedder on one device against the JAX package's
``ShardedEmbedder`` on a one-CPU-device mesh (CPU, resnet18, the
name-seeded init): 10 frames at batch 4, so a ragged tail is padded and
trimmed and the int8 path calibrates on the first batch; f32 at 1e-3,
int8 at per-row cosine > 0.999 (the JAX forward is jitted, so XLA may
fuse a quantize without rounding to bf16 first and flip an int8 value).
Then the CLI, ``save_embedded_obs --source pickle --mesh_shape 1,1
--disable_pretrained_embedding`` with ``--sharded_embed`` and with
``--quantize_embed``, against the JAX CLI's pickles on one FakeNav
scene, and what still raises."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pvr_habitat_tpu.data import formats as jformats
from pvr_habitat_tpu.data.embed_pipeline import ShardedEmbedder as JaxEmbedder
from pvr_habitat_tpu.parallel import mesh as pmesh
from pvr_habitat_tpu.tools import save_embedded_obs as jembed
from pvr_habitat_tpu.tools import save_opt_trajectories as jdatagen
from pvr_habitat_tpu_torch.data.embed_pipeline import ShardedEmbedder
from pvr_habitat_tpu_torch.tools import save_embedded_obs

NAME = "resnet18"
ENV = "FakePointNav-office_0"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on a few cores: torch's
    and BLAS's thread pools stay small here (the results do not depend
    on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(threads)


def _row_cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _mesh():
    return pmesh.make_mesh((1, 1), devices=jax.devices("cpu")[:1])


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_sharded_embedder_matches_jax(quantize):
    frames = np.random.RandomState(0).randint(0, 256, (10, 64, 64, 3),
                                              np.uint8)
    want = JaxEmbedder(NAME, mesh=_mesh(), batch_size=4, pretrained=False,
                       compute_dtype=jnp.float32,
                       quantize=quantize).embed_all(frames)
    emb = ShardedEmbedder(NAME, device="cpu", batch_size=4,
                          compute_dtype=torch.float32, pretrained=False,
                          quantize=quantize)
    assert emb.fused == "off"
    got = emb.embed_all(frames)
    assert got.dtype == np.float32 and got.shape == want.shape == (10, 512)
    assert np.isfinite(got).all()
    if quantize:
        # calibrated on the first staged batch, kept as floats
        assert emb._scales and all(isinstance(v, float)
                                   for v in emb._scales.values())
        assert _row_cos(got, want).min() > 0.999
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert emb.embed_all(frames[:0]).shape == (0, 512)
    np.testing.assert_array_equal(emb.embed_local(frames), got)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """Two FakeNav trajectories of 12 steps written by the JAX tool."""
    path = tmp_path_factory.mktemp("raw")
    fl = jdatagen.build_tool_parser().parse_args(
        ["--env", ENV, "--save_path", str(path), "--n_trajectories", "2",
         "--max_episode_steps", "12"])
    jdatagen.gen_data_habitat(fl)
    return path


def _cli_args(path, option):
    return ["--env", ENV, "--data_path", str(path), "--embedding_name",
            NAME, "--source", "pickle", "--batch_size", "16",
            "--mesh_shape", "1,1", "--disable_pretrained_embedding", option]


@pytest.mark.parametrize("option", ["--sharded_embed", "--quantize_embed"])
def test_cli_matches_jax(raw_dir, tmp_path, option):
    paths = {}
    for label in ("jax", "port"):
        path = tmp_path / label
        path.mkdir()
        shutil.copy(jformats.raw_path(str(raw_dir), ENV),
                    jformats.raw_path(str(path), ENV))
        paths[label] = path
    want = jformats.load_pickle(jembed.run(
        jembed.build_tool_parser().parse_args(_cli_args(paths["jax"],
                                                        option))))
    flags = save_embedded_obs.build_tool_parser().parse_args(
        _cli_args(paths["port"], option) + ["--disable_cuda"])
    got = jformats.load_pickle(save_embedded_obs.run(flags))
    assert set(got) == set(want)
    for key in want:
        assert len(got[key]) == len(want[key]) > 0, key
    for key in ("action", "reward", "done", "true_state"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))
    obs_got = np.asarray(got["obs"], np.float32)
    obs_want = np.asarray(want["obs"], np.float32)
    if option == "--quantize_embed":
        assert _row_cos(obs_got, obs_want).min() > 0.999
    else:
        np.testing.assert_allclose(obs_got, obs_want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("args,match", [
    (["--source", "png"], "png"),
    (["--source", "pickle", "--mesh_shape", "2,1"], "mesh_shape"),
    (["--source", "pickle", "--mesh_shape", "2"], "mesh_shape"),
    (["--source", "pickle", "--coordinator", "localhost:1234"],
     "coordinator"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, args, match):
    flags = save_embedded_obs.build_tool_parser().parse_args(
        ["--env", ENV, "--data_path", str(tmp_path), "--embedding_name",
         NAME, "--sharded_embed", "--disable_cuda"] + args)
    with pytest.raises(NotImplementedError, match=match):
        save_embedded_obs.run(flags)


def test_embedder_and_cli_run_on_the_card_unless_asked(raw_dir):
    """Without CUDA the embedder and the CLI raise unless the CPU is asked
    for; nothing falls back to it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedEmbedder(NAME, pretrained=False)
    for option in ("--sharded_embed", "--quantize_embed"):
        flags = save_embedded_obs.build_tool_parser().parse_args(
            _cli_args(raw_dir, option))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            save_embedded_obs.run(flags)
