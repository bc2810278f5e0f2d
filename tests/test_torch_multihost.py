"""The port's multi-process paths over ``torch.distributed`` (CPU, 2 ranks
over gloo, launched by ``parallel/dryrun.py``) against the JAX package:
the mesh and the slices; ``embed_local``'s slices cover the rows, each
rank's at 1e-4 against the JAX ``EmbeddingNet`` in one process (as
``tests/test_multihost.py``); ``save_embedded_obs --sharded_embed`` over
2 ranks writes the one-process pickle; a data-parallel ``main_bc_2``
run with ``--batch_norm`` (B 8, T 10) keeps the ranks' losses and
gradient norms exactly equal and matches the JAX trainer on one device
at rtol 1e-4; the dry run.  Each launch has its own time limit."""

import os
import shlex
import shutil

import numpy as np
import pytest
import torch

from pvr_habitat_tpu.data import formats as jformats
from pvr_habitat_tpu.models.embedding_net import EmbeddingNet as JaxNet
from pvr_habitat_tpu.parallel import multihost as jmultihost
from pvr_habitat_tpu.tools import save_opt_trajectories as jdatagen
from pvr_habitat_tpu.train import bc as jbc
from pvr_habitat_tpu.utils.flags import default_flags as jdefault_flags
from pvr_habitat_tpu_torch.parallel import dryrun, multihost
from pvr_habitat_tpu_torch.parallel import mesh as pmesh
from pvr_habitat_tpu_torch.tools import save_embedded_obs

LAUNCH_TIMEOUT = 240
ENV = "FakePointNav-hotel_0"
# the ranks keep to one thread each beside the suite's other workers
RANK_ENV = {"OMP_NUM_THREADS": "1"}


def test_mesh_and_slices():
    assert pmesh.parse_mesh_shape("") is None
    assert pmesh.parse_mesh_shape("4") == (4, 1)
    assert pmesh.parse_mesh_shape("4,2") == (4, 2)
    assert pmesh.make_mesh().shape == {"data": 1, "model": 1}
    assert pmesh.make_mesh((2, 1), n_devices=2).data == 2
    with pytest.raises(ValueError, match=r"mesh \(3, 3\) != 1 devices"):
        pmesh.make_mesh((3, 3))
    # a 'model' axis (tensor parallelism) builds the mesh; without a
    # group this process is rank 0, at data and model index 0
    assert pmesh.make_mesh((2, 2), n_devices=4) == pmesh.Mesh(2, 2)
    assert pmesh.make_mesh((2, 2), n_devices=4).shape == \
        {"data": 2, "model": 2}
    for n in (0, 1, 7, 37):
        for p in (1, 2, 3):
            slices = [multihost.process_slice(n, p, i) for i in range(p)]
            assert slices == [jmultihost.process_slice(n, p, i)
                              for i in range(p)]
            assert slices[0][0] == 0 and slices[-1][1] == n
    assert multihost.world() == (1, 0)
    assert multihost.process_slice(5) == (0, 5)


A2 = [("a", 1), ("a", 1)]                    # 2 ranks, one card
A2_4 = [("a", 4), ("a", 4)]                  # 2 ranks, 4 cards
AB16 = [("a", 8)] * 8 + [("b", 8)] * 8       # 2 hosts of 8 cards, 16 ranks
AB2 = [("a", 1), ("b", 1)]                   # 2 hosts of one card each
AB5 = [("a", 2)] * 2 + [("b", 2)] * 3        # host b has a rank too many


@pytest.mark.parametrize("device,layout,rank,backend,local_rank", [
    ("cpu", A2, 1, "gloo", 1),
    ("cuda", A2, 1, "gloo", 1),
    ("cuda", A2_4, 1, "nccl", 1),
    ("cuda", AB16, 9, "nccl", 1),
    ("cuda", AB2, 1, "nccl", 0),
    ("cuda", AB5, 0, "gloo", 0),
], ids=["cpu", "one-card", "own-cards", "two-hosts", "a-card-a-host",
        "two-hosts-crowded"])
def test_backend_follows_the_devices(device, layout, rank, backend,
                                     local_rank):
    """NCCL only when every host has a card for each of its ranks; the
    local rank counts the ranks of this rank's host only."""
    got, local, why = multihost.choose_backend(device, layout, rank)
    assert (got, local) == (backend, local_rank), why
    if device == "cuda" and backend == "gloo":
        assert "share" in why and "NCCL refuses" in why


def test_one_rank_joins_through_the_store(capsys):
    """``initialize`` posts the layout to the coordinator's store and
    forms the group on it (one CPU rank)."""
    assert multihost.initialize(f"localhost:{dryrun.free_port()}", 1, 0,
                                torch.device("cpu")) == torch.device("cpu")
    try:
        assert multihost.world() == (1, 0)
        assert torch.distributed.get_backend() == "gloo"
    finally:
        torch.distributed.destroy_process_group()
    assert "rank 0 of 1, backend gloo (the ranks run on the CPU)" in \
        capsys.readouterr().out


def test_dryrun_multichip_two_ranks(capsys):
    dryrun.dryrun_multichip(2, timeout=LAUNCH_TIMEOUT)
    out = capsys.readouterr().out
    assert out.count("MLP policy") == out.count("conv policy") == 2, out
    assert out.count("ranks equal OK") == 4, out
    assert out.count("sharded embedder parity OK") == 2, out
    assert "backend gloo" in out


GROUP = ["--coordinator", "localhost:1", "--num_processes", "2",
         "--process_id", "1"]


@pytest.mark.parametrize("task", ["multichip", "embed", "steps"])
def test_dryrun_ranks_run_on_the_card_unless_asked(monkeypatch, task):
    """Without ``--device`` a rank resolves the card, and raises without
    CUDA before it joins a group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main([task] + GROUP)


@pytest.mark.parametrize("device,bc_flags,disable_cuda", [
    (None, "", False), ("cpu", "", True), (None, "--disable_cuda", True)],
    ids=["default", "device-cpu", "bc-flags"])
def test_dryrun_train_keeps_the_bc_flags_device(device, bc_flags,
                                                 disable_cuda):
    """The train task asks for the CPU only with ``--device cpu`` or when
    its BC flags do; it passes the rank's group flags on."""
    argv = ["train", f"--bc_flags={bc_flags}"] + GROUP
    if device:
        argv += ["--device", device]
    flags = dryrun.train_flags(dryrun._parser().parse_args(argv))
    assert flags.disable_cuda is disable_cuda
    assert (flags.coordinator, flags.num_processes, flags.process_id) == \
        ("localhost:1", 2, 1)


def test_two_ranks_embed_local_matches_jax(tmp_path):
    prefix = str(tmp_path / "rank")
    logs = dryrun.launch(2, ["embed", "--device", "cpu", "--out", prefix,
                             "--frames", "37", "--batch_size", "16",
                             "--name", "random"],
                         LAUNCH_TIMEOUT, RANK_ENV)
    assert all("backend gloo" in log for log in logs)
    frames = np.random.RandomState(dryrun.SEED).randint(
        0, 256, size=(37, 64, 64, 3), dtype=np.uint8)
    want = JaxNet("random", pretrained=False)(frames)
    covered = np.zeros(37, bool)
    for rank in range(2):
        out = np.load(f"{prefix}{rank}.npz")
        start, stop = int(out["start"]), int(out["stop"])
        assert (start, stop) == jmultihost.process_slice(37, 2, rank)
        assert out["local"].dtype == np.float32
        np.testing.assert_allclose(out["local"], want[start:stop],
                                   atol=1e-4, rtol=1e-4)
        covered[start:stop] = True
    assert covered.all()


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("raw")
    fl = jdatagen.build_tool_parser().parse_args(
        ["--env", ENV, "--save_path", str(path), "--n_trajectories", "3",
         "--max_episode_steps", "15"])
    jdatagen.gen_data_habitat(fl)
    return path


def test_two_ranks_save_embedded_obs_writes_one_process_pickle(raw_dir,
                                                               tmp_path):
    args = ["--env", ENV, "--embedding_name", "random", "--source",
            "pickle", "--batch_size", "8", "--sharded_embed",
            "--disable_cuda"]
    paths = {}
    for label in ("one", "two"):
        paths[label] = tmp_path / label
        paths[label].mkdir()
        shutil.copy(jformats.raw_path(str(raw_dir), ENV),
                    jformats.raw_path(str(paths[label]), ENV))
    save_embedded_obs.run(save_embedded_obs.build_tool_parser().parse_args(
        args + ["--data_path", str(paths["one"])]))
    logs = dryrun.launch(
        2, args + ["--data_path", str(paths["two"]), "--mesh_shape", "2"],
        LAUNCH_TIMEOUT, RANK_ENV,
        module="pvr_habitat_tpu_torch.tools.save_embedded_obs")
    assert all("backend gloo" in log for log in logs)
    name = f"{ENV}_random.pickle"
    want = jformats.load_pickle(str(paths["one"] / name))
    got = jformats.load_pickle(str(paths["two"] / name))
    assert got.keys() == want.keys()
    for key in ("action", "reward", "done", "true_state"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["obs"], want["obs"], atol=1e-5, rtol=1e-5)
    assert sorted(os.listdir(paths["two"])) == sorted(os.listdir(paths["one"]))


def test_two_ranks_data_parallel_main_bc_2_matches_jax(tmp_path):
    """``--mesh_shape 2`` over 2 ranks with ``--batch_norm``: every rank
    trains on 4 of the 8 columns; the ranks' losses, gradient norms and
    eval returns are equal, bit for bit, and match the JAX trainer on
    one device with the same flags and data; rank 0 wrote the stats."""
    rng = np.random.RandomState(3)
    n = 200
    jformats.save_embedded(
        jformats.embedded_path(str(tmp_path), ENV, "resnet50"),
        obs=rng.randn(n, 32).astype(np.float32),
        action=rng.randint(0, 3, size=n).astype(np.int64),
        reward=rng.rand(n).astype(np.float32),
        done=(rng.rand(n) < 0.1),
        true_state=rng.randn(n, 12).astype(np.float32))
    common = dict(env=ENV, to_env=ENV, embedding_name="true_state",
                  data_path=str(tmp_path), batch_size=8, unroll_length=10,
                  max_frames=160, eval_frequency=1, n_episodes_test=1,
                  max_episode_steps=10, batch_norm=True)
    bc_flags = " ".join(
        f"--{k} {shlex.quote(str(v))}" for k, v in common.items()
        if k != "batch_norm") + " --batch_norm --mesh_shape 2 " \
        f"--save_path {shlex.quote(str(tmp_path / 'port'))}"
    prefix = str(tmp_path / "train")
    logs = dryrun.launch(2, ["train", "--device", "cpu", "--out", prefix,
                             "--bc_flags", bc_flags], LAUNCH_TIMEOUT,
                         RANK_ENV)
    assert all("data parallel: 2 ranks" in log for log in logs)
    r0, r1 = (np.load(f"{prefix}{rank}.npz") for rank in range(2))
    assert r0["loss"].shape == (3,) and np.isfinite(r0["loss"][1:]).all()
    for key in ("loss", "gnorm", "ret"):
        np.testing.assert_array_equal(r0[key], r1[key])

    want = jbc.run(jdefault_flags(save_path=str(tmp_path / "jax"),
                                  disable_save=True, **common))[ENV]
    np.testing.assert_allclose(r0["loss"][1:], want["training_loss"][1:],
                               rtol=1e-4)
    np.testing.assert_allclose(r0["gnorm"][1:], want["gradient_norm"][1:],
                               rtol=1e-4)
    np.testing.assert_array_equal(r0["ret"], want["episode_return"])
    stem = f"{ENV}_emtrue_state_s1_{ENV}"
    stats = jformats.load_pickle(str(tmp_path / "port" / f"{stem}.pickle"))
    np.testing.assert_array_equal(stats[ENV]["training_loss"], r0["loss"])
    assert os.path.isfile(tmp_path / "port" / f"{stem}.tar")
