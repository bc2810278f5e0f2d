"""Tensor parallelism of the policy over the mesh's 'model' axis against
the JAX package: the sharding rules for every key, and the trainer on
2 CPU ranks (mesh 1,2) and 4 (mesh 2,2) over gloo, launched by
``parallel/dryrun.py`` with a time limit each.  Their 5-step losses and
pre-clip gradient norms match the JAX trainer on one device at rtol
1e-4 (as ``tests/test_torch_multihost.py`` holds data parallelism); the
gathered checkpoint matches a one-process port run at 1e-5 and loads in
the JAX package; a run resumes across the mesh and one process both
ways.  Small shapes: B 4, T 5, the true state's 12-d obs."""

import os
import shlex
import shutil

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pvr_habitat_tpu.data import formats as jformats
from pvr_habitat_tpu.models import policy as jpolicy
from pvr_habitat_tpu.models.registry import build_encoder as jbuild_encoder
from pvr_habitat_tpu.parallel import mesh as jmesh
from pvr_habitat_tpu.train import bc as jbc
from pvr_habitat_tpu.utils import checkpoint as jckpt
from pvr_habitat_tpu.utils.flags import default_flags as jdefault_flags
from pvr_habitat_tpu_torch.models import policy
from pvr_habitat_tpu_torch.models.registry import build_encoder
from pvr_habitat_tpu_torch.parallel import dryrun
from pvr_habitat_tpu_torch.parallel import mesh as pmesh
from pvr_habitat_tpu_torch.train import bc
from pvr_habitat_tpu_torch.utils import checkpoint as ckpt
from pvr_habitat_tpu_torch.utils.flags import default_flags

LAUNCH_TIMEOUT = 240
ENV = "FakePointNav-hotel_0"
STEM = f"{ENV}_emtrue_state_s1_{ENV}"
RANK_ENV = {"OMP_NUM_THREADS": "1"}
B, T, STEPS = 4, 5, 5
COMMON = dict(env=ENV, to_env=ENV, embedding_name="true_state",
              batch_size=B, unroll_length=T, eval_frequency=1,
              n_episodes_test=1, max_episode_steps=10, batch_norm=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The in-process runs keep torch and BLAS at one thread beside the
    suite's other workers (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


# -- the sharding rules -------------------------------------------------------


@pytest.mark.parametrize("conv,batch_norm", [(False, False), (False, True),
                                             (True, True)],
                         ids=["mlp", "mlp-bn", "conv-bn"])
def test_policy_param_spec_matches_jax(conv, batch_norm):
    """Every key of the policy: the JAX rule on the JAX shapes, the
    port's on the port's (the conv stem is OIHW here, HWIO there)."""
    rng = np.random.RandomState(0)
    if conv:
        obs = (64, 64, 3)
        want = jpolicy.init_conv_policy_params(rng, obs, 3, batch_norm)[0]
        got = policy.init_conv_policy_params(
            np.random.RandomState(0), obs, 3, batch_norm, device="cpu")[0]
    else:
        want = jpolicy.init_policy_params(rng, 2048, 3, batch_norm)[0]
        got = policy.init_policy_params(np.random.RandomState(0), 2048, 3,
                                        batch_norm, device="cpu")[0]
    assert sorted(got) == sorted(want)
    sharded = set()
    for key in want:
        spec = pmesh.policy_param_spec(key, tuple(got[key].shape))
        assert spec == tuple(jmesh.policy_param_spec(
            key, np.shape(want[key]))), key
        if spec:
            sharded.add(key)
    assert pmesh.sharded_keys(got) == sharded
    assert {k for k in sharded if k.startswith("core.")} == {
        f"core.{w}_{kind}_l{layer}" for w in ("weight", "bias")
        for kind in ("ih", "hh") for layer in (0, 1)}
    assert {k for k in sharded if k.startswith("fc.")} == {
        f"fc.{i}.weight" for i in ((1, 3) if batch_norm else (0, 2))}


@pytest.mark.parametrize("name", ["resnet50", "mae_base"])
def test_encoder_param_spec_matches_jax(name):
    """The JAX rule in HWIO, the port's in OIHW: the same axis split for
    every key (a conv's output channels, a linear's rows)."""
    want = jbuild_encoder(name, pretrained=False).params
    got = build_encoder(name, pretrained=False, device="cpu").params
    assert sorted(got) == sorted(want)
    n_sharded = 0
    for key, value in want.items():
        spec = tuple(jmesh.encoder_param_spec(key, np.shape(value)))
        if len(spec) == 4:       # HWIO -> OIHW
            spec = (spec[3], spec[2], spec[0], spec[1])
        assert pmesh.encoder_param_spec(key, tuple(got[key].shape)) == \
            spec, key
        n_sharded += bool(spec)
    assert n_sharded > 0


def test_shard_params_takes_contiguous_rows():
    """Rank m holds rows [m R/2, (m+1) R/2) of a sharded param: with a
    'model' axis of 2, rank 0 holds the i and f gates, rank 1 g and o."""
    params, _ = policy.init_policy_params(np.random.RandomState(0), 12, 3,
                                          device="cpu")
    for index in (0, 1):
        mesh = pmesh.Mesh(1, 2, model_index=index)
        part = pmesh.shard_params(mesh, params)
        assert sorted(part) == sorted(params)
        for key, value in params.items():
            if key in pmesh.sharded_keys(params):
                half = value.shape[0] // 2
                torch.testing.assert_close(
                    part[key], value[index * half:(index + 1) * half],
                    rtol=0, atol=0)
            else:
                assert part[key] is value
    i, f, g, o = params["core.weight_ih_l0"].chunk(4)
    rank0 = pmesh.shard_params(pmesh.Mesh(1, 2), params)
    torch.testing.assert_close(rank0["core.weight_ih_l0"],
                               torch.cat([i, f]), rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not split"):
        pmesh.shard_params(pmesh.Mesh(1, 3), params)


# -- the trainer on a mesh ----------------------------------------------------


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_data")
    rng = np.random.RandomState(3)
    n = 200
    jformats.save_embedded(
        jformats.embedded_path(str(path), ENV, "resnet50"),
        obs=rng.randn(n, 32).astype(np.float32),
        action=rng.randint(0, 3, size=n).astype(np.int64),
        reward=rng.rand(n).astype(np.float32),
        done=(rng.rand(n) < 0.1),
        true_state=rng.randn(n, 12).astype(np.float32))
    return str(path)


def _launch(nprocs, mesh_shape, data_path, save_path, prefix, steps=STEPS):
    """``main_bc_2`` over ``nprocs`` CPU ranks on ``mesh_shape``; returns
    each rank's (losses, gradient norms, returns)."""
    kw = dict(COMMON, data_path=data_path, save_path=save_path,
              max_frames=steps * B * T)
    bc_flags = " ".join(f"--{k} {shlex.quote(str(v))}" for k, v in kw.items()
                        if k != "batch_norm")
    bc_flags += f" --batch_norm --mesh_shape {mesh_shape}"
    logs = dryrun.launch(nprocs, ["train", "--device", "cpu", "--out",
                                  prefix, "--bc_flags", bc_flags],
                         LAUNCH_TIMEOUT, RANK_ENV)
    assert all("tensor parallel: 2 ranks a row" in log for log in logs)
    return [np.load(f"{prefix}{rank}.npz") for rank in range(nprocs)]


def _one_process(data_path, save_path, steps=STEPS):
    return bc.run(default_flags(**COMMON, data_path=data_path,
                                save_path=save_path, disable_cuda=True,
                                max_frames=steps * B * T))[ENV]


def _assert_checkpoints_close(got_path, want_path, tol=1e-5):
    got, want = ckpt.load_checkpoint(got_path), ckpt.load_checkpoint(
        want_path)
    for part in ("actor_model_state_dict",):
        assert sorted(got[part]) == sorted(want[part])
        for key, value in want[part].items():
            assert got[part][key].shape == value.shape, key
            np.testing.assert_allclose(got[part][key], value, rtol=tol,
                                       atol=tol, err_msg=key)
    g, w = (c["actor_model_optimizer_state_dict"] for c in (got, want))
    assert g["count"] == w["count"]
    assert sorted(g["square_avg"]) == sorted(w["square_avg"])
    for key, value in w["square_avg"].items():
        assert g["square_avg"][key].shape == value.shape, key
        np.testing.assert_allclose(g["square_avg"][key], value, rtol=tol,
                                   atol=tol, err_msg=key)
    assert got["scheduler_state_dict"] == want["scheduler_state_dict"]


@pytest.mark.parametrize("nprocs,mesh_shape", [(2, "1,2"), (4, "2,2")])
def test_mesh_trainer_matches_jax_and_one_process(nprocs, mesh_shape,
                                                  data_path, tmp_path):
    """``--mesh_shape 1,2`` (2 ranks) and ``2,2`` (4 ranks, B split over
    'data' too) with BatchNorm: every rank logs the same losses, gradient
    norms and eval returns, which match the JAX trainer on one device;
    rank 0's checkpoint is the whole state, the one-process file's within
    1e-5, and the JAX package restores it."""
    ranks = _launch(nprocs, mesh_shape, data_path, str(tmp_path / "mesh"),
                    str(tmp_path / "rank"))
    r0 = ranks[0]
    assert r0["loss"].shape == (STEPS + 1,)
    assert np.isfinite(r0["loss"][1:]).all()
    for r in ranks[1:]:
        for key in ("loss", "gnorm", "ret"):
            np.testing.assert_array_equal(r[key], r0[key])

    want = jbc.run(jdefault_flags(**COMMON, data_path=data_path,
                                  save_path=str(tmp_path / "jax"),
                                  max_frames=STEPS * B * T))[ENV]
    np.testing.assert_allclose(r0["loss"][1:], want["training_loss"][1:],
                               rtol=1e-4)
    np.testing.assert_allclose(r0["gnorm"][1:], want["gradient_norm"][1:],
                               rtol=1e-4)
    np.testing.assert_array_equal(r0["ret"], want["episode_return"])

    one = _one_process(data_path, str(tmp_path / "one"))
    np.testing.assert_allclose(r0["loss"][1:], one["training_loss"][1:],
                               rtol=1e-5)
    mesh_tar = str(tmp_path / "mesh" / f"{STEM}.tar")
    _assert_checkpoints_close(mesh_tar, str(tmp_path / "one" / f"{STEM}.tar"))
    # the JAX package restores the mesh's file like its own
    payload = jckpt.load_checkpoint(mesh_tar)
    jaxs = jckpt.load_checkpoint(str(tmp_path / "jax" / f"{STEM}.tar"))
    params, stats = jckpt.split_actor_state(payload["actor_model_state_dict"])
    jparams, _ = jckpt.split_actor_state(jaxs["actor_model_state_dict"])
    assert {k: np.shape(v) for k, v in params.items()} == \
        {k: np.shape(v) for k, v in jparams.items()}
    assert set(stats) == {"fc.0.running_mean", "fc.0.running_var"}
    assert jckpt.restore_opt_state(payload).count == STEPS
    assert not [f for f in os.listdir(tmp_path / "mesh")
                if f.endswith(".tmp")]


@pytest.mark.parametrize("first", ["mesh", "one"])
def test_resume_across_the_mesh_and_one_process(first, data_path, tmp_path):
    """3 epochs on the mesh (or in one process), then the run resumed to
    5 in one process and on the mesh from copies of its files: the two
    resumed runs log the same losses and write the same checkpoint."""
    start = str(tmp_path / "start")
    if first == "mesh":
        _launch(2, "1,2", data_path, start, str(tmp_path / "a"), steps=3)
    else:
        _one_process(data_path, start, steps=3)
    for label in ("one", "mesh"):
        shutil.copytree(start, str(tmp_path / label))
    one = _one_process(data_path, str(tmp_path / "one"))
    mesh = _launch(2, "1,2", data_path, str(tmp_path / "mesh"),
                   str(tmp_path / "b"))[0]
    # the resumed runs repeat the last frame count, as the reference does
    assert one["frames"] == [0, 0, 20, 40, 40, 60, 80]
    assert len(one["training_loss"]) == len(mesh["loss"]) == 7
    np.testing.assert_allclose(mesh["loss"][1:], one["training_loss"][1:],
                               rtol=1e-5)
    np.testing.assert_allclose(mesh["gnorm"][1:], one["gradient_norm"][1:],
                               rtol=1e-5)
    _assert_checkpoints_close(str(tmp_path / "mesh" / f"{STEM}.tar"),
                              str(tmp_path / "one" / f"{STEM}.tar"))


def test_dryrun_multichip_four_ranks_on_a_mesh(capsys):
    """The dry run on 4 ranks takes the JAX dry run's (2, 2) mesh: one
    step of the MLP and the conv policy, sharded over 'data' and
    'model', equals one process's."""
    dryrun.dryrun_multichip(4, timeout=LAUNCH_TIMEOUT)
    out = capsys.readouterr().out
    assert out.count("mesh {'data': 2, 'model': 2} MLP policy") == 4, out
    assert out.count("ranks equal OK") == 8, out
