"""The BC trainer (counterpart of ``pvr_habitat_tpu/train/bc.py``).

One parameterized ``run(flags, mode)`` implements the reference's three
entry points (cited lines are the behavior contract):

- mode='precomputed'   — main_bc_2.py:26-262 (train on cached embeddings)
- mode='embed_at_load' — main_bc_1.py:26-274 (embed raw frames at load
                         time; required for the seed-dependent 'random'
                         encoder)
- mode='finetune'      — main_bc_finetune.py:25-247 (end-to-end conv
                         policy on raw pixels; no frozen encoder)

Everything runs on ``cuda`` unless ``--disable_cuda`` asks for the CPU.
``--coordinator host:port --num_processes n --process_id i`` makes the
run one rank of n over ``torch.distributed`` (``parallel/multihost.py``)
on a ``--mesh_shape d,m`` mesh of d·m = n ranks (none: every process on
'data'; ``parallel/mesh.py``).  Data parallelism: every rank samples the
same global starts and trains on its data index's B/d columns of them,
and the gradients and the BatchNorm statistics are summed over its data
group (``train/bc_step.py``).  Tensor parallelism: each rank holds its
rows of the policy's sharded weights and of their RMSprop state
(``bc_step.shard_state``); online eval and the checkpoints take the
whole state, gathered over the model group at each eval point
(``bc_step.gather_state``), so a checkpoint is the one-process file and
a resumed run slices it, on any mesh.  Rank 0 alone writes the stats and
checkpoints.
The dataset is device-resident when it fits (uint8 frames for
finetune), the unroll gather runs where the dataset is, and the metrics
stay on the device between eval points.
"""

import copy
import os
import random

import numpy as np
import torch

from pvr_habitat_tpu_torch.data import formats, sampler
from pvr_habitat_tpu_torch.envs.environment import make_environment
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.parallel import mesh as pmesh
from pvr_habitat_tpu_torch.parallel import multihost
from pvr_habitat_tpu_torch.train import bc_step
from pvr_habitat_tpu_torch.train.evaluate import (FusedPolicyRunner,
                                                  PolicyRunner,
                                                  batched_test,
                                                  batched_test_fused, test)
from pvr_habitat_tpu_torch.utils import checkpoint as ckpt
from pvr_habitat_tpu_torch.utils import profiling
from pvr_habitat_tpu_torch.utils import stats as stats_util
from pvr_habitat_tpu_torch.utils.platform import resolve_device


def flags_device(flags):
    """``--disable_cuda`` -> the CPU; else ``cuda`` (raises without it)."""
    return resolve_device("cpu" if flags.disable_cuda else None)


def compute_dtype(flags):
    return (torch.bfloat16 if flags.compute_dtype == "bfloat16"
            else torch.float32)


def data_columns(batch_size, mesh):
    """This rank's columns of a global batch of ``batch_size`` sharded
    over the mesh's 'data' axis (equal shards, as the JAX trainer
    asserts): those of its data index."""
    if batch_size % mesh.data:
        raise ValueError(f"batch_size {batch_size} does not divide over "
                         f"the mesh's data axis of {mesh.data}")
    per_rank = batch_size // mesh.data
    return slice(mesh.data_index * per_rank,
                 (mesh.data_index + 1) * per_rank)


def embed_in_minibatches(embedding_model, obs, batch_size, limit=None):
    """Minibatched bulk embedding with the stacked-frame split/merge dance
    (reference: main_bc_1.py:127-138, save_embedded_obs.py:147-157)."""
    n = obs.shape[0] if limit is None else min(limit, obs.shape[0])
    obs = obs[:n]
    if obs.shape[-1] == 1:  # grayscale (Atari): repeat to RGB
        obs = np.repeat(obs, 3, -1)
    n_frames = max(obs.shape[3] // 3, 1)
    # (N, H, W, nf*3) -> (N*nf, H, W, 3): all frames through the encoder
    flat = np.concatenate(np.split(obs, n_frames, axis=3), axis=0) \
        if n_frames > 1 else obs
    embedded = embedding_model.embed_batches(flat, batch_size)
    if n_frames > 1:
        embedded = np.concatenate(np.split(embedded, n_frames, axis=0),
                                  axis=-1)
    return embedded[:n]


def _load_precomputed(flags, from_env):
    """main_bc_2.py:111-148 data loading."""
    parts = {k: [] for k in ("obs", "action", "reward", "done")}
    for env_id in from_env.split(","):
        if flags.embedding_name == "true_state":
            # true_state is saved with every embedding; prefer a pickle
            # the bulk embedder wrote FOR true_state itself, fall back
            # to resnet50's (the reference's implicit convention).
            path = formats.embedded_path(flags.data_path, env_id,
                                         "true_state")
            if not os.path.isfile(path):
                path = formats.embedded_path(flags.data_path, env_id,
                                             "resnet50")
        else:
            path = formats.embedded_path(flags.data_path, env_id,
                                         flags.embedding_name)
        data = formats.load_pickle(path)
        n = (flags.batch_size * flags.unroll_length if flags.debug
             else data["obs"].shape[0])
        obs_key = "true_state" if flags.embedding_name == "true_state" \
            else "obs"
        parts["obs"].append(np.asarray(data[obs_key][:n]))
        for key in ("action", "reward", "done"):
            parts[key].append(np.asarray(data[key][:n]))
    return {k: np.concatenate(v) for k, v in parts.items()}


def _load_embed_at_load(flags, from_env, embedding_model):
    """main_bc_1.py:115-150 data loading."""
    parts = {k: [] for k in ("obs", "action", "reward", "done")}
    for env_id in from_env.split(","):
        data = formats.read_habitat_data(
            formats.raw_path(flags.data_path, env_id))
        n = (flags.batch_size * flags.unroll_length if flags.debug
             else data["obs"].shape[0])
        print("   passing observations through embedding model")
        embed_batch = flags.embed_batch_size or flags.batch_size
        parts["obs"].append(embed_in_minibatches(
            embedding_model, data["obs"], embed_batch, limit=n))
        for key in ("action", "reward", "done"):
            parts[key].append(np.asarray(data[key][:n]))
    return {k: np.concatenate(v) for k, v in parts.items()}


def _load_finetune(flags, from_env):
    """main_bc_finetune.py:103-125: raw pixel trajectories."""
    parts = {k: [] for k in ("obs", "action", "reward", "done")}
    for env_id in from_env.split(","):
        data = formats.load_pickle(formats.raw_path(flags.data_path, env_id))
        n_traj = (flags.batch_size * flags.unroll_length if flags.debug
                  else len(data["obs"]))
        for key in ("obs", "action", "reward", "done"):
            parts[key].append(np.concatenate(data[key][:n_traj]))
    return {k: np.concatenate(v) for k, v in parts.items()}


def _evaluate(runner, eval_envs, stat_keys, n_episodes, embedding=None):
    if len(eval_envs) > 1 and embedding is not None:
        # Raw-frame envs; preprocess+encoder+policy in one tick (see
        # FusedPolicyRunner).  Eager PyTorch compiles nothing, so a fresh
        # runner per eval point costs nothing.
        return batched_test_fused(FusedPolicyRunner(runner, embedding),
                                  eval_envs, stat_keys, n_episodes)
    if len(eval_envs) > 1:
        return batched_test(runner, eval_envs, stat_keys, n_episodes)
    return test(runner, eval_envs[0], stat_keys, n_episodes)


def run(flags, mode="precomputed"):
    flags = copy.copy(flags)
    if mode not in ("precomputed", "embed_at_load", "finetune"):
        raise ValueError(f"unknown mode: {mode}")
    device = flags_device(flags)
    with multihost.session(flags, device) as device:
        return _run(flags, mode, device)


def _run(flags, mode, device):
    mesh = pmesh.make_mesh(pmesh.parse_mesh_shape(flags.mesh_shape))
    columns = data_columns(flags.batch_size, mesh)
    is_writer = multihost.world()[1] == 0
    # Fix seeds (reference: main_bc_2.py:28-31).
    np.random.seed(flags.run_id)
    random.seed(flags.run_id)

    if flags.debug:
        flags.n_episodes_test = int(min(2, flags.n_episodes_test))

    from_env = flags.env
    to_env = flags.to_env
    conv_policy = mode == "finetune"
    embedding_label = "random_finetuned" if conv_policy else None

    os.makedirs(flags.save_path, exist_ok=True)
    save_path = stats_util.run_save_path(flags, embedding_label)

    # Resume probe (main_bc_2.py:49-56).
    resume = False
    if os.path.isfile(save_path + ".pickle"):
        stats = stats_util.load_stats(save_path + ".pickle")
        if stats[to_env]["frames"][-1] >= flags.max_frames:
            print("   WARNING! This run was already completed. Stopping now.")
            return
        resume = True

    embedding_model = None
    if not conv_policy:
        embedding_model = EmbeddingNet(
            flags.embedding_name, in_channels=3,
            pretrained=flags.pretrained_embedding if mode == "embed_at_load"
            else True,
            train=False, checkpoint_dir=flags.data_path,
            run_id=flags.run_id, compute_dtype=compute_dtype(flags),
            device=device)

    env_flags = copy.copy(flags)
    env_flags.env = to_env
    env = make_environment(env_flags, embedding_model)
    obs_shape = env.gym_env.observation_space.shape
    num_actions = env.gym_env.action_space.n
    eval_batched_embed = (flags.eval_batch > 1
                          and embedding_model is not None
                          and flags.embedding_name != "true_state"
                          and flags.num_input_frames == 1)
    if eval_batched_embed:
        # raw-frame envs; embedding happens jointly inside the evaluator
        eval_envs = [make_environment(env_flags, None, actor_id=1 + i)
                     for i in range(flags.eval_batch)]
    else:
        eval_envs = [env] + [
            make_environment(env_flags, embedding_model, actor_id=2 + i)
            for i in range(max(flags.eval_batch, 1) - 1)]

    max_epochs = flags.max_frames // (flags.unroll_length
                                      * flags.batch_size) + 1
    state, opt = bc_step.create_train_state(
        np.random.RandomState(flags.run_id), obs_shape, num_actions, flags,
        conv_policy=conv_policy, max_epochs=max_epochs, seed=flags.run_id,
        device=device)

    if resume:
        payload = ckpt.load_checkpoint(save_path + ".tar")
        if embedding_model is not None and \
                "embedding_model_state_dict" in payload:
            embedding_model.load_state_dict(
                payload["embedding_model_state_dict"])
        params, batch_stats = ckpt.split_actor_state(
            payload["actor_model_state_dict"], device)
        state = bc_step.TrainState(params, batch_stats,
                                   ckpt.restore_opt_state(payload, device),
                                   state.generator)
    # the whole state (fresh, or the one-process file) -> this rank's part
    state = bc_step.shard_state(mesh, state)

    print("=== BC run ===")
    print("   embedding:", embedding_label or flags.embedding_name)
    print("   training environment(s):", from_env)
    print("   testing environment(s):", to_env)
    print("   device:", device)
    if mesh.data > 1:
        print(f"   data parallel: {mesh.data} ranks, columns "
              f"[{columns.start}, {columns.stop}) of each batch")
    if mesh.model > 1:
        print(f"   tensor parallel: {mesh.model} ranks a row, rows of "
              f"model index {mesh.model_index} here")
    if flags.debug:
        print("   RUNNING IN DEBUG MODE!")

    print("=== Loading trajectories ===")
    if mode == "precomputed":
        data = _load_precomputed(flags, from_env)
    elif mode == "embed_at_load":
        data = _load_embed_at_load(flags, from_env, embedding_model)
    else:
        data = _load_finetune(flags, from_env)

    n_samples = len(data["reward"])
    assert len(data["obs"]) == len(data["action"]) == n_samples == \
        len(data["done"]), "data length does not match"
    assert n_samples > 0, "no data found"
    print("   total number of samples", n_samples)

    train_data, _ = sampler.maybe_device_put(
        dict(obs=np.asarray(data["obs"],
                            np.uint8 if conv_policy else np.float32),
             action=np.asarray(data["action"], np.int64),
             done=np.asarray(data["done"], bool)),
        device, mode=flags.data_on_device)

    stat_keys = list(stats_util.STAT_KEYS)
    # The encoder is frozen during BC training: fetch its state_dict to
    # the host ONCE and reuse it at every checkpoint boundary.  File
    # contents are identical to re-serializing it per save.
    embedding_state_host = (embedding_model.state_dict()
                            if embedding_model is not None else None)

    def evaluate(whole):
        """Online eval of ``whole``, the gathered state."""
        runner = PolicyRunner(whole.params, whole.batch_stats,
                              batch_norm=flags.batch_norm,
                              conv_policy=conv_policy)
        with profiling.span("bc.eval"):
            return _evaluate(runner, eval_envs, stat_keys,
                             flags.n_episodes_test,
                             embedding_model if eval_batched_embed
                             else None)

    if resume:
        print("=== Resuming previous run ===")
        stats = stats_util.load_stats(save_path + ".pickle")
        init_frames = stats[to_env]["frames"][-1]
        for key in ("frames", "training_loss", "gradient_norm"):
            print("  ", key, stats[to_env][key][-1])
    else:
        print("=== Initial evaluation ===")
        stats = stats_util.new_stats(to_env, stat_keys)
        stats_ep = evaluate(bc_step.gather_state(mesh, state))
        stats_util.append_eval(stats, to_env, stats_ep, stat_keys)
        for k in stat_keys:
            print("  ", k, np.mean(stats_ep[k]))
        stats[to_env]["frames"].append(0)
        stats[to_env]["training_loss"].append(np.nan)
        stats[to_env]["gradient_norm"].append(np.nan)
        init_frames = 0

    # One step an epoch on starts drawn from the host's ``random`` stream,
    # as the reference does (every rank draws the same global starts and
    # trains on its columns); the unroll gather runs on the device that
    # holds the dataset.  ``--train_chunk`` saves dispatches in the JAX
    # package and changes nothing here: on one card ``make_train_step``
    # replays the whole step from one CUDA graph instead (eager on a
    # mesh of more ranks).
    step_fn = bc_step.make_train_step(opt, batch_norm=flags.batch_norm,
                                      conv_policy=conv_policy,
                                      max_grad_norm=flags.max_grad_norm,
                                      mesh=mesh)

    print("=== Training policy ===")
    frames_per_epoch = flags.batch_size * flags.unroll_length
    metrics = None
    timer = profiling.StepTimer(items_per_step=frames_per_epoch,
                                label="train")
    frames = init_frames
    with profiling.trace(flags.profile_dir):
        while frames < flags.max_frames:
            starts = sampler.sample_with_minimum_distance(
                n=n_samples, k=flags.batch_size, d=flags.unroll_length)
            with profiling.span("bc.train"):
                batch = sampler.gather_unrolls(train_data, starts[columns],
                                               flags.unroll_length)
                state, metrics = step_fn(
                    state, {k: v.to(device) for k, v in batch.items()})
            frames += frames_per_epoch
            timer.tick()
            # The just-trained (last) epoch and its start-frame count —
            # what the reference's per-epoch loop logs at eval points.
            epoch = frames // frames_per_epoch - 1
            frames_log = frames - frames_per_epoch

            if (epoch + 1) % flags.eval_frequency == 0:
                # Reading the metrics waits for the device: the timer's
                # report is the training rate since the last eval point.
                loss = float(metrics["loss"])
                gnorm = float(metrics["gradient_norm"])
                timer.report()
                whole = bc_step.gather_state(mesh, state)
                if not flags.essential_save_only or \
                        stats_util.is_essential_save(
                            epoch, max_epochs, flags.eval_frequency):
                    stats_ep = evaluate(whole)
                    stats_util.append_eval(stats, to_env, stats_ep,
                                           stat_keys)
                    for k in stat_keys:
                        print("  ", k, np.mean(stats_ep[k]))
                else:
                    stats_util.append_nan_eval(stats, to_env, stat_keys)

                stats[to_env]["frames"].append(frames_log)
                stats[to_env]["training_loss"].append(loss)
                stats[to_env]["gradient_norm"].append(gnorm)
                print("   frames", frames_log)
                print("   training loss", loss)
                print("   gradient norm", gnorm)

                if is_writer and not flags.disable_save:
                    stats_util.save_stats(save_path + ".pickle", stats)
                    ckpt.save_checkpoint(
                        save_path + ".tar",
                        actor_params=whole.params,
                        actor_batch_stats=whole.batch_stats,
                        opt_state=whole.opt_state,
                        flags=flags,
                        embedding_state=embedding_state_host)
                timer.restart()

    env.close()
    for e in eval_envs:
        if e is not env:
            e.close()
    return stats
