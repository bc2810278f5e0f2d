"""Multi-process runs over ``torch.distributed`` (counterpart of
``__graft_entry__.py::dryrun_multichip``).

``launch(n, args)`` starts n processes of this module on one host,
each a rank of one group (``tcp://localhost:<free port>``), waits for
them within a time limit and returns their outputs; a rank that fails or
outlives the limit fails the launch, and no rank is left running.  Each
rank runs one task:

- ``multichip``: the dry run, on the JAX dry run's mesh ((n/2, 2) for an
  even n >= 4, else (n, 1)).  One BC train step with BatchNorm on a
  tiny batch sharded over 'data' (the policy's weights over 'model'),
  for the MLP and the conv policy, against the same step on the whole
  batch in one process (``mesh=None``, computed by each rank alone),
  and the ranks' gathered new params bitwise equal; then the bulk
  embedder (``random`` encoder) over each rank's ``process_slice`` of
  some frames, gathered, against ``embed_all`` of all of them.
- ``embed``: ``ShardedEmbedder.embed_local`` over this rank's slice of
  seeded frames; writes ``<out><rank>.npz`` (local rows, slice bounds,
  kernel launches).
- ``train``: ``main_bc_2`` (``train/bc.py::run``) with the BC flags of
  ``--bc_flags`` (plus ``--disable_cuda`` with ``--device cpu``) and the
  rank's ``--coordinator`` flags, so that the trainer picks its device
  and joins the group as its CLI does; writes ``<out><rank>.npz``
  (losses, gradient norms, returns).
- ``steps``: ``STEPS`` train steps of the policy with BatchNorm at the
  default batch (B 32, T 100) on the embeddings of a pickle, on the
  ``--mesh_shape`` mesh (default: every rank on 'data'); before each
  step rank 0 saves the whole state (gathered over the model group) to
  ``<snapshots>/step_<k>.pt``, so that one process can take the same
  step from the same state on the whole batch; then the same steps
  again, timed, and the collectives of a step alone, as many times: the
  gradients' all-reduce over the data group and, with a 'model' axis,
  the sharded products' all-gathers and their inputs' gradient
  all-reduces over the model group; writes ``<out><rank>.npz`` (each
  step's loss and gradient norm, the starts, the seconds of the timed
  steps and of each collective).

The ranks run on the card unless ``--device cpu`` asks for the CPU
(without CUDA they raise):

    python -m pvr_habitat_tpu_torch.parallel.dryrun --nprocs 2 --device cpu

runs ``multichip`` on 2 CPU ranks over gloo.
"""

import argparse
import os
import random
import shlex
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from pvr_habitat_tpu_torch.parallel import multihost

SEED = 0
STEPS = 5          # the steps task's train steps


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(nprocs, args, timeout=300.0, env=None,
           module="pvr_habitat_tpu_torch.parallel.dryrun"):
    """Run ``python -m <module> <args>`` (by default a task of this
    module; or an entry point of the port, such as
    ``pvr_habitat_tpu_torch.tools.save_embedded_obs``) as ranks
    0..nprocs-1 of one group, each given its ``--coordinator``,
    ``--num_processes`` and ``--process_id``; ``env`` adds variables to
    this process's environment for them.  Returns their outputs (stdout
    and stderr), in rank order.  Raises with the failing rank's
    output."""
    coordinator = f"localhost:{free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *args, "--coordinator", coordinator,
         "--num_processes", str(nprocs), "--process_id", str(rank)],
        cwd=root, env={**os.environ, **(env or {})}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(nprocs)]
    logs = [None] * nprocs
    try:
        for rank, proc in enumerate(procs):
            logs[rank] = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"ranks outlived {timeout} s") from exc
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, proc in enumerate(procs):
        if proc.returncode:
            raise RuntimeError(f"rank {rank} exited {proc.returncode}:\n"
                               f"{logs[rank][-4000:]}")
    return logs


def dryrun_multichip(n_devices=2, timeout=300.0):
    """The dry run on ``n_devices`` CPU ranks of one thread each (the
    shapes are tiny); prints each rank's lines."""
    for log in launch(n_devices, ["multichip", "--device", "cpu"], timeout,
                      env={"OMP_NUM_THREADS": "1"}):
        print(log, end="")


# -- the ranks' tasks ---------------------------------------------------------


def _multichip(args, device):
    from pvr_habitat_tpu_torch.data.embed_pipeline import ShardedEmbedder
    from pvr_habitat_tpu_torch.parallel import mesh as pmesh
    from pvr_habitat_tpu_torch.train import bc, bc_step
    from pvr_habitat_tpu_torch.utils.flags import default_flags

    size, rank = multihost.world()
    mesh = pmesh.make_mesh((size // 2, 2) if size % 2 == 0 and size >= 4
                           else (size, 1))
    t, b, num_actions = 4, 2 * size, 3
    flags = default_flags(learning_rate=1e-3, batch_norm=True)
    rng = np.random.RandomState(1)
    cols = bc.data_columns(b, mesh)
    # the MLP policy on embeddings; the conv policy on frames, whose
    # BatchNorm statistics depend on the params (a backward through the
    # sums over the ranks)
    for conv_policy, obs in (
            (False, rng.randn(t, b, 64).astype(np.float32)),
            (True, rng.randint(0, 256, (t, b, 16, 16, 3), np.uint8))):
        batch = dict(obs=torch.from_numpy(obs),
                     action=torch.from_numpy(rng.randint(0, num_actions,
                                                         (t, b))),
                     done=torch.from_numpy(rng.rand(t, b) < 0.2))
        batch = {k: v.to(device) for k, v in batch.items()}

        def step(step_mesh, part):
            state, opt = bc_step.create_train_state(
                np.random.RandomState(0), obs.shape[2:], num_actions,
                flags, conv_policy=conv_policy, max_epochs=100,
                device=device)
            fn = bc_step.make_train_step(opt, batch_norm=True,
                                         conv_policy=conv_policy,
                                         mesh=step_mesh)
            if step_mesh is None:
                return fn(state, {k: v[:, part] for k, v in batch.items()})
            state, metrics = fn(bc_step.shard_state(step_mesh, state),
                                {k: v[:, part] for k, v in batch.items()})
            return bc_step.gather_state(step_mesh, state), metrics

        state, metrics = step(mesh, cols)
        want_state, want = step(None, slice(None))
        for key in ("loss", "gradient_norm"):
            torch.testing.assert_close(metrics[key], want[key], rtol=1e-5,
                                       atol=1e-6)
        for tree, ref in ((state.params, want_state.params),
                          (state.batch_stats, want_state.batch_stats)):
            for k in ref:
                torch.testing.assert_close(tree[k], ref[k], rtol=1e-5,
                                           atol=1e-6)
        digest = torch.stack([v.double().sum()
                              for v in state.params.values()])
        gathered = multihost.allgather_rows(digest.cpu().numpy()[None])
        if not (gathered == gathered[:1]).all():
            raise AssertionError("the ranks' params differ after the step")
        print(f"dryrun_multichip({size}) rank {rank}: mesh {mesh.shape} "
              f"{'conv' if conv_policy else 'MLP'} policy loss "
              f"{float(metrics['loss']):.6f} against one process "
              f"{float(want['loss']):.6f}; ranks equal OK", flush=True)

    frames = np.random.RandomState(2).randint(
        0, 256, size=(3 * size + 1, 16, 16, 3), dtype=np.uint8)
    embedder = ShardedEmbedder("random", device=device, batch_size=2,
                               compute_dtype=torch.float32, run_id=0)
    start, stop = multihost.process_slice(len(frames))
    out = multihost.allgather_rows(embedder.embed_local(frames[start:stop]))
    np.testing.assert_allclose(out, embedder.embed_all(frames), rtol=1e-5,
                               atol=1e-5)
    print(f"dryrun_multichip({size}) rank {rank}: sharded embedder parity "
          f"OK ({len(frames)} frames, rows [{start}, {stop}) here)",
          flush=True)


def _launches():
    from pvr_habitat_tpu_torch.ops.cuda import attention as fa
    from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb
    from pvr_habitat_tpu_torch.ops.cuda import layer_norm as ln

    return {**fb.launches, **fa.launches, **ln.launches}


def _embed(args, device):
    from pvr_habitat_tpu_torch.data.embed_pipeline import ShardedEmbedder

    rank = multihost.world()[1]
    frames = np.random.RandomState(SEED).randint(
        0, 256, size=(args.frames, 64, 64, 3), dtype=np.uint8)
    embedder = ShardedEmbedder(args.name, device=device,
                               batch_size=args.batch_size,
                               compute_dtype=torch.float32,
                               pretrained=False)
    start, stop = multihost.process_slice(len(frames))
    before = _launches()
    local = embedder.embed_local(frames[start:stop])
    launches = {k: v - before[k] for k, v in _launches().items()}
    np.savez(f"{args.out}{rank}.npz", local=local, start=start, stop=stop,
             launches=np.asarray(list(launches.values())),
             kernels=np.asarray(list(launches)))
    print(f"rank {rank}: rows [{start}, {stop}) embedded, launches "
          f"{launches}", flush=True)


def train_flags(args):
    """The train task's BC flags: ``--bc_flags``, ``--disable_cuda`` when
    ``--device cpu`` asks for the CPU, and the rank's group flags."""
    from pvr_habitat_tpu_torch.utils.flags import build_parser

    return build_parser().parse_args(
        shlex.split(args.bc_flags)
        + (["--disable_cuda"] if args.device == "cpu" else [])
        + ["--coordinator", args.coordinator, "--num_processes",
           str(args.num_processes), "--process_id", str(args.process_id)])


def _train(args):
    from pvr_habitat_tpu_torch.train import bc

    flags = train_flags(args)
    stats = bc.run(flags)[flags.to_env]
    np.savez(f"{args.out}{args.process_id}.npz",
             loss=np.asarray(stats["training_loss"], np.float64),
             gnorm=np.asarray(stats["gradient_norm"], np.float64),
             ret=np.asarray(stats["episode_return"], np.float64))
    print(f"rank {args.process_id}: trained, losses "
          f"{stats['training_loss']}", flush=True)


def _steps(args, device):
    from pvr_habitat_tpu_torch.data import formats, sampler
    from pvr_habitat_tpu_torch.models import policy
    from pvr_habitat_tpu_torch.parallel import mesh as pmesh
    from pvr_habitat_tpu_torch.train import bc, bc_step
    from pvr_habitat_tpu_torch.utils.flags import default_flags

    rank = multihost.world()[1]
    mesh = pmesh.make_mesh(pmesh.parse_mesh_shape(args.mesh_shape))
    flags = default_flags(batch_norm=True)
    b, t = flags.batch_size, flags.unroll_length
    cols = bc.data_columns(b, mesh)
    data = formats.load_pickle(args.data)
    n = len(data["action"])
    tensors = sampler.to_tensors(dict(
        obs=data["obs"].astype(np.float32),
        action=data["action"].astype(np.int64),
        done=data["done"].astype(bool)), device)
    random.seed(SEED)
    starts = [sampler.sample_with_minimum_distance(n, b, t)
              for _ in range(STEPS)]
    state, opt = bc_step.create_train_state(
        np.random.RandomState(SEED), (data["obs"].shape[1],), 3, flags,
        max_epochs=100, device=device)
    state = bc_step.shard_state(mesh, state)
    step = bc_step.make_train_step(opt, batch_norm=True, mesh=mesh)
    metrics = []
    for k, row in enumerate(starts):
        whole = bc_step.gather_state(mesh, state)
        if rank == 0:
            torch.save(snapshot(whole), os.path.join(args.snapshots,
                                                     f"step_{k}.pt"))
        state, m = step(state, sampler.gather_unrolls(tensors, row[cols], t))
        metrics.append([m["loss"].item(), m["gradient_norm"].item()])
    # the same steps again, timed (no snapshots)
    _sync(device)
    start = time.perf_counter()
    for row in starts:
        state, m = step(state, sampler.gather_unrolls(tensors, row[cols], t))
    m["loss"].item()
    _sync(device)
    seconds = time.perf_counter() - start
    # and a step's collectives alone, as many times: the gradients'
    # all-reduce (over the data group), and on a 'model' axis the
    # all-gathers of the two fc products and of the gates (2 layers, T
    # steps) and the all-reduces of their inputs' gradients (obs and
    # the first fc's output; x and h of each layer and step)
    rows, width = (b // mesh.data) * t, policy.HIDDEN // mesh.model
    reduce_numel = sum(v.numel() for v in state.params.values()) + 1
    gathers = [(rows, width)] * 2 + [(b // mesh.data, 4 * width)] * (2 * t)
    inputs = [(rows, data["obs"].shape[1]), (rows, policy.HIDDEN)] \
        + [(b // mesh.data, policy.HIDDEN)] * (4 * t)
    reduce_s = _time_collective(
        multihost.all_reduce_sum, mesh.data_group,
        [(reduce_numel,)] if mesh.data > 1 else [], len(starts), device)
    model = mesh.model > 1
    gather_s = _time_collective(multihost.all_gather_cat, mesh.model_group,
                                gathers if model else [], len(starts), device)
    input_s = _time_collective(multihost.all_reduce_sum, mesh.model_group,
                               inputs if model else [], len(starts), device)
    np.savez(f"{args.out}{rank}.npz", metrics=np.asarray(metrics),
             starts=np.asarray(starts), seconds=seconds,
             reduce_seconds=reduce_s, reduce_numel=reduce_numel,
             gather_seconds=gather_s, input_reduce_seconds=input_s)
    print(f"rank {rank}: mesh {mesh.shape}, {STEPS} steps on columns "
          f"[{cols.start}, {cols.stop}), losses {[m[0] for m in metrics]}; "
          f"then {STEPS} more in {seconds:.3f} s; a step's collectives "
          f"alone, {STEPS} times: the gradients' all-reduce {reduce_s:.3f} "
          f"s, the all-gathers {gather_s:.3f} s, the sharded inputs' "
          f"all-reduces {input_s:.3f} s", flush=True)


def _time_collective(fn, group, shapes, repeat, device):
    """Seconds of ``repeat`` rounds of ``fn(buffer, group)`` over zero
    buffers of ``shapes``."""
    buffers = [torch.zeros(shape, device=device) for shape in shapes]
    _sync(device)
    start = time.perf_counter()
    for _ in range(repeat):
        for buf in buffers:
            fn(buf, group)
    _sync(device)
    return time.perf_counter() - start


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def snapshot(state):
    """A ``TrainState`` as host tensors (params, BN statistics and the
    optimizer's state); ``restore`` puts it back on a device."""
    def host(tree):
        return {k: v.cpu() for k, v in tree.items()} \
            if isinstance(tree, dict) else tree

    opt = state.opt_state
    return dict(params=host(state.params), batch_stats=host(state.batch_stats),
                count=opt.count, square_avg=host(opt.square_avg),
                momentum_buf=host(opt.momentum_buf))


def restore(saved, device):
    from pvr_habitat_tpu_torch.train import bc_step, optim

    def put(tree):
        return {k: v.to(device) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree

    return bc_step.TrainState(
        put(saved["params"]), put(saved["batch_stats"]),
        optim.RMSpropTorchState(saved["count"], put(saved["square_avg"]),
                                put(saved["momentum_buf"])),
        torch.Generator(device=device))


TASKS = {"multichip": _multichip, "embed": _embed, "train": _train,
         "steps": _steps}


def _parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("task", nargs="?", default="multichip",
                        choices=sorted(TASKS))
    parser.add_argument("--nprocs", type=int, default=0,
                        help="Launch this many ranks of the task here.")
    parser.add_argument("--device", default=None, choices=["cpu", "cuda"],
                        help="The ranks' device (default: the card).")
    parser.add_argument("--coordinator", default="")
    parser.add_argument("--num_processes", type=int, default=1)
    parser.add_argument("--process_id", type=int, default=0)
    parser.add_argument("--out", default="")
    parser.add_argument("--name", default="random")
    parser.add_argument("--frames", type=int, default=37)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--bc_flags", default="",
                        help="The train task's BC flags, as one string.")
    parser.add_argument("--data", default="")
    parser.add_argument("--snapshots", default="")
    parser.add_argument("--mesh_shape", default="",
                        help="The steps task's mesh, 'data,model'.")
    return parser


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.nprocs:
        i = argv.index("--nprocs")
        for log in launch(args.nprocs, argv[:i] + argv[i + 2:]):
            print(log, end="")
        return
    if not args.coordinator:
        raise SystemExit("a task runs as a rank: give --nprocs, or "
                         "--coordinator, --num_processes and --process_id")
    if args.task == "train":
        # bc.run picks its device from the BC flags and joins the group
        # itself, through its --coordinator flags
        _train(args)
        return
    from pvr_habitat_tpu_torch.utils.platform import resolve_device

    with multihost.session(args, resolve_device(args.device)) as device:
        TASKS[args.task](args, device)


if __name__ == "__main__":
    main()
