"""Sweep runner (counterpart of ``pvr_habitat_tpu/tools/sweep.py``) —
the reference's Slurm/submitit layer (slurm_bc.py:34-217, slurm_eo.py,
slurm_bc_finetune.py) generalized to executors:

- ``local``   — run jobs sequentially in-process (the --local path);
- ``subprocess`` — one Python subprocess per job (isolation without a
  cluster), each the port's CLI (``python -m
  pvr_habitat_tpu_torch.main_bc_1`` / ``.main_bc_2`` /
  ``.main_bc_finetune``);
- ``slurm``   — submitit SlurmExecutor when submitit is installed.

    python -m pvr_habitat_tpu_torch.tools.sweep --kind bc|embed|finetune \
        [--local] [--fake] [--disable_cuda]

Jobs run on the card unless ``--disable_cuda`` asks for the CPU (it is
set on every job's flags, and a subprocess job's command line carries
it).  The top-level ``slurm_*.py`` launchers run the JAX package's sweep.

Semantics preserved: cartesian grid expansion with xpid naming,
per-env max_frames table, transfer-run skip (to_env not in env),
completed-run skip via the stats pickle (with the unroll*batch
tolerance, slurm_bc.py:165), forced essential_save_only and batch_norm
(except true_state), and the random->embed-at-load routing.  The
skip/resume contract makes relaunches elastic and crash-tolerant.
"""

import argparse
import itertools
import os
import pickle
import subprocess
import sys
import warnings

from pvr_habitat_tpu_torch.utils import stats as stats_util
from pvr_habitat_tpu_torch.utils.flags import build_parser

DEFAULT_MAX_FRAMES = 200000000
MAX_FRAMES_BY_ENV = {
    "HabitatImageNav-apartment_0": 200000000,
    "HabitatPointNav-apartment_0": 2000000,
}


def make_prefix(key):
    return "".join(w[0] for w in key.split("_"))


def expand_args(params, max_frames_map=None):
    """Cartesian product over list-valued entries, with xpid naming."""
    max_frames_map = max_frames_map or MAX_FRAMES_BY_ENV
    sweep_args = {k: v for k, v in params.items() if isinstance(v, list)}
    sweep = [dict(zip(sweep_args.keys(), vs))
             for vs in itertools.product(*sweep_args.values())]
    expanded = []
    for swargs in sweep:
        new_args = {**params, **swargs}
        new_args["xpid"] = "--".join(
            f"{make_prefix(k)}={v}" for k, v in swargs.items())
        new_args["max_frames"] = max_frames_map.get(
            new_args["env"], DEFAULT_MAX_FRAMES)
        expanded.append(new_args)
    return expanded


def make_command(params):
    out = []
    for key, value in params.items():
        if isinstance(value, bool):   # store_true flags take no value
            if value:
                out.append(f"--{key}")
        else:
            out += [f"--{key}", str(value)]
    return out


def is_run_completed(flags, embedding_label=None):
    """Completed-run skip (reference: slurm_bc.py:157-168).

    Uses ``stats_util.run_save_path`` as the single naming source of
    truth so finetune runs — which save under ``emrandom_finetuned``
    (main_bc_finetune.py:44, train/bc.py:163) — are skipped too.
    """
    save_path = stats_util.run_save_path(flags, embedding_label)
    if not os.path.isfile(save_path + ".pickle"):
        return False
    with open(save_path + ".pickle", "rb") as handle:
        stats = pickle.load(handle)
    threshold = flags.max_frames - flags.unroll_length * flags.batch_size
    return stats[flags.to_env]["frames"][-1] >= threshold


# -- executors ---------------------------------------------------------------


class LocalExecutor:
    def submit(self, fn, flags):
        fn(flags)
        return "local"


class SubprocessExecutor:
    """One Python subprocess per job (process isolation without a
    cluster).  Routes by the runner function's name to the port's CLI
    entry points, run as modules from the repository's root."""

    MODULES = {
        "runner_random": "pvr_habitat_tpu_torch.main_bc_1",
        "runner_pvr": "pvr_habitat_tpu_torch.main_bc_2",
        "runner_finetune": "pvr_habitat_tpu_torch.main_bc_finetune",
    }

    def __init__(self, repo_root=None, extra_env=None):
        self.repo_root = repo_root or os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        self.extra_env = extra_env or {}

    def submit(self, fn, flags):
        module = self.MODULES.get(fn.__name__)
        if module is None:
            fn(flags)  # unknown runner: run in-process
            return "local"
        env = dict(os.environ, **self.extra_env)
        cmd = [sys.executable, "-m", module] + _flags_to_cli(flags)
        proc = subprocess.run(cmd, check=False, cwd=self.repo_root, env=env)
        return f"subprocess:{proc.returncode}"


def _flags_to_cli(flags):
    """The command line of the port's CLIs for ``flags``: every flag
    that differs from the port's defaults (``--disable_cuda`` with it)."""
    defaults = build_parser().parse_args([])
    out = []
    for key, value in vars(flags).items():
        if getattr(defaults, key, None) == value or value is None:
            continue
        if key == "pretrained_embedding":
            if not value:
                out.append("--disable_pretrained_embedding")
        elif isinstance(value, bool):
            if value:
                out.append(f"--{key}")
        else:
            out += [f"--{key}", str(value)]
    return out


class SubmititExecutor:
    """submitit executor computing the reference's PER-JOB specs.

    kind='bc' (reference slurm_bc.py:191-205): memory heuristic
    16 GB * n_scenes * (2 if uber), 5 CPUs, 4319 min,
    job_name 'bc-{embedding}-{env}-{to_env}'.
    kind='embed' (reference slurm_eo.py:149-167): fixed 32 GB, 10 CPUs,
    1319 min, job_name 'emb_obs-{embedding}-{env}'.
    ``debug`` swaps the partition to 'devlab' (slurm_bc.py:188-189).
    The reference's GPU knobs (num_gpus=1 / constraint='pascal') are
    configurable and default off: GPU sites name their cards with their
    own ``constraint`` (an H100 feature tag) and ``gres`` (e.g.
    'gpu:1'), so callers set those to their site's values.
    """

    def __init__(self, partition="learnfair", folder="./out/", kind="bc",
                 debug=False, local=False, constraint=None, gres=None,
                 comment=None):
        import submitit  # optional dependency

        cls = submitit.LocalExecutor if local else submitit.SlurmExecutor
        self._executor = cls(folder=folder)
        self._local = local
        self.partition = "devlab" if debug else partition
        self.kind = kind
        self.constraint = constraint
        self.gres = gres
        self.comment = comment

    def job_spec(self, flags):
        spec = dict(partition=self.partition, nodes=1, ntasks_per_node=1)
        if self.kind == "embed":
            spec.update(time=1319, mem="32GB", cpus_per_task=10,
                        job_name="emb_obs-%s-%s" % (flags.embedding_name,
                                                    flags.env))
        else:
            n_scenes = len(flags.env.split(","))
            mem = 16 * n_scenes * \
                (2 if "uber" in flags.embedding_name else 1)
            spec.update(time=4319, mem=f"{mem}GB", cpus_per_task=5,
                        job_name="bc-%s-%s-%s" % (flags.embedding_name,
                                                  flags.env, flags.to_env))
        if self.constraint:
            spec["constraint"] = self.constraint
        if self.gres:
            spec["gres"] = self.gres
        if self.comment:
            spec["comment"] = self.comment
        return spec

    def submit(self, fn, flags):
        spec = self.job_spec(flags)
        if self._local:
            # submitit.LocalExecutor rejects Slurm-only parameters
            # (partition/mem/job_name/...) with "unexpected parameters";
            # translate the spec to the keys it understands.
            spec = dict(timeout_min=spec["time"],
                        tasks_per_node=spec["ntasks_per_node"])
        self._executor.update_parameters(**spec)
        return self._executor.submit(fn, flags).job_id


def submitit_executor(partition, folder="./out/", **kwargs):
    """Back-compat shim for the round-2 API.  The old fixed
    timeout_min/mem_gb/cpus knobs are superseded by the per-job
    reference specs (SubmititExecutor.job_spec); a caller that still
    passes one gets a DeprecationWarning naming it (ADVICE r3: silently
    replacing a deliberate shorter timeout / larger memory request with
    the reference spec gave different Slurm resources with no signal)."""
    ignored = [legacy for legacy in ("timeout_min", "mem_gb", "cpus")
               if kwargs.pop(legacy, None) is not None]
    if ignored:
        warnings.warn(
            f"submitit_executor: ignoring legacy resource knob(s) "
            f"{', '.join(ignored)} — per-job resources now come from "
            f"SubmititExecutor.job_spec (reference slurm_bc.py:191-205)",
            DeprecationWarning, stacklevel=2)
    return SubmititExecutor(partition=partition, folder=folder, **kwargs)


# -- BC sweep ----------------------------------------------------------------

BC_EMBEDDINGS = [
    "true_state",
    "moco_croponly_places_uber_345", "moco_croponly_uber_345",
    "moco_croponly_places_uber_35", "moco_croponly_uber_35",
    "moco_croponly_places_uber_34", "moco_croponly_uber_34",
    "moco_croponly_places_uber_45", "moco_croponly_uber_45",
    "moco_aug_habitat",
    "moco_croponly_places_l4", "moco_croponly_places_l3",
    "moco_croponly_places", "moco_croponly_l3", "moco_croponly_l4",
    "moco_croponly", "moco_coloronly",
    "moco_aug_places_l3", "moco_aug_places_l4", "moco_aug_places",
    "moco_aug_l4", "moco_aug_l3", "moco_aug",
    "clip_rn50", "clip_vit", "mae_base", "mae_large",
    "resnet34", "resnet50", "resnet50_places", "resnet50_l4",
    "resnet50_l3", "resnet50_places_l4", "resnet50_places_l3",
    "random",
]


def default_bc_grid(scene_prefix="HabitatImageNav"):
    scenes = [f"{scene_prefix}-{s}" for s in (
        "apartment_0", "frl_apartment_0", "office_0", "room_0", "hotel_0")]
    return dict(
        env=[",".join(scenes)],
        to_env=scenes,
        embedding_name=list(BC_EMBEDDINGS),
        save_path=["latest"],
        max_frames=[0],
        run_id=list(range(1, 11)),
        unroll_length=[100],
        batch_size=[16],
        learning_rate=[0.0001],
        n_episodes_test=[50],
        eval_frequency=[200],
    )


def run_bc_sweep(grid=None, executor=None, debug=False, dry_run=False,
                 max_frames_map=None, finetune=False):
    """BC sweep (slurm_bc.py semantics).  ``finetune=True`` = the
    slurm_bc_finetune.py variant: every job trains the conv policy end
    to end and saves under ``emrandom_finetuned``; the completed-run
    skip checks that name."""
    from pvr_habitat_tpu_torch.train.bc import run as bc_run

    def runner_random(flags):
        return bc_run(flags, mode="embed_at_load")

    def runner_pvr(flags):
        return bc_run(flags, mode="precomputed")

    def runner_finetune(flags):
        return bc_run(flags, mode="finetune")

    executor = executor or LocalExecutor()
    grid = grid if grid is not None else default_bc_grid()
    parser = build_parser()
    submitted = []
    for run_args in expand_args(grid, max_frames_map):
        flags = parser.parse_args(make_command(run_args))
        if flags.to_env not in flags.env:   # skip transfer runs
            continue
        label = "random_finetuned" if finetune else None
        if is_run_completed(flags, label):
            print("skipping completed", flags.xpid)
            continue
        flags.essential_save_only = True
        if flags.embedding_name != "true_state":
            flags.batch_norm = True
        if finetune:
            runner = runner_finetune
        elif flags.embedding_name == "random":
            runner = runner_random
        else:
            runner = runner_pvr
        if dry_run:
            submitted.append(flags)
            continue
        job = executor.submit(runner, flags)
        submitted.append(job)
        if debug:
            print("debug: one job only")
            break
    return submitted


# -- embedding sweep (slurm_eo.py) --------------------------------------------


def default_embedding_grid(scene_prefix="HabitatImageNav",
                           embeddings=None):
    scenes = [f"{scene_prefix}-{s}" for s in (
        "apartment_0", "frl_apartment_0", "office_0", "room_0", "hotel_0")]
    return dict(
        env=scenes,
        embedding_name=embeddings if embeddings is not None
        else list(BC_EMBEDDINGS),
        batch_size=[32],
    )


def run_embedding_sweep(grid=None, executor=None, data_path=None,
                        source="pickle", dry_run=False):
    """Embedding sweep (slurm_eo.py semantics).  The jobs read the raw
    trajectory pickles (``source="pickle"``, the JAX sweep's default),
    set on every job: the port's ``save_embedded_obs`` CLI defaults to
    ``png``."""
    from pvr_habitat_tpu_torch.tools.save_embedded_obs import (
        build_tool_parser, run as embed_job)

    executor = executor or LocalExecutor()
    grid = grid if grid is not None else default_embedding_grid()
    parser = build_tool_parser()
    submitted = []
    for run_args in expand_args(grid):
        flags = parser.parse_args(make_command(run_args))
        flags.source = source
        if data_path:
            flags.data_path = data_path
        out = os.path.join(flags.data_path,
                           f"{flags.env}_{flags.embedding_name}.pickle")
        if os.path.isfile(out):        # idempotent skip
            continue
        if dry_run:
            submitted.append(flags)
            continue
        submitted.append(executor.submit(embed_job, flags))
    return submitted


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kind", choices=["bc", "embed", "finetune"],
                        default="bc")
    parser.add_argument("--local", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--partition", type=str, default="learnfair")
    parser.add_argument("--fake", action="store_true",
                        help="Use the hermetic FakeNav scenes.")
    parser.add_argument("--disable_cuda", action="store_true",
                        help="Run every job on the CPU.")
    args = parser.parse_args(argv)

    prefix = "FakeImageNav" if args.fake else "HabitatImageNav"
    # a scalar grid entry is set on every job and is not swept
    device = {"disable_cuda": True} if args.disable_cuda else {}
    executor = LocalExecutor() if args.local else None
    if executor is None:
        try:
            executor = SubmititExecutor(
                args.partition, debug=args.debug,
                kind="embed" if args.kind == "embed" else "bc")
        except ImportError:
            print("submitit not installed; running locally")
            executor = LocalExecutor()

    if args.kind == "bc":
        run_bc_sweep({**default_bc_grid(prefix), **device}, executor,
                     debug=args.debug)
    elif args.kind == "embed":
        run_embedding_sweep({**default_embedding_grid(prefix), **device},
                            executor)
    else:
        grid = {**default_bc_grid(prefix), **device}
        grid["embedding_name"] = ["random"]
        run_bc_sweep(grid, executor, debug=args.debug, finetune=True)


if __name__ == "__main__":
    main()
