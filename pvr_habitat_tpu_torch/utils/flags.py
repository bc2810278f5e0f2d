"""Flag system (counterpart of ``pvr_habitat_tpu/utils/flags.py``).

Drop-in compatible with the reference argparse namespace
(reference: src/arguments.py:1-68) and with the JAX package's: every
flag name and default is the same, so sweep grids and checkpointed
``flags`` dicts interoperate.  In the port ``--disable_cuda`` runs
everything on the CPU; without it everything runs on ``cuda`` or raises.
Flags of parts not ported yet (a ``--mesh_shape`` of more than one
device, ``--coordinator``) are accepted and refused by the entry points
that would use them.
"""

import argparse


def build_parser():
    parser = argparse.ArgumentParser(description="PVR BC agent (PyTorch port)")

    # Behavioral Cloning settings (reference: src/arguments.py:5-14).
    parser.add_argument("--max_frames", type=int, default=200000000)
    parser.add_argument("--n_episodes_test", type=int, default=50)
    parser.add_argument("--eval_frequency", type=int, default=200)
    parser.add_argument("--to_env", type=str,
                        default="HabitatImageNav-apartment_0")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--disable_save", action="store_true")
    parser.add_argument("--essential_save_only", action="store_true")
    parser.add_argument("--save_path", type=str, default="bc")
    parser.add_argument("--data_path", type=str, default="behavioral_cloning")

    # Embedding settings (reference: src/arguments.py:16-24).
    parser.add_argument("--embedding_name", type=str, default="resnet50",
                        help="Name of the embedding model.")
    parser.add_argument("--train_embedding", action="store_true",
                        help="Train observation embedding or keep it fixed.")
    parser.add_argument("--disable_pretrained_embedding", action="store_false",
                        dest="pretrained_embedding",
                        help="Prevent loading pretrained weights.")
    parser.add_argument("--batch_norm", action="store_true",
                        help="BatchNorm1d layer at the start of the policy.")

    # Environment settings (reference: src/arguments.py:26-33).
    parser.add_argument("--env", type=str,
                        default="HabitatImageNav-apartment_0",
                        help="Training environments (comma-separated list).")
    parser.add_argument("--num_input_frames", type=int, default=1,
                        help="Frames stacked per observation.")

    # General settings (reference: src/arguments.py:35-42).
    parser.add_argument("--xpid", default=None, help="Experiment ID.")
    parser.add_argument("--run_id", default=1, type=int,
                        help="Run ID, doubles as the random seed.")
    parser.add_argument("--seed", default=1, type=int, help="Random seed.")

    # Training settings (reference: src/arguments.py:44-56).
    parser.add_argument("--total_frames", default=50000000, type=int,
                        help="Total environment frames to train for.")
    parser.add_argument("--batch_size", default=32, type=int,
                        help="Learner batch size.")
    parser.add_argument("--unroll_length", default=100, type=int,
                        help="The unroll length (time dimension).")
    parser.add_argument("--mp_start", default="spawn", type=str,
                        help="Kept for CLI compatibility; unused.")
    parser.add_argument("--disable_cuda", action="store_true",
                        help="Run on the CPU (device='cpu'); without it "
                             "everything runs on cuda or raises.")

    # Optimizer settings (reference: src/arguments.py:58-68).
    parser.add_argument("--learning_rate", default=0.0001, type=float)
    parser.add_argument("--alpha", default=0.99, type=float,
                        help="RMSProp smoothing constant.")
    parser.add_argument("--momentum", default=0, type=float,
                        help="RMSProp momentum.")
    parser.add_argument("--epsilon", default=1e-5, type=float,
                        help="RMSProp epsilon.")
    parser.add_argument("--max_grad_norm", default=40., type=float,
                        help="Max norm of gradients.")

    # Extras of the JAX package (defaults keep reference behavior: fp32
    # parity-grade numerics, one device, no sharding).
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Matmul/conv compute dtype for frozen encoders.")
    parser.add_argument("--mesh_shape", type=str, default="",
                        help="Device mesh as 'data[,model]', e.g. '4,2'. "
                             "Empty = all devices on the data axis.")
    parser.add_argument("--embed_batch_size", type=int, default=0,
                        help="Per-step batch for bulk embedding; "
                             "0 = use --batch_size (reference semantics).")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="Dump a torch.profiler trace of the training "
                             "loop to this directory (Perfetto/Chrome).")
    parser.add_argument("--eval_batch", type=int, default=1,
                        help="Evaluate K env instances in lockstep with one "
                             "batched policy step (1 = reference's "
                             "sequential protocol).")
    parser.add_argument("--max_episode_steps", type=int, default=0,
                        help="Override the simulator episode step limit "
                             "(0 = simulator default, 500 for nav tasks).")
    parser.add_argument("--coordinator", type=str, default="",
                        help="Multi-host: 'host:port' of rank 0. Empty = "
                             "single-host (the only mode ported so far).")
    parser.add_argument("--num_processes", type=int, default=1,
                        help="Multi-host: total process count.")
    parser.add_argument("--process_id", type=int, default=0,
                        help="Multi-host: this process's rank.")
    parser.add_argument("--data_on_device", type=str, default="auto",
                        choices=["auto", "always", "never"],
                        help="Keep the BC dataset resident in device memory "
                             "and gather unrolls on-device (auto = if it "
                             "fits).")
    parser.add_argument("--train_chunk", type=int, default=0,
                        help="Accepted for compatibility with the JAX "
                             "package, where it runs that many epochs in one "
                             "dispatch; it has no effect here (eager PyTorch "
                             "runs one step per epoch, with the same "
                             "losses).")
    return parser


def default_flags(**overrides):
    """A flags namespace with the reference defaults, for library use."""
    flags = build_parser().parse_args([])
    for key, value in overrides.items():
        if not hasattr(flags, key):
            raise AttributeError(f"unknown flag: {key}")
        setattr(flags, key, value)
    return flags


# Shared parser instance, mirroring the reference's module-level ``parser``
# (reference: src/arguments.py:3) so entry points can extend it.
parser = build_parser()
