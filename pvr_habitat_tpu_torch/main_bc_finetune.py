"""End-to-end BC on raw pixels (a conv policy trained from scratch, no
frozen encoder) — the port's counterpart of the JAX package's
``main_bc_finetune.py`` (same flags, file formats and run naming:
``{env}_emrandom_finetuned_s{run_id}_{to_env}.{pickle,tar}``).

    python -m pvr_habitat_tpu_torch.main_bc_finetune \\
        --env FakePointNav-hotel_0 --to_env FakePointNav-hotel_0 \\
        --data_path DIR --save_path DIR/bc [--disable_cuda]

The raw trajectory pickle ``{data_path}/{env}.pickle`` is the input.
"""

from pvr_habitat_tpu_torch.train.bc import run as _run
from pvr_habitat_tpu_torch.utils.flags import parser


def run(flags):
    return _run(flags, mode="finetune")


if __name__ == "__main__":
    run(parser.parse_args())
