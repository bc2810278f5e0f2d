"""BC with embed-at-load (for the seed-dependent 'random' encoder) — the
port's counterpart of the JAX package's ``main_bc_1.py``: the raw
trajectory pickle is embedded when it is loaded, then trained on.

    python -m pvr_habitat_tpu_torch.main_bc_1 --env FakePointNav-hotel_0 \\
        --to_env FakePointNav-hotel_0 --embedding_name random \\
        --data_path DIR --save_path DIR/bc [--disable_cuda]
"""

from pvr_habitat_tpu_torch.train.bc import run as _run
from pvr_habitat_tpu_torch.utils.flags import parser


def run(flags):
    return _run(flags, mode="embed_at_load")


if __name__ == "__main__":
    run(parser.parse_args())
