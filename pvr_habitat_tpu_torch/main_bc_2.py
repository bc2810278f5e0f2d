"""BC on precomputed embeddings — the port's counterpart of the JAX
package's ``main_bc_2.py`` (same flags, file formats and run naming).

    python -m pvr_habitat_tpu_torch.main_bc_2 --env FakePointNav-hotel_0 \\
        --to_env FakePointNav-hotel_0 --embedding_name resnet50 \\
        --data_path DIR --save_path DIR/bc [--disable_cuda]
"""

from pvr_habitat_tpu_torch.train.bc import run as _run
from pvr_habitat_tpu_torch.utils.flags import parser


def run(flags):
    return _run(flags, mode="precomputed")


if __name__ == "__main__":
    run(parser.parse_args())
