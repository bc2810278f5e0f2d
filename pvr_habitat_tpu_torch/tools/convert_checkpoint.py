"""Convert a reference PyTorch encoder checkpoint to the flat format
(counterpart of ``pvr_habitat_tpu/tools/convert_checkpoint.py``).

  python -m pvr_habitat_tpu_torch.tools.convert_checkpoint \\
      --embedding_name moco_aug --checkpoint moco_aug.pth.tar \\
      --out moco_aug.converted.tar [--disable_cuda]

Applies the same key surgery the reference uses for that encoder
(module. / module.encoder_q. stripping, backbone extraction) and
validates the full expected parameter set, through the port's registry.
The file it writes is the JAX tool's: the same keys, the same arrays
(HWIO numpy, ``convert.save_flat``) and the same extra
``embedding_name``, so it loads in both packages.  After conversion,
dropping the ORIGINAL torch file under --data_path works too (the
registry loads it directly); this tool is for ahead-of-time conversion
and validation.  The encoder is built on the card unless
``--disable_cuda`` asks for the CPU; the conversion is exact either
way."""

import argparse
import os
import shutil
import tempfile

from pvr_habitat_tpu_torch.models import convert
from pvr_habitat_tpu_torch.models.registry import (CHECKPOINT_FILES,
                                                   build_encoder)
from pvr_habitat_tpu_torch.utils.platform import resolve_device


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--embedding_name", required=True,
                        choices=sorted(CHECKPOINT_FILES))
    parser.add_argument("--checkpoint", required=True,
                        help="Path to the torch .pth/.tar file.")
    parser.add_argument("--out", required=True,
                        help="Output path for the converted weights.")
    parser.add_argument("--disable_cuda", action="store_true",
                        help="Build the encoder on the CPU.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    # Stage the file under the reference's expected filename so the
    # registry's loader (surgery + validation) does the work.
    with tempfile.TemporaryDirectory() as tmp:
        staged = os.path.join(tmp, CHECKPOINT_FILES[args.embedding_name])
        shutil.copy(args.checkpoint, staged)
        handle = build_encoder(
            args.embedding_name, pretrained=True, checkpoint_dir=tmp,
            device=resolve_device("cpu" if args.disable_cuda else None))
    convert.save_flat(args.out, handle.params,
                      extra={"embedding_name": args.embedding_name})
    n_params = sum(v.numel() for v in handle.params.values())
    print(f"converted {args.embedding_name}: "
          f"{len(handle.params)} tensors, {n_params / 1e6:.1f}M params "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
