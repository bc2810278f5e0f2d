"""Times every launch shape (tile, cluster) of the f32 fused-bottleneck
engine at ResNet-50's 8 block shapes on one card, beside the shape that
``pick_launch`` takes and its model cost.

    python -m pvr_habitat_tpu_torch.tools.bottleneck_launch_shapes \\
        [--batch 1 --batch 4 ...] [--source path/to/variant.cu] \\
        [--json PATH]

For each block and batch (default 1, 4 and 32), on v1 with random seeded
weights (BN folded): every shape of ``launch_shapes``, each checked bit
for bit against one block a tile at ``pick_tile``'s tile (the launch
before the cluster split), then timed as the mean device time of
back-to-back launches through the C launcher (no wrapper between them),
the median of 3; ``launch_cost`` of each; and the shape the wrapper
takes with the card's cluster occupancy.  Per batch, the sum over a
forward (16 launches) at the wrapper's shape, at the best measured shape
of each block, and at one block a tile.  ``--source`` builds and times
another source with the tree's C interface in place of the tree's
``csrc/fused_bottleneck.cu``.  Needs a CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from pvr_habitat_tpu_torch.ops.cuda import build
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb
from pvr_habitat_tpu_torch.tools.bottleneck_variants import (
    BLOCKS, resnet50_params, time_ms)


def launcher(lib, x, w, stride, shape, out):
    """One launch of the kernel at ``shape`` through the C interface."""
    n, h, w_, cin = x.shape
    p, cout = w[0].shape[1], w[4].shape[1]
    args = (0, x.data_ptr(), *(t.data_ptr() if t is not None else None
                               for t in w),
            out.data_ptr(), n, h, w_, cin, p, cout, stride, *shape,
            torch.cuda.current_stream().cuda_stream)

    def run():
        err = lib.fused_bottleneck_launch(*args)
        if err:
            raise RuntimeError(
                f"launch at {shape} failed: "
                f"{lib.fused_bottleneck_error_string(err).decode()}")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, action="append")
    ap.add_argument("--source")
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bottleneck_launch_shapes: CUDA is not available",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    source = str(Path(args.source).resolve()) if args.source else None
    lib = build.load("fused_bottleneck", source)
    for kernel, regs, st, ld in build.ptxas_report(
            build.ptxas_output("fused_bottleneck", source)):
        if kernel.startswith("bottleneck_kernel"):
            print(f"ptxas: {kernel}: {regs} registers, spill stores {st} B, "
                  f"loads {ld} B", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    params = resnet50_params()
    gen = torch.Generator(device="cuda")
    result = {"device": smi, "source": args.source, "blocks": {},
              "per_forward": {}}
    for n in args.batch or (1, 4, 32):
        forward = {"wrapper": 0.0, "best": 0.0, "one block a tile": 0.0}
        for prefix, h, s, cin, count, _ in BLOCKS:
            gen.manual_seed(h + cin)
            x = torch.randn(n, h, h, cin, device="cuda", generator=gen,
                            dtype=torch.float32).relu_()
            w = fb.block_weights(params, prefix, torch.float32)
            p, cout, ds, ho = w[0].shape[1], w[4].shape[1], w[6] is not None, \
                h // s
            out = torch.empty(n, ho, ho, cout, device="cuda")
            parent = (fb.pick_tile(ho, s, cin, p, cout, ds, 4), 1)
            chosen = fb._pick(lib, 0, False, ho, s, cin, p, cout, ds, 4, n)
            launcher(lib, x, w, s, parent, out)()
            want = out.clone()
            rows = {}
            for shape in fb.launch_shapes(ho, s, p, cout, 4):
                run = launcher(lib, x, w, s, shape, out)
                run()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{prefix} n={n} {shape}: not the "
                                         "bits of one block a tile")
                cost = fb.launch_cost(
                    *shape, ho, s, cin, p, cout, ds, n, sms,
                    lambda c, smem: fb.max_clusters(lib, 0, False, c, smem))
                rows[shape] = (time_ms(run, launches=10), cost[0])
            best = min(rows, key=lambda k: rows[k][0])
            for key, shape in (("wrapper", chosen), ("best", best),
                               ("one block a tile", parent)):
                forward[key] += count * rows[shape][0]
            result["blocks"][f"{prefix} n={n}"] = {
                "wrapper": chosen, "best": best, "one_block_a_tile": parent,
                "shapes": {f"{t},{c}": v for (t, c), v in rows.items()}}
            print(f"{prefix} n={n} (x{count}/forward): wrapper {chosen} "
                  f"{rows[chosen][0]:.4f} ms; best {best} "
                  f"{rows[best][0]:.4f}; one block a tile "
                  f"{rows[parent][0]:.4f}", flush=True)
            print("  " + " ".join(f"{t},{c}:{ms:.4f}[{cost}]"
                                  for (t, c), (ms, cost) in rows.items()),
                  flush=True)
        result["per_forward"][n] = forward
        print(f"n={n} per forward (16 launches): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in forward.items()), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
