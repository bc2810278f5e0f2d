"""Times builds of the bf16 fused-attention kernel against each other on
one card, in turns, at the MAE head shapes (batch 256, the strided qkv
views the ViT passes), beside ``scaled_dot_product_attention``.

    python -m pvr_habitat_tpu_torch.tools.attention_tilings \\
        [--source before=path/to/fused_attention.cu ...] \\
        [--diag no_exp=path/to/variant.cu ...] [--json PATH]

The tree's ``csrc/fused_attention.cu`` is always built, as ``tree``.
``--source LABEL=PATH`` builds another source with the same C interface:
an earlier version of the kernel, or a copy with another tiling
(``kWarpsMma``, ``kMinBlocksMma``).  Every such build is held against
the plain version (one bf16 ulp: atol 4e-3, rtol 2^-7) before it is
timed.  ``--diag LABEL=PATH`` builds and times a source without that
check: a variant that leaves out one part of the work (the exponentials,
the products, the loads) to show what that part costs.
Prints each build's ptxas registers and spills per bf16 instance, then,
per shape, each build's ms per launch in two rounds (builds in order,
then in reverse) and their mean; ``--json PATH`` writes the same as
JSON.
Needs a CUDA card and nvcc.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from pvr_habitat_tpu_torch.ops.cuda import attention as fa
from pvr_habitat_tpu_torch.ops.cuda import build

SHAPES = [("mae_base", 256, 12, 197, 64), ("mae_large", 256, 16, 197, 64),
          ("mae_huge", 256, 16, 257, 80)]


def time_ms(fn, launches=20, reps=5):
    """Median over ``reps`` of the mean device time of ``launches``
    back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def qkv(shape, seed):
    n, h, l, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, l, 3, h, d, device="cuda", generator=gen,
                    dtype=torch.float32).to(torch.bfloat16)
    return [t.transpose(1, 2) for t in x.unbind(2)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--diag", action="append", default=[])
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_tilings: CUDA is not available", file=sys.stderr)
        return 1

    variants = [("tree", "fused_attention", None)]
    unchecked = set()
    for spec in args.source + args.diag:
        label, path = spec.split("=", 1)
        variants.append((label, "fused_attention", str(Path(path).resolve())))
        if spec in args.diag:
            unchecked.add(label)
    report = build.build((), variants)
    result = {"device": torch.cuda.get_device_name(0), "ptxas": {},
              "times": {}}
    libs = {}
    for label, name, source in variants:
        libs[label] = build.load(name, source)
        rows = [r for r in build.ptxas_report(
                    build.ptxas_output(name, source))
                if r[0].startswith("attention_mma_kernel")]
        result["ptxas"][label] = rows
        print(f"{label}: built in {report[label][0]:.1f} s" if label in report
              else f"{label}: built before this run", flush=True)
        for kernel, regs, st, ld in rows:
            print(f"  {kernel}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")

    for config, *shape in SHAPES:
        q, k, v = qkv(shape, seed=sum(shape))
        want = fa.fused_attention_ref(q, k, v)
        for label, lib in libs.items():
            if label in unchecked:
                continue
            got = fa.fused_attention(q, k, v, lib=lib)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), atol=4e-3,
                                       rtol=2.0 ** -7,
                                       msg=lambda m: f"{label} {config}: {m}")
        del want
        order = list(libs) + list(reversed(libs))
        rounds = {label: [] for label in libs}
        for label in order:
            rounds[label].append(time_ms(
                lambda: fa.fused_attention(q, k, v, lib=libs[label])))
        sdpa = time_ms(lambda: torch.nn.functional
                       .scaled_dot_product_attention(q, k, v))
        result["times"][config] = {"shape": shape, "sdpa_ms": sdpa,
                                   "ms": rounds}
        print(f"{config} {tuple(shape)}: sdpa {sdpa:.4f} ms", flush=True)
        for label, ms in rounds.items():
            print(f"  {label}: {ms[0]:.4f} {ms[1]:.4f} mean "
                  f"{statistics.mean(ms):.4f} ms", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
