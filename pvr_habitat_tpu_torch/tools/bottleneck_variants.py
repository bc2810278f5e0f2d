"""Times builds of the bf16 fused-bottleneck kernels against each other on
one card, in turns, at ResNet-50's 8 block shapes (batch 256, random
seeded weights, BN folded), beside cuDNN.

    python -m pvr_habitat_tpu_torch.tools.bottleneck_variants \\
        [--source parent=path/to/fused_bottleneck.cu ...] \\
        [--diag no_b=path/to/variant.cu ...] [--json PATH]

The tree's ``csrc/fused_bottleneck.cu`` is always built, as ``tree``.
``--source LABEL=PATH`` builds another source with the same C interface
(an earlier version of the kernel, or a copy with other constants); each
such build is held against the plain version (per-image cosine > 0.999,
the bf16 gate of ``tests/test_torch_cuda_kernels.py``) at every shape
before it is timed.  ``--diag
LABEL=PATH`` builds and times a source without that check: a variant
that leaves out one part of the work (a feed, the products) to show what
that part costs.
Prints each build's ptxas registers and spills per bf16 instance, then,
per block shape and route (``v1``, and ``v2`` at stride 1), each build's
ms per launch in two rounds (builds in order, then in reverse), each the
mean of back-to-back launches, and their mean; then each build's ms per
ResNet-50 forward (16 ``v1`` launches, 13 ``v2``).  ``--json PATH``
writes the same as JSON.  Needs a CUDA card and nvcc.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from pvr_habitat_tpu_torch.ops.cuda import build
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb

# (first block of the shape class, H in, stride, Cin, launches per forward
# on v1, on v2); P and Cout follow from the weights.
BLOCKS = [("layer1.0", 56, 1, 64, 1, 1), ("layer1.1", 56, 1, 256, 2, 2),
          ("layer2.0", 56, 2, 256, 1, 0), ("layer2.1", 28, 1, 512, 3, 3),
          ("layer3.0", 28, 2, 512, 1, 0), ("layer3.1", 14, 1, 1024, 5, 5),
          ("layer4.0", 14, 2, 1024, 1, 0), ("layer4.1", 7, 1, 2048, 2, 2)]
BATCH = 256


def time_ms(fn, launches=5, reps=3):
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


def row_cosine(a, b):
    a, b = a.float().reshape(a.shape[0], -1), b.float().reshape(b.shape[0], -1)
    return F.cosine_similarity(a, b, dim=1).min().item()


def resnet50_params():
    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet

    return EmbeddingNet("resnet50", pretrained=False,
                        compute_dtype=torch.float32, fused="off").params


def cudnn_block(params, prefix, x, stride):
    """The block as bf16 channels_last ``F.conv2d`` calls (cuDNN)."""

    def w(name):
        return params[f"{prefix}.{name}.weight"].to(
            torch.bfloat16, memory_format=torch.channels_last)

    def b(name):
        return params[f"{prefix}.{name}.bias"].to(torch.bfloat16)

    xc = x.permute(0, 3, 1, 2)
    ds = f"{prefix}.downsample.0.weight" in params

    def run():
        y = F.relu(F.conv2d(xc, w("conv1"), b("bn1")))
        y = F.relu(F.conv2d(y, w("conv2"), b("bn2"), stride, 1))
        y = F.conv2d(y, w("conv3"), b("bn3"))
        sc = (F.conv2d(xc, w("downsample.0"), b("downsample.1"), stride)
              if ds else xc)
        return F.relu(y + sc)

    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--diag", action="append", default=[])
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bottleneck_variants: CUDA is not available", file=sys.stderr)
        return 1

    variants = [("tree", "fused_bottleneck", None)]
    unchecked = set()
    for spec in args.source + args.diag:
        label, path = spec.split("=", 1)
        variants.append((label, "fused_bottleneck",
                         str(Path(path).resolve())))
        if spec in args.diag:
            unchecked.add(label)
    report = build.build((), variants)
    result = {"device": torch.cuda.get_device_name(0), "ptxas": {},
              "times": {}, "per_forward": {}}
    libs = {}
    for label, name, source in variants:
        libs[label] = build.load(name, source)
        rows = [r for r in build.ptxas_report(
                    build.ptxas_output(name, source))
                if r[0].startswith("bottleneck_mma_kernel")]
        result["ptxas"][label] = rows
        print(f"{label}: built in {report[label][0]:.1f} s" if label in report
              else f"{label}: built before this run", flush=True)
        for kernel, regs, st, ld in rows:
            print(f"  {kernel}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")

    params = resnet50_params()
    gen = torch.Generator(device="cuda")
    forward = {label: {"v1": 0.0, "v2": 0.0} for label in libs}
    forward["cudnn"] = {"v1": 0.0, "v2": 0.0}
    for prefix, h, s, cin, n_v1, n_v2 in BLOCKS:
        gen.manual_seed(h + cin)
        x = torch.randn(BATCH, h, h, cin, device="cuda", generator=gen,
                        dtype=torch.float32).relu_().to(torch.bfloat16)
        w = fb.block_weights(params, prefix, torch.bfloat16)
        mask = torch.from_numpy(fb.flat_mask(h, h)).cuda()
        xf = fb.to_padded_flat(x)
        routes = [("v1", n_v1,
                   lambda lib: fb.fused_bottleneck(x, *w, stride=s, lib=lib),
                   lambda: fb.fused_bottleneck_ref(x, *w, stride=s))]
        if n_v2:
            routes.append((
                "v2", n_v2,
                lambda lib: fb.fused_bottleneck_flat(xf, mask, *w, h=h, w=h,
                                                     lib=lib),
                lambda: fb.fused_bottleneck_flat_ref(xf, mask, *w, h=h,
                                                     w=h)))
        cudnn = time_ms(cudnn_block(params, prefix, x, s))
        for route, count, run, plain in routes:
            want = plain()
            for label, lib in libs.items():
                if label in unchecked:
                    continue
                cos = row_cosine(run(lib), want)
                if cos <= 0.999:
                    raise AssertionError(f"{label} {prefix} {route}: "
                                         f"cosine {cos}")
            del want
            rounds = {label: [] for label in libs}
            for label in list(libs) + list(reversed(libs)):
                rounds[label].append(time_ms(lambda: run(libs[label])))
            key = f"{prefix} {route}"
            result["times"][key] = {"count": count, "cudnn_ms": cudnn,
                                    "ms": rounds}
            print(f"{key} (x{count}/forward): cudnn {cudnn:.4f} ms",
                  flush=True)
            for label, ms in rounds.items():
                mean = statistics.mean(ms)
                forward[label][route] += count * mean
                print(f"  {label}: {ms[0]:.4f} {ms[1]:.4f} mean {mean:.4f} ms",
                      flush=True)
            forward["cudnn"][route] += count * cudnn
    result["per_forward"] = forward
    print("ms per ResNet-50 forward (v1: 16 launches, v2: 13):")
    for label, ms in forward.items():
        print(f"  {label}: v1 {ms['v1']:.3f} v2 {ms['v2']:.3f}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
