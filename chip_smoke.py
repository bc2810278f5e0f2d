#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py

Drives the port's main path, the ResNet-50 frame-embedding service
(uint8 64x64 frames -> matmul preprocess -> BN-folded ResNet-50 ->
2048-d embedding), through ``EmbeddingNet`` with random seeded weights,
and holds every kernel of that path against its plain PyTorch version.
Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: nvcc compiles ``ops/cuda/csrc/*.cu`` into ``build/kernels``;
3. kernels: both fused-bottleneck kernels against their plain versions
   at every ResNet-50 block shape, in f32 (TF32 off, batch 8, 1e-4) and
   in bf16 (batch 256, per-image cosine gate), with the v2 border;
4. slice: ``EmbeddingNet("resnet50", compute_dtype=bf16)`` with ``fused``
   set to v1, v2 and hybrid answers a batch of 1, a batch of 3 and
   ``embed_batches`` over 1024 frames at batch 256; each answer is held
   against the f32 ``fused="off"`` path, and the launch counters must
   show the kernels ran (16 / 13 / 3+7 launches per forward);
5. times: each kernel's median ms per shape beside its bound, its plain
   version and the same block as cuDNN bf16 channels_last ``F.conv2d``
   calls; end-to-end frames/s for off, v1, v2 and hybrid.

The last three lines are the card's name and power limit, one JSON
object with the kernels' numbers, and the verdict
``{"ok": true, "device": {...}}``.  Without CUDA it exits nonzero and
prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
SEED = 0

# ResNet-50 at 224 input: (first block of the shape class, H in, stride,
# Cin, P, Cout, projection shortcut, launches per forward on v1, on v2)
BLOCKS = [
    ("layer1.0", 56, 1, 64, 64, 256, True, 1, 1),
    ("layer1.1", 56, 1, 256, 64, 256, False, 2, 2),
    ("layer2.0", 56, 2, 256, 128, 512, True, 1, 0),
    ("layer2.1", 28, 1, 512, 128, 512, False, 3, 3),
    ("layer3.0", 28, 2, 512, 256, 1024, True, 1, 0),
    ("layer3.1", 14, 1, 1024, 256, 1024, False, 5, 5),
    ("layer4.0", 14, 2, 1024, 512, 2048, True, 1, 0),
    ("layer4.1", 7, 1, 2048, 512, 2048, False, 2, 2),
]
ROUTE_LAUNCHES = {"v1": {"fused_bottleneck": 16, "fused_bottleneck_flat": 0},
                  "v2": {"fused_bottleneck": 0, "fused_bottleneck_flat": 13},
                  "hybrid": {"fused_bottleneck": 3,
                             "fused_bottleneck_flat": 7}}
KERNELS = {
    "fused_bottleneck": (
        "pvr_habitat_tpu/ops/pallas/fused_bottleneck.py:93"),
    "fused_bottleneck_flat": (
        "pvr_habitat_tpu/ops/pallas/fused_bottleneck.py:222"),
}
SOURCE = "pvr_habitat_tpu_torch/ops/cuda/csrc/fused_bottleneck.cu"


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def time_ms(torch, fn, reps=5, warmup=2):
    """Median device time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def row_cosine(torch, a, b):
    a, b = a.float().reshape(a.shape[0], -1), b.float().reshape(b.shape[0], -1)
    return torch.nn.functional.cosine_similarity(a, b, dim=1).min().item()


def block_cost(n, h, stride, cin, p, cout, ds, itemsize, flat):
    """(bytes, FLOP) the block must move and do: x read once, out written
    once, weights and biases read once; FLOP of the block's products."""
    ho = h // stride
    pix_in = (h + 2) ** 2 if flat else h * h
    pix_out = (ho + 2) ** 2 if flat else ho * ho
    weights = cin * p + 9 * p * p + p * cout + (cin * cout if ds else 0)
    nbytes = (n * (pix_in * cin + pix_out * cout) + weights) * itemsize \
        + 4 * (2 * p + cout * (2 if ds else 1)) + (4 * pix_in if flat else 0)
    flop = 2 * n * (h * h * cin * p + ho * ho * (
        9 * p * p + p * cout + (cin * cout if ds else 0)))
    return nbytes, flop


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.ops.cuda import build
    from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb
    from pvr_habitat_tpu_torch.utils.platform import resolve_device

    device = resolve_device()          # cuda; sets TF32 off
    t0 = phase("1 device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {smi}")

    t0 = phase("2 build")
    report = build.build()
    for name, (seconds, output) in report.items():
        print(f"built {name} in {seconds:.1f} s")
        for line in output.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    build.load("fused_bottleneck")
    print(f"build phase {time.perf_counter() - t0:.1f} s")

    # Real ResNet-50 weights (seeded init, BN folded) for every block.
    net32 = EmbeddingNet("resnet50", pretrained=False,
                         compute_dtype=torch.float32, fused="off")
    params = net32.params
    gen = torch.Generator(device=device)

    def activations(n, h, c, dtype):
        gen.manual_seed(SEED + h + c)
        return torch.randn(n, h, h, c, device=device, generator=gen,
                           dtype=torch.float32).relu_().to(dtype)

    t0 = phase("3 kernels vs plain versions")
    max_err = {k: 0.0 for k in KERNELS}
    for prefix, h, s, cin, p, cout, ds, _, n_v2 in BLOCKS:
        for dtype, n in ((torch.float32, 8), (torch.bfloat16, 256)):
            w = fb.block_weights(params, prefix, dtype)
            x = activations(n, h, cin, dtype)
            runs = [("fused_bottleneck",
                     lambda: fb.fused_bottleneck(x, *w, stride=s),
                     lambda: fb.fused_bottleneck_ref(x, *w, stride=s))]
            if n_v2:
                mask = torch.from_numpy(fb.flat_mask(h, h)).to(device)
                xf = fb.to_padded_flat(x)
                runs.append((
                    "fused_bottleneck_flat",
                    lambda: fb.fused_bottleneck_flat(xf, mask, *w, h=h, w=h),
                    lambda: fb.fused_bottleneck_flat_ref(xf, mask, *w, h=h,
                                                         w=h)))
            for kernel, run, plain in runs:
                got = run()
                torch.cuda.synchronize()
                want = plain()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{kernel} {prefix}: not finite")
                err = (got.float() - want.float()).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, atol=1e-4,
                                               rtol=1e-4)
                    max_err[kernel] = max(max_err[kernel], err)
                    gate = f"max_abs_err {err:.3g} (atol=rtol=1e-4)"
                else:
                    cos = row_cosine(torch, got, want)
                    if cos <= 0.999:
                        raise AssertionError(
                            f"{kernel} {prefix} bf16: cosine {cos}")
                    gate = f"max_abs_err {err:.3g}, min cosine {cos:.6f}"
                if kernel == "fused_bottleneck_flat":
                    border = got.reshape(n, h + 2, h + 2, cout)
                    if (border[:, 0].any() or border[:, -1].any()
                            or border[:, :, 0].any()
                            or border[:, :, -1].any()):
                        raise AssertionError(f"{kernel} {prefix}: border")
                print(f"{kernel} {prefix} {str(dtype)[6:]} n={n}: {gate}",
                      flush=True)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("4 slice: EmbeddingNet resnet50 bf16")
    frames = np.random.RandomState(SEED).randint(
        0, 256, size=(1024, 64, 64, 3), dtype=np.uint8)
    ref = net32.embed_batches(frames, 256)
    if ref.shape != (1024, 2048) or not np.isfinite(ref).all():
        raise AssertionError(f"f32 reference: {ref.shape}")
    ref = torch.from_numpy(ref)
    nets = {}
    launches = {k: 0 for k in KERNELS}
    for route, per_forward in ROUTE_LAUNCHES.items():
        net = EmbeddingNet("resnet50", pretrained=False,
                           compute_dtype=torch.bfloat16, fused=route)
        nets[route] = net
        fb.reset_launches()
        one = net(frames[:1])
        three = net(frames[1:4])
        bulk = net.embed_batches(frames, 256)
        counts = dict(fb.launches)
        forwards = 1 + 1 + 1024 // 256
        want = {k: v * forwards for k, v in per_forward.items()}
        if counts != want:
            raise AssertionError(f"{route}: launches {counts} != {want}")
        for k in KERNELS:
            launches[k] += counts[k]
        if one.shape != (2048,) or three.shape != (3, 2048) \
                or bulk.shape != (1024, 2048):
            raise AssertionError(f"{route}: shapes {one.shape} "
                                 f"{three.shape} {bulk.shape}")
        got = torch.from_numpy(np.concatenate([one[None], three, bulk]))
        if not torch.isfinite(got).all():
            raise AssertionError(f"{route}: not finite")
        cos = row_cosine(torch, got, torch.cat([ref[:4], ref]))
        if cos <= 0.99:
            raise AssertionError(f"{route}: cosine vs f32 off {cos}")
        print(f"route {route}: launches {counts} over {forwards} forwards; "
              f"min cosine vs f32 off {cos:.6f}", flush=True)
    default = EmbeddingNet("resnet50", pretrained=False,
                           compute_dtype=torch.bfloat16)
    if default.fused != "v1":
        raise AssertionError(f"default route {default.fused}")
    print(f"slice phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("5 times (batch 256, bf16)")
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bytes_ms": 0.0, "flop_ms": 0.0}
              for k in KERNELS}
    n = 256
    for prefix, h, s, cin, p, cout, ds, n_v1, n_v2 in BLOCKS:
        w = fb.block_weights(params, prefix, torch.bfloat16)
        x = activations(n, h, cin, torch.bfloat16)

        def lib_w(name):
            return params[f"{prefix}.{name}.weight"].to(
                torch.bfloat16, memory_format=torch.channels_last)

        def lib_b(name):
            return params[f"{prefix}.{name}.bias"].to(torch.bfloat16)

        xc = x.permute(0, 3, 1, 2)     # channels_last view

        def library():
            y = F.relu(F.conv2d(xc, lib_w("conv1"), lib_b("bn1")))
            y = F.relu(F.conv2d(y, lib_w("conv2"), lib_b("bn2"), s, 1))
            y = F.conv2d(y, lib_w("conv3"), lib_b("bn3"))
            sc = (F.conv2d(xc, lib_w("downsample.0"), lib_b("downsample.1"),
                           s) if ds else xc)
            return F.relu(y + sc)

        library_ms = time_ms(torch, library)
        mask = torch.from_numpy(fb.flat_mask(h, h)).to(device)
        xf = fb.to_padded_flat(x)
        cases = [("fused_bottleneck", n_v1, False,
                  lambda: fb.fused_bottleneck(x, *w, stride=s),
                  lambda: fb.fused_bottleneck_ref(x, *w, stride=s))]
        if n_v2:
            cases.append((
                "fused_bottleneck_flat", n_v2, True,
                lambda: fb.fused_bottleneck_flat(xf, mask, *w, h=h, w=h),
                lambda: fb.fused_bottleneck_flat_ref(xf, mask, *w, h=h,
                                                     w=h)))
        for kernel, count, flat, run, plain in cases:
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain, reps=3, warmup=1)
            nbytes, flop = block_cost(n, h, s, cin, p, cout, ds, 2, flat)
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            flop_ms = flop / PEAK_BF16_FLOP_PER_S * 1e3
            bound = max(bytes_ms, flop_ms)
            tot = totals[kernel]
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("bound_ms", bound),
                             ("bytes_ms", bytes_ms), ("flop_ms", flop_ms)):
                tot[key] += count * val
            print(f"time {kernel} {prefix} (x{count}/forward): ms {ms:.4f} "
                  f"bound {bound:.4f} "
                  f"({'bytes' if bytes_ms >= flop_ms else 'operations'}: "
                  f"{nbytes / 1e6:.1f} MB, {flop / 1e9:.1f} GFLOP) "
                  f"plain {plain_ms:.4f} library {library_ms:.4f}",
                  flush=True)

    dev_frames = torch.from_numpy(frames[:n]).to(device)
    for route in ("off", "v1", "v2", "hybrid"):
        net = nets.get(route) or EmbeddingNet(
            "resnet50", pretrained=False, compute_dtype=torch.bfloat16,
            fused=route)
        ms = time_ms(torch, lambda: net._forward(dev_frames), reps=5,
                     warmup=1)
        print(f"e2e {route}: {n / ms * 1e3:.1f} frames/s "
              f"({ms:.3f} ms per batch of {n}, frames on device)", flush=True)
    print(f"times phase {time.perf_counter() - t0:.1f} s")

    line = {"kernels": [{
        "name": k, "route": "cuda", "source": SOURCE, "replaces": KERNELS[k],
        "launches": launches[k], "max_abs_err": max_err[k],
        "ms": totals[k]["ms"], "plain_ms": totals[k]["plain_ms"],
        "bound_ms": totals[k]["bound_ms"],
        "bound_by": ("bytes" if totals[k]["bytes_ms"] >= totals[k]["flop_ms"]
                     else "operations"),
        "library_ms": totals[k]["library_ms"],
    } for k in KERNELS]}
    print("kernel times are per forward of the route that runs the kernel "
          "on every block it can (v1: 16 launches, v2: 13), batch 256 bf16")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
