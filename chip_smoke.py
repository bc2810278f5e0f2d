#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py

Drives the port's two paths through ``EmbeddingNet`` with random seeded
weights: the ResNet-50 frame-embedding service (uint8 64x64 frames ->
matmul preprocess -> BN-folded ResNet-50 -> 2048-d embedding) and the
MAE ViT embedding service (uint8 64x64 frames -> bicubic preprocess ->
patch embed -> 12 pre-LN transformer blocks -> 768-d CLS embedding), and
holds every kernel of those paths against its plain PyTorch version.
Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: nvcc compiles ``ops/cuda/csrc/*.cu`` into ``build/kernels``,
   one process per source, all started together, and prints each kernel
   instance's registers and spill bytes from ptxas; the bf16 bottleneck
   kernel's v1 and v2 instances (``BF16_INSTANCES``) must be among them;
3. kernels: both fused-bottleneck kernels against their plain versions
   at every ResNet-50 block shape, in f32 (TF32 off, batch 8, 1e-4) and
   in bf16 (batch 256, per-image cosine gate), with the v2 border; the
   fused-attention kernel at the mae_base, mae_large and mae_huge head
   shapes, on the strided qkv views the service passes, in bf16 (batch
   256, within one ulp, per-row relative error and cosine) and f32
   (batch 8, 1e-5), and at the ragged (2, 4, 17, 16) and the bf16
   tiling's edges (``ATTENTION_EDGES``), contiguous;
4. slice, ResNet-50: ``EmbeddingNet("resnet50", compute_dtype=bf16)``
   with ``fused`` set to v1, v2 and hybrid answers a batch of 1, a batch
   of 3 and ``embed_batches`` over 1024 frames at batch 256; each answer
   is held against the f32 ``fused="off"`` path, and the launch counters
   must show the kernels ran (16 / 13 / 3+7 launches per forward);
5. slice, MAE: ``EmbeddingNet("mae_base", compute_dtype=bf16)`` on its
   card default route, ``attention``, answers the same requests, held
   against the f32 ``fused="off"`` path; 12 attention launches per
   forward;
6. times: each kernel's median ms per shape beside its bound, its plain
   version and one library call of the same function (cuDNN bf16
   channels_last ``F.conv2d`` for a block, ``scaled_dot_product_attention``
   for attention); end-to-end frames/s for every route of both paths.

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
# MAE attention cores: (config, heads, L, head dim, launches per forward)
ATTENTION = [("mae_base", 12, 197, 64, 12),
             ("mae_large", 16, 197, 64, 24),
             ("mae_huge", 16, 257, 80, 32)]
# bf16 attention shapes at the edges of the kernel's tiling: rows of 8,
# 16 and 17 key tiles held in registers (full, no ragged tile), and a row
# past 17 tiles that takes two passes over the keys.
ATTENTION_EDGES = [(2, 4, 128, 64), (2, 4, 256, 64), (2, 4, 272, 80),
                   (2, 4, 600, 64)]
MAE_LAUNCHES = {"fused_attention": 12}
# The bf16 engine of fused_bottleneck.cu, FLAT = false (v1) and true (v2).
BF16_INSTANCES = {"bottleneck_mma_kernel<0>", "bottleneck_mma_kernel<1>"}
# kernel -> (TPU kernel it replaces, CUDA source)
KERNELS = {
    "fused_bottleneck": (
        "pvr_habitat_tpu/ops/pallas/fused_bottleneck.py:93",
        "pvr_habitat_tpu_torch/ops/cuda/csrc/fused_bottleneck.cu"),
    "fused_bottleneck_flat": (
        "pvr_habitat_tpu/ops/pallas/fused_bottleneck.py:222",
        "pvr_habitat_tpu_torch/ops/cuda/csrc/fused_bottleneck.cu"),
    "fused_attention": (
        "pvr_habitat_tpu/ops/pallas/attention.py:149",
        "pvr_habitat_tpu_torch/ops/cuda/csrc/fused_attention.cu"),
}


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


def attention_cost(n, h, l, d, itemsize):
    """(bytes, FLOP) one attention launch must move and do: q, k, v read
    once, out written once; QK^T and PV."""
    return 4 * n * h * l * d * itemsize, 4 * n * h * l * l * d


def count_launches(fb, fa):
    return {**fb.launches, **fa.launches}


def reset_launches(fb, fa):
    fb.reset_launches()
    fa.reset_launches()


def check_bottleneck_kernels(torch, fb, params, activations, device,
                             max_err):
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


def attention_inputs(torch, gen, shape, dtype, strided=True):
    """q, k, v of ``shape`` (N, H, L, D).  ``strided``: (N, H, L, D) views
    of one (N, L, 3, H, D) tensor, the layout ``models/vit.py`` passes;
    else three contiguous tensors."""
    gen.manual_seed(SEED + sum(shape))
    n, h, l, d = shape
    if strided:
        qkv = torch.randn(n, l, 3, h, d, device="cuda", generator=gen,
                          dtype=torch.float32).to(dtype)
        return [t.transpose(1, 2) for t in qkv.unbind(2)]
    return [torch.randn(*shape, device="cuda", generator=gen,
                        dtype=torch.float32).to(dtype) for _ in range(3)]


# bf16 gate.  Both round p and the output to bf16 at the same points, so
# an output moves at most one bf16 ulp, at most 2^-7 of its value: rtol
# 2^-7, atol 4e-3 (one ulp below 1).  The per-row relative norm error is
# then at most 2^-7 too; a whole row scaled by a few percent (a lost mask,
# a wrong row sum) fails its bound of 1e-2.
ATTN_BF16_ATOL, ATTN_BF16_RTOL = 4e-3, 2.0 ** -7
ATTN_BF16_ROW_REL = 1e-2


def check_attention_kernel(torch, fa, gen, max_err):
    """f32 at 1e-5 (the JAX test's tolerance).  bf16 elementwise within
    one ulp, per-row relative norm error and per-row cosine.
    The MAE shapes read the strided qkv views the service passes; the
    ragged JAX-test shape and the tiling's edges read contiguous tensors."""
    cases = [((2, 4, 17, 16), dtype, False) for dtype in (torch.float32,
                                                          torch.bfloat16)]
    cases += [(shape, torch.bfloat16, False) for shape in ATTENTION_EDGES]
    for _, h, l, d, _ in ATTENTION:
        cases += [((8, h, l, d), torch.float32, True),
                  ((256, h, l, d), torch.bfloat16, True)]
    for shape, dtype, strided in cases:
        q, k, v = attention_inputs(torch, gen, shape, dtype, strided)
        got = fa.fused_attention(q, k, v)
        torch.cuda.synchronize()
        want = fa.fused_attention_ref(q, k, v)
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"fused_attention {shape}: {got.shape}")
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            max_err["fused_attention"] = max(max_err["fused_attention"], err)
            gate = f"max_abs_err {err:.3g} (atol=rtol=1e-5)"
        else:
            torch.testing.assert_close(got, want, atol=ATTN_BF16_ATOL,
                                       rtol=ATTN_BF16_RTOL)
            g = got.float().reshape(-1, shape[-1])
            w = want.float().reshape(-1, shape[-1])
            rel = ((g - w).norm(dim=1)
                   / w.norm(dim=1).clamp_min(1e-30)).max().item()
            if rel > ATTN_BF16_ROW_REL:
                raise AssertionError(f"fused_attention {shape}: row relative "
                                     f"error {rel}")
            cos = row_cosine(torch, g, w)
            if cos <= 0.999:
                raise AssertionError(f"fused_attention {shape}: cos {cos}")
            gate = (f"max_abs_err {err:.3g} (atol {ATTN_BF16_ATOL}, "
                    f"rtol 2^-7), "
                    f"max row rel err {rel:.3g}, min row cosine {cos:.6f}")
        print(f"fused_attention {shape} {str(dtype)[6:]}"
              f"{' strided' if strided else ''}: {gate}", flush=True)


def drive_service(torch, fb, fa, net, frames, ref, per_forward, label):
    """One batch of 1, one of 3 and ``embed_batches`` over all frames at
    batch 256, with every launch counter set to 0 just before and read
    just after; held against the f32 ``off`` embeddings ``ref``."""
    reset_launches(fb, fa)
    one = net(frames[:1])
    three = net(frames[1:4])
    bulk = net.embed_batches(frames, 256)
    counts = count_launches(fb, fa)
    forwards = 1 + 1 + len(frames) // 256
    want = {k: per_forward.get(k, 0) * forwards for k in KERNELS}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want}")
    dim = net.out_size
    if one.shape != (dim,) or three.shape != (3, dim) \
            or bulk.shape != (len(frames), dim):
        raise AssertionError(f"{label}: shapes {one.shape} {three.shape} "
                             f"{bulk.shape}")
    got = torch.from_numpy(np.concatenate([one[None], three, bulk]))
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: not finite")
    cos = row_cosine(torch, got, torch.cat([ref[:4], ref]))
    if cos <= 0.99:
        raise AssertionError(f"{label}: cosine vs f32 off {cos}")
    print(f"{label}: launches {counts} over {forwards} forwards; "
          f"min cosine vs f32 off {cos:.6f}", flush=True)
    return counts


def f32_reference(torch, net, frames):
    ref = net.embed_batches(frames, 256)
    if ref.shape != (len(frames), net.out_size) or not np.isfinite(ref).all():
        raise AssertionError(f"f32 reference: {ref.shape}")
    return torch.from_numpy(ref)


def add_time(totals, kernel, count, **values):
    for key, val in values.items():
        totals[kernel][key] += count * val


def time_bottleneck_kernels(torch, F, fb, params, activations, device,
                            totals):
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
            add_time(totals, kernel, count, ms=ms, plain_ms=plain_ms,
                     library_ms=library_ms, bound_ms=bound,
                     bytes_ms=bytes_ms, flop_ms=flop_ms)
            print(f"time {kernel} {prefix} (x{count}/forward): ms {ms:.4f} "
                  f"bound {bound:.4f} "
                  f"({'bytes' if bytes_ms >= flop_ms else 'operations'}: "
                  f"{nbytes / 1e6:.1f} MB, {flop / 1e9:.1f} GFLOP) "
                  f"plain {plain_ms:.4f} library {library_ms:.4f}",
                  flush=True)


def time_attention_kernel(torch, F, fa, gen, totals):
    """Per launch at batch 256 bf16 for each MAE shape, on the strided
    qkv views the service passes; the JSON totals are per mae_base
    forward (12 launches)."""
    n = 256
    for config, h, l, d, count in ATTENTION:
        q, k, v = attention_inputs(torch, gen, (n, h, l, d), torch.bfloat16)
        ms = time_ms(torch, lambda: fa.fused_attention(q, k, v))
        plain_ms = time_ms(torch, lambda: fa.fused_attention_ref(q, k, v),
                           reps=3, warmup=1)
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v))
        nbytes, flop = attention_cost(n, h, l, d, 2)
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        flop_ms = flop / PEAK_BF16_FLOP_PER_S * 1e3
        bound = max(bytes_ms, flop_ms)
        if config == "mae_base":
            add_time(totals, "fused_attention", count, ms=ms,
                     plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound, bytes_ms=bytes_ms, flop_ms=flop_ms)
        print(f"time fused_attention {config} ({n}, {h}, {l}, {d}) "
              f"(x{count}/forward): ms {ms:.4f} bound {bound:.4f} "
              f"({'bytes' if bytes_ms >= flop_ms else 'operations'}: "
              f"{nbytes / 1e6:.1f} MB, {flop / 1e9:.1f} GFLOP) "
              f"plain {plain_ms:.4f} library (sdpa) {library_ms:.4f}",
              flush=True)


def profile_forward(torch, net, frames, label, top=8):
    """One forward under ``torch.profiler``: wall time, the device's busy
    time summed over its kernels and copies, the idle share, and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    net._forward(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        net._forward(frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    device = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    if not busy_ms:
        print(f"profile {label}: device time not measured", flush=True)
        return
    print(f"profile {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle {max(0.0, 1 - busy_ms / wall_ms):.1%}")
    for e in device[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4} "
              f"{e.key[:100]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.ops.cuda import attention as fa
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
    instances = set()
    for name in build.SIGNATURES:
        build.load(name)
        print(f"built {name} in {report[name][0]:.1f} s" if name in report
              else f"{name} was built before this run")
        for kernel, regs, stores, loads in build.ptxas_report(
                build.ptxas_output(name)):
            instances.add(kernel)
            print(f"  ptxas: {kernel}: {regs} registers, spill stores "
                  f"{stores} B, loads {loads} B")
    if not BF16_INSTANCES <= instances:
        raise AssertionError(f"ptxas reports no {BF16_INSTANCES - instances}")
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
    check_bottleneck_kernels(torch, fb, params, activations, device, max_err)
    check_attention_kernel(torch, fa, gen, max_err)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("4 slice: EmbeddingNet resnet50 bf16")
    frames = np.random.RandomState(SEED).randint(
        0, 256, size=(1024, 64, 64, 3), dtype=np.uint8)
    ref = f32_reference(torch, net32, frames)
    nets = {}
    launches = {k: 0 for k in KERNELS}
    for route, per_forward in ROUTE_LAUNCHES.items():
        net = EmbeddingNet("resnet50", pretrained=False,
                           compute_dtype=torch.bfloat16, fused=route)
        nets[route] = net
        counts = drive_service(torch, fb, fa, net, frames, ref, per_forward,
                               f"resnet50 route {route}")
        for k in KERNELS:
            launches[k] += counts[k]
    default = EmbeddingNet("resnet50", pretrained=False,
                           compute_dtype=torch.bfloat16)
    if default.fused != "v1":
        raise AssertionError(f"resnet50 default route {default.fused}")
    print(f"slice phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("5 slice: EmbeddingNet mae_base bf16")
    mae32 = EmbeddingNet("mae_base", pretrained=False,
                         compute_dtype=torch.float32, fused="off")
    mae_ref = f32_reference(torch, mae32, frames)
    del mae32
    mae = EmbeddingNet("mae_base", pretrained=False,
                       compute_dtype=torch.bfloat16)
    if mae.fused != "attention":
        raise AssertionError(f"mae_base default route {mae.fused}")
    counts = drive_service(torch, fb, fa, mae, frames, mae_ref, MAE_LAUNCHES,
                           "mae_base route attention")
    for k in KERNELS:
        launches[k] += counts[k]
    print(f"slice phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("6 times (batch 256, bf16)")
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bytes_ms": 0.0, "flop_ms": 0.0}
              for k in KERNELS}
    time_bottleneck_kernels(torch, F, fb, params, activations, device, totals)
    time_attention_kernel(torch, F, fa, gen, totals)
    n = 256
    dev_frames = torch.from_numpy(frames[:n]).to(device)
    e2e = [("resnet50", route, nets.get(route)) for route in
           ("off", "v1", "v2", "hybrid")]
    e2e += [("mae_base", "off", None), ("mae_base", "attention", mae)]
    for name, route, net in e2e:
        net = net or EmbeddingNet(name, pretrained=False,
                                  compute_dtype=torch.bfloat16, fused=route)
        ms = time_ms(torch, lambda: net._forward(dev_frames), reps=5,
                     warmup=1)
        print(f"e2e {name} {route}: {n / ms * 1e3:.1f} frames/s "
              f"({ms:.3f} ms per batch of {n}, frames on device)", flush=True)
        if route in ("off", "v1", "attention"):
            profile_forward(torch, net, dev_frames, f"{name} {route}")
    print(f"times phase {time.perf_counter() - t0:.1f} s")

    line = {"kernels": [{
        "name": k, "route": "cuda", "source": KERNELS[k][1],
        "replaces": KERNELS[k][0],
        "launches": launches[k], "max_abs_err": max_err[k],
        "ms": totals[k]["ms"], "plain_ms": totals[k]["plain_ms"],
        "bound_ms": totals[k]["bound_ms"],
        "bound_by": ("bytes" if totals[k]["bytes_ms"] >= totals[k]["flop_ms"]
                     else "operations"),
        "library_ms": totals[k]["library_ms"],
    } for k in KERNELS]}
    print("kernel times are per forward at batch 256 bf16: ResNet-50 on the "
          "route that runs the kernel on every block it can (v1: 16 "
          "launches, v2: 13), mae_base on attention (12 launches)")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
