#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py

Drives the port's paths with random seeded weights: the ResNet-50
frame-embedding service (uint8 64x64 frames ->
matmul preprocess -> BN-folded ResNet-50 -> 2048-d embedding) and the
MAE ViT embedding service (uint8 64x64 frames -> bicubic preprocess ->
patch embed -> 12 pre-LN transformer blocks -> 768-d CLS embedding), both
through ``EmbeddingNet``, the BC pipeline on ResNet-50 embeddings
(datagen -> bulk embedding -> ``main_bc_2`` -> ``main_test``, and
``main_bc_1``), the rest of the encoder zoo (the MoCo uber fusion
``moco_aug_uber_345``, CLIP ViT-B/32 and RN50, Mask R-CNN C4) and the
finetune trainer (``main_bc_finetune``), and holds every kernel of those
paths against its plain PyTorch version.
Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: nvcc compiles ``ops/cuda/csrc/*.cu`` into ``build/kernels``,
   one process per source, all started together, and prints each kernel
   instance's registers and spill bytes from ptxas; the bottleneck
   kernel's bf16 and f32 engines' v1 and v2 instances
   (``BF16_INSTANCES``, ``F32_INSTANCES``) must be among them;
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
   for attention); end-to-end frames/s for every route of both paths;
7. slice, BC trainer and online eval on ResNet-50 embeddings (f32, the
   CLIs' default, so the f32 engine of ``fused_bottleneck``): the kernel
   against its plain version at the slice's batch sizes (1, 4, 32); expert
   data of one FakeNav scene (``save_opt_trajectories``), the bulk
   embedder (``save_embedded_obs``), 5 train steps at full width (B 32,
   T 100, obs 2048) on the card against the CPU (rtol 1e-3), ``main_bc_2``
   with eval_batch 1 (wrapper envs) and 4 (the fused runner),
   ``main_test`` on its checkpoint and ``main_bc_1`` (embed at load).
   Each run is gated on 16 ``fused_bottleneck`` launches per encoder
   forward and none of ``fused_bottleneck_flat``, and on finite losses,
   the stats pickle and the checkpoint; then the training frames/s, the
   eval ms per env step at K = 1 and 4 with the encoder's share, and at
   batch 1, 4 and 32 in f32 the kernel's ms per block at the launch
   shape the wrapper chose (tile, cluster, blocks; gated on being
   ``pick_launch``'s, and at batch 1 on 32 blocks or more for
   ``SPLIT_BLOCKS``), with the cluster capped at 1 and at one block a
   tile, and a forward's sum beside its bound, its plain version and
   cuDNN f32, a whole forward on v1 against off at batch 1 and 4, and
   ``cudaOccupancyMaxActiveClusters`` for each cluster used;
8. slice, encoder zoo and finetune: ``tools/zoo_checkpoints.py`` writes
   seeded checkpoints with trained-like BN statistics in the reference's
   layouts; each encoder of ``ZOO`` loads them, and its f32 ``off`` path
   on the card is held against the CPU (8 frames, 1e-3); on its card
   default route in bf16 (``v1`` for the uber fusion, 45 launches a
   forward; ``off`` and no launch for the rest) it answers phase 4's
   requests, held against the f32 ``off`` path; the uber fusion runs in
   f32 on ``v1`` at batch 1 and 4 against ``off`` (1e-4); frames/s at
   batch 256 bf16 and a profile of the uber ``v1`` forward; then the conv
   policy on phase 7's raw data: 5 train steps at full width (B 32, T
   100, uint8 64x64x3) on the card against the CPU (rtol 1e-3),
   ``main_bc_finetune`` with eval_batch 1 and 4 (finite losses, the
   stats pickle and the checkpoint), the training frames/s and the eval
   ms per env step.

The last three lines are the card's name and power limit, one JSON
object with the kernels' numbers, and the verdict
``{"ok": true, "device": {...}}``.  Without CUDA it exits nonzero and
prints no result.
"""

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
SEED = 0
BULK_BATCH = 256               # the service's bulk batch (embed_batches)

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
# Phase 7, the BC slice: expert data of one PointNav scene, enough of it
# that sample_with_minimum_distance finds 32 starts 100 apart (n > 3101).
BC_ENV = "FakePointNav-apartment_0"
BC_TRAJECTORIES = 72           # about 3,700 samples
BC_MIN_SAMPLES = 3300
BC_STEPS = 5                   # train steps held card against CPU
BC_EPISODE_STEPS = 60          # eval episode limit
EVAL_BATCHES = (1, 4)          # lockstep eval envs the f32 times are taken at
F32_BATCHES = (1, 4, 32)       # ... and the bulk embedder's batch
# Blocks whose f32 launches at the eval batches must spread over more
# blocks than one a tile (pick_launch's cluster split).
SPLIT_BLOCKS = ("layer3.1", "layer4.0", "layer4.1")
# Phase 8, the rest of the encoder zoo: (name, the card's default route,
# kernel launches per forward on it).  An uber fusion runs three trunks:
# 13 v1 launches for moco_aug_l3, 16 for moco_aug_l4, 16 for moco_aug.
ZOO = [("moco_aug_uber_345", "v1", {"fused_bottleneck": 45}),
       ("clip_vit", "off", {}), ("clip_rn50", "off", {}),
       ("maskrcnn_l3", "off", {})]
ZOO_CPU_FRAMES = 8             # frames of the f32 forward, card vs CPU
FINETUNE_STEPS = 5             # conv-policy train steps, card vs CPU
# The bf16 and f32 engines of fused_bottleneck.cu, FLAT = false (v1) and
# true (v2).
BF16_INSTANCES = {"bottleneck_mma_kernel<0>", "bottleneck_mma_kernel<1>"}
F32_INSTANCES = {"bottleneck_kernel<ScalarEngine,0>",
                 "bottleneck_kernel<ScalarEngine,1>"}
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
    bulk = net.embed_batches(frames, BULK_BATCH)
    counts = count_launches(fb, fa)
    forwards = 1 + 1 + len(frames) // BULK_BATCH
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
    ref = net.embed_batches(frames, BULK_BATCH)
    if ref.shape != (len(frames), net.out_size) or not np.isfinite(ref).all():
        raise AssertionError(f"f32 reference: {ref.shape}")
    return torch.from_numpy(ref)


def add_time(totals, kernel, count, **values):
    for key, val in values.items():
        totals[kernel][key] += count * val


def library_block(torch, F, params, prefix, s, ds, dtype, x):
    """One bottleneck block as cuDNN ``F.conv2d`` calls on a channels_last
    view of the NHWC ``x``, with the folded weights cast once: the
    library call of the kernel's function (TF32 off in f32)."""
    def conv(name, bias):
        return (params[f"{prefix}.{name}.weight"].to(
            dtype, memory_format=torch.channels_last),
            params[f"{prefix}.{bias}.bias"].to(dtype))

    c1, c2, c3 = conv("conv1", "bn1"), conv("conv2", "bn2"), conv("conv3",
                                                                  "bn3")
    cd = conv("downsample.0", "downsample.1") if ds else None
    xc = x.permute(0, 3, 1, 2)

    def library():
        y = F.relu(F.conv2d(xc, *c1))
        y = F.relu(F.conv2d(y, *c2, s, 1))
        y = F.conv2d(y, *c3)
        return F.relu(y + (F.conv2d(xc, *cd, s) if ds else xc))

    return library


def time_bottleneck_kernels(torch, F, fb, params, activations, device,
                            totals):
    n = 256
    for prefix, h, s, cin, p, cout, ds, n_v1, n_v2 in BLOCKS:
        w = fb.block_weights(params, prefix, torch.bfloat16)
        x = activations(n, h, cin, torch.bfloat16)
        library_ms = time_ms(torch, library_block(
            torch, F, params, prefix, s, ds, torch.bfloat16, x))
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


def f32_launch_shapes(fb, lib, n, ho, s, cin, p, cout, ds, sms):
    """The f32 launch shapes (tile, cluster) of one block at batch n:
    ``pick_launch``'s with the card's cluster occupancy, its choice with
    the cluster capped at 1 (tile only), and the shape the kernel took
    before the cluster split (``pick_tile``'s tile, one block a tile)."""
    def fits(c, smem):
        return fb.max_clusters(lib, 0, False, c, smem)

    return (fb.pick_launch(ho, s, cin, p, cout, ds, 4, n, sms, fits),
            fb.pick_launch(ho, s, cin, p, cout, ds, 4, n, sms,
                           lambda c, smem: fits(c, smem) if c == 1 else 0),
            (fb.pick_tile(ho, s, cin, p, cout, ds, 4), 1))


def time_f32_eval_batches(torch, F, fb, params, activations, nets, device,
                          smi):
    """The f32 engine of fused_bottleneck at the eval batches (1 and 4
    lockstep envs, the CLIs' default dtype) and the bulk embedder's 32:
    per block its ms at the launch shape the wrapper chose (tile, cluster,
    blocks), at the choice with the cluster capped at 1 and at one block
    a tile (the shape before the cluster split), beside its plain version
    and cuDNN f32; per forward (16 launches on v1) each of them beside the
    bound (f32 outside the tensor cores); then one whole f32 forward on
    each route of ``nets`` (v1 and off) at the eval batches.  Fails if a
    launch runs at another shape than ``pick_launch`` chose, or a batch-1
    launch of ``SPLIT_BLOCKS`` with fewer than 32 blocks."""
    from pvr_habitat_tpu_torch.ops.cuda import build

    lib = build.load("fused_bottleneck")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    frames = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, 256, size=(max(EVAL_BATCHES), 64, 64, 3), dtype=np.uint8)).to(
            device)
    clusters = {}
    for n in F32_BATCHES:
        totals = {"fused_bottleneck": dict.fromkeys(
            ("ms", "tile_only_ms", "one_block_ms", "plain_ms", "library_ms",
             "bytes_ms", "flop_ms"), 0.0)}
        for prefix, h, s, cin, p, cout, ds, count, _ in BLOCKS:
            w = fb.block_weights(params, prefix, torch.float32)
            x = activations(n, h, cin, torch.float32)
            chosen, tile_only, one_block = f32_launch_shapes(
                fb, lib, n, h // s, s, cin, p, cout, ds, sms)
            ms = time_ms(torch, lambda: fb.fused_bottleneck(x, *w, stride=s))
            tile, cluster, blocks = fb.last_launch["fused_bottleneck"]
            if (tile, cluster) != chosen or (
                    prefix in SPLIT_BLOCKS and n == 1 and blocks < 32):
                raise AssertionError(
                    f"f32 {prefix} n={n}: launched tile {tile} cluster "
                    f"{cluster}, {blocks} blocks; pick_launch chose "
                    f"{chosen}")
            if cluster > 1:
                smem = fb.smem_bytes(tile, s, p, 4)
                clusters[(prefix, tile, cluster, smem)] = fb.max_clusters(
                    lib, 0, False, cluster, smem)

            def shape_ms(shape):
                return ms if shape == chosen else time_ms(
                    torch, lambda: fb._launch(x, *w, s, None, shape))

            def at(shape, shape_ms):
                return (f"ms {shape_ms:.4f} [tile {shape[0]}, "
                        f"{math.ceil(h // s / shape[0]) ** 2 * n} blocks]")

            tile_only_ms, one_block_ms = shape_ms(tile_only), shape_ms(
                one_block)
            plain_ms = time_ms(
                torch, lambda: fb.fused_bottleneck_ref(x, *w, stride=s))
            library_ms = time_ms(torch, library_block(
                torch, F, params, prefix, s, ds, torch.float32, x))
            nbytes, flop = block_cost(n, h, s, cin, p, cout, ds, 4, False)
            add_time(totals, "fused_bottleneck", count, ms=ms,
                     tile_only_ms=tile_only_ms, one_block_ms=one_block_ms,
                     plain_ms=plain_ms, library_ms=library_ms,
                     bytes_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                     flop_ms=flop / PEAK_F32_FLOP_PER_S * 1e3)
            print(f"time fused_bottleneck {prefix} f32 n={n} (x{count}/"
                  f"forward): ms {ms:.4f} [tile {tile}, cluster {cluster}, "
                  f"{blocks} blocks]; tile only: {at(tile_only, tile_only_ms)}"
                  f"; one block a tile: {at(one_block, one_block_ms)}; plain "
                  f"{plain_ms:.4f} library (cuDNN f32) {library_ms:.4f}",
                  flush=True)
        t = totals["fused_bottleneck"]
        by = "bytes" if t["bytes_ms"] >= t["flop_ms"] else "operations"
        forward = ""
        if n in EVAL_BATCHES:
            forward = "; whole forward " + ", ".join(
                f"{route} "
                f"{time_ms(torch, lambda: net._forward(frames[:n])):.4f} ms"
                for route, net in nets.items())
        print(f"f32 batch {n}, per forward: fused_bottleneck ms "
              f"{t['ms']:.4f} (16 launches; tile only "
              f"{t['tile_only_ms']:.4f}, one block a tile "
              f"{t['one_block_ms']:.4f}), bound "
              f"{max(t['bytes_ms'], t['flop_ms']):.4f} ({by}), plain "
              f"{t['plain_ms']:.4f}, library (cuDNN f32) "
              f"{t['library_ms']:.4f}{forward} [{smi}]", flush=True)
    for (prefix, tile, cluster, smem), count in sorted(clusters.items()):
        print(f"cudaOccupancyMaxActiveClusters {prefix} tile {tile} "
              f"({smem} B a block), cluster {cluster}: {count}", flush=True)


def profile_call(torch, fn, label, top=8):
    """One call of ``fn`` (after one unprofiled) under ``torch.profiler``:
    wall time, the device's busy time summed over its kernels and copies,
    the idle share, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
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


class ForwardCounter:
    """Counts encoder forwards: every ``EmbeddingNet.apply`` call is one
    (the wrapper env, the fused tick and the bulk path all go through it)."""

    def __init__(self, cls):
        self.count = 0
        original = cls.apply

        def apply(net, params, frames):
            self.count += 1
            return original(net, params, frames)

        cls.apply = apply


def train_state_to(bc_step, state, device):
    """A copy of a ``TrainState`` on ``device`` (params, BN stats and the
    optimizer state; a fresh generator, which draws no loss term)."""
    import torch

    def move(tree):
        return {k: v.to(device) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree

    opt = state.opt_state
    return bc_step.TrainState(
        move(state.params), move(state.batch_stats),
        opt._replace(square_avg=move(opt.square_avg),
                     momentum_buf=move(opt.momentum_buf)),
        torch.Generator(device=device))


class StepCounter:
    """Wraps an eval runner and counts its steps: a ``PolicyRunner`` is
    called once an env step, a ``FusedPolicyRunner`` ticked once a step of
    its K envs."""

    def __init__(self, runner):
        self.runner, self.count = runner, 0

    def initial_state(self, batch_size=1):
        return self.runner.initial_state(batch_size)

    def __call__(self, *args):
        self.count += 1
        return self.runner(*args)

    def tick(self, *args, **kwargs):
        self.count += 1
        return self.runner.tick(*args, **kwargs)


def quiet(fn, *args, **kwargs):
    """Run a trainer or tool with its progress prints kept off the output
    (its own exceptions still propagate)."""
    import contextlib
    import io
    import warnings

    with contextlib.redirect_stdout(io.StringIO()), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def check_slice_kernel_shapes(torch, fb, params, activations, max_err):
    """The f32 engine of fused_bottleneck at the batch sizes the BC slice
    gives it (1 and 4 eval envs, the bulk embedder's 32), every ResNet-50
    block shape, against the plain version at 1e-4."""
    for prefix, h, s, cin, p, cout, ds, _, _ in BLOCKS:
        w = fb.block_weights(params, prefix, torch.float32)
        for n in (1, 4, 32):
            x = activations(n, h, cin, torch.float32)
            got = fb.fused_bottleneck(x, *w, stride=s)
            torch.cuda.synchronize()
            want = fb.fused_bottleneck_ref(x, *w, stride=s)
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            err = (got - want).abs().max().item()
            max_err["fused_bottleneck"] = max(max_err["fused_bottleneck"],
                                              err)
        print(f"fused_bottleneck {prefix} float32 n=1,4,32: max_abs_err "
              f"{err:.3g} (atol=rtol=1e-4)", flush=True)


def bc_slice(torch, fb, fa, device, smi, workdir):
    """Phase 7: datagen -> bulk embedding (resnet50 f32) -> train steps on
    the card against the CPU -> main_bc_2 with eval_batch 1 and 4 ->
    main_test -> main_bc_1, with the launch counters against the encoder
    forwards in each run, then the slice's times.  Returns the launches."""
    import os
    import random
    from concurrent.futures import ThreadPoolExecutor

    from pvr_habitat_tpu_torch import main_bc_1, main_bc_2, main_test
    from pvr_habitat_tpu_torch.data import formats, sampler
    from pvr_habitat_tpu_torch.envs.environment import make_environment
    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.tools import save_embedded_obs
    from pvr_habitat_tpu_torch.tools import save_opt_trajectories
    from pvr_habitat_tpu_torch.train import bc_step, evaluate
    from pvr_habitat_tpu_torch.utils import checkpoint as ckpt
    from pvr_habitat_tpu_torch.utils.flags import default_flags

    forwards = ForwardCounter(EmbeddingNet)
    launches = {k: 0 for k in KERNELS}

    def counted(label, fn, *args):
        """Run ``fn`` with every count at 0 before it; gate its launches
        on 16 per encoder forward and none of the flat kernel."""
        reset_launches(fb, fa)
        forwards.count = 0
        start = time.perf_counter()
        out = quiet(fn, *args)
        seconds = time.perf_counter() - start
        counts = count_launches(fb, fa)
        want = {"fused_bottleneck": 16 * forwards.count,
                "fused_bottleneck_flat": 0, "fused_attention": 0}
        if counts != want or not forwards.count:
            raise AssertionError(f"{label}: launches {counts}, "
                                 f"{forwards.count} encoder forwards")
        for k in KERNELS:
            launches[k] += counts[k]
        print(f"{label}: {forwards.count} encoder forwards, launches "
              f"{counts}, {seconds:.1f} s", flush=True)
        return out

    # 1. data: expert trajectories, then the bulk embedder on the card
    flags = save_opt_trajectories.build_tool_parser().parse_args(
        ["--env", BC_ENV, "--save_path", workdir,
         "--n_trajectories", str(BC_TRAJECTORIES)])
    start = time.perf_counter()
    quiet(save_opt_trajectories.gen_data_habitat, flags)
    print(f"datagen: {BC_TRAJECTORIES} trajectories in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    flags = save_embedded_obs.build_tool_parser().parse_args(
        ["--env", BC_ENV, "--data_path", workdir, "--embedding_name",
         "resnet50", "--source", "pickle", "--disable_pretrained_embedding"])
    start = time.perf_counter()
    path = counted("bulk embedder (resnet50 f32, batch 32)",
                   save_embedded_obs.run, flags)
    seconds = time.perf_counter() - start
    data = formats.load_pickle(path)
    n = len(data["action"])
    if n < BC_MIN_SAMPLES or data["obs"].shape != (n, 2048) \
            or not np.isfinite(data["obs"]).all():
        raise AssertionError(f"embedded data: {data['obs'].shape}")
    print(f"bulk embedder: {n} samples, {n / seconds:.1f} frames/s "
          f"(tool wall time, encoder build included) [{smi}]", flush=True)

    # 2. K train steps at full width from one init and one list of starts.
    # Free-running trajectories of two devices part after step 1 (f32
    # rounding, amplified; shown below with a 1e-7 perturbation of the
    # init on the card), so each step is held card against CPU from the
    # same state: the card's, copied to the CPU before the step.
    fl = default_flags()
    b, t = fl.batch_size, fl.unroll_length
    random.seed(SEED)
    starts = [sampler.sample_with_minimum_distance(n, b, t)
              for _ in range(BC_STEPS)]
    arrays = dict(obs=data["obs"].astype(np.float32),
                  action=data["action"].astype(np.int64),
                  done=data["done"].astype(bool))
    cpu = torch.device("cpu")
    tensors, cpu_tensors = (sampler.to_tensors(arrays, dev)
                            for dev in (device, cpu))

    def fresh(noise=0.0):
        state, opt = bc_step.create_train_state(
            np.random.RandomState(SEED), (2048,), 3, fl, max_epochs=100,
            device=device)
        if noise:
            gen = torch.Generator(device=device).manual_seed(SEED)
            state = state._replace(params={
                k: v * (1 + noise * torch.randn(v.shape, device=device,
                                                generator=gen))
                for k, v in state.params.items()})
        return state, bc_step.make_train_step(opt)

    def run_steps(state, step, snapshots=None):
        """The card's metrics per step; with a list ``snapshots``, a CPU
        copy of the card's state before each step is appended to it."""
        card = []
        for row in starts:
            if snapshots is not None:
                snapshots.append(train_state_to(bc_step, state, cpu))
            state, m = step(state, sampler.gather_unrolls(tensors, row, t))
            card.append([m["loss"].item(), m["gradient_norm"].item()])
        return state, np.asarray(card)

    def cpu_steps(step, snapshots, threads):
        """The same steps on the CPU, each from the card's state before
        it.  Runs in a worker thread beside the trainer runs of part 3,
        which keep two host cores."""
        torch.set_num_threads(threads)
        start = time.perf_counter()
        out = []
        for state, row in zip(snapshots, starts):
            _, m = step(state, sampler.gather_unrolls(cpu_tensors, row, t))
            out.append([m["loss"].item(), m["gradient_norm"].item()])
        return np.asarray(out), time.perf_counter() - start

    state, step = fresh()
    snapshots = []
    state, card = run_steps(state, step, snapshots)
    if not np.isfinite(card).all():
        raise AssertionError(f"train steps: {card}")
    _, perturbed = run_steps(*fresh(noise=1e-7))
    drift = np.abs(perturbed / card - 1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for row in starts * 2:
        state, m = step(state, sampler.gather_unrolls(tensors, row, t))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    print(f"training: {b * t * 2 * BC_STEPS / seconds:.1f} frames/s "
          f"({seconds / (2 * BC_STEPS) * 1e3:.2f} ms a step of B {b} x T "
          f"{t}, eval excluded) [{smi}]", flush=True)
    profile_call(torch, lambda: step(
        state, sampler.gather_unrolls(tensors, starts[0], t)), "train step")

    # 3. the trainer (main_bc_2) with eval_batch 1 and 4, main_test,
    # main_bc_1 (embed at load); their seconds include the CPU steps'
    # contention for the host
    def bc_flags(save, **kw):
        return default_flags(**{**dict(
            env=BC_ENV, to_env=BC_ENV, embedding_name="resnet50",
            data_path=workdir, save_path=os.path.join(workdir, save),
            max_frames=b * t * 4, eval_frequency=2, n_episodes_test=2,
            max_episode_steps=BC_EPISODE_STEPS), **kw})

    def trainers():
        """Runs the CLIs' entry points; returns main_bc_2's checkpoint."""
        stem = f"{BC_ENV}_emresnet50_s1_{BC_ENV}"
        for k in (1, 4):
            save = f"bc_k{k}"
            stats = counted(f"main_bc_2 eval_batch {k}", main_bc_2.run,
                            bc_flags(save, eval_batch=k))[BC_ENV]
            losses = stats["training_loss"][1:]
            if len(losses) != 2 or not np.isfinite(losses).all() or not all(
                    os.path.isfile(os.path.join(workdir, save, stem + ext))
                    for ext in (".pickle", ".tar")):
                raise AssertionError(f"main_bc_2 eval_batch {k}: {stats}")
            print(f"main_bc_2 eval_batch {k}: frames {stats['frames']}, "
                  f"losses {losses}, returns {stats['episode_return']}",
                  flush=True)
        checkpoint = os.path.join(workdir, "bc_k1", stem + ".tar")
        flags = main_test.parser.parse_args(
            ["--checkpoint", checkpoint, "--env", BC_ENV, "--from_env",
             BC_ENV, "--embedding_name", "resnet50", "--data_path", workdir,
             "--disable_pretrained_embedding", "--n_episodes_test", "2",
             "--max_episode_steps", str(BC_EPISODE_STEPS)])
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            stats = counted("main_test", main_test.run, flags)
        finally:
            os.chdir(cwd)
        if len(stats["episode_step"]) != 2:
            raise AssertionError(f"main_test: {stats}")
        print(f"main_test: {stats}", flush=True)
        stats = counted("main_bc_1 (embed at load)", main_bc_1.run, bc_flags(
            "bc1", max_frames=b * t * 2, debug=True))[BC_ENV]
        if len(stats["training_loss"]) != 2 or \
                not np.isfinite(stats["training_loss"][1]):
            raise AssertionError(f"main_bc_1: {stats}")
        print(f"main_bc_1: frames {stats['frames']}, losses "
              f"{stats['training_loss'][1:]}", flush=True)
        return checkpoint

    threads = torch.get_num_threads()
    with ThreadPoolExecutor(1) as pool:
        reference = pool.submit(cpu_steps, step, snapshots,
                                max(1, threads - 2))
        checkpoint = trainers()
        on_cpu, cpu_seconds = reference.result()
    torch.set_num_threads(threads)
    np.testing.assert_allclose(card, on_cpu, rtol=1e-3)
    rel = np.abs(card / on_cpu - 1).max(axis=0)
    print(f"train steps (B {b}, T {t}, obs 2048) x{BC_STEPS}, each from the "
          f"same state, card vs CPU: losses {card[:, 0].round(6).tolist()}, "
          f"gradient norms {card[:, 1].round(4).tolist()}, max rel err loss "
          f"{rel[0]:.3g}, gradient norm {rel[1]:.3g} (rtol 1e-3); the CPU's "
          f"steps took {cpu_seconds:.1f} s on {max(1, threads - 2)} threads; "
          f"free-running on the card from an init perturbed by 1e-7: rel "
          f"change of the gradient norm per step "
          f"{[float(f'{x:.3g}') for x in drift[:, 1]]}", flush=True)

    # 4. eval times on the trained policy: ms per env step, and the share
    # the encoder takes at the same batch
    payload = ckpt.load_checkpoint(checkpoint)
    params, _ = ckpt.split_actor_state(payload["actor_model_state_dict"],
                                       device)
    policy = evaluate.PolicyRunner(params)
    start = time.perf_counter()
    net = EmbeddingNet("resnet50", pretrained=False)
    print(f"EmbeddingNet('resnet50') built in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    env_flags = default_flags(env=BC_ENV, embedding_name="resnet50",
                              max_episode_steps=BC_EPISODE_STEPS)
    keys = ["episode_return"]
    frames = np.random.RandomState(SEED).randint(
        0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    for k in (1, 4):
        if k == 1:
            runner = StepCounter(policy)
            env = quiet(make_environment, env_flags, net)

            def run_eval():
                return evaluate.test(runner, env, keys, 1)
        else:
            runner = StepCounter(evaluate.FusedPolicyRunner(policy, net))
            envs = [quiet(make_environment, env_flags, None, actor_id=i)
                    for i in range(1, k + 1)]

            def run_eval():
                return evaluate.batched_test_fused(runner, envs, keys, k)
        run_eval()                      # warm-up
        runner.count = 0
        start = time.perf_counter()
        run_eval()
        step_ms = (time.perf_counter() - start) / runner.count * 1e3
        encoder = []
        for _ in range(20):
            start = time.perf_counter()
            net(frames[:k])
            encoder.append((time.perf_counter() - start) * 1e3)
        enc_ms = statistics.median(encoder)
        if k == 1:
            env_output = env.initial()
            core = policy.initial_state(1)

            def one_step():
                out, _ = policy(env_output, core)
                env.step(out["action"])

            profile_call(torch, one_step, "eval step K=1")
        print(f"eval K={k}: {step_ms:.3f} ms per env step over "
              f"{runner.count} steps; encoder (resnet50 f32, batch {k}, "
              f"upload and download included) {enc_ms:.3f} ms, "
              f"{enc_ms / step_ms:.1%} of a step [{smi}]", flush=True)
    return launches


def load_net(EmbeddingNet, name, checkpoint_dir, **kwargs):
    """``EmbeddingNet(name)`` through the pretrained path from
    ``checkpoint_dir``; a missing file (which would warn and fall back to
    the seeded init) fails."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return EmbeddingNet(name, checkpoint_dir=checkpoint_dir, **kwargs)


def zoo_slice(torch, fb, fa, frames, device, smi, workdir):
    """Phase 8a and 8b: each zoo encoder at full width on its card default
    route (bf16) answers a batch of 1, a batch of 3 and the bulk path,
    held against its f32 ``off`` path, which is held against the CPU;
    the uber fusion also in f32 on v1 at the eval batches; then frames/s
    at batch 256 bf16.  Returns the launches."""
    import os

    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.tools import zoo_checkpoints

    ckpt_dir = os.path.join(workdir, "zoo")
    os.makedirs(ckpt_dir)
    start = time.perf_counter()
    for name, _, _ in ZOO:
        zoo_checkpoints.write(name, ckpt_dir, SEED)
    print(f"zoo checkpoints (seeded, trained-like BN) written in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    launches = {k: 0 for k in KERNELS}
    dev_frames = torch.from_numpy(frames[:BULK_BATCH]).to(device)
    for name, route, per_forward in ZOO:
        start = time.perf_counter()
        net32 = load_net(EmbeddingNet, name, ckpt_dir, fused="off")
        ref = f32_reference(torch, net32, frames)
        cpu = load_net(EmbeddingNet, name, ckpt_dir, device="cpu")
        want = cpu(frames[:ZOO_CPU_FRAMES])
        np.testing.assert_allclose(ref[:ZOO_CPU_FRAMES].numpy(), want,
                                   atol=1e-3, rtol=1e-3)
        err = np.abs(ref[:ZOO_CPU_FRAMES].numpy() - want).max()
        print(f"{name} f32 off, card vs CPU ({ZOO_CPU_FRAMES} frames): "
              f"max_abs_err {err:.3g} (atol=rtol=1e-3)", flush=True)
        del cpu
        net = load_net(EmbeddingNet, name, ckpt_dir,
                       compute_dtype=torch.bfloat16)
        if net.fused != route:
            raise AssertionError(f"{name} default route {net.fused}")
        counts = drive_service(torch, fb, fa, net, frames, ref, per_forward,
                               f"{name} route {route}")
        for k in KERNELS:
            launches[k] += counts[k]
        nets = {route: net}
        if route != "off":
            # f32 on the kernel route at the eval batches, against off
            v1 = load_net(EmbeddingNet, name, ckpt_dir, fused=route)
            reset_launches(fb, fa)
            for n in EVAL_BATCHES:
                got, want = v1(frames[:n]), net32(frames[:n])
                np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
                print(f"{name} f32 {route} vs off, batch {n}: max_abs_err "
                      f"{np.abs(got - want).max():.3g} (atol=rtol=1e-4)",
                      flush=True)
            counts = count_launches(fb, fa)
            want = {k: per_forward.get(k, 0) * len(EVAL_BATCHES)
                    for k in KERNELS}
            if counts != want:
                raise AssertionError(f"{name} f32 {route}: launches {counts}")
            for k in KERNELS:
                launches[k] += counts[k]
            del v1
            nets["off"] = load_net(EmbeddingNet, name, ckpt_dir,
                                   compute_dtype=torch.bfloat16, fused="off")
        del net32
        for r, m in nets.items():
            ms = time_ms(torch, lambda: m._forward(dev_frames), reps=5,
                         warmup=1)
            print(f"e2e {name} {r}: {BULK_BATCH / ms * 1e3:.1f} frames/s "
                  f"({ms:.3f} ms per batch of {BULK_BATCH} bf16, frames on "
                  f"device) [{smi}]",
                  flush=True)
        if route != "off":
            profile_call(torch, lambda: net._forward(dev_frames),
                         f"{name} {route}")
        print(f"{name}: {time.perf_counter() - start:.1f} s", flush=True)
    return launches


def finetune_slice(torch, fb, fa, device, smi, workdir):
    """Phase 8c: the conv policy on phase 7's raw pickle: train steps at
    full width on the card against the CPU from the same state (in a
    worker thread beside the trainer runs), ``main_bc_finetune`` with
    eval_batch 1 and 4, the training frames/s and the eval ms per env
    step.  Nothing here reaches a kernel; returns the (zero) launches."""
    import os
    import random
    from concurrent.futures import ThreadPoolExecutor

    from pvr_habitat_tpu_torch import main_bc_finetune
    from pvr_habitat_tpu_torch.data import formats, sampler
    from pvr_habitat_tpu_torch.envs.environment import make_environment
    from pvr_habitat_tpu_torch.train import bc_step, evaluate
    from pvr_habitat_tpu_torch.utils import checkpoint as ckpt
    from pvr_habitat_tpu_torch.utils.flags import default_flags

    data = formats.read_habitat_data(formats.raw_path(workdir, BC_ENV),
                                     verbose=False)
    n = len(data["action"])
    fl = default_flags()
    b, t = fl.batch_size, fl.unroll_length
    random.seed(SEED)
    starts = [sampler.sample_with_minimum_distance(n, b, t)
              for _ in range(FINETUNE_STEPS)]
    arrays = dict(obs=data["obs"], action=data["action"].astype(np.int64),
                  done=data["done"].astype(bool))
    cpu = torch.device("cpu")
    tensors, cpu_tensors = (sampler.to_tensors(arrays, dev)
                            for dev in (device, cpu))
    if tensors["obs"].dtype != torch.uint8:
        raise AssertionError(f"frames {tensors['obs'].dtype}")
    state, opt = bc_step.create_train_state(
        np.random.RandomState(SEED), data["obs"].shape[1:], 3, fl,
        conv_policy=True, max_epochs=100, device=device)
    step = bc_step.make_train_step(opt, conv_policy=True)
    snapshots, card = [], []
    for row in starts:
        snapshots.append(train_state_to(bc_step, state, cpu))
        state, m = step(state, sampler.gather_unrolls(tensors, row, t))
        card.append([m["loss"].item(), m["gradient_norm"].item()])
    card = np.asarray(card)
    if not np.isfinite(card).all():
        raise AssertionError(f"finetune steps: {card}")
    torch.cuda.synchronize()
    start = time.perf_counter()
    for row in starts * 2:
        state, m = step(state, sampler.gather_unrolls(tensors, row, t))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    print(f"finetune training: {b * t * 2 * FINETUNE_STEPS / seconds:.1f} "
          f"frames/s ({seconds / (2 * FINETUNE_STEPS) * 1e3:.2f} ms a step "
          f"of B {b} x T {t} uint8 64x64x3, eval excluded) [{smi}]",
          flush=True)
    profile_call(torch, lambda: step(
        state, sampler.gather_unrolls(tensors, starts[0], t)),
        "finetune train step")

    def cpu_steps(threads):
        torch.set_num_threads(threads)
        out = []
        for snapshot, row in zip(snapshots, starts):
            _, m = step(snapshot, sampler.gather_unrolls(cpu_tensors, row, t))
            out.append([m["loss"].item(), m["gradient_norm"].item()])
        return np.asarray(out)

    stem = f"{BC_ENV}_emrandom_finetuned_s1_{BC_ENV}"

    def trainers():
        for k in EVAL_BATCHES:
            save = os.path.join(workdir, f"finetune_k{k}")
            flags = default_flags(
                env=BC_ENV, to_env=BC_ENV, data_path=workdir, save_path=save,
                max_frames=b * t * 4, eval_frequency=2, n_episodes_test=2,
                max_episode_steps=BC_EPISODE_STEPS, eval_batch=k)
            reset_launches(fb, fa)
            start = time.perf_counter()
            stats = quiet(main_bc_finetune.run, flags)[BC_ENV]
            seconds = time.perf_counter() - start
            counts = count_launches(fb, fa)
            losses = stats["training_loss"][1:]
            if any(counts.values()) or len(losses) != 2 \
                    or not np.isfinite(losses).all() \
                    or sorted(os.listdir(save)) != [stem + ".pickle",
                                                    stem + ".tar"]:
                raise AssertionError(f"main_bc_finetune eval_batch {k}: "
                                     f"{stats}, launches {counts}")
            print(f"main_bc_finetune eval_batch {k}: frames "
                  f"{stats['frames']}, losses {losses}, returns "
                  f"{stats['episode_return']}, launches {counts}, "
                  f"{seconds:.1f} s", flush=True)
        return os.path.join(workdir, "finetune_k1", stem + ".tar")

    threads = torch.get_num_threads()
    with ThreadPoolExecutor(1) as pool:
        reference = pool.submit(cpu_steps, max(1, threads - 2))
        checkpoint = trainers()
        on_cpu = reference.result()
    torch.set_num_threads(threads)
    np.testing.assert_allclose(card, on_cpu, rtol=1e-3)
    rel = np.abs(card / on_cpu - 1).max(axis=0)
    print(f"finetune steps (B {b}, T {t}) x{FINETUNE_STEPS}, each from the "
          f"same state, card vs CPU: losses {card[:, 0].round(6).tolist()}, "
          f"max rel err loss {rel[0]:.3g}, gradient norm {rel[1]:.3g} "
          f"(rtol 1e-3)", flush=True)

    payload = ckpt.load_checkpoint(checkpoint)
    if "embedding_model_state_dict" in payload:
        raise AssertionError("finetune checkpoint holds an encoder")
    params, stats = ckpt.split_actor_state(payload["actor_model_state_dict"],
                                           device)
    runner = StepCounter(evaluate.PolicyRunner(params, stats,
                                               conv_policy=True))
    env_flags = default_flags(env=BC_ENV, max_episode_steps=BC_EPISODE_STEPS)
    keys = ["episode_return"]
    for k in EVAL_BATCHES:
        envs = [quiet(make_environment, env_flags, None, actor_id=i)
                for i in range(1, k + 1)]

        def run_eval():
            if k == 1:
                return evaluate.test(runner, envs[0], keys, 1)
            return evaluate.batched_test(runner, envs, keys, k)
        run_eval()                      # warm-up
        runner.count = 0
        start = time.perf_counter()
        run_eval()
        step_ms = (time.perf_counter() - start) / runner.count * 1e3
        print(f"finetune eval K={k}: {step_ms:.3f} ms per step of the K "
              f"envs over {runner.count} steps (conv policy on raw frames) "
              f"[{smi}]",
              flush=True)
    return {k: 0 for k in KERNELS}


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
    if not BF16_INSTANCES | F32_INSTANCES <= instances:
        raise AssertionError("ptxas reports no "
                             f"{(BF16_INSTANCES | F32_INSTANCES) - instances}")
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
            profile_call(torch, lambda: net._forward(dev_frames),
                         f"{name} {route}")
    print(f"times phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("7 slice: BC trainer and online eval (resnet50)")
    check_slice_kernel_shapes(torch, fb, params, activations, max_err)
    print(f"f32 kernel checks {time.perf_counter() - t0:.1f} s", flush=True)
    workdir = tempfile.TemporaryDirectory()
    counts = bc_slice(torch, fb, fa, device, smi, workdir.name)
    for k in KERNELS:
        launches[k] += counts[k]
    start = time.perf_counter()
    v1_32 = EmbeddingNet("resnet50", pretrained=False,
                         compute_dtype=torch.float32, fused="v1")
    time_f32_eval_batches(torch, F, fb, params, activations,
                          {"v1": v1_32, "off": net32}, device, smi)
    print(f"f32 eval-batch times {time.perf_counter() - start:.1f} s")
    print(f"slice phase {time.perf_counter() - t0:.1f} s")
    del v1_32, nets, default, mae

    t0 = phase("8 slice: encoder zoo (bf16) and finetune")
    with workdir:
        for part in (
                lambda: zoo_slice(torch, fb, fa, frames, device, smi,
                                  workdir.name),
                lambda: finetune_slice(torch, fb, fa, device, smi,
                                       workdir.name)):
            counts = part()
            for k in KERNELS:
                launches[k] += counts[k]
    print(f"slice phase {time.perf_counter() - t0:.1f} s")

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
