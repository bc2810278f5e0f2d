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
finetune trainer (``main_bc_finetune``), int8 serving through the bulk
embedder (``ShardedEmbedder``, ``save_embedded_obs --quantize_embed`` and
``--sharded_embed``), the embedding server, the PNG data path and two
ranks over ``torch.distributed``, and holds every kernel of those paths
against its plain PyTorch version.
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
   ms per env step;
9. slice, int8 serving and the bulk embedder: ``ops/quantize.matmul_int32``
   (``torch._int_mm``, zero-padded) against the CPU's int32 product,
   exactly, and its time beside bf16's at the serving shapes; for each
   encoder of ``INT8`` (resnet50 and mae_base seeded, clip_rn50 and
   maskrcnn_l3 from phase 8's checkpoints)
   ``ShardedEmbedder(quantize=True).embed_all`` over phase 4's frames at
   batch 256, gated on per-row cosine against the f32 ``off`` path and on
   its launches (12 ``fused_attention`` a mae_base forward, calibration
   included); the int8 forward on the card against the CPU on the same
   inputs and scales (cosine > 0.9999); int8 frames/s beside the bf16
   default route's; a profile of the resnet50 int8 forward split into
   im2col copies, ``_int_mm``, quantize and dequant, and the top kernels
   of the mae_base one; then
   ``save_embedded_obs`` on phase 7's raw pickle with ``--sharded_embed``
   (f32 on v1, 16 launches a forward, 1e-3 against phase 7's pickle) and
   ``--quantize_embed`` (cosine > 0.99);
10. slice, serving and scale-out: (a) an ``EmbeddingServer``
   (``tools/serve_embeddings.py``) in this process serves resnet50 bf16
   and f32 and mae_base bf16 on their card default routes to 4
   concurrent clients of 50 requests of 1-8 frames; launches gated per
   micro-batch (16 ``fused_bottleneck``, 12 ``fused_attention``), every
   reply held against a direct ``EmbeddingNet`` call (f32, 1e-3) or the
   f32 off path (bf16, cosine > 0.99); round-trip p50/p99, the
   micro-batch sizes, frames/s and the f32 launch-shape search's time;
   (b) PNG datagen of phase 7's trajectories, decoded bit for bit equal
   to phase 7's frames, and ``save_embedded_obs`` with its default
   ``--source png`` (resnet50 f32, 16 launches a trajectory) against
   ``embed_batches`` at 1e-3, with the codec that ran and decode frames/s;
   then its read-and-embed loop alone on a built encoder, with and without
   the decode prefetch: embed frames/s and the share outside the
   encoder's forwards; (c) two
   ranks on the one card over gloo (``parallel/dryrun.py``):
   ``embed_local`` against one process
   (1e-3) and 5 data-parallel train steps at full width with BatchNorm,
   the ranks bitwise equal and each step against one process from the
   same state (rtol 1e-3); then the dry run as one rank over NCCL;
11. slice, sweep, checkpoint conversion, tensor parallelism: (a)
   ``tools/zoo_checkpoints.py`` writes reference-layout ``moco_aug`` and
   ``mae_base`` files, ``tools/convert_checkpoint.py`` converts them on
   the card, and ``EmbeddingNet(compute_dtype=bf16)`` from the converted
   file answers as the one from the original (pretrained path), equal,
   with 16 ``fused_bottleneck`` / 12 ``fused_attention`` launches a
   forward; (b) ``tools/sweep.py`` over one FakeImageNav scene
   (``SWEEP_GRID``): the embedding sweep, resnet50 (``main_bc_2``) and
   random (``main_bc_1``) BC jobs and a finetune job through the local
   executor, each job's launches gated (16 a resnet50 forward), a
   second seed through ``SubprocessExecutor``, every stats pickle and
   checkpoint with finite losses, and a second call of each sweep
   submitting nothing; (c) ``main_bc_2 --mesh_shape 1,2`` on two ranks
   on the card over gloo at full width with BatchNorm, against one
   process: losses and pre-clip norms (rtol 1e-4), the checkpoints'
   keys, shapes and params (1e-4); then each tensor-parallel step from
   the same state as one process (rtol 1e-4), ms a step beside one
   process, and the all-gathers' and the sharded inputs' all-reduces'
   share of it.  The habitat and gym adapters are not installed there:
   it says so, and the CPU tests hold them on stubs.

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
# Phase 9, int8 serving through the bulk embedder: (name, the int8 path's
# card default route, kernel launches per forward on it, cosine gate
# against the f32 off path: the JAX package's, tests/test_quantize.py).
INT8 = [("resnet50", "off", {}, 0.99),
        ("clip_rn50", "off", {}, 0.98),
        ("maskrcnn_l3", "off", {}, 0.98),
        ("mae_base", "attention", {"fused_attention": 12}, 0.98)]
INT8_CPU_FRAMES = 8            # frames of the int8 forward, card vs CPU
# the whole int8 MAE forward, card vs CPU (its blocks are held at 0.9999
# one by one; phase 9 prints the same forward on the "off" route, no
# kernel, card vs CPU, beside it)
MAE_WHOLE_GATE = 0.999
# launches per forward of the CLI's resnet50 runs: --sharded_embed runs
# f32 on v1, --quantize_embed int8 with no kernel
CLI_LAUNCHES = {"--sharded_embed": {"fused_bottleneck": 16},
                "--quantize_embed": {}}
# (M, K, N) of the int8 product: below cuBLAS's M > 16, K and N off a
# multiple of 8 (the stems' K, the compress graft's N = 11); then at a
# batch of 256 ResNet-50's stem, a layer1 3x3 and 1x1, layer4's 3x3 and
# mae_base's qkv
INT_MM_SHAPES = [(8, 147, 11), (17, 27, 32), (100, 99, 11),
                 (3211264, 152, 64), (802816, 576, 64), (802816, 64, 256),
                 (12544, 4608, 512), (50432, 768, 2304)]
# The bf16 and f32 engines of fused_bottleneck.cu, FLAT = false (v1) and
# true (v2).
BF16_INSTANCES = {"bottleneck_mma_kernel<0>", "bottleneck_mma_kernel<1>"}
F32_INSTANCES = {"bottleneck_kernel<ScalarEngine,0>",
                 "bottleneck_kernel<ScalarEngine,1>"}
# Phase 10, serving and scale-out.  The server: (encoder, compute dtype,
# launches per micro-batch on its card default route), its clients and
# their requests of 1 to SERVE_MAX_FRAMES frames, the server's defaults.
SERVE = [("resnet50", "bfloat16", {"fused_bottleneck": 16}),
         ("resnet50", "float32", {"fused_bottleneck": 16}),
         ("mae_base", "bfloat16", {"fused_attention": 12})]
SERVE_CLIENTS = 4
SERVE_REQUESTS = 50
SERVE_MAX_FRAMES = 8
SERVE_MAX_BATCH = 64
SERVE_WINDOW_MS = 2.0
PNG_TRAJECTORIES = BC_TRAJECTORIES   # PNG datagen of phase 7's data
RANKS = 2                      # processes on the one card, over gloo
RANK_EMBED_FRAMES = 256        # frames embed_local splits over the ranks
# Phase 11, the sweep, checkpoint conversion and tensor parallelism.
# Conversion: (zoo name, launches a forward of its bf16 card default route).
CONVERT = [("moco_aug", {"fused_bottleneck": 16}),
           ("mae_base", {"fused_attention": 12})]
CONVERT_FRAMES = 8
# The sweep's one-scene grid (cut: 2 epochs of B 8 x T 20, one eval
# episode of <= 30 steps a point; the default grid's 35 x 5 x 10 jobs
# run B 16 x T 100 for up to 2e8 frames).
SWEEP_ENV = "FakeImageNav-apartment_0"
SWEEP_TRAJECTORIES = 12
SWEEP_EPOCHS = 2
SWEEP_GRID = dict(batch_size=[8], unroll_length=[20], eval_frequency=[1],
                  n_episodes_test=[1], max_episode_steps=[30])
TP_STEPS = 5                   # tensor-parallel steps held against one process
TP_EPISODE_STEPS = 20          # their eval episodes' limit
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
    """Counts encoder forwards while it is open (a ``with`` block): every
    ``EmbeddingNet.apply`` call is one (the wrapper env, the fused tick and
    the bulk path all go through it).  With ``timed``, each forward also
    gets a pair of CUDA events, so that the encoder's device time in a run
    can be set beside the run's wall time.  ``apply`` is restored on
    exit."""

    def __init__(self, torch, cls, timed=False):
        self.torch, self.cls, self.original = torch, cls, cls.apply
        self.count, self.events = 0, []

        def apply(net, params, frames):
            self.count += 1
            if not timed:
                return self.original(net, params, frames)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.original(net, params, frames)
            end.record()
            self.events.append((start, end))
            return out

        cls.apply = apply

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cls.apply = self.original

    def device_ms(self):
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


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

    launches = {k: 0 for k in KERNELS}

    def counted(label, fn, *args):
        """Run ``fn`` with every count at 0 before it; gate its launches
        on 16 per encoder forward and none of the flat kernel."""
        reset_launches(fb, fa)
        start = time.perf_counter()
        with ForwardCounter(torch, EmbeddingNet) as forwards:
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


def load_net(cls, name, checkpoint_dir, **kwargs):
    """``cls(name)`` (``EmbeddingNet``, ``ShardedEmbedder``) with
    ``checkpoint_dir``; a checkpoint asked for and missing (which would
    warn and fall back to the seeded init) fails."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return cls(name, checkpoint_dir=checkpoint_dir, **kwargs)


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


def check_int_mm(torch, qz, device, smi):
    """``ops/quantize.matmul_int32`` on the card (``torch._int_mm`` with
    its zero-padding and the weight passed transposed) against the int32
    product on the CPU, exactly; at the serving shapes (M > 1000) its time
    beside a bf16 product of the same shape."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    for m, k, n in INT_MM_SHAPES:
        a_dev, w_dev = (torch.randint(-127, 128, shape, generator=gen,
                                      device=device, dtype=torch.int8)
                        for shape in ((m, k), (n, k)))
        got = qz.matmul_int32(a_dev, w_dev)
        rows = min(m, 2048)           # the CPU's int32 product is slow
        want = a_dev[:rows].cpu().int() @ w_dev.cpu().int().t()
        if got.dtype != torch.int32 or got.shape != (m, n) \
                or not torch.equal(got[:rows].cpu(), want):
            raise AssertionError(f"matmul_int32 {(m, k, n)} differs")
        if m > 1000:
            ab, wb = a_dev.bfloat16(), w_dev.bfloat16()
            ms = time_ms(torch, lambda: qz.matmul_int32(a_dev, w_dev))
            ms_bf16 = time_ms(torch, lambda: ab @ wb.t())
            print(f"matmul_int32 {(m, k, n)}: {ms:.4f} ms "
                  f"({2 * m * k * n / ms / 1e9:.0f} TOP/s), bf16 product "
                  f"{ms_bf16:.4f} ms ({2 * m * k * n / ms_bf16 / 1e9:.0f} "
                  f"TFLOP/s) [{smi}]", flush=True)
    print(f"matmul_int32 (torch._int_mm, padded) equals the CPU's int32 "
          f"product at (M, K, N) {INT_MM_SHAPES}", flush=True)


def int8_profile(torch, fn, label):
    """One call of ``fn`` under ``torch.profiler``: the device time of the
    int8 path's parts, summed from each op's own kernels, and the idle
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    groups = {"im2col, casts and padding copies": ("aten::copy_",
                                                   "aten::fill_",
                                                   "aten::zero_"),
              "_int_mm": ("aten::_int_mm",),
              "quantize (x*inv, round, clamp)": ("aten::mul", "aten::round_",
                                                 "aten::clamp_"),
              "dequant (addcmul)": ("aten::addcmul",)}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    if not busy_ms:
        print(f"profile {label}: device time not measured", flush=True)
        return
    parts = {g: sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CPU and e.key in ops) / 1e3
             for g, ops in groups.items()}
    rest = busy_ms - sum(parts.values())
    print(f"profile {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle {max(0.0, 1 - busy_ms / wall_ms):.1%}; "
          + "; ".join(f"{g} {ms:.3f} ms" for g, ms in parts.items())
          + f"; the rest {rest:.3f} ms", flush=True)


def int8_card_vs_cpu(torch, emb, frames, name):
    """The int8 forward on the card against the CPU from the same bf16
    inputs and calibrated scales, per-row cosine > 0.9999.  An MAE is held
    block by block, each block fed the CPU's input of that block (per-token
    cosine > 0.9999), and as a whole at > MAE_WHOLE_GATE: its attention
    cores and LayerNorms sum in another order on the card (the kernel, or
    its plain version there, differs from the CPU's plain version in about
    one output in 10^4 by one bf16 ulp), and twelve blocks of int8
    quantization spread such differences over the image."""
    from pvr_habitat_tpu_torch.models import vit
    from pvr_habitat_tpu_torch.ops import quantize as qz

    device = frames.device
    x = emb.handle.preprocess(frames, out_dtype=torch.bfloat16).cpu()
    params_cpu = {k: v.cpu() for k, v in emb.params.items()}
    blocks = []
    block_q = vit._timm_block_q
    if name in vit.MAE_CONFIGS:
        def spy(qs, y, p, prefix, num_heads, fused="off"):
            out = block_q(qs, y, p, prefix, num_heads, fused=fused)
            blocks.append((prefix, num_heads, y, out))
            return out
        vit._timm_block_q = spy
    try:
        on_cpu, _ = emb._int8.apply(params_cpu, x, emb._scales,
                                    fused=emb.fused)
    finally:
        vit._timm_block_q = block_q
    on_card, _ = emb._int8.apply(emb.params, x.to(device), emb._scales,
                                 fused=emb.fused)
    cos = row_cosine(torch, on_card.cpu(), on_cpu)
    err = (on_card.cpu().float() - on_cpu.float()).abs().max().item()
    worst = 1.0
    for prefix, num_heads, y, want in blocks:
        got = block_q(qz.QuantState(emb._scales), y.to(device),
                      emb.params, prefix, num_heads, fused=emb.fused)
        d = want.shape[-1]
        worst = min(worst, row_cosine(torch, got.cpu().reshape(-1, d),
                                      want.reshape(-1, d)))
    gate = MAE_WHOLE_GATE if blocks else 0.9999
    if cos <= gate or worst <= 0.9999:
        raise AssertionError(f"{name} int8 card vs CPU: cosine {cos}, "
                             f"worst block {worst}")
    plain = ""
    if blocks:
        # the reading behind MAE_WHOLE_GATE: the same forward on the
        # "off" route (the int8 block's einsum core, no kernel), card vs
        # CPU; reported, not gated
        off_cpu, _ = emb._int8.apply(params_cpu, x, emb._scales, fused="off")
        off_card, _ = emb._int8.apply(emb.params, x.to(device), emb._scales,
                                      fused="off")
        plain = (f"; route off (no kernel), card vs CPU: min cosine "
                 f"{row_cosine(torch, off_card.cpu(), off_cpu):.7f}")
    print(f"{name} int8, card vs CPU ({len(x)} frames, the same scales): "
          f"min cosine {cos:.7f} (gate {gate}), max_abs_err {err:.3g}"
          + (f"; {len(blocks)} blocks each from the CPU's input: min "
             f"per-token cosine {worst:.7f} (gate 0.9999)" if blocks else "")
          + plain, flush=True)


def int8_slice(torch, fb, fa, frames, refs, device, smi, workdir):
    """Phase 9: each encoder of ``INT8`` through
    ``ShardedEmbedder(quantize=True)``: its int8 forward on the card
    against the CPU on the same inputs and scales, ``embed_all`` over the
    frames at batch 256 (launches counted, calibration included) against
    the f32 off path, int8 frames/s beside the bf16 default route's, and a
    profile of the resnet50 int8 forward; then the CLI with
    ``--sharded_embed`` and ``--quantize_embed`` on phase 7's raw pickle
    against its embedded pickle.  Returns the launches."""
    import math
    import os
    import shutil

    from pvr_habitat_tpu_torch.data import formats
    from pvr_habitat_tpu_torch.data.embed_pipeline import ShardedEmbedder
    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.ops import quantize as qz
    from pvr_habitat_tpu_torch.tools import save_embedded_obs

    check_int_mm(torch, qz, device, smi)
    ckpt_dir = os.path.join(workdir, "zoo")
    launches = {k: 0 for k in KERNELS}
    dev_frames = torch.from_numpy(frames[:BULK_BATCH]).to(device)
    for name, route, per_forward, gate in INT8:
        start = time.perf_counter()
        # resnet50 and mae_base: the seeded init of phases 4 and 5;
        # clip_rn50 and maskrcnn_l3: phase 8's checkpoints
        seeded = name in refs
        kwargs = dict(pretrained=not seeded, batch_size=BULK_BATCH)
        ckpt = None if seeded else ckpt_dir
        ref = refs.get(name)
        if ref is None:
            ref = f32_reference(torch, load_net(
                EmbeddingNet, name, ckpt_dir, fused="off"), frames)
        emb = load_net(ShardedEmbedder, name, ckpt, quantize=True, **kwargs)
        if emb.fused != route:
            raise AssertionError(f"{name} int8 route {emb.fused}")
        reset_launches(fb, fa)
        got = emb.embed_all(frames)
        counts = count_launches(fb, fa)
        forwards = math.ceil(len(frames) / BULK_BATCH) + 1   # + calibration
        want = {k: per_forward.get(k, 0) * forwards for k in KERNELS}
        if counts != want:
            raise AssertionError(f"{name} int8: launches {counts} != {want}")
        for k in KERNELS:
            launches[k] += counts[k]
        if got.shape != (len(frames), emb.out_size) \
                or not np.isfinite(got).all():
            raise AssertionError(f"{name} int8: {got.shape}")
        cos = row_cosine(torch, torch.from_numpy(got), ref)
        if cos <= gate:
            raise AssertionError(f"{name} int8: cosine vs f32 off {cos}")
        print(f"{name} int8 embed_all ({len(frames)} frames, batch "
              f"{BULK_BATCH}, route {route}): launches {counts} over "
              f"{forwards} forwards (one calibrates); min cosine vs f32 off "
              f"{cos:.6f} (gate {gate})", flush=True)

        int8_card_vs_cpu(torch, emb, dev_frames[:INT8_CPU_FRAMES], name)

        # frames/s: int8 beside the bf16 default route, both with their
        # params prepared once
        bf16 = load_net(ShardedEmbedder, name, ckpt, **kwargs)
        for label, e in (("int8", emb), (f"bf16 {bf16.fused}", bf16)):
            ms = time_ms(torch, lambda: e._forward(dev_frames), reps=5,
                         warmup=1)
            print(f"e2e {name} {label}: {BULK_BATCH / ms * 1e3:.1f} frames/s "
                  f"({ms:.3f} ms per batch of {BULK_BATCH}, frames on "
                  f"device) [{smi}]", flush=True)
        if name == "resnet50":
            int8_profile(torch, lambda: emb._forward(dev_frames),
                         "resnet50 int8")
        elif route != "off":
            profile_call(torch, lambda: emb._forward(dev_frames),
                         f"{name} int8 {route}", top=10)
        del emb, bf16
        torch.cuda.empty_cache()
        print(f"{name} int8: {time.perf_counter() - start:.1f} s", flush=True)

    # the CLI on phase 7's raw pickle (resnet50, f32 on v1 / int8)
    want = formats.load_pickle(
        formats.embedded_path(workdir, BC_ENV, "resnet50"))["obs"]
    for option, per_forward in CLI_LAUNCHES.items():
        path = os.path.join(workdir, option.strip("-"))
        os.makedirs(path)
        shutil.copy(formats.raw_path(workdir, BC_ENV),
                    formats.raw_path(path, BC_ENV))
        flags = save_embedded_obs.build_tool_parser().parse_args(
            ["--env", BC_ENV, "--data_path", path, "--embedding_name",
             "resnet50", "--source", "pickle", "--embed_batch_size",
             str(BULK_BATCH), "--disable_pretrained_embedding", option])
        reset_launches(fb, fa)
        start = time.perf_counter()
        got = formats.load_pickle(quiet(save_embedded_obs.run, flags))["obs"]
        seconds = time.perf_counter() - start
        counts = count_launches(fb, fa)
        forwards = math.ceil(len(want) / BULK_BATCH)
        if counts != {k: per_forward.get(k, 0) * forwards for k in KERNELS}:
            raise AssertionError(f"CLI {option}: launches {counts}")
        for k in KERNELS:
            launches[k] += counts[k]
        if got.shape != want.shape:
            raise AssertionError(f"CLI {option}: {got.shape}")
        cos = row_cosine(torch, torch.from_numpy(np.asarray(got)),
                         torch.from_numpy(np.asarray(want)))
        if option == "--sharded_embed":
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
        elif cos <= 0.99:
            raise AssertionError(f"CLI {option}: cosine {cos}")
        print(f"save_embedded_obs {option} (resnet50, batch {BULK_BATCH}): "
              f"{len(got)} samples in {seconds:.1f} s (tool wall time, "
              f"encoder builds included), launches {counts}, min cosine "
              f"vs phase 7's pickle {cos:.6f} [{smi}]", flush=True)
    return launches


class PickTimer:
    """Seconds spent in ``fused_bottleneck._pick`` calls that missed its
    cache (the f32 engine's launch-shape search, run once for each new
    batch size and block shape), on any thread, while it is open (a
    ``with`` block); ``_pick`` is restored on exit."""

    def __init__(self, fb):
        self.fb, self.original = fb, fb._pick
        self.seconds, self.searches = 0.0, 0

        def pick(*args):
            misses = self.original.cache_info().misses
            start = time.perf_counter()
            out = self.original(*args)
            if self.original.cache_info().misses != misses:
                self.seconds += time.perf_counter() - start
                self.searches += 1
            return out

        fb._pick = pick

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.fb._pick = self.original


class ServedNet:
    """The server's encoder: an ``EmbeddingNet`` whose calls (the
    micro-batches) are counted, sized and timed (host clock; the call
    returns numpy, so the device work is done)."""

    def __init__(self, net):
        self.net, self.out_size = net, net.out_size
        self.sizes, self.seconds = [], []

    def __call__(self, frames):
        start = time.perf_counter()
        out = self.net(frames)
        self.seconds.append(time.perf_counter() - start)
        self.sizes.append(frames.shape[0])
        return out


def serve_clients(address):
    """``SERVE_CLIENTS`` threads, each an ``EmbeddingClient`` sending
    ``SERVE_REQUESTS`` requests of 1 to ``SERVE_MAX_FRAMES`` uint8 64x64
    frames.  Returns [(frames, reply (n, D), round trip s)] and the wall
    time."""
    import threading

    from pvr_habitat_tpu_torch.tools.serve_embeddings import EmbeddingClient

    results, errors = {}, []

    def client(c):
        try:
            rng = np.random.RandomState(SEED + 100 + c)
            conn = EmbeddingClient(address)
            out = []
            for _ in range(SERVE_REQUESTS):
                n = rng.randint(1, SERVE_MAX_FRAMES + 1)
                frames = rng.randint(0, 256, size=(n, 64, 64, 3),
                                     dtype=np.uint8)
                start = time.perf_counter()
                reply = conn(frames)
                out.append((frames, reply.reshape(len(frames), -1),
                            time.perf_counter() - start))
            conn.close()
            results[c] = out
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(f"client {c}: {exc!r}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - start
    if errors or any(t.is_alive() for t in threads) \
            or len(results) != SERVE_CLIENTS:
        raise AssertionError(f"server clients: {errors or 'timed out'}")
    return [r for c in sorted(results) for r in results[c]], wall


def serve_slice(torch, fb, fa, device, smi):
    """Phase 10a: an ``EmbeddingServer`` in this process serves each
    encoder of ``SERVE`` (the card default route) to ``SERVE_CLIENTS``
    concurrent clients; launches gated per micro-batch, every reply held
    against a direct ``EmbeddingNet`` call on the same frames (f32 at
    1e-3) or against the f32 off path (bf16, per-frame cosine > 0.99).
    Returns the launches."""
    import collections

    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.tools.serve_embeddings import EmbeddingServer

    launches = {k: 0 for k in KERNELS}
    refs = {}
    for name, dtype_name, per_batch in SERVE:
        label = f"server {name} {dtype_name}"
        dtype = getattr(torch, dtype_name)
        start = time.perf_counter()
        net = EmbeddingNet(name, pretrained=False, compute_dtype=dtype,
                           device=device)
        served = ServedNet(net)
        server = EmbeddingServer(served, port=0, max_batch=SERVE_MAX_BATCH,
                                 window_ms=SERVE_WINDOW_MS).start()
        print(f"{label}: route {net.fused}, built and warmed (on the "
              f"dispatcher thread: {served.seconds[0] * 1e3:.1f} ms) in "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        served.sizes, served.seconds = [], []
        reset_launches(fb, fa)
        try:
            with PickTimer(fb) as picks:
                replies, wall = serve_clients(server.address)
        finally:
            server.close()
        counts = count_launches(fb, fa)
        batches = len(served.sizes)
        want = {k: per_batch.get(k, 0) * batches for k in KERNELS}
        if counts != want:
            raise AssertionError(f"{label}: launches {counts} != {want} "
                                 f"over {batches} micro-batches")
        for k in KERNELS:
            launches[k] += counts[k]
        frames = np.concatenate([f for f, _, _ in replies])
        got = np.concatenate([r for _, r, _ in replies])
        if sum(served.sizes) != len(frames) or not np.isfinite(got).all():
            raise AssertionError(f"{label}: {sum(served.sizes)} frames "
                                 f"served of {len(frames)}")
        if dtype == torch.float32:
            direct = net.embed_batches(frames, BULK_BATCH)
            np.testing.assert_allclose(got, direct, atol=1e-3, rtol=1e-3)
            gate = (f"max abs err vs a direct call "
                    f"{np.abs(got - direct).max():.3g} (1e-3)")
        else:
            if name not in refs:
                refs[name] = EmbeddingNet(
                    name, pretrained=False, compute_dtype=torch.float32,
                    fused="off", device=device).embed_batches(frames,
                                                              BULK_BATCH)
            cos = row_cosine(torch, torch.from_numpy(got),
                             torch.from_numpy(refs[name]))
            if cos <= 0.99:
                raise AssertionError(f"{label}: cosine vs f32 off {cos}")
            gate = f"min cosine vs f32 off {cos:.6f} (0.99)"
        rt = np.asarray([s for _, _, s in replies]) * 1e3
        hist = collections.Counter(
            min(8 * ((s - 1) // 8 + 1), 8 * (SERVE_MAX_BATCH // 8 + 1))
            for s in served.sizes)
        busy = sum(served.seconds)
        fwd = np.asarray(served.seconds) * 1e3
        print(f"{label}: {len(replies)} requests, {len(frames)} frames from "
              f"{SERVE_CLIENTS} clients in {batches} micro-batches; "
              f"launches {counts}; {gate}", flush=True)
        print(f"{label}: round trip p50 {np.percentile(rt, 50):.3f} ms, p99 "
              f"{np.percentile(rt, 99):.3f} ms; {len(frames) / wall:.1f} "
              f"frames/s over {wall:.2f} s; micro-batch frames (up to) "
              f"{dict(sorted(hist.items()))}; forwards {busy:.2f} s (ms: "
              f"first {fwd[0]:.1f}, median {np.median(fwd):.1f}, max "
              f"{fwd.max():.1f}, the slowest request's "
              f"{rt.max():.1f}); "
              f"launch-shape searches {picks.searches} taking "
              f"{picks.seconds * 1e3:.1f} ms, {picks.seconds / busy:.2%} of "
              f"the forwards [{smi}]", flush=True)
        del net, served, server
        torch.cuda.empty_cache()
    return launches


def png_slice(torch, fb, fa, device, smi, workdir):
    """Phase 10b: PNG datagen of phase 7's ``PNG_TRAJECTORIES``
    trajectories, decoded against phase 7's raw pickle (the same
    trajectories, bit for bit); ``save_embedded_obs`` with its default
    ``--source png`` (resnet50 f32, one forward a trajectory) gated on its
    launches and held against a direct ``embed_batches`` of the decoded
    frames at 1e-3; then the tool's read-and-embed loop
    (``read_png_trajectories(embed_fn=...)``) alone, on an encoder built
    before the clock starts, with the decode prefetch on (the tool's
    default) and off: embed frames/s, and the time inside the encoder's
    forwards beside the loop's wall time.  Returns the launches."""
    import os

    from pvr_habitat_tpu_torch.data import formats, native
    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.tools import save_embedded_obs
    from pvr_habitat_tpu_torch.tools import save_opt_trajectories_png

    root = os.path.join(workdir, "png")
    flags = save_opt_trajectories_png.build_tool_parser().parse_args(
        ["--env", BC_ENV, "--save_path", root, "--n_trajectories",
         str(PNG_TRAJECTORIES)])
    start = time.perf_counter()
    traj_dir = quiet(save_opt_trajectories_png.gen_data_habitat, flags)
    seconds = time.perf_counter() - start
    codec = native.codec()
    start = time.perf_counter()
    decoded = formats.read_png_trajectories(traj_dir)
    decode_s = time.perf_counter() - start
    raw = formats.load_pickle(formats.raw_path(workdir, BC_ENV))
    want = np.concatenate(raw["obs"][:PNG_TRAJECTORIES])
    if decoded["obs"].shape != want.shape \
            or not np.array_equal(decoded["obs"], want):
        raise AssertionError(f"PNG frames differ from the written ones: "
                             f"{decoded['obs'].shape} vs {want.shape}")
    n = len(want)
    sizes = [len(o) for o in raw["obs"][:PNG_TRAJECTORIES]]
    print(f"PNG datagen: {PNG_TRAJECTORIES} trajectories of {min(sizes)} "
          f"to {max(sizes)} frames, {n} frames in {seconds:.1f} s; decoded "
          f"by {codec}{'' if codec == 'native' else f' ({native._why})'} "
          f"equal to phase 7's frames bit for bit; decode "
          f"{n / decode_s:.1f} frames/s", flush=True)

    launches = {k: 0 for k in KERNELS}

    def gate(label, forwards):
        counts = count_launches(fb, fa)
        want_counts = {k: 0 for k in KERNELS}
        want_counts["fused_bottleneck"] = 16 * forwards
        if counts != want_counts or forwards != PNG_TRAJECTORIES:
            raise AssertionError(f"{label}: launches {counts}, {forwards} "
                                 "forwards")
        for k in KERNELS:
            launches[k] += counts[k]
        return counts

    flags = save_embedded_obs.build_tool_parser().parse_args(
        ["--env", BC_ENV, "--data_path", root, "--embedding_name",
         "resnet50", "--disable_pretrained_embedding"]
        + (["--disable_cuda"] if device.type == "cpu" else []))
    reset_launches(fb, fa)
    start = time.perf_counter()
    with ForwardCounter(torch, EmbeddingNet) as forwards, \
            PickTimer(fb) as picks:
        path = quiet(save_embedded_obs.run, flags)
    tool_s = time.perf_counter() - start
    counts = gate("PNG embed", forwards.count)
    got = formats.load_pickle(path)["obs"]
    net = EmbeddingNet("resnet50", pretrained=False, device=device)
    direct = net.embed_batches(decoded["obs"], BULK_BATCH)
    np.testing.assert_allclose(got, direct, atol=1e-3, rtol=1e-3)
    print(f"save_embedded_obs --source png (resnet50 f32, {forwards.count} "
          f"forwards, batch = a trajectory's frames): launches {counts}; max "
          f"abs err vs embed_batches {np.abs(got - direct).max():.3g} "
          f"(1e-3); tool wall time {tool_s:.2f} s, {n / tool_s:.1f} "
          f"frames/s with set-up (encoder build, weight save, "
          f"{picks.searches} first-seen launch-shape searches taking "
          f"{picks.seconds * 1e3:.1f} ms) [{smi}]", flush=True)

    for prefetch in (2, 0):
        reset_launches(fb, fa)
        with ForwardCounter(torch, EmbeddingNet, timed=True) as timer:
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = formats.read_png_trajectories(traj_dir, embed_fn=net,
                                                prefetch=prefetch)
            wall_ms = (time.perf_counter() - start) * 1e3
            device_ms = timer.device_ms()
        gate(f"PNG loop prefetch {prefetch}", timer.count)
        np.testing.assert_allclose(out["obs"], direct, atol=1e-3, rtol=1e-3)
        print(f"read-and-embed loop, prefetch {prefetch}"
              f"{' (the default)' if prefetch else ' (decode inline)'}: "
              f"{n / wall_ms * 1e3:.1f} frames/s over {wall_ms:.1f} ms "
              f"(encoder built before); inside the encoder forwards "
              f"{device_ms:.1f} ms (CUDA events, a forward's own dispatch "
              f"gaps included), outside them "
              f"{1 - device_ms / wall_ms:.1%} [{smi}]", flush=True)
    return launches


def ranks_slice(torch, fb, fa, device, smi, workdir):
    """Phase 10c: two ranks on the one card over gloo
    (``parallel/dryrun.py``): ``embed_local`` of ``RANK_EMBED_FRAMES``
    frames (resnet50 f32, batch 32), each rank's rows against one process
    at rtol 1e-3; then ``dryrun.STEPS`` data-parallel train steps at full
    width with BatchNorm on phase 7's embeddings, the ranks bitwise equal
    and each step against one process from the same state at rtol 1e-3;
    last, the dry run (``multichip``) as one rank with the card to itself,
    which takes NCCL.  Returns the ranks' launches."""
    import os

    from pvr_habitat_tpu_torch.data import formats, sampler
    from pvr_habitat_tpu_torch.data.embed_pipeline import ShardedEmbedder
    from pvr_habitat_tpu_torch.parallel import dryrun
    from pvr_habitat_tpu_torch.train import bc_step
    from pvr_habitat_tpu_torch.utils.flags import default_flags

    launches = {k: 0 for k in KERNELS}
    prefix = os.path.join(workdir, "embed_rank")
    start = time.perf_counter()
    # each rank keeps its share of the host's cores
    threads = {"OMP_NUM_THREADS": str(max(1, torch.get_num_threads()
                                          // RANKS))}
    logs = dryrun.launch(RANKS, [
        "embed", "--device", device.type, "--name", "resnet50", "--frames",
        str(RANK_EMBED_FRAMES), "--batch_size", "32", "--out", prefix],
        timeout=600, env=threads)
    seconds = time.perf_counter() - start
    backends = {line for log in logs for line in log.splitlines()
                if line.startswith("torch.distributed:")}
    frames = np.random.RandomState(dryrun.SEED).randint(
        0, 256, size=(RANK_EMBED_FRAMES, 64, 64, 3), dtype=np.uint8)
    want = ShardedEmbedder("resnet50", batch_size=32, pretrained=False,
                           compute_dtype=torch.float32,
                           device=device).embed_all(frames)
    rows, errs = 0, []
    for rank in range(RANKS):
        out = np.load(f"{prefix}{rank}.npz")
        start_row, stop = int(out["start"]), int(out["stop"])
        np.testing.assert_allclose(out["local"], want[start_row:stop],
                                   atol=1e-3, rtol=1e-3)
        errs.append(float(np.abs(out["local"] - want[start_row:stop]).max()))
        counts = dict(zip(out["kernels"].tolist(), out["launches"].tolist()))
        per_rank = {k: 0 for k in KERNELS}
        per_rank["fused_bottleneck"] = 16 * math.ceil((stop - start_row) / 32)
        if counts != per_rank:
            raise AssertionError(f"rank {rank} embed: launches {counts}")
        for k in KERNELS:
            launches[k] += counts[k]
        rows += stop - start_row
    if rows != RANK_EMBED_FRAMES:
        raise AssertionError(f"ranks embedded {rows} rows")
    print(f"embed_local over {RANKS} ranks on one card: {rows} frames "
          f"(resnet50 f32, batch 32) in {seconds:.1f} s (process starts "
          f"included); max abs err vs one process {max(errs):.3g} (1e-3); "
          f"launches {launches}; {sorted(backends)}", flush=True)

    prefix = os.path.join(workdir, "steps_rank")
    snapshots = os.path.join(workdir, "snapshots")
    os.makedirs(snapshots)
    data_path = formats.embedded_path(workdir, BC_ENV, "resnet50")
    start = time.perf_counter()
    dryrun.launch(RANKS, [
        "steps", "--device", device.type, "--data", data_path, "--snapshots",
        snapshots, "--out", prefix], timeout=600, env=threads)
    seconds = time.perf_counter() - start
    ranks = [np.load(f"{prefix}{rank}.npz") for rank in range(RANKS)]
    for r in ranks[1:]:
        if not np.array_equal(r["metrics"], ranks[0]["metrics"]):
            raise AssertionError(f"ranks differ: {ranks[0]['metrics']} vs "
                                 f"{r['metrics']}")
    data = formats.load_pickle(data_path)
    tensors = sampler.to_tensors(dict(
        obs=data["obs"].astype(np.float32),
        action=data["action"].astype(np.int64),
        done=data["done"].astype(bool)), device)
    fl = default_flags(batch_norm=True)
    _, opt = bc_step.create_train_state(
        np.random.RandomState(SEED), (data["obs"].shape[1],), 3, fl,
        max_epochs=100, device=device)
    step = bc_step.make_train_step(opt, batch_norm=True)
    one = []
    starts = [row.tolist() for row in ranks[0]["starts"]]
    for k, row in enumerate(starts):
        path = os.path.join(snapshots, f"step_{k}.pt")
        state = dryrun.restore(torch.load(path, weights_only=False), device)
        os.remove(path)
        state, m = step(state, sampler.gather_unrolls(tensors, row,
                                                      fl.unroll_length))
        one.append([m["loss"].item(), m["gradient_norm"].item()])
    one = np.asarray(one)
    np.testing.assert_allclose(ranks[0]["metrics"], one, rtol=1e-3)
    rel = np.abs(ranks[0]["metrics"] / one - 1).max(axis=0)
    torch.cuda.synchronize()
    start_one = time.perf_counter()
    for row in starts:
        state, m = step(state, sampler.gather_unrolls(tensors, row,
                                                      fl.unroll_length))
    m["loss"].item()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - start_one
    frames = len(starts) * fl.batch_size * fl.unroll_length
    dp_s = max(float(r["seconds"]) for r in ranks)
    reduce_s = max(float(r["reduce_seconds"]) for r in ranks)
    print(f"{len(starts)} data-parallel train steps over {RANKS} ranks (B "
          f"{fl.batch_size}, T {fl.unroll_length}, obs "
          f"{data['obs'].shape[1]}, batch_norm) in {seconds:.1f} s (process "
          f"starts included): ranks bitwise equal; losses "
          f"{ranks[0]['metrics'][:, 0].round(6).tolist()}; vs one process "
          f"from the same state: max rel err loss {rel[0]:.3g}, gradient "
          f"norm {rel[1]:.3g} (rtol 1e-3); training {frames / dp_s:.1f} "
          f"frames/s over {RANKS} ranks ({dp_s / len(starts) * 1e3:.1f} ms a "
          f"step) against {frames / one_s:.1f} in one process "
          f"({one_s / len(starts) * 1e3:.1f} ms); the gradient all-reduce "
          f"alone ({int(ranks[0]['reduce_numel']) * 4 / 1e6:.1f} MB through "
          f"the host) {reduce_s / len(starts) * 1e3:.1f} ms [{smi}]",
          flush=True)

    start = time.perf_counter()
    log = dryrun.launch(1, ["multichip", "--device", device.type],
                        timeout=300)[0]
    if "backend nccl" not in log or log.count("ranks equal OK") != 2 \
            or "sharded embedder parity OK" not in log:
        raise AssertionError(f"the dry run on one rank over NCCL:\n{log}")
    print(f"dry run, one rank with the card to itself, in "
          f"{time.perf_counter() - start:.1f} s: "
          f"{[x for x in log.splitlines() if 'backend' in x]}; DP steps "
          "and the sharded embedder OK", flush=True)
    return launches


def convert_slice(torch, fb, fa, frames, device, smi, workdir):
    """Phase 11a: ``tools/zoo_checkpoints.py`` writes reference-layout
    ``moco_aug`` and ``mae_base`` files, the port's ``convert_checkpoint``
    converts each on the card, and ``EmbeddingNet(compute_dtype=bf16)``
    built from the converted file (BN folded, as a frozen encoder folds
    it at build) answers exactly as the one built from the original
    through the pretrained path, with the launches of ``CONVERT`` a
    forward.  Returns the launches."""
    import os

    from pvr_habitat_tpu_torch.models import convert
    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.ops.fold_bn import fold_resnet_bn
    from pvr_habitat_tpu_torch.tools import convert_checkpoint
    from pvr_habitat_tpu_torch.tools import zoo_checkpoints

    directory = os.path.join(workdir, "convert")
    os.makedirs(directory)
    launches = {k: 0 for k in KERNELS}
    for name, per_forward in CONVERT:
        start = time.perf_counter()
        (original,) = zoo_checkpoints.write(name, directory, SEED)
        out = os.path.join(directory, f"{name}.converted.tar")
        convert_checkpoint.main(["--embedding_name", name, "--checkpoint",
                                 original, "--out", out])
        seconds = time.perf_counter() - start
        answers = []
        for source in ("converted", "original"):
            if source == "converted":
                net = EmbeddingNet(name, pretrained=False,
                                   compute_dtype=torch.bfloat16)
                net.params = fold_resnet_bn(convert.load_flat(out, device))
            else:
                net = load_net(EmbeddingNet, name, directory,
                               compute_dtype=torch.bfloat16)
            reset_launches(fb, fa)
            answers.append(net(frames[:CONVERT_FRAMES]))
            counts = count_launches(fb, fa)
            want = {k: per_forward.get(k, 0) for k in KERNELS}
            if counts != want:
                raise AssertionError(f"{name} from the {source} file: "
                                     f"launches {counts}, not {want}")
            for k in KERNELS:
                launches[k] += counts[k]
        if not np.array_equal(*answers) or not np.isfinite(answers[0]).all():
            raise AssertionError(
                f"{name}: the converted file's answer differs by "
                f"{np.abs(answers[0] - answers[1]).max()}")
        print(f"{name}: converted on the card in {seconds:.1f} s (reference "
              f"file written included); bf16 on route {net.fused} from the "
              f"converted file and from the original, {CONVERT_FRAMES} "
              f"frames: equal, shape {answers[0].shape}; launches a forward "
              f"{counts}", flush=True)
    return launches


class CountingExecutor:
    """The sweep's ``LocalExecutor`` with every count at 0 before a job;
    records each job's runner, flags, encoder forwards, launches and
    seconds."""

    def __init__(self, torch, fb, fa, sweep):
        self.torch, self.fb, self.fa = torch, fb, fa
        self.local = sweep.LocalExecutor()
        self.jobs = []

    def submit(self, fn, flags):
        from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet

        reset_launches(self.fb, self.fa)
        start = time.perf_counter()
        with ForwardCounter(self.torch, EmbeddingNet) as forwards:
            out = quiet(self.local.submit, fn, flags)
        self.jobs.append(dict(runner=fn.__name__, flags=flags,
                              forwards=forwards.count,
                              launches=count_launches(self.fb, self.fa),
                              seconds=time.perf_counter() - start))
        return out


def sweep_slice(torch, fb, fa, device, smi, workdir):
    """Phase 11b: the sweep (``tools/sweep.py``) over one FakeImageNav
    scene: datagen, then the embedding sweep (resnet50 on the raw
    pickle), a BC grid of resnet50 (``main_bc_2`` on those embeddings)
    and random (``main_bc_1``, embedding at load), and a finetune grid,
    each job in this process through the sweep's local executor, its
    launches gated (16 ``fused_bottleneck`` a resnet50 forward, none
    elsewhere); then a second seed of the resnet50 job through
    ``SubprocessExecutor`` (the port's ``main_bc_2`` as a process, seed
    1 skipped as completed); every job's stats pickle and checkpoint,
    finite losses; and a second call of each sweep submits nothing.
    Returns the in-process jobs' launches."""
    import os

    from pvr_habitat_tpu_torch.data import formats
    from pvr_habitat_tpu_torch.tools import save_opt_trajectories, sweep

    data = os.path.join(workdir, "sweep_data")
    save = os.path.join(workdir, "sweep", "latest")
    flags = save_opt_trajectories.build_tool_parser().parse_args(
        ["--env", SWEEP_ENV, "--save_path", data, "--n_trajectories",
         str(SWEEP_TRAJECTORIES)])
    start = time.perf_counter()
    quiet(save_opt_trajectories.gen_data_habitat, flags)
    print(f"sweep datagen: {SWEEP_TRAJECTORIES} {SWEEP_ENV} trajectories "
          f"in {time.perf_counter() - start:.1f} s", flush=True)
    executor = CountingExecutor(torch, fb, fa, sweep)
    embed = dict(env=[SWEEP_ENV], embedding_name=["resnet50"],
                 batch_size=[32])
    grid = dict(env=[SWEEP_ENV], to_env=[SWEEP_ENV],
                embedding_name=["resnet50", "random"], run_id=[1],
                save_path=[save], data_path=[data], **SWEEP_GRID)
    frames = {SWEEP_ENV: SWEEP_EPOCHS * SWEEP_GRID["batch_size"][0]
              * SWEEP_GRID["unroll_length"][0]}
    finetune = dict(grid, embedding_name=["random"])
    seeds = dict(grid, embedding_name=["resnet50"], run_id=[1, 2])
    calls = [
        ("embedding sweep", 1, lambda ex: sweep.run_embedding_sweep(
            embed, ex, data_path=data)),
        ("BC sweep", 2, lambda ex: sweep.run_bc_sweep(
            grid, ex, max_frames_map=frames)),
        ("finetune sweep", 1, lambda ex: sweep.run_bc_sweep(
            finetune, ex, max_frames_map=frames, finetune=True))]
    for label, n_jobs, call in calls:
        if len(call(executor)) != n_jobs:
            raise AssertionError(f"{label}: jobs {executor.jobs}")
    launches = {k: 0 for k in KERNELS}
    for job in executor.jobs:
        name = job["flags"].embedding_name
        want = {k: 0 for k in KERNELS}
        if name == "resnet50":
            want["fused_bottleneck"] = 16 * job["forwards"]
        if job["launches"] != want or (job["runner"] != "runner_finetune"
                                       and not job["forwards"]):
            raise AssertionError(f"sweep job {job['runner']} {name}: "
                                 f"{job['forwards']} forwards, launches "
                                 f"{job['launches']}")
        for k in KERNELS:
            launches[k] += job["launches"][k]
        print(f"sweep job {job['runner']} ({name}, xpid "
              f"{job['flags'].xpid}): {job['forwards']} "
              f"encoder forwards, launches {job['launches']}, "
              f"{job['seconds']:.1f} s", flush=True)
    start = time.perf_counter()
    if sweep.run_bc_sweep(seeds, sweep.SubprocessExecutor(),
                          max_frames_map=frames) != ["subprocess:0"]:
        raise AssertionError("the subprocess job failed")
    print(f"sweep job through SubprocessExecutor (python -m "
          f"pvr_habitat_tpu_torch.main_bc_2, resnet50, seed 2; seed 1 "
          f"skipped as completed): {time.perf_counter() - start:.1f} s",
          flush=True)

    stems = [f"{SWEEP_ENV}_em{e}_s{s}_{SWEEP_ENV}" for e, s in (
        ("resnet50", 1), ("resnet50", 2), ("random", 1),
        ("random_finetuned", 1))]
    for stem in stems:
        path = os.path.join(save, stem)
        if not all(os.path.isfile(path + ext) for ext in (".pickle", ".tar")):
            raise AssertionError(f"sweep job {stem}: {os.listdir(save)}")
        losses = formats.load_pickle(path + ".pickle")[SWEEP_ENV][
            "training_loss"][1:]
        if len(losses) != SWEEP_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"sweep job {stem}: losses {losses}")
    rerun = [call(sweep.LocalExecutor()) for _, _, call in calls] + [
        sweep.run_bc_sweep(seeds, sweep.SubprocessExecutor(),
                           max_frames_map=frames)]
    if any(rerun):
        raise AssertionError(f"a second sweep submitted {rerun}")
    print(f"sweep outputs: {len(stems)} runs with stats and checkpoint, "
          f"{SWEEP_EPOCHS} finite losses each, and the embedded pickle; a "
          "second call of each sweep submitted nothing", flush=True)
    return launches


def tensor_parallel_slice(torch, fb, fa, device, smi, workdir):
    """Phase 11c: tensor parallelism of the policy on a (1, 2) mesh, two
    ranks on the one card over gloo (``parallel/dryrun.py``), at full
    width with BatchNorm (B 32, T 100, obs 2048, phase 7's ResNet-50
    embeddings).  (1) ``main_bc_2 --mesh_shape 1,2`` (the ``train``
    task, ``TP_STEPS`` steps, eval after each on the gathered params)
    beside the same run in one process: the losses and pre-clip norms,
    and the checkpoints (keys, shapes, params within 1e-4).  (2) The
    ``steps`` task on the same mesh: each step against one process from
    the same state (rtol 1e-4), ms a step beside one process, and a
    step's all-gathers and sharded inputs' all-reduces alone.  Returns
    the one-process run's launches (the ranks count theirs in their own
    processes)."""
    import os
    import shlex

    from pvr_habitat_tpu_torch.data import formats, sampler
    from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
    from pvr_habitat_tpu_torch.parallel import dryrun
    from pvr_habitat_tpu_torch.train import bc, bc_step
    from pvr_habitat_tpu_torch.utils import checkpoint as ckpt
    from pvr_habitat_tpu_torch.utils.flags import default_flags

    threads = {"OMP_NUM_THREADS": str(max(1, torch.get_num_threads()
                                          // RANKS))}
    fl = default_flags(batch_norm=True)
    b, t = fl.batch_size, fl.unroll_length
    kw = dict(env=BC_ENV, to_env=BC_ENV, embedding_name="resnet50",
              data_path=workdir, eval_frequency=1, n_episodes_test=1,
              max_episode_steps=TP_EPISODE_STEPS,
              max_frames=TP_STEPS * b * t)
    mesh_dir = os.path.join(workdir, "tp_mesh")
    one_dir = os.path.join(workdir, "tp_one")
    bc_flags = " ".join(f"--{k} {shlex.quote(str(v))}"
                        for k, v in kw.items())
    bc_flags += f" --batch_norm --mesh_shape 1,2 --save_path {mesh_dir}"
    prefix = os.path.join(workdir, "tp_train")
    start = time.perf_counter()
    logs = dryrun.launch(RANKS, ["train", "--device", device.type, "--out",
                                 prefix, "--bc_flags", bc_flags],
                         timeout=600, env=threads)
    mesh_s = time.perf_counter() - start
    backends = {line for log in logs for line in log.splitlines()
                if line.startswith("torch.distributed:")}
    if not all("tensor parallel: 2 ranks a row" in log for log in logs):
        raise AssertionError(f"no tensor-parallel trainer:\n{logs[0]}")
    ranks = [np.load(f"{prefix}{r}.npz") for r in range(RANKS)]
    for r in ranks[1:]:
        for key in ("loss", "gnorm", "ret"):
            if not np.array_equal(r[key], ranks[0][key], equal_nan=True):
                raise AssertionError(f"the ranks differ in {key}")
    reset_launches(fb, fa)
    start = time.perf_counter()
    with ForwardCounter(torch, EmbeddingNet) as forwards:
        one = quiet(bc.run, default_flags(**kw, batch_norm=True,
                                          save_path=one_dir))[BC_ENV]
    one_s = time.perf_counter() - start
    launches = count_launches(fb, fa)
    if launches["fused_bottleneck"] != 16 * forwards.count \
            or not forwards.count:
        raise AssertionError(f"one-process run: launches {launches}, "
                             f"{forwards.count} forwards")
    got = np.stack([ranks[0]["loss"][1:], ranks[0]["gnorm"][1:]], axis=1)
    want = np.stack([one["training_loss"][1:], one["gradient_norm"][1:]],
                    axis=1)
    if got.shape != (TP_STEPS, 2) or not np.isfinite(got).all():
        raise AssertionError(f"mesh run: {got}")
    free_rel = np.abs(got / want - 1)
    stem = f"{BC_ENV}_emresnet50_s1_{BC_ENV}"
    files = [ckpt.load_checkpoint(os.path.join(d, stem + ".tar"))
             for d in (mesh_dir, one_dir)]
    trees = [(f["actor_model_state_dict"],
              f["actor_model_optimizer_state_dict"]["square_avg"])
             for f in files]
    for mesh_tree, one_tree in zip(*trees):
        if {k: v.shape for k, v in mesh_tree.items()} != \
                {k: v.shape for k, v in one_tree.items()}:
            raise AssertionError("the mesh's checkpoint has other keys or "
                                 "shapes than one process's")
    param_err = max(float(np.abs(trees[0][0][k] - v).max())
                    for k, v in trees[1][0].items())
    print(f"main_bc_2 --mesh_shape 1,2 on {RANKS} ranks ({TP_STEPS} steps, "
          f"B {b}, T {t}, obs 2048, batch_norm, eval after each on the "
          f"gathered params) in {mesh_s:.1f} s (process starts included), "
          f"one process {one_s:.1f} s ({forwards.count} encoder forwards, "
          f"launches {launches}); the ranks equal; free-running against one "
          f"process: losses {got[:, 0].tolist()} vs "
          f"{want[:, 0].tolist()}, rel err per step loss "
          f"{[float(f'{x:.3g}') for x in free_rel[:, 0]]}, gradient norm "
          f"{[float(f'{x:.3g}') for x in free_rel[:, 1]]}; checkpoints: "
          f"same keys and shapes, params max abs err {param_err:.3g} "
          f"(1e-4); {sorted(backends)}", flush=True)

    # (2) each step from the same state, times, and the collectives alone
    prefix = os.path.join(workdir, "tp_steps")
    snapshots = os.path.join(workdir, "tp_snapshots")
    os.makedirs(snapshots)
    data_path = formats.embedded_path(workdir, BC_ENV, "resnet50")
    dryrun.launch(RANKS, ["steps", "--device", device.type, "--data",
                          data_path, "--snapshots", snapshots, "--out",
                          prefix, "--mesh_shape", "1,2"],
                  timeout=600, env=threads)
    ranks = [np.load(f"{prefix}{r}.npz") for r in range(RANKS)]
    if not np.array_equal(ranks[1]["metrics"], ranks[0]["metrics"]):
        raise AssertionError("the ranks' steps differ")
    data = formats.load_pickle(data_path)
    tensors = sampler.to_tensors(dict(
        obs=data["obs"].astype(np.float32),
        action=data["action"].astype(np.int64),
        done=data["done"].astype(bool)), device)
    _, opt = bc_step.create_train_state(
        np.random.RandomState(SEED), (data["obs"].shape[1],), 3, fl,
        max_epochs=100, device=device)
    step = bc_step.make_train_step(opt, batch_norm=True)
    starts = [row.tolist() for row in ranks[0]["starts"]]
    single = []
    for k, row in enumerate(starts):
        path = os.path.join(snapshots, f"step_{k}.pt")
        state = dryrun.restore(torch.load(path, weights_only=False), device)
        os.remove(path)
        state, m = step(state, sampler.gather_unrolls(tensors, row, t))
        single.append([m["loss"].item(), m["gradient_norm"].item()])
    single = np.asarray(single)
    np.testing.assert_allclose(ranks[0]["metrics"], single, rtol=1e-4)
    rel = np.abs(ranks[0]["metrics"] / single - 1).max(axis=0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for row in starts:
        state, m = step(state, sampler.gather_unrolls(tensors, row, t))
    m["loss"].item()
    torch.cuda.synchronize()
    n = len(starts)
    one_ms = (time.perf_counter() - start) / n * 1e3
    tp_ms, gather_ms, input_ms = (
        max(float(r[key]) for r in ranks) / n * 1e3
        for key in ("seconds", "gather_seconds", "input_reduce_seconds"))
    print(f"{n} tensor-parallel train steps on the (1, 2) mesh (B {b}, T "
          f"{t}, obs {data['obs'].shape[1]}, batch_norm), each from the same "
          f"state as one process: max rel err loss {rel[0]:.3g}, gradient "
          f"norm {rel[1]:.3g} (rtol 1e-4); {tp_ms:.1f} ms a step over "
          f"{RANKS} ranks against {one_ms:.1f} in one process; a step's "
          f"{2 + 2 * t} all-gathers alone {gather_ms:.1f} ms "
          f"({gather_ms / tp_ms:.1%} of the step), its {2 + 4 * t} sharded "
          f"inputs' gradient all-reduces alone {input_ms:.1f} ms "
          f"({input_ms / tp_ms:.1%}) [{smi}]", flush=True)
    # (1)'s gates, after (2) has printed its numbers
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if param_err > 1e-4:
        raise AssertionError(f"checkpoint params differ by {param_err}")
    return launches


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

        t0 = phase("9 slice: int8 serving and the bulk embedder")
        counts = int8_slice(torch, fb, fa, frames,
                            {"resnet50": ref, "mae_base": mae_ref}, device,
                            smi, workdir.name)
        for k in KERNELS:
            launches[k] += counts[k]
        print(f"slice phase {time.perf_counter() - t0:.1f} s")

        t0 = phase("10 slice: serving and scale-out")
        for part in (
                lambda: serve_slice(torch, fb, fa, device, smi),
                lambda: png_slice(torch, fb, fa, device, smi, workdir.name),
                lambda: ranks_slice(torch, fb, fa, device, smi,
                                    workdir.name)):
            start = time.perf_counter()
            counts = part()
            for k in KERNELS:
                launches[k] += counts[k]
            print(f"part {time.perf_counter() - start:.1f} s", flush=True)
        print(f"slice phase {time.perf_counter() - t0:.1f} s")

        t0 = phase("11 slice: sweep, checkpoint conversion, tensor "
                   "parallelism")
        for part in (
                lambda: convert_slice(torch, fb, fa, frames, device, smi,
                                      workdir.name),
                lambda: sweep_slice(torch, fb, fa, device, smi,
                                    workdir.name),
                lambda: tensor_parallel_slice(torch, fb, fa, device, smi,
                                              workdir.name)):
            start = time.perf_counter()
            counts = part()
            for k in KERNELS:
                launches[k] += counts[k]
            print(f"part {time.perf_counter() - start:.1f} s", flush=True)
        print("the habitat and gym adapters (envs/habitat_adapter.py, "
              "envs/gym_adapter.py) do not run here: neither habitat nor "
              "gym is installed on this machine; the CPU tests hold them "
              "against the JAX package's on stubs "
              "(tests/test_torch_adapters.py)", flush=True)
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
