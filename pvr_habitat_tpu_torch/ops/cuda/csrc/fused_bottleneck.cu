// Fused BN-folded ResNet bottleneck blocks for Hopper (sm_90a).
//
// Replaces pvr_habitat_tpu/ops/pallas/fused_bottleneck.py::fused_bottleneck
// (v1, NHWC) and ::fused_bottleneck_flat (v2, padded-flat NHWC with a zero
// border).  One launch computes the whole block
//
//   y1 = relu(x . W1 + b1)                     rounded to x's type
//   y2 = relu(conv3x3_s(y1) + b2)              rounded to x's type
//   out = relu(y2 . W3 + b3 + (x_s . Wd + bd | x))
//
// with f32 accumulation, the rounding points of the TPU kernel, one read
// of x and one write of out.
//
// What bounds it on the H100: at batch 256 in bf16 the layer1 blocks move
// ~0.8 GB (x in, out) against ~112 GFLOP, so a cuDNN-style pipeline of
// three convs that writes y1 and y2 to HBM is memory-bound there; the
// layer3/4 blocks move ~0.1 GB for the same FLOP and are compute-bound.
// Design: the TPU kernel keeps one whole image (up to ~100 MB of VMEM) on
// chip; an SM has 227 KB of shared memory, so each block owns a T x T
// output tile of one image for all output channels.  Stage 1 recomputes
// conv1 on the tile's one-pixel halo ((T-1)*s+3 squared input positions)
// and keeps y1 in shared memory, which buys the single HBM read; stage 2
// runs the 3x3 conv from shared memory into a y2 tile, also in shared
// memory; stage 3 walks Cout and adds the shortcut.
//
// Each stage is a product whose A rows are gathered (halo positions, the
// nine taps, strided pixels).  Two engines run the products:
//   bf16 (bottleneck_mma_kernel): the block's 8 warps cover a BM x BN
//         tile (BM * BN = 8192, BM the smallest of 256/128/64/32 that
//         covers the stage's rows), a warp 32 x 32 on mma.sync m16n8k16.
//         The weights are walked in chunks of 64 rows (32 where the ring
//         holds fewer than two), each copied once per block tile by
//         16-byte cp.async into a two-chunk ring, one chunk in flight
//         while the other runs; the ring takes what the block's occupancy
//         leaves of shared memory, at least kRingBytes, so the tiles are
//         those of the older engine.  B comes from the ring by
//         ldmatrix.x4.trans, A from y1 and y2 by ldmatrix.x4 with each
//         lane's gathered row address, and from x (stage 1, the
//         projection) by one 8-byte load a row and k16 step, with the
//         step's k permuted to match.  Epilogues work on channel pairs
//         (bf162 stores, float2 biases).
//   f32 (bottleneck_kernel<ScalarEngine>): scalar FMAs from a register
//         tile of RM rows x RN channels per thread, weights read from
//         global memory two 4-deep steps ahead of their FMAs (the f32
//         parity path; TF32 would break its tolerance).  It serves the
//         eval batches (1 and 4 images), where one block per tile gave
//         layer3/4 4 to 16 blocks for 132 SMs: a batch-1 forward's 16
//         launches took 11.70 ms, layer4.0 1.87 on 4 SMs.  So a tile may
//         be computed by a thread-block cluster of C = 1, 2, 4 or 8
//         blocks that split its channels: block r computes channels
//         [r P/C, (r+1) P/C) of y1 and y2 and [r Cout/C, (r+1) Cout/C) of
//         the output, reading only those columns of each weight matrix,
//         and after stage 1 and stage 2 copies the other channels of y1
//         and y2 from its peers' shared memory (distributed shared
//         memory, 16-byte reads) into its own.  Every output element is
//         still one thread's FMA chain over the same K in the same
//         order, so every (tile, C) gives the same bits.  The wrapper's
//         pick_launch chooses (tile, C) from the batch and the SM count.
//         What bounds it now: a block's time is its rounds of 256 threads
//         over 8 x 4 jobs, each round one chain of K FMAs that waits on
//         the L2 for weights; at one 256-thread block an SM (over 200
//         registers a thread) a stage of few jobs leaves most of the SM's
//         instruction slots idle.  The 16 launches now take 4.17 ms at batch 1
//         (11.70 before), 4.99 at batch 4 (11.92), cuDNN f32 3.62 and
//         3.76; H100 80GB HBM3 at 700 W, chip_smoke.py (PERF.md).
// The bf16 engine was first a warp-per-job loop that built each B
// register from two 2-byte global loads and each A register from a 4-byte
// load; its ResNet-50 v1 forward took 52.2 ms against this one's 31.2
// (cuDNN 19.5), H100 80GB HBM3 at 700 W, tools/bottleneck_variants.py
// (PERF.md has the numbers).  What bounds it
// now is no single part: leaving out the x loads saves 24%, the epilogue
// stores 17%, the weight copies 14%, the products 11%, the barrier a
// chunk 7%.  Stage 2 and 3 at layer4.0 have 16 rows a block, so every
// weight element is fetched once per 16 output pixels: 12 GB of L2
// traffic a launch, 5.8 ms against cuDNN's 0.73.  More rows a block, or
// weights shared across a cluster, and staged x rows are the next levers;
// wgmma and TMA after them.
//
// v2 runs the same device code with FLAT=true: the input carries a zero
// border, y1 and the output are multiplied by the mask (the TPU kernel's
// :172 and :196), and the output border is written as zero so blocks
// chain without re-padding.
//
// Shared-memory rows are P + 8 elements apart (the ring's BN + 8), so the
// eight rows of an MMA fragment fall on distinct banks.
//
// Plain C interface, loaded with ctypes: each launcher returns the
// cudaError_t of the launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 8;  // shared-memory row pitch is P + kPad elements

template <typename T>
struct Args {
  const T* x;
  const T* w1;       // (Cin, P)
  const float* b1;   // (P)
  const T* w2;       // (9, P, P), tap = dh * 3 + dw
  const float* b2;   // (P)
  const T* w3;       // (P, Cout)
  const float* b3;   // (Cout)
  const T* wd;       // (Cin, Cout) or null
  const float* bd;   // (Cout) or null
  const float* mask; // ((H+2)*(W+2)) for FLAT, else null
  T* out;
  int h, w, cin, p, cout, stride, tile;
  int cluster;       // f32: blocks that split a tile's channels (1, 2, 4, 8)
  int ring;          // bytes of the bf16 engine's weight ring
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// f32 engine: each thread owns RM rows x RN channels of a job.
// ---------------------------------------------------------------------------

struct ScalarEngine {
  static constexpr int RM = 8, RN = 4;
  static constexpr int kRows = RM, kCols = RN, kSlots = RM;
  static constexpr int kUnits = kThreads;
  using T = float;
  struct Acc { float v[RM][RN]; };

  __device__ static int unit() { return threadIdx.x; }
  __device__ static int slot_row(int s) { return s; }
  __device__ static const T* lane_offset(const T* row) { return row; }
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc.v[r][c] = 0.f;
  }

  // acc[r][c] += sum_k a[r][k] * b[k * ldb + n0 + c]; K a multiple of 4.
  __device__ static void accumulate(Acc& acc, const T* const (&a)[kSlots],
                                    const T* __restrict__ b, int K, int ldb,
                                    int n0, int /*n_end*/) {
    b += n0;
    // A step waits on the L2 for its weights, so B's rows are loaded two
    // 4-deep steps ahead of the FMAs that use them (past the end, the
    // last step's rows again); the FMAs and their order are unchanged.
    float4 b0[4], b1[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      b0[kk] = __ldg(reinterpret_cast<const float4*>(b + (size_t)kk * ldb));
      b1[kk] = __ldg(reinterpret_cast<const float4*>(
          b + (size_t)((K > 4 ? 4 : 0) + kk) * ldb));
    }
    for (int k = 0; k < K; k += 4) {
      const int kn = k + 8 < K ? k + 8 : K - 4;
      float4 b2[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        b2[kk] = __ldg(
            reinterpret_cast<const float4*>(b + (size_t)(kn + kk) * ldb));
      float4 av[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        av[r] = *reinterpret_cast<const float4*>(a[r] + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float bv[RN] = {b0[kk].x, b0[kk].y, b0[kk].z, b0[kk].w};
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float x = kk == 0 ? av[r].x : kk == 1 ? av[r].y
                        : kk == 2 ? av[r].z : av[r].w;
#pragma unroll
          for (int c = 0; c < RN; ++c) acc.v[r][c] = fmaf(x, bv[c], acc.v[r][c]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        b0[kk] = b1[kk];
        b1[kk] = b2[kk];
      }
    }
  }

  // f(slot, channel offset within the job, value) for every element owned.
  template <typename F>
  __device__ static void for_each(const Acc& acc, int /*n0*/, int /*n_end*/,
                                  F f) {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) f(r, c, acc.v[r][c]);
  }
};

// Element offset of pixel (hh, ww) of image n, in units of pixels.
// FLAT: the (H+2) x (W+2) padded plane, (hh, ww) in [-1, H] x [-1, W].
template <bool FLAT>
__device__ __forceinline__ int64_t pixel(int n, int hh, int ww, int H, int W) {
  if (FLAT)
    return ((int64_t)n * (H + 2) + hh + 1) * (W + 2) + ww + 1;
  return ((int64_t)n * H + hh) * W + ww;
}

// Image n's first element in an (N, H, W, C) or padded-flat tensor.
template <bool FLAT, typename T>
__device__ __forceinline__ T* image(T* t, int n, int H, int W, int C) {
  return t + (FLAT ? (int64_t)(H + 2) * (W + 2) : (int64_t)H * W) * n * C;
}

// v2: zero the one-pixel border of image n's padded (H+2) x (W+2) output.
template <typename T>
__device__ void write_flat_border(T* out, int n, int H, int W, int Cout) {
  const int PW = W + 2, PH = H + 2;
  const int nb = 2 * PW + 2 * H;
  for (int e = threadIdx.x; e < nb * Cout; e += kThreads) {
    const int b = e / Cout, c = e % Cout;
    int row, col;
    if (b < PW) {
      row = 0; col = b;
    } else if (b < 2 * PW) {
      row = PH - 1; col = b - PW;
    } else {
      row = 1 + (b - 2 * PW) / 2;
      col = ((b - 2 * PW) & 1) ? PW - 1 : 0;
    }
    out[(((int64_t)n * PH + row) * PW + col) * Cout + c] = from_f32<T>(0.f);
  }
}

// Rows [0, M) of the channels that the other C - 1 blocks of this
// block's cluster own in `buf` (row pitch `pitch`, `width` channels a
// block; this block is rank r), copied from their shared memory into the
// same places of this block's, 16 bytes a read.
template <typename T>
__device__ void gather_peers(T* buf, int M, int pitch, int width, int C,
                             int r) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte piece
  const int vec = width / kVec;         // pieces a row of a slice
  const int per_peer = M * vec;
  for (int i = threadIdx.x; i < (C - 1) * per_peer; i += kThreads) {
    const int q = (r + 1 + i / per_peer) % C;  // start at the next rank
    const int e = i % per_peer;
    T* local = buf + (e / vec) * pitch + q * width + (e % vec) * kVec;
    *reinterpret_cast<float4*>(local) =
        *reinterpret_cast<const float4*>(cluster.map_shared_rank(local, q));
  }
}

// One output tile per cluster of args.cluster blocks (a plain launch when
// it is 1); block r of the cluster computes its 1/C of y1's, y2's and the
// output's channels (the file header).
template <typename E, bool FLAT>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const Args<typename E::T> args) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = args.h, W = args.w, S = args.stride, TT = args.tile;
  const int P = args.p, Cin = args.cin, Cout = args.cout;
  const int C = args.cluster;
  const int pitch = P + kPad;
  const int Ho = H / S, Wo = W / S;
  const int HS = (TT - 1) * S + 3;  // halo side
  const int tiles_w = (Wo + TT - 1) / TT;
  const int tile = blockIdx.x / C, rank = blockIdx.x % C;
  const int oh0 = (tile / tiles_w) * TT;
  const int ow0 = (tile % tiles_w) * TT;
  const int n = blockIdx.y;
  const bool has_ds = args.wd != nullptr;

  T* y1s = reinterpret_cast<T*>(smem_raw);  // [HS * HS][pitch]
  T* y2s = y1s + HS * HS * pitch;            // [TT * TT][pitch]

  // ---- stage 1: y1 on the halo; zero where conv2 pads ------------------
  // This block's channel groups of y1 and y2: [rank, rank + 1) * groups_p.
  const int groups_p = P / C / E::kCols;
  const int M1 = HS * HS;
  for (int job = E::unit(); job < ((M1 + E::kRows - 1) / E::kRows) * groups_p;
       job += E::kUnits) {
    const int m0 = (job / groups_p) * E::kRows;
    const int n0 = (rank * groups_p + job % groups_p) * E::kCols;
    const T* a[E::kSlots];
    float keep[E::kSlots];
#pragma unroll
    for (int s = 0; s < E::kSlots; ++s) {
      const int m = m0 + E::slot_row(s);
      const int hh = oh0 * S - 1 + m / HS, ww = ow0 * S - 1 + m % HS;
      bool ok;
      if (FLAT)  // every position of the padded plane is readable
        ok = m < M1 && hh >= -1 && hh <= H && ww >= -1 && ww <= W;
      else
        ok = m < M1 && hh >= 0 && hh < H && ww >= 0 && ww < W;
      a[s] = E::lane_offset(
          args.x + pixel<FLAT>(n, ok ? hh : 0, ok ? ww : 0, H, W) * Cin);
      if (FLAT)
        keep[s] = ok ? args.mask[(hh + 1) * (W + 2) + ww + 1] : 0.f;
      else
        keep[s] = ok ? 1.f : 0.f;
    }
    typename E::Acc acc;
    E::zero(acc);
    E::accumulate(acc, a, args.w1, Cin, P, n0, P);
    E::for_each(acc, n0, P, [&](int s, int c, float v) {
      const int m = m0 + E::slot_row(s);
      if (m < M1)
        y1s[m * pitch + n0 + c] =
            from_f32<T>(fmaxf(v + args.b1[n0 + c], 0.f) * keep[s]);
    });
  }
  // In a cluster: every block's slice of y1 is written (cluster.sync also
  // orders this block's own stores), then the peers' slices are copied in.
  if (C > 1) {
    cg::this_cluster().sync();
    gather_peers(y1s, M1, pitch, P / C, C, rank);
  }
  __syncthreads();

  // ---- stage 2: y2 = relu(conv3x3_s(y1) + b2) from shared memory --------
  const int M2 = TT * TT;
  for (int job = E::unit(); job < ((M2 + E::kRows - 1) / E::kRows) * groups_p;
       job += E::kUnits) {
    const int m0 = (job / groups_p) * E::kRows;
    const int n0 = (rank * groups_p + job % groups_p) * E::kCols;
    int base[E::kSlots];
#pragma unroll
    for (int s = 0; s < E::kSlots; ++s) {
      const int m = min(m0 + E::slot_row(s), M2 - 1);
      base[s] = (m / TT) * S * HS + (m % TT) * S;
    }
    typename E::Acc acc;
    E::zero(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * HS + tap % 3;
      const T* a[E::kSlots];
#pragma unroll
      for (int s = 0; s < E::kSlots; ++s)
        a[s] = E::lane_offset(y1s + (base[s] + shift) * pitch);
      E::accumulate(acc, a, args.w2 + (size_t)tap * P * P, P, P, n0, P);
    }
    E::for_each(acc, n0, P, [&](int s, int c, float v) {
      const int m = m0 + E::slot_row(s);
      if (m < M2)
        y2s[m * pitch + n0 + c] =
            from_f32<T>(fmaxf(v + args.b2[n0 + c], 0.f));
    });
  }
  // The same for y2; the peers have read this block's y1 before they
  // arrive here, so y1 is free from now on.
  if (C > 1) {
    cg::this_cluster().sync();
    gather_peers(y2s, M2, pitch, P / C, C, rank);
  }
  __syncthreads();

  // ---- stage 3: out = relu(y2 . W3 + b3 + shortcut) ---------------------
  const int groups_o = Cout / C / E::kCols;
  for (int job = E::unit(); job < ((M2 + E::kRows - 1) / E::kRows) * groups_o;
       job += E::kUnits) {
    const int m0 = (job / groups_o) * E::kRows;
    const int n0 = (rank * groups_o + job % groups_o) * E::kCols;
    const T* a[E::kSlots];
    const T* xs[E::kSlots];  // the shortcut's pixel rows
    bool valid[E::kSlots];
    int64_t opix[E::kSlots];
    float om[E::kSlots];
#pragma unroll
    for (int s = 0; s < E::kSlots; ++s) {
      const int m = min(m0 + E::slot_row(s), M2 - 1);
      const int oh = oh0 + m / TT, ow = ow0 + m % TT;
      valid[s] = m0 + E::slot_row(s) < M2 && oh < Ho && ow < Wo;
      a[s] = E::lane_offset(y2s + m * pitch);
      // the strided projection samples x[s*oh, s*ow] (TPU kernel :75-77)
      xs[s] = args.x + pixel<FLAT>(n, valid[s] ? oh * S : 0,
                                   valid[s] ? ow * S : 0, H, W) * Cin;
      opix[s] = pixel<FLAT>(n, valid[s] ? oh : 0, valid[s] ? ow : 0, Ho, Wo);
      om[s] = FLAT && valid[s] ? args.mask[(oh + 1) * (Wo + 2) + ow + 1] : 1.f;
    }
    typename E::Acc acc;
    E::zero(acc);
    E::accumulate(acc, a, args.w3, P, Cout, n0, Cout);
    if (has_ds) {
      const T* xa[E::kSlots];
#pragma unroll
      for (int s = 0; s < E::kSlots; ++s) xa[s] = E::lane_offset(xs[s]);
      E::accumulate(acc, xa, args.wd, Cin, Cout, n0, Cout);
    }
    E::for_each(acc, n0, Cout, [&](int s, int c, float v) {
      if (!valid[s]) return;
      const int col = n0 + c;
      v += args.b3[col];
      if (has_ds)
        v += args.bd[col];
      else  // identity shortcut added in f32 (TPU kernel :88)
        v += to_f32(xs[s][col]);
      args.out[opix[s] * Cout + col] = from_f32<T>(fmaxf(v, 0.f) * om[s]);
    });
  }

  // ---- v2: the output border is zero, written by block 0 of each image
  // (tile 0, rank 0) ----
  if (FLAT && blockIdx.x == 0) write_flat_border(args.out, n, H, W, Cout);

  // No block leaves while a peer may still read its y2.
  if (C > 1) cg::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// bf16 engine.  Each stage is one product on the block's tensor cores: the
// 8 warps cover a BM x BN block tile (BM * BN = 8192), each warp 2 x 16
// rows by 4 x 8 channels on mma.sync m16n8k16 (bf16 in, f32 accumulate).
// Fragment layouts (PTX ISA, mma.m16n8k16): g = lane / 4, t = lane % 4;
//   A regs: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B regs: (k = 2t..2t+1, n = g), (k = 2t+8..2t+9, n = g)
//   C regs: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// ldmatrix.x4: lanes 8i..8i+7 give the row addresses of 8x8 matrix i, and
// register i of every lane receives matrix i in the A/B layout above
// (.trans: transposed).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMaxKC = 64;   // most weight rows a ring chunk
constexpr int kBNMax = 256;  // the widest block tile (BM = 32)
// The weight ring in shared memory, after y2, holds two chunks of 32 or
// kMaxKC weight rows at pitch BN + kPad.  It takes what the block's
// occupancy leaves of shared memory (ring_bytes), up to two kMaxKC-row
// chunks of the widest tile, and at least two 32-row ones: kRingBytes,
// which ops/cuda/fused_bottleneck.py mirrors as RING_BYTES.
constexpr int kRingBytes = 2 * 32 * (kBNMax + kPad) * 2;
constexpr int kSmemPerSM = 233472;  // 228 KB, 1 KB of it reserved a block
constexpr int kMaxSmem = 232448;    // the most one block may use

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16-byte global -> shared copy that skips L1; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four bf16 of a row in global memory: two A fragment registers.
__device__ __forceinline__ uint2 ld64(const bf16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Row of accumulator slot s (= M-tile * 2 + half) in a warp's 32 rows.
__device__ __forceinline__ int slot_row(int s) {
  return (s >> 1) * 16 + (s & 1) * 8 + (lane_id() >> 2);
}

// This lane's ldmatrix row in a 16 x 16 A tile (rows x k: matrices a0..a3
// = (rows 0-7, 8-15) x (k 0-7, 8-15), rows first), as (row, k offset).
__device__ __forceinline__ int a_row() { return lane_id() & 15; }
__device__ __forceinline__ int a_col() { return (lane_id() >> 4) * 8; }

// The block tile of a stage with M rows and N channels: the fewest
// m-blocks (each stages the weights again), then the least padded work,
// then the smaller BM.
struct Mode { int bm, bn; };
__device__ __forceinline__ Mode pick_mode(int m, int n) {
  Mode best = {0, 0};
  int best_blocks = 0, best_work = 0;
#pragma unroll
  for (int bm = 32; bm <= 256; bm *= 2) {
    const int bn = kThreads * 32 / bm;
    const int blocks = (m + bm - 1) / bm;
    const int work = blocks * bm * ((n + bn - 1) / bn) * bn;
    if (!best.bm || blocks < best_blocks ||
        (blocks == best_blocks && work < best_work)) {
      best = {bm, bn};
      best_blocks = blocks;
      best_work = work;
    }
  }
  return best;
}

// One stage's product over its M rows and N channels.  Its K is a list of
// segments (stage 1: x . W1; stage 2: the nine taps of y1 . W2; stage 3:
// y2 . W3, then x . Wd), each a row-major weight block of K_seg rows.  For
// each block tile the segments are walked in chunks of kc weight rows (64
// where the ring holds two such chunks of the tile's width, else 32): while
// the warps run a chunk from one half of the ring, the block's cp.async
// copy of the next fills the other (columns past N zero).  A deeper ring
// bought nothing on the card (PERF.md).  B comes by ldmatrix.x4.trans from the
// ring, A as the stage gives it: the stage supplies segments(), seg_k(s),
// seg_w(s) (the segment's weights, row pitch ldw()), from_x(s) (whether
// segment s reads A from x in global memory, in x_fragments' order of k),
// begin(m0) (a warp's 32 rows), load_a(s, k, af) (the A fragments of rows
// k .. k + 15 of segment s) and epilogue(m0, n0, N, acc).
struct Cursor {  // a chunk: segment and first weight row
  int seg, k0;
};

template <typename Stage>
__device__ __forceinline__ void advance(const Stage& st, Cursor& c, int kc) {
  c.k0 += kc;
  if (c.k0 >= st.seg_k(c.seg)) {
    ++c.seg;
    c.k0 = 0;
  }
}

template <typename Stage>
__device__ __forceinline__ void block_gemm(Stage& st, bf16* ring,
                                           int ring_bytes, int M, int N) {
  const Mode md = pick_mode(M, N);
  const int rp = md.bn + kPad, wcols = md.bn / 32;
  const int kc = ring_bytes >= 2 * kMaxKC * rp * 2 ? kMaxKC : 32;
  const int slot = kc * rp;  // elements a chunk
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int nseg = st.segments(), ldw = st.ldw();
  const int lg = __ffs(md.bn / 8) - 1;  // log2 of 16-byte pieces a row
  // This lane's ldmatrix.trans row in a 16 x 16 (k x n) tile of the ring:
  // matrices (k 0-7, 8-15) x (n 0-7, 8-15) in the order b0, b1 of the
  // first 8 channels, then of the next 8.  Row k of the tile is ring row
  // k, or for A from x ring row xk(k), x_fragments' order.
  const int bk = ((lane >> 3) & 1) * 8 + (lane & 7), bn = (lane >> 4) * 8;
  const int boff = bk * rp + bn;
  const int boff_x =
      (4 * ((bk & 7) >> 1) + 2 * (bk >> 3) + (bk & 1)) * rp + bn;

  for (int mb = 0; mb < M; mb += md.bm)
    for (int nb = 0; nb < N; nb += md.bn) {
      const int m0 = mb + (warp / wcols) * 32, n0 = nb + (warp % wcols) * 32;
      const bool active = m0 < M && n0 < N;
      Cursor in = {0, 0}, run = {0, 0};  // the next chunk to copy, to run
      int in_slot = 0, run_slot = 0;
      // Copy the chunk at `in` into its slot (an empty group past the end).
      auto copy_next = [&]() {
        if (in.seg < nseg) {
          const bf16* w = st.seg_w(in.seg) + (size_t)in.k0 * ldw + nb;
          bf16* dst = ring + in_slot * slot;
          const int pieces = min(kc, st.seg_k(in.seg) - in.k0) << lg;
          for (int i = threadIdx.x; i < pieces; i += kThreads) {
            const int r = i >> lg, col = (i & ((1 << lg) - 1)) * 8;
            const bool ok = nb + col < N;
            cp_async16(dst + r * rp + col, ok ? w + (size_t)r * ldw + col : w,
                       ok ? 16 : 0);
          }
          advance(st, in, kc);
          in_slot ^= 1;
        }
        cp_async_commit();
      };

      __syncthreads();  // the last tile's readers are done with the ring
      copy_next();
      if (active) st.begin(m0);
      float acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

      while (run.seg < nseg) {
        cp_async_wait<0>();
        __syncthreads();  // this chunk landed; the last one's slot is free
        copy_next();
        if (active) {
          const bf16* b = ring + run_slot * slot + (n0 - nb) +
                          (st.from_x(run.seg) ? boff_x : boff);
          const int rows = min(kc, st.seg_k(run.seg) - run.k0);
#pragma unroll
          for (int ks = 0; ks < kMaxKC / 16; ++ks) {
            if (ks * 16 >= rows) break;
            uint32_t af[2][4];
            st.load_a(run.seg, run.k0 + ks * 16, af);
#pragma unroll
            for (int j = 0; j < 4; j += 2) {
              if (n0 + j * 8 >= N) break;
              uint32_t bf[4];
              ldmatrix_x4_trans(bf, b + ks * 16 * rp + j * 8);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
                // past N when N % 16 == 8: zero B, and never stored
                mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
              }
            }
          }
        }
        advance(st, run, kc);
        run_slot ^= 1;
      }
      if (active) st.epilogue(m0, n0, N, acc);
    }
}

// The accumulator's elements (row slot s, channels col and col + 1) are
// acc[s >> 1][j][2 (s & 1)] and [.. + 1] with col = n0 + 8 j + 2t.
using Acc = float[2][4][4];

// y = relu(acc + bias) * keep[slot] as bf16 pairs into rows of shared
// memory (y1, y2); rows[slot] is null past the stage's rows.
__device__ __forceinline__ void store_pairs(const Acc& acc, int n0, int N,
                                            const float* bias,
                                            bf16* const (&rows)[4],
                                            const float (&keep)[4]) {
  const int t = lane_id() & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (n0 + j * 8 >= N) break;
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!rows[s]) continue;
      const float* v = &acc[s >> 1][j][2 * (s & 1)];
      *reinterpret_cast<__nv_bfloat162*>(rows[s] + col) =
          __floats2bfloat162_rn(fmaxf(v[0] + b.x, 0.f) * keep[s],
                                fmaxf(v[1] + b.y, 0.f) * keep[s]);
    }
  }
}

// The A fragments of a k16 step from four rows of x in global memory,
// one per slot (element offsets from x), at the lane's column 4t: one
// 8-byte load a row.  The
// lane's four channels k + 4t .. k + 4t + 3 stand in the fragment for the
// step's rows 2t, 2t + 1, 2t + 8, 2t + 9, so the products run over the
// step's rows in another order: row r of the step is channel xk(r) =
// 4 ((r & 7) >> 1) + 2 (r >> 3) + (r & 1), and B's rows follow
// (block_gemm's boff_x).
__device__ __forceinline__ void x_fragments(const bf16* x,
                                            const int (&rows)[4], int k,
                                            uint32_t (&af)[2][4]) {
  x += k + 4 * (lane_id() & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint2 g = ld64(x + rows[2 * i]), h = ld64(x + rows[2 * i + 1]);
    af[i][0] = g.x;
    af[i][1] = h.x;
    af[i][2] = g.y;
    af[i][3] = h.y;
  }
}

// Stage 1: y1 = relu(x . W1 + b1) on the halo, zero where conv2 pads.  A
// rows are halo pixels of x in global memory, read by each lane.
template <bool FLAT>
struct Stage1 {
  const Args<bf16> a;
  bf16* y1s;
  int pitch, n, hh0, ww0, HS, M;
  const bf16* xn;  // image n of x
  int xr[4];       // the lane's x rows, element offsets from xn
  float keep[4];

  __device__ int segments() const { return 1; }
  __device__ int seg_k(int) const { return a.cin; }
  __device__ const bf16* seg_w(int) const { return a.w1; }
  __device__ int ldw() const { return a.p; }
  __device__ bool from_x(int) const { return true; }
  __device__ void begin(int m0) {
    const int H = a.h, W = a.w;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int m = m0 + slot_row(s);
      const int hh = hh0 + m / HS, ww = ww0 + m % HS;
      bool ok;
      if (FLAT)  // every position of the padded plane is readable
        ok = m < M && hh >= -1 && hh <= H && ww >= -1 && ww <= W;
      else
        ok = m < M && hh >= 0 && hh < H && ww >= 0 && ww < W;
      xr[s] = pixel<FLAT>(0, ok ? hh : 0, ok ? ww : 0, H, W) * a.cin;
      if (FLAT)
        keep[s] = ok ? a.mask[(hh + 1) * (W + 2) + ww + 1] : 0.f;
      else
        keep[s] = ok ? 1.f : 0.f;
    }
  }
  __device__ void load_a(int, int k, uint32_t (&af)[2][4]) const {
    x_fragments(xn, xr, k, af);
  }
  __device__ void epilogue(int m0, int n0, int N, const Acc& acc) const {
    bf16* rows[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int m = m0 + slot_row(s);
      rows[s] = m < M ? y1s + m * pitch : nullptr;
    }
    store_pairs(acc, n0, N, a.b1, rows, keep);
  }
};

// Stage 2: y2 = relu(conv3x3_s(y1) + b2), the nine taps one after the
// other; A rows are gathered from y1 in shared memory by ldmatrix.
struct Stage2 {
  const Args<bf16> a;
  const bf16* y1s;
  bf16* y2s;
  int pitch, TT, HS, M;
  int ar[2];  // the lane's ldmatrix row of each M-tile

  __device__ int segments() const { return 9; }
  __device__ int seg_k(int) const { return a.p; }
  __device__ const bf16* seg_w(int tap) const {
    return a.w2 + (size_t)tap * a.p * a.p;
  }
  __device__ int ldw() const { return a.p; }
  __device__ bool from_x(int) const { return false; }
  __device__ void begin(int m0) {
    const int S = a.stride;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = min(m0 + i * 16 + a_row(), M - 1);
      ar[i] = ((m / TT) * S * HS + (m % TT) * S) * pitch + a_col();
    }
  }
  __device__ void load_a(int tap, int k, uint32_t (&af)[2][4]) const {
    const int off = ((tap / 3) * HS + tap % 3) * pitch + k;
#pragma unroll
    for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], y1s + ar[i] + off);
  }
  __device__ void epilogue(int m0, int n0, int N, const Acc& acc) const {
    bf16* rows[4];
    const float keep[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int m = m0 + slot_row(s);
      rows[s] = m < M ? y2s + m * pitch : nullptr;
    }
    store_pairs(acc, n0, N, a.b2, rows, keep);
  }
};

// Stage 3: out = relu(y2 . W3 + b3 + shortcut).  y2's rows come from
// shared memory by ldmatrix, then the projection's strided x rows (TPU
// kernel :75-77) from global memory, read by each lane.
template <bool FLAT>
struct Stage3 {
  const Args<bf16> a;
  const bf16* y2s;
  int pitch, n, oh0, ow0, TT, M;
  const bf16* xn;     // image n of x
  bf16* on;           // image n of out
  int ar[2];          // the lane's ldmatrix row of each M-tile
  int xs[4];          // the shortcut's x row of each slot, from xn

  __device__ int segments() const { return a.wd ? 2 : 1; }
  __device__ int seg_k(int s) const { return s ? a.cin : a.p; }
  __device__ const bf16* seg_w(int s) const { return s ? a.wd : a.w3; }
  __device__ int ldw() const { return a.cout; }
  __device__ bool from_x(int s) const { return s == 1; }
  __device__ bool valid(int m, int& oh, int& ow) const {
    oh = oh0 + m / TT;
    ow = ow0 + m % TT;
    return m < M && oh < a.h / a.stride && ow < a.w / a.stride;
  }
  __device__ void begin(int m0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ar[i] = min(m0 + i * 16 + a_row(), M - 1) * pitch + a_col();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      int oh, ow;
      const bool ok = valid(m0 + slot_row(s), oh, ow);
      xs[s] = pixel<FLAT>(0, ok ? oh * a.stride : 0, ok ? ow * a.stride : 0,
                          a.h, a.w) * a.cin;
    }
  }
  __device__ void load_a(int seg, int k, uint32_t (&af)[2][4]) const {
    if (seg == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], y2s + ar[i] + k);
    } else {
      x_fragments(xn, xs, k, af);
    }
  }
  __device__ void epilogue(int m0, int n0, int N, const Acc& acc) const {
    const int Ho = a.h / a.stride, Wo = a.w / a.stride;
    const int t = lane_id() & 3;
    int out[4];  // each slot's output pixel from on, -1 where it is none
    float om[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      int oh, ow;
      const bool ok = valid(m0 + slot_row(s), oh, ow);
      out[s] = ok ? pixel<FLAT>(0, oh, ow, Ho, Wo) * a.cout : -1;
      om[s] = FLAT && ok ? a.mask[(oh + 1) * (Wo + 2) + ow + 1] : 1.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (n0 + j * 8 >= N) break;
      const float2 b = *reinterpret_cast<const float2*>(a.b3 + col);
      const float2 d = a.wd ? *reinterpret_cast<const float2*>(a.bd + col)
                            : make_float2(0.f, 0.f);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (out[s] < 0) continue;
        const float* v = &acc[s >> 1][j][2 * (s & 1)];
        float v0 = v[0] + b.x, v1 = v[1] + b.y;
        if (a.wd) {
          v0 += d.x;
          v1 += d.y;
        } else {  // identity shortcut added in f32 (TPU kernel :88)
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xn + xs[s] + col));
          v0 += x.x;
          v1 += x.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(on + out[s] + col) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f) * om[s],
                                  fmaxf(v1, 0.f) * om[s]);
      }
    }
  }
};

template <bool FLAT>
__global__ void __launch_bounds__(kThreads, 2)
bottleneck_mma_kernel(const Args<bf16> args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = args.stride, TT = args.tile;
  const int pitch = args.p + kPad;
  const int HS = (TT - 1) * S + 3;  // halo side
  const int tiles_w = (args.w / S + TT - 1) / TT;
  const int oh0 = (blockIdx.x / tiles_w) * TT;
  const int ow0 = (blockIdx.x % tiles_w) * TT;
  const int n = blockIdx.y;
  const int M1 = HS * HS, M2 = TT * TT;

  bf16* y1s = reinterpret_cast<bf16*>(smem_raw);  // [HS * HS][pitch]
  bf16* y2s = y1s + M1 * pitch;                    // [TT * TT][pitch]
  bf16* ring = y2s + M2 * pitch;                   // args.ring bytes

  // Each block_gemm starts with a barrier, so a stage sees all of the
  // last stage's stores.
  const bf16* xn = image<FLAT>(args.x, n, args.h, args.w, args.cin);
  Stage1<FLAT> s1{args, y1s, pitch, n, oh0 * S - 1, ow0 * S - 1, HS, M1, xn};
  block_gemm(s1, ring, args.ring, M1, args.p);
  Stage2 s2{args, y1s, y2s, pitch, TT, HS, M2};
  block_gemm(s2, ring, args.ring, M2, args.p);
  Stage3<FLAT> s3{args, y2s, pitch, n, oh0, ow0, TT, M2, xn,
                  image<FLAT>(args.out, n, args.h / S, args.w / S, args.cout)};
  block_gemm(s3, ring, args.ring, M2, args.cout);

  // ---- v2: the output border is zero, written by each image's tile 0 ----
  if (FLAT && blockIdx.x == 0) write_flat_border(args.out, n, args.h, args.w,
                                                 args.cout);
}

// Shared memory of y1 on the halo and the y2 tile.
template <typename T>
size_t tile_smem(const Args<T>& a) {
  const int HS = (a.tile - 1) * a.stride + 3;
  return (size_t)(HS * HS + a.tile * a.tile) * (a.p + kPad) * sizeof(T);
}

// The weight ring beside y1 and y2 of `base` bytes: the rest of half an
// SM where two blocks fit with a kRingBytes ring (the budget pick_tile
// counts), else the rest of what one block may use; at most two kMaxKC-row
// chunks of the widest tile.
int ring_bytes(size_t base) {
  const size_t most = (size_t)2 * kMaxKC * (kBNMax + kPad) * 2;
  const size_t two = kSmemPerSM / 2 - 1024;
  const size_t room = base + kRingBytes <= two ? two - base : kMaxSmem - base;
  return (int)(room < most ? room & ~(size_t)15 : most);
}

// Launch one block per output tile of each image (a cluster of
// a.cluster blocks per tile where it is more than 1), with y1 and y2
// (and, for bf16, the weight ring) in dynamic shared memory.
template <typename T, typename Kernel>
int launch(Kernel kernel, const Args<T>& a, int n, cudaStream_t stream) {
  const int S = a.stride, Ho = a.h / S, Wo = a.w / S;
  const size_t smem = tile_smem(a) + a.ring;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles =
      ((Ho + a.tile - 1) / a.tile) * ((Wo + a.tile - 1) / a.tile);
  if (a.cluster == 1) {
    kernel<<<dim3(tiles, n), kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.cluster, n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* w3,
                  const void* b3, const void* wd, const void* bd,
                  const void* mask, void* out, int h, int w, int cin, int p,
                  int cout, int stride, int tile, int cluster) {
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.w1 = static_cast<const T*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const T*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.w3 = static_cast<const T*>(w3);
  a.b3 = static_cast<const float*>(b3);
  a.wd = static_cast<const T*>(wd);
  a.bd = static_cast<const float*>(bd);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<T*>(out);
  a.h = h; a.w = w; a.cin = cin; a.p = p; a.cout = cout;
  a.stride = stride; a.tile = tile;
  a.cluster = cluster;
  a.ring = 0;
  return a;
}

template <bool FLAT>
int dispatch(int dtype, const void* x, const void* w1, const void* b1,
             const void* w2, const void* b2, const void* w3, const void* b3,
             const void* wd, const void* bd, const void* mask, void* out,
             int n, int h, int w, int cin, int p, int cout, int stride,
             int tile, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    // a block's channel slices are whole RN-wide groups (and 16 bytes)
    const int rn = ScalarEngine::kCols;
    if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
        p % (rn * cluster) || cout % (rn * cluster))
      return (int)cudaErrorInvalidValue;
    return launch(bottleneck_kernel<ScalarEngine, FLAT>,
                  make_args<float>(x, w1, b1, w2, b2, w3, b3, wd, bd, mask,
                                   out, h, w, cin, p, cout, stride, tile,
                                   cluster),
                  n, s);
  }
  if (dtype == 1) {
    if (cluster != 1) return (int)cudaErrorInvalidValue;  // f32 only
    Args<bf16> a = make_args<bf16>(x, w1, b1, w2, b2, w3, b3, wd, bd, mask,
                                   out, h, w, cin, p, cout, stride, tile, 1);
    a.ring = ring_bytes(tile_smem(a));
    return launch(bottleneck_mma_kernel<FLAT>, a, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  wd and bd are null for an identity
// shortcut.  cluster: blocks that split each tile's channels, 1, 2, 4 or
// 8 for float32 (P and Cout multiples of 4 * cluster), 1 for bfloat16.
// Returns the cudaError_t of the launch.
int fused_bottleneck_launch(int dtype, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* w3, const void* b3, const void* wd,
                            const void* bd, void* out, int n, int h, int w,
                            int cin, int p, int cout, int stride, int tile,
                            int cluster, void* stream) {
  return dispatch<false>(dtype, x, w1, b1, w2, b2, w3, b3, wd, bd, nullptr,
                         out, n, h, w, cin, p, cout, stride, tile, cluster,
                         stream);
}

// x and out are (N, (H+2)*(W+2), C) with zero borders; stride 1.
int fused_bottleneck_flat_launch(int dtype, const void* x, const void* mask,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2,
                                 const void* w3, const void* b3,
                                 const void* wd, const void* bd, void* out,
                                 int n, int h, int w, int cin, int p,
                                 int cout, int tile, int cluster,
                                 void* stream) {
  return dispatch<true>(dtype, x, w1, b1, w2, b2, w3, b3, wd, bd, mask, out,
                        n, h, w, cin, p, cout, 1, tile, cluster, stream);
}

// How many clusters of `cluster` f32 blocks (v1, or v2 with flat = 1) of
// `smem` bytes of dynamic shared memory the card holds at once
// (cudaOccupancyMaxActiveClusters); -(cudaError_t) on failure.
int fused_bottleneck_max_clusters(int flat, int cluster, int smem) {
  const void* kernel =
      flat ? (const void*)bottleneck_kernel<ScalarEngine, true>
           : (const void*)bottleneck_kernel<ScalarEngine, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : count;
}

const char* fused_bottleneck_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
