// Fused multi-head attention for Hopper (sm_90a).
//
// Replaces pvr_habitat_tpu/ops/pallas/attention.py::fused_attention: the
// non-causal core softmax(Q K^T / sqrt(D)) V of the ViT encoders, for
// q, k, v, out of shape (N, H, L, D), with the TPU kernel's rounding points
//
//   s   = (q . k^T) * (1 / sqrt(D))             f32
//   p   = exp(s - max_row(s)) / sum_row(...)     f32, then rounded to q's type
//   out = p . v                                  f32 accumulate, q's type
//
// What bounds it on the H100: at mae_base batch 256 in bf16 one launch must
// move q, k, v and out once, 4 * N*H*L*D * 2 B = 310 MB (0.093 ms at
// 3.35 TB/s), and do 4 * N*H*L^2*D = 30.5 GFLOP (0.031 ms at 989 TFLOP/s):
// it is bound by bytes.  The (L, L) scores (477 MB in f32 at that shape)
// must therefore never reach device memory, and K and V should be read
// from device memory once per head.
//
// bf16 engine (the main path).  One block per (image, head): it stages the
// head's K and V in shared memory once (row pitch D + 8, so ldmatrix is
// conflict-free; 30 KB each at L = 197, D = 64), by cp.async 16-byte copies
// in two commit groups, K's then V's, so V lands while the first query
// tiles run QK^T and the softmax.  Its warps walk the head's 16-row query
// tiles.  A warp
//   1. computes the whole row of scores of its 16 rows with mma.sync
//      m16n8k16 (K fragments by ldmatrix) and keeps them in registers:
//      L_pad / 2 floats a thread, 104 at L = 197 and 136 at L = 257;
//   2. takes the row max and the row sum (one quad shuffle reduction
//      each), with e = exp2(s * log2(e)/sqrt(D) - max * log2(e)/sqrt(D))
//      (ex2.approx: one MUFU op per score) and one reciprocal per row;
//   3. rounds p = e * (1 / sum) to bf16 in place: a C tile of the scores is
//      the A fragment of p . V, so p never leaves registers;
//   4. runs p . V (V fragments by ldmatrix.trans) and stores its rows.
// So QK^T runs once and p is normalised before it is rounded, as on the
// TPU (a flash-style "divide after p . V" kernel computes something else).
// exp2 with the folded scale and the reciprocal move e and p by a few f32
// ulps before p's bf16 rounding; the bf16 gate (one bf16 ulp of the
// output) holds that unchanged.  The kernel is templated on the 16-key
// tiles a row keeps in registers (KT = 8, 13, 17: L <= 128, 208, 272; the
// MAE lengths 197 and 257 fill 13 and 17 exactly).  A longer row takes two
// passes over the keys with the same feeds: row max and rescaled sum, then
// the scores again (the same instructions, so the same bits), p and p . V.
// Ragged L: keys past L are -inf, K/V rows past L are zero in shared
// memory (cp.async zero-fill), query rows past L are read as zero and
// never stored.  D = 16 * DK, DK = 1..8, is a template.
//
// f32 engine (the parity path; TF32 would break its 1e-5): scalar FMAs, one
// block per (image, head, 64 query rows), a warp walks 8 query rows one at
// a time, lanes split the keys for the scores and the channels for p . V.
//
// Strides are in elements and D's stride is 1, so a caller can pass
// (N, L, H, D)-ordered views of a fused qkv projection without copies.
//
// Measured on an H100 80GB HBM3 at 700 W, batch 256 on the strided qkv
// views (pvr_habitat_tpu_torch/tools/attention_tilings.py, and builds of
// this source with other values of kWarpsMma and kMinBlocksMma): 0.19 ms a
// launch at mae_base against SDPA's 0.17 and the earlier two-pass
// kernel's 0.88; 0.51 ms at mae_huge against SDPA's 0.60.  That is twice
// the byte bound, and no one part holds it there: variants that leave out
// the QK^T products, the p . V products, the K/V loads or the
// exponentials are 18%, 11%, 11% and 2% faster.  4 warps a block with 3
// blocks an SM (168 registers) beat 5 or 6 warps with 2 blocks and 8
// warps with 1; sharing the 13th query tile among the warps, tree-shaped
// row reductions and wgmma (m64n16k16) for both products did not help.
// PERF.md has the numbers.
//
// Plain C interface, loaded with ctypes: the launcher returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsBlock = 64;   // query rows per block, f32 engine
// Tiling of the bf16 engine: warps a block, and blocks an SM that
// __launch_bounds__ asks for (rows of up to 13 key tiles, and two passes).
constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;
constexpr int kMinBlocksMma = 3;
// A row of 17 key tiles holds 136 scores a thread: leave it ~176 registers.
constexpr int kMinBlocksLong =
    65536 / (kThreadsMma * 176) > 0 ? 65536 / (kThreadsMma * 176) : 1;
constexpr int kPadMma = 8;       // bf16 shared-memory row pitch is D + 8
// Blocks an SM holds (65536 registers, 228 KB of shared memory with 1 KB
// reserved a block) asked of __launch_bounds__ for a row of KT held tiles:
// no more than the shared memory of 16 * KT rows of K and V allows.
constexpr int min_blocks(int kt, int d) {
  const int want = kt > 13 ? kMinBlocksLong : kMinBlocksMma;
  const int fit = kt ? 233472 / (4 * 16 * kt * (d + kPadMma) + 1024) : want;
  return fit < 1 ? 1 : fit < want ? fit : want;
}
constexpr int kThreadsF32 = 256; // 8 warps x 8 rows
constexpr int kWarpsF32 = kThreadsF32 / 32;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long n, h, l;
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  Strides sq, sk, sv, so;
  int l, d;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 engine.  mma.m16n8k16 fragment layouts (PTX ISA): g = lane / 4,
// t = lane % 4;
//   A regs: (g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..)
//   B regs: (k = 2t..2t+1, n = g), (k = 2t+8..2t+9, n = g)
//   C regs: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// The C tiles of the scores for keys 16kt..16kt+7 and 16kt+8..16kt+15 are
// together the A fragment of p for those 16 keys in p . V.
// ldmatrix.x4: lanes 8i..8i+7 give the row addresses of 8x8 matrix i, and
// register i of every lane receives matrix i in the A/B layout above
// (.trans: transposed).
// ---------------------------------------------------------------------------

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

// 2^x in one MUFU op; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp(s_old - s_new) for unscaled maxima, with "no key seen yet" (-inf)
// giving 0.
__device__ __forceinline__ float rescale(float m, float m_new, float c) {
  return m == -INFINITY ? 0.f : exp2_approx((m - m_new) * c);
}

// Rows 0 .. lp-1 of one head's K or V into shared memory at pitch D + 8,
// rows past L zero.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ld, int L, int lp) {
  constexpr int kChunks = D / 8, P = D + kPadMma;
  for (int i = threadIdx.x; i < lp * kChunks; i += kThreadsMma) {
    const int row = i / kChunks, c = (i % kChunks) * 8;
    const bool in = row < L;
    cp_async16(dst + row * P + c, in ? src + row * ld + c : src, in ? 16 : 0);
  }
}

// KT > 0: a row of up to 16 * KT keys is held in registers, one QK^T pass.
// KT = 0: any length, two passes over the keys.
template <int DK, int KT>
__global__ void __launch_bounds__(kThreadsMma, min_blocks(KT, 16 * DK))
attention_mma_kernel(const Args<__nv_bfloat16> args) {
  using T = __nv_bfloat16;
  constexpr int D = 16 * DK, DN = 2 * DK, P = D + kPadMma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = args.l, nkt = (L + 15) >> 4;  // 16-row / 16-key tiles
  const int rows = KT > 0 ? 16 * KT : 16 * nkt;  // K and V rows staged
  const int head = blockIdx.x, n = blockIdx.y;
  T* ks = reinterpret_cast<T*>(smem_raw);  // [rows][P]
  T* vs = ks + rows * P;                   // [rows][P]

  stage_rows<D>(ks, args.k + n * args.sk.n + head * args.sk.h, args.sk.l, L,
                rows);
  cp_async_commit();
  stage_rows<D>(vs, args.v + n * args.sv.n + head * args.sv.h, args.sv.l, L,
                rows);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // This lane's ldmatrix row in a 16 x 16 tile of K (keys x channels:
  // matrices (keys 0-7, 8-15) x (channels 0-7, 8-15) in the order b0, b1 of
  // the first 8 keys, then of the next 8) and of V (.trans, the order b0,
  // b1 of channels 0-7, then of channels 8-15).
  const T* kl = ks + ((lane >> 4) * 8 + (lane & 7)) * P + ((lane >> 3) & 1) * 8;
  const T* vl = vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * P + (lane >> 4) * 8;
  const T* qg = args.q + n * args.sq.n + head * args.sq.h + 2 * t;
  T* og = args.out + n * args.so.n + head * args.so.h + 2 * t;
  const float c = args.scale * kLog2e;  // exp(x * scale) = 2^(x * c)

  // The A fragments of query rows r + g and r + g + 8; zero past L.
  auto load_q = [&](uint32_t(&f)[DK][4], int r) {
    const int ra = r + g, rb = ra + 8;
    const unsigned* qa = reinterpret_cast<const unsigned*>(
        qg + (long long)min(ra, L - 1) * args.sq.l);
    const unsigned* qb = reinterpret_cast<const unsigned*>(
        qg + (long long)min(rb, L - 1) * args.sq.l);
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      f[kk][0] = ra < L ? __ldg(qa + 8 * kk) : 0u;
      f[kk][1] = rb < L ? __ldg(qb + 8 * kk) : 0u;
      f[kk][2] = ra < L ? __ldg(qa + 8 * kk + 4) : 0u;
      f[kk][3] = rb < L ? __ldg(qb + 8 * kk + 4) : 0u;
    }
  };

  uint32_t qf[DK][4];
  load_q(qf, 16 * warp);

  // Unscaled scores of keys 16kt .. 16kt+7 (s[0]) and 16kt+8 .. 16kt+15
  // (s[1]).
  auto qk_tile = [&](int kt, float(&s)[2][4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = 0.f;
    const T* kr = kl + kt * 16 * P;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, kr + 16 * kk);
      mma_bf16(s[0], qf[kk], b[0], b[1]);
      mma_bf16(s[1], qf[kk], b[2], b[3]);
    }
  };
  // Keys past L to -inf, in a tile that reaches past L.
  auto mask_tile = [&](int kt, float(&s)[2][4]) {
    if (16 * kt + 16 > L) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (16 * kt + 8 * h + 2 * t + (e & 1) >= L) s[h][e] = -INFINITY;
    }
  };

  // o += p . V for keys 16kt .. 16kt+15; pf is p's A fragment.
  auto pv_tile = [&](int kt, const uint32_t(&pf)[4], float(&o)[DN][4]) {
    const T* vr = vl + kt * 16 * P;
#pragma unroll
    for (int dk = 0; dk < DK; ++dk) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vr + 16 * dk);
      mma_bf16(o[2 * dk], pf, b[0], b[1]);
      mma_bf16(o[2 * dk + 1], pf, b[2], b[3]);
    }
  };

  cp_async_wait<1>();
  __syncthreads();  // K is in shared memory

  for (int tile = warp;; tile += kWarpsMma) {
    const bool have = tile < nkt;
    // [0] is row g of the tile, [1] row g + 8.
    float mc[2], inv[2];  // row max times c, 1 / row sum
    uint32_t pf[KT > 0 ? KT : 1][4];
    if (have) {
      if constexpr (KT > 0) {
        // All KT tiles, with no branch between their products (a guard
        // per tile serialises each tile's chain of mma and keeps a tile
        // that may be undefined live beside its packed p).  Rows past L are
        // zero in shared memory, and their keys are masked after the
        // products.
        float s[KT][2][4];
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) qk_tile(kt, s[kt]);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) mask_tile(kt, s[kt]);
        float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              m[e >> 1] = fmaxf(m[e >> 1], s[kt][h][e]);
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) mc[r] = quad_max(m[r]) * c;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[kt][h][e] = exp2_approx(fmaf(s[kt][h][e], c, -mc[e >> 1]));
              sum[e >> 1] += s[kt][h][e];
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(sum[r]);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              pf[kt][2 * h + r] = pack_bf16(s[kt][h][2 * r] * inv[r],
                                            s[kt][h][2 * r + 1] * inv[r]);
      } else {
        // Pass 1: running row max and rescaled row sum, then merge the
        // quad's keys.
        float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
        for (int kt = 0; kt < nkt; ++kt) {
          float s[2][4];
          qk_tile(kt, s);
          mask_tile(kt, s);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn =
                fmaxf(fmaxf(m[r], fmaxf(s[0][2 * r], s[0][2 * r + 1])),
                      fmaxf(s[1][2 * r], s[1][2 * r + 1]));
            if (mn == -INFINITY) continue;
            const float nc = -mn * c;
            sum[r] = sum[r] * rescale(m[r], mn, c) +
                     exp2_approx(fmaf(s[0][2 * r], c, nc)) +
                     exp2_approx(fmaf(s[0][2 * r + 1], c, nc)) +
                     exp2_approx(fmaf(s[1][2 * r], c, nc)) +
                     exp2_approx(fmaf(s[1][2 * r + 1], c, nc));
            m[r] = mn;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
            const float so = __shfl_xor_sync(0xffffffffu, sum[r], off);
            const float mn = fmaxf(m[r], mo);
            sum[r] = sum[r] * rescale(m[r], mn, c) + so * rescale(mo, mn, c);
            m[r] = mn;
          }
          mc[r] = m[r] * c;
          inv[r] = 1.f / sum[r];
        }
      }
    }
    if (tile == warp) {  // every warp's first iteration: V has landed
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!have) break;

    // The next tile's query rows load under this tile's p . V.
    const int next = tile + kWarpsMma;
    uint32_t qn[DK][4];
    if (next < nkt) load_q(qn, 16 * next);

    float o[DN][4];
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    if constexpr (KT > 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) pv_tile(kt, pf[kt], o);
    } else {
      // Pass 2: the scores again, p = e / sum rounded to bf16, p . V.
      for (int kt = 0; kt < nkt; ++kt) {
        float s[2][4];
        qk_tile(kt, s);
        mask_tile(kt, s);
        uint32_t p[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            p[2 * h + r] = pack_bf16(
                exp2_approx(fmaf(s[h][2 * r], c, -mc[r])) * inv[r],
                exp2_approx(fmaf(s[h][2 * r + 1], c, -mc[r])) * inv[r]);
        pv_tile(kt, p, o);
      }
    }

    const int ra = 16 * tile + g, rb = ra + 8;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      if (ra < L)
        *reinterpret_cast<__nv_bfloat162*>(og + ra * args.so.l + dn * 8) =
            __floats2bfloat162_rn(o[dn][0], o[dn][1]);
      if (rb < L)
        *reinterpret_cast<__nv_bfloat162*>(og + rb * args.so.l + dn * 8) =
            __floats2bfloat162_rn(o[dn][2], o[dn][3]);
    }
    if (next < nkt) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[kk][e] = qn[kk][e];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 engine (parity path).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreadsF32)
attention_f32_kernel(const Args<float> args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = args.l, D = args.d, P = D + 1;  // odd pitch: no conflicts
  const int head = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ks = reinterpret_cast<float*>(smem_raw);  // [L][P]
  float* vs = ks + L * P;                          // [L][P]
  float* qs = vs + L * P + warp * D;               // [warps][D]
  float* ps = vs + L * P + kWarpsF32 * D + warp * L;  // [warps][L]

  {
    const float* kg = args.k + n * args.sk.n + head * args.sk.h;
    const float* vg = args.v + n * args.sv.n + head * args.sv.h;
    for (int i = threadIdx.x; i < L * D; i += kThreadsF32) {
      const int row = i / D, c = i % D;
      ks[row * P + c] = kg[row * args.sk.l + c];
      vs[row * P + c] = vg[row * args.sv.l + c];
    }
  }
  __syncthreads();

  const float* qg = args.q + n * args.sq.n + head * args.sq.h;
  float* og = args.out + n * args.so.n + head * args.so.h;
  for (int r = warp; r < kRowsBlock; r += kWarpsF32) {
    const int row = blockIdx.x * kRowsBlock + r;
    if (row >= L) break;
    for (int c = lane; c < D; c += 32) qs[c] = qg[row * args.sq.l + c];
    __syncwarp();
    float m = -INFINITY;
    for (int key = lane; key < L; key += 32) {
      const float* kr = ks + key * P;
      float acc = 0.f;
      for (int c = 0; c < D; ++c) acc = fmaf(qs[c], kr[c], acc);
      const float s = acc * args.scale;
      ps[key] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int key = lane; key < L; key += 32) {
      const float e = expf(ps[key] - m);
      ps[key] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int key = lane; key < L; key += 32) ps[key] = ps[key] / sum;
    __syncwarp();
    for (int c = lane; c < D; c += 32) {
      float acc = 0.f;
      for (int key = 0; key < L; ++key) acc = fmaf(ps[key], vs[key * P + c], acc);
      og[row * args.so.l + c] = acc;
    }
    __syncwarp();  // qs and ps are rewritten by the next row
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The 16-key tiles a row of L keys keeps in registers (0: two passes).
int held_tiles(int l) {
  const int nkt = (l + 15) / 16;
  return nkt <= 8 ? 8 : nkt <= 13 ? 13 : nkt <= 17 ? 17 : 0;
}

size_t smem_mma(int l, int d) {
  const int kt = held_tiles(l);
  const size_t rows = kt ? 16 * kt : (l + 15) & ~15;
  return 2 * rows * (d + kPadMma) * sizeof(__nv_bfloat16);
}

size_t smem_f32(int l, int d) {
  return ((size_t)2 * l * (d + 1) + (size_t)kWarpsF32 * (d + l)) *
         sizeof(float);
}

template <typename Kernel, typename A>
int launch(Kernel kernel, const A& a, size_t smem, dim3 grid,
           cudaStream_t stream, int threads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v, void* out,
                  const long long* st, int l, int d, float scale) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.out = static_cast<T*>(out);
  a.sq = {st[0], st[1], st[2]};
  a.sk = {st[3], st[4], st[5]};
  a.sv = {st[6], st[7], st[8]};
  a.so = {st[9], st[10], st[11]};
  a.l = l;
  a.d = d;
  a.scale = scale;
  return a;
}

template <int DK, int KT>
int launch_mma_kt(const Args<__nv_bfloat16>& a, int n, int h,
                  cudaStream_t s) {
  return launch(attention_mma_kernel<DK, KT>, a, smem_mma(a.l, a.d),
                dim3(h, n), s, kThreadsMma);
}

template <int DK>
int launch_mma(const Args<__nv_bfloat16>& a, int n, int h, cudaStream_t s) {
  switch (held_tiles(a.l)) {
    case 8: return launch_mma_kt<DK, 8>(a, n, h, s);
    case 13: return launch_mma_kt<DK, 13>(a, n, h, s);
    case 17: return launch_mma_kt<DK, 17>(a, n, h, s);
    default: return launch_mma_kt<DK, 0>(a, n, h, s);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (n, h, l)
// of q, k, v and out in that order; D's stride is 1.  D is a multiple of 16
// up to 128.  Returns the cudaError_t of the launch.
int fused_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, const long long* strides,
                           int n, int h, int l, int d, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > 128 || d % 16 || l <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(attention_f32_kernel,
                  make_args<float>(q, k, v, out, strides, l, d, scale),
                  smem_f32(l, d), dim3((l + kRowsBlock - 1) / kRowsBlock, h, n),
                  s, kThreadsF32);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const Args<__nv_bfloat16> a =
      make_args<__nv_bfloat16>(q, k, v, out, strides, l, d, scale);
  switch (d / 16) {
    case 1: return launch_mma<1>(a, n, h, s);
    case 2: return launch_mma<2>(a, n, h, s);
    case 3: return launch_mma<3>(a, n, h, s);
    case 4: return launch_mma<4>(a, n, h, s);
    case 5: return launch_mma<5>(a, n, h, s);
    case 6: return launch_mma<6>(a, n, h, s);
    case 7: return launch_mma<7>(a, n, h, s);
    default: return launch_mma<8>(a, n, h, s);
  }
}

// Shared memory one launch asks for, so the caller can refuse a shape.
long long fused_attention_smem_bytes(int dtype, int l, int d) {
  return (long long)(dtype == 0 ? smem_f32(l, d) : smem_mma(l, d));
}

const char* fused_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
