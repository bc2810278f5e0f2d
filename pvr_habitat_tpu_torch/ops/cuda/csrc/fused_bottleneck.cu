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
// memory; stage 3 walks Cout and adds the shortcut.  Weights stream from
// global memory through L1/L2.
//
// Each stage is a product whose A rows are gathered (halo positions, the
// nine taps, strided pixels), so every thread keeps a pointer per row it
// owns.  Two engines run the products:
//   bf16: warp-level tensor-core MMA (mma.sync m16n8k16, f32 accumulate);
//         a warp owns MT x 16 rows by NT x 8 channels, and each thread
//         loads its fragment elements straight from its rows;
//   f32:  scalar FMAs from a register tile of RM rows x RN channels per
//         thread (the f32 parity path; TF32 would break its tolerance).
// wgmma, TMA and staged weight tiles are later work.
//
// v2 runs the same device code with FLAT=true: the input carries a zero
// border, y1 and the output are multiplied by the mask (the TPU kernel's
// :172 and :196), and the output border is written as zero so blocks
// chain without re-padding.
//
// Shared-memory rows are P + 8 elements apart, so the eight rows of an
// MMA fragment fall on distinct banks.
//
// Plain C interface, loaded with ctypes: each launcher returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    for (int k = 0; k < K; k += 4) {
      float4 av[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        av[r] = *reinterpret_cast<const float4*>(a[r] + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 bq =
            __ldg(reinterpret_cast<const float4*>(b + (size_t)(k + kk) * ldb));
        const float bv[RN] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float x = kk == 0 ? av[r].x : kk == 1 ? av[r].y
                        : kk == 2 ? av[r].z : av[r].w;
#pragma unroll
          for (int c = 0; c < RN; ++c) acc.v[r][c] = fmaf(x, bv[c], acc.v[r][c]);
        }
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

// ---------------------------------------------------------------------------
// bf16 engine: each warp owns MT x 16 rows x NT x 8 channels of a job and
// runs mma.sync m16n8k16 (bf16 in, f32 accumulate).  Fragment layouts
// (PTX ISA, mma.m16n8k16): g = lane / 4, t = lane % 4;
//   A regs: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B regs: (k = 2t..2t+1, n = g), (k = 2t+8..2t+9, n = g)
//   C regs: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// ---------------------------------------------------------------------------

struct MmaEngine {
  static constexpr int MT = 2, NT = 4;
  static constexpr int kRows = MT * 16, kCols = NT * 8, kSlots = MT * 2;
  static constexpr int kUnits = kThreads / 32;
  using T = __nv_bfloat16;
  struct Acc { float v[MT][NT][4]; };

  __device__ static int lane() { return threadIdx.x & 31; }
  __device__ static int unit() { return threadIdx.x >> 5; }
  // slot s = mt * 2 + half: row mt * 16 + half * 8 + g
  __device__ static int slot_row(int s) {
    return (s >> 1) * 16 + (s & 1) * 8 + (lane() >> 2);
  }
  __device__ static const T* lane_offset(const T* row) {
    return row + 2 * (lane() & 3);
  }
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
  }

  __device__ static uint32_t ld32(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  // Two bf16 one row apart in a row-major (K, ldb) matrix, packed low-first.
  __device__ static uint32_t ld_pair(const T* p, int ldb) {
    const uint32_t lo = __ldg(reinterpret_cast<const unsigned short*>(p));
    const uint32_t hi = __ldg(reinterpret_cast<const unsigned short*>(p + ldb));
    return lo | (hi << 16);
  }

  // acc += A . B[:, n0 : n0 + NT*8] over k < K (a multiple of 16).  a[s]
  // already carries the lane's column offset (lane_offset).  N-tiles at
  // or past n_end are skipped.
  __device__ static void accumulate(Acc& acc, const T* const (&a)[kSlots],
                                    const T* __restrict__ b, int K, int ldb,
                                    int n0, int n_end) {
    const int g = lane() >> 2, t = lane() & 3;
    b += (size_t)(2 * t) * ldb + n0 + g;
    for (int k = 0; k < K; k += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        af[i][0] = ld32(a[2 * i] + k);
        af[i][1] = ld32(a[2 * i + 1] + k);
        af[i][2] = ld32(a[2 * i] + k + 8);
        af[i][3] = ld32(a[2 * i + 1] + k + 8);
      }
      const T* bk = b + (size_t)k * ldb;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n0 + j * 8 >= n_end) break;
        const uint32_t b0 = ld_pair(bk + j * 8, ldb);
        const uint32_t b1 = ld_pair(bk + (size_t)8 * ldb + j * 8, ldb);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(acc.v[i][j][0]), "+f"(acc.v[i][j][1]),
                "+f"(acc.v[i][j][2]), "+f"(acc.v[i][j][3])
              : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                "r"(b0), "r"(b1));
      }
    }
  }

  template <typename F>
  __device__ static void for_each(const Acc& acc, int n0, int n_end, F f) {
    const int t = lane() & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n0 + j * 8 >= n_end) break;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(i * 2 + (e >> 1), j * 8 + 2 * t + (e & 1), acc.v[i][j][e]);
      }
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

template <typename E, bool FLAT>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const Args<typename E::T> args) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = args.h, W = args.w, S = args.stride, TT = args.tile;
  const int P = args.p, Cin = args.cin, Cout = args.cout;
  const int pitch = P + kPad;
  const int Ho = H / S, Wo = W / S;
  const int HS = (TT - 1) * S + 3;  // halo side
  const int tiles_w = (Wo + TT - 1) / TT;
  const int oh0 = (blockIdx.x / tiles_w) * TT;
  const int ow0 = (blockIdx.x % tiles_w) * TT;
  const int n = blockIdx.y;
  const bool has_ds = args.wd != nullptr;

  T* y1s = reinterpret_cast<T*>(smem_raw);  // [HS * HS][pitch]
  T* y2s = y1s + HS * HS * pitch;            // [TT * TT][pitch]

  // ---- stage 1: y1 on the halo; zero where conv2 pads ------------------
  const int groups_p = (P + E::kCols - 1) / E::kCols;
  const int M1 = HS * HS;
  for (int job = E::unit(); job < ((M1 + E::kRows - 1) / E::kRows) * groups_p;
       job += E::kUnits) {
    const int m0 = (job / groups_p) * E::kRows;
    const int n0 = (job % groups_p) * E::kCols;
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
  __syncthreads();

  // ---- stage 2: y2 = relu(conv3x3_s(y1) + b2) from shared memory --------
  const int M2 = TT * TT;
  for (int job = E::unit(); job < ((M2 + E::kRows - 1) / E::kRows) * groups_p;
       job += E::kUnits) {
    const int m0 = (job / groups_p) * E::kRows;
    const int n0 = (job % groups_p) * E::kCols;
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
  __syncthreads();

  // ---- stage 3: out = relu(y2 . W3 + b3 + shortcut) ---------------------
  const int groups_o = (Cout + E::kCols - 1) / E::kCols;
  for (int job = E::unit(); job < ((M2 + E::kRows - 1) / E::kRows) * groups_o;
       job += E::kUnits) {
    const int m0 = (job / groups_o) * E::kRows;
    const int n0 = (job % groups_o) * E::kCols;
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

  // ---- v2: the output border is zero, written by each image's tile 0 ----
  if (FLAT && blockIdx.x == 0) {
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
      args.out[(((int64_t)n * PH + row) * PW + col) * Cout + c] =
          from_f32<T>(0.f);
    }
  }
}

template <typename E, bool FLAT>
int launch(const Args<typename E::T>& a, int n, cudaStream_t stream) {
  const int S = a.stride, Ho = a.h / S, Wo = a.w / S;
  const int HS = (a.tile - 1) * S + 3;
  const size_t smem = (size_t)(HS * HS + a.tile * a.tile) * (a.p + kPad) *
                      sizeof(typename E::T);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<E, FLAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((Ho + a.tile - 1) / a.tile) * ((Wo + a.tile - 1) / a.tile),
                  n);
  bottleneck_kernel<E, FLAT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* w3,
                  const void* b3, const void* wd, const void* bd,
                  const void* mask, void* out, int h, int w, int cin, int p,
                  int cout, int stride, int tile) {
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
  return a;
}

template <bool FLAT>
int dispatch(int dtype, const void* x, const void* w1, const void* b1,
             const void* w2, const void* b2, const void* w3, const void* b3,
             const void* wd, const void* bd, const void* mask, void* out,
             int n, int h, int w, int cin, int p, int cout, int stride,
             int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<ScalarEngine, FLAT>(
        make_args<float>(x, w1, b1, w2, b2, w3, b3, wd, bd, mask, out, h, w,
                         cin, p, cout, stride, tile), n, s);
  if (dtype == 1)
    return launch<MmaEngine, FLAT>(
        make_args<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, wd, bd, mask,
                                 out, h, w, cin, p, cout, stride, tile), n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  wd and bd are null for an identity
// shortcut.  Returns the cudaError_t of the launch.
int fused_bottleneck_launch(int dtype, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* w3, const void* b3, const void* wd,
                            const void* bd, void* out, int n, int h, int w,
                            int cin, int p, int cout, int stride, int tile,
                            void* stream) {
  return dispatch<false>(dtype, x, w1, b1, w2, b2, w3, b3, wd, bd, nullptr,
                         out, n, h, w, cin, p, cout, stride, tile, stream);
}

// x and out are (N, (H+2)*(W+2), C) with zero borders; stride 1.
int fused_bottleneck_flat_launch(int dtype, const void* x, const void* mask,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2,
                                 const void* w3, const void* b3,
                                 const void* wd, const void* bd, void* out,
                                 int n, int h, int w, int cin, int p,
                                 int cout, int tile, void* stream) {
  return dispatch<true>(dtype, x, w1, b1, w2, b2, w3, b3, wd, bd, mask, out,
                        n, h, w, cin, p, cout, 1, tile, stream);
}

const char* fused_bottleneck_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
