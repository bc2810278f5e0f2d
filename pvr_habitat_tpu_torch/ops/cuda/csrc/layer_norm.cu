// LayerNorm over the last axis for Hopper (sm_90a): the ViT encoders'
// models/common.py::layer_norm in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA,
// which fuses its elementwise steps on the TPU.  Op by op in PyTorch the
// same function is 15 launches and about 30 B of device memory traffic an
// element in bf16 (the f32 copy of x written and read three times, four
// bf16 passes read and written); this kernel moves 4 B an element: x read
// once, y written once.
//
// What bounds it on the H100: bytes.  At mae_huge batch 256 (256 x 257 rows
// of 1280 in bf16) one call must move 336.9 MB, 0.1006 ms at 3.35 TB/s; its
// ~10 operations an element are far below the card's rate.
//
// Design.  One warp a row, the row held in registers: each lane reads
// D / 32 values with 16-byte loads (lane l takes the vectors l, l + 32,
// ...: a warp's load instruction reads 512 contiguous bytes).  D is a
// template, one of the zoo's widths 768, 1024 and 1280 (24, 32 or 40
// values a lane).  The f32 sum and the f32 sum of squared deviations from
// the f32 mean are warp shuffle reductions over the registers, so x is
// read once.  A warp issues its row's loads before anything else; its
// block of kWarps rows meanwhile stages w and b, rounded to x's type, in
// shared memory once, in the layout of a row's vectors.  The grid has a
// block for every kWarps rows, and the block scheduler keeps the card
// full.  Measured on an H100 80GB HBM3 at 700 W: 78-84% of the byte bound
// at the two MAE shapes (chip_smoke.py prints it), within 5% of
// Tensor.copy_ of the same bytes.  Persistent blocks whose warps walked
// rows in turn, with w and b in registers and the next row's loads in
// flight, ran at 72-79%, and so did a plain copy in that shape; 4 or 8
// warps a block, or 2 or 4 rows a warp, were no faster.
//
// Rounding points, those of the op-by-op version (in x's type T; in f32
// every "round" is the identity):
//   mean = round(sum(x) * (1/D))        f32 sum
//   var  = round(sum((x - mean_f32)^2) / D)
//   inv  = round(rsqrtf(round(var + eps)))   eps already in T
//   y    = round(round(round(round(x - mean) * inv) * round(w)) + round(b))
// Every product and sum of the last line is an explicitly rounded f32
// operation (__fmul_rn, __fadd_rn), so the compiler contracts none of them
// into an FMA that would round once where the op-by-op path rounds twice.
// Only the f32 sums run in another order than PyTorch's reductions: a row
// whose f32 mean or variance lies within a few f32 ulps of a bf16 rounding
// boundary can round the other way.
//
// Plain C interface, loaded with ctypes: the launcher returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;                // rows a block, one a warp
constexpr int kThreads = 32 * kWarps;

template <typename T> struct Elem;

// f32: four values a 16-byte vector, no rounding.
template <> struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float get(const uint4& p, int k) {
    return __uint_as_float((&p.x)[k]);
  }
  // values k and k + 1 of p from a and b
  static __device__ __forceinline__ void put2(uint4& p, int k, float a,
                                              float b) {
    (&p.x)[k] = __float_as_uint(a);
    (&p.x)[k + 1] = __float_as_uint(b);
  }
  static __device__ __forceinline__ float load(const float* w, int i) {
    return w[i];
  }
};

// bf16: eight values a 16-byte vector, value k in half k % 2 of word k / 2.
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float get(const uint4& p, int k) {
    const uint32_t w = (&p.x)[k / 2];
    return __uint_as_float(k % 2 ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ void put2(uint4& p, int k, float a,
                                              float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a low, b high
    (&p.x)[k / 2] = *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* w,
                                               int i) {
    return __bfloat162float(w[i]);
  }
};

// Two values rounded to T together (one cvt.rn.bf16x2.f32 in bf16).
template <typename T>
__device__ __forceinline__ void round2(float& a, float& b) {
  uint4 p;
  Elem<T>::put2(p, 0, a, b);
  a = Elem<T>::get(p, 0);
  b = Elem<T>::get(p, 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x: rows of D in T at x_stride elements apart; y: rows of D in T, dense;
// w, b: D values of W (f32, or T itself).  EPL = D / 32 values a lane.
template <typename T, typename W, int EPL>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, long long x_stride,
                  const W* __restrict__ w, const W* __restrict__ b,
                  T* __restrict__ y, long long rows, float eps) {
  using E = Elem<T>;
  constexpr int kVec = E::kVec;
  constexpr int kNv = EPL / kVec;         // 16-byte vectors a lane
  constexpr int kD = 32 * EPL;
  static_assert(EPL % kVec == 0, "a lane holds whole vectors");
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;

  // The warp's row first, so its loads are in flight during the rest.
  uint4 v[kNv];
  if (row < rows) {
    const uint4* src = reinterpret_cast<const uint4*>(x + row * x_stride);
#pragma unroll
    for (int j = 0; j < kNv; ++j) v[j] = __ldg(src + j * 32 + lane);
  }

  // w and b rounded to T, once a block, in the layout of a row's vectors.
  __shared__ uint4 ws[kD / kVec], bs[kD / kVec];
  for (int i = 2 * threadIdx.x; i < kD; i += 2 * kThreads) {
    E::put2(ws[i / kVec], i % kVec, Elem<W>::load(w, i),
            Elem<W>::load(w, i + 1));
    E::put2(bs[i / kVec], i % kVec, Elem<W>::load(b, i),
            Elem<W>::load(b, i + 1));
  }
  __syncthreads();
  if (row >= rows) return;

  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kNv; ++j)
#pragma unroll
    for (int k = 0; k < kVec; ++k) sum += E::get(v[j], k);
  const float mean_f = warp_sum(sum) * (1.0f / kD);
  float m2 = 0.f;
#pragma unroll
  for (int j = 0; j < kNv; ++j)
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float d = E::get(v[j], k) - mean_f;
      m2 = fmaf(d, d, m2);
    }
  const float var = E::round(__fdiv_rn(warp_sum(m2), (float)kD));
  const float mean = E::round(mean_f);
  const float inv = E::round(rsqrtf(E::round(__fadd_rn(var, eps))));

  uint4* dst = reinterpret_cast<uint4*>(y + row * kD);
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    const uint4 wv = ws[j * 32 + lane], bv = bs[j * 32 + lane];
    uint4 out;
#pragma unroll
    for (int k = 0; k < kVec; k += 2) {
      float a = __fsub_rn(E::get(v[j], k), mean);
      float c = __fsub_rn(E::get(v[j], k + 1), mean);
      round2<T>(a, c);
      a = __fmul_rn(a, inv);
      c = __fmul_rn(c, inv);
      round2<T>(a, c);
      a = __fmul_rn(a, E::get(wv, k));
      c = __fmul_rn(c, E::get(wv, k + 1));
      round2<T>(a, c);
      E::put2(out, k, __fadd_rn(a, E::get(bv, k)),
              __fadd_rn(c, E::get(bv, k + 1)));
    }
    dst[j * 32 + lane] = out;
  }
}

template <typename T, typename W, int EPL>
cudaError_t launch(const void* x, long long x_stride, const void* w,
                   const void* b, void* y, long long rows, float eps,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  layer_norm_kernel<T, W, EPL><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), x_stride, static_cast<const W*>(w),
      static_cast<const W*>(b), static_cast<T*>(y), rows, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_width(int d, const void* x, long long x_stride,
                         const void* w, const void* b, void* y,
                         long long rows, float eps, cudaStream_t stream) {
  switch (d) {
    case 768: return launch<T, W, 24>(x, x_stride, w, b, y, rows, eps, stream);
    case 1024: return launch<T, W, 32>(x, x_stride, w, b, y, rows, eps, stream);
    case 1280: return launch<T, W, 40>(x, x_stride, w, b, y, rows, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: x's and y's type, 0 = float32, 1 = bfloat16; wdtype: w's and b's,
// 0 = float32 or the same as dtype.  x: rows of d at x_stride elements
// apart, 16-byte aligned; y: rows * d, dense.  d: 768, 1024 or 1280.
// eps: already rounded to dtype.  Returns the cudaError_t of the launch.
int layer_norm_launch(int dtype, int wdtype, const void* x,
                      long long x_stride, const void* w, const void* b,
                      void* y, long long rows, int d, float eps,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && wdtype == 0)
    return (int)launch_width<float, float>(d, x, x_stride, w, b, y, rows,
                                           eps, s);
  if (dtype == 1 && wdtype == 0)
    return (int)launch_width<__nv_bfloat16, float>(d, x, x_stride, w, b, y,
                                                   rows, eps, s);
  if (dtype == 1 && wdtype == 1)
    return (int)launch_width<__nv_bfloat16, __nv_bfloat16>(
        d, x, x_stride, w, b, y, rows, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
