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
// must therefore never reach device memory.
// Design: the TPU kernel holds one image, all heads, in VMEM (~300 KB); a
// block has 227 KB of shared memory, and one head's f32 score tile alone is
// 155 KB at L = 197.  So each block owns one (image, head, 64 query rows)
// and stages that head's K and V in shared memory (25 KB each at L = 197,
// D = 64; 41 KB at L = 257, D = 80).  The scores live in registers, one
// 16 x 8 tile at a time, in two passes over the keys:
//   pass 1: s tile by tile, a running row max and rescaled row sum;
//   pass 2: s again (the same instructions, so the same bits), p = e / sum
//           rounded to bf16 in registers, then p . V.
// Normalising before the rounding of p keeps the TPU kernel's order (a
// flash-style "divide after p . V" kernel computes something else), at the
// price of computing q . k^T twice, which the byte bound leaves room for.
// Ragged L: keys past L are masked to -inf and K/V rows past L are zero in
// shared memory; query rows past L are read as zero and never stored.
//
// Two engines:
//   bf16: warp-level tensor-core MMA (mma.sync m16n8k16, f32 accumulate);
//         a warp owns 16 query rows; D = 16 * DK, DK = 1..8 (a template);
//   f32:  scalar FMAs (the f32 parity path; TF32 would break its 1e-5),
//         a warp walks 8 query rows one at a time, lanes split the keys for
//         the scores and the channels for p . V.
// wgmma, TMA and several heads per block are later work.
//
// Strides are in elements and D's stride is 1, so a caller can pass
// (N, L, H, D)-ordered views of a fused qkv projection without copies.
//
// Plain C interface, loaded with ctypes: the launcher returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsBlock = 64;   // query rows per block, both engines
constexpr int kThreadsMma = 128; // 4 warps x 16 rows
constexpr int kPadMma = 8;       // bf16 shared-memory row pitch is D + 8
constexpr int kThreadsF32 = 256; // 8 warps x 8 rows
constexpr int kWarpsF32 = kThreadsF32 / 32;

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
// A C tile of the scores (rows g / g+8, keys 2t, 2t+1) is exactly the A
// fragment of p for p . V, so p never leaves registers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 one row apart, packed low-first.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(p + ld);
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp(s - m) with a row max of -inf (no key seen yet) giving 0.
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : expf(m - m_new);
}

template <int DK>
__global__ void __launch_bounds__(kThreadsMma)
attention_mma_kernel(const Args<__nv_bfloat16> args) {
  using T = __nv_bfloat16;
  constexpr int D = 16 * DK, DN = 2 * DK, P = D + kPadMma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = args.l, Lp = (L + 15) & ~15;
  const int head = blockIdx.y, n = blockIdx.z;
  T* ks = reinterpret_cast<T*>(smem_raw);  // [Lp][P]
  T* vs = ks + Lp * P;                     // [Lp][P]

  // ---- stage this head's K and V, 16 bytes at a time; zero past L -------
  {
    const T* kg = args.k + n * args.sk.n + head * args.sk.h;
    const T* vg = args.v + n * args.sv.n + head * args.sv.h;
    constexpr int kChunks = D / 8;
    for (int i = threadIdx.x; i < Lp * kChunks; i += kThreadsMma) {
      const int row = i / kChunks, c = (i % kChunks) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (row < L) {
        kv = *reinterpret_cast<const uint4*>(kg + row * args.sk.l + c);
        vv = *reinterpret_cast<const uint4*>(vg + row * args.sv.l + c);
      }
      *reinterpret_cast<uint4*>(ks + row * P + c) = kv;
      *reinterpret_cast<uint4*>(vs + row * P + c) = vv;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRowsBlock + warp * 16;
  if (r0 >= L) return;  // warp-uniform; no barrier follows
  const int ra = r0 + g, rb = r0 + g + 8;

  // ---- this warp's 16 query rows as A fragments --------------------------
  uint32_t qf[DK][4];
  {
    const T* qg = args.q + n * args.sq.n + head * args.sq.h + 2 * t;
    const T* qa = qg + (long long)min(ra, L - 1) * args.sq.l;
    const T* qb = qg + (long long)min(rb, L - 1) * args.sq.l;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      qf[kk][0] = ra < L ? ld32(qa + 16 * kk) : 0u;
      qf[kk][1] = rb < L ? ld32(qb + 16 * kk) : 0u;
      qf[kk][2] = ra < L ? ld32(qa + 16 * kk + 8) : 0u;
      qf[kk][3] = rb < L ? ld32(qb + 16 * kk + 8) : 0u;
    }
  }

  // s for keys 8j .. 8j+7: scaled, -inf past L.
  auto scores = [&](int j, float (&s)[4]) {
    s[0] = s[1] = s[2] = s[3] = 0.f;
    const T* kr = ks + (j * 8 + g) * P + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
      mma_bf16(s, qf[kk], ld32(kr + 16 * kk), ld32(kr + 16 * kk + 8));
    const int col = j * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = col + (e & 1) < L ? s[e] * args.scale : -INFINITY;
  };

  // ---- pass 1: row max and row sum of exp(s - max) -----------------------
  // [0] is row g, [1] row g + 8; each thread sees keys 2t, 2t+1 of a tile.
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int j = 0; j < Lp / 8; ++j) {
    float s[4];
    scores(j, s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], fmaxf(s[2 * h], s[2 * h + 1]));
      if (mn == -INFINITY) continue;
      sum[h] = sum[h] * rescale(m[h], mn) + expf(s[2 * h] - mn) +
               expf(s[2 * h + 1] - mn);
      m[h] = mn;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // merge the quad's keys
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float so = __shfl_xor_sync(0xffffffffu, sum[h], off);
      const float mn = fmaxf(m[h], mo);
      sum[h] = sum[h] * rescale(m[h], mn) + so * rescale(mo, mn);
      m[h] = mn;
    }

  // ---- pass 2: p = e / sum rounded to bf16, out = p . V ------------------
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int kt = 0; kt < Lp / 16; ++kt) {
    float s0[4], s1[4];
    scores(2 * kt, s0);
    scores(2 * kt + 1, s1);
    uint32_t pf[4];
    pf[0] = pack_bf16(expf(s0[0] - m[0]) / sum[0], expf(s0[1] - m[0]) / sum[0]);
    pf[1] = pack_bf16(expf(s0[2] - m[1]) / sum[1], expf(s0[3] - m[1]) / sum[1]);
    pf[2] = pack_bf16(expf(s1[0] - m[0]) / sum[0], expf(s1[1] - m[0]) / sum[0]);
    pf[3] = pack_bf16(expf(s1[2] - m[1]) / sum[1], expf(s1[3] - m[1]) / sum[1]);
    const T* vr = vs + (kt * 16 + 2 * t) * P + g;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      mma_bf16(o[dn], pf, ld_pair(vr + dn * 8, P),
               ld_pair(vr + 8 * P + dn * 8, P));
  }

  T* og = args.out + n * args.so.n + head * args.so.h + 2 * t;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(og + ra * args.so.l + dn * 8) =
          __floats2bfloat162_rn(o[dn][0], o[dn][1]);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(og + rb * args.so.l + dn * 8) =
          __floats2bfloat162_rn(o[dn][2], o[dn][3]);
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

size_t smem_mma(int l, int d) {
  return (size_t)2 * ((l + 15) & ~15) * (d + kPadMma) * sizeof(__nv_bfloat16);
}

size_t smem_f32(int l, int d) {
  return ((size_t)2 * l * (d + 1) + (size_t)kWarpsF32 * (d + l)) *
         sizeof(float);
}

template <typename Kernel, typename A>
int launch(Kernel kernel, const A& a, size_t smem, int n, int h,
           cudaStream_t stream, int threads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.l + kRowsBlock - 1) / kRowsBlock, h, n);
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

template <int DK>
int launch_mma(const Args<__nv_bfloat16>& a, int n, int h, cudaStream_t s) {
  return launch(attention_mma_kernel<DK>, a, smem_mma(a.l, a.d), n, h, s,
                kThreadsMma);
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
                  smem_f32(l, d), n, h, s, kThreadsF32);
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
