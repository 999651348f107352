// Causal attention by blocked online softmax over [bh, s, d]: kernel B2 of
// the port.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel). The TPU grid walked (bh, q block, kv
// block) with kv innermost and carried the running max m, sum l and
// accumulator acc in VMEM scratch from one grid step to the next. Here one
// CTA owns one (head, 64-row q block) and loops over the kv blocks up to the
// diagonal itself, with m, l and acc in registers, so nothing crosses CTAs
// and blocks wholly above the diagonal are never visited (the TPU streamed
// their tiles and skipped only the compute). The q tile is staged in shared
// memory as f32, the K and V tiles in their own dtype (bf16 or f32) and
// converted on use; every product and sum is f32, as in the reference.
//
// 128 threads as 8 x 16: thread (ty, tx) owns q rows ty + 8i (i < 8), score
// columns tx + 16j (j < 4) and output columns tx + 16c (c < d / 16). Per kv
// block: scores by f32 FMAs over d in order; scale, then the reference's
// mask (k_pos > q_pos -> -1e30); row max and row sum by a fixed xor-shuffle
// tree over the 16 threads of a row (every lane ends with the same bits);
// the reference's update (m_new, p = exp(s - m_new), alpha, l = l * alpha +
// sum p); p through shared memory; acc = acc * alpha + p.v summed over kv
// positions in order. The emit is acc / max(l, 1e-30). No atomics and a
// fixed order everywhere, so identical inputs give identical bits. Rows and
// kv positions past s are zero-filled and never stored; a padded kv
// position is causally masked for every real row. GQA: q head i reads kv
// head i / group, the same values as the reference's jnp.repeat.
//
// Bound on an H100 SXM: at s = 128 the call moves q, k, v and out once and
// is bound by bytes at 3.35 TB/s; at s = 4096 the causal product needs
// about 4 d s^2 / 2 flops per head and is bound by tensor-core flops (989
// TFLOP/s bf16). This is the simple, correct version: f32 FMAs on the CUDA
// cores (67 TFLOP/s), element-wide tile loads and no overlap of loads with
// compute, so it reaches neither bound. Tensor-core products (wgmma) with a
// TMA ring of K/V tiles are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (a plain C interface, loaded with ctypes)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64, kBKV = 64;
constexpr float kNegInf = -1e30f;

template <bool kBf16>
struct Elem;
template <>
struct Elem<true> {
  using T = uint16_t;   // bf16 bits
  __device__ static float f32(T b) { return __uint_as_float((uint32_t)b << 16); }
};
template <>
struct Elem<false> {
  using T = float;
  __device__ static float f32(T x) { return x; }
};

template <int kD, bool kBf16>
struct Layout {
  using T = typename Elem<kBf16>::T;
  static constexpr int kQS = kD + 1;                  // f32 q row stride
  static constexpr int kPS = kBKV + 1;                // f32 p row stride
  static constexpr int kKS = kBf16 ? kD + 2 : kD + 1; // K row stride (elements)
  static constexpr int kVS = kD;                      // V row stride (elements)
  static constexpr size_t kBytes = sizeof(float) * (kBQ * kQS + kBQ * kPS) +
                                   sizeof(T) * (kBKV * kKS + kBKV * kVS);
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int kD, bool kBf16>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const void* q_, const void* k_, const void* v_, void* out_,
             int s, int group, float scale) {
  using L = Layout<kD, kBf16>;
  using T = typename L::T;
  constexpr int kDC = kD / 16;
  extern __shared__ float smem[];
  float* qs = smem;                                   // [kBQ][kQS]
  float* ps = qs + kBQ * L::kQS;                      // [kBQ][kPS]
  T* ks = reinterpret_cast<T*>(ps + kBQ * L::kPS);    // [kBKV][kKS]
  T* vs = ks + kBKV * L::kKS;                         // [kBKV][kVS]

  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const long long qoff = (long long)head * s * kD;
  const long long kvoff = (long long)(head / group) * s * kD;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    qs[r * L::kQS + c] =
        q0 + r < s ? Elem<kBf16>::f32(q[qoff + (long long)(q0 + r) * kD + c]) : 0.f;
  }
  float m[8], l[8], acc[8][kDC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // kv blocks up to the diagonal: the last q row of this block is
  // min(q0 + 63, s - 1), and kBQ == kBKV
  const int n_kv = blockIdx.x + 1;
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * kBKV;
    __syncthreads();   // the previous block's K, V and p are consumed
    for (int i = tid; i < kBKV * kD; i += kThreads) {
      const int r = i / kD, c = i % kD;
      const bool in = k0 + r < s;
      const long long at = kvoff + (long long)(k0 + r) * kD + c;
      ks[r * L::kKS + c] = in ? k[at] : T(0);
      vs[r * L::kVS + c] = in ? v[at] : T(0);
    }
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = qs[(ty + 8 * i) * L::kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = Elem<kBf16>::f32(ks[(tx + 16 * j) * L::kKS + d]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + ty + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float x = kpos <= qpos ? sc[i][j] * scale : kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty + 8 * i) * L::kPS + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBKV; ++t) {
      float pv[8], vv[kDC];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = ps[(ty + 8 * i) * L::kPS + t];
#pragma unroll
      for (int c = 0; c < kDC; ++c)
        vv[c] = Elem<kBf16>::f32(vs[t * L::kVS + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const float y = __fdiv_rn(acc[i][c], denom);
      const long long o = qoff + (long long)row * kD + tx + 16 * c;
      if (kBf16) {
        static_cast<uint16_t*>(out_)[o] = __bfloat16_as_ushort(__float2bfloat16_rn(y));
      } else {
        static_cast<float*>(out_)[o] = y;
      }
    }
  }
}

template <int kD, bool kBf16>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int group, int s, float scale, cudaStream_t stream) {
  const size_t smem = Layout<kD, kBf16>::kBytes;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        flash_kernel<kD, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((unsigned)((s + kBQ - 1) / kBQ), (unsigned)bh);
  flash_kernel<kD, kBf16><<<grid, kThreads, smem, stream>>>(q, k, v, out, s,
                                                           group, scale);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int group, int s, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32, kBf16>(q, k, v, out, bh, group, s, scale, stream);
    case 64: return launch<64, kBf16>(q, k, v, out, bh, group, s, scale, stream);
    case 128: return launch<128, kBf16>(q, k, v, out, bh, group, s, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out[bh, s, d] = causal attention of q[bh, s, d] over k/v[bh / group, s, d]
// (q head i reads kv head i / group), scores scaled by `scale`. bf16
// (is_bf16) or f32 for q, k, v and out alike; d one of 32, 64, 128.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int bh,
                                     int group, int s, int d, int is_bf16,
                                     float scale, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (group <= 0 || bh % group) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<true>(q, k, v, out, bh, group, s, d, scale, st)
                 : dispatch<false>(q, k, v, out, bh, group, s, d, scale, st);
}
