// Causal attention by blocked online softmax over [bh, s, d]: kernel B2 of
// the port.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel). The TPU grid walked (bh, q block, kv
// block) with kv innermost and carried the running max m, sum l and
// accumulator acc in VMEM scratch from one grid step to the next. Here one
// CTA of 4 warps owns one (head, 64-row q block) and loops over the 64-row
// kv tiles up to the diagonal itself, with m, l and acc in registers, so
// nothing crosses CTAs and tiles wholly above the diagonal are never
// visited. The update is the reference's: scores scaled, masked
// (k_pos > q_pos -> -1e30), m_new = max(m, row max), p = exp(s - m_new),
// alpha = exp(m - m_new), l = l * alpha + sum p, acc = acc * alpha + p.v,
// and the emit acc / max(l, 1e-30). GQA: q head i reads kv head i / group,
// the values of the reference's jnp.repeat. Rows and kv positions past s are
// zero-filled and never stored; a padded kv position is causally masked for
// every real row. No atomics and a fixed order everywhere, so identical
// inputs give identical bits.
//
// Bound on an H100 SXM: at s = 128 the call moves q, k, v and out once and
// is bound by bytes at 3.35 TB/s; at s = 4096 the causal product needs about
// 4 d s^2 / 2 flops per head and is bound by tensor-core flops (989 TFLOP/s
// bf16).
//
// bf16 (flash_tc_kernel): the products run on the tensor cores, mma.sync
// m16n8k16 bf16 with f32 accumulate. Each warp owns 16 q rows, their Q
// fragments loaded once by ldmatrix. S = Q K^T stays in registers (bf16 x
// bf16 products are exact in f32, so S loses nothing against the
// reference's f32 dot but the order of its sums); the row max and row sum
// reduce over the four lanes of a quad by a fixed shuffle order; softmax in
// base 2 (ex2.approx of s * scale * log2 e); P goes from the S accumulators
// straight into A fragments; V's B fragments come from
// ldmatrix.trans. P is split into bf16 hi + lo (hi = bf16(p), lo =
// bf16(p - hi)) and p.v issues both products: with P rounded to bf16 alone
// the output used over half of the (1e-2, 1e-2) tolerance against the plain
// version, more than this design allows itself (PERF.md). K and V tiles arrive by cp.async in a two-stage ring of
// padded rows (a 16-byte pad puts the 8 rows of an ldmatrix on distinct
// banks), so tile j + 1 loads while tile j computes; the Q tile lands in
// the second stage before the ring starts. Only the diagonal tile is
// masked. The grid runs q blocks longest-first (blockIdx.y counts down from
// the last block) so the longest causal rows start first. Launch bounds
// hold the kernel to 3 CTAs (12 warps) an SM, which measured faster at
// s = 4096 than the 2 its free register count allowed, despite a few spilled
// registers at d = 128. wgmma and TMA are later work.
//
// f32 (flash_kernel): the first version's CUDA-core body, f32 FMAs. f32 is
// held to 1e-5 against its plain version; TF32 tensor cores keep about
// three decimal digits and would break that, and f32 is not the path's
// dtype. 128 threads as 8 x 16: thread (ty, tx) owns q rows ty + 8i (i < 8),
// score columns tx + 16j (j < 4) and output columns tx + 16c (c < d / 16);
// row max and row sum by a fixed xor-shuffle tree over the 16 threads of a
// row; p through shared memory; acc = acc * alpha + p.v over kv positions
// in order.
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int kD>
struct TcLayout {
  static constexpr int kStride = kD + 8;        // bf16 elements per smem row
  static constexpr int kTile = kBKV * kStride;  // elements per K or V tile
  static constexpr size_t kBytes = sizeof(uint16_t) * 4 * kTile;  // 2 stages
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) as bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi), so p.v
// in two products keeps p to about 16 bits instead of 8
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// 2^x by the SFU (2 ulp; a result below 2^-126 flushes to 0, which no
// probability beside the row's max of 1 can feel)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + 64) of a [s, kD] bf16 matrix into a padded smem tile
template <int kD>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          int row0, int s) {
  constexpr int kChunks = kD / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBKV * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < s;
    const uint16_t* g = src + (long long)(in ? row0 + r : 0) * kD + c * 8;
    cp_async16(dst + r * TcLayout<kD>::kStride + c * 8, g, in ? 16 : 0);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 3)
flash_tc_kernel(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                uint16_t* out, int s, int group, float scale) {
  using L = TcLayout<kD>;
  constexpr int kKS = kD / 16;   // k steps of Q K^T
  constexpr int kNT = kBKV / 8;  // n tiles of S
  constexpr int kDT = kD / 8;    // n tiles of O
  extern __shared__ __align__(16) uint16_t sm[];
  // stage i: K tile at sm + 2 i kTile, V tile right after it
  auto kbuf = [&](int i) { return sm + 2 * i * L::kTile; };

  const int head = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;   // longest rows first
  const int q0 = qb * kBQ;
  const long long qoff = (long long)head * s * kD;
  const long long kvoff = (long long)(head / group) * s * kD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float sl2 = scale * 1.4426950408889634f;   // scale * log2(e)

  load_tile<kD>(kbuf(1), q + qoff, q0, s);          // Q into stage 1
  cp_async_commit();
  load_tile<kD>(kbuf(0), k + kvoff, 0, s);
  load_tile<kD>(kbuf(0) + L::kTile, v + kvoff, 0, s);
  cp_async_commit();
  cp_async_wait_one();
  __syncthreads();

  uint32_t qf[kKS][4];
  {
    const uint16_t* row = kbuf(1) + (16 * warp + lane % 16) * L::kStride;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) ldmatrix_x4(qf[kk], row + kk * 16 + (lane / 16) * 8);
  }
  __syncthreads();   // every warp holds its Q: stage 1 is free

  float o[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows a, a + 8
  const int row_a = q0 + 16 * warp + lane / 4;

  const int n_kv = qb + 1;   // tiles up to the diagonal (kBQ == kBKV)
  for (int kb = 0; kb < n_kv; ++kb) {
    if (kb + 1 < n_kv) {
      uint16_t* next = kbuf((kb + 1) & 1);
      load_tile<kD>(next, k + kvoff, (kb + 1) * kBKV, s);
      load_tile<kD>(next + L::kTile, v + kvoff, (kb + 1) * kBKV, s);
    }
    cp_async_commit();   // possibly empty: the wait counts groups
    cp_async_wait_one();
    __syncthreads();
    const uint16_t* ks = kbuf(kb & 1);
    const uint16_t* vs = ks + L::kTile;

    // S = Q K^T, 16 x 64 per warp
    float sc[kNT][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (nt * 8 + (lane / 16) * 8 + lane % 8) * L::kStride +
                           kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(sc[nt], qf[kk], b[0], b[1]);
        mma_bf16(sc[nt + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale (base 2), the diagonal tile's mask, row max over the quad
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] *= sl2;
    }
    if (kb == qb) {   // the diagonal tile: k_pos > q_pos -> -1e30
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * (lane % 4) + (e & 1);   // within tile
          if (col > 16 * warp + lane / 4 + (e >> 1) * 8) sc[nt][e] = kNegInf;
        }
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];   // this lane's share of the row sum
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(sc[nt][e] - m[e >> 1]);
        sc[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // O += P V: P's accumulators become A fragments, p = hi + lo in bf16
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], hi[0], lo[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], hi[1], lo[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                      L::kStride +
                                  (dt + lane / 16) * 8);
        mma_bf16(o[dt], hi, b[0], b[1]);
        mma_bf16(o[dt + 1], hi, b[2], b[3]);
        mma_bf16(o[dt], lo, b[0], b[1]);
        mma_bf16(o[dt + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();   // this stage is consumed before the next load into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_a + 8 * r;
    if (row >= s) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + qoff + (long long)row * kD);
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      dst[(t * 8 + 2 * (lane % 4)) / 2] =
          pack_bf16(__fdiv_rn(o[t][2 * r], denom), __fdiv_rn(o[t][2 * r + 1], denom));
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int kD>
struct Layout {
  static constexpr int kQS = kD + 1;    // q row stride
  static constexpr int kPS = kBKV + 1;  // p row stride
  static constexpr int kKS = kD + 1;    // K row stride
  static constexpr int kVS = kD;        // V row stride
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * kQS + kBQ * kPS + kBKV * kKS + kBKV * kVS);
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

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* q, const float* k, const float* v, float* out, int s,
             int group, float scale) {
  using L = Layout<kD>;
  constexpr int kDC = kD / 16;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][kQS]
  float* ps = qs + kBQ * L::kQS;     // [kBQ][kPS]
  float* ks = ps + kBQ * L::kPS;     // [kBKV][kKS]
  float* vs = ks + kBKV * L::kKS;    // [kBKV][kVS]

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const long long qoff = (long long)head * s * kD;
  const long long kvoff = (long long)(head / group) * s * kD;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    qs[r * L::kQS + c] = q0 + r < s ? q[qoff + (long long)(q0 + r) * kD + c] : 0.f;
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
      ks[r * L::kKS + c] = in ? k[at] : 0.f;
      vs[r * L::kVS + c] = in ? v[at] : 0.f;
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
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * L::kKS + d];
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
      for (int c = 0; c < kDC; ++c) vv[c] = vs[t * L::kVS + tx + 16 * c];
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
      out[qoff + (long long)row * kD + tx + 16 * c] = __fdiv_rn(acc[i][c], denom);
    }
  }
}

template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int group, int s, bool bf16, float scale, cudaStream_t stream) {
  const unsigned n_qb = (unsigned)((s + kBQ - 1) / kBQ);
  if (bf16) {
    const size_t smem = TcLayout<kD>::kBytes;
    if (int rc = opt_in(flash_tc_kernel<kD>, smem)) return rc;
    flash_tc_kernel<kD><<<dim3((unsigned)bh, n_qb), kThreads, smem, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), s, group,
        scale);
  } else {
    const size_t smem = Layout<kD>::kBytes;
    if (int rc = opt_in(flash_kernel<kD>, smem)) return rc;
    flash_kernel<kD><<<dim3(n_qb, (unsigned)bh), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), s, group,
        scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out[bh, s, d] = causal attention of q[bh, s, d] over k/v[bh / group, s, d]
// (q head i reads kv head i / group), scores scaled by `scale`. bf16
// (is_bf16) or f32 for q, k, v and out alike; d one of 16, 32, 64, 128.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int bh,
                                     int group, int s, int d, int is_bf16,
                                     float scale, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (group <= 0 || bh % group) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (d) {
    case 16: return launch<16>(q, k, v, out, bh, group, s, bf16, scale, st);
    case 32: return launch<32>(q, k, v, out, bh, group, s, bf16, scale, st);
    case 64: return launch<64>(q, k, v, out, bh, group, s, bf16, scale, st);
    case 128: return launch<128>(q, k, v, out, bh, group, s, bf16, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
