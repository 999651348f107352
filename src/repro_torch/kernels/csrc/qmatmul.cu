// int8 x int8 -> int32 matrix product with a per-column f32 scale in the
// epilogue: kernel B5 of the port.
//
// Replaces the TPU kernel src/repro/kernels/qmatmul.py::qmatmul (body
// _qmm_kernel). The TPU grid walked (M/bm, N/bn, K/bk) with K innermost and
// carried an int32 accumulator in VMEM from one grid step to the next. Here
// one CTA owns one 64 x 64 output tile and loops over K itself, with the
// accumulator in registers: no sum crosses CTAs. Per K step of 64, the x
// tile [64, 64] and the w tile [64, 64] are staged in shared memory, and
// four warps (2 x 2, 32 x 32 each) multiply with
// mma.sync.m16n8k32.s32.s8.s8.s32 on the tensor cores. w is [K, N]
// row-major, so four K-consecutive values of one column lie N apart: each
// thread loads a 4 x 4 byte block (four rows of four columns) and transposes
// it with byte permutes while staging, so that shared memory holds w
// column-major in K quads, the layout of the mma's B operand. The next K
// tile is loaded into registers while the current one is multiplied.
//
// Integer sums are exact, so the order of the K loop does not matter: the
// result is the reference's bit for bit. The epilogue follows
// qmatmul.py:35-36: int32 -> f32 rounded to nearest, one f32 multiply by
// scale[n], then round to nearest even into bf16 (or store f32).
//
// Bound on an H100 SXM: at decode and small-batch widths (M up to a few
// hundred rows) the product reads the whole int8 weight once and is bound
// by bytes at 3.35 TB/s; at M = 2048 on a Llama2-7B FFN weight it is bound
// by int8 tensor-core operations at 1,979 T ops/s. This is the simple,
// correct version: mma.sync rather than wgmma, no TMA, and one register-
// staged tile in flight, so it reaches neither bound. wgmma with a TMA ring,
// and a split of K across CTAs for M = 1, are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (a plain C interface, loaded with ctypes)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kThreads = 128;          // 4 warps, 2 x 2 over the tile
// bytes per shared-memory row: 16-byte aligned, and the fragment loads of a
// warp (8 rows x 4 quads) land on 32 distinct banks
constexpr int kStride = kBK + 16;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Staged {
  uint4 a[2];        // two 16-byte chunks of the x tile
  uint32_t b[2][4];  // two 4 x 4 blocks of the w tile, one word per K row
};

// Load the K tile at k0 into registers; out-of-range chunks are zero.
// K % 16 == 0 and N % 4 == 0 (checked by the host), so every 16-byte x
// chunk and every 4-byte w word is wholly inside or wholly outside.
__device__ __forceinline__ void load_tile(Staged& st, const int8_t* x,
                                          const int8_t* w, int m, int n,
                                          int k, int m0, int n0, int k0,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;          // 64 rows x 4 chunks
    const int row = c >> 2, kc = (c & 3) * 16;
    st.a[i] = make_uint4(0, 0, 0, 0);
    if (m0 + row < m && k0 + kc < k)
      st.a[i] = __ldg(reinterpret_cast<const uint4*>(
          x + (long long)(m0 + row) * k + k0 + kc));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = tid + i * kThreads;        // 16 K quads x 16 N quads
    const int kq = blk >> 4, nq = blk & 15;
    const int kk = k0 + kq * 4, nn = n0 + nq * 4;
    const bool in = kk < k && nn < n;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st.b[i][r] = in ? __ldg(reinterpret_cast<const uint32_t*>(
                            w + (long long)(kk + r) * n + nn))
                      : 0u;
  }
}

__device__ __forceinline__ void store_tile(const Staged& st, uint8_t* as,
                                           uint8_t* bs, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    *reinterpret_cast<uint4*>(as + (c >> 2) * kStride + (c & 3) * 16) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = tid + i * kThreads;
    const int kq = blk >> 4, nq = blk & 15;
    const uint32_t* r = st.b[i];
    // 4 x 4 byte transpose: word j = the K quad of column nq * 4 + j
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t u0 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t u1 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, u0, 0x5410),
                             __byte_perm(t0, u0, 0x7632),
                             __byte_perm(t1, u1, 0x5410),
                             __byte_perm(t1, u1, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(bs + (nq * 4 + j) * kStride + kq * 4) = col[j];
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
qmatmul_kernel(const int8_t* x, const int8_t* w, const float* scale,
               void* out, int m, int n, int k) {
  __shared__ __align__(16) uint8_t as[kBM * kStride];   // x tile, row-major
  __shared__ __align__(16) uint8_t bs[kBN * kStride];   // w tile, column-major
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;      // mma groupID, thread in group
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  Staged st;
  load_tile(st, x, w, m, n, k, m0, n0, 0, tid);
  store_tile(st, as, bs, tid);
  __syncthreads();
  for (int k0 = 0; k0 < k; k0 += kBK) {
    const bool more = k0 + kBK < k;
    if (more) load_tile(st, x, w, m, n, k, m0, n0, k0 + kBK, tid);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* p = as + (wm + mi * 16 + g) * kStride + kk + t * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = bs + (wn + ni * 8 + g) * kStride + kk + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
    if (more) {
      store_tile(st, as, bs, tid);
      __syncthreads();
    }
  }

  // epilogue: c0, c1 at (g, 2t + {0, 1}), c2, c3 at (g + 8, 2t + {0, 1})
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn + ni * 8 + t * 2 + (e & 1);
        if (row >= m || col >= n) continue;
        const float y = __fmul_rn(__int2float_rn(acc[mi][ni][e]), scale[col]);
        const long long o = (long long)row * n + col;
        if (kBf16) {
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
        } else {
          static_cast<float*>(out)[o] = y;
        }
      }
}

}  // namespace

// out[m, n] = (float(sum_k x[m, k] * w[k, n]) * scale[n]) in bf16 (out_bf16)
// or f32. x int8 [m, k] and w int8 [k, n] row-major, scale f32 [n]; k a
// multiple of 16 and n of 4, x 16-byte and w 4-byte aligned (the wrapper
// checks). Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int repro_qmatmul(const void* x, const void* w, const void* scale,
                             void* out, int m, int n, int k, int out_bf16,
                             void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || k % 16 || n % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kBN - 1) / kBN), (unsigned)((m + kBM - 1) / kBM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  if (out_bf16) {
    qmatmul_kernel<true><<<grid, kThreads, 0, s>>>(xp, wp, sp, out, m, n, k);
  } else {
    qmatmul_kernel<false><<<grid, kThreads, 0, s>>>(xp, wp, sp, out, m, n, k);
  }
  return (int)cudaGetLastError();
}
