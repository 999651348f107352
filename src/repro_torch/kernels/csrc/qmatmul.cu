// int8 x int8 -> int32 matrix product with a per-column f32 scale in the
// epilogue: kernel B5 of the port.
//
// Replaces the TPU kernel src/repro/kernels/qmatmul.py::qmatmul (body
// _qmm_kernel). The TPU grid walked (M/bm, N/bn, K/bk) with K innermost and
// carried an int32 accumulator in VMEM from one grid step to the next. Here
// a CTA owns a bm x 128 output tile and one run of K (a split), and the
// splits of a tile meet in a thread-block cluster.
//
// Bound on an H100 SXM: at decode and small-batch widths (M up to a few
// hundred rows) the product reads the whole int8 weight once and is bound
// by bytes at 3.35 TB/s; at M = 2048 on a Llama2-7B FFN weight it is bound
// by int8 tensor-core operations at 1,979 T ops/s. The wrapper
// (kernels/qmatmul.py::qmm_plan) picks one of two regimes from (M, N, K):
//
//  - small M (M <= 128, the bytes bound): bm the least of 16, 32, 64, 128
//    that holds M, a 6-stage cp.async ring (tens of KB of w in flight per
//    CTA), and K split over up to 8 CTAs so that every SM has about two
//    CTAs streaming, w_down's 32 column tiles included;
//  - large M (M > 128, the operations bound): 128 x 128 tiles, a 4-stage
//    ring, K split only where the tiles alone leave SMs idle.
//
// Per K step of 64, the x tile [bm, 64] and the w tile [64, 128] land in
// shared memory by 16-byte cp.async (4-byte where N is not a multiple of
// 16), zero-filled past the edges, in XOR-swizzled rows so that the
// fragment reads below are free of bank conflicts. Warps multiply with
// mma.sync.m16n8k32.s32.s8.s8.s32. wgmma takes .s8 operands only K-major,
// and w is [K, N] row-major: a wgmma version that transposed each w tile
// in shared memory into the 64-byte swizzle was bit-exact but slower on
// the card than this one at every 128-row shape tried, both of them held
// by the L2-to-SM traffic of 128 x 128 tiles (PERF.md). The A fragments come
// by ldmatrix.x4. The mma's B operand is K-major, so each thread reads four
// 4-byte words down K (four columns each) and transposes the 4 x 4 bytes
// with byte permutes: column j of the word serves the warp's j-th n8
// fragment, whose columns are therefore every fourth column of the warp's
// 32, and the epilogue maps them back.
//
// Integer sums are exact, so the split changes no bit. No atomics: after
// the K loop every CTA of a cluster writes its int32 tile to its own shared
// memory, the cluster synchronises, and CTA r of the cluster sums a share
// of the tile over the cluster's CTAs in rank order, reading their shared
// memory directly (distributed shared memory), then applies the epilogue of
// qmatmul.py:35-36: int32 -> f32 rounded to nearest, one f32 multiply by
// scale[n], then round to nearest even into bf16 (or store f32).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (a plain C interface, loaded with ctypes)

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 128, kBK = 64;
constexpr int kMaxSplits = 8;             // a cluster's portable size
constexpr int kTileStride = kBN + 4;      // int32 words per row of the
                                          // epilogue tile: conflict-free
                                          // 16-byte stores

template <int BM>
struct Cfg {
  static constexpr int kWarpsM = BM >= 64 ? 2 : 1;
  static constexpr int kThreads = 32 * 4 * kWarpsM;   // 4 warps along N
  static constexpr int kMI = BM / 16 / kWarpsM;       // m16 fragments a warp
  static constexpr int kXBytes = BM * kBK;            // x tile per stage
  static constexpr int kWBytes = kBK * kBN;           // w tile per stage
  static constexpr int kStageBytes = kXBytes + kWBytes;
};

// the ring or the epilogue's tile, whichever is larger
template <int BM, int STAGES>
constexpr size_t smem_bytes() {
  const size_t ring = (size_t)STAGES * Cfg<BM>::kStageBytes;
  const size_t tile = (size_t)BM * kTileStride * 4;
  return ring > tile ? ring : tile;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offsets in a stage. x rows are 64 bytes (4 chunks of 16): chunk c of
// row r sits at chunk c ^ ((r >> 1) & 3), so the 8 rows an ldmatrix phase
// reads fill 32 banks. w rows are 128 bytes (8 chunks): chunk c of K row r
// sits at c ^ (2 * ((r >> 2) & 3)), so the four K rows t * 4 + i that the
// four thread groups of a warp read for one word fill 32 banks.
__device__ __forceinline__ int x_off(int row, int chunk) {
  return row * kBK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ int w_off(int krow, int chunk) {
  return krow * kBN + ((chunk ^ ((krow >> 1) & 6)) << 4);
}

// Issue the copies of K tile [k0, k0 + 64) into one stage; rows of x past
// m, K rows past k_hi (the split's end) and columns past n are zero.
template <int BM>
__device__ __forceinline__ void load_stage(uint8_t* st, const int8_t* x,
                                           const int8_t* w, int m, int n,
                                           int k, int m0, int n0, int k0,
                                           int k_hi, bool vec16, int tid) {
  constexpr int T = Cfg<BM>::kThreads;
  uint8_t* xs = st;
  uint8_t* ws = st + Cfg<BM>::kXBytes;
#pragma unroll
  for (int i = tid; i < BM * 4; i += T) {
    const int row = i >> 2, c = i & 3;
    const int gm = m0 + row, gk = k0 + c * 16;
    const bool in = gm < m && gk < k_hi;    // K % 16 == 0: whole chunks
    cp_async16(xs + x_off(row, c), in ? x + (long long)gm * k + gk : x,
               in ? 16 : 0);
  }
#pragma unroll
  for (int i = tid; i < kBK * 8; i += T) {
    const int kr = i >> 3, c = i & 7;
    const int gk = k0 + kr, gn = n0 + c * 16;
    uint8_t* dst = ws + w_off(kr, c);
    const int8_t* row = w + (long long)gk * n;
    if (vec16) {   // N % 16 == 0: whole chunks
      const bool in = gk < k_hi && gn < n;
      cp_async16(dst, in ? row + gn : w, in ? 16 : 0);
    } else {       // N % 4 == 0: whole words
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = gk < k_hi && gn + 4 * q < n;
        cp_async4(dst + 4 * q, in ? row + gn + 4 * q : w, in ? 4 : 0);
      }
    }
  }
}

// 4 x 4 byte transpose: r[i] holds four columns of K row i; out[j] holds
// the K quad (rows 0..3, row 0 in the low byte) of column j.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t u0 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t u1 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, u0, 0x5410);
  out[1] = __byte_perm(t0, u0, 0x7632);
  out[2] = __byte_perm(t1, u1, 0x5410);
  out[3] = __byte_perm(t1, u1, 0x7632);
}

// After the K loop: every CTA of the cluster (the splits of one output
// tile) holds its int32 tile [BM, kTileStride] in shared memory. CTA
// `split` sums every n_splits-th group of 4 columns over the cluster's
// tiles in rank order, reading them directly (distributed shared memory),
// then the epilogue.
template <int BM, int T, bool kBf16>
__device__ __forceinline__ void cluster_epilogue(const int* tile,
                                                 const float* scale,
                                                 void* out, int m, int n,
                                                 int m0, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int split = blockIdx.y, n_splits = gridDim.y;   // one cluster
  cluster.sync();   // every split's tile is in its CTA's shared memory

  for (int i = split * T + tid; i < BM * (kBN / 4); i += n_splits * T) {
    const int row = i / (kBN / 4), col = (i % (kBN / 4)) * 4;
    const int gm = m0 + row, gn = n0 + col;
    if (gm >= m || gn >= n) continue;    // N % 4 == 0: whole groups
    int4 s = make_int4(0, 0, 0, 0);
    for (int r = 0; r < n_splits; ++r) {
      const int4 v = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(tile, r) + row * kTileStride + col);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(scale + gn);
    const float y0 = __fmul_rn(__int2float_rn(s.x), sc.x);
    const float y1 = __fmul_rn(__int2float_rn(s.y), sc.y);
    const float y2 = __fmul_rn(__int2float_rn(s.z), sc.z);
    const float y3 = __fmul_rn(__int2float_rn(s.w), sc.w);
    const long long o = (long long)gm * n + gn;
    if (kBf16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(y0, y1);
      __nv_bfloat162 hi = __floats2bfloat162_rn(y2, y3);
      uint2 pk;
      pk.x = *reinterpret_cast<uint32_t*>(&lo);
      pk.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) = pk;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
          make_float4(y0, y1, y2, y3);
    }
  }
  cluster.sync();   // no CTA leaves while another reads its tile
}

template <int BM, int STAGES, bool kBf16>
__global__ void __launch_bounds__(Cfg<BM>::kThreads)
qmatmul_kernel(const int8_t* x, const int8_t* w, const float* scale,
               void* out, int m, int n, int k, int k_per_split, int vec16) {
  using C = Cfg<BM>;
  constexpr int T = C::kThreads, MI = C::kMI;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;      // mma groupID, thread in group
  const int wm = (warp >> 2) * (BM / C::kWarpsM), wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.z * BM;
  const int k_lo = blockIdx.y * k_per_split;   // this CTA's split of K
  const int k_hi = min(k, k_lo + k_per_split);
  const int steps = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  int acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_stage<BM>(smem + s * C::kStageBytes, x, w, m, n, k, m0, n0,
                     k_lo + s * kBK, k_hi, vec16, tid);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // this step's tile landed; the previous stage is free
    const int nxt = step + STAGES - 1;
    if (nxt < steps)
      load_stage<BM>(smem + (nxt % STAGES) * C::kStageBytes, x, w, m, n, k,
                     m0, n0, k_lo + nxt * kBK, k_hi, vec16, tid);
    cp_async_commit();

    const uint8_t* xs = smem + (step % STAGES) * C::kStageBytes;
    const uint8_t* ws = xs + C::kXBytes;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        // matrices: rows 0-7 / 8-15 of the fragment, K bytes 0-15 / 16-31
        const int row = wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a[mi], xs + x_off(row, (kk >> 4) + (lane >> 4)));
      }
      uint32_t b[2][4];   // [K half][fragment j]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4];
        const int word = (wn >> 2) + g;   // columns wn + 4g .. + 3
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = kk + h * 16 + t * 4 + i;
          r[i] = *reinterpret_cast<const uint32_t*>(
              ws + w_off(kr, word >> 2) + (word & 3) * 4);
        }
        transpose4(r, b[h]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_s8(acc[mi][j], a[mi], b[0][j], b[1][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is idle: reuse it for the int32 tile

  // acc[mi][j][e] is row wm + mi*16 + g + (e >> 1) * 8, mma column
  // 2t + (e & 1), which is column wn + 4 * (2t + (e & 1)) + j: a thread
  // holds columns wn + 8t .. + 7 of each of its rows
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      int* p = tile + (wm + mi * 16 + g + hi * 8) * kTileStride + wn + 8 * t;
      *reinterpret_cast<int4*>(p) =
          make_int4(acc[mi][0][hi * 2], acc[mi][1][hi * 2],
                    acc[mi][2][hi * 2], acc[mi][3][hi * 2]);
      *reinterpret_cast<int4*>(p + 4) =
          make_int4(acc[mi][0][hi * 2 + 1], acc[mi][1][hi * 2 + 1],
                    acc[mi][2][hi * 2 + 1], acc[mi][3][hi * 2 + 1]);
    }
  cluster_epilogue<BM, T, kBf16>(tile, scale, out, m, n, m0, n0);
}

template <int BM, int STAGES>
int launch(const int8_t* x, const int8_t* w, const float* scale, void* out,
           int m, int n, int k, bool bf16, int splits, int k_per_split,
           cudaStream_t stream) {
  auto kernel = bf16 ? qmatmul_kernel<BM, STAGES, true>
                     : qmatmul_kernel<BM, STAGES, false>;
  constexpr size_t smem = smem_bytes<BM, STAGES>();
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + kBN - 1) / kBN), (unsigned)splits,
                     (unsigned)((m + BM - 1) / BM));
  cfg.blockDim = dim3(Cfg<BM>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec16 = (n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0);
  rc = cudaLaunchKernelEx(&cfg, kernel, x, w, scale, out, m, n, k,
                          k_per_split, vec16);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace

// out[m, n] = (float(sum_k x[m, k] * w[k, n]) * scale[n]) in bf16 (out_bf16)
// or f32. x int8 [m, k] and w int8 [k, n] row-major, scale f32 [n]; k a
// multiple of 16 and n of 4, x 16-byte and w, scale and out 4-, 16- and
// 16-byte aligned (the wrapper checks). The plan comes from the wrapper
// (kernels/qmatmul.py::qmm_plan): bm in {16, 32, 64, 128} with 6 stages,
// or 128 with 4; K cut into `splits` (1..8, one cluster) runs of
// k_per_split (a multiple of 64). Launches on `stream`, allocates nothing,
// returns the first CUDA error.
extern "C" int repro_qmatmul(const void* x, const void* w, const void* scale,
                             void* out, int m, int n, int k, int out_bf16,
                             int bm, int stages, int splits, int k_per_split,
                             void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || k % 16 || n % 4 || splits < 1 || splits > kMaxSplits ||
      k_per_split <= 0 || k_per_split % kBK ||
      (long long)splits * k_per_split < k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  const bool bf = out_bf16 != 0;
  const int kps = k_per_split;
  if (stages == 6) {
    switch (bm) {
      case 16: return launch<16, 6>(xp, wp, sp, out, m, n, k, bf, splits, kps, s);
      case 32: return launch<32, 6>(xp, wp, sp, out, m, n, k, bf, splits, kps, s);
      case 64: return launch<64, 6>(xp, wp, sp, out, m, n, k, bf, splits, kps, s);
      case 128: return launch<128, 6>(xp, wp, sp, out, m, n, k, bf, splits, kps, s);
    }
  } else if (stages == 4 && bm == 128) {
    return launch<128, 4>(xp, wp, sp, out, m, n, k, bf, splits, kps, s);
  }
  return (int)cudaErrorInvalidValue;
}
