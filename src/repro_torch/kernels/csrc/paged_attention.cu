// Paged decode attention (one query token per slot, GQA, online softmax over
// a page table), optionally decrypting ciphertext-resident pages on the way
// in: kernels B3 and B4 of the port, as split-KV decode attention ("flash
// decoding") in two launches.
//
// Replaces the TPU kernels src/repro/kernels/paged_attention.py::
// paged_attention (body _paged_kernel) and ::paged_attention_unseal (body
// _paged_unseal_kernel, _unseal_tile, _page_keystream). The TPU grid walked
// (slot, page) with pages innermost and carried m, l, acc in VMEM scratch
// from one grid step to the next; blocks on a GPU run in parallel and carry
// nothing, so the walk is cut into splits and merged by a second launch.
//
// Bound on an H100 SXM: decode attention reads each attended K and V element
// once, 2 * hd * bytes per token per kv head, and does 4 flops per element,
// so bytes bind at 3.35 TB/s (B4 adds 992 integer ops per 64-byte block,
// which stays under the bytes at 33.5 T ops/s). What the design does about
// what held the first version (one CTA per (slot, kv head) walking every page
// serially, element-wide loads, a one-thread softmax) far from that bound:
//
//  - Grid over (split, kv head, slot). A split is a fixed run of
//    pages_per_split table columns, chosen by the wrapper from the page size
//    alone (kernels/paged_attention.py::split_geometry), so a slot's splits,
//    and its output bits, never depend on the batch size, the SM count or
//    another slot's valid length. A split wholly past valid[slot] writes the
//    empty state (m = -1e30, l = 0, acc = 0) and exits.
//  - Loads. Each K and V row of the head is copied with cp.async in 16-byte
//    units (8 or 4 bytes where the row or the pool is not 16-byte aligned)
//    into a two-stage ring in shared memory: page j + 1 is in flight while
//    page j computes, with one __syncthreads per stage.
//  - Scores and softmax in parallel. Warp w owns rows w, w + 4, ... of each
//    page; lane i owns u32 words i, i + 32, ... of a row (two bf16 elements
//    or one f32 element each), sums its q.k products and a fixed xor-shuffle
//    tree reduces them, so every lane holds the score. A warp scores its
//    rows of a page together (kRows at a time, their shuffle trees
//    interleaved) and runs one online update over them (m_new, alpha, p, l,
//    as the reference does per page) on every lane at once. Each warp keeps
//    its own (m, l, acc) per query head of the GQA group; every loaded K or
//    V row serves the g query heads of the group. At the end of the split the warps
//    merge in warp order through shared memory and write f32 partials
//    acc [b, h, n_splits, hd] and (m, l) [b, h, n_splits, 2].
//  - Combine. A second launch over (slot, head) merges the live splits in
//    split order: m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i
//    e^(m_i - m), out = acc / max(l, 1e-30). An empty split would add exact
//    zeros, so reading only the live ones changes no bit; a slot with
//    valid = 0 gives 0. No atomics and a fixed order everywhere: identical
//    inputs give identical bits.
//
// B4: a page whose sidecar flag (word 3) is nonzero is XORed with its
// keystream as its words are read from shared memory. Linear u32 word w of
// the page's bytes takes word w % 16 of ChaCha20 block counter_base + w / 16
// (counter_base = layer * blocks_per_page) under the sidecar's nonce; a bf16
// pair is one little-endian word (the even element the low half), so the
// XOR applies to whole words. The keystream stage is the first version's:
// per page of its split, a CTA computes every block that touches its rows
// (while that page's copy is in flight), even where a neighbouring head's
// CTA computes it too. A dead page passes through bit for bit, so B4 on a
// ciphertext page gives the bits of B3 on its plaintext.
//
// Rows must be whole u32 words (every f32 row; bf16 rows of even hd) of at
// most 32 * kMaxWords words.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (a plain C interface, loaded with ctypes)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chacha20_block.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 8;          // u32 words of a row per lane
constexpr int kRows = 4;              // rows of a page a warp scores together
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1e30f;

struct Key {
  uint32_t w[8];
};

struct Geometry {
  int h, hk, hd, ps, max_pages;
  int pages_per_split, n_splits;
  int row_words;           // u32 words in one head's row: hd * bytes / 4
  int row_stride;          // shared-memory row stride in words (multiple of 4)
  int copy_bytes;          // cp.async unit: 16, 8 or 4
  int nbr;                 // keystream blocks kept per row (B4)
  float scale;
  uint32_t counter_base;   // layer * blocks_per_page (B4)
};

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(N));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group (the next page's) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_rows(uint32_t* dk, uint32_t* dv,
                                          const char* k, const char* v,
                                          long long row0, const Geometry& G) {
  const int row_bytes = G.row_words * 4;
  const int per_row = row_bytes / N;
  const long long stride = (long long)G.hk * row_bytes;  // page row to row
  for (int i = threadIdx.x; i < G.ps * per_row; i += kThreads) {
    const int r = i / per_row, c = i - r * per_row;
    const long long src = row0 + r * stride + (long long)c * N;
    const int dst = r * G.row_stride * 4 + c * N;
    cp_async<N>(reinterpret_cast<char*>(dk) + dst, k + src);
    cp_async<N>(reinterpret_cast<char*>(dv) + dst, v + src);
  }
}

// Issue the copies of one page's K and V rows of kv head kh into a stage.
__device__ __forceinline__ void issue_page(uint32_t* dk, uint32_t* dv,
                                           const void* k_pool,
                                           const void* v_pool, long long phys,
                                           int kh, const Geometry& G) {
  const char* k = static_cast<const char*>(k_pool);
  const char* v = static_cast<const char*>(v_pool);
  const long long row0 = (phys * G.ps * G.hk + kh) * (long long)G.row_words * 4;
  if (G.copy_bytes == 16) {
    copy_rows<16>(dk, dv, k, v, row0, G);
  } else if (G.copy_bytes == 8) {
    copy_rows<8>(dk, dv, k, v, row0, G);
  } else {
    copy_rows<4>(dk, dv, k, v, row0, G);
  }
}

template <bool kBf16>
__device__ __forceinline__ float elem_f32(const void* p, long long i) {
  if (kBf16) {
    return __uint_as_float(
        static_cast<uint32_t>(static_cast<const uint16_t*>(p)[i]) << 16);
  }
  return static_cast<const float*>(p)[i];
}

template <bool kBf16>
__device__ __forceinline__ void store_f32(void* p, long long i, float x) {
  if (kBf16) {
    static_cast<uint16_t*>(p)[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  } else {
    static_cast<float*>(p)[i] = x;
  }
}

// A row word as f32 elements: bf16 low half (the even element) first.
template <bool kBf16>
__device__ __forceinline__ void word_f32(uint32_t w, float* out) {
  if (kBf16) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xFFFF0000u);
  } else {
    out[0] = __uint_as_float(w);
  }
}

// Where word w of row t (kv head kh) of a page sits in the K half of the
// keystream stage [2, ps, nbr, 16]: linear page word pw takes word pw % 16
// of the row's block pw / 16 - (first word of the row) / 16.
__device__ __forceinline__ int ks_word(int t, int w, int kh,
                                       const Geometry& G) {
  const long long w0 = ((long long)t * G.hk + kh) * G.row_words;
  const long long pw = w0 + w;
  return (int)(((long long)t * G.nbr + (pw >> 4) - (w0 >> 4)) * 16 + (pw & 15));
}

template <bool kBf16, bool kUnseal, int kWords>
__global__ void __launch_bounds__(kThreads)
split_kernel(const void* q, const void* k_pool, const void* v_pool,
             const int* table, const int* valid, float* part_acc,
             float* part_ml, const int* k_crypt, const int* v_crypt, Key key,
             Geometry G) {
  constexpr int kPer = kBf16 ? 2 : 1;       // elements per word
  constexpr int kElems = kWords * kPer;     // elements a lane owns
  extern __shared__ __align__(16) uint32_t smem[];
  const int split = blockIdx.x, kh = blockIdx.y, slot = blockIdx.z;
  const int g = G.h / G.hk, hd = G.hd, ps = G.ps;
  const int stage_words = ps * G.row_stride;
  uint32_t* stages = smem;                                  // [2][K, V][ps, stride]
  float* qs = reinterpret_cast<float*>(smem + 4 * stage_words);  // [g, hd]
  float* st_m = qs + g * hd;                                // [warps, g]
  float* st_l = st_m + kWarps * g;                          // [warps, g]
  float* st_acc = st_l + kWarps * g;                        // [warps, g, hd]
  uint32_t* ks = reinterpret_cast<uint32_t*>(st_acc + kWarps * g * hd);
                                                            // [2, ps, nbr, 16]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long head0 = (long long)slot * G.h + (long long)kh * g;
  const int n_valid = valid[slot];
  const int first = split * G.pages_per_split;
  const int live_cols = min(G.max_pages, n_valid > 0 ? (n_valid + ps - 1) / ps : 0);
  const int n_pages = min(first + G.pages_per_split, live_cols) - first;

  if (n_pages <= 0) {   // the split lies wholly past valid: the empty state
    for (int i = tid; i < g * hd; i += kThreads) {
      const long long at = (head0 + i / hd) * G.n_splits + split;
      part_acc[at * hd + i % hd] = 0.f;
      if (i % hd == 0) {
        part_ml[at * 2] = kNegInf;
        part_ml[at * 2 + 1] = 0.f;
      }
    }
    return;
  }

  const int* row_table = table + (long long)slot * G.max_pages;
  issue_page(stages, stages + stage_words, k_pool, v_pool, row_table[first],
             kh, G);
  cp_async_commit();

  for (int i = tid; i < g * hd; i += kThreads) {
    qs[i] = elem_f32<kBf16>(q, head0 * hd + i);
  }
  for (int i = tid; i < kWarps * g * hd; i += kThreads) st_acc[i] = 0.f;
  for (int i = tid; i < kWarps * g; i += kThreads) {
    st_m[i] = kNegInf;
    st_l[i] = 0.f;
  }
  for (int j = 0; j < n_pages; ++j) {
    const int col = first + j;
    __syncthreads();   // page j - 1 is consumed: its stage and ks are free
    if (j + 1 < n_pages) {
      uint32_t* nk = stages + ((j + 1) & 1) * 2 * stage_words;
      issue_page(nk, nk + stage_words, k_pool, v_pool, row_table[col + 1], kh,
                 G);
    }
    cp_async_commit();   // possibly empty: the wait below counts groups

    bool live_k = false, live_v = false;
    if (kUnseal) {
      const long long phys = row_table[col];
      live_k = k_crypt[phys * 4 + 3] != 0;
      live_v = v_crypt[phys * 4 + 3] != 0;
      // the keystream blocks that touch this head's ps rows, for K and V
      for (int i = tid; i < 2 * ps * G.nbr; i += kThreads) {
        const int which = i / (ps * G.nbr);
        const int t = (i / G.nbr) % ps;
        const int bi = i % G.nbr;
        if (!(which ? live_v : live_k)) continue;
        const int* crypt = which ? v_crypt : k_crypt;
        const long long w0 = ((long long)t * G.hk + kh) * G.row_words;
        const long long b0 = w0 >> 4;
        const long long b1 = (w0 + G.row_words - 1) >> 4;
        if (b0 + bi > b1) continue;
        uint32_t words[16];
        repro::chacha20_block(key.w, (uint32_t)crypt[phys * 4 + 0],
                              (uint32_t)crypt[phys * 4 + 1],
                              (uint32_t)crypt[phys * 4 + 2],
                              G.counter_base + (uint32_t)(b0 + bi), words);
        uint32_t* dst = ks + ((long long)(which * ps + t) * G.nbr + bi) * 16;
#pragma unroll
        for (int w = 0; w < 16; ++w) dst[w] = words[w];
      }
    }
    cp_async_wait_one();
    __syncthreads();   // page j's rows (and keystream) are in shared memory

    const uint32_t* kst = stages + (j & 1) * 2 * stage_words;
    const uint32_t* vst = kst + stage_words;
    const bool xor_k = kUnseal && live_k, xor_v = kUnseal && live_v;
    for (int gi = 0; gi < g; ++gi) {
      const int si = warp * g + gi;
      float m = st_m[si], l = st_l[si];
      float acc[kElems], qv[kElems];
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int w = lane + 32 * i;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const bool in = w < G.row_words;
          acc[i * kPer + e] = in ? st_acc[si * hd + w * kPer + e] : 0.f;
          qv[i * kPer + e] = in ? qs[gi * hd + w * kPer + e] : 0.f;
        }
      }
      // the warp's rows t0, t0 + 4, ... (kRows of them) scored together,
      // then one update: m_new, alpha, p, l as the reference's per page
      for (int t0 = warp; t0 < ps; t0 += kWarps * kRows) {
        float sc[kRows];
        bool live[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int t = t0 + r * kWarps;
          live[r] = t < ps && col * ps + t < n_valid;   // warp-uniform
          float sum = 0.f;
          if (live[r]) {
#pragma unroll
            for (int i = 0; i < kWords; ++i) {
              const int w = lane + 32 * i;
              if (w >= G.row_words) continue;
              uint32_t kw = kst[t * G.row_stride + w];
              if (xor_k) kw ^= ks[ks_word(t, w, kh, G)];
              float kf[kPer];
              word_f32<kBf16>(kw, kf);
#pragma unroll
              for (int e = 0; e < kPer; ++e) sum = fmaf(qv[i * kPer + e], kf[e], sum);
            }
          }
          sc[r] = sum;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
        }
        float m_new = m;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          sc[r] *= G.scale;
          if (live[r]) m_new = fmaxf(m_new, sc[r]);
        }
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[e] *= alpha;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (!live[r]) continue;
          const int t = t0 + r * kWarps;
          const float p = expf(sc[r] - m_new);
          l += p;
#pragma unroll
          for (int i = 0; i < kWords; ++i) {
            const int w = lane + 32 * i;
            if (w >= G.row_words) continue;
            uint32_t vw = vst[t * G.row_stride + w];
            if (xor_v) vw ^= ks[ps * G.nbr * 16 + ks_word(t, w, kh, G)];
            float vf[kPer];
            word_f32<kBf16>(vw, vf);
#pragma unroll
            for (int e = 0; e < kPer; ++e)
              acc[i * kPer + e] = fmaf(p, vf[e], acc[i * kPer + e]);
          }
        }
        m = m_new;
      }
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int w = lane + 32 * i;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          if (w < G.row_words) st_acc[si * hd + w * kPer + e] = acc[i * kPer + e];
        }
      }
      if (lane == 0) {
        st_m[si] = m;
        st_l[si] = l;
      }
    }
  }
  __syncthreads();

  // merge the warps' states in warp order and write this split's partials
  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd, d = i % hd;
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, st_m[w * g + gi]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(st_m[w * g + gi] - m);
      l = fmaf(st_l[w * g + gi], c, l);
      a = fmaf(st_acc[(w * g + gi) * hd + d], c, a);
    }
    const long long at = (head0 + gi) * G.n_splits + split;
    part_acc[at * hd + d] = a;
    if (d == 0) {
      part_ml[at * 2] = m;
      part_ml[at * 2 + 1] = l;
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* part_acc, const float* part_ml, const int* valid,
               void* out, Geometry G) {
  extern __shared__ float weight[];   // [n_splits]
  const long long head = blockIdx.x;  // slot * h + query head
  const int slot = (int)(head / G.h);
  const int n_valid = valid[slot];
  const int live_cols =
      min(G.max_pages, n_valid > 0 ? (n_valid + G.ps - 1) / G.ps : 0);
  const int n = (live_cols + G.pages_per_split - 1) / G.pages_per_split;
  const float* ml = part_ml + head * G.n_splits * 2;
  float m = kNegInf;
  for (int i = 0; i < n; ++i) m = fmaxf(m, ml[2 * i]);
  for (int i = threadIdx.x; i < n; i += kCombineThreads)
    weight[i] = expf(ml[2 * i] - m);
  __syncthreads();
  float l = 0.f;
  for (int i = 0; i < n; ++i) l = fmaf(ml[2 * i + 1], weight[i], l);
  const float denom = fmaxf(l, 1e-30f);
  const float* acc = part_acc + head * G.n_splits * G.hd;
  for (int d = threadIdx.x; d < G.hd; d += kCombineThreads) {
    float a = 0.f;
    for (int i = 0; i < n; ++i) a = fmaf(acc[(long long)i * G.hd + d], weight[i], a);
    store_f32<kBf16>(out, head * G.hd + d, a / denom);
  }
}

template <bool kBf16, bool kUnseal, int kWords>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* valid, void* out, float* part_acc,
           float* part_ml, const int* k_crypt, const int* v_crypt,
           const Key& key, const Geometry& G, int b, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        split_kernel<kBf16, kUnseal, kWords>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((unsigned)G.n_splits, (unsigned)G.hk, (unsigned)b);
  split_kernel<kBf16, kUnseal, kWords><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, table, valid, part_acc, part_ml, k_crypt, v_crypt,
      key, G);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  combine_kernel<kBf16><<<(unsigned)(b * G.h), kCombineThreads,
                          sizeof(float) * G.n_splits, stream>>>(
      part_acc, part_ml, valid, out, G);
  return (int)cudaGetLastError();
}

// the launch for a lane's words per row, 1, 2, 4 or 8
template <bool kBf16, bool kUnseal, typename... Args>
int launch_words(int words, Args... args) {
  if (words <= 1) return launch<kBf16, kUnseal, 1>(args...);
  if (words <= 2) return launch<kBf16, kUnseal, 2>(args...);
  if (words <= 4) return launch<kBf16, kUnseal, 4>(args...);
  return launch<kBf16, kUnseal, kMaxWords>(args...);
}

}  // namespace

// out[b, h, hd] = paged decode attention of q[b, h, hd] over the pools
// [P+1, ps, hk, hd] through table[b, max_pages] up to valid[b]. f32 or bf16
// (is_bf16) for q, pools and out alike. The walk is cut into
// ceil(max_pages / pages_per_split) splits whose f32 partials go to
// part_acc [b, h, n_splits, hd] and part_ml [b, h, n_splits, 2] (workspace
// the caller allocates), then a second launch merges them. With k_crypt
// and v_crypt ([P+1, 4] int32 sidecars) the pages whose flag is live are
// decrypted first under the 8 host key words, counters from counter_base;
// with null sidecars the kernel is B3. Launches on `stream`, allocates
// nothing, returns the first launch error (cudaGetLastError()).
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* valid, void* out, void* part_acc, void* part_ml, int b, int h,
    int hk, int hd, int ps, int max_pages, int pages_per_split, int is_bf16,
    float scale, const void* k_crypt, const void* v_crypt,
    const unsigned int* key_words, unsigned int counter_base, void* stream) {
  if (b <= 0) return 0;
  const bool unseal = k_crypt != nullptr && v_crypt != nullptr;
  const int g = h / hk;
  const int es = is_bf16 ? 2 : 4;
  const int row_bytes = hd * es;
  if (row_bytes % 4 || row_bytes > 4 * 32 * kMaxWords || pages_per_split <= 0 ||
      max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool);
  int copy_bytes = 4;
  if (row_bytes % 16 == 0 && align % 16 == 0) {
    copy_bytes = 16;
  } else if (row_bytes % 8 == 0 && align % 8 == 0) {
    copy_bytes = 8;
  } else if (align % 4) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int row_words = row_bytes / 4;
  Geometry G{h, hk, hd, ps, max_pages, pages_per_split,
             (max_pages + pages_per_split - 1) / pages_per_split, row_words,
             (row_words + 3) / 4 * 4, copy_bytes, (row_bytes + 63) / 64 + 1,
             scale, counter_base};
  Key key;
  for (int i = 0; i < 8; ++i) key.w[i] = unseal ? key_words[i] : 0u;
  size_t smem = sizeof(uint32_t) * 4 * ps * G.row_stride +
                sizeof(float) * (g * hd + 2 * kWarps * g + kWarps * g * hd);
  if (unseal) smem += sizeof(uint32_t) * 2 * ps * G.nbr * 16;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(table);
  const int* v = static_cast<const int*>(valid);
  const int* kc = static_cast<const int*>(k_crypt);
  const int* vc = static_cast<const int*>(v_crypt);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (row_words + 31) / 32;
  if (is_bf16) {
    return unseal ? launch_words<true, true>(words, q, k_pool, v_pool, t, v,
                                             out, pa, pm, kc, vc, key, G, b,
                                             smem, s)
                  : launch_words<true, false>(words, q, k_pool, v_pool, t, v,
                                              out, pa, pm, kc, vc, key, G, b,
                                              smem, s);
  }
  return unseal ? launch_words<false, true>(words, q, k_pool, v_pool, t, v,
                                            out, pa, pm, kc, vc, key, G, b,
                                            smem, s)
                : launch_words<false, false>(words, q, k_pool, v_pool, t, v,
                                             out, pa, pm, kc, vc, key, G, b,
                                             smem, s);
}
