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
// so B3 is bound by bytes at 3.35 TB/s (B4 adds 992 integer ops per 64-byte
// block of a live page, which binds over the bytes at 33.5 T ops/s: B4 is
// bound by integer ops, below). What the design does about
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
//    page j computes, with one barrier of the consumer warps per stage.
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
// XOR applies to whole words. A dead page passes through bit for bit, so B4
// on a ciphertext page gives the bits of B3 on its plaintext. The keystream
// stage is built for the integer-ops bound:
//
//  - Warp specialisation. A B4 CTA has 4 more warps, producers, which
//    compute the keystream of page j + 1 into a two-stage ring while the 4
//    consumer warps copy and attend page j. Named barriers hand the stages
//    over (FULL: producers arrive, consumers wait; EMPTY: the reverse), so
//    the integer pipe works while the copies and the score math run.
//  - Exact work. The blocks that touch the kv head's rows of a page (the
//    same for every page) are listed once at CTA start: 64 for K and 64
//    for V at Llama2-7B's 256-byte rows, so 128 producer threads compute
//    one block each and none waits on a second. Rows that straddle blocks,
//    or that share one (hk * row bytes < 64), count each block once.
//  - Sidecars hoisted. The split's table columns and every page's nonce
//    and live flag are read into shared memory once, at CTA start.
//  - Conflict-free stores. A block's 16 words sit at a stride of 17 words
//    from the next block's: the 32 threads of a warp store word i of 32
//    consecutive blocks into 32 banks.
//  - Dead pages are free: a dead K or V costs no keystream, only the
//    barrier hand-over.

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

constexpr int kThreads = 128;         // consumer threads (B3: all of them)
constexpr int kWarps = kThreads / 32;
constexpr int kProducers = 128;       // B4's keystream threads
constexpr int kKsStages = 2;          // keystream ring depth (pages)
constexpr int kKsStride = 17;         // words from one block to the next
// named barriers: 0 is __syncthreads; the consumers' own, then the ring's
constexpr int kBarConsumers = 1, kBarFull = 2, kBarEmpty = 2 + kKsStages;
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
  int nbr;                 // keystream blocks a page holds for one kv
                           // head's rows, the most over the kv heads (B4)
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

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared memory of a split CTA, in u32 words from the start: the K/V copy
// ring [2][K, V][ps, row_stride]; for B4 the sidecar rows [K, V][pages,
// 4], the keystream ring [kKsStages][K, V][nbr blocks, kKsStride], the
// slot of each row's first block [ps] plus the block count, and the page
// block of each slot [nbr]; then q [g, hd], the warps' m, l [warps, g] and
// acc [warps, g, hd], and the split's table columns [pages].
struct Layout {
  int side, ks, row_slot, blk, qs, st_m, st_l, st_acc, pages, words;
};

__host__ __device__ inline Layout layout(const Geometry& G, bool unseal) {
  const int g = G.h / G.hk;
  Layout L;
  int o = 4 * G.ps * G.row_stride;
  L.side = o;                 // 16-byte aligned: row_stride % 4 == 0
  if (unseal) o += 2 * G.pages_per_split * 4;
  L.ks = o;
  if (unseal) o += kKsStages * 2 * G.nbr * kKsStride;
  L.row_slot = o;
  if (unseal) o += G.ps + 1;
  L.blk = o;
  if (unseal) o += G.nbr;
  L.qs = o;
  o += g * G.hd;
  L.st_m = o;
  o += kWarps * g;
  L.st_l = o;
  o += kWarps * g;
  L.st_acc = o;
  o += kWarps * g * G.hd;
  L.pages = o;
  o += G.pages_per_split;
  L.words = o;
  return L;
}

template <bool kBf16, bool kUnseal, int kWords>
__global__ void __launch_bounds__(kUnseal ? kThreads + kProducers : kThreads)
split_kernel(const void* q, const void* k_pool, const void* v_pool,
             const int* table, const int* valid, float* part_acc,
             float* part_ml, const int* k_crypt, const int* v_crypt, Key key,
             Geometry G) {
  constexpr int kPer = kBf16 ? 2 : 1;       // elements per word
  constexpr int kElems = kWords * kPer;     // elements a lane owns
  constexpr int kAll = kUnseal ? kThreads + kProducers : kThreads;
  extern __shared__ __align__(16) uint32_t smem[];
  const int split = blockIdx.x, kh = blockIdx.y, slot = blockIdx.z;
  const int g = G.h / G.hk, hd = G.hd, ps = G.ps, pps = G.pages_per_split;
  const int stage_words = ps * G.row_stride;
  const Layout L = layout(G, kUnseal);
  uint32_t* stages = smem;                                  // [2][K, V][ps, stride]
  int* side = reinterpret_cast<int*>(smem + L.side);        // [K, V][pages, 4]
  uint32_t* ks = smem + L.ks;                 // [kKsStages][K, V][nbr, 17]
  int* row_slot = reinterpret_cast<int*>(smem + L.row_slot);  // [ps + 1]
  int* blk = reinterpret_cast<int*>(smem + L.blk);          // [nbr]
  float* qs = reinterpret_cast<float*>(smem + L.qs);        // [g, hd]
  float* st_m = reinterpret_cast<float*>(smem + L.st_m);    // [warps, g]
  float* st_l = reinterpret_cast<float*>(smem + L.st_l);    // [warps, g]
  float* st_acc = reinterpret_cast<float*>(smem + L.st_acc);  // [warps, g, hd]
  int* pages = reinterpret_cast<int*>(smem + L.pages);      // [pages]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long head0 = (long long)slot * G.h + (long long)kh * g;
  const int n_valid = valid[slot];
  const int first = split * pps;
  const int live_cols = min(G.max_pages, n_valid > 0 ? (n_valid + ps - 1) / ps : 0);
  const int n_pages = min(first + pps, live_cols) - first;

  if (n_pages <= 0) {   // the split lies wholly past valid: the empty state
    for (int i = tid; i < g * hd; i += kAll) {
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
  // the split's table columns and, for B4, their sidecar rows, once
  for (int i = tid; i < n_pages; i += kAll) {
    const int phys = row_table[first + i];
    pages[i] = phys;
    if (kUnseal) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        side[i * 4 + c] = k_crypt[(long long)phys * 4 + c];
        side[(pps + i) * 4 + c] = v_crypt[(long long)phys * 4 + c];
      }
    }
  }
  if (tid < kThreads) {
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
  } else if (kUnseal && tid == kThreads) {
    // the blocks that touch this kv head's rows of a page, each once, in
    // order; row t's first block is slot row_slot[t], and its later
    // blocks follow it
    int n = 0;
    long long last = -1;
    for (int t = 0; t < ps; ++t) {
      const long long w0 = ((long long)t * G.hk + kh) * G.row_words;
      const long long b0 = w0 >> 4, b1 = (w0 + G.row_words - 1) >> 4;
      row_slot[t] = b0 <= last ? n - 1 : n;
      for (long long b = last + 1 > b0 ? last + 1 : b0; b <= b1; ++b)
        blk[n++] = (int)b;
      last = b1;
    }
    row_slot[ps] = n;
  }
  __syncthreads();

  if (kUnseal && tid >= kThreads) {
    // ---- producers: the keystream of page j into ring stage j % 2 ----
    const int p = tid - kThreads, nb = row_slot[ps];
    for (int j = 0; j < n_pages; ++j) {
      const int s = j % kKsStages;
      if (j >= kKsStages) bar_sync(kBarEmpty + s, kAll);  // page j - 2 read
      for (int i = p; i < 2 * nb; i += kProducers) {
        const int which = i >= nb, b = which ? i - nb : i;
        const int* sd = side + ((which ? pps : 0) + j) * 4;
        if (sd[3] == 0) continue;     // a dead page costs no keystream
        uint32_t words[16];
        repro::chacha20_block(key.w, (uint32_t)sd[0], (uint32_t)sd[1],
                              (uint32_t)sd[2],
                              G.counter_base + (uint32_t)blk[b], words);
        uint32_t* dst = ks + ((s * 2 + which) * G.nbr + b) * kKsStride;
#pragma unroll
        for (int w = 0; w < 16; ++w) dst[w] = words[w];
      }
      __threadfence_block();
      bar_arrive(kBarFull + s, kAll);
    }
    return;
  }

  // ---- consumers: copy and attend ----
  for (int j = 0; j < n_pages; ++j) {
    const int col = first + j;
    bar_sync(kBarConsumers, kThreads);   // page j - 1 is consumed: its stage is free
    if (j + 1 < n_pages) {
      uint32_t* nk = stages + ((j + 1) & 1) * 2 * stage_words;
      issue_page(nk, nk + stage_words, k_pool, v_pool, pages[j + 1], kh, G);
    }
    cp_async_commit();   // possibly empty: the wait below counts groups
    cp_async_wait_one();
    bar_sync(kBarConsumers, kThreads);   // page j's rows are in shared memory

    bool xor_k = false, xor_v = false;
    const uint32_t* ksk = ks;
    const uint32_t* ksv = ks;
    if (kUnseal) {
      const int s = j % kKsStages;
      xor_k = side[j * 4 + 3] != 0;
      xor_v = side[(pps + j) * 4 + 3] != 0;
      ksk = ks + (s * 2) * G.nbr * kKsStride;
      ksv = ksk + G.nbr * kKsStride;
      bar_sync(kBarFull + s, kAll);      // page j's keystream is in its stage
    }
    const uint32_t* kst = stages + (j & 1) * 2 * stage_words;
    const uint32_t* vst = kst + stage_words;
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
        // B4: the ring word lane's word `lane` of the row XORs; word
        // lane + 32 i sits two blocks further per i
        int ks0[kRows] = {};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int t = t0 + r * kWarps;
          live[r] = t < ps && col * ps + t < n_valid;   // warp-uniform
          float sum = 0.f;
          if (live[r]) {
            if (kUnseal) {
              const int off = (((t * G.hk + kh) * G.row_words) & 15) + lane;
              ks0[r] = (row_slot[t] + (off >> 4)) * kKsStride + (off & 15);
            }
#pragma unroll
            for (int i = 0; i < kWords; ++i) {
              const int w = lane + 32 * i;
              if (w >= G.row_words) continue;
              uint32_t kw = kst[t * G.row_stride + w];
              if (xor_k) kw ^= ksk[ks0[r] + 2 * kKsStride * i];
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
            if (xor_v) vw ^= ksv[ks0[r] + 2 * kKsStride * i];
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
    if (kUnseal && j + kKsStages < n_pages)
      bar_arrive(kBarEmpty + j % kKsStages, kAll);   // its stage is free
  }
  bar_sync(kBarConsumers, kThreads);

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
  constexpr int threads = kUnseal ? kThreads + kProducers : kThreads;
  split_kernel<kBf16, kUnseal, kWords><<<grid, threads, smem, stream>>>(
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

// B4's keystream blocks per page for one kv head's rows, the most over the
// kv heads: every block that touches a row of the head, each counted once
// (split_kernel lists the same blocks for its own head).
int keystream_blocks(int hk, int ps, int row_words) {
  int most = 0;
  for (int kh = 0; kh < hk; ++kh) {
    int n = 0;
    long long last = -1;
    for (int t = 0; t < ps; ++t) {
      const long long w0 = ((long long)t * hk + kh) * row_words;
      const long long b0 = w0 >> 4, b1 = (w0 + row_words - 1) >> 4;
      n += (int)(b1 - (last + 1 > b0 ? last + 1 : b0) + 1);
      last = b1;
    }
    most = n > most ? n : most;
  }
  return most;
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
             (row_words + 3) / 4 * 4, copy_bytes,
             unseal ? keystream_blocks(hk, ps, row_words) : 0, scale,
             counter_base};
  Key key;
  for (int i = 0; i < 8; ++i) key.w[i] = unseal ? key_words[i] : 0u;
  const size_t smem = sizeof(uint32_t) * (size_t)layout(G, unseal).words;
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
