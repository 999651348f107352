// Paged decode attention (one query token per slot, GQA, online softmax over
// a page table), optionally decrypting ciphertext-resident pages on the way
// in: kernels B3 and B4 of the port.
//
// Replaces the TPU kernels src/repro/kernels/paged_attention.py::
// paged_attention (body _paged_kernel) and ::paged_attention_unseal (body
// _paged_unseal_kernel, _unseal_tile, _page_keystream). The TPU grid walked
// (slot, page) with pages innermost and carried m, l, acc in VMEM scratch
// from one grid step to the next. Here one CTA owns one (slot, kv head) pair
// (a GQA group of g = h / hk query heads) and walks that slot's pages in a
// loop, with the group's q, accumulator and the current page's K and V rows
// staged in shared memory as f32. Per page: every warp takes (query, key)
// pairs and reduces q.k across its lanes with a fixed shuffle tree; one
// thread per query head runs the reference's update in its order (m_new,
// p = exp(s - m_new), alpha, l); then every thread owns (head, d) entries of
// acc = acc * alpha + p.v, summed over the page in position order. No atomics
// and a fixed order everywhere, so identical inputs give identical bits, and
// B4 on a ciphertext page gives the bits of B3 on its plaintext.
//
// B4: a page whose sidecar flag (word 3) is nonzero is XORed with its
// keystream as it is loaded. Linear u32 word w of the page's bytes takes
// word w % 16 of ChaCha20 block counter_base + w / 16 (counter_base =
// layer * blocks_per_page) under the sidecar's nonce; a bf16 element e takes
// the low half of word e / 2 when e is even, the high half when odd. A CTA's
// rows need not cover whole 64-byte blocks, so each CTA computes every block
// that touches its rows, even where a neighbouring head's CTA computes it
// too.
//
// Bound on an H100 SXM: decode attention reads each K and V element once,
// 2 * hd * bytes per token per kv head, and does 4 flops per element; at
// 3.35 TB/s bytes bind (B4 adds 992 integer ops per 64-byte block, which
// stays under the bytes at 33.5 T ops/s). This is the simple, correct
// version: the page loop is serial per CTA, loads are element-wide, and
// only b * hk CTAs run, which leaves most SMs idle at small batch. Wider
// loads, several pages in flight and a split of long contexts across CTAs
// are later work.
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
constexpr float kNegInf = -1e30f;

struct Key {
  uint32_t w[8];
};

struct Geometry {
  int h, hk, hd, ps, max_pages;
  int nbr;                 // keystream blocks kept per row (B4)
  float scale;
  uint32_t counter_base;   // layer * blocks_per_page (B4)
};

// Element bits: bf16 pools are read as their u16 bits, f32 as u32 bits, so
// the XOR works on the bits and the conversion to f32 is exact.
template <bool kBf16>
__device__ __forceinline__ uint32_t load_bits(const void* p, long long i) {
  if (kBf16) return static_cast<const uint16_t*>(p)[i];
  return static_cast<const uint32_t*>(p)[i];
}

template <bool kBf16>
__device__ __forceinline__ float bits_to_f32(uint32_t b) {
  return kBf16 ? __uint_as_float(b << 16) : __uint_as_float(b);
}

template <bool kBf16>
__device__ __forceinline__ void store_f32(void* p, long long i, float x) {
  if (kBf16) {
    static_cast<uint16_t*>(p)[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  } else {
    static_cast<float*>(p)[i] = x;
  }
}

// The u32 word of the page that holds element e.
template <bool kBf16>
__device__ __forceinline__ long long row_word(long long e) {
  return kBf16 ? (e >> 1) : e;
}

template <bool kBf16, bool kUnseal>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const void* q, const void* k_pool, const void* v_pool,
                       const int* table, const int* valid, void* out,
                       const int* k_crypt, const int* v_crypt, Key key,
                       Geometry G) {
  extern __shared__ float smem[];
  const int slot = blockIdx.x / G.hk;
  const int kh = blockIdx.x % G.hk;
  const int g = G.h / G.hk, hd = G.hd, ps = G.ps, hk = G.hk;
  float* qs = smem;                 // [g, hd] the group's queries
  float* acc = qs + g * hd;         // [g, hd]
  float* kt = acc + g * hd;         // [ps, hd] this page's K rows, f32
  float* vt = kt + ps * hd;         // [ps, hd]
  float* sp = vt + ps * hd;         // [g, ps] scores, then probabilities
  float* ml = sp + g * ps;          // m [g], l [g], alpha [g]
  uint32_t* ks = reinterpret_cast<uint32_t*>(ml + 3 * g);  // [2, ps, nbr, 16]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long page_elems = (long long)ps * hk * hd;
  const long long q0 = ((long long)slot * G.h + (long long)kh * g) * hd;

  for (int i = tid; i < g * hd; i += kThreads) {
    qs[i] = bits_to_f32<kBf16>(load_bits<kBf16>(q, q0 + i));
    acc[i] = 0.f;
  }
  if (tid < g) {
    ml[tid] = kNegInf;
    ml[g + tid] = 0.f;
  }
  const int n_valid = valid[slot];
  __syncthreads();

  for (int j = 0; j < G.max_pages && j * ps < n_valid; ++j) {
    const long long phys = table[(long long)slot * G.max_pages + j];
    const long long base = phys * page_elems;
    bool live_k = false, live_v = false;
    if (kUnseal) {
      live_k = k_crypt[phys * 4 + 3] != 0;
      live_v = v_crypt[phys * 4 + 3] != 0;
      // the keystream blocks that touch this head's ps rows, for K and V
      for (int i = tid; i < 2 * ps * G.nbr; i += kThreads) {
        const int which = i / (ps * G.nbr);
        const int t = (i / G.nbr) % ps;
        const int bi = i % G.nbr;
        const int* crypt = which ? v_crypt : k_crypt;
        if (!(which ? live_v : live_k)) continue;
        const long long e0 = ((long long)t * hk + kh) * hd;
        const long long b0 = row_word<kBf16>(e0) >> 4;
        const long long b1 = row_word<kBf16>(e0 + hd - 1) >> 4;
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
      __syncthreads();
    }
    for (int i = tid; i < ps * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      const long long e0 = ((long long)t * hk + kh) * hd;
      const long long e = e0 + d;              // element within the page
      uint32_t kb = load_bits<kBf16>(k_pool, base + e);
      uint32_t vb = load_bits<kBf16>(v_pool, base + e);
      if (kUnseal && (live_k || live_v)) {
        const long long w = row_word<kBf16>(e);
        const long long bi = (w >> 4) - (row_word<kBf16>(e0) >> 4);
        const long long at = (long long)t * G.nbr + bi;
        uint32_t kw = ks[at * 16 + (w & 15)];
        uint32_t vw = ks[((long long)ps * G.nbr + at) * 16 + (w & 15)];
        if (kBf16) {
          kw = (e & 1) ? (kw >> 16) : (kw & 0xFFFFu);
          vw = (e & 1) ? (vw >> 16) : (vw & 0xFFFFu);
        }
        if (live_k) kb ^= kw;
        if (live_v) vb ^= vw;
      }
      kt[i] = bits_to_f32<kBf16>(kb);
      vt[i] = bits_to_f32<kBf16>(vb);
    }
    __syncthreads();

    // scores: one (query head, key position) pair per warp at a time
    for (int pr = warp; pr < g * ps; pr += kWarps) {
      const int gi = pr / ps, t = pr % ps;
      float sum = 0.f;
      for (int d = lane; d < hd; d += 32) sum += qs[gi * hd + d] * kt[t * hd + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) sp[pr] = (j * ps + t < n_valid) ? sum * G.scale : kNegInf;
    }
    __syncthreads();

    // the online-softmax update, one thread per query head
    if (tid < g) {
      const float m_prev = ml[tid];
      float mx = sp[tid * ps];
      for (int t = 1; t < ps; ++t) mx = fmaxf(mx, sp[tid * ps + t]);
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sp[tid * ps + t] - m_new);
        sp[tid * ps + t] = p;
        psum += p;
      }
      const float alpha = expf(m_prev - m_new);
      ml[tid] = m_new;
      ml[g + tid] = ml[g + tid] * alpha + psum;
      ml[2 * g + tid] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < g * hd; i += kThreads) {
      const int gi = i / hd, d = i % hd;
      float pv = 0.f;
      for (int t = 0; t < ps; ++t) pv += sp[gi * ps + t] * vt[t * hd + d];
      acc[i] = acc[i] * ml[2 * g + gi] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd;
    store_f32<kBf16>(out, q0 + i, acc[i] / fmaxf(ml[g + gi], 1e-30f));
  }
}

template <bool kBf16, bool kUnseal>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* valid, void* out, const int* k_crypt,
           const int* v_crypt, const Key& key, const Geometry& G, int b,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        paged_attention_kernel<kBf16, kUnseal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  paged_attention_kernel<kBf16, kUnseal>
      <<<(unsigned int)(b * G.hk), kThreads, smem, stream>>>(
          q, k_pool, v_pool, table, valid, out, k_crypt, v_crypt, key, G);
  return (int)cudaGetLastError();
}

}  // namespace

// out[b, h, hd] = paged decode attention of q[b, h, hd] over the pools
// [P+1, ps, hk, hd] through table[b, max_pages] up to valid[b]. f32 or bf16
// (is_bf16) for q, pools and out alike. With k_crypt and v_crypt ([P+1, 4]
// int32 sidecars) the pages whose flag is live are decrypted first under the
// 8 host key words, counters from counter_base; with null sidecars the
// kernel is B3. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* valid, void* out, int b, int h, int hk, int hd, int ps,
    int max_pages, int is_bf16, float scale, const void* k_crypt,
    const void* v_crypt, const unsigned int* key_words,
    unsigned int counter_base, void* stream) {
  if (b <= 0) return 0;
  const bool unseal = k_crypt != nullptr && v_crypt != nullptr;
  const int g = h / hk;
  const int es = is_bf16 ? 2 : 4;
  Geometry G{h, hk, hd, ps, max_pages, (hd * es + 63) / 64 + 1, scale,
             counter_base};
  Key key;
  for (int i = 0; i < 8; ++i) key.w[i] = unseal ? key_words[i] : 0u;
  size_t smem = sizeof(float) * (2 * g * hd + 2 * ps * hd + g * ps + 3 * g);
  if (unseal) smem += sizeof(uint32_t) * 2 * ps * G.nbr * 16;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(table);
  const int* v = static_cast<const int*>(valid);
  const int* kc = static_cast<const int*>(k_crypt);
  const int* vc = static_cast<const int*>(v_crypt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return unseal ? launch<true, true>(q, k_pool, v_pool, t, v, out, kc, vc,
                                       key, G, b, smem, s)
                  : launch<true, false>(q, k_pool, v_pool, t, v, out, kc, vc,
                                        key, G, b, smem, s);
  }
  return unseal ? launch<false, true>(q, k_pool, v_pool, t, v, out, kc, vc,
                                      key, G, b, smem, s)
                : launch<false, false>(q, k_pool, v_pool, t, v, out, kc, vc,
                                       key, G, b, smem, s);
}
