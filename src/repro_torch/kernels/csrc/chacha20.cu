// ChaCha20 (RFC 8439, 20 rounds) keystream XOR over the word-major blocked
// layout: data is uint32 [16, N], word w of 64-byte block b at data[w*N + b],
// block b encrypted under counter (counter_base + b) mod 2^32.
//
// Replaces the TPU kernel src/repro/kernels/chacha20.py::chacha20_xor_blocked
// (body _xor_kernel, rounds chacha_block_words). On the TPU each lane of a
// (16, 1024) VMEM tile computed one block; here each thread computes one
// block with the 16 state words in registers, and the word-major layout
// makes every one of the 16 loads and stores of a warp coalesce (thread b
// touches data[w*N + b], neighbouring threads neighbouring addresses).
//
// Bound on an H100 SXM: per 64-byte block the kernel moves 128 bytes (64 read,
// 64 written) and executes 992 integer operations (80 quarter rounds of 4
// adds, 4 xors and 4 rotates, 16 feed-forward adds and 16 data xors). At
// 3.35 TB/s the bytes take 38.2 ps per block; at one 32-bit op per lane per
// clock on 128 lanes per SM (33.5 T ops/s, the issue rate behind the card's
// 67 TFLOP/s fp32 figure) the operations take 29.6 ps. Memory binds, with
// the integer work close behind: the design keeps each block's words in
// registers, reads and writes every byte once, and coalesces every access.
// This is the simple, correct version; making it fast (wider loads, fewer
// instructions per round) is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (a plain C interface, loaded with ctypes)

#include <cuda_runtime.h>
#include <stdint.h>

#include "chacha20_block.cuh"

namespace {

struct KeyNonce {
  uint32_t w[11];  // key words 0..7, nonce words 8..10
};

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chacha20_xor_kernel(const uint32_t* in, uint32_t* out, long long n,
                    KeyNonce kn, uint32_t counter_base) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n) return;

  // in may equal out (in-place XOR): every word is read before any is
  // written, and no other thread touches this block's words.
  uint32_t d[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) d[w] = in[(long long)w * n + b];

  uint32_t ks[16];
  // the counter wraps mod 2^32 like the TPU kernel's
  repro::chacha20_block(kn.w, kn.w[8], kn.w[9], kn.w[10],
                        counter_base + (uint32_t)b, ks);
#pragma unroll
  for (int w = 0; w < 16; ++w) out[(long long)w * n + b] = d[w] ^ ks[w];
}

}  // namespace

// XOR n_blocks 64-byte blocks of `in` ([16, n_blocks] uint32, word-major)
// with the keystream into `out` (may equal `in`). key_nonce points to 11
// host words (key 0..7, nonce 8..10), passed to the kernel by value.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int repro_chacha20_xor(const void* in, void* out, long long n_blocks,
                                  const unsigned int* key_nonce,
                                  unsigned int counter_base, void* stream) {
  if (n_blocks <= 0) return 0;
  KeyNonce kn;
  for (int i = 0; i < 11; ++i) kn.w[i] = key_nonce[i];
  const long long grid = (n_blocks + kThreads - 1) / kThreads;
  chacha20_xor_kernel<<<(unsigned int)grid, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n_blocks, kn, counter_base);
  return (int)cudaGetLastError();
}
