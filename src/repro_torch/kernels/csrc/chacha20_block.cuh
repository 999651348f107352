// The RFC 8439 ChaCha20 block function (20 rounds), shared by the ChaCha20
// XOR kernel (chacha20.cu) and the fused-unseal paged attention kernel
// (paged_attention.cu). The state's 16 words stay in registers.
#pragma once

#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c,
                                        uint32_t& d) {
  a += b; d ^= a; d = rotl(d, 16);
  c += d; b ^= c; b = rotl(b, 12);
  a += b; d ^= a; d = rotl(d, 8);
  c += d; b ^= c; b = rotl(b, 7);
}

// Keystream block `counter` under key[0..7] and nonce n0..n2 into ks[16].
__device__ __forceinline__ void chacha20_block(const uint32_t* key,
                                               uint32_t n0, uint32_t n1,
                                               uint32_t n2, uint32_t counter,
                                               uint32_t ks[16]) {
  uint32_t init[16];
  init[0] = 0x61707865u; init[1] = 0x3320646eu;
  init[2] = 0x79622d32u; init[3] = 0x6b206574u;
#pragma unroll
  for (int i = 0; i < 8; ++i) init[4 + i] = key[i];
  init[12] = counter;
  init[13] = n0; init[14] = n1; init[15] = n2;

  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
#pragma unroll
  for (int r = 0; r < 10; ++r) {  // 10 double rounds = 20 rounds
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) ks[i] = x[i] + init[i];
}

}  // namespace repro
