// The Salsa20/20 block function, shared by the keystream kernel S1
// (salsa20.cu) and the two device Gaussian kernels S3 (gaussian_fixed.cu)
// and S4 (gaussian_exact.cu), which make the keystream where they consume
// it.
//
// block() writes the 16 final-state words of block `ctr` of the stream at
// `nonce`: the bytes 64 * ctr .. 64 * ctr + 63 of Salsa20Stream(key,
// nonce).randombytes (reference crypto_stream_salsa20: key words 1-4 and
// 11-14, nonce words 6-7, the 64-bit counter in 8-9).  One thread a block,
// the state in registers, rotations as __funnelshift_l: 10 double rounds
// of 8 quarter-rounds (add, rotate, xor four times) and 16 final adds.
#pragma once

#include <cstdint>

namespace nfl_salsa {

struct Key {
  uint32_t w[8];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int c) {
  return __funnelshift_l(x, x, c);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b,
                                        uint32_t& c, uint32_t& d) {
  b ^= rotl(a + d, 7);
  c ^= rotl(b + a, 9);
  d ^= rotl(c + b, 13);
  a ^= rotl(d + c, 18);
}

__device__ __forceinline__ void block(const Key& key, uint64_t nonce,
                                      uint64_t ctr, uint32_t out[16]) {
  const uint32_t j[16] = {
      0x61707865u, key.w[0], key.w[1], key.w[2],
      key.w[3], 0x3320646Eu, static_cast<uint32_t>(nonce),
      static_cast<uint32_t>(nonce >> 32), static_cast<uint32_t>(ctr),
      static_cast<uint32_t>(ctr >> 32), 0x79622D32u, key.w[4],
      key.w[5], key.w[6], key.w[7], 0x6B206574u};
  uint32_t x[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = j[k];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[5], x[9], x[13], x[1]);
    quarter(x[10], x[14], x[2], x[6]);
    quarter(x[15], x[3], x[7], x[11]);
    quarter(x[0], x[1], x[2], x[3]);
    quarter(x[5], x[6], x[7], x[4]);
    quarter(x[10], x[11], x[8], x[9]);
    quarter(x[15], x[12], x[13], x[14]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k] = x[k] + j[k];
}

// The nonce a launch's stream f starts from: base = *nonce_dev (a device
// int64 the host never reads; 0 when null) + nonce_add + off, mod 2^64.
__device__ __forceinline__ uint64_t nonce_of(const long long* nonce_dev,
                                             unsigned long long nonce_add,
                                             long long off) {
  uint64_t nonce = nonce_add + static_cast<uint64_t>(off);
  if (nonce_dev != nullptr)
    nonce += static_cast<uint64_t>(__ldg(nonce_dev));
  return nonce;
}

}  // namespace nfl_salsa
