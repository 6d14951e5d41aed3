// nfl_native — host-side native runtime for nfllib_tpu_torch.
//
// The port's own copy of the JAX package's csrc/nfl_native.cpp, with the
// same results and its C ABI plus a keystream offset (a channel block's
// uniform draw starts first * n limbs into the stream);
// nfllib_tpu_torch/native.py builds it with g++ at first use into
// nfllib_tpu_torch/_build/ and loads it with ctypes.  It is the C++ slot
// for the reference's native layer: the
// Salsa20 stream PRNG (reference lib/prng/nfl_crypto_stream_salsa20_amd64_xmm6.s
// — 4,823 lines of qhasm-generated x86-64 assembly driven by
// lib/prng/fastrandombytes.cpp:21-34) and the hot host-side sampling loops.
// This is a clean-room portable implementation of the same crypto_stream
// function (Salsa20/20, 32-byte key, 8-byte nonce, 64-bit little-endian
// block counter starting at 0); output is byte-identical to the reference
// stream, anchored by tools/golden/salsa20_golden.bin in tests.
//
// Built as a plain shared library (no Python headers).  Exposed C ABI:
//   nfl_salsa20_stream(out, nbytes, nonce8, key32, offset)
//   nfl_fastrandombytes(state, out, nbytes)   — stateful nonce-bumping
//   nfl_uniform_u32 / nfl_uniform_u16 / nfl_uniform_u64 — mask+subtract
//     uniform residue sampling (reference core.hpp:151-186 semantics),
//     from a limb offset of the call's stream
//   nfl_poly2mpz / nfl_mpz2poly — CRT lifting without GMP
//   nfl_gaussian_noise — the stream-exact discrete Gaussian walk

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t rotl(uint32_t x, int c) { return (x << c) | (x >> (32 - c)); }

inline uint32_t load32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline void store32(uint8_t *p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

constexpr uint32_t kSigma[4] = {0x61707865u, 0x3320646Eu, 0x79622D32u,
                                0x6B206574u};  // "expand 32-byte k"

void salsa20_block(uint8_t out[64], const uint32_t key[8],
                   const uint32_t nonce[2], uint64_t counter) {
  uint32_t j[16] = {
      kSigma[0], key[0],  key[1],  key[2],
      key[3],    kSigma[1], nonce[0], nonce[1],
      (uint32_t)counter, (uint32_t)(counter >> 32), kSigma[2], key[4],
      key[5],    key[6],  key[7],  kSigma[3]};
  uint32_t x[16];
  std::memcpy(x, j, sizeof(x));

#define QR(a, b, c, d)          \
  x[b] ^= rotl(x[a] + x[d], 7); \
  x[c] ^= rotl(x[b] + x[a], 9); \
  x[d] ^= rotl(x[c] + x[b], 13); \
  x[a] ^= rotl(x[d] + x[c], 18)

  for (int round = 0; round < 10; ++round) {
    QR(0, 4, 8, 12);
    QR(5, 9, 13, 1);
    QR(10, 14, 2, 6);
    QR(15, 3, 7, 11);
    QR(0, 1, 2, 3);
    QR(5, 6, 7, 4);
    QR(10, 11, 8, 9);
    QR(15, 12, 13, 14);
  }
#undef QR
  for (int i = 0; i < 16; ++i) store32(out + 4 * i, x[i] + j[i]);
}

}  // namespace

extern "C" {

// crypto_stream_salsa20 equivalent: the bytes offset .. offset + nbytes - 1
// of the keystream under (key, nonce), made from the block they start in.
void nfl_salsa20_stream(uint8_t *out, uint64_t nbytes, const uint8_t nonce8[8],
                        const uint8_t key32[32], uint64_t offset) {
  uint32_t key[8], nonce[2];
  for (int i = 0; i < 8; ++i) key[i] = load32(key32 + 4 * i);
  nonce[0] = load32(nonce8);
  nonce[1] = load32(nonce8 + 4);
  uint64_t counter = offset / 64;
  uint8_t block[64];
  const uint64_t skip = offset % 64;
  if (skip && nbytes) {
    const uint64_t take = nbytes < 64 - skip ? nbytes : 64 - skip;
    salsa20_block(block, key, nonce, counter++);
    std::memcpy(out, block + skip, take);
    out += take;
    nbytes -= take;
  }
  while (nbytes >= 64) {
    salsa20_block(out, key, nonce, counter++);
    out += 64;
    nbytes -= 64;
  }
  if (nbytes) {
    salsa20_block(block, key, nonce, counter);
    std::memcpy(out, block, nbytes);
  }
}

namespace {

// fastrandombytes from byte `offset` of the call's stream: the nonce is
// bumped once, as for the call from byte 0
void fastrandombytes_at(uint8_t state40[40], uint8_t *out, uint64_t nbytes,
                        uint64_t offset) {
  nfl_salsa20_stream(out, nbytes, state40 + 32, state40, offset);
  uint64_t nonce;
  std::memcpy(&nonce, state40 + 32, 8);
  ++nonce;  // host is little-endian on all supported platforms
  std::memcpy(state40 + 32, &nonce, 8);
}

}  // namespace

// fastrandombytes equivalent (reference lib/prng/fastrandombytes.cpp:21-34):
// state = 32-byte key followed by a little-endian 64-bit nonce that is
// incremented once per call.
void nfl_fastrandombytes(uint8_t state40[40], uint8_t *out, uint64_t nbytes) {
  fastrandombytes_at(state40, out, nbytes, 0);
}

// Uniform residue sampling, one call per poly (reference core.hpp:151-186):
// fill from the stream, mask each channel to the modulus bit width, subtract
// p once if >= p (the documented non-rejection bias tradeoff).  The limbs
// come from limb `offset` of the call's stream on: on a channel block of a
// ring (offset = first * degree) they are the whole ring's draw's rows.
#define DEFINE_UNIFORM(NAME, T)                                             \
  void NAME(uint8_t state40[40], T *data, const T *moduli, uint64_t nmoduli, \
            uint64_t degree, T mask, uint64_t offset) {                     \
    fastrandombytes_at(state40, (uint8_t *)data,                            \
                       nmoduli * degree * sizeof(T), offset * sizeof(T));   \
    for (uint64_t cm = 0; cm < nmoduli; ++cm) {                             \
      const T p = moduli[cm];                                               \
      T *row = data + cm * degree;                                          \
      for (uint64_t i = 0; i < degree; ++i) {                               \
        T t = row[i] & mask;                                                \
        row[i] = (t >= p) ? (T)(t - p) : t;                                 \
      }                                                                     \
    }                                                                       \
  }

DEFINE_UNIFORM(nfl_uniform_u16, uint16_t)
DEFINE_UNIFORM(nfl_uniform_u32, uint32_t)
DEFINE_UNIFORM(nfl_uniform_u64, uint64_t)
#undef DEFINE_UNIFORM

}  // extern "C"

// ---------------------------------------------------------------------------
// CRT lifting (reference include/nfl/gmp.hpp:113-219, reimplemented without
// GMP on fixed-width multiword arithmetic; __uint128_t provides the
// 64x64->128 multiply).
//
// poly2mpz uses the classic Garner-free CRT form
//     x = sum_cm (v_cm * inv_cm mod p_cm) * (prod / p_cm)   (mod prod)
// where inv_cm = (prod/p_cm)^-1 mod p_cm.  Each term multiplies a multiword
// constant Q_cm = prod/p_cm by a word-sized scalar; the accumulated quotient
// vs prod is < nmoduli, removed by conditional subtraction.  Results are
// canonical (identical to the reference's Shoup-reduced lift).
// ---------------------------------------------------------------------------

namespace {

// acc[0..W] += q[0..W-1] * scalar   (acc has one extra overflow word)
inline void addmul_word(uint64_t *acc, const uint64_t *q, uint64_t scalar,
                        uint64_t W) {
  unsigned __int128 carry = 0;
  for (uint64_t j = 0; j < W; ++j) {
    unsigned __int128 cur =
        (unsigned __int128)q[j] * scalar + acc[j] + (uint64_t)carry;
    acc[j] = (uint64_t)cur;
    carry = cur >> 64;
  }
  acc[W] += (uint64_t)carry;
}

// return acc >= mod (both W+1 words, mod's top word implicitly 0-extended)
inline bool geq(const uint64_t *acc, const uint64_t *mod, uint64_t W) {
  if (acc[W]) return true;
  for (uint64_t j = W; j-- > 0;) {
    if (acc[j] != mod[j]) return acc[j] > mod[j];
  }
  return true;  // equal
}

inline void sub_inplace(uint64_t *acc, const uint64_t *mod, uint64_t W) {
  unsigned __int128 borrow = 0;
  for (uint64_t j = 0; j < W; ++j) {
    unsigned __int128 cur = (unsigned __int128)acc[j] - mod[j]
                            - (uint64_t)borrow;
    acc[j] = (uint64_t)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  acc[W] -= (uint64_t)borrow;
}

inline uint64_t mulmod_u64(uint64_t a, uint64_t b, uint64_t p) {
  return (uint64_t)(((unsigned __int128)a * b) % p);
}

}  // namespace

extern "C" {

// residues: [m, n] row-major uint64 (narrower limbs widened by the caller)
// qtab:     [m, W]  Q_cm = prod/p_cm, little-endian 64-bit words
// invtab:   [m]     (prod/p_cm)^-1 mod p_cm
// prod:     [W]     moduli product
// out:      [n, W]  canonical coefficients, little-endian words
void nfl_poly2mpz(const uint64_t *residues, const uint64_t *qtab,
                  const uint64_t *invtab, const uint64_t *prod,
                  const uint64_t *moduli, uint64_t m, uint64_t n, uint64_t W,
                  uint64_t *out, uint64_t *scratch /* W+1 words */) {
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t *acc = scratch;
    for (uint64_t j = 0; j <= W; ++j) acc[j] = 0;
    for (uint64_t cm = 0; cm < m; ++cm) {
      uint64_t v = residues[cm * n + i];
      uint64_t t = mulmod_u64(v, invtab[cm], moduli[cm]);
      if (t) addmul_word(acc, qtab + cm * W, t, W);
    }
    while (geq(acc, prod, W)) sub_inplace(acc, prod, W);
    for (uint64_t j = 0; j < W; ++j) out[i * W + j] = acc[j];
  }
}

// Reduce big coefficients (little-endian words) modulo each prime:
// out[cm, i] = coeff_i mod p_cm, via Horner over the words.
void nfl_mpz2poly(const uint64_t *coeffs, uint64_t m, uint64_t n, uint64_t W,
                  const uint64_t *moduli, uint64_t *out) {
  for (uint64_t cm = 0; cm < m; ++cm) {
    const uint64_t p = moduli[cm];
    // 2^64 mod p
    uint64_t base = (uint64_t)((((unsigned __int128)1) << 64) % p);
    for (uint64_t i = 0; i < n; ++i) {
      const uint64_t *w = coeffs + i * W;
      uint64_t r = 0;
      for (uint64_t j = W; j-- > 0;) {
        r = mulmod_u64(r, base, p);
        unsigned __int128 cur = (unsigned __int128)r + (w[j] % p);
        r = (uint64_t)(cur % p);
      }
      out[cm * n + i] = r;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Discrete Gaussian host sampler — native tier of prng/gaussian.py.
//
// Exact port of the stream-consumption walk (itself reproducing the
// reference's FastGaussianNoise::getNoise, FastGaussianNoise.hpp:478-595):
// two-level uint8 lookup, full-precision barrier compare on flagged entries,
// buffer regeneration when nearly exhausted.  Byte-exact vs the python walk
// for the same stream state (differentially tested).
//
// Second-level tables arrive flattened: flagged first-words w0 map via
// lu1_map[w0] -> f into val2/flag2[f][lu_size]; barrier index lists are the
// contiguous ranges [bars_first, bars_first + bars_count).
// ---------------------------------------------------------------------------

extern "C" {

void nfl_gaussian_noise(
    uint8_t state40[40],
    int64_t *out, uint64_t rlen,
    // geometry
    uint64_t word_precision, uint64_t in_bytes /*1 or 2*/,
    uint64_t innoise_words,
    // level 1
    const int64_t *lu_val, const uint8_t *lu_flag, const int32_t *lu1_map,
    const int32_t *bars1_first, const int32_t *bars1_count,
    // level 2 (lu_depth==2; nf tables of lu_size entries)
    const int64_t *val2, const uint8_t *flag2,
    const int32_t *bars2_first, const int32_t *bars2_count,
    // barriers
    const uint16_t *barrier_words, uint64_t lu_depth, uint64_t lu_size) {
  const uint64_t wp = word_precision;
  uint64_t buf_bytes = innoise_words * in_bytes;
  uint8_t *noise = new uint8_t[buf_bytes];

  auto word_at = [&](uint64_t idx) -> uint64_t {
    if (in_bytes == 1) return noise[idx];
    uint16_t v;
    std::memcpy(&v, noise + 2 * idx, 2);  // little-endian host
    return v;
  };

  nfl_fastrandombytes(state40, noise, buf_bytes);
  uint64_t pos = 0, computed = 0;

  auto cmp_barrier = [&](int32_t b_idx, uint64_t at) -> int {
    const uint16_t *bw = barrier_words + (uint64_t)b_idx * wp;
    for (uint64_t j = 0; j < wp; ++j) {
      uint64_t nj = word_at(at + j);
      if (bw[j] > nj) return 1;
      if (bw[j] < nj) return -1;
    }
    return 0;
  };

  while (computed < rlen) {
    uint64_t w0 = word_at(pos);
    int64_t output;
    if (lu_flag[w0]) {
      if (lu_depth == 1) {
        output = lu_val[w0];
        int32_t first = bars1_first[w0], cnt = bars1_count[w0];
        for (int32_t k = 0; k < cnt; ++k) {
          if (cmp_barrier(first + k, pos) == 1) break;
          ++output;
        }
        pos += wp - 1;
      } else {
        uint64_t w1 = word_at(pos + 1);
        int32_t f = lu1_map[w0];
        const int64_t *v2 = val2 + (uint64_t)f * lu_size;
        const uint8_t *f2 = flag2 + (uint64_t)f * lu_size;
        if (f2[w1]) {
          output = v2[w1];
          int32_t first = bars2_first[(uint64_t)f * lu_size + w1];
          int32_t cnt = bars2_count[(uint64_t)f * lu_size + w1];
          for (int32_t k = 0; k < cnt; ++k) {
            if (cmp_barrier(first + k, pos) == 1) break;
            ++output;
          }
          pos += wp - 2;
        } else {
          output = v2[w1];
        }
        pos += 1;
      }
    } else {
      output = lu_val[w0];
    }
    pos += 1;
    out[computed++] = output;
    // pos counts consumed words since the last refill; keep the next
    // full-precision read (word_at(pos + wp - 1)) inside the buffer
    if (pos + wp >= innoise_words) {
      nfl_fastrandombytes(state40, noise, buf_bytes);
      pos = 0;
    }
  }
  delete[] noise;
}

}  // extern "C"
