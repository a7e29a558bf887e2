// Burn-key proof-of-work grinder: find burnKey such that
// keccak256(BE32(burnKey) || BE32(revealAmount) || BE32(burnExtraCommitment)
//           || "EIP-7503") has >= min_zero_bytes leading zero bytes.
// This is the hot host-side loop of input generation (the reference grinds it
// in Python at tests/main.py:47-56); here it is native C++ exposed via a C ABI
// for ctypes. Clean-room Keccak-f[1600] from the specification.
//
// Build: g++ -O3 -shared -fPIC -o libpowgrind.so pow_grinder.cpp

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

constexpr int ROT[5][5] = {{0, 36, 3, 41, 18},
                           {1, 44, 10, 45, 2},
                           {62, 6, 43, 15, 61},
                           {28, 55, 25, 21, 56},
                           {27, 20, 39, 8, 14}};

inline uint64_t rotl(uint64_t v, int r) {
  return r == 0 ? v : (v << r) | (v >> (64 - r));
}

void keccak_f(uint64_t a[25]) {
  uint64_t b[25], c[5], d[5];
  for (int round = 0; round < 24; ++round) {
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], ROT[x][y]);
    for (int i = 0; i < 25; ++i) {
      int x = i % 5, y5 = (i / 5) * 5;
      a[i] = b[i] ^ (~b[(x + 1) % 5 + y5] & b[(x + 2) % 5 + y5]);
    }
    a[0] ^= RC[round];
  }
}

// single-block keccak256 of exactly 104 message bytes (the PoW preimage size)
void keccak256_104(const uint8_t msg[104], uint8_t out[32]) {
  uint8_t block[136];
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, msg, 104);
  block[104] = 0x01;
  block[135] = 0x80;
  uint64_t lanes[25];
  std::memset(lanes, 0, sizeof(lanes));
  for (int i = 0; i < 17; ++i) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; --j) v = (v << 8) | block[8 * i + j];
    lanes[i] = v;
  }
  keccak_f(lanes);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j) out[8 * i + j] = (lanes[i] >> (8 * j)) & 0xFF;
}

}  // namespace

extern "C" {

// Increments the 32-byte big-endian burnKey starting from `key` until the PoW
// digest has >= min_zero_bytes leading zero bytes, or max_iters tried.
// msg layout: key[32] | reveal[32] | extra[32] | "EIP-7503".
// Returns the number of iterations used, or -1 if not found; the winning key
// is written back into `key`.
long long grind_burn_key(uint8_t key[32], const uint8_t reveal[32],
                         const uint8_t extra[32], int min_zero_bytes,
                         long long max_iters) {
  uint8_t msg[104];
  std::memcpy(msg, key, 32);
  std::memcpy(msg + 32, reveal, 32);
  std::memcpy(msg + 64, extra, 32);
  std::memcpy(msg + 96, "EIP-7503", 8);
  uint8_t digest[32];
  for (long long it = 0; it < max_iters; ++it) {
    keccak256_104(msg, digest);
    bool ok = true;
    for (int i = 0; i < min_zero_bytes; ++i) ok &= (digest[i] == 0);
    if (ok) {
      std::memcpy(key, msg, 32);
      return it;
    }
    // increment the big-endian key
    for (int i = 31; i >= 0; --i)
      if (++msg[i] != 0) break;
  }
  return -1;
}

// Plain keccak256 of the 104-byte PoW preimage (for tests).
void pow_digest(const uint8_t msg[104], uint8_t out[32]) {
  keccak256_104(msg, out);
}
}
