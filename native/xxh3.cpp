// XXH3-64 (seed 0, default secret): the content hash the scheduler uses
// for .hmm / .dcp files (reference src/core/xfile.c:60-100).  One-shot
// over a buffer, plus a file variant that maps the file read-only.
// Algorithm and constants: the XXH3 specification (xxhash 0.8).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

using u8 = uint8_t;
using u32 = uint32_t;
using u64 = uint64_t;

constexpr u64 P32_1 = 0x9E3779B1U, P32_2 = 0x85EBCA77U, P32_3 = 0xC2B2AE3DU;
constexpr u64 P64_1 = 0x9E3779B185EBCA87ULL, P64_2 = 0xC2B2AE3D27D4EB4FULL,
              P64_3 = 0x165667B19E3779F9ULL, P64_4 = 0x85EBCA77C2B2AE63ULL,
              P64_5 = 0x27D4EB2F165667C5ULL;
constexpr u64 PMX_1 = 0x165667919E3779F9ULL, PMX_2 = 0x9FB21C651E98DF25ULL;

constexpr u8 kSecret[192] = {
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c,
    0xf7, 0x21, 0xad, 0x1c, 0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb,
    0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f, 0xcb, 0x79, 0xe6, 0x4e,
    0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6,
    0x81, 0x3a, 0x26, 0x4c, 0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb,
    0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3, 0x71, 0x64, 0x48, 0x97,
    0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7,
    0xc7, 0x0b, 0x4f, 0x1d, 0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31,
    0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64, 0xea, 0xc5, 0xac, 0x83,
    0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26,
    0x29, 0xd4, 0x68, 0x9e, 0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc,
    0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce, 0x45, 0xcb, 0x3a, 0x8f,
    0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
};

inline u64 r64(const u8* p) { u64 v; std::memcpy(&v, p, 8); return v; }
inline u32 r32(const u8* p) { u32 v; std::memcpy(&v, p, 4); return v; }
inline u64 rotl(u64 x, int r) { return (x << r) | (x >> (64 - r)); }

inline u64 fold64(u64 a, u64 b) {
    __uint128_t p = (__uint128_t)a * b;
    return (u64)p ^ (u64)(p >> 64);
}

inline u64 avalanche(u64 h) {
    h ^= h >> 37;
    h *= PMX_1;
    return h ^ (h >> 32);
}

inline u64 avalanche64(u64 h) {
    h ^= h >> 33; h *= P64_2;
    h ^= h >> 29; h *= P64_3;
    return h ^ (h >> 32);
}

inline u64 rrmxmx(u64 h, u64 len) {
    h ^= rotl(h, 49) ^ rotl(h, 24);
    h *= PMX_2;
    h ^= (h >> 35) + len;
    h *= PMX_2;
    return h ^ (h >> 28);
}

inline u64 mix16(const u8* in, const u8* s) {
    return fold64(r64(in) ^ r64(s), r64(in + 8) ^ r64(s + 8));
}

void accumulate512(u64* acc, const u8* in, const u8* s) {
    for (int i = 0; i < 8; i++) {
        u64 v = r64(in + 8 * i);
        u64 k = v ^ r64(s + 8 * i);
        acc[i ^ 1] += v;
        acc[i] += (k & 0xFFFFFFFFULL) * (k >> 32);
    }
}

void scramble(u64* acc, const u8* s) {
    for (int i = 0; i < 8; i++) {
        u64 a = acc[i];
        a ^= a >> 47;
        a ^= r64(s + 8 * i);
        acc[i] = a * P32_1;
    }
}

u64 hash_long(const u8* in, size_t len) {
    const size_t stripes_per_block = (sizeof(kSecret) - 64) / 8;
    const size_t block_len = 64 * stripes_per_block;
    const size_t nblocks = (len - 1) / block_len;
    u64 acc[8] = {P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1};
    for (size_t n = 0; n < nblocks; n++) {
        const u8* blk = in + n * block_len;
        for (size_t s = 0; s < stripes_per_block; s++)
            accumulate512(acc, blk + 64 * s, kSecret + 8 * s);
        scramble(acc, kSecret + sizeof(kSecret) - 64);
    }
    const size_t nstripes = ((len - 1) - block_len * nblocks) / 64;
    const u8* tail = in + nblocks * block_len;
    for (size_t s = 0; s < nstripes; s++)
        accumulate512(acc, tail + 64 * s, kSecret + 8 * s);
    accumulate512(acc, in + len - 64, kSecret + sizeof(kSecret) - 64 - 7);
    u64 h = (u64)len * P64_1;
    for (int i = 0; i < 4; i++)
        h += fold64(acc[2 * i] ^ r64(kSecret + 11 + 16 * i),
                    acc[2 * i + 1] ^ r64(kSecret + 11 + 16 * i + 8));
    return avalanche(h);
}

u64 xxh3_64(const u8* in, size_t len) {
    const u8* s = kSecret;
    if (len == 0) return avalanche64(r64(s + 56) ^ r64(s + 64));
    if (len <= 3) {
        u32 c = ((u32)in[0] << 16) | ((u32)in[len >> 1] << 24) |
                (u32)in[len - 1] | ((u32)len << 8);
        return avalanche64((u64)c ^ (u64)(r32(s) ^ r32(s + 4)));
    }
    if (len <= 8) {
        u64 v = (u64)r32(in + len - 4) + ((u64)r32(in) << 32);
        return rrmxmx(v ^ (r64(s + 8) ^ r64(s + 16)), len);
    }
    if (len <= 16) {
        u64 lo = r64(in) ^ (r64(s + 24) ^ r64(s + 32));
        u64 hi = r64(in + len - 8) ^ (r64(s + 40) ^ r64(s + 48));
        u64 acc = len + __builtin_bswap64(lo) + hi + fold64(lo, hi);
        return avalanche(acc);
    }
    if (len <= 128) {
        u64 acc = len * P64_1;
        if (len > 32) {
            if (len > 64) {
                if (len > 96) {
                    acc += mix16(in + 48, s + 96);
                    acc += mix16(in + len - 64, s + 112);
                }
                acc += mix16(in + 32, s + 64);
                acc += mix16(in + len - 48, s + 80);
            }
            acc += mix16(in + 16, s + 32);
            acc += mix16(in + len - 32, s + 48);
        }
        acc += mix16(in, s);
        acc += mix16(in + len - 16, s + 16);
        return avalanche(acc);
    }
    if (len <= 240) {
        u64 acc = len * P64_1;
        for (size_t i = 0; i < 8; i++) acc += mix16(in + 16 * i, s + 16 * i);
        acc = avalanche(acc);
        u64 end = mix16(in + len - 16, s + 136 - 17);
        for (size_t i = 8; i < len / 16; i++)
            end += mix16(in + 16 * i, s + 16 * (i - 8) + 3);
        return avalanche(acc + end);
    }
    return hash_long(in, len);
}

}  // namespace

extern "C" {

uint64_t dcp_xxh3_64(const void* data, size_t len) {
    return xxh3_64(static_cast<const u8*>(data), len);
}

// Hash a whole file; returns 0 and sets *ok = 0 on an I/O error.
uint64_t dcp_xxh3_64_file(const char* path, int* ok) {
    *ok = 0;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return 0;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return 0; }
    size_t len = (size_t)st.st_size;
    u64 h;
    if (len == 0) {
        h = xxh3_64(nullptr, 0);
    } else {
        void* p = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) { close(fd); return 0; }
        h = xxh3_64(static_cast<const u8*>(p), len);
        munmap(p, len);
    }
    close(fd);
    *ok = 1;
    return h;
}

}  // extern "C"
