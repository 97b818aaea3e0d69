// qpsk_io — native runtime IO for qpsk_tpu_torch (the port's own copy of
// the JAX package's library; the C ABI and the file formats are the same,
// so spool and WAV files cross between the two packages).
//
// The reference modem's entire runtime is native C: a blocking stdio spool
// (qpsk.c:314-356 writes/reads /tmp/spectrum-filtered.raw) and bit-domain
// packet helpers (algorithms/).  This library is the port's native
// equivalent: int16 PCM spool/WAV IO with explicit framing, a
// single-producer/single-consumer ring buffer for real-time streaming into
// the device pipeline, and line-rate bit-domain packet ops (CRC16,
// DVB-LFSR keystream, golden-prime interleaver) matching the packet ops of
// ``qpsk_tpu_torch.packet`` bit for bit.
//
// C ABI (extern "C") for ctypes; no global state — every object is an
// opaque handle owned by the caller.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <atomic>
#include <new>

extern "C" {

// ---------------------------------------------------------------- spool IO

struct Spool {
    FILE *f;
};

Spool *spool_open(const char *path, const char *mode) {
    FILE *f = std::fopen(path, mode);
    if (!f) return nullptr;
    Spool *s = new (std::nothrow) Spool{f};
    if (!s) std::fclose(f);
    return s;
}

// Returns frames actually read (short count at EOF, matching the
// reference's short-read termination, qpsk.c:348-351).
int64_t spool_read(Spool *s, int16_t *buf, int64_t frame_len,
                   int64_t nframes) {
    if (!s) return -1;
    size_t got = std::fread(buf, sizeof(int16_t) * frame_len, nframes, s->f);
    return (int64_t)got;
}

int64_t spool_write(Spool *s, const int16_t *buf, int64_t frame_len,
                    int64_t nframes) {
    if (!s) return -1;
    size_t put = std::fwrite(buf, sizeof(int16_t) * frame_len, nframes, s->f);
    return (int64_t)put;
}

void spool_close(Spool *s) {
    if (s) {
        std::fclose(s->f);
        delete s;
    }
}

// ------------------------------------------------------------------- WAV

// Minimal mono 16-bit PCM WAV writer/reader (the practical container for
// an audio-band modem; the reference uses raw spools only).
#pragma pack(push, 1)
struct WavHeader {
    char riff[4];
    uint32_t size;
    char wave[4];
    char fmt[4];
    uint32_t fmt_size;
    uint16_t format;
    uint16_t channels;
    uint32_t sample_rate;
    uint32_t byte_rate;
    uint16_t block_align;
    uint16_t bits;
    char data[4];
    uint32_t data_size;
};
#pragma pack(pop)

int wav_write(const char *path, const int16_t *samples, int64_t n,
              int32_t sample_rate) {
    FILE *f = std::fopen(path, "wb");
    if (!f) return -1;
    WavHeader h;
    std::memcpy(h.riff, "RIFF", 4);
    std::memcpy(h.wave, "WAVE", 4);
    std::memcpy(h.fmt, "fmt ", 4);
    std::memcpy(h.data, "data", 4);
    h.fmt_size = 16;
    h.format = 1;
    h.channels = 1;
    h.sample_rate = (uint32_t)sample_rate;
    h.bits = 16;
    h.block_align = 2;
    h.byte_rate = (uint32_t)sample_rate * 2;
    h.data_size = (uint32_t)(n * 2);
    h.size = 36 + h.data_size;
    int ok = std::fwrite(&h, sizeof h, 1, f) == 1 &&
             std::fwrite(samples, 2, (size_t)n, f) == (size_t)n;
    std::fclose(f);
    return ok ? 0 : -1;
}

// Returns sample count, fills *sample_rate; buf==nullptr queries the size.
// Walks RIFF chunks properly (real-world WAVs carry LIST/fact chunks and
// 18-byte fmt blocks between 'fmt ' and 'data').
int64_t wav_read(const char *path, int16_t *buf, int64_t maxn,
                 int32_t *sample_rate) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return -1;
    char riff[4], wave[4];
    uint32_t riff_size;
    if (std::fread(riff, 4, 1, f) != 1 || std::fread(&riff_size, 4, 1, f) != 1 ||
        std::fread(wave, 4, 1, f) != 1 ||
        std::memcmp(riff, "RIFF", 4) != 0 || std::memcmp(wave, "WAVE", 4) != 0) {
        std::fclose(f);
        return -1;
    }
    bool fmt_ok = false;
    int64_t n = -1;
    for (;;) {
        char id[4];
        uint32_t size;
        if (std::fread(id, 4, 1, f) != 1 || std::fread(&size, 4, 1, f) != 1)
            break;
        if (std::memcmp(id, "fmt ", 4) == 0) {
            uint16_t format, channels, block_align, bits;
            uint32_t rate, byte_rate;
            if (size < 16 || std::fread(&format, 2, 1, f) != 1 ||
                std::fread(&channels, 2, 1, f) != 1 ||
                std::fread(&rate, 4, 1, f) != 1 ||
                std::fread(&byte_rate, 4, 1, f) != 1 ||
                std::fread(&block_align, 2, 1, f) != 1 ||
                std::fread(&bits, 2, 1, f) != 1)
                break;
            if (format != 1 || channels != 1 || bits != 16) break;
            if (sample_rate) *sample_rate = (int32_t)rate;
            fmt_ok = true;
            if (size > 16) std::fseek(f, size - 16, SEEK_CUR);
        } else if (std::memcmp(id, "data", 4) == 0) {
            if (!fmt_ok) break;
            n = size / 2;
            if (buf) {
                if (n > maxn) n = maxn;
                n = (int64_t)std::fread(buf, 2, (size_t)n, f);
            }
            break;
        } else {
            std::fseek(f, size + (size & 1), SEEK_CUR);  // chunks pad to even
        }
    }
    std::fclose(f);
    return n;
}

// -------------------------------------------------------- ring buffer

// SPSC int16 ring for real-time capture → demod pipelines: the producer
// (audio callback / SDR thread) pushes samples, the consumer pops fixed
// frames for the device. Lock-free via acquire/release atomics.
struct Ring {
    int16_t *data;
    int64_t capacity;             // power of two
    std::atomic<int64_t> head;    // written
    std::atomic<int64_t> tail;    // consumed
};

Ring *ring_create(int64_t capacity_pow2) {
    if (capacity_pow2 <= 0 || (capacity_pow2 & (capacity_pow2 - 1)) != 0)
        return nullptr;
    Ring *r = new (std::nothrow) Ring;
    if (!r) return nullptr;
    r->data = (int16_t *)std::malloc(sizeof(int16_t) * capacity_pow2);
    if (!r->data) {
        delete r;
        return nullptr;
    }
    r->capacity = capacity_pow2;
    r->head.store(0);
    r->tail.store(0);
    return r;
}

int64_t ring_push(Ring *r, const int16_t *src, int64_t n) {
    int64_t head = r->head.load(std::memory_order_relaxed);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    int64_t space = r->capacity - (head - tail);
    if (n > space) n = space;
    for (int64_t i = 0; i < n; i++)
        r->data[(head + i) & (r->capacity - 1)] = src[i];
    r->head.store(head + n, std::memory_order_release);
    return n;
}

int64_t ring_pop(Ring *r, int16_t *dst, int64_t n) {
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    int64_t head = r->head.load(std::memory_order_acquire);
    int64_t avail = head - tail;
    if (n > avail) n = avail;
    for (int64_t i = 0; i < n; i++)
        dst[i] = r->data[(tail + i) & (r->capacity - 1)];
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

int64_t ring_available(Ring *r) {
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

void ring_destroy(Ring *r) {
    if (r) {
        std::free(r->data);
        delete r;
    }
}

// ------------------------------------------------- bit-domain packet ops

// CRC-16/CCITT-FALSE, identical transition to crc16.c:11-23.
uint16_t crc16_native(const uint8_t *data, int64_t len) {
    uint16_t crc = 0xFFFF;
    while (len--) {
        uint8_t x = (uint8_t)((crc >> 8) ^ *data++);
        x ^= (uint8_t)(x >> 4);
        crc = (uint16_t)((crc << 8) ^ ((uint16_t)x << 12) ^
                         ((uint16_t)x << 5) ^ (uint16_t)x);
    }
    return crc;
}

// DVB additive LFSR keystream (bit-scramble.c:57-69 semantics).
void scramble_keystream(uint16_t seed, uint8_t *out_bits, int64_t nbits) {
    uint32_t mem = seed;
    for (int64_t i = 0; i < nbits; i++) {
        uint32_t s = ((mem >> 1) & 1u) ^ (mem & 1u);
        out_bits[i] = (uint8_t)s;
        mem = (mem >> 1) | (s << 14);
    }
}

// XOR a bit array with the keystream in place (scramble == descramble).
void scramble_bits_native(uint16_t seed, uint8_t *bits, int64_t nbits) {
    uint32_t mem = seed;
    for (int64_t i = 0; i < nbits; i++) {
        uint32_t s = ((mem >> 1) & 1u) ^ (mem & 1u);
        bits[i] ^= (uint8_t)s;
        mem = (mem >> 1) | (s << 14);
    }
}

// Golden-prime interleaver permutation (interleave.c:33-59 semantics):
// writes perm such that out[perm[k]] == in[k] is the INTERLEAVE mapping
// inverse — i.e. out[k] = in[perm[k]] reproduces interleave_bits().
static const uint16_t kPrimes[] = {
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29,
    31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
    127, 131, 137, 139, 149, 151, 157, 163, 167, 173,
    179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
    233, 239, 241, 251, 257, 263, 269, 271, 277, 281,
    283, 293, 307, 311, 313, 317, 331, 337, 347};

// Largest table prime < nbits (interleave.c:33-41 selection rule) — the
// ONE place the rule lives, so the bijectivity guard below always checks
// the same prime the permutation uses.
static int64_t pick_prime(int64_t nbits) {
    int64_t imax = (int64_t)(sizeof(kPrimes) / sizeof(kPrimes[0]));
    int64_t index = 1;
    while (index < imax && kPrimes[index] < nbits) index++;
    return kPrimes[index - 1];
}

void interleave_permutation_native(int64_t nbits, int32_t *perm) {
    int64_t b = pick_prime(nbits);
    for (int64_t i = 0; i < nbits; i++) perm[(b * i) % nbits] = (int32_t)i;
}

// Returns 0 on success, -1 on allocation failure, -2 when the saturated
// prime divides nbits (gcd(b, nbits) != 1): the map i -> (b*i) mod nbits is
// then non-invertible and would silently corrupt data — the exact reference
// defect (interleave.c:52-59) the Python twin (_check_bijective) refuses.
int interleave_bits_native(uint8_t *bits, int64_t nbits, int deinter) {
    int64_t b = pick_prime(nbits);
    int64_t x = b, y = nbits;  // gcd(b, nbits)
    while (y) { int64_t t = x % y; x = y; y = t; }
    if (x != 1) return -2;
    int32_t *perm = (int32_t *)std::malloc(sizeof(int32_t) * nbits);
    uint8_t *tmp = (uint8_t *)std::malloc(nbits);
    if (!perm || !tmp) {
        std::free(perm);
        std::free(tmp);
        return -1;
    }
    interleave_permutation_native(nbits, perm);
    if (deinter) {
        for (int64_t k = 0; k < nbits; k++) tmp[perm[k]] = bits[k];
    } else {
        for (int64_t k = 0; k < nbits; k++) tmp[k] = bits[perm[k]];
    }
    std::memcpy(bits, tmp, nbits);
    std::free(perm);
    std::free(tmp);
    return 0;
}

}  // extern "C"
