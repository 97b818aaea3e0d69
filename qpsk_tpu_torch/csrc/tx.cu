// TX modulator kernel for Hopper (sm_90a).
//
// Replaces: qpsk_tpu/ops/pallas/tx_kernel.py, _kernel launched by _tx_2d
// (entry tx_modulate_fused), at CYC = 2..8 samples per symbol and any odd
// tap count up to 129; the rest of the TPU kernel's gate (more samples per
// symbol, taps up to a 128-symbol halo) runs tx_general_kernel, at the end
// of this file.
//
// What it computes, per channel: symbols -> zero-stuff x CYC -> ntaps-tap
// RRC -> x gain -> mix up by phase0 * e^{j*omega*(t+1)} -> Re * pcm_scale
// -> int16, truncating toward zero like C's float-to-int conversion and
// saturating at the int16 range like the JAX package's astype.  The
// zero-stuffed signal is never built: output sample t = CYC*m + q meets the
// symbols m - d at taps ntaps-1 - CYC*d - q, d = 0..HS, HS = (ntaps-1) /
// CYC, so each output is a polyphase sum over HS + 1 symbols; the HS
// symbols before the call are the lanes (ntaps-1) % CYC + CYC*i of the
// carried zero-stuffed tail, read in place.  Beside the PCM it writes the
// carried state: the new phase normalize(phase0 * e^{j*omega*n}) and the
// new zero-stuffed tail, the last ntaps-1 samples of [old tail | stuffed
// symbols] (ops/frontend.py advance_phase and modmap's zero-stuff), so a
// call is one launch, with no torch operation around it and no copy to the
// card (the taps ride as a by-value parameter).
//
// What bounds it on the H100: bytes, once the arithmetic leaves the CUDA
// cores.  Per sample it reads 8/CYC bytes of symbols and writes 2 bytes of
// PCM (0.040 ms at 8192 channels x 1024 symbols, CYC 4), against
// 2 * 127/CYC multiply-adds (0.064 ms of float32 FMAs at the card's peak)
// and a carrier phasor.  The kernel this one replaced spent a float64
// multiply, divide-and-floor and sincos on every sample and ran the FIR on
// the CUDA cores (with the float64 carrier gone, a CUDA-core FIR still
// measured slower than this one on the H100: PERF.md).  Here:
//
//   - the FIR runs on the tensor cores, symbol-major.  A tile is the
//     product D[r, n] = sum_d A[r, d] B[d, n] of one plane (re or im) of
//     one channel, with mma.sync m16n8k16 in float16 with float32 sums:
//     row r holds the R = 8 / CYC symbols m0 + R*r + j, j < R, so that
//     the 8 columns n = q + CYC*j carry their CYC samples each,
//     A[r, d] = sym[m0 + R*r + R-1 - d], and B[d, n] = h[ntaps-1 -
//     CYC*(d + j - (R-1)) - q] is the same for every tile: its
//     (HS+R-1)/16 + 1 k-tiles (3 at 127 taps and CYC 4: a row's two
//     symbols need 33) are loaded once into registers.  A is a Toeplitz
//     matrix; the warp's window of symbols sits in shared memory in
//     reverse order, so the pairs of an A fragment are consecutive halves
//     (for R = 1 a second copy shifted by one keeps the odd rows' pairs
//     aligned).  A tile yields 16R symbols x CYC samples, two rows'
//     adjacent samples a lane, so the int16 stores of a warp are 128
//     contiguous bytes;
//   - precision: three passes, x_lo*h_hi + x_hi*h_lo + x_hi*h_hi with both
//     operands split into float16 hi + lo (round to nearest) and the taps
//     scaled by the power of two that puts the largest near 2^14 (the gain
//     carries the inverse, exactly), as the RX front-end does: the symbols
//     of QPSK, 8PSK and 16QAM are not exact in float16, and the two
//     kept parts hold every product within 2^-22 of its value;
//   - the carrier: phase0 (x) base (x) ramp.  The base of each tile,
//     e^{j*omega*(CYC*m0 + 1)}, is taken in float64 reduced mod 2*pi (one
//     sincos a lane covers a warp's tiles, shuffled out), so long calls
//     keep their phase; the ramp e^{j*omega*o} of the four sample offsets
//     o a lane owns within a tile is computed in float64 once and held in
//     registers as float32, as the TPU kernel's tables are designed;
//   - one warp a (channel, 512 symbols) work item, on grid.x, so any
//     symbol count runs; the warps of a block share nothing; a lane issues
//     its window loads 8 at a time before it splits any of them.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int KT = 129;                  // the largest tap count
constexpr int NWARP = 4;
constexpr int L = 512;                   // symbols a work item
constexpr unsigned FULL = 0xffffffffu;
constexpr double TWO_PI = 6.283185307179586476925286766559;

struct Taps {
  float h[KT];
};

template <int CYC>
struct Shape {
  static constexpr int R = 8 / CYC;              // symbols a row
  static constexpr int TILE = 16 * R;            // symbols a tile
  static constexpr int NKMAX = ((KT - 1) / CYC + R - 1) / 16 + 1;  // k-tiles
  static constexpr int W = L + 16 * NKMAX + 2;   // window, halves
  static constexpr int WS = W + (24 - W % 16) % 16;   // stride: 8 mod 16
  static constexpr int COPIES = R == 1 ? 2 : 1;
};
static_assert(L % (16 * 8) == 0 && L / 16 <= 32,
              "a work item is whole tiles, their bases one a lane");

// v = hi + lo in float16, both rounded to nearest
__device__ __forceinline__ void split(float v, __half& hi, __half& lo) {
  hi = __float2half_rn(v);
  lo = __float2half_rn(__fsub_rn(v, __half2float(hi)));
}

__device__ __forceinline__ uint32_t pack(__half a, __half b) {
  return (uint32_t)__half_as_ushort(a) | ((uint32_t)__half_as_ushort(b) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __half* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e^{j*ang} of a float64 angle reduced to [0, 2*pi), as float32 parts
__device__ __forceinline__ void phasor(double ang, float& re, float& im) {
  ang -= TWO_PI * floor(ang * (1.0 / TWO_PI));
  double s, c;
  sincos(ang, &s, &c);
  re = (float)c;
  im = (float)s;
}

// the symbol m of channel c's stream: the call's, the carried tail's
// (lane ntaps-1 + CYC*m for -hs <= m < 0), else zero
__device__ __forceinline__ float symbol(const float* sym, const float* tail,
                                        long long c, int S, int ntaps, int cyc,
                                        int hs, long long m) {
  if (m >= S || m < -hs) return 0.f;
  if (m >= 0) return sym[c * S + m];
  return tail[c * (ntaps - 1) + (ntaps - 1) + cyc * m];
}

// e^{j*ang} of a float64 angle reduced to [0, 2*pi), in float64
__device__ __forceinline__ void phasor64(double ang, double& re, double& im) {
  ang -= TWO_PI * floor(ang * (1.0 / TWO_PI));
  sincos(ang, &im, &re);
}

// (pr, pi) of lane j < ntiles: phase0 (x) e^{j*omega*(cyc*(m0 + j*tile)
// + 1)}, the base of the work item's tile j
__device__ __forceinline__ void tile_base(float p0r, float p0i, double omega,
                                          int cyc, long long m0, int tile,
                                          int j, float& pr, float& pi) {
  float br, bi;
  phasor(omega * (double)(cyc * (m0 + (long long)j * tile) + 1), br, bi);
  pr = p0r * br - p0i * bi;
  pi = p0r * bi + p0i * br;
}

// re = Re(y * phasor) * pcm_scale -> int16, truncated and saturated
__device__ __forceinline__ short to_pcm(float yr, float yi, float fr, float fi,
                                        float gain, float pcm_scale) {
  const float re = (yr * gain) * fr - (yi * gain) * fi;
  return (short)max(-32768, min(32767, __float2int_rz(re * pcm_scale)));
}

// The carried state of channel c, written by the warp of its first work
// item (lanes ``lane`` + ``step``*j): the phase after n = S*CYC samples and
// the last ntaps-1 samples of [old tail | zero-stuffed symbols].
__device__ void write_state(const float* sym_re, const float* sym_im,
                            const float* tail_re, const float* tail_im,
                            float p0r, float p0i, float* nph_re,
                            float* nph_im, float* ntail_re, float* ntail_im,
                            long long c, int S, int ntaps, int cyc,
                            double omega, int lane, int step) {
  const long long n = (long long)S * cyc;
  if (lane == 0) {
    float er, ei;
    phasor(omega * (double)n, er, ei);
    const float ar = p0r * er - p0i * ei, ai = p0r * ei + p0i * er;
    const float inv = 1.f / sqrtf(ar * ar + ai * ai);
    nph_re[c] = ar * inv;
    nph_im[c] = ai * inv;
  }
  const int h = ntaps - 1;
  for (int k = lane; k < h; k += step) {
    float vr = 0.f, vi = 0.f;
    if (k + n < h) {                     // still the old tail
      vr = tail_re[c * h + k + n];
      vi = tail_im[c * h + k + n];
    } else if ((h - k) % cyc == 0) {     // a symbol lane
      const long long m = S - (h - k) / cyc;
      vr = sym_re[c * S + m];
      vi = sym_im[c * S + m];
    }
    ntail_re[c * h + k] = vr;
    ntail_im[c * h + k] = vi;
  }
}

template <int CYC>
__global__ void __launch_bounds__(32 * NWARP)
tx_kernel(const float* __restrict__ sym_re, const float* __restrict__ sym_im,
          const float* __restrict__ tail_re, const float* __restrict__ tail_im,
          const float* __restrict__ p0_re, const float* __restrict__ p0_im,
          int16_t* __restrict__ pcm, float* __restrict__ nph_re,
          float* __restrict__ nph_im, float* __restrict__ ntail_re,
          float* __restrict__ ntail_im, int C, int S, int ntaps, int nchunks,
          const __grid_constant__ Taps taps, double omega, float gain,
          float pcm_scale) {
  using Sh = Shape<CYC>;
  constexpr int R = Sh::R, TILE = Sh::TILE, NKMAX = Sh::NKMAX, W = Sh::W,
                WS = Sh::WS, COPIES = Sh::COPIES;
  // [warp][copy][plane re hi, re lo, im hi, im lo][x]: x = xe + R-1 - m,
  // the window in reverse; copy 1 (R = 1) is copy 0 shifted by one
  __shared__ __align__(16) __half win[NWARP][COPIES][4][WS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * NWARP + warp;
  const long long c = item / nchunks;
  if (c >= C) return;                    // the whole warp leaves together
  const long long m_first = (item % nchunks) * L;
  const long long xe = m_first + L;
  const int hs = (ntaps - 1) / CYC;
  const int nk = (hs + R - 1) / 16 + 1;  // live k-tiles
  const int g = lane >> 2, t = lane & 3;

  // the window: symbols xe + R-1 - x for x < W, 8 loads a lane issued
  // before any is split, so that they are in flight together
  constexpr int NX = (W + 31) / 32;
#pragma unroll
  for (int j0 = 0; j0 < NX; j0 += 8) {
    float vr[8], vi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = lane + 32 * (j0 + j);
      const long long m = xe + R - 1 - x;
      const bool in = j0 + j < NX && x < W;
      vr[j] = in ? symbol(sym_re, tail_re, c, S, ntaps, CYC, hs, m) : 0.f;
      vi[j] = in ? symbol(sym_im, tail_im, c, S, ntaps, CYC, hs, m) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = lane + 32 * (j0 + j);
      if (j0 + j >= NX || x >= W) break;
      __half h[4];
      split(vr[j], h[0], h[1]);
      split(vi[j], h[2], h[3]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        win[warp][0][p][x] = h[p];
        if (COPIES == 2 && x > 0) win[warp][COPIES - 1][p][x - 1] = h[p];
      }
    }
  }

  // B: column n = g is sample q = g % CYC of symbol j = g / CYC of a row,
  // whose newest symbol (d = 0) is j = R - 1; b_r holds d = 16kt + 2t + 8r,
  // +1
  uint32_t bh[NKMAX][2], bl[NKMAX][2];
#pragma unroll
  for (int kt = 0; kt < NKMAX; ++kt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __half hi[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 16 * kt + 2 * t + 8 * r + e;
        const int k = ntaps - 1 - CYC * (d + g / CYC - (R - 1)) - g % CYC;
        split(g < R * CYC && k >= 0 && k < ntaps ? taps.h[k] : 0.f, hi[e],
              lo[e]);
      }
      bh[kt][r] = pack(hi[0], hi[1]);
      bl[kt][r] = pack(lo[0], lo[1]);
    }
  }

  // the ramp of this lane's samples: row g + 8i, column 2t + e, at offset
  // CYC*R*(g + 8i) + 2t + e from the tile's first sample
  float rr[2][2], ri[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      phasor(omega * (double)(CYC * R * (g + 8 * i) + 2 * t + e), rr[i][e],
             ri[i][e]);
  const float p0r = p0_re[c], p0i = p0_im[c];
  float pbr = 0.f, pbi = 0.f;            // lane j: the base of tile j
  if (lane < L / TILE)
    tile_base(p0r, p0i, omega, CYC, m_first, TILE, lane, pbr, pbi);
  if (m_first == 0)
    write_state(sym_re, sym_im, tail_re, tail_im, p0r, p0i, nph_re, nph_im,
                ntail_re, ntail_im, c, S, ntaps, CYC, omega, lane, 32);
  __syncwarp();                          // the window is in

  // this lane's A pairs: copy (g & 1) for R = 1, whose pairs start one
  // half earlier
  const int cp = COPIES == 2 ? (g & 1) : 0;
  const int nout = R * CYC;              // live columns
  int16_t* out = pcm + c * S * CYC;
  const int ntiles = (int)min((long long)L, S - m_first + TILE - 1) / TILE;
#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    const long long m0 = m_first + (long long)i * TILE;
    const int x0 = L - i * TILE - R * g + 2 * t - cp;   // row g, d = 2t
    float acc[2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[p][r] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NKMAX; ++kt) {
      if (kt >= nk) break;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const __half* xh = &win[warp][cp][2 * p][x0 + 16 * kt];
        const __half* xl = &win[warp][cp][2 * p + 1][x0 + 16 * kt];
        const uint32_t ah[4] = {ld32(xh), ld32(xh - 8 * R), ld32(xh + 8),
                                ld32(xh - 8 * R + 8)};
        const uint32_t al[4] = {ld32(xl), ld32(xl - 8 * R), ld32(xl + 8),
                                ld32(xl - 8 * R + 8)};
        mma_f16(acc[p], al, bh[kt][0], bh[kt][1]);
        mma_f16(acc[p], ah, bl[kt][0], bl[kt][1]);
        mma_f16(acc[p], ah, bh[kt][0], bh[kt][1]);
      }
    }
    const float br = __shfl_sync(FULL, pbr, i), bi = __shfl_sync(FULL, pbi, i);
#pragma unroll
    for (int r = 0; r < 2; ++r) {        // rows g, g + 8
      const long long sym0 = m0 + R * (g + 8 * r);
      short v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float fr = br * rr[r][e] - bi * ri[r][e];
        const float fi = br * ri[r][e] + bi * rr[r][e];
        v[e] = to_pcm(acc[0][2 * r + e], acc[1][2 * r + e], fr, fi, gain,
                      pcm_scale);
      }
      const int n0 = 2 * t;
      int16_t* o = out + CYC * sym0 + n0;
      if (CYC % 2 == 0) {                // both samples of one symbol
        if (n0 < nout && sym0 + n0 / CYC < S)
          *reinterpret_cast<uint32_t*>(o) =
              (uint32_t)(uint16_t)v[0] | ((uint32_t)(uint16_t)v[1] << 16);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + e < nout && sym0 + (n0 + e) / CYC < S) o[e] = v[e];
      }
    }
  }
}

template <int CYC>
int launch(const void* sym_re, const void* sym_im,
           const void* tail_re, const void* tail_im, const void* p0_re,
           const void* p0_im, void* pcm, void* nph_re, void* nph_im,
           void* ntail_re, void* ntail_im, int C, int S, int ntaps,
           const Taps& taps, double omega, float gain, float pcm_scale,
           cudaStream_t stream) {
  const int nchunks = (S + L - 1) / L;
  const long long blocks = ((long long)C * nchunks + NWARP - 1) / NWARP;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tx_kernel<CYC><<<(unsigned)blocks, 32 * NWARP, 0, stream>>>(
      (const float*)sym_re, (const float*)sym_im, (const float*)tail_re,
      (const float*)tail_im, (const float*)p0_re, (const float*)p0_im,
      (int16_t*)pcm, (float*)nph_re, (float*)nph_im, (float*)ntail_re,
      (float*)ntail_im, C, S, ntaps, nchunks, taps, omega, gain, pcm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The general instance, tx_general_kernel: the TPU kernel's whole gate
// (qpsk_tpu/ops/pallas/tx_kernel.py, tx_supported: any samples per symbol
// CYC >= 2 and a halo of at most 128 symbols, (ntaps - 1 + CYC - 1) / CYC
// + 1 <= 128, so 16 samples per symbol, 131 taps at 4, 255 at 8), where
// tx_kernel<CYC> above takes CYC 2..8 and 129 taps.  It computes what
// tx_kernel computes (the header above has the formulas): with the taps
// reversed, hr[j] = h[ntaps-1 - j], output t is the sum over the symbols m
// with 0 <= t - CYC*m < ntaps of hr[t - CYC*m] * sym[m] (the symbols before
// the call read from the carried tail's lanes in place), times gain, mixed
// by phase0 * e^{j*omega*(t+1)}, Re * pcm_scale, truncated and saturated
// to int16; the warp of a channel's first symbols writes its carried state
// (write_state).
//
// What bounds it on the H100: bytes.  At 16 samples per symbol and 127
// taps a sample costs 16 multiply-adds (8 taps, complex symbols, real
// taps) against 2 bytes of PCM written and half a byte of symbols read:
// 0.0126 ms at 256 channels x 4096 symbols, the float32 FMAs 0.010.
// The instance it replaced spent, on one thread a sample, two 64-bit
// divisions, a float64 sincos and a bounds-checked symbol fetch with
// 64-bit indices a tap, some hundreds of instructions a sample (0.59 ms).
// Here, on the CUDA cores:
//   - a lane computes 8 consecutive samples t0..t0+7 (one 16-byte store),
//     and the 8 at t0 + 256*CYC, 256 symbols later: each symbol m they
//     meet contributes hr[t0 - CYC*m + e], 8 consecutive reversed taps,
//     the same for both groups, so a symbol pair costs two 8-byte loads of
//     symbols, two 16-byte loads of taps and 32 multiply-adds; a lane's
//     symbols are the (ntaps + 6) / CYC + 1 newest from floor((t0+7)/CYC),
//     one integer division a step; the lanes that meet the same taps read
//     one address (a broadcast);
//   - the taps sit in shared memory, reversed behind 8 zeros, in 4 copies
//     shifted by 0..3, so that the 8 taps of any offset are two aligned
//     16-byte loads at every CYC; they come from the device copy the
//     wrapper keeps (2033 taps at CYC 16 exceed a by-value parameter);
//   - one warp a (channel, TGL symbols) work item, on grid.x, so any length
//     runs, int32 indices within it; its symbols plus the history (the
//     carried tail's lanes) are staged in shared memory as complex pairs;
//   - the carrier as tx_kernel computes it: a float64 base e^{j*omega*(T +
//     1)} of each 256-sample step T, reduced mod 2*pi (one sincos a lane
//     covers 32 steps, shuffled out), times the float32 ramp e^{j*omega*o}
//     of the lane's 8 offsets o, computed once in float64 (two sincos and
//     a float64 step) with gain * pcm_scale folded in, so a sample costs
//     the two complex products and the conversion.
// At 255 taps and 8 samples per symbol the multiply-adds (0.017 ms of
// float32 FMAs at 256 x 4096) are above the bytes (0.008): the CUDA cores
// are kept there too, as the measured time is 2.7x that floor, not the
// floor; general_work prints both.  Times it was chosen by (fec_times.py
// --gen-modem, NVIDIA H100 80GB HBM3, 700.00 W, 256 channels x 4096
// symbols alone in a CUDA graph, the instance it replaced in brackets):
// 16 samples per symbol 0.0435 ms [0.5917], 3.5x the bytes; 255 taps at 8
// 0.0465 [0.8898]; 131 taps at 4 0.0275 [0.4421].  What is left is issue:
// by count of its code a sample costs some 35 instructions a lane, half
// of them the FIR's, and one wave of warps hides little shared-load latency.
constexpr int TGW = 4;                   // warps a block
constexpr int TGL = 512;                 // symbols a work item
constexpr int TGS = 256;                 // samples a warp step, 8 a lane

// The shared-memory layout, in 4-byte words: the taps' 4 copies of tw
// words, then a warp's window of win complex symbols.
struct TxGenLayout {
  int nsy, tw, win, bytes;
  TxGenLayout(int cyc, int ntaps) {
    nsy = (ntaps + 6) / cyc + 1;         // symbols 8 samples meet, at most
    tw = (ntaps + 2 * cyc + 24 + 3) / 4 * 4;
    win = TGL + nsy;
    bytes = 4 * tw * 4 + TGW * win * 8;
  }
};

__global__ void __launch_bounds__(32 * TGW)
tx_general_kernel(const float* __restrict__ sym_re,
                  const float* __restrict__ sym_im,
                  const float* __restrict__ tail_re,
                  const float* __restrict__ tail_im,
                  const float* __restrict__ p0_re,
                  const float* __restrict__ p0_im,
                  const float* __restrict__ taps, int16_t* __restrict__ pcm,
                  float* __restrict__ nph_re, float* __restrict__ nph_im,
                  float* __restrict__ ntail_re, float* __restrict__ ntail_im,
                  int C, int S, int cyc, int ntaps, int nitems, int nsy,
                  int tw, double omega, float gain, float pcm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tc = reinterpret_cast<float*>(smem_raw);   // [4][tw]
  float2* win = reinterpret_cast<float2*>(smem_raw + 16 * tw) +
                warp * (TGL + nsy);
  // copy r: tc[r][u] = hr[u + r - 8], zero outside the taps
  for (int e = threadIdx.x; e < 4 * tw; e += 32 * TGW) {
    const int r = e / tw, j = e - r * tw + r - 8;
    tc[e] = j >= 0 && j < ntaps ? taps[ntaps - 1 - j] : 0.f;
  }
  __syncthreads();
  const long long item = (long long)blockIdx.x * TGW + warp;
  const int c = (int)(item / nitems);
  if (c >= C) return;                    // the whole warp leaves together
  const long long m_first = (item % nitems) * TGL;
  const int hs = (ntaps - 1) / cyc;
  const float p0r = p0_re[c], p0i = p0_im[c];

  // the ramp of this lane's offsets o = 8*lane + e, times gain *
  // pcm_scale: e^{j*omega*8*lane} stepped by e^{j*omega} in float64
  float rr[8], ri[8];
  {
    double ar, ai, sr, si;
    phasor64(omega * (double)(8 * lane), ar, ai);
    phasor64(omega, sr, si);
    const double gs = (double)gain * (double)pcm_scale;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      rr[e] = (float)(ar * gs);
      ri[e] = (float)(ai * gs);
      const double nr = ar * sr - ai * si;
      ai = ar * si + ai * sr;
      ar = nr;
    }
  }
  // the window: symbol m_first - (nsy - 1) + x at x
  for (int x = lane; x < TGL + nsy - 1; x += 32) {
    const long long m = m_first - (nsy - 1) + x;
    float vr = 0.f, vi = 0.f;
    if (m >= 0 && m < S) {
      vr = sym_re[(long long)c * S + m];
      vi = sym_im[(long long)c * S + m];
    } else if (m < 0 && m >= -hs) {      // the carried tail's lane
      const long long k = (long long)c * (ntaps - 1) + (ntaps - 1) + cyc * m;
      vr = tail_re[k];
      vi = tail_im[k];
    }
    win[x] = make_float2(vr, vi);
  }
  if (m_first == 0)
    write_state(sym_re, sym_im, tail_re, tail_im, p0r, p0i, nph_re, nph_im,
                ntail_re, ntail_im, c, S, ntaps, cyc, omega, lane, 32);
  __syncwarp();                          // the window is in

  const long long n = (long long)S * cyc;
  const long long t_first = m_first * cyc;
  // the item's 256-sample steps; a lane takes step st and step st + cyc,
  // 256 symbols later, whose samples meet the same taps
  const int nsteps = (int)((min((long long)TGL * cyc, n - t_first) + TGS - 1) / TGS);
  const bool vec = n % 8 == 0;           // every lane's 8 samples 16-byte aligned
  int16_t* out = pcm + (long long)c * n + t_first;
  float pb[2][2];                        // lane j: the bases of 32*(st/32) + j, + cyc
#pragma unroll 1
  for (int st = 0; st < min(cyc, nsteps); ++st) {
    if ((st & 31) == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float br, bi;
        phasor(omega * (double)(t_first + (long long)(st + lane + hf * cyc) * TGS + 1),
               br, bi);
        pb[hf][0] = p0r * br - p0i * bi;
        pb[hf][1] = p0r * bi + p0i * br;
      }
    }
    const int tl = st * TGS + 8 * lane;  // this lane's first sample
    float yr[2][8], yi[2][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) yr[0][e] = yi[0][e] = yr[1][e] = yi[1][e] = 0.f;
    const int mh = (tl + 7) / cyc;       // the newest symbol it meets
#pragma unroll 2
    for (int jj = 0; jj < nsy; ++jj) {
      const int m = mh - jj;
      const float2 s0 = win[m + nsy - 1], s1 = win[m + nsy - 1 + TGL / 2];
      const int jt = tl - cyc * m + 8;   // hr index of e = 0, plus 8
      const int r = jt & 3;
      const float4* tp = reinterpret_cast<const float4*>(tc + r * tw + jt - r);
      const float4 a = tp[0], b = tp[1];
      const float h[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        yr[0][e] = fmaf(h[e], s0.x, yr[0][e]);
        yi[0][e] = fmaf(h[e], s0.y, yi[0][e]);
        yr[1][e] = fmaf(h[e], s1.x, yr[1][e]);
        yi[1][e] = fmaf(h[e], s1.y, yi[1][e]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hf == 1 && st + cyc >= nsteps) break;   // the whole warp
      const float br = __shfl_sync(FULL, pb[hf][0], st & 31);
      const float bi = __shfl_sync(FULL, pb[hf][1], st & 31);
      const int tt = tl + hf * cyc * TGS;
      __align__(16) short v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float fr = br * rr[e] - bi * ri[e];
        const float fi = br * ri[e] + bi * rr[e];
        v[e] = (short)max(-32768,
                          min(32767, __float2int_rz(yr[hf][e] * fr - yi[hf][e] * fi)));
      }
      if (vec && t_first + tt + 8 <= n) {
        *reinterpret_cast<int4*>(out + tt) = *reinterpret_cast<const int4*>(v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (t_first + tt + e < n) out[tt + e] = v[e];
      }
    }
  }
}

}  // namespace

// symbols (C, S), the carried zero-stuffed tail (C, ntaps-1) and phase
// (C,) in; PCM (C, S*cycles) int16 and the new phase and tail out.
// taps_host: the ntaps RRC taps (scaled; ``gain`` carries the inverse).
// Takes cycles 2..8, odd ntaps <= 129, C >= 1, S >= 1.
extern "C" int qpsk_tx(const void* sym_re, const void* sym_im,
                       const void* tail_re, const void* tail_im,
                       const void* p0_re, const void* p0_im, void* pcm,
                       void* nph_re, void* nph_im, void* ntail_re,
                       void* ntail_im, int C, int S, int cycles, int ntaps,
                       const void* taps_host, double omega,
                       float gain, float pcm_scale, void* stream) {
  if (C < 1 || S < 1 || ntaps < 1 || ntaps > KT || ntaps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int k = 0; k < KT; ++k)
    taps.h[k] = k < ntaps ? static_cast<const float*>(taps_host)[k] : 0.f;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cycles) {
#define QPSK_TX_CASE(N)                                                     \
  case N:                                                                   \
    return launch<N>(sym_re, sym_im, tail_re, tail_im, p0_re, p0_im, pcm,   \
                     nph_re, nph_im, ntail_re, ntail_im, C, S, ntaps, taps, \
                     omega, gain, pcm_scale, st);
    QPSK_TX_CASE(2)
    QPSK_TX_CASE(3)
    QPSK_TX_CASE(4)
    QPSK_TX_CASE(5)
    QPSK_TX_CASE(6)
    QPSK_TX_CASE(7)
    QPSK_TX_CASE(8)
#undef QPSK_TX_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The general instance: symbols (C, S), the carried zero-stuffed tail
// (C, ntaps-1) and phase (C,) in, PCM (C, S*cycles) int16 and the new
// phase and tail out; ``taps`` the ntaps RRC taps in device memory.
// Takes cycles >= 2, odd ntaps with (ntaps - 1) / cycles <= 128, C >= 1,
// S >= 1, S * cycles < 2^31.
extern "C" int qpsk_tx_gen(const void* sym_re, const void* sym_im,
                           const void* tail_re, const void* tail_im,
                           const void* p0_re, const void* p0_im,
                           const void* taps, void* pcm, void* nph_re,
                           void* nph_im, void* ntail_re, void* ntail_im,
                           int C, int S, int cycles, int ntaps, double omega,
                           float gain, float pcm_scale, void* stream) {
  if (C < 1 || S < 1 || cycles < 2 || ntaps < 1 || ntaps % 2 == 0 ||
      (ntaps - 1) / cycles > 128 || (long long)S * cycles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const TxGenLayout L(cycles, ntaps);
  const int nitems = (S + TGL - 1) / TGL;
  const long long blocks = ((long long)C * nitems + TGW - 1) / TGW;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tx_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  tx_general_kernel<<<(unsigned)blocks, 32 * TGW, L.bytes,
                      (cudaStream_t)stream>>>(
      (const float*)sym_re, (const float*)sym_im, (const float*)tail_re,
      (const float*)tail_im, (const float*)p0_re, (const float*)p0_im,
      (const float*)taps, (int16_t*)pcm, (float*)nph_re, (float*)nph_im,
      (float*)ntail_re, (float*)ntail_im, C, S, cycles, ntaps, nitems, L.nsy,
      L.tw, omega, gain, pcm_scale);
  return (int)cudaGetLastError();
}
