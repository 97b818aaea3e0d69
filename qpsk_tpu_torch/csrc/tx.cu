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
// + 1 <= 128, so 255 taps at 8 samples per symbol or 16 samples per
// symbol), where tx_kernel<CYC> above takes CYC 2..8 and 129 taps.  It
// computes what tx_kernel computes (the header above has the formulas):
// output t = CYC*m + q is the polyphase sum over d = 0..HS of h[ntaps-1 -
// CYC*d - q] * sym[m - d], the symbols before the call read from the
// carried tail's lanes in place, times gain, mixed by phase0 *
// e^{j*omega*(t+1)} (the angle in float64, reduced mod 2*pi), Re *
// pcm_scale, truncated and saturated to int16; the block of the call's
// first sample of a channel writes its carried state (write_state).
//
// What bounds it on the H100: arithmetic on the CUDA cores and the float64
// phasor of every sample.  The design is the plain one: one thread a
// (channel, sample), the taps in device memory (any count; the wrapper
// keeps them on the card), the symbols read through the L1 cache, a
// grid-stride loop so any length runs.  A simple kernel that is right:
// the tensor-core route of tx_kernel<CYC> is the one to widen if these
// geometries become hot.
__global__ void __launch_bounds__(256)
tx_general_kernel(const float* __restrict__ sym_re,
                  const float* __restrict__ sym_im,
                  const float* __restrict__ tail_re,
                  const float* __restrict__ tail_im,
                  const float* __restrict__ p0_re,
                  const float* __restrict__ p0_im,
                  const float* __restrict__ taps, int16_t* __restrict__ pcm,
                  float* __restrict__ nph_re, float* __restrict__ nph_im,
                  float* __restrict__ ntail_re, float* __restrict__ ntail_im,
                  int C, int S, int cyc, int ntaps, double omega, float gain,
                  float pcm_scale) {
  const long long n = (long long)S * cyc;
  const int hs = (ntaps - 1) / cyc;
  const long long total = (long long)C * n;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long c = e / n, t = e - c * n;
    const long long m = t / cyc;
    const int q = (int)(t - m * cyc);
    float yr = 0.f, yi = 0.f;
    for (int d = 0; d <= hs; ++d) {
      const int k = ntaps - 1 - cyc * d - q;
      if (k < 0) break;
      const float h = __ldg(taps + k);
      yr = fmaf(h, symbol(sym_re, tail_re, c, S, ntaps, cyc, hs, m - d), yr);
      yi = fmaf(h, symbol(sym_im, tail_im, c, S, ntaps, cyc, hs, m - d), yi);
    }
    const float p0r = p0_re[c], p0i = p0_im[c];
    float er, ei;
    phasor(omega * (double)(t + 1), er, ei);
    const float fr = p0r * er - p0i * ei, fi = p0r * ei + p0i * er;
    pcm[e] = to_pcm(yr, yi, fr, fi, gain, pcm_scale);
    if (t == 0)
      write_state(sym_re, sym_im, tail_re, tail_im, p0r, p0i, nph_re, nph_im,
                  ntail_re, ntail_im, c, S, ntaps, cyc, omega, 0, 1);
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
// Takes cycles >= 2, odd ntaps, C >= 1, S >= 1.
extern "C" int qpsk_tx_gen(const void* sym_re, const void* sym_im,
                           const void* tail_re, const void* tail_im,
                           const void* p0_re, const void* p0_im,
                           const void* taps, void* pcm, void* nph_re,
                           void* nph_im, void* ntail_re, void* ntail_im,
                           int C, int S, int cycles, int ntaps, double omega,
                           float gain, float pcm_scale, void* stream) {
  if (C < 1 || S < 1 || cycles < 2 || ntaps < 1 || ntaps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)C * S * cycles;
  const long long blocks = std::min((total + 255) / 256, 132LL * 64);
  tx_general_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)sym_re, (const float*)sym_im, (const float*)tail_re,
      (const float*)tail_im, (const float*)p0_re, (const float*)p0_im,
      (const float*)taps, (int16_t*)pcm, (float*)nph_re, (float*)nph_im,
      (float*)ntail_re, (float*)ntail_im, C, S, cycles, ntaps, omega, gain,
      pcm_scale);
  return (int)cudaGetLastError();
}
