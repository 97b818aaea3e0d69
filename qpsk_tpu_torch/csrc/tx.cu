// TX modulator kernel for Hopper (sm_90a).
//
// Replaces: qpsk_tpu/ops/pallas/tx_kernel.py, _kernel launched by _tx_2d
// (entry tx_modulate_fused), at 4 or 8 samples per symbol (2400 and 1200
// baud).
//
// What it computes, per channel: QPSK symbols -> zero-stuff x CYC -> 127-tap
// RRC -> x gain -> mix up by phase0 * e^{j*omega*(t+1)} -> Re * pcm_scale
// -> int16, truncating toward zero like C's float-to-int conversion and
// saturating at the int16 range like the JAX package's astype.  The
// zero-stuffed signal is never built: output sample t = CYC*m + q only
// meets the symbols m - d at taps 126 - CYC*d - q, so each output is a
// polyphase sum over symbols: 32 terms at CYC 4 (31 for q = 3), 16 at CYC 8
// (15 for q = 7).  The HS = 126 / CYC symbols before the call come from the
// carried zero-stuffed tail (lanes 126 % CYC + CYC*m), which the wrapper
// extracts.  The carrier angle omega*(t+1) is reduced mod 2*pi in float64,
// so long calls keep their phase.
//
// What bounds it on the H100: arithmetic and the float64 phasor.  Per output
// sample it reads 8/CYC bytes of symbols and writes 2 bytes of PCM, against
// 2*(127/CYC) float32 FMAs and one float64 sincos; the FMAs take their taps
// from a by-value kernel parameter at compile-time indices (constant-bank
// operands), and the window of a block (128 + HS symbols) sits in shared
// memory.
//
// Layout: one block per (channel, 128 symbols), 128 threads, each thread
// one symbol slot and its CYC output samples (one 8- or 16-byte store).  Any
// channel count and symbol count work; the ragged end of a row is masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTAPS = 127;
constexpr int BS = 128;                  // symbol slots per block

struct Taps {
  float h[NTAPS];
};

template <int CYC>
struct alignas(2 * CYC) Samples {
  short v[CYC];
};

template <int CYC>
__global__ void __launch_bounds__(BS)
tx_kernel(const float* __restrict__ sym_re, const float* __restrict__ sym_im,
          const float* __restrict__ hist_re, const float* __restrict__ hist_im,
          const float* __restrict__ p0_re, const float* __restrict__ p0_im,
          Samples<CYC>* __restrict__ pcm, int S, const Taps taps,
          double omega, float gain, float pcm_scale) {
  constexpr int HS = (NTAPS - 1) / CYC;  // history symbols: 31 or 15
  __shared__ float wr[BS + HS], wi[BS + HS];
  const int c = blockIdx.x;
  const int m0 = blockIdx.y * BS;
  const int tid = threadIdx.x;
  for (int w = tid; w < BS + HS; w += BS) {
    const int j = m0 - HS + w;           // symbol index, < 0 from the tail
    float vr = 0.f, vi = 0.f;
    if (j < 0) {
      vr = hist_re[(long long)c * HS + HS + j];
      vi = hist_im[(long long)c * HS + HS + j];
    } else if (j < S) {
      vr = sym_re[(long long)c * S + j];
      vi = sym_im[(long long)c * S + j];
    }
    wr[w] = vr;
    wi[w] = vi;
  }
  __syncthreads();
  const int m = m0 + tid;
  if (m >= S) return;

  float yr[CYC], yi[CYC];
#pragma unroll
  for (int q = 0; q < CYC; ++q) yr[q] = yi[q] = 0.f;
#pragma unroll
  for (int d = 0; d <= HS; ++d) {
    const float sr = wr[tid + HS - d], si = wi[tid + HS - d];
#pragma unroll
    for (int q = 0; q < CYC; ++q) {
      const int k = NTAPS - 1 - CYC * d - q;
      if (k >= 0) {
        yr[q] = fmaf(taps.h[k], sr, yr[q]);
        yi[q] = fmaf(taps.h[k], si, yi[q]);
      }
    }
  }

  const float pr0 = p0_re[c], pi0 = p0_im[c];
  const double two_pi = 6.283185307179586476925286766559;
  Samples<CYC> out;
#pragma unroll
  for (int q = 0; q < CYC; ++q) {
    double ang = omega * (double)((long long)CYC * m + q + 1);
    ang -= two_pi * floor(ang / two_pi);
    double sd, cd;
    sincos(ang, &sd, &cd);
    const float er = (float)cd, ei = (float)sd;
    const float fr = pr0 * er - pi0 * ei;
    const float fi = pr0 * ei + pi0 * er;
    const float re = (yr[q] * gain) * fr - (yi[q] * gain) * fi;
    out.v[q] = (short)max(-32768, min(32767, __float2int_rz(re * pcm_scale)));
  }
  pcm[(long long)c * S + m] = out;
}

template <int CYC>
int launch(const void* sym_re, const void* sym_im, const void* hist_re,
           const void* hist_im, const void* p0_re, const void* p0_im,
           void* pcm, int C, int S, const Taps& taps, double omega, float gain,
           float pcm_scale, void* stream) {
  dim3 grid(C, (S + BS - 1) / BS);
  tx_kernel<CYC><<<grid, BS, 0, (cudaStream_t)stream>>>(
      (const float*)sym_re, (const float*)sym_im, (const float*)hist_re,
      (const float*)hist_im, (const float*)p0_re, (const float*)p0_im,
      (Samples<CYC>*)pcm, S, taps, omega, gain, pcm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qpsk_tx(const void* sym_re, const void* sym_im,
                       const void* hist_re, const void* hist_im,
                       const void* p0_re, const void* p0_im, void* pcm,
                       int C, int S, int cycles, const void* taps_host,
                       double omega, float gain, float pcm_scale,
                       void* stream) {
  Taps taps;
  for (int k = 0; k < NTAPS; ++k) taps.h[k] = static_cast<const float*>(taps_host)[k];
  if (cycles == 4)
    return launch<4>(sym_re, sym_im, hist_re, hist_im, p0_re, p0_im, pcm, C,
                     S, taps, omega, gain, pcm_scale, stream);
  if (cycles == 8)
    return launch<8>(sym_re, sym_im, hist_re, hist_im, p0_re, p0_im, pcm, C,
                     S, taps, omega, gain, pcm_scale, stream);
  return (int)cudaErrorInvalidValue;
}
