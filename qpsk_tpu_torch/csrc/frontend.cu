// RX front-end kernel for Hopper (sm_90a).
//
// Replaces: qpsk_tpu/ops/pallas/frontend_kernel.py, _kernel launched by
// _frontend_2d_tm (entry rx_frontend_fused_tm), in the slice's mode: no
// AGC power output.
//
// What it computes, per channel and 512-sample frame f of one call:
//   x = int16 PCM * (1/pcm_scale), preceded by the 126-sample raw halo
//       (the previous frame's last samples, or the carried raw tail);
//   y[s] = gain * sum_k hm[k] * x[s + k], k = 0..126, with the complex
//       carrier-MODULATED RRC taps hm (the NCO mix folded into the filter);
//   e[p] = sum_i |y[4i + p]|^2, p = 0..3; index = first argmax of e;
//   pick[i] = y[4i + index] * phase0 * e^{j*omega*(pos+1)},
//       pos = f*512 + 4i + index, with the angle of each thread's first
//       pick reduced mod 2*pi in float64;
//   the one-frame decimation delay: frame f's picks go to rows
//       (f+1)*128 .. of the time-major (T, C) output, frame 0's rows are
//       the carried decim_delay, and the last frame's picks are the new
//       decim_delay.
//
// What bounds it on the H100: arithmetic.  Each output sample costs 254
// float32 FMAs (127 complex taps on a real input), 130 k FMAs per frame and
// channel, against 2 bytes of PCM read and 2 bytes of picks written per
// sample: about 64 FMAs per byte, far above the card's float32 ridge
// (67 TFLOP/s / 3.35 TB/s = 10 FLOP/byte).  So the design keeps the FMAs
// fed from registers: the taps are a by-value kernel parameter with
// compile-time indices (constant-bank operands of the FMAs, no loads), the
// frame window sits in shared memory, and each thread computes all four
// phases of one symbol at a time, so every window value it loads feeds up
// to 8 FMAs.  The outputs go to shared memory, not registers (holding a
// thread's 64 outputs for the pick spilled), and the pick stage reads back
// the selected phase: one block of 221 KB per SM.
// No tensor cores: the float32 reference is held to 3e-4, so TF32/bf16
// and the TPU's bf16 pass are out.
//
// Layout: one block per (32 channels, frame), 32 x 16 threads.  threadIdx.x
// is the channel, so the (T, C) stores of a warp are 128 contiguous bytes
// and the output planes in shared memory are read and written without bank
// conflicts; the window row stride is odd (639 floats), so the 32 channels
// of a warp read 32 different banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTAPS = 127;
constexpr int HALO = NTAPS - 1;          // raw samples carried from before
constexpr int FSZ = 512;                 // samples per frame
constexpr int CYC = 4;                   // samples per symbol
constexpr int NSYM = FSZ / CYC;          // symbols per frame
constexpr int CT = 32;                   // channels per block
constexpr int SPT = 8;                   // symbols per thread
constexpr int NTY = NSYM / SPT;          // thread rows per block
constexpr int WIN = HALO + FSZ;          // window samples per channel
constexpr int STRIDE = WIN + 1;          // odd: conflict-free columns
// window [CT][STRIDE], outputs [2][CYC][NSYM][CT], energies [NTY][CYC][CT]
constexpr size_t SMEM_BYTES =
    (size_t)(CT * STRIDE + 2 * CYC * NSYM * CT + NTY * CYC * CT) * sizeof(float);

struct Taps {
  float re[NTAPS];
  float im[NTAPS];
};

__global__ void __launch_bounds__(CT * NTY)
frontend_tm_kernel(const int16_t* __restrict__ pcm,
                   const float* __restrict__ tail_raw,
                   const float* __restrict__ p0_re,
                   const float* __restrict__ p0_im,
                   const float* __restrict__ dd_re,
                   const float* __restrict__ dd_im,
                   float* __restrict__ zr, float* __restrict__ zi,
                   int32_t* __restrict__ index,
                   float* __restrict__ ndd_re, float* __restrict__ ndd_im,
                   int C, int F, const Taps taps, double omega, float gain,
                   float inv_scale) {
  extern __shared__ float smem[];
  float* x = smem;                                  // [CT][STRIDE]
  float* yr_s = x + CT * STRIDE;                    // [CYC][NSYM][CT]
  float* yi_s = yr_s + CYC * NSYM * CT;             // [CYC][NSYM][CT]
  float* esum = yi_s + CYC * NSYM * CT;             // [NTY][CYC][CT]
  __shared__ int sel[CT];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * CT + tx;
  const int c0 = blockIdx.x * CT;
  const int f = blockIdx.y;
  const long long n = (long long)F * FSZ;

  // stage the raw window of each channel (halo + this frame); consecutive
  // threads read consecutive samples of one channel
#pragma unroll 4
  for (int e = tid; e < CT * WIN; e += CT * NTY) {
    const int cc = e / WIN, w = e - cc * WIN;
    const int c = c0 + cc;
    float v = 0.f;
    if (c < C) {
      if (w >= HALO || f > 0) {
        v = (float)pcm[(long long)c * n + (long long)f * FSZ + (w - HALO)] * inv_scale;
      } else {
        v = tail_raw[(long long)c * HALO + w];
      }
    }
    x[cc * STRIDE + w] = v;
  }
  __syncthreads();

  // the filter at all four phases of symbols ty*SPT .. ty*SPT+SPT-1, one
  // symbol at a time: outputs to shared memory, energies in registers
  const float* xc = x + tx * STRIDE;
  float e[CYC];
#pragma unroll
  for (int p = 0; p < CYC; ++p) e[p] = 0.f;
#pragma unroll 1
  for (int k = 0; k < SPT; ++k) {
    const int i = ty * SPT + k;
    float ar[CYC], ai[CYC];
#pragma unroll
    for (int p = 0; p < CYC; ++p) ar[p] = ai[p] = 0.f;
#pragma unroll
    for (int m = 0; m < NTAPS + CYC - 1; ++m) {
      const float v = xc[i * CYC + m];
#pragma unroll
      for (int p = 0; p < CYC; ++p) {
        const int t = m - p;
        if (t >= 0 && t < NTAPS) {
          ar[p] = fmaf(taps.re[t], v, ar[p]);
          ai[p] = fmaf(taps.im[t], v, ai[p]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < CYC; ++p) {
      const float yr = ar[p] * gain, yi = ai[p] * gain;
      yr_s[(p * NSYM + i) * CT + tx] = yr;
      yi_s[(p * NSYM + i) * CT + tx] = yi;
      e[p] = __fadd_rn(e[p], __fadd_rn(__fmul_rn(yr, yr), __fmul_rn(yi, yi)));
    }
  }
#pragma unroll
  for (int p = 0; p < CYC; ++p) esum[(ty * CYC + p) * CT + tx] = e[p];
  __syncthreads();
  if (ty == 0) {
    float best_e = 0.f;
    int best = 0;
    for (int p = 0; p < CYC; ++p) {
      float sum = 0.f;
      for (int r = 0; r < NTY; ++r) sum += esum[(r * CYC + p) * CT + tx];
      if (p == 0 || sum > best_e) {   // strict: the first maximum wins
        best_e = sum;
        best = p;
      }
    }
    sel[tx] = best;
    if (c0 + tx < C) index[(long long)(c0 + tx) * F + f] = best;
  }
  __syncthreads();

  const int c = c0 + tx;
  if (c >= C) return;
  // picks of the selected phase, rotated by phase0 * e^{j*omega*(pos+1)}:
  // the first pick's angle in float64, then steps of e^{j*omega*CYC}
  const int p = sel[tx];
  const int i0 = ty * SPT;
  const double two_pi = 6.283185307179586476925286766559;
  double ang = omega * (double)((long long)f * FSZ + i0 * CYC + p + 1);
  ang -= two_pi * floor(ang * (1.0 / two_pi));
  double sd, cd;
  sincos(ang, &sd, &cd);
  const float pr0 = p0_re[c], pi0 = p0_im[c];
  float fr = pr0 * (float)cd - pi0 * (float)sd;
  float fi = pr0 * (float)sd + pi0 * (float)cd;
  sincos(omega * CYC, &sd, &cd);
  const float sr = (float)cd, si = (float)sd;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int i = i0 + k;
    const float ur = yr_s[(p * NSYM + i) * CT + tx];
    const float ui = yi_s[(p * NSYM + i) * CT + tx];
    const float outr = ur * fr - ui * fi;
    const float outi = ur * fi + ui * fr;
    if (f + 1 < F) {
      const long long o = ((long long)(f + 1) * NSYM + i) * C + c;
      zr[o] = outr;
      zi[o] = outi;
    } else {
      ndd_re[(long long)c * NSYM + i] = outr;
      ndd_im[(long long)c * NSYM + i] = outi;
    }
    if (f == 0) {
      zr[(long long)i * C + c] = dd_re[(long long)c * NSYM + i];
      zi[(long long)i * C + c] = dd_im[(long long)c * NSYM + i];
    }
    const float nr = fr * sr - fi * si;
    fi = fr * si + fi * sr;
    fr = nr;
  }
}

}  // namespace

extern "C" int qpsk_frontend_tm(const void* pcm, const void* tail_raw,
                                const void* p0_re, const void* p0_im,
                                const void* dd_re, const void* dd_im,
                                void* zr, void* zi, void* index,
                                void* ndd_re, void* ndd_im, int C, int F,
                                const void* taps_re, const void* taps_im,
                                double omega, float gain, float inv_scale,
                                void* stream) {
  Taps taps;
  for (int k = 0; k < NTAPS; ++k) {
    taps.re[k] = static_cast<const float*>(taps_re)[k];
    taps.im[k] = static_cast<const float*>(taps_im)[k];
  }
  cudaError_t err = cudaFuncSetAttribute(
      frontend_tm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + CT - 1) / CT, F);
  dim3 block(CT, NTY);
  frontend_tm_kernel<<<grid, block, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const float*)tail_raw, (const float*)p0_re,
      (const float*)p0_im, (const float*)dd_re, (const float*)dd_im,
      (float*)zr, (float*)zi, (int32_t*)index, (float*)ndd_re,
      (float*)ndd_im, C, F, taps, omega, gain, inv_scale);
  return (int)cudaGetLastError();
}
