// RX front-end kernel for Hopper (sm_90a), in two launch modes.
//
// Replaces: qpsk_tpu/ops/pallas/frontend_kernel.py, _kernel launched by
//   * _frontend_2d_tm (entry rx_frontend_fused_tm): the time-major launch
//     with the in-kernel one-frame delay and, on request, the per-frame
//     AGC power of the emitted picks (emit_power); 4 samples per symbol;
//   * _frontend_2d (entry rx_frontend_fused): the channel-major launch
//     without the delay, at 4 or 8 samples per symbol (2400 and 1200 baud).
//     The TPU groups 128 // nsym frames per block to fill its 128 lanes;
//     here a block is one frame whatever nsym is, so any frame count works.
//
// What it computes, per channel and 512-sample frame f of one call, with
// CYC samples per symbol and NSYM = 512 / CYC symbols per frame:
//   x = int16 PCM * (1/pcm_scale), preceded by the 126-sample raw halo
//       (the previous frame's last samples, or the carried raw tail);
//   y[s] = gain * sum_k hm[k] * x[s + k], k = 0..126, with the complex
//       carrier-MODULATED RRC taps hm (the NCO mix folded into the filter);
//   e[p] = sum_i |y[CYC*i + p]|^2, p < CYC; index = first argmax of e;
//   pick[i] = y[CYC*i + index] * phase0 * e^{j*omega*(pos+1)},
//       pos = f*512 + CYC*i + index, with the angle of each thread's first
//       pick reduced mod 2*pi in float64.
// Time-major mode: the one-frame decimation delay.  Frame f's picks go to
//   rows (f+1)*NSYM .. of the (T, C) output, frame 0's rows are the carried
//   decim_delay and the last frame's picks are the new decim_delay.  With a
//   power output, power[c, f] is the mean |pick|^2 of output frame f: the
//   squares |re|^2 + |im|^2 of the stored picks, summed by halves pairing
//   (p[i] += p[i + h] for h = NSYM/2, .., 1), times 1/NSYM, every step a
//   round-to-nearest intrinsic: the bits of ops/agc.py::_frame_power.
// Channel-major mode: picks (C, F, NSYM) and index (C, F), no delay.
//
// What bounds it on the H100: arithmetic.  Each output sample costs 254
// float32 FMAs (127 complex taps on a real input), 130 k FMAs per frame and
// channel, against 2 bytes of PCM read and 2 (CYC 4) or 1 (CYC 8) bytes of
// picks written per sample: far above the card's float32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte).  So the design keeps the FMAs
// fed from registers: the taps are a by-value kernel parameter with
// compile-time indices (constant-bank operands of the FMAs, no loads), the
// frame window sits in shared memory, and each thread computes all CYC
// phases of one symbol at a time, so every window value it loads feeds up
// to 2*CYC FMAs.  The outputs go to shared memory, not registers (holding a
// thread's outputs for the pick spilled), and the pick stage reads back the
// selected phase: one block of 216 KB (CYC 4) or 224 KB (CYC 8) per SM.
// No tensor cores: the float32 reference is held to 3e-4, so TF32/bf16
// and the TPU's bf16 pass are out.
//
// Layout: one block per (32 channels, frame), 32 x 16 threads, each thread
// row SPT = 32 / CYC symbols.  threadIdx.x is the channel, so the (T, C)
// stores of a warp are 128 contiguous bytes and the output planes in shared
// memory are read and written without bank conflicts; the window row stride
// is odd (639 floats), so the 32 channels of a warp read 32 different
// banks.  A channel-major thread stores its SPT consecutive picks as
// 16-byte vectors.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTAPS = 127;
constexpr int HALO = NTAPS - 1;          // raw samples carried from before
constexpr int FSZ = 512;                 // samples per frame
constexpr int CT = 32;                   // channels per block
constexpr int NTY = 16;                  // thread rows per block
constexpr int WIN = HALO + FSZ;          // window samples per channel
constexpr int STRIDE = WIN + 1;          // odd: conflict-free columns

struct Taps {
  float re[NTAPS];
  float im[NTAPS];
};

// window [CT][STRIDE], outputs [2][CYC][NSYM][CT], energies [NTY][CYC][CT]
template <int CYC>
constexpr size_t smem_bytes() {
  return (size_t)(CT * STRIDE + 2 * FSZ * CT + NTY * CYC * CT) * sizeof(float);
}

__device__ __forceinline__ float sq(float r, float i) {
  return __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i));
}

template <int CYC, bool TM>
__global__ void __launch_bounds__(CT * NTY)
frontend_kernel(const int16_t* __restrict__ pcm,
                const float* __restrict__ tail_raw,
                const float* __restrict__ p0_re,
                const float* __restrict__ p0_im,
                const float* __restrict__ dd_re,
                const float* __restrict__ dd_im,
                float* __restrict__ zr, float* __restrict__ zi,
                int32_t* __restrict__ index,
                float* __restrict__ ndd_re, float* __restrict__ ndd_im,
                float* __restrict__ power,
                int C, int F, const Taps taps, double omega, float gain,
                float inv_scale) {
  constexpr int NSYM = FSZ / CYC;        // symbols per frame
  constexpr int SPT = NSYM / NTY;        // symbols per thread
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

  // the filter at all CYC phases of symbols ty*SPT .. ty*SPT+SPT-1, one
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
      e[p] = __fadd_rn(e[p], sq(yr, yi));
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

  // picks of the selected phase, rotated by phase0 * e^{j*omega*(pos+1)}:
  // the first pick's angle in float64, then steps of e^{j*omega*CYC}.  The
  // window is no longer read: its space holds the squares of the power tree.
  const int c = c0 + tx;
  const bool live = c < C;
  const int p = sel[tx];
  const int i0 = ty * SPT;
  const double two_pi = 6.283185307179586476925286766559;
  double ang = omega * (double)((long long)f * FSZ + i0 * CYC + p + 1);
  ang -= two_pi * floor(ang * (1.0 / two_pi));
  double sd, cd;
  sincos(ang, &sd, &cd);
  const float pr0 = live ? p0_re[c] : 1.f, pi0 = live ? p0_im[c] : 0.f;
  float fr = pr0 * (float)cd - pi0 * (float)sd;
  float fi = pr0 * (float)sd + pi0 * (float)cd;
  sincos(omega * CYC, &sd, &cd);
  const float sr = (float)cd, si = (float)sd;
  float* sq_new = x;                  // [NSYM][CT] squares of this frame's picks
  float* sq_dd = x + NSYM * CT;       // [NSYM][CT] squares of the carried picks
  float out_r[SPT], out_i[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int i = i0 + k;
    const float ur = yr_s[(p * NSYM + i) * CT + tx];
    const float ui = yi_s[(p * NSYM + i) * CT + tx];
    out_r[k] = ur * fr - ui * fi;
    out_i[k] = ur * fi + ui * fr;
    const float nr = fr * sr - fi * si;
    fi = fr * si + fi * sr;
    fr = nr;
    if (TM) {
      if (live) {
        if (f + 1 < F) {
          const long long o = ((long long)(f + 1) * NSYM + i) * C + c;
          zr[o] = out_r[k];
          zi[o] = out_i[k];
        } else {
          ndd_re[(long long)c * NSYM + i] = out_r[k];
          ndd_im[(long long)c * NSYM + i] = out_i[k];
        }
      }
      if (power) sq_new[i * CT + tx] = sq(out_r[k], out_i[k]);
      if (f == 0) {
        const float dr = live ? dd_re[(long long)c * NSYM + i] : 0.f;
        const float di = live ? dd_im[(long long)c * NSYM + i] : 0.f;
        if (live) {
          zr[(long long)i * C + c] = dr;
          zi[(long long)i * C + c] = di;
        }
        if (power) sq_dd[i * CT + tx] = sq(dr, di);
      }
    }
  }
  if (!TM) {
    if (live) {
      const long long o = ((long long)c * F + f) * NSYM + i0;
#pragma unroll
      for (int k = 0; k < SPT; k += 4) {
        *reinterpret_cast<float4*>(zr + o + k) =
            make_float4(out_r[k], out_r[k + 1], out_r[k + 2], out_r[k + 3]);
        *reinterpret_cast<float4*>(zi + o + k) =
            make_float4(out_i[k], out_i[k + 1], out_i[k + 2], out_i[k + 3]);
      }
    }
    return;
  }
  if (power == nullptr) return;       // uniform over the grid

  // the power tree: halves pairing over the symbol axis, one level per
  // barrier; row ty adds pairs ty, ty + NTY, .. of each level
  __syncthreads();
#pragma unroll 1
  for (int h = NSYM / 2; h >= 1; h >>= 1) {
    for (int i = ty; i < h; i += NTY) {
      sq_new[i * CT + tx] = __fadd_rn(sq_new[i * CT + tx], sq_new[(i + h) * CT + tx]);
      if (f == 0) sq_dd[i * CT + tx] = __fadd_rn(sq_dd[i * CT + tx], sq_dd[(i + h) * CT + tx]);
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    const float inv = 1.f / (float)NSYM;          // a power of two: exact
    if (f + 1 < F) power[(long long)c * F + f + 1] = __fmul_rn(sq_new[tx], inv);
    if (f == 0) power[(long long)c * F] = __fmul_rn(sq_dd[tx], inv);
  }
}

template <int CYC, bool TM>
int launch(const void* pcm, const void* tail_raw, const void* p0_re,
           const void* p0_im, const void* dd_re, const void* dd_im, void* zr,
           void* zi, void* index, void* ndd_re, void* ndd_im, void* power,
           int C, int F, const void* taps_re, const void* taps_im,
           double omega, float gain, float inv_scale, void* stream) {
  Taps taps;
  for (int k = 0; k < NTAPS; ++k) {
    taps.re[k] = static_cast<const float*>(taps_re)[k];
    taps.im[k] = static_cast<const float*>(taps_im)[k];
  }
  auto kernel = frontend_kernel<CYC, TM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<CYC>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + CT - 1) / CT, F);
  dim3 block(CT, NTY);
  kernel<<<grid, block, smem_bytes<CYC>(), (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const float*)tail_raw, (const float*)p0_re,
      (const float*)p0_im, (const float*)dd_re, (const float*)dd_im,
      (float*)zr, (float*)zi, (int32_t*)index, (float*)ndd_re,
      (float*)ndd_im, (float*)power, C, F, taps, omega, gain, inv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Time-major launch, 4 samples per symbol; ``power`` may be null.
extern "C" int qpsk_frontend_tm(const void* pcm, const void* tail_raw,
                                const void* p0_re, const void* p0_im,
                                const void* dd_re, const void* dd_im,
                                void* zr, void* zi, void* index,
                                void* ndd_re, void* ndd_im, void* power,
                                int C, int F, const void* taps_re,
                                const void* taps_im, double omega, float gain,
                                float inv_scale, void* stream) {
  return launch<4, true>(pcm, tail_raw, p0_re, p0_im, dd_re, dd_im, zr, zi,
                         index, ndd_re, ndd_im, power, C, F, taps_re, taps_im,
                         omega, gain, inv_scale, stream);
}

// Channel-major launch at ``cycles`` = 4 or 8 samples per symbol.
extern "C" int qpsk_frontend_cm(const void* pcm, const void* tail_raw,
                                const void* p0_re, const void* p0_im,
                                void* picks_re, void* picks_im, void* index,
                                int C, int F, int cycles, const void* taps_re,
                                const void* taps_im, double omega, float gain,
                                float inv_scale, void* stream) {
  if (cycles == 4)
    return launch<4, false>(pcm, tail_raw, p0_re, p0_im, nullptr, nullptr,
                            picks_re, picks_im, index, nullptr, nullptr,
                            nullptr, C, F, taps_re, taps_im, omega, gain,
                            inv_scale, stream);
  if (cycles == 8)
    return launch<8, false>(pcm, tail_raw, p0_re, p0_im, nullptr, nullptr,
                            picks_re, picks_im, index, nullptr, nullptr,
                            nullptr, C, F, taps_re, taps_im, omega, gain,
                            inv_scale, stream);
  return (int)cudaErrorInvalidValue;
}
