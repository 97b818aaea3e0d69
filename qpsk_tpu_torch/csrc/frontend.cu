// RX front-end kernel for Hopper (sm_90a), in two launch modes.
//
// Replaces: qpsk_tpu/ops/pallas/frontend_kernel.py, _kernel launched by
//   * _frontend_2d_tm (entry rx_frontend_fused_tm): the time-major launch
//     with the in-kernel one-frame delay and, on request, the per-frame
//     AGC power of the emitted picks (emit_power); 4 samples per symbol;
//   * _frontend_2d (entry rx_frontend_fused): the channel-major launch
//     without the delay, at 4 or 8 samples per symbol (2400 and 1200 baud).
//
// What it computes, per channel and 512-sample frame f of one call, with
// CYC samples per symbol and NSYM = 512 / CYC symbols per frame:
//   halo: frame 0's is the carried mixed-domain tail un-mixed,
//       raw[k] = Re(tail[k] * conj(phase0 * e^{j*omega*(k-125)})) (the
//       ops/frontend.py unmix_tail); frame f's the raw samples ending f-1;
//   x = int16 PCM * (1/pcm_scale), preceded by the 126-sample halo;
//   y[s] = gain * sum_k hm[k] * x[s + k], k = 0..126, with the complex
//       carrier-MODULATED RRC taps hm (the NCO mix folded into the filter);
//   e[p] = sum_i |y[CYC*i + p]|^2, p < CYC; index = first argmax of e;
//   pick[i] = y[CYC*i + index] * phase0 * e^{j*omega*(pos+1)},
//       pos = f*512 + CYC*i + index, with the angle of each thread's first
//       pick reduced mod 2*pi in float64;
//   and, after the last frame, the carried state: the new mixed-domain
//   tail, raw[n-126+k] * phase0 * e^{j*omega*(n-126+k+1)} (remix_tail), and
//   the new phase, normalize(phase0 * e^{j*omega*n}) (advance_phase), every
//   angle reduced mod 2*pi in float64, n the call's samples.  So a call is
//   one launch and no host-to-device copy.
// Time-major mode: the one-frame decimation delay.  Frame f's picks go to
//   rows (f+1)*NSYM .. of the (T, C) output, frame 0's rows are the carried
//   decim_delay and the last frame's picks are the new decim_delay.  With a
//   power output, power[c, f] is the mean |pick|^2 of output frame f: the
//   squares |re|^2 + |im|^2 of the stored picks, summed by halves pairing
//   (p[i] += p[i + h] for h = NSYM/2, .., 1), times 1/NSYM, every step a
//   round-to-nearest intrinsic: the bits of ops/agc.py::_frame_power.
// Channel-major mode: picks (C, F, NSYM) and index (C, F), no delay.
//
// What bounds it on the H100: arithmetic.  Each output sample costs 127
// complex taps on a real input, 130 k multiply-adds per frame and channel,
// against 2 bytes of PCM read and 2 (CYC 4) or 1 (CYC 8) bytes of picks
// written per sample.  On the CUDA cores that is 0.26 ms at 8192 x 8
// frames; so the FIR runs on the tensor cores as a Toeplitz product:
//   D[m, n] = sum_j A[m, j] B[j, n],  A[m, j] = x_m[s0 + j],
//   B[j, n] = hm[j - n] (0 <= j - n <= 126), n < 32 outputs a row block,
// with mma.sync m16n8k16 in float16 with float32 sums.  The A rows are 8
// channels at s0 and the same 8 channels at s0 + 256, read in place from
// the staged window as half pairs (rows overlap by 126 samples).  B depends
// on the tile only through the offset D = 16*k-tile - 8*n-tile (-8..128, the
// band), so a warp keeps the 18 fragments of its plane (re or im) in
// registers, and only band tiles are multiplied.  Precision: three passes.
// An int16 over a power of two has at most 16 significant bits, so
// x = x_hi + x_lo exactly in two float16 (2^-22 relative for the float
// halo of frame 0); the taps are h_hi + h_lo; each tile is x_lo*h_hi +
// x_hi*h_lo + x_hi*h_hi, the x_lo*h_lo term (2^-22 relative) dropped: the
// picks stay within the 3e-4 the float32 chain is held to.  (Three TF32
// passes of m16n8k8, the first design, took twice the instructions and
// measured 0.12 ms a pass at 8192 x 8; the rest of the kernel, 0.11 ms
// channel-major and 0.18 ms time-major.)
//
// Layout and overlap: one block of 4 warps per (8 channels, up to FPB
// consecutive frames); frames ride grid.x, so any frame count works.  The
// PCM of the next frame arrives by cp.async into a second stage buffer
// while the current frame's FIR runs; the window of a frame (126 halo +
// 512 samples, as float16 hi and lo planes) sits in shared memory with a
// row of 324 words (4 mod 32), so the 32 lanes' A loads hit 32 banks.
// Warps 0/1 compute the re / im plane of row blocks 0-3, warps 2/3 of row
// blocks 4-7; the outputs go to shared memory [plane][phase][symbol]
// [channel] with per-lane phase energies, then all 128 threads rotate and
// store the picks, 16 threads a channel; a thread holds the symbols
// i = part + 16m, so the power tree's first levels stay in its registers
// and its last four are warp shuffles; every thread of a channel sums the
// phase energies itself, so no thread waits on a serial argmax.  Two
// blocks share an SM (73 KB of shared memory each), so one block's picks
// run beside another's FIR.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTAPS = 127;
constexpr int HALO = NTAPS - 1;          // raw samples carried from before
constexpr int FSZ = 512;                 // samples per frame
constexpr int CG = 8;                    // channels a block
constexpr int NWARP = 4;
constexpr int NTHR = 32 * NWARP;
constexpr int STRIDE = 648;              // window row in halves: >= 640,
                                         // 324 words = 4 mod 32
constexpr int ND = 18;                   // B fragments: 16*kt - 8*nt = -8..128
constexpr int NKT = 10;                  // 16-wide k-tiles of a row block
constexpr int FPB = 4;                   // frames a block
constexpr double TWO_PI = 6.283185307179586476925286766559;

struct Taps {
  float re[NTAPS];
  float im[NTAPS];
};

struct Smem {
  int16_t stage[2][CG][FSZ];             // the next frames' PCM
  int16_t halo16[CG][128];               // the samples ending frame f0-1
  __half xh[CG][STRIDE];                 // halo + frame, then zeros, as
  __half xl[CG][STRIDE];                 // x = hi + lo
  float y[2][FSZ][CG];                   // [plane][p*NSYM + i][channel]
  float epart[NWARP][4][CG][2];          // [warp][t][channel][2t+b]
  float ph[2][HALO];                     // e^{j*omega*(k-125)}, frame 0
};

__device__ __forceinline__ float sq(float r, float i) {
  return __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i));
}

// v = hi + lo in float16, both rounded to nearest: exact for an int16
// over a power of two (at most 16 significant bits), 2^-22 relative else
__device__ __forceinline__ void split(float v, __half& hi, __half& lo) {
  hi = __float2half_rn(v);
  lo = __float2half_rn(__fsub_rn(v, __half2float(hi)));
}

// two halves as the .f16x2 register of an mma fragment, ``a`` low
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

// 16 bytes global -> shared; zero-filled when ``live`` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// e^{j*ang} of a float64 angle reduced to [0, 2*pi), as float32 parts
__device__ __forceinline__ void phasor(double ang, float& re, float& im) {
  ang -= TWO_PI * floor(ang * (1.0 / TWO_PI));
  double s, c;
  sincos(ang, &s, &c);
  re = (float)c;
  im = (float)s;
}

// (pr, pi) = phase0 (x) (er, ei), the ops/frontend.py _tail_phasors order
__device__ __forceinline__ void cmul_pinned(float ar, float ai, float er,
                                            float ei, float& pr, float& pi) {
  pr = __fsub_rn(__fmul_rn(ar, er), __fmul_rn(ai, ei));
  pi = __fadd_rn(__fmul_rn(ar, ei), __fmul_rn(ai, er));
}

// Stage frame f of the block's channels (1 KB each) into ``dst``.
__device__ __forceinline__ void stage_frame(int16_t (*dst)[FSZ],
                                            const int16_t* pcm, int c0, int C,
                                            int F, int f, int tid) {
#pragma unroll
  for (int e = tid; e < CG * FSZ / 8; e += NTHR) {
    const int ch = e / (FSZ / 8), q = e % (FSZ / 8);
    const int c = c0 + ch;
    const int16_t* src = pcm + ((long long)min(c, C - 1) * F + f) * FSZ + 8 * q;
    cp_async16(&dst[ch][8 * q], src, c < C);
  }
}

template <int CYC, bool TM>
__global__ void __launch_bounds__(NTHR, 2)
frontend_kernel(const int16_t* __restrict__ pcm,
                const float* __restrict__ tail_re,
                const float* __restrict__ tail_im,
                const float* __restrict__ p0_re,
                const float* __restrict__ p0_im,
                const float* __restrict__ dd_re,
                const float* __restrict__ dd_im,
                float* __restrict__ zr, float* __restrict__ zi,
                int32_t* __restrict__ index,
                float* __restrict__ ndd_re, float* __restrict__ ndd_im,
                float* __restrict__ power,
                float* __restrict__ nph_re, float* __restrict__ nph_im,
                float* __restrict__ ntail_re, float* __restrict__ ntail_im,
                int C, int F, int nchunks, const __grid_constant__ Taps taps,
                double omega, float gain, float inv_scale) {
  constexpr int NSYM = FSZ / CYC;        // symbols per frame
  constexpr int SPT = NSYM / 16;         // picks a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = (blockIdx.x / nchunks) * CG;
  const int f0 = (blockIdx.x % nchunks) * FPB;
  const int f1 = min(F, f0 + FPB);
  const long long n = (long long)F * FSZ;
  const int g = lane >> 2, t = lane & 3;
  const int plane = warp & 1;

  // the prologue's copies: the frame before the chunk (its last 128
  // samples) and the chunk's first frame
  if (f0 > 0) {
    const int ch = tid / 16, q = tid % 16;
    const int c = c0 + ch;
    cp_async16(&sm.halo16[ch][8 * q],
               pcm + ((long long)min(c, C - 1) * F + f0 - 1) * FSZ + 384 + 8 * q,
               c < C);
  }
  stage_frame(sm.stage[0], pcm, c0, C, F, f0, tid);
  cp_async_commit();

  // this warp's plane of the B fragments, D = 8*(d - 1): b0 holds
  // h[D + 2t - g .. +1], b1 h[D + 2t + 8 - g .. +1], split into hi + lo
  const float* h = plane ? taps.im : taps.re;
  uint32_t bh[ND][2], bl[ND][2];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __half hi[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * (d - 1) + 2 * t + 8 * r + e - g;
        split((k >= 0 && k < NTAPS) ? h[k] : 0.f, hi[e], lo[e]);
      }
      bh[d][r] = pack(hi[0], hi[1]);
      bl[d][r] = pack(lo[0], lo[1]);
    }
  }
  if (f0 == 0) {
    for (int k = tid; k < HALO; k += NTHR)
      phasor(omega * (double)(k - (HALO - 1)), sm.ph[0][k], sm.ph[1][k]);
  }
  float sr, si;                          // the pick phasor's step, 16 symbols
  phasor(omega * (16.0 * CYC), sr, si);
  // zeros past the window: the band's last k-tile reads two of them
  for (int e = tid; e < CG * (STRIDE - HALO - FSZ); e += NTHR) {
    const int w = STRIDE - HALO - FSZ;
    sm.xh[e / w][HALO + FSZ + e % w] = __float2half_rn(0.f);
    sm.xl[e / w][HALO + FSZ + e % w] = __float2half_rn(0.f);
  }

  for (int f = f0; f < f1; ++f) {
    const int buf = (f - f0) & 1;
    // the halo of frame f: carried (un-mixed), staged, or the end of f-1
    __half keep_h[(CG * HALO + NTHR - 1) / NTHR];
    __half keep_l[(CG * HALO + NTHR - 1) / NTHR];
    if (f > f0) {
#pragma unroll
      for (int j = 0; j < (CG * HALO + NTHR - 1) / NTHR; ++j) {
        const int e = tid + j * NTHR;
        if (e < CG * HALO) {
          keep_h[j] = sm.xh[e / HALO][FSZ + e % HALO];
          keep_l[j] = sm.xl[e / HALO][FSZ + e % HALO];
        }
      }
    }
    if (f + 1 < f1) {
      stage_frame(sm.stage[buf ^ 1], pcm, c0, C, F, f + 1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // (A) frame f staged; frame f-1 read out of the window, y
#pragma unroll
    for (int j = 0; j < (CG * HALO + NTHR - 1) / NTHR; ++j) {
      const int e = tid + j * NTHR;
      if (e >= CG * HALO) break;
      const int ch = e / HALO, k = e % HALO;
      const int c = c0 + ch;
      if (f > f0) {
        sm.xh[ch][k] = keep_h[j];
        sm.xl[ch][k] = keep_l[j];
        continue;
      }
      float v = 0.f;
      if (f0 > 0) {
        v = (float)sm.halo16[ch][128 - HALO + k] * inv_scale;
      } else if (c < C) {
        float pr, pi;
        cmul_pinned(p0_re[c], p0_im[c], sm.ph[0][k], sm.ph[1][k], pr, pi);
        v = __fadd_rn(__fmul_rn(tail_re[(long long)c * HALO + k], pr),
                      __fmul_rn(tail_im[(long long)c * HALO + k], pi));
      }
      split(v, sm.xh[ch][k], sm.xl[ch][k]);
    }
#pragma unroll 4
    for (int e = tid; e < CG * FSZ; e += NTHR) {
      const int ch = e / FSZ, s = e % FSZ;
      split((float)sm.stage[buf][ch][s] * inv_scale, sm.xh[ch][HALO + s],
            sm.xl[ch][HALO + s]);
    }
    __syncthreads();   // (B) the window of frame f

    // the FIR of this warp's plane over row blocks rb0 .. rb0+3: rows g and
    // g + 8 are channel g at s0 and at s0 + 256
    float e0 = 0.f, e1 = 0.f;            // energies of phases 2t, 2t+1
#pragma unroll 1
    for (int rb = 0; rb < 4; ++rb) {
      const int s0 = 32 * ((warp >> 1) * 4 + rb);
      const __half* xh = &sm.xh[g][s0 + 2 * t];
      const __half* xl = &sm.xl[g][s0 + 2 * t];
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        // A: rows g (s0) and g + 8 (s0 + 256), columns 16kt + 2t, +1 and
        // 16kt + 2t + 8, +1, read in place as half pairs
        const uint32_t ah[4] = {ld32(xh + 16 * kt), ld32(xh + 256 + 16 * kt),
                                ld32(xh + 16 * kt + 8),
                                ld32(xh + 256 + 16 * kt + 8)};
        const uint32_t al[4] = {ld32(xl + 16 * kt), ld32(xl + 256 + 16 * kt),
                                ld32(xl + 16 * kt + 8),
                                ld32(xl + 256 + 16 * kt + 8)};
        // the three passes in turn over the n-tiles, so that consecutive
        // products accumulate into different tiles; tile (kt, nt) meets
        // the band at fragment d = 2kt - nt + 1
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (2 * kt - nt + 1 >= 0 && 2 * kt - nt + 1 < ND)
            mma_f16(acc[nt], al, bh[2 * kt - nt + 1][0], bh[2 * kt - nt + 1][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (2 * kt - nt + 1 >= 0 && 2 * kt - nt + 1 < ND)
            mma_f16(acc[nt], ah, bl[2 * kt - nt + 1][0], bl[2 * kt - nt + 1][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (2 * kt - nt + 1 >= 0 && 2 * kt - nt + 1 < ND)
            mma_f16(acc[nt], ah, bh[2 * kt - nt + 1][0], bh[2 * kt - nt + 1][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int s = s0 + 8 * nt + 2 * t + (r & 1) + (r >> 1) * 256;
          const float v = acc[nt][r] * gain;
          sm.y[plane][(s % CYC) * NSYM + s / CYC][g] = v;
          if (r & 1) e1 += v * v; else e0 += v * v;
        }
      }
    }
    sm.epart[warp][t][g][0] = e0;
    sm.epart[warp][t][g][1] = e1;
    __syncthreads();   // (C) outputs and energies of frame f

    // picks: 16 threads a channel, thread ``part`` holds i = part + 16m
    const int ch = warp * 2 + (lane >> 4), part = lane & 15;
    const int c = c0 + ch;
    const bool live = c < C;
    // the phase: every thread of the channel sums the partial energies in
    // the same order, so all 16 pick the same; the first maximum wins
    int p = 0;
    {
      float best_e = 0.f;
#pragma unroll
      for (int pp = 0; pp < CYC; ++pp) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w)
#pragma unroll
          for (int tt = 0; tt < 4; ++tt)
#pragma unroll
            for (int bb = 0; bb < 2; ++bb)
              if ((2 * tt + bb) % CYC == pp) sum += sm.epart[w][tt][ch][bb];
        if (pp == 0 || sum > best_e) {
          best_e = sum;
          p = pp;
        }
      }
    }
    if (part == 0 && live) index[(long long)c * F + f] = p;
    const float pr0 = live ? p0_re[c] : 1.f, pi0 = live ? p0_im[c] : 0.f;
    float er, ei;
    phasor(omega * (double)((long long)f * FSZ + part * CYC + p + 1), er, ei);
    float fr = pr0 * er - pi0 * ei;
    float fi = pr0 * ei + pi0 * er;
    float pw[SPT], pd[SPT];
#pragma unroll
    for (int m = 0; m < SPT; ++m) {
      const int i = part + 16 * m;
      const float ur = sm.y[0][p * NSYM + i][ch];
      const float ui = sm.y[1][p * NSYM + i][ch];
      const float outr = ur * fr - ui * fi;
      const float outi = ur * fi + ui * fr;
      const float nr = fr * sr - fi * si;
      fi = fr * si + fi * sr;
      fr = nr;
      if (TM) {
        if (live) {
          if (f + 1 < F) {
            const long long o = ((long long)(f + 1) * NSYM + i) * C + c;
            zr[o] = outr;
            zi[o] = outi;
          } else {
            ndd_re[(long long)c * NSYM + i] = outr;
            ndd_im[(long long)c * NSYM + i] = outi;
          }
        }
        pw[m] = sq(outr, outi);
        if (f == 0) {
          const float dr = live ? dd_re[(long long)c * NSYM + i] : 0.f;
          const float di = live ? dd_im[(long long)c * NSYM + i] : 0.f;
          if (live) {
            zr[(long long)i * C + c] = dr;
            zi[(long long)i * C + c] = di;
          }
          pd[m] = sq(dr, di);
        }
      } else if (live) {
        const long long o = ((long long)c * F + f) * NSYM + i;
        zr[o] = outr;
        zi[o] = outi;
      }
    }
    if (TM && power != nullptr) {       // uniform over the grid
      // halves pairing: levels h = 16*hm in registers, then h = 8 .. 1
#pragma unroll
      for (int hm = SPT / 2; hm >= 1; hm >>= 1)
#pragma unroll
        for (int m = 0; m < hm; ++m) {
          pw[m] = __fadd_rn(pw[m], pw[m + hm]);
          if (f == 0) pd[m] = __fadd_rn(pd[m], pd[m + hm]);
        }
      float vw = pw[0], vd = f == 0 ? pd[0] : 0.f;
#pragma unroll
      for (int hh = 8; hh >= 1; hh >>= 1) {
        vw = __fadd_rn(vw, __shfl_down_sync(0xffffffffu, vw, hh, 16));
        vd = __fadd_rn(vd, __shfl_down_sync(0xffffffffu, vd, hh, 16));
      }
      if (part == 0 && live) {
        const float inv = 1.f / (float)NSYM;          // a power of two: exact
        if (f + 1 < F) power[(long long)c * F + f + 1] = __fmul_rn(vw, inv);
        if (f == 0) power[(long long)c * F] = __fmul_rn(vd, inv);
      }
    }
  }

  if (f1 != F) return;
  // the carried state after the call: the raw samples ending it re-mixed,
  // and the phase advanced by n samples
  for (int e = tid; e < CG * HALO; e += NTHR) {
    const int ch = e / HALO, k = e % HALO;
    const int c = c0 + ch;
    if (c >= C) continue;
    float er, ei, pr, pi;
    phasor(omega * (double)(n - HALO + k + 1), er, ei);
    cmul_pinned(p0_re[c], p0_im[c], er, ei, pr, pi);
    // hi + lo gives back the sample (the split is exact for int16 PCM
    // over a power-of-two scale)
    const float raw = __fadd_rn(__half2float(sm.xh[ch][FSZ + k]),
                                __half2float(sm.xl[ch][FSZ + k]));
    ntail_re[(long long)c * HALO + k] = __fmul_rn(raw, pr);
    ntail_im[(long long)c * HALO + k] = __fmul_rn(raw, pi);
  }
  if (tid < CG && c0 + tid < C) {
    const int c = c0 + tid;
    float er, ei, ar, ai;
    phasor(omega * (double)n, er, ei);
    cmul_pinned(p0_re[c], p0_im[c], er, ei, ar, ai);
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(sq(ar, ai)));
    nph_re[c] = __fmul_rn(ar, inv);
    nph_im[c] = __fmul_rn(ai, inv);
  }
}

template <int CYC, bool TM>
int launch(const void* pcm, const void* tail_re, const void* tail_im,
           const void* p0_re, const void* p0_im, const void* dd_re,
           const void* dd_im, void* zr, void* zi, void* index, void* ndd_re,
           void* ndd_im, void* power, void* nph_re, void* nph_im,
           void* ntail_re, void* ntail_im, int C, int F, const void* taps_re,
           const void* taps_im, double omega, float gain, float inv_scale,
           void* stream) {
  Taps taps;
  for (int k = 0; k < NTAPS; ++k) {
    taps.re[k] = static_cast<const float*>(taps_re)[k];
    taps.im[k] = static_cast<const float*>(taps_im)[k];
  }
  auto kernel = frontend_kernel<CYC, TM>;
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (F + FPB - 1) / FPB;
  const long long blocks = (long long)((C + CG - 1) / CG) * nchunks;
  if (C < 1 || F < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NTHR, bytes, (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const float*)tail_re, (const float*)tail_im,
      (const float*)p0_re, (const float*)p0_im, (const float*)dd_re,
      (const float*)dd_im, (float*)zr, (float*)zi, (int32_t*)index,
      (float*)ndd_re, (float*)ndd_im, (float*)power, (float*)nph_re,
      (float*)nph_im, (float*)ntail_re, (float*)ntail_im, C, F, nchunks, taps,
      omega, gain, inv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Time-major launch, 4 samples per symbol; ``power`` may be null.  Reads
// the carried mixed-domain tail (C, 126) and phase (C,), writes the new
// ones beside the picks.
extern "C" int qpsk_frontend_tm(const void* pcm, const void* tail_re,
                                const void* tail_im, const void* p0_re,
                                const void* p0_im, const void* dd_re,
                                const void* dd_im, void* zr, void* zi,
                                void* index, void* ndd_re, void* ndd_im,
                                void* power, void* nph_re, void* nph_im,
                                void* ntail_re, void* ntail_im, int C, int F,
                                const void* taps_re, const void* taps_im,
                                double omega, float gain, float inv_scale,
                                void* stream) {
  return launch<4, true>(pcm, tail_re, tail_im, p0_re, p0_im, dd_re, dd_im,
                         zr, zi, index, ndd_re, ndd_im, power, nph_re, nph_im,
                         ntail_re, ntail_im, C, F, taps_re, taps_im, omega,
                         gain, inv_scale, stream);
}

// Channel-major launch at ``cycles`` = 4 or 8 samples per symbol.
extern "C" int qpsk_frontend_cm(const void* pcm, const void* tail_re,
                                const void* tail_im, const void* p0_re,
                                const void* p0_im, void* picks_re,
                                void* picks_im, void* index, void* nph_re,
                                void* nph_im, void* ntail_re, void* ntail_im,
                                int C, int F, int cycles, const void* taps_re,
                                const void* taps_im, double omega, float gain,
                                float inv_scale, void* stream) {
  if (cycles == 4)
    return launch<4, false>(pcm, tail_re, tail_im, p0_re, p0_im, nullptr,
                            nullptr, picks_re, picks_im, index, nullptr,
                            nullptr, nullptr, nph_re, nph_im, ntail_re,
                            ntail_im, C, F, taps_re, taps_im, omega, gain,
                            inv_scale, stream);
  if (cycles == 8)
    return launch<8, false>(pcm, tail_re, tail_im, p0_re, p0_im, nullptr,
                            nullptr, picks_re, picks_im, index, nullptr,
                            nullptr, nullptr, nph_re, nph_im, ntail_re,
                            ntail_im, C, F, taps_re, taps_im, omega, gain,
                            inv_scale, stream);
  return (int)cudaErrorInvalidValue;
}
