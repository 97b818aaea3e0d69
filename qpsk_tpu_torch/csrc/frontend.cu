// RX front-end kernel for Hopper (sm_90a), in two launch modes.
//
// Replaces: qpsk_tpu/ops/pallas/frontend_kernel.py, _kernel launched by
//   * _frontend_2d_tm (entry rx_frontend_fused_tm): the time-major launch
//     with the in-kernel one-frame delay and, on request, the per-frame
//     AGC power of the emitted picks (emit_power);
//   * _frontend_2d (entry rx_frontend_fused): the channel-major launch
//     without the delay.
// Both at 2, 4 or 8 samples per symbol (CYC: 4800, 2400 and 1200 baud at
// 9600 S/s), any odd tap count up to 129 and any frame of FSZ samples, FSZ
// a multiple of 128, up to the shared-memory budget (the wrapper's
// _FAST_MAX_FRAME).  The rest of the TPU kernel's gate (other samples per
// symbol, longer frames, the power output at a symbol count that is not a
// power of two) runs frontend_general_kernel, at the end of this file.
//
// What it computes, per channel and FSZ-sample frame f of one call, with
// NSYM = FSZ / CYC symbols per frame and H = ntaps - 1 carried samples:
//   the taps: the complex carrier-MODULATED RRC taps hm (the NCO mix
//       folded into the filter), padded at the front with 129 - ntaps
//       zeros to KT = 129 taps; a zero tap adds an exact zero, so every
//       tap count runs through the same FIR;
//   halo: the HALO = 128 raw samples before the frame.  Frame 0's are the
//       carried mixed-domain tail un-mixed, raw[k] = Re(tail[k] *
//       conj(phase0 * e^{j*omega*(k-(H-1))})) (ops/frontend.py
//       unmix_tail), behind 128 - H zeros; frame f's the raw samples
//       ending f-1;
//   x = int16 PCM * (1/pcm_scale), preceded by the 128-sample halo;
//   y[s] = gain * sum_k hm[k] * x[s + k], k = 0..128;
//   e[p] = sum_i |y[CYC*i + p]|^2, p < CYC; index = first argmax of e;
//   pick[i] = y[CYC*i + index] * phase0 * e^{j*omega*(pos+1)},
//       pos = f*FSZ + CYC*i + index, with the angle of each thread's first
//       pick reduced mod 2*pi in float64;
//   and, after the last frame, the carried state: the new mixed-domain
//   tail, raw[n-H+k] * phase0 * e^{j*omega*(n-H+k+1)} (remix_tail), and
//   the new phase, normalize(phase0 * e^{j*omega*n}) (advance_phase), every
//   angle reduced mod 2*pi in float64, n the call's samples.  So a call is
//   one launch and no host-to-device copy.
// Time-major mode: the one-frame decimation delay.  Frame f's picks go to
//   rows (f+1)*NSYM .. of the (T, C) output, frame 0's rows are the carried
//   decim_delay and the last frame's picks are the new decim_delay.  With a
//   power output (NSYM a power of two), power[c, f] is the mean |pick|^2 of
//   output frame f: the squares |re|^2 + |im|^2 of the stored picks, summed
//   by halves pairing (p[i] += p[i + h] for h = NSYM/2, .., 1: in
//   registers and warp shuffles at the default frame size, in shared
//   memory at the others), times 1/NSYM, every step a round-to-nearest
//   intrinsic: the bits of ops/agc.py::_frame_power.
// Channel-major mode: picks (C, F, NSYM) and index (C, F), no delay.
//
// What bounds it on the H100: arithmetic.  Each output sample costs 127
// complex taps on a real input, 130 k multiply-adds per 512-sample frame
// and channel, against 2 bytes of PCM read and 2 (CYC 4) or 1 (CYC 8)
// bytes of picks written per sample.  On the CUDA cores that is 0.26 ms at
// 8192 x 8 frames; so the FIR runs on the tensor cores as a Toeplitz
// product:
//   D[m, n] = sum_j A[m, j] B[j, n],  A[m, j] = x_m[s0 + j],
//   B[j, n] = hm[j - n] (0 <= j - n <= 128), n < 32 outputs a row block,
// with mma.sync m16n8k16 in float16 with float32 sums.  The A rows are 8
// channels at s0 and the same 8 channels at s0 + FSZ/2, read in place from
// the staged window as half pairs (rows overlap by 128 samples).  B depends
// on the tile only through the offset D = 16*k-tile - 8*n-tile (-8..128,
// the band), so a warp keeps the 18 fragments of its plane (re or im) in
// registers, and only band tiles are multiplied.  Precision: three passes.
// An int16 over a power of two has at most 16 significant bits, so
// x = x_hi + x_lo exactly in two float16 (2^-22 relative for the float
// halo of frame 0); the taps are h_hi + h_lo, scaled by the wrapper by the
// power of two that puts the set's largest near 2^14, so every part rounds
// within 2^-22 of the largest tap; each tile is x_lo*h_hi +
// x_hi*h_lo + x_hi*h_hi, the x_lo*h_lo term (2^-22 relative) dropped: the
// picks stay within the 3e-4 the float32 chain is held to.  (Three TF32
// passes of m16n8k8, the first design, took twice the instructions and
// measured 0.12 ms a pass at 8192 x 8; the rest of the kernel, 0.11 ms
// channel-major and 0.18 ms time-major.)
//
// Layout and overlap: one block of 4 warps per (8 channels, up to FPB
// consecutive frames); frames ride grid.x, so any frame count works.  The
// PCM of the next frame arrives by cp.async into a second stage buffer
// while the current frame's FIR runs; the window of a frame (128 halo +
// FSZ samples, as float16 hi and lo planes) sits in shared memory with a
// row of FSZ/2 + 68 words (4 mod 32), so the 32 lanes' A loads hit 32
// banks.  Warps 0/1 compute the re / im plane of the first half of the
// row blocks of a half frame, warps 2/3 of the second half; the outputs go
// to shared memory [plane][phase][symbol][channel] with per-lane phase
// energies, then all 128 threads rotate and store the picks, 16 threads a
// channel (a thread holds the symbols i = part + 16m); every thread of a
// channel sums the phase energies itself, so no thread waits on a serial
// argmax.  Shared memory is laid out at launch for the frame size: at 512
// samples (74 KB) two blocks share an SM, so one block's picks run beside
// another's FIR.  The default 512-sample frame has instances of its own
// with the size at compile time; every other size runs the instances
// that read it from the launch.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KT = 129;                  // taps the kernel runs (padded)
constexpr int HALO = KT - 1;             // raw samples before a frame
constexpr int CG = 8;                    // channels a block
constexpr int NWARP = 4;
constexpr int NTHR = 32 * NWARP;
constexpr int ND = 18;                   // B fragments: 16*kt - 8*nt = -8..128
constexpr int NKT = 10;                  // 16-wide k-tiles of a row block
constexpr int FPB = 4;                   // frames a block
constexpr int KEEP = CG * HALO / NTHR;   // halo samples a thread carries
constexpr double TWO_PI = 6.283185307179586476925286766559;

struct Taps {
  float re[KT];
  float im[KT];
};

// The shared-memory layout of a frame of ``fsz`` samples, in bytes; every
// offset is a multiple of 16.
struct Layout {
  int stride;                            // window row in halves
  int stage, halo16, xh, xl, y, epart, ph, bytes;
  __host__ __device__ explicit Layout(int fsz) {
    stride = fsz + HALO + 8;             // fsz/2 + 68 words: 4 mod 32
    stage = 0;                           // int16 [2][CG][fsz]
    halo16 = stage + 2 * CG * fsz * 2;   // int16 [CG][128]
    xh = halo16 + CG * 128 * 2;          // half [CG][stride]
    xl = xh + CG * stride * 2;           // half [CG][stride]
    y = xl + CG * stride * 2;            // float [2][fsz][CG]
    epart = y + 2 * fsz * CG * 4;        // float [NWARP][4][CG][2]
    ph = epart + NWARP * 4 * CG * 2 * 4; // float [2][HALO]
    bytes = ph + 2 * HALO * 4;
  }
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

// This warp's plane (re or im taps ``h``, KT of them) of the B fragments,
// D = 8*(d - 1): b0 holds h[D + 2t - g .. +1], b1 h[D + 2t + 8 - g .. +1],
// split into hi + lo
__device__ __forceinline__ void band_fragments(uint32_t (&bh)[ND][2],
                                               uint32_t (&bl)[ND][2],
                                               const float* h, int g, int t) {
#pragma unroll
  for (int d = 0; d < ND; ++d) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __half hi[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * (d - 1) + 2 * t + 8 * r + e - g;
        split((k >= 0 && k < KT) ? h[k] : 0.f, hi[e], lo[e]);
      }
      bh[d][r] = pack(hi[0], hi[1]);
      bl[d][r] = pack(lo[0], lo[1]);
    }
  }
}

// The Toeplitz product of one row block: acc[nt] = the 4 n-tiles of 8
// outputs, rows g at ``ah_p``/``al_p`` (the window's hi / lo planes at
// s0 + 2t of row g) and g + 8 at ``half`` halves further, over the band
// of 16-wide k-tiles, each x_lo*h_hi + x_hi*h_lo + x_hi*h_hi.
__device__ __forceinline__ void band_rows(float (&acc)[4][4],
                                          const __half* ah_p,
                                          const __half* al_p, int half,
                                          const uint32_t (&bh)[ND][2],
                                          const uint32_t (&bl)[ND][2]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    // A: rows g (s0) and g + 8 (s0 + half), columns 16kt + 2t, +1 and
    // 16kt + 2t + 8, +1, read in place as half pairs
    const uint32_t ah[4] = {ld32(ah_p + 16 * kt), ld32(ah_p + half + 16 * kt),
                            ld32(ah_p + 16 * kt + 8),
                            ld32(ah_p + half + 16 * kt + 8)};
    const uint32_t al[4] = {ld32(al_p + 16 * kt), ld32(al_p + half + 16 * kt),
                            ld32(al_p + 16 * kt + 8),
                            ld32(al_p + half + 16 * kt + 8)};
    // the three passes in turn over the n-tiles, so that consecutive
    // products accumulate into different tiles; tile (kt, nt) meets the
    // band at fragment d = 2kt - nt + 1
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

// Stage frame f of the block's channels (2*fsz bytes each) into ``dst``.
__device__ __forceinline__ void stage_frame(int16_t* dst, const int16_t* pcm,
                                            int c0, int C, int F, int f,
                                            int fsz, int tid) {
  const int q8 = fsz / 8;                // 16-byte copies a channel
  for (int e = tid; e < CG * q8; e += NTHR) {
    const int ch = e / q8, q = e - ch * q8;
    const int c = c0 + ch;
    const int16_t* src =
        pcm + ((long long)min(c, C - 1) * F + f) * fsz + 8 * q;
    cp_async16(dst + ch * fsz + 8 * q, src, c < C);
  }
}

template <int CYC, bool TM, int FSZ>
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
                int C, int F, int fsz_arg, int H, int nchunks,
                const __grid_constant__ Taps taps, double omega, float gain,
                float inv_scale) {
  // FSZ > 0: the frame size at compile time (the default 512), so that
  // its loops unroll and its divisions fold; 0: the launch's
  const int fsz = FSZ > 0 ? FSZ : fsz_arg;
  const int nsym = fsz / CYC;            // symbols per frame
  const int spt = nsym / 16;             // picks a thread
  const Layout L(fsz);
  const int stride = L.stride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + L.stage);
  int16_t* halo16 = reinterpret_cast<int16_t*>(smem_raw + L.halo16);
  __half* xh = reinterpret_cast<__half*>(smem_raw + L.xh);
  __half* xl = reinterpret_cast<__half*>(smem_raw + L.xl);
  float* y = reinterpret_cast<float*>(smem_raw + L.y);
  float* epart = reinterpret_cast<float*>(smem_raw + L.epart);
  float* ph = reinterpret_cast<float*>(smem_raw + L.ph);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = (blockIdx.x / nchunks) * CG;
  const int f0 = (blockIdx.x % nchunks) * FPB;
  const int f1 = min(F, f0 + FPB);
  const long long n = (long long)F * fsz;
  const int g = lane >> 2, t = lane & 3;
  const int plane = warp & 1;

  // the prologue's copies: the frame before the chunk (its last 128
  // samples) and the chunk's first frame
  if (f0 > 0) {
    const int ch = tid / 16, q = tid % 16;
    const int c = c0 + ch;
    cp_async16(halo16 + ch * 128 + 8 * q,
               pcm + ((long long)min(c, C - 1) * F + f0 - 1) * fsz + fsz -
                   128 + 8 * q,
               c < C);
  }
  stage_frame(stage, pcm, c0, C, F, f0, fsz, tid);
  cp_async_commit();

  uint32_t bh[ND][2], bl[ND][2];
  band_fragments(bh, bl, plane ? taps.im : taps.re, g, t);
  if (f0 == 0) {
    for (int k = tid; k < H; k += NTHR)
      phasor(omega * (double)(k - (H - 1)), ph[k], ph[HALO + k]);
  }
  float sr, si;                          // the pick phasor's step, 16 symbols
  phasor(omega * (16.0 * CYC), sr, si);

  for (int f = f0; f < f1; ++f) {
    const int buf = (f - f0) & 1;
    // the halo of frame f: carried (un-mixed), staged, or the end of f-1
    __half keep_h[KEEP], keep_l[KEEP];
    if (f > f0) {
#pragma unroll
      for (int j = 0; j < KEEP; ++j) {
        const int e = tid + j * NTHR;
        keep_h[j] = xh[(e / HALO) * stride + fsz + e % HALO];
        keep_l[j] = xl[(e / HALO) * stride + fsz + e % HALO];
      }
    }
    if (f + 1 < f1) {
      stage_frame(stage + (buf ^ 1) * CG * fsz, pcm, c0, C, F, f + 1, fsz,
                  tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // (A) frame f staged; frame f-1 read out of the window, y
#pragma unroll
    for (int j = 0; j < KEEP; ++j) {
      const int e = tid + j * NTHR;
      const int ch = e / HALO, k = e % HALO;
      const int c = c0 + ch;
      if (f > f0) {
        xh[ch * stride + k] = keep_h[j];
        xl[ch * stride + k] = keep_l[j];
        continue;
      }
      float v = 0.f;
      if (f0 > 0) {
        v = (float)halo16[ch * 128 + k] * inv_scale;
      } else if (c < C && k >= HALO - H) {
        const int kk = k - (HALO - H);   // the carried tail's sample
        float pr, pi;
        cmul_pinned(p0_re[c], p0_im[c], ph[kk], ph[HALO + kk], pr, pi);
        v = __fadd_rn(__fmul_rn(tail_re[(long long)c * H + kk], pr),
                      __fmul_rn(tail_im[(long long)c * H + kk], pi));
      }
      split(v, xh[ch * stride + k], xl[ch * stride + k]);
    }
    const int16_t* st = stage + buf * CG * fsz;
    // one flat loop over the block's samples, four loads in flight a
    // thread (a loop a channel, four iterations each, cost the default
    // frame 3 %)
#pragma unroll 4
    for (int e = tid; e < CG * fsz; e += NTHR) {
      const int ch = e / fsz, s = e - ch * fsz;
      split((float)st[ch * fsz + s] * inv_scale,
            xh[ch * stride + HALO + s], xl[ch * stride + HALO + s]);
    }
    __syncthreads();   // (B) the window of frame f

    // the FIR of this warp's plane over its row blocks: rows g and g + 8
    // are channel g at s0 and at s0 + fsz/2
    float e0 = 0.f, e1 = 0.f;            // energies of phases 2t, 2t+1
    const int nrb = fsz / 128;           // row blocks a warp pair
    const int half = fsz / 2;
#pragma unroll 1
    for (int rb = 0; rb < nrb; ++rb) {
      const int s0 = 32 * ((warp >> 1) * nrb + rb);
      float acc[4][4];
      band_rows(acc, xh + g * stride + s0 + 2 * t, xl + g * stride + s0 + 2 * t,
                half, bh, bl);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int s = s0 + 8 * nt + 2 * t + (r & 1) + (r >> 1) * half;
          const float v = acc[nt][r] * gain;
          y[((plane * fsz) + (s % CYC) * nsym + s / CYC) * CG + g] = v;
          if (r & 1) e1 += v * v; else e0 += v * v;
        }
      }
    }
    epart[((warp * 4 + t) * CG + g) * 2] = e0;
    epart[((warp * 4 + t) * CG + g) * 2 + 1] = e1;
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
              if ((2 * tt + bb) % CYC == pp)
                sum += epart[((w * 4 + tt) * CG + ch) * 2 + bb];
        if (pp == 0 || sum > best_e) {
          best_e = sum;
          p = pp;
        }
      }
    }
    if (part == 0 && live) index[(long long)c * F + f] = p;
    const float pr0 = live ? p0_re[c] : 1.f, pi0 = live ? p0_im[c] : 0.f;
    float er, ei;
    phasor(omega * (double)((long long)f * fsz + part * CYC + p + 1), er, ei);
    float fr = pr0 * er - pi0 * ei;
    float fi = pr0 * ei + pi0 * er;
    // with a power output the squares stay in registers when the frame
    // size is known at compile time; else they go to y[.][i][ch], i <
    // nsym: this thread has read that slot already (p == 0) or no thread
    // reads it (p > 0 reads only slots >= nsym)
    const bool pow_out = TM && power != nullptr;   // uniform over the grid
    constexpr int SPT = FSZ > 0 ? FSZ / CYC / 16 : 1;   // picks a thread
    constexpr int UNR = FSZ > 0 ? SPT : 4;
    float pwr[SPT], pdr[SPT];
    float* pw = y + ch;                  // [i * CG]: squares of frame f
    float* pd = y + fsz * CG + ch;       // squares of the carried delay
#pragma unroll UNR
    for (int m = 0; m < spt; ++m) {
      const int i = part + 16 * m;
      const float ur = y[(p * nsym + i) * CG + ch];
      const float ui = y[(fsz + p * nsym + i) * CG + ch];
      const float outr = ur * fr - ui * fi;
      const float outi = ur * fi + ui * fr;
      const float nr = fr * sr - fi * si;
      fi = fr * si + fi * sr;
      fr = nr;
      if (TM) {
        if (live) {
          if (f + 1 < F) {
            const long long o = ((long long)(f + 1) * nsym + i) * C + c;
            zr[o] = outr;
            zi[o] = outi;
          } else {
            ndd_re[(long long)c * nsym + i] = outr;
            ndd_im[(long long)c * nsym + i] = outi;
          }
        }
        if (pow_out) {
          if constexpr (FSZ > 0) pwr[m] = sq(outr, outi);
          else pw[i * CG] = sq(outr, outi);
        }
        if (f == 0) {
          const float dr = live ? dd_re[(long long)c * nsym + i] : 0.f;
          const float di = live ? dd_im[(long long)c * nsym + i] : 0.f;
          if (live) {
            zr[(long long)i * C + c] = dr;
            zi[(long long)i * C + c] = di;
          }
          if (pow_out) {
            if constexpr (FSZ > 0) pdr[m] = sq(dr, di);
            else pd[i * CG] = sq(dr, di);
          }
        }
      } else if (live) {
        const long long o = ((long long)c * F + f) * nsym + i;
        zr[o] = outr;
        zi[o] = outi;
      }
    }
    if (pow_out) {
      // halves pairing over the channel's 16 threads (one half warp)
      float vw, vd = 0.f;
      if constexpr (FSZ > 0) {
        // levels h = 16*hm in registers, then h = 8 .. 1 by shuffles
#pragma unroll
        for (int hm = SPT / 2; hm >= 1; hm >>= 1)
#pragma unroll
          for (int m = 0; m < hm; ++m) {
            pwr[m] = __fadd_rn(pwr[m], pwr[m + hm]);
            if (f == 0) pdr[m] = __fadd_rn(pdr[m], pdr[m + hm]);
          }
        vw = pwr[0];
        if (f == 0) vd = pdr[0];
#pragma unroll
        for (int hh = 8; hh >= 1; hh >>= 1) {
          vw = __fadd_rn(vw, __shfl_down_sync(0xffffffffu, vw, hh, 16));
          vd = __fadd_rn(vd, __shfl_down_sync(0xffffffffu, vd, hh, 16));
        }
      } else {
        __syncwarp();
        for (int hh = nsym / 2; hh >= 1; hh >>= 1) {
          for (int i = part; i < hh; i += 16) {
            pw[i * CG] = __fadd_rn(pw[i * CG], pw[(i + hh) * CG]);
            if (f == 0) pd[i * CG] = __fadd_rn(pd[i * CG], pd[(i + hh) * CG]);
          }
          __syncwarp();
        }
        vw = pw[0];
        vd = pd[0];
      }
      if (part == 0 && live) {
        const float inv = 1.f / (float)nsym;          // a power of two: exact
        if (f + 1 < F) power[(long long)c * F + f + 1] = __fmul_rn(vw, inv);
        if (f == 0) power[(long long)c * F] = __fmul_rn(vd, inv);
      }
    }
  }

  if (f1 != F) return;
  // the carried state after the call: the raw samples ending it re-mixed,
  // and the phase advanced by n samples
  for (int e = tid; e < CG * H; e += NTHR) {
    const int ch = e / H, k = e % H;
    const int c = c0 + ch;
    if (c >= C) continue;
    float er, ei, pr, pi;
    phasor(omega * (double)(n - H + k + 1), er, ei);
    cmul_pinned(p0_re[c], p0_im[c], er, ei, pr, pi);
    // hi + lo gives back the sample (the split is exact for int16 PCM
    // over a power-of-two scale)
    const int w = ch * stride + HALO + fsz - H + k;
    const float raw = __fadd_rn(__half2float(xh[w]), __half2float(xl[w]));
    ntail_re[(long long)c * H + k] = __fmul_rn(raw, pr);
    ntail_im[(long long)c * H + k] = __fmul_rn(raw, pi);
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

template <int CYC, bool TM, int FSZ>
int launch(const void* pcm, const void* tail_re, const void* tail_im,
           const void* p0_re, const void* p0_im, const void* dd_re,
           const void* dd_im, void* zr, void* zi, void* index, void* ndd_re,
           void* ndd_im, void* power, void* nph_re, void* nph_im,
           void* ntail_re, void* ntail_im, int C, int F, int fsz, int ntaps,
           const void* taps_re, const void* taps_im, double omega, float gain,
           float inv_scale, void* stream) {
  // the taps behind KT - ntaps zeros
  Taps taps;
  for (int k = 0; k < KT; ++k) {
    const int j = k - (KT - ntaps);
    taps.re[k] = j >= 0 ? static_cast<const float*>(taps_re)[j] : 0.f;
    taps.im[k] = j >= 0 ? static_cast<const float*>(taps_im)[j] : 0.f;
  }
  auto kernel = frontend_kernel<CYC, TM, FSZ>;
  const int bytes = Layout(fsz).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (F + FPB - 1) / FPB;
  const long long blocks = (long long)((C + CG - 1) / CG) * nchunks;
  kernel<<<(unsigned)blocks, NTHR, bytes, (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const float*)tail_re, (const float*)tail_im,
      (const float*)p0_re, (const float*)p0_im, (const float*)dd_re,
      (const float*)dd_im, (float*)zr, (float*)zi, (int32_t*)index,
      (float*)ndd_re, (float*)ndd_im, (float*)power, (float*)nph_re,
      (float*)nph_im, (float*)ntail_re, (float*)ntail_im, C, F, fsz,
      ntaps - 1, nchunks, taps, omega, gain, inv_scale);
  return (int)cudaGetLastError();
}

// the geometry both launches take: 2, 4 or 8 samples per symbol, odd
// ntaps <= 129, frames of a multiple of 128 samples (with a power output,
// a power of two of symbols), at least one frame and channel
bool covered(int C, int F, int fsz, int cycles, int ntaps) {
  if (C < 1 || F < 1 || ntaps < 1 || ntaps > KT || ntaps % 2 == 0 ||
      fsz < 128 || fsz % 128 != 0 || Layout(fsz).bytes > 227 * 1024)
    return false;
  const long long blocks =
      (long long)((C + CG - 1) / CG) * ((F + FPB - 1) / FPB);
  return (cycles == 2 || cycles == 4 || cycles == 8) && blocks <= 0x7fffffffLL;
}

// ---------------------------------------------------------------------------
// The general instance, frontend_general_kernel<TM>: both launches (TM:
// the time-major one with the one-frame delay and the power output; else
// the channel-major one) at the geometries the instances above do not
// take and the TPU kernel's gate admits (qpsk_tpu/ops/pallas/
// frontend_kernel.py, frontend_supported): any samples per symbol CYC from
// 1 to 256 that divides the frame (3, 6 or 16 at a custom rs), any frame of
// a multiple of 128 samples with no cap (2048 samples at 2 samples per
// symbol, 4096 and more), any odd ntaps <= 129, and the AGC power output at
// any number of symbols a frame (384 at a 1536-sample frame): the halves
// pairing of ops/agc.py::_frame_power while the count is even, then its
// odd residue summed in order, then times float32(1/NSYM).  It computes
// what the instances above compute (their header has the formulas).
//
// What bounds it on the H100: as above, the FIR's arithmetic, 129 complex
// taps a sample.  The instance it replaced ran the FIR on the CUDA cores,
// one thread an output, and was bound by the shared-memory loads of that
// (three 4-byte loads for two multiply-adds a tap: 0.53 ms at 256 channels
// x 8 frames of 4096 samples, 39x its bound).  Here the FIR runs on the
// tensor cores as the instances above run it (band_fragments, band_rows:
// float16 hi + lo, three passes), over rows of 8 channels, and what ties
// those instances to their geometries is done at run time:
//   - the frame is streamed in chunks of GCH outputs: each chunk's window
//     (128-sample halo + chunk, float16 hi / lo planes) is staged from the
//     PCM by cp.async into a second buffer while the previous chunk's FIR
//     runs; the halo is the previous chunk's tail (frame 0's first chunk:
//     the carried tail un-mixed; another frame's: the end of frame f-1), so
//     no frame is too long;
//   - CYC is a launch argument: the outputs go to shared memory in sample
//     order, y[plane][channel][s], and a warp a channel sums the phase
//     energies from there: 32 / CYC lanes a phase below 32 samples per
//     symbol (each lane its own residue of that phase's outputs, in order,
//     then the lanes' partials in order), a lane a phase from 32 on; the
//     chunks in order; the first maximum wins;
//   - the picks: where the frame's outputs fit in shared memory beside the
//     window (GenLayout's bytes at most GRES_BYTES: frames up to about
//     2500 samples), they stay there and the picks are read from them, one
//     FIR pass (on the card the faster of the two wherever both fit); a
//     longer frame runs the chunks' FIR a second time and picks from each
//     chunk.  The second pass costs the FIR again but keeps the block's
//     shared memory the same at any frame length; writing the outputs to
//     device memory instead would cost 8 bytes a sample and a scratch of
//     that size a call.  A warp rotates its channel's picks as above (the
//     angle of a lane's first in float64 reduced mod 2*pi, then a float32
//     step of 32 symbols); the time-major ones go out through a shared
//     buffer of GPR symbols x 8 channels, so that a warp's stores are
//     32-byte rows of the (T, C) output, not 4 bytes C floats apart (frame
//     0's carried delay likewise);
//   - the power output: a warp runs its channel's pairing tree over the
//     squares of the stored picks, in shared memory up to GSQ symbols a
//     frame, beyond that in a device scratch row the wrapper passes.
// One block of GNT threads a (8 channels, frame); frames ride grid.x
// fastest, so a block's halo (the end of frame f-1) was just read by its
// neighbour.  The B fragments are built from a shared copy of the taps
// (from the by-value parameter, whose per-lane indices serialise the
// constant cache, they were the longest step of a block's prologue), and
// the launch bounds ask for two blocks an SM only where two fit.
// Times it was chosen by (fec_times.py --gen-modem, NVIDIA H100 80GB HBM3,
// 700.00 W, 256 channels x 8 frames alone in a CUDA graph, the instance
// it replaced in brackets): 4096-sample frames 0.1357 ms [0.5271], the
// power output at 1536 0.0460 [0.2030], channel-major at 3 samples per
// symbol and 384 0.0129 [0.0451]; 9-10x its bound at each.
constexpr int GNW = 8;                   // warps a block: one a channel
constexpr int GNT = 32 * GNW;
constexpr int GCH = 512;                 // outputs a chunk, at most
constexpr int GMAXCYC = 256;             // samples per symbol, at most
constexpr int GSQ = 512;                 // squares of a frame in shared, at most
constexpr int GKEEP = CG * HALO / GNT;   // halo samples a thread carries
constexpr int GRES_BYTES = 227 * 1024;   // shared memory of a resident frame
constexpr int GPR = 128;                 // symbols a round of picks
constexpr int PBS = GPR + 4;             // a channel's row of them: 4 mod 32

// The shared-memory layout of a frame of ``fsz`` samples, in bytes (every
// offset a multiple of 16): the frame's outputs resident, or a chunk's.
struct GenLayout {
  int stride, ys;                        // window row in halves, y row in floats
  int stage, halo16, xh, xl, y, esum, epart, sq, pb, ph, taps, rng, bytes;
  __host__ __device__ GenLayout(int fsz, int cyc, int nsym, bool resident,
                                bool sq_smem) {
    stride = GCH + HALO + 8;             // GCH/2 + 68 words: 4 mod 32
    ys = (resident ? fsz : GCH) + 8;     // 8 mod 32
    stage = 0;                           // int16 [2][CG][GCH]
    halo16 = stage + 2 * CG * GCH * 2;   // int16 [CG][128]
    xh = halo16 + CG * 128 * 2;          // half [CG][stride]
    xl = xh + CG * stride * 2;           // half [CG][stride]
    y = xl + CG * stride * 2;            // float [2][CG][ys]
    esum = y + 2 * CG * ys * 4;          // float [CG][cyc]
    epart = esum + (CG * cyc * 4 + 15) / 16 * 16;   // float [CG][32]
    sq = epart + CG * 32 * 4;            // float [CG][nsym]
    pb = sq + (sq_smem ? (CG * nsym * 4 + 15) / 16 * 16 : 0);  // float [2][CG][PBS]
    ph = pb + 2 * CG * PBS * 4;          // float [2][HALO]
    taps = ph + 2 * HALO * 4;            // float [2][KT]
    rng = taps + (2 * KT * 4 + 15) / 16 * 16;   // int [2][CG]
    bytes = rng + 2 * CG * 4;
  }
};

// Stage chunk [s_c, s_c + len) of frame f of the block's channels into
// ``dst`` (rows of GCH).
__device__ __forceinline__ void stage_chunk(int16_t* dst, const int16_t* pcm,
                                            int c0, int C, int F, int f,
                                            int fsz, int s_c, int len,
                                            int tid) {
  const int q8 = len / 8;                // 16-byte copies a channel
  for (int e = tid; e < CG * q8; e += GNT) {
    const int ch = e / q8, q = e - ch * q8;
    const int c = c0 + ch;
    cp_async16(dst + ch * GCH + 8 * q,
               pcm + ((long long)min(c, C - 1) * F + f) * fsz + s_c + 8 * q,
               c < C);
  }
}

// The halves pairing of ops/agc.py::_frame_power over p[0 .. n) in place
// by the lanes of one warp, then the odd residue summed in order, times
// ``inv``; lane 0 returns the value.
__device__ float warp_tree(float* p, int n, float inv, int lane) {
  __syncwarp();
  while (n > 1 && n % 2 == 0) {
    const int h = n / 2;
    for (int i = lane; i < h; i += 32) p[i] = __fadd_rn(p[i], p[i + h]);
    n = h;
    __syncwarp();
  }
  float s = 0.f;
  if (lane == 0) {
    s = p[0];
    for (int i = 1; i < n; ++i) s = __fadd_rn(s, p[i]);
    s = __fmul_rn(s, inv);
  }
  __syncwarp();                          // p may be written again
  return s;
}

template <bool TM, int MINB>
__global__ void __launch_bounds__(GNT, MINB)
frontend_general_kernel(const int16_t* __restrict__ pcm,
                        const float* __restrict__ tail_re,
                        const float* __restrict__ tail_im,
                        const float* __restrict__ p0_re,
                        const float* __restrict__ p0_im,
                        const float* __restrict__ dd_re,
                        const float* __restrict__ dd_im,
                        float* __restrict__ zr, float* __restrict__ zi,
                        int32_t* __restrict__ index,
                        float* __restrict__ ndd_re, float* __restrict__ ndd_im,
                        float* __restrict__ power, float* __restrict__ scratch,
                        float* __restrict__ nph_re, float* __restrict__ nph_im,
                        float* __restrict__ ntail_re,
                        float* __restrict__ ntail_im, int C, int F, int fsz,
                        int cyc, int H, int resident,
                        const __grid_constant__ Taps taps, double omega,
                        float gain, float inv_scale) {
  const int nsym = fsz / cyc;
  const bool pow_out = TM && power != nullptr;   // uniform over the grid
  const bool sq_smem = nsym <= GSQ;
  const GenLayout L(fsz, cyc, nsym, resident, pow_out && sq_smem);
  const int stride = L.stride, ys = L.ys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + L.stage);
  int16_t* halo16 = reinterpret_cast<int16_t*>(smem_raw + L.halo16);
  __half* xh = reinterpret_cast<__half*>(smem_raw + L.xh);
  __half* xl = reinterpret_cast<__half*>(smem_raw + L.xl);
  float* y = reinterpret_cast<float*>(smem_raw + L.y);
  float* ph = reinterpret_cast<float*>(smem_raw + L.ph);
  float* pb = reinterpret_cast<float*>(smem_raw + L.pb);
  float* tsm = reinterpret_cast<float*>(smem_raw + L.taps);
  int* rng = reinterpret_cast<int*>(smem_raw + L.rng);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = (int)(blockIdx.x % F);
  const int c0 = (int)(blockIdx.x / F) * CG;
  const int g = lane >> 2, t = lane & 3;
  const int plane = warp & 1, pair = warp >> 1;
  // this warp's channel in the energies, the picks and the power
  const int c = c0 + warp;
  const bool live = c < C;
  const float pr0 = live ? p0_re[c] : 1.f, pi0 = live ? p0_im[c] : 0.f;
  float* esum = reinterpret_cast<float*>(smem_raw + L.esum) + warp * cyc;
  float* epart = reinterpret_cast<float*>(smem_raw + L.epart) + warp * 32;
  float* sq_row =
      !pow_out ? nullptr
      : sq_smem ? reinterpret_cast<float*>(smem_raw + L.sq) + warp * nsym
                : scratch + ((long long)min(c, C - 1) * F + f) * nsym;
  const float* y0 = y + warp * ys;       // this channel's re and im outputs
  const float* y1 = y + (CG + warp) * ys;
  const float inv = (float)(1.0 / (double)nsym);   // float32(1/nsym)
  const int nchunks = (fsz + GCH - 1) / GCH;

  // the taps into shared memory first: the fragments' per-lane indices
  // would serialise the parameter's constant-cache reads
  for (int k = tid; k < 2 * KT; k += GNT)
    tsm[k] = k < KT ? taps.re[k] : taps.im[k - KT];
  if (f == 0) {
    for (int k = tid; k < H; k += GNT)
      phasor(omega * (double)(k - (H - 1)), ph[k], ph[HALO + k]);
  }
  for (int p = lane; p < cyc; p += 32) esum[p] = 0.f;
  float sr, si;                          // a lane's pick step, 32 symbols
  phasor(omega * (32.0 * cyc), sr, si);
  __syncthreads();
  uint32_t bh[ND][2], bl[ND][2];
  band_fragments(bh, bl, tsm + plane * KT, g, t);

  if (TM && f == 0) {
    // output frame 0: the carried delay, in rounds of GPR symbols through
    // pb (a warp reads its channel's symbols, the block stores 8 channels,
    // 32 bytes, a row), and its power
    for (int r0 = 0; r0 < nsym; r0 += GPR) {
#pragma unroll
      for (int m = 0; m < GPR / 32; ++m) {
        const int i = r0 + 32 * m + lane;
        if (live && i < nsym) {
          const float dr = dd_re[(long long)c * nsym + i];
          const float di = dd_im[(long long)c * nsym + i];
          pb[warp * PBS + i - r0] = dr;
          pb[(CG + warp) * PBS + i - r0] = di;
          if (pow_out) sq_row[i] = sq(dr, di);
        }
      }
      __syncthreads();
      for (int e = tid; e < GPR * CG; e += GNT) {
        const int i = r0 + e / CG, cc = c0 + e % CG;
        if (cc < C && i < nsym) {
          zr[(long long)i * C + cc] = pb[(e % CG) * PBS + i - r0];
          zi[(long long)i * C + cc] = pb[(CG + e % CG) * PBS + i - r0];
        }
      }
      __syncthreads();
    }
    if (pow_out && live) {
      const float v = warp_tree(sq_row, nsym, inv, lane);
      if (lane == 0) power[(long long)c * F] = v;
    }
  }

  // the picks of outputs [s_c, s_c + len), y's column yb + s - s_c
  // holding output s: lane ``lane`` of a warp walks its channel's symbols
  // I0 + lane + 32m, I0 = s_c / cyc, the angle of its first in float64,
  // then a float32 step of 32 symbols, and rotates those of the channel's
  // phase.  In rounds of GPR symbols, the time-major picks of a frame but
  // the last go into pb[plane][i][channel], which the block then stores 8
  // channels (32 bytes) a row; the rest (the channel-major picks, the last
  // frame's new delay) a warp stores itself, consecutive symbols.
  const bool staged = TM && f + 1 < F;   // uniform over the block
  int p = 0;                             // this warp's channel's phase
  const int K = cyc >= 32 ? 1 : 32 / cyc;   // lanes a phase
  float eacc = 0.f;                      // this lane's slot (K > 1)
  auto picks = [&](int s_c, int len, int yb) {
    const int I0 = s_c / cyc, I1 = min(nsym, (s_c + len + cyc - 1) / cyc);
    const int lo = (s_c - p + cyc - 1) / cyc;   // the channel's picks
    const int hi = min(nsym, (s_c + len - p + cyc - 1) / cyc);
    if (staged && lane == 0) {
      rng[warp] = lo;
      rng[CG + warp] = hi;
    }
    float er, ei;
    phasor(omega * (double)((long long)f * fsz + (long long)cyc * (I0 + lane) +
                            p + 1),
           er, ei);
    float fr = pr0 * er - pi0 * ei;
    float fi = pr0 * ei + pi0 * er;
    for (int r0 = I0; r0 < I1; r0 += GPR) {
#pragma unroll
      for (int m = 0; m < GPR / 32; ++m) {
        const int i = r0 + 32 * m + lane;
        if (live && i >= lo && i < hi) {
          const int s = cyc * i + p - s_c + yb;
          const float ur = y0[s], ui = y1[s];
          const float outr = ur * fr - ui * fi;
          const float outi = ur * fi + ui * fr;
          if (staged) {
            pb[warp * PBS + i - r0] = outr;
            pb[(CG + warp) * PBS + i - r0] = outi;
          } else if (TM) {
            ndd_re[(long long)c * nsym + i] = outr;
            ndd_im[(long long)c * nsym + i] = outi;
          } else {
            const long long o = ((long long)c * F + f) * nsym + i;
            zr[o] = outr;
            zi[o] = outi;
          }
          if (pow_out) sq_row[i] = sq(outr, outi);
        }
        const float nr = fr * sr - fi * si;
        fi = fr * si + fi * sr;
        fr = nr;
      }
      if (!staged) continue;
      __syncthreads();
      for (int e = tid; e < GPR * CG; e += GNT) {
        const int i = r0 + e / CG, ch = e % CG, cc = c0 + ch;
        if (cc < C && i >= rng[ch] && i < rng[CG + ch]) {
          const long long o = ((long long)(f + 1) * nsym + i) * C + cc;
          zr[o] = pb[ch * PBS + i - r0];
          zi[o] = pb[(CG + ch) * PBS + i - r0];
        }
      }
      __syncthreads();
    }
  };

  for (int pass = 0; pass < (resident ? 1 : 2); ++pass) {
    // the prologue's copies: the end of frame f-1 and the first chunk
    if (f > 0 && tid < CG * 16) {
      const int ch = tid / 16, q = tid % 16;
      const int cc = c0 + ch;
      cp_async16(halo16 + ch * 128 + 8 * q,
                 pcm + ((long long)min(cc, C - 1) * F + f - 1) * fsz + fsz -
                     128 + 8 * q,
                 cc < C);
    }
    stage_chunk(stage, pcm, c0, C, F, f, fsz, 0, min(GCH, fsz), tid);
    cp_async_commit();
    for (int k = 0; k < nchunks; ++k) {
      const int s_c = k * GCH, len = min(GCH, fsz - s_c);
      const int buf = k & 1;
      // the halo of chunk k: carried (un-mixed), staged, or the end of k-1
      __half keep_h[GKEEP], keep_l[GKEEP];
      if (k > 0) {
#pragma unroll
        for (int j = 0; j < GKEEP; ++j) {
          const int e = tid + j * GNT;
          keep_h[j] = xh[(e / HALO) * stride + GCH + e % HALO];
          keep_l[j] = xl[(e / HALO) * stride + GCH + e % HALO];
        }
      }
      if (k + 1 < nchunks) {
        stage_chunk(stage + (buf ^ 1) * CG * GCH, pcm, c0, C, F, f, fsz,
                    s_c + GCH, min(GCH, fsz - s_c - GCH), tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // (A) chunk k staged; k-1 read out of the window, y
#pragma unroll
      for (int j = 0; j < GKEEP; ++j) {
        const int e = tid + j * GNT;
        const int ch = e / HALO, kk = e % HALO;
        const int cc = c0 + ch;
        if (k > 0) {
          xh[ch * stride + kk] = keep_h[j];
          xl[ch * stride + kk] = keep_l[j];
          continue;
        }
        float v = 0.f;
        if (f > 0) {
          v = (float)halo16[ch * 128 + kk] * inv_scale;
        } else if (cc < C && kk >= HALO - H) {
          const int kt = kk - (HALO - H);   // the carried tail's sample
          float pr, pi;
          cmul_pinned(p0_re[cc], p0_im[cc], ph[kt], ph[HALO + kt], pr, pi);
          v = __fadd_rn(__fmul_rn(tail_re[(long long)cc * H + kt], pr),
                        __fmul_rn(tail_im[(long long)cc * H + kt], pi));
        }
        split(v, xh[ch * stride + kk], xl[ch * stride + kk]);
      }
      // the chunk, 8 samples a thread: one 16-byte stage load, two 16-byte
      // window stores
      const int16_t* st = stage + buf * CG * GCH;
      const int q8 = len / 8;
      for (int e = tid; e < CG * q8; e += GNT) {
        const int ch = e / q8, q = e - ch * q8;
        const int4 raw = *reinterpret_cast<const int4*>(st + ch * GCH + 8 * q);
        const int16_t* v = reinterpret_cast<const int16_t*>(&raw);
        __align__(16) __half hi[8], lo[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) split((float)v[u] * inv_scale, hi[u], lo[u]);
        *reinterpret_cast<int4*>(xh + ch * stride + HALO + 8 * q) =
            *reinterpret_cast<const int4*>(hi);
        *reinterpret_cast<int4*>(xl + ch * stride + HALO + 8 * q) =
            *reinterpret_cast<const int4*>(lo);
      }
      __syncthreads();   // (B) the window of chunk k

      // the FIR of this warp's plane over its row blocks: rows g and g + 8
      // are channel g at s0 and at s0 + len/2
      const int half = len / 2, nrb = len / 64;
      const int yb = resident ? s_c : 0;
      float* yp = y + (plane * CG + g) * ys + yb;
#pragma unroll 1
      for (int rb = pair; rb < nrb; rb += GNW / 2) {
        const int s0 = 32 * rb;
        float acc[4][4];
        band_rows(acc, xh + g * stride + s0 + 2 * t,
                  xl + g * stride + s0 + 2 * t, half, bh, bl);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            yp[s0 + 8 * nt + 2 * t + (r & 1) + (r >> 1) * half] =
                acc[nt][r] * gain;
      }
      __syncthreads();   // (C) the outputs of chunk k

      if (pass == 1) {
        picks(s_c, len, 0);
        continue;
      }
      // the phase energies: below 32 samples per symbol lane l < cyc*K is
      // the slot (phase l % cyc, part l / cyc) and sums, in order over the
      // frame, |y|^2 at each chunk's outputs s = first(phase) + cyc * (part
      // + K m); from 32 on a lane sums a chunk's outputs of each of its
      // phases in order and adds that to the phase's energy
      if (!live) continue;
      const int cb = s_c % cyc;
      if (K == 1) {
        for (int pp = lane; pp < cyc; pp += 32) {
          float acc = 0.f;
#pragma unroll 4
          for (int s = (pp - cb + cyc) % cyc; s < len; s += cyc)
            acc = __fadd_rn(acc, sq(y0[yb + s], y1[yb + s]));
          esum[pp] = __fadd_rn(esum[pp], acc);
        }
      } else if (lane < cyc * K) {
#pragma unroll 4
        for (int s = (lane % cyc - cb + cyc) % cyc + cyc * (lane / cyc);
             s < len; s += cyc * K)
          eacc = __fadd_rn(eacc, sq(y0[yb + s], y1[yb + s]));
      }
    }
    if (pass == 0) {
      if (K > 1) {
        // the K partial sums of a phase, in order
        epart[lane] = eacc;
        __syncwarp();
        if (lane < cyc) {
          float tot = epart[lane];
          for (int part = 1; part < K; ++part)
            tot = __fadd_rn(tot, epart[lane + cyc * part]);
          esum[lane] = tot;
        }
      }
      // the first maximum of the channel's energies
      __syncwarp();
      float best = -1.f;
      int bp = GMAXCYC;
      for (int pp = lane; pp < cyc; pp += 32)
        if (esum[pp] > best) {
          best = esum[pp];
          bp = pp;
        }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int op = __shfl_xor_sync(0xffffffffu, bp, o);
        if (ob > best || (ob == best && op < bp)) {
          best = ob;
          bp = op;
        }
      }
      p = bp;
      if (lane == 0 && live) index[(long long)c * F + f] = p;
      if (resident) picks(0, fsz, 0);
    }
  }
  if (pow_out && live && f + 1 < F) {
    const float v = warp_tree(sq_row, nsym, inv, lane);
    if (lane == 0) power[(long long)c * F + f + 1] = v;
  }

  if (f != F - 1) return;
  // the carried state after the call, from the last frame's blocks
  const long long n = (long long)F * fsz;
  for (int e = tid; e < CG * H; e += GNT) {
    const int ch = e / H, k = e % H;
    const int cc = c0 + ch;
    if (cc >= C) continue;
    float er, ei, pr, pi;
    phasor(omega * (double)(n - H + k + 1), er, ei);
    cmul_pinned(p0_re[cc], p0_im[cc], er, ei, pr, pi);
    const float raw =
        (float)pcm[((long long)cc * F + f) * fsz + fsz - H + k] * inv_scale;
    ntail_re[(long long)cc * H + k] = __fmul_rn(raw, pr);
    ntail_im[(long long)cc * H + k] = __fmul_rn(raw, pi);
  }
  if (tid < CG && c0 + tid < C) {
    const int cc = c0 + tid;
    float er, ei, ar, ai;
    phasor(omega * (double)n, er, ei);
    cmul_pinned(p0_re[cc], p0_im[cc], er, ei, ar, ai);
    const float iv = __fdiv_rn(1.f, __fsqrt_rn(sq(ar, ai)));
    nph_re[cc] = __fmul_rn(ar, iv);
    nph_im[cc] = __fmul_rn(ai, iv);
  }
}

}  // namespace

// Time-major launch; ``power`` may be null.  Reads the carried
// mixed-domain tail (C, ntaps-1) and phase (C,), writes the new ones
// beside the picks.
extern "C" int qpsk_frontend_tm(const void* pcm, const void* tail_re,
                                const void* tail_im, const void* p0_re,
                                const void* p0_im, const void* dd_re,
                                const void* dd_im, void* zr, void* zi,
                                void* index, void* ndd_re, void* ndd_im,
                                void* power, void* nph_re, void* nph_im,
                                void* ntail_re, void* ntail_im, int C, int F,
                                int fsz, int cycles, int ntaps,
                                const void* taps_re, const void* taps_im,
                                double omega, float gain, float inv_scale,
                                void* stream) {
  if (!covered(C, F, fsz, cycles, ntaps)) return (int)cudaErrorInvalidValue;
  const bool d = fsz == 512;
  const auto run = cycles == 2 ? (d ? launch<2, true, 512> : launch<2, true, 0>)
                   : cycles == 4 ? (d ? launch<4, true, 512> : launch<4, true, 0>)
                                 : (d ? launch<8, true, 512> : launch<8, true, 0>);
  return run(pcm, tail_re, tail_im, p0_re, p0_im, dd_re, dd_im, zr, zi, index,
             ndd_re, ndd_im, power, nph_re, nph_im, ntail_re, ntail_im, C, F,
             fsz, ntaps, taps_re, taps_im, omega, gain, inv_scale, stream);
}

// Channel-major launch.
extern "C" int qpsk_frontend_cm(const void* pcm, const void* tail_re,
                                const void* tail_im, const void* p0_re,
                                const void* p0_im, void* picks_re,
                                void* picks_im, void* index, void* nph_re,
                                void* nph_im, void* ntail_re, void* ntail_im,
                                int C, int F, int fsz, int cycles, int ntaps,
                                const void* taps_re, const void* taps_im,
                                double omega, float gain, float inv_scale,
                                void* stream) {
  if (!covered(C, F, fsz, cycles, ntaps)) return (int)cudaErrorInvalidValue;
  const bool d = fsz == 512;
  const auto run = cycles == 2 ? (d ? launch<2, false, 512> : launch<2, false, 0>)
                   : cycles == 4 ? (d ? launch<4, false, 512> : launch<4, false, 0>)
                                 : (d ? launch<8, false, 512> : launch<8, false, 0>);
  return run(pcm, tail_re, tail_im, p0_re, p0_im, nullptr, nullptr, picks_re,
             picks_im, index, nullptr, nullptr, nullptr, nph_re, nph_im,
             ntail_re, ntail_im, C, F, fsz, ntaps, taps_re, taps_im, omega,
             gain, inv_scale, stream);
}

// The general instance, both launches (``tm`` 1: time-major with the delay
// and, if ``power`` is not null, the power output, whose tree runs in
// ``scratch``, (C, F, fsz/cycles) float32, past GSQ symbols a frame; 0:
// channel-major, the picks in zr/zi).  Takes any cycles in
// 1..256 dividing fsz, fsz a multiple of 128, odd ntaps <= 129.
extern "C" int qpsk_frontend_gen(const void* pcm, const void* tail_re,
                                 const void* tail_im, const void* p0_re,
                                 const void* p0_im, const void* dd_re,
                                 const void* dd_im, void* zr, void* zi,
                                 void* index, void* ndd_re, void* ndd_im,
                                 void* power, void* scratch, void* nph_re,
                                 void* nph_im, void* ntail_re, void* ntail_im,
                                 int C, int F, int fsz, int cycles, int ntaps,
                                 int tm, const void* taps_re,
                                 const void* taps_im, double omega, float gain,
                                 float inv_scale, void* stream) {
  if (C < 1 || F < 1 || ntaps < 1 || ntaps > KT || ntaps % 2 == 0 ||
      fsz < 128 || fsz % 128 != 0 || cycles < 1 || cycles > GMAXCYC ||
      fsz % cycles != 0 || (long long)((C + CG - 1) / CG) * F > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int nsym = fsz / cycles;
  const bool sq_smem = tm && power != nullptr && nsym <= GSQ;
  if (tm && power != nullptr && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int k = 0; k < KT; ++k) {
    const int j = k - (KT - ntaps);
    taps.re[k] = j >= 0 ? static_cast<const float*>(taps_re)[j] : 0.f;
    taps.im[k] = j >= 0 ? static_cast<const float*>(taps_im)[j] : 0.f;
  }
  const bool resident =
      GenLayout(fsz, cycles, nsym, true, sq_smem).bytes <= GRES_BYTES;
  const int bytes = GenLayout(fsz, cycles, nsym, resident, sq_smem).bytes;
  // two blocks an SM where their shared memory fits (then at most 128
  // registers a thread), else one with no register cap
  const bool two = 2 * (bytes + 1024) <= 228 * 1024;
  const auto kernel = tm ? (two ? frontend_general_kernel<true, 2>
                                : frontend_general_kernel<true, 1>)
                         : (two ? frontend_general_kernel<false, 2>
                                : frontend_general_kernel<false, 1>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((C + CG - 1) / CG) * F;
  kernel<<<(unsigned)blocks, GNT, bytes, (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const float*)tail_re, (const float*)tail_im,
      (const float*)p0_re, (const float*)p0_im, (const float*)dd_re,
      (const float*)dd_im, (float*)zr, (float*)zi, (int32_t*)index,
      (float*)ndd_re, (float*)ndd_im, (float*)power, (float*)scratch,
      (float*)nph_re, (float*)nph_im, (float*)ntail_re, (float*)ntail_im, C,
      F, fsz, cycles, ntaps - 1, resident ? 1 : 0, taps, omega, gain,
      inv_scale);
  return (int)cudaGetLastError();
}
