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
// a multiple of 128 up to 512 (the wrapper's _PIPE_MAX_FRAME).  The rest
// of the TPU kernel's gate (other samples per symbol, longer frames, the
// power output at a symbol count that is not a power of two) runs
// frontend_general_kernel, at the end of this file.
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
//   by halves pairing (p[i] += p[i + h] for h = NSYM/2, .., 1), times
//   1/NSYM, every step a round-to-nearest intrinsic: the bits of
//   ops/agc.py::_frame_power.
// Channel-major mode: picks (C, F, NSYM) and index (C, F), no delay.
//
// What bounds it on the H100: arithmetic.  Each output sample costs 127
// complex taps on a real input, 130 k multiply-adds per 512-sample frame
// and channel, against 2 bytes of PCM read and 2 (CYC 4) or 1 (CYC 8)
// bytes of picks written per sample.  On the CUDA cores that is 0.26 ms at
// 8192 x 8 frames; so the FIR runs on the tensor cores as a Toeplitz
// product in float16 with float32 sums, three passes: an int16 over a
// power of two has at most 16 significant bits, so x = x_hi + x_lo
// exactly in two float16 (2^-22 relative for the float halo of frame 0);
// the taps are h_hi + h_lo, scaled by the wrapper by the power of two that
// puts the set's largest near 2^14, so every part rounds within 2^-22 of
// the largest tap; each product is x_lo*h_hi + x_hi*h_lo + x_hi*h_hi, the
// x_lo*h_lo term (2^-22 relative) dropped: the picks stay within the 3e-4
// the float32 chain is held to.  The bound (portbench/frozen_roofline.py)
// is 0.0550 ms at 8192 x 8: the three passes at the tensor cores' peak.
//
// frontend_kernel_pipe<CYC, TM, FSZ>, frames up to PIPE_MAX_FRAME = 512
// samples (the default config, and every geometry above up to 512): one
// persistent block an SM (the grid min(tiles, SMs)) walks its share of the
// tiles (8 channels x a frame, frames fastest), three warpgroups with a
// role each, handing tiles over on mbarriers in shared memory:
//   * the stager copies tile k's PCM into a ring of NS = 2 stage slots by
//     cp.async (completion on the slot's mbarrier), splits it into the
//     float16 hi and lo planes of a ring of NW = 5 window slots, 8
//     channels interleaved in 16-byte rows ([sample / 8][channel][8], the
//     layout of a wgmma operand's 8x8 core matrices), the halo taken from
//     the previous window as it is, and hands the window to the FIR
//     groups; at a call's last frame it also writes the carried state;
//   * two FIR warpgroups take the tiles in turn.  A tile's product is
//     D (64 x 128) = band (64 x 160) * window (160 x 128) by wgmma
//     m64n64k16, the band (rows: re then im taps of 32 output positions,
//     A[m][k] = h[k - m % 32]) in registers by ldmatrix from a copy in
//     shared memory made once a block, the window (columns: 8 channels at
//     16 segments of 32 outputs) read in place by descriptor, in two
//     rounds of 5 k-tiles x 3 passes (60 products).  From the products in
//     registers a group takes the phase energies (warp shuffles, then a
//     sum of the 4 warps' in fixed order), the first argmax, and stores
//     only the outputs at each channel's phase; then it rotates and
//     stores the tile's picks, while the other group's products run.  The
//     time-major picks go out 8 channels (32 bytes) a row of the (T, C)
//     output.
// What each role is for, from the split of the instance it replaced
// (below): the
// stager takes the staging and the split (a quarter of that kernel's
// time) off the FIR warps, and the second FIR group runs one tile's
// picks and stores (a fifth) beside the other's products; a persistent
// block makes the taps' band, the pick phasor's step and the carried
// tail's phasors once, not once every 4 frames (8 % of that kernel's
// time was its prologue).  The window as the wgmma operand read from
// shared memory and the band from registers move 160 KB of shared memory
// a tile (with the signal in registers and the band in shared memory:
// 200 KB; both in shared memory: 240 KB, the tensor cores then take all of
// it at their rate).  Registers: 168 a thread (384 threads, one block an
// SM), 8 bytes spilled at the default geometry; setmaxnreg to give the FIR
// groups more was ignored by ptxas ("to maintain minimum register
// requirements") and then crashed it, so the roles share the register file
// evenly.  Times (fec_times.py, NVIDIA H100 80GB HBM3, 700 W, 8192 x 8,
// alone in a CUDA graph): time-major 0.179 ms against the blocked
// instance's 0.340 ms, 31 % of the bound; PERF.md section 6 has every mode.
// By clock64 stamps of each warp at 8192 x 8 (cycles a tile a warp): the
// stager copies and splits in about 4.4 k; a FIR group spends 4.2 k in its
// products (its own 60 and the other group's), 2.6 k in energies, phase
// and the phase's outputs, 2.6 k in the picks and stores: both roles are
// bound by their latency, not by the tensor cores (busy about 2.2 k).
//
// The instance it replaced, the blocked frontend_kernel: one block of 4
// warps per (8 channels, up to 4 consecutive frames), each step in turn
// behind a __syncthreads: the next frame's copy, the split of the window
// into shared memory, the FIR by mma.sync m16n8k16 (the 18 band fragments
// of a plane in registers, as band_fragments / band_rows below still do
// for the general instance), the outputs and energies to shared memory,
// then the picks by all 128 threads.  Its sections at 512 samples, 8192 x
// 8 (clock64 stamps, shares of the warps' cycles): the prologue 8 %, the
// copy's wait 5 %, halo and split 26 %, FIR and outputs 36 %, argmax 1 %,
// picks and stores 20 %, carried state 4 %; without its FIR it took 0.22
// ms of 0.36, without the split 0.24, without the picks 0.28: the steps
// around the FIR, run one after another, were the larger part, hence the
// pipeline.  At its longer frames (640 to 1664 samples) the general
// instance took 0.75-0.82 of its time at 1024 and 1664 samples and 1.09 at
// 640 (PERF.md section 6), so the general instance takes them all.
// The pipeline has instances with the default 512-sample frame fixed at
// compile time; every other size runs the instances that read it from
// the launch.  Every instance reads the PCM in 16-byte copies; the wrapper
// passes it 16-byte aligned.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int KT = 129;                  // taps the kernel runs (padded)
constexpr int HALO = KT - 1;             // raw samples before a frame
constexpr int CG = 8;                    // channels a block
constexpr int NWARP = 4;
constexpr int NTHR = 32 * NWARP;
constexpr int ND = 18;                   // B fragments: 16*kt - 8*nt = -8..128
constexpr int NKT = 10;                  // 16-wide k-tiles of a row block
constexpr double TWO_PI = 6.283185307179586476925286766559;

struct Taps {
  float re[KT];
  float im[KT];
};

// cudaFuncSetAttribute of ``kernel``'s dynamic shared memory, made once for
// each kernel, device and larger byte count: the attribute stays set on the
// device, and a launch that set it again would pay a driver call each time
cudaError_t allow_smem(const void* kernel, int bytes) {
  struct Grant {
    const void* kernel;
    int device, bytes;
  };
  static std::mutex lock;
  static std::vector<Grant> granted;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  for (const Grant& g : granted) {
    if (g.kernel == kernel && g.device == device && g.bytes >= bytes) {
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) granted.push_back({kernel, device, bytes});
  return err;
}

// the ntaps host taps behind KT - ntaps zeros, as every instance takes them
Taps pad_taps(const void* taps_re, const void* taps_im, int ntaps) {
  Taps taps;
  for (int k = 0; k < KT; ++k) {
    const int j = k - (KT - ntaps);
    taps.re[k] = j >= 0 ? static_cast<const float*>(taps_re)[j] : 0.f;
    taps.im[k] = j >= 0 ? static_cast<const float*>(taps_im)[j] : 0.f;
  }
  return taps;
}

__device__ __forceinline__ float sq(float r, float i) {
  return __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i));
}

// v = hi + lo in float16, both rounded to nearest: exact for an int16
// over a power of two (at most 16 significant bits), 2^-22 relative else
__device__ __forceinline__ void split(float v, __half& hi, __half& lo) {
  hi = __float2half_rn(v);
  lo = __float2half_rn(__fsub_rn(v, __half2float(hi)));
}

// split() of the two int16 samples of ``ab`` (a low) times ``scale``, as
// .f16x2 pairs: the int16 to float by the exponent of 1.5 * 2^23 (exact),
// the conversions two at a time; the bits of split((float)a * scale) and
// split((float)b * scale)
__device__ __forceinline__ void split2(uint32_t ab, float scale, uint32_t& hi,
                                       uint32_t& lo) {
  const int a = (int)(int16_t)(ab & 0xffffu), b = (int)ab >> 16;
  const float x = __fmul_rn(__fsub_rn(__int_as_float(0x4B400000 + a), 12582912.f), scale);
  const float z = __fmul_rn(__fsub_rn(__int_as_float(0x4B400000 + b), 12582912.f), scale);
  __half2 h = __floats2half2_rn(x, z);
  const float2 hf = __half22float2(h);
  __half2 l = __floats2half2_rn(__fsub_rn(x, hf.x), __fsub_rn(z, hf.y));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
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

// ---------------------------------------------------------------------------
// The tensor-core instance, frontend_kernel_pipe<CYC, TM, FSZ>, at frames
// up to PIPE_MAX_FRAME = 512 samples (16 segments of 32 outputs, a FIR
// group's two accumulators).  The header of this file says why and what
// it measured.
constexpr int NS = 2;                    // PCM stage slots
constexpr int NW = 5;                    // window slots
constexpr int NFIR = 2;                  // FIR warpgroups
constexpr int PNT = (1 + NFIR) * NTHR;   // and the stager
constexpr int BKP = 16 * NKT + 8;        // a band row's pitch: 20 mod 32 words
constexpr int PIPE_MAX_BYTES = 227 * 1024;
constexpr int PIPE_MAX_FRAME = 512;      // 2 accumulators x 8 segments x 32

// The pipeline's shared memory at a frame of ``fsz`` samples, in bytes
// (every offset a multiple of 16).
struct PipeLayout {
  // a FIR group's words beside its outputs: the per-warp energies (float
  // [NWARP][CG][cyc], at most 256), the phases (int [CG]), the first
  // picks' carriers of three tiles (float [3][2][16 cyc])
  __host__ __device__ static int eps(int cyc) {
    return NWARP * 8 * 4 * 2 + CG + 3 * 2 * 16 * cyc;
  }
  int row, rowp, plane, ys;  // stage row, its pitch, a window plane, a y
  int bars, tsm, ph0, phe, band, stage, win, y, epart, bytes;
  __host__ __device__ PipeLayout(int fsz, int cyc) {
    row = HALO + fsz;                    // int16: the halo and the frame
    rowp = row + 8;                      // 4 mod 32 words: a stage read's 32 banks
    plane = row * CG;                    // halves [row / 8][CG][8]
    ys = 2 * fsz / cyc * CG;             // floats: re and im of the picks' phase
    bars = 0;                            // uint64 [NS + 2 * NW]
    tsm = 128;                           // float [2][KT]
    ph0 = tsm + (2 * KT * 4 + 15) / 16 * 16;   // float [2][HALO]
    phe = ph0 + 2 * HALO * 4;            // float [2][HALO]
    band = (phe + 2 * HALO * 4 + 127) / 128 * 128;   // half [2][64][BKP]
    stage = band + 2 * 64 * BKP * 2;     // int16 [NS][CG][rowp]
    win = stage + NS * CG * rowp * 2;    // half [NW][2][plane]
    y = win + NW * 2 * plane * 2;        // float [NFIR][ys]
    epart = y + NFIR * ys * 4;           // [NFIR][eps]
    bytes = epart + NFIR * eps(cyc) * 4;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// wait until the phase of parity ``parity`` of ``bar`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// order this thread's shared-memory writes before the tensor cores'
// reads
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes to / from shared memory at ``addr`` (the compiler does not
// know the window's alignment and would split a uint4 store in four)
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// a barrier of the 128 threads of one warpgroup
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NTHR) : "memory");
}

// A wgmma operand's descriptor: 8x8 core matrices of halves, no swizzle,
// a core matrix's neighbour along k ``lead`` bytes on, along m or n
// ``stride`` bytes on
__device__ __forceinline__ uint64_t mat_desc(uint32_t addr, uint32_t lead,
                                             uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32);
}

#define WG_D8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A * B, m64n64k16: A (this warp's 16 rows) from registers, B from
// shared memory by descriptor, float16 products summed in float32
__device__ __forceinline__ void wgmma_band(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// keep the compiler from moving reads or writes of ``d`` across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The timing phase of channel ``ch``'s tile from the FIR group's per-warp
// energies esum[warp][ch][phase], summed over the warps in the same order
// by every thread that asks; the first maximum wins.
template <int CYC>
__device__ __forceinline__ int tile_phase(const float* esum, int ch) {
  int p = 0;
  float best_e = 0.f;
#pragma unroll
  for (int pp = 0; pp < CYC; ++pp) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) sum += esum[(w * CG + ch) * CYC + pp];
    if (pp == 0 || sum > best_e) {
      best_e = sum;
      p = pp;
    }
  }
  return p;
}

// The picks' threads: 16 a channel ``ch``, thread ``part`` holding the
// symbols i = part + 16m; time-major, channels fastest (a warp's store is
// 4 rows of the (T, C) output, 32 bytes each), else a channel's 16 in a
// half warp (consecutive symbols).
template <bool TM>
__device__ __forceinline__ void pick_lane(int warp, int lane, int& ch,
                                          int& part) {
  ch = TM ? lane & 7 : warp * 2 + (lane >> 4);
  part = TM ? warp * 4 + (lane >> 3) : lane & 15;
}

// e^{j omega (f fsz + part CYC + p + 1)}: the carrier at a thread's first
// pick, the angle reduced mod 2 pi in float64
template <int CYC>
__device__ __forceinline__ void pick_carrier(double omega, int f, int fsz,
                                             int part, int p, float& er,
                                             float& ei) {
  phasor(omega * (double)((long long)f * fsz + (part * CYC + p) + 1), er, ei);
}

// Output frame 0 of the time-major launch, thread (c, part)'s symbols of
// it: the carried delay as rows of the (T, C) output and, with a power
// output, their squares, into ``pdr`` when the frame size is known at
// compile time (SPT picks a thread), else into pd[i * CG]
template <int FSZ, int SPT, int UNR>
__device__ __forceinline__ void emit_delay(
    const float* __restrict__ dd_re, const float* __restrict__ dd_im,
    float* __restrict__ zr, float* __restrict__ zi, int c, int C, bool live,
    int nsym, int part, bool pow_out, float (&pdr)[SPT], float* pd) {
  const int spt = nsym / 16;
#pragma unroll UNR
  for (int m = 0; m < spt; ++m) {
    const int i = part + 16 * m;
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
}

// The picks of frame ``f`` of channels c0 .. c0 + 7, by the 128 threads
// of a FIR group, which ``sync()`` joins, thread (ch, part) of pick_lane
// at phase ``p``: the timing index, the rotated picks (time-major with the
// one-frame delay, or channel-major) and the power output.  ``yr``, ``yi``
// hold the outputs at phase p ([i * CG + ch]); (er, ei) is the carrier at
// the thread's first pick, (pr0, pi0) the channel's phase, (sr, si) the
// carrier's step of 16 symbols.
template <int CYC, bool TM, int FSZ, typename Sync>
__device__ __forceinline__ void emit_frame(
    float* yr, float* yi, int ch, int part, int p, float er, float ei, float pr0, float pi0, int c0, int C,
    int F, int f, int fsz, const float* __restrict__ dd_re,
    const float* __restrict__ dd_im,
    float* __restrict__ zr, float* __restrict__ zi,
    int32_t* __restrict__ index, float* __restrict__ ndd_re,
    float* __restrict__ ndd_im, float* __restrict__ power, float sr,
    float si, Sync sync) {
  const int nsym = fsz / CYC;
  const int spt = nsym / 16;             // picks a thread
  const int c = c0 + ch;
  const bool live = c < C;
  if (part == 0 && live) index[(long long)c * F + f] = p;
  float fr = pr0 * er - pi0 * ei;
  float fi = pr0 * ei + pi0 * er;
  // with a power output the squares stay in registers when the frame
  // size is known at compile time; else they go back to the slots of y
  // they replace, [i * CG + ch], each slot read and written by this thread
  // alone: frame f's to yr's, the delay's to yi's, written once the thread
  // has read them (the delay's loop runs after the outputs' loop there)
  const bool pow_out = TM && power != nullptr;   // uniform over the grid
  constexpr int SPT = FSZ > 0 ? FSZ / CYC / 16 : 1;   // picks a thread
  constexpr int UNR = FSZ > 0 ? SPT : 4;
  float pwr[SPT], pdr[SPT];
  float* pw = yr + ch;                 // [i * CG]: squares of frame f
  float* pd = yi + ch;                 // squares of the carried delay
  // the delay's loads go out together, before the outputs' loop where the
  // frame size is known at compile time
  if constexpr (FSZ > 0)
    if (TM && f == 0)
      emit_delay<FSZ, SPT, UNR>(dd_re, dd_im, zr, zi, c, C, live, nsym, part,
                                pow_out, pdr, pd);
  // the outputs first, when the frame size is known at compile time
  float lr[SPT], li[SPT];
  if constexpr (FSZ > 0) {
#pragma unroll
    for (int m = 0; m < SPT; ++m) {
      lr[m] = yr[(part + 16 * m) * CG + ch];
      li[m] = yi[(part + 16 * m) * CG + ch];
    }
  }
#pragma unroll UNR
  for (int m = 0; m < spt; ++m) {
    const int i = part + 16 * m;
    float ur, ui;
    if constexpr (FSZ > 0) {
      ur = lr[m];
      ui = li[m];
    } else {
      ur = yr[i * CG + ch];
      ui = yi[i * CG + ch];
    }
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
    } else if (live) {
      const long long o = ((long long)c * F + f) * nsym + i;
      zr[o] = outr;
      zi[o] = outi;
    }
  }
  if constexpr (FSZ == 0)
    if (TM && f == 0)
      emit_delay<FSZ, SPT, UNR>(dd_re, dd_im, zr, zi, c, C, live, nsym, part,
                                pow_out, pdr, pd);
  if (pow_out) {
    // halves pairing: the levels h >= 16 pair a thread's own symbols (in
    // registers when the frame size is known at compile time, else in
    // y), then each thread's sum goes to y[.][part][ch] (a slot that only
    // this thread reads) and the channel's part 0 pairs the 16 in turn
    if constexpr (FSZ > 0) {
#pragma unroll
      for (int hm = SPT / 2; hm >= 1; hm >>= 1)
#pragma unroll
        for (int m = 0; m < hm; ++m) {
          pwr[m] = __fadd_rn(pwr[m], pwr[m + hm]);
          if (f == 0) pdr[m] = __fadd_rn(pdr[m], pdr[m + hm]);
        }
      pw[part * CG] = pwr[0];
      if (f == 0) pd[part * CG] = pdr[0];
    } else {
      for (int hh = nsym / 2; hh >= 16; hh >>= 1)
        for (int i = part; i < hh; i += 16) {
          pw[i * CG] = __fadd_rn(pw[i * CG], pw[(i + hh) * CG]);
          if (f == 0) pd[i * CG] = __fadd_rn(pd[i * CG], pd[(i + hh) * CG]);
        }
    }
    sync();
    if (part == 0 && live) {
      float vw[16], vd[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        vw[q] = pw[q * CG];
        vd[q] = f == 0 ? pd[q * CG] : 0.f;
      }
#pragma unroll
      for (int hh = 8; hh >= 1; hh >>= 1)
#pragma unroll
        for (int q = 0; q < hh; ++q) {
          vw[q] = __fadd_rn(vw[q], vw[q + hh]);
          vd[q] = __fadd_rn(vd[q], vd[q + hh]);
        }
      const float inv = 1.f / (float)nsym;          // a power of two: exact
      if (f + 1 < F) power[(long long)c * F + f + 1] = __fmul_rn(vw[0], inv);
      if (f == 0) power[(long long)c * F] = __fmul_rn(vd[0], inv);
    }
  }
}

template <int CYC, bool TM, int FSZ>
__global__ void __launch_bounds__(PNT, 1)
frontend_kernel_pipe(const int16_t* __restrict__ pcm,
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
                     float* __restrict__ ntail_re,
                     float* __restrict__ ntail_im, int C, int F, int fsz_arg,
                     int H, const __grid_constant__ Taps taps, double omega,
                     float gain, float inv_scale) {
  const int fsz = FSZ > 0 ? FSZ : fsz_arg;
  const PipeLayout L(fsz, CYC);
  const int row = L.row, rowp = L.rowp, plane = L.plane;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full_st = reinterpret_cast<uint64_t*>(smem_raw + L.bars);
  uint64_t* full_win = full_st + NS;
  uint64_t* empty_win = full_win + NW;
  float* tsm = reinterpret_cast<float*>(smem_raw + L.tsm);
  float* ph0 = reinterpret_cast<float*>(smem_raw + L.ph0);
  float* phe = reinterpret_cast<float*>(smem_raw + L.phe);
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw + L.stage);
  __half* win = reinterpret_cast<__half*>(smem_raw + L.win);

  const int tid = threadIdx.x, lane = tid & 31;
  const int role = tid / NTHR, rtid = tid % NTHR, rwarp = rtid >> 5;
  const long long ntot = (long long)F * fsz;   // samples a channel
  // this block's tiles (8 channels, a frame), frames fastest: t0 .. t0+nt-1
  const long long tiles = (long long)((C + CG - 1) / CG) * F;
  const int t0 = (int)(tiles * blockIdx.x / gridDim.x);
  const int nt = (int)(tiles * (blockIdx.x + 1) / gridDim.x) - t0;

  // the prologue, once a block: the barriers, the taps, the phasors of
  // frame 0's halo and of the new tail, and the band A[m][k] = h[k - m %
  // 32] (re taps at m < 32, im at m >= 32) split into hi and lo
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(full_st + i, NTHR);
    for (int i = 0; i < NW; ++i) {
      mbar_init(full_win + i, NTHR);
      mbar_init(empty_win + i, NTHR);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = tid; k < 2 * KT; k += PNT)
    tsm[k] = k < KT ? taps.re[k] : taps.im[k - KT];
  for (int k = tid; k < H; k += PNT) {
    phasor(omega * (double)(k - (H - 1)), ph0[k], ph0[HALO + k]);
    phasor(omega * (double)(ntot - H + k + 1), phe[k], phe[HALO + k]);
  }
  __syncthreads();
  __half* band = reinterpret_cast<__half*>(smem_raw + L.band);
  for (int e = tid; e < 64 * 16 * NKT; e += PNT) {
    const int m = e / (16 * NKT), k = e % (16 * NKT), j = k - m % 32;
    const float h = (j >= 0 && j < KT) ? tsm[(m >> 5) * KT + j] : 0.f;
    split(h, band[m * BKP + k], band[(64 + m) * BKP + k]);
  }
  __syncthreads();

  if (role == 0) {
    // the stager: tile k's PCM (and for the block's first tile past frame
    // 0 the 128 samples before it) into stage slot k % NS by cp.async,
    // each stager's copies arriving on full_st[k % NS]; then as float16
    // hi and lo into window slot k % NW, [sample / 8][channel][8], the
    // halo from the last tile's window (frame f - 1 of the same channels)
    // or, at frame 0, the carried tail; after a call's last frame, the
    // carried state from the same stage slot
    // (16 stagers a channel, consecutive 16-byte chunks of its row)
    auto copy_in = [&](int k) {
      const int tile = t0 + k, c0 = tile / F * CG, f = tile % F;
      const int ch = rtid >> 4, c = c0 + ch;
      int16_t* dst = stage + ((k % NS) * CG + ch) * rowp;
      const int16_t* src = pcm + ((long long)min(c, C - 1) * F + f) * fsz - HALO;
      for (int q = (f > 0 && k == 0 ? 0 : HALO / 8) + (rtid & 15); q < row / 8;
           q += 16)
        cp_async16(dst + 8 * q, src + 8 * q, c < C);
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                       smem_addr(full_st + k % NS))
                   : "memory");
    };
    for (int k = 0; k < min(NS, nt); ++k) copy_in(k);
    for (int k = 0; k < nt; ++k) {
      const int tile = t0 + k, c0 = tile / F * CG, f = tile % F;
      const int s = k % NS, w = k % NW;
      mbar_wait(empty_win + w, ((k / NW) & 1) ^ 1);
      mbar_wait(full_st + s, (k / NS) & 1);
      const int16_t* st = stage + s * CG * rowp;
      __half* xh = win + w * 2 * plane;
      __half* xl = xh + plane;
      // 8 samples of a channel an item, channels fastest: one 16-byte
      // load, two 16-byte stores; four items in flight a thread
      const uint32_t sta = smem_addr(st), xha = smem_addr(xh);
      const int e0 = f > 0 && k == 0 ? 0 : HALO, n8 = row;   // items: (row / 8) * CG
      if (f > 0 && k > 0) {
        // the halo: window slot (k - 1) % NW's last 128 samples, as they are
        const uint32_t pa = smem_addr(win + ((k - 1) % NW) * 2 * plane);
        sts128(xha + 16 * rtid, lds128(pa + 16 * (fsz + rtid)));
        sts128(xha + plane * 2 + 16 * rtid, lds128(pa + plane * 2 + 16 * (fsz + rtid)));
      }
#pragma unroll 1
      for (int e = e0 + rtid; e < n8; e += 4 * NTHR) {
        uint4 raw[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int eu = e + u * NTHR;
          if (eu < n8) raw[u] = lds128(sta + ((eu & 7) * rowp + 8 * (eu >> 3)) * 2);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int eu = e + u * NTHR;
          if (eu >= n8) continue;
          uint4 hi, lo;
          split2(raw[u].x, inv_scale, hi.x, lo.x);
          split2(raw[u].y, inv_scale, hi.y, lo.y);
          split2(raw[u].z, inv_scale, hi.z, lo.z);
          split2(raw[u].w, inv_scale, hi.w, lo.w);
          sts128(xha + 16 * eu, hi);
          sts128(xha + plane * 2 + 16 * eu, lo);
        }
      }
      if (f == 0) {
        // frame 0's halo: the carried tail un-mixed, behind 128 - H zeros
#pragma unroll
        for (int u = 0; u < CG * HALO / NTHR; ++u) {
          const int e = rtid + u * NTHR, ch = e / HALO, kk = e % HALO;
          const int c = c0 + ch;
          float v = 0.f;
          if (c < C && kk >= HALO - H) {
            const int j = kk - (HALO - H);
            float pr, pi;
            cmul_pinned(p0_re[c], p0_im[c], ph0[j], ph0[HALO + j], pr, pi);
            v = __fadd_rn(__fmul_rn(tail_re[(long long)c * H + j], pr),
                          __fmul_rn(tail_im[(long long)c * H + j], pi));
          }
          const int o = ((kk >> 3) * CG + ch) * 8 + (kk & 7);
          split(v, xh[o], xl[o]);
        }
      }
      fence_async();
      mbar_arrive(full_win + w);
      if (f == F - 1) {
        // the carried state after the call: the raw samples ending it
        // re-mixed, and the phase advanced by ntot samples
#pragma unroll
        for (int u = 0; u < CG * HALO / NTHR; ++u) {
          const int e = rtid + u * NTHR, ch = e / HALO, kk = e % HALO;
          const int c = c0 + ch;
          if (kk >= H || c >= C) continue;
          float pr, pi;
          cmul_pinned(p0_re[c], p0_im[c], phe[kk], phe[HALO + kk], pr, pi);
          const float raw = (float)st[ch * rowp + HALO + fsz - H + kk] * inv_scale;
          ntail_re[(long long)c * H + kk] = __fmul_rn(raw, pr);
          ntail_im[(long long)c * H + kk] = __fmul_rn(raw, pi);
        }
        if (rtid < CG && c0 + rtid < C) {
          const int c = c0 + rtid;
          float er, ei, ar, ai;
          phasor(omega * (double)ntot, er, ei);
          cmul_pinned(p0_re[c], p0_im[c], er, ei, ar, ai);
          const float inv = __fdiv_rn(1.f, __fsqrt_rn(sq(ar, ai)));
          nph_re[c] = __fmul_rn(ar, inv);
          nph_im[c] = __fmul_rn(ai, inv);
        }
      }
      group_sync(1);                     // every stager has read slot s
      if (k + NS < nt) copy_in(k + NS);
    }
    return;
  }

  // the FIR warpgroups, tiles k = cw, cw + NFIR, ...: the Toeplitz product
  // of a window's 8 channels by wgmma, the band's 64 rows (re and im of 32
  // outputs) from registers by the window's columns (8 channels at 8
  // segments, twice) by 160; from the products in registers the phase
  // energies, the phase, and the outputs at that phase to shared memory;
  // then the tile's picks, while the other group's products run.  A tile
  // needs two barriers of its group: one thread's store-out of tile k
  // follows every thread's picks of tile k - NFIR (they wrote their
  // energies of tile k after them).
  const int cw = role - 1, bar = 2 + cw;
  float* y = reinterpret_cast<float*>(smem_raw + L.y) + cw * L.ys;
  float* epart = reinterpret_cast<float*>(smem_raw + L.epart) +
                 cw * PipeLayout::eps(CYC);
  int* pch = reinterpret_cast<int*>(epart + NWARP * 8 * 4 * 2);
  float* ctab = epart + NWARP * 8 * 4 * 2 + CG;   // [3][2][16 * CYC]
  const int nsym = fsz / CYC, nseg = fsz / 32;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t bh = smem_addr(smem_raw + L.band), bl = bh + 64 * BKP * 2;
  // ldmatrix: lane l addresses row l & 15, k half l >> 4 of this warp's
  // 16 rows of the band
  const uint32_t arow = ((16 * rwarp + (lane & 15)) * BKP + 8 * (lane >> 4)) * 2;
  int pick_ch, part;
  pick_lane<TM>(rwarp, lane, pick_ch, part);
  float sr, si;                          // the pick phasor's step, 16 symbols
  phasor(omega * (16.0 * CYC), sr, si);
  // the carriers at the first picks of tile k, part q / CYC at phase q %
  // CYC by thread q of 16 CYC, into table (k / NFIR) % 3: tile k + NFIR's
  // are made while tile k's products run, when every thread of the group
  // has left the picks of tile k - NFIR, which read another table
  auto carriers = [&](int k) {
    float* tab = ctab + ((k / NFIR) % 3) * 2 * 16 * CYC;
    if (rtid < 16 * CYC)
      pick_carrier<CYC>(omega, (t0 + k) % F, fsz, rtid / CYC, rtid % CYC,
                        tab[rtid], tab[16 * CYC + rtid]);
  };
  if (cw < nt) carriers(cw);
  // d[4j + r] is output 16 (warp & 1) + g + 8 (r >> 1) of segment 8 hf + j,
  // channel 2t + (r & 1), re (warps 0, 1) or im; its phase is g % CYC
  const int m0 = 16 * (rwarp & 1) + g, yplane = (rwarp >> 1) * nsym * CG;
  for (int k = cw; k < nt; k += NFIR) {
    const int tile = t0 + k, c0 = tile / F * CG, f = tile % F;
    const int w = k % NW;
    const bool live = c0 + pick_ch < C;
    const float pr0 = live ? p0_re[c0 + pick_ch] : 1.f;
    const float pi0 = live ? p0_im[c0 + pick_ch] : 0.f;
    mbar_wait(full_win + w, (k / NW) & 1);
    const uint32_t xh = smem_addr(win + w * 2 * plane), xl = xh + plane * 2;
    float d0[32], d1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.f;
    fence_acc(d0);
    fence_acc(d1);
    // the products in two rounds of 5 k-tiles, the band's fragments of a
    // round in registers until its products are done; the next tile's
    // carriers while the second round runs
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      uint32_t ah[NKT / 2][4], al[NKT / 2][4];
#pragma unroll
      for (int u = 0; u < NKT / 2; ++u) {
        ldsm_x4(ah[u], bh + arow + 32 * (5 * kh + u));
        ldsm_x4(al[u], bl + arow + 32 * (5 * kh + u));
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int u = 0; u < NKT / 2; ++u) {
        // B: core matrix (k half, j) at segment j, samples 16kt + 8 half
        const uint32_t b = 2 * (5 * kh + u) * 128;
        wgmma_band(d0, ah[u], mat_desc(xl + b, 128, 512));
        wgmma_band(d0, al[u], mat_desc(xh + b, 128, 512));
        wgmma_band(d0, ah[u], mat_desc(xh + b, 128, 512));
        if (nseg > 8) {
          wgmma_band(d1, ah[u], mat_desc(xl + b + 4096, 128, 512));
          wgmma_band(d1, al[u], mat_desc(xh + b + 4096, 128, 512));
          wgmma_band(d1, ah[u], mat_desc(xh + b + 4096, 128, 512));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (kh == 1 && k + NFIR < nt) carriers(k + NFIR);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int u = 0; u < NKT / 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          asm volatile("" : "+r"(ah[u][i]), "+r"(al[u][i])::"memory");
    }
    fence_acc(d0);
    fence_acc(d1);
    mbar_arrive(empty_win + w);
    float e0 = 0.f, e1 = 0.f;            // energies of channels 2t, 2t + 1
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float(&d)[32] = hf ? d1 : d0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * hf + j >= nseg) break;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = d[4 * j + r] * gain;
          if (r & 1) e1 += v * v; else e0 += v * v;
        }
      }
    }
    // the warp's sums over the lanes of a phase (g % CYC), the same in
    // each of them: esum[warp][channel][phase]
#pragma unroll
    for (int o = 4 * CYC; o < 32; o <<= 1) {
      e0 += __shfl_xor_sync(0xffffffffu, e0, o);
      e1 += __shfl_xor_sync(0xffffffffu, e1, o);
    }
    if (g < CYC) {
      epart[(rwarp * CG + 2 * t) * CYC + g] = e0;
      epart[(rwarp * CG + 2 * t + 1) * CYC + g] = e1;
    }
    group_sync(bar);                     // the tile's energies
    const int pa = tile_phase<CYC>(epart, 2 * t);
    const int pb = tile_phase<CYC>(epart, 2 * t + 1);
    if (rwarp == 0 && g == 0) {
      pch[2 * t] = pa;
      pch[2 * t + 1] = pb;
    }
    // the outputs at each channel's phase to y[plane][symbol][channel]
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float(&d)[32] = hf ? d1 : d0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * hf + j >= nseg) break;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (g % CYC != ((r & 1) ? pb : pa)) continue;
          const int s = 32 * (8 * hf + j) + m0 + 8 * (r >> 1);
          y[yplane + s / CYC * CG + 2 * t + (r & 1)] = d[4 * j + r] * gain;
        }
      }
    }
    group_sync(bar);                     // the picks' outputs and phases
    const int pc = pch[pick_ch];
    const float* tab = ctab + ((k / NFIR) % 3) * 2 * 16 * CYC;
    emit_frame<CYC, TM, FSZ>(y, y + nsym * CG, pick_ch, part,
                             pc, tab[part * CYC + pc],
                             tab[16 * CYC + part * CYC + pc], pr0, pi0, c0, C,
                             F, f, fsz, dd_re, dd_im, zr, zi, index, ndd_re,
                             ndd_im, power, sr, si, [bar] { group_sync(bar); });
  }
}

template <int CYC, bool TM, int FSZ>
int launch(const void* pcm, const void* tail_re, const void* tail_im,
           const void* p0_re, const void* p0_im, const void* dd_re,
           const void* dd_im, void* zr, void* zi, void* index, void* ndd_re,
           void* ndd_im, void* power, void* nph_re, void* nph_im,
           void* ntail_re, void* ntail_im, int C, int F, int fsz, int ntaps,
           int blocks, const Taps& taps, double omega, float gain,
           float inv_scale, void* stream) {
  auto kernel = frontend_kernel_pipe<CYC, TM, FSZ>;
  const int bytes = PipeLayout(fsz, CYC).bytes;
  const cudaError_t err = allow_smem((const void*)kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, PNT, bytes, (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const float*)tail_re, (const float*)tail_im,
      (const float*)p0_re, (const float*)p0_im, (const float*)dd_re,
      (const float*)dd_im, (float*)zr, (float*)zi, (int32_t*)index,
      (float*)ndd_re, (float*)ndd_im, (float*)power, (float*)nph_re,
      (float*)nph_im, (float*)ntail_re, (float*)ntail_im, C, F, fsz,
      ntaps - 1, taps, omega, gain, inv_scale);
  return (int)cudaGetLastError();
}

// the geometry both launches take: 2, 4 or 8 samples per symbol, odd
// ntaps <= 129, frames of a multiple of 128 samples up to PIPE_MAX_FRAME
// (with a power output, a power of two of symbols), at least one frame
// and channel, and from 1 to one block a tile
bool covered(int C, int F, int fsz, int cycles, int ntaps, int blocks) {
  if (C < 1 || F < 1 || ntaps < 1 || ntaps > KT || ntaps % 2 == 0 ||
      fsz < 128 || fsz % 128 != 0 || fsz > PIPE_MAX_FRAME ||
      !(cycles == 2 || cycles == 4 || cycles == 8) ||
      PipeLayout(fsz, cycles).bytes > PIPE_MAX_BYTES)
    return false;
  const long long tiles = (long long)((C + CG - 1) / CG) * F;
  return blocks >= 1 && blocks <= tiles && tiles <= 0x7fffffffLL;
}

// ---------------------------------------------------------------------------
// The general instance, frontend_general_kernel<TM>: both launches (TM:
// the time-major one with the one-frame delay and the power output; else
// the channel-major one) at the geometries the pipeline above does not
// take and the TPU kernel's gate admits (qpsk_tpu/ops/pallas/
// frontend_kernel.py, frontend_supported): any samples per symbol CYC from
// 1 to 256 that divides the frame (3, 6 or 16 at a custom rs), any frame of
// a multiple of 128 samples with no cap (2048 samples at 2 samples per
// symbol, 4096 and more), any odd ntaps <= 129, and the AGC power output at
// any number of symbols a frame (384 at a 1536-sample frame): the halves
// pairing of ops/agc.py::_frame_power while the count is even, then its
// odd residue summed in order, then times float32(1/NSYM).  It computes
// what the pipeline above computes (the file's header has the formulas).
//
// What bounds it on the H100: as above, the FIR's arithmetic, 129 complex
// taps a sample.  The instance it replaced ran the FIR on the CUDA cores,
// one thread an output, and was bound by the shared-memory loads of that
// (three 4-byte loads for two multiply-adds a tap: 0.53 ms at 256 channels
// x 8 frames of 4096 samples, 39x its bound).  Here the FIR runs on the
// tensor cores (band_fragments, band_rows: mma.sync m16n8k16, float16 hi
// + lo, three passes), over rows of 8 channels, and what ties the
// pipeline to its geometries is done at run time:
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

// The two entries take one argument list.  ``tm`` 1: the time-major launch
// with the one-frame delay (dd_*, ndd_*) and, if ``power`` is not null, the
// power output; 0: the channel-major launch, the picks in zr/zi, the
// delay's and the power's pointers null.  Both read the carried
// mixed-domain tail (C, ntaps-1) and phase (C,) and write the new ones
// beside the picks.

// The pipeline, on ``blocks`` persistent blocks (one an SM, at most one a
// tile of 8 channels x a frame); ``scratch`` is not read.
extern "C" int qpsk_frontend_pipe(const void* pcm, const void* tail_re,
                                  const void* tail_im, const void* p0_re,
                                  const void* p0_im, const void* dd_re,
                                  const void* dd_im, void* zr, void* zi,
                                  void* index, void* ndd_re, void* ndd_im,
                                  void* power, void* scratch, void* nph_re,
                                  void* nph_im, void* ntail_re,
                                  void* ntail_im, int C, int F, int fsz,
                                  int cycles, int ntaps, int tm, int blocks,
                                  const void* taps_re, const void* taps_im,
                                  double omega, float gain, float inv_scale,
                                  void* stream) {
  if (!covered(C, F, fsz, cycles, ntaps, blocks))
    return (int)cudaErrorInvalidValue;
  const bool d = fsz == 512;
  const auto run =
      tm ? (cycles == 2 ? (d ? launch<2, true, 512> : launch<2, true, 0>)
            : cycles == 4 ? (d ? launch<4, true, 512> : launch<4, true, 0>)
                          : (d ? launch<8, true, 512> : launch<8, true, 0>))
         : (cycles == 2 ? (d ? launch<2, false, 512> : launch<2, false, 0>)
            : cycles == 4 ? (d ? launch<4, false, 512> : launch<4, false, 0>)
                          : (d ? launch<8, false, 512> : launch<8, false, 0>));
  return run(pcm, tail_re, tail_im, p0_re, p0_im, dd_re, dd_im, zr, zi, index,
             ndd_re, ndd_im, power, nph_re, nph_im, ntail_re, ntail_im, C, F,
             fsz, ntaps, blocks, pad_taps(taps_re, taps_im, ntaps), omega,
             gain, inv_scale, stream);
}

// The general instance, one block a tile (``blocks`` is not read); with
// the power output its tree runs in ``scratch``, (C, F, fsz/cycles)
// float32, past GSQ symbols a frame.  Takes any cycles in 1..256 dividing
// fsz, fsz a multiple of 128, odd ntaps <= 129.
extern "C" int qpsk_frontend_gen(const void* pcm, const void* tail_re,
                                 const void* tail_im, const void* p0_re,
                                 const void* p0_im, const void* dd_re,
                                 const void* dd_im, void* zr, void* zi,
                                 void* index, void* ndd_re, void* ndd_im,
                                 void* power, void* scratch, void* nph_re,
                                 void* nph_im, void* ntail_re, void* ntail_im,
                                 int C, int F, int fsz, int cycles, int ntaps,
                                 int tm, int blocks, const void* taps_re,
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
  const cudaError_t err = allow_smem((const void*)kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)((C + CG - 1) / CG) * F;
  kernel<<<(unsigned)grid, GNT, bytes, (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const float*)tail_re, (const float*)tail_im,
      (const float*)p0_re, (const float*)p0_im, (const float*)dd_re,
      (const float*)dd_im, (float*)zr, (float*)zi, (int32_t*)index,
      (float*)ndd_re, (float*)ndd_im, (float*)power, (float*)scratch,
      (float*)nph_re, (float*)nph_im, (float*)ntail_re, (float*)ntail_im, C,
      F, fsz, cycles, ntaps - 1, resident ? 1 : 0,
      pad_taps(taps_re, taps_im, ntaps), omega, gain, inv_scale);
  return (int)cudaGetLastError();
}
