// Costas-loop kernel for Hopper (sm_90a).
//
// Replaces: qpsk_tpu/ops/pallas/costas_kernel.py, _kernel launched by
// _costas_pallas_tc (entries costas_run_pallas_tm, costas_run_pallas_traced)
// with the QPSK sign detector, emit_bits and trace_every, and its gear,
// gains and decision-directed (dd, emit_label) modes.
//
// What it computes, per channel, in series over the T symbols of the
// time-major (T, C) input:
//   gains mode: z *= g[t / nsf], one multiply per plane, the frame-rate AGC
//       gain of the symbol's frame ((T/nsf, C) input);
//   out = z * e^{-j*phase};  err = sign+(Re out)*Im out - sign+(Im out)*Re out;
//   dd mode (BPSK, 8PSK, 16QAM; the program of qpsk_tpu/ops/modfam.py
//       dd_err_ops): exact comparisons on (Re out, Im out) decide the Gray
//       label and select float32 constants (cr, ci, ic2) from the host's
//       modfam.dd_constants vector; err = (Im out*cr - Re out*ci) * ic2;
//   gear mode: errn = |err| / ((|Re out| + |Im out|) + 1e-9);
//       lev += gamma*(errn - lev);  locked = 1 if lev < enter, 0 if
//       lev > exit, else unchanged;  (alpha, beta) = the tracking gains
//       while locked, the acquisition gains otherwise;
//   freq += beta*err;  phase = (phase + freq) + alpha*err;
//   phase wrapped to +-TAU by two conditional subtractions each way;
//   freq clamped to [min_freq, max_freq].
// It writes the derotated (T, C) planes, the slicer's decisions of the
// STORED derotation -- QPSK: the diagonal slicer's dibits packed 16
// symbols per int32 word ((T/16, C), symbol t at bits 2*(t%16) with
// b1 = Im<0 in the low bit, the layout of unpack_bits_tm); dd: the 4-bit
// Gray labels the detector decided, 8 per word ((T/8, C), symbol t at
// bits 4*(t%8), the layout of unpack_labels_tm) -- the loop frequency after
// every trace_every-th symbol ((T/trace_every, C)) and the final phase,
// frequency and (gear mode) lock level and gear.
//
// The op order is that of qpsk_tpu/ops/costas.py (and of the plain
// PyTorch loop beside this kernel): every multiply, add and the division
// of errn is a round-to-nearest intrinsic, so nvcc cannot contract them
// into FMAs, and cosf/sinf are the precise library functions PyTorch's own
// cos/sin call.  gamma is a power of two, so gamma*(errn - lev) is exact.
// Bit-identity matters most in gear mode: a lock level one ulp off moves a
// gear change by a symbol and the two trajectories part from there; and in
// dd mode, where the error's products are not by +-1 as QPSK's are, so a
// contracted (u - v) would round differently from step one.  The dd
// constants are a by-value struct read at indices the comparison tree
// fixes at compile time, and a __grid_constant__ kernel parameter, so they
// are read from the parameter bank and never copied to local memory.
//
// What bounds it on the H100: the serial dependence.  Each step waits on
// the previous step's phase through cosf/sinf and about 15 dependent float
// ops (about 25 with the gear's divide), so a channel advances one symbol
// per few hundred cycles, while its memory traffic (8 bytes in, 8.25 bytes
// out per symbol) is coalesced across the channels of a warp (thread =
// channel, (T, C) rows).  The design therefore puts one channel on one
// thread with the state in registers and relies on many channels in flight
// to hide the latency.  The gain multiply sits off the chain: its load and
// product do not depend on the loop state.  The dd detectors put their
// comparisons and selects on the chain in place of QPSK's two signs
// (8PSK's select tree, 16QAM's three) and write 0.5 byte of labels a
// symbol in place of 0.25 of dibits.  Occupancy is the first thing a
// later change should look at: at 8192 channels this launch is 64 blocks
// of 128 threads, under half of the 132 SMs, each SM running at most 4
// warps of the chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

struct LoopParams {
  float alpha, beta, min_freq, max_freq;        // acquisition gear, clamp
  float alpha_trk, beta_trk, gamma, enter, exit;  // gear mode only
};

// The phase detector (ops/cuda/costas_kernel.py _DETECTOR).
enum Detector { QPSK = 0, BPSK = 1, PSK8 = 2, QAM16 = 3 };

// modfam.dd_constants: [cre(M), cim(M), 1/|c|^2(M)] (+ the 16QAM axis
// threshold), at most 3*16 + 1 values.
struct DdConsts {
  float c[49];
};

// The dd error of derotated (r, q) and its Gray label: modfam.dd_err_ops,
// with the same exact comparisons and the products pinned.
template <int DET>
__device__ __forceinline__ float dd_error(float r, float q, const DdConsts& k,
                                          uint32_t& label) {
  float cr, ci, ic2;
  if constexpr (DET == BPSK) {          // M = 2: cre at 0..1, 1/|c|^2 at 4
    const bool neg = r < 0.f;
    cr = neg ? k.c[1] : k.c[0];
    ci = 0.f;                           // v = Re out * 0, as dd_err_ops
    ic2 = k.c[4];
    label = neg ? 1u : 0u;
  } else if constexpr (DET == PSK8) {   // M = 8: cre 0..7, cim 8..15, 16
    const bool s_im = q < 0.f, s_re = r < 0.f;
    const bool diag = fabsf(q) > fabsf(r);
    const int sector = (s_im ? 4 : 0) | (s_re ? 2 : 0);
    // pick(a, b) = diag ? c[base + a] : c[base + b] with (a, b) =
    // (2s+1, 2s) for sector s = (s_im, s_re), as the select tree of
    // dd_err_ops; written as a switch so every index is a constant
    switch (sector) {
      case 6: cr = diag ? k.c[7] : k.c[6]; ci = diag ? k.c[15] : k.c[14]; break;
      case 4: cr = diag ? k.c[5] : k.c[4]; ci = diag ? k.c[13] : k.c[12]; break;
      case 2: cr = diag ? k.c[3] : k.c[2]; ci = diag ? k.c[11] : k.c[10]; break;
      default: cr = diag ? k.c[1] : k.c[0]; ci = diag ? k.c[9] : k.c[8]; break;
    }
    label = (uint32_t)(sector | (diag ? 1 : 0));
    ic2 = k.c[16];
  } else {                              // QAM16, M = 16: threshold at 48
    const float thr = k.c[48];
    const bool neg_i = r < 0.f, far_i = fabsf(r) > thr;
    const bool neg_q = q < 0.f, far_q = fabsf(q) > thr;
    // level -> Gray axis label: -3 -> 0, -1 -> 1, +1 -> 3, +3 -> 2
    cr = neg_i ? (far_i ? k.c[0] : k.c[4]) : (far_i ? k.c[8] : k.c[12]);
    ci = neg_q ? (far_q ? k.c[16] : k.c[17]) : (far_q ? k.c[18] : k.c[19]);
    ic2 = far_i ? (far_q ? k.c[32] : k.c[33]) : (far_q ? k.c[36] : k.c[37]);
    const uint32_t gi = neg_i ? (far_i ? 0u : 1u) : (far_i ? 2u : 3u);
    const uint32_t gq = neg_q ? (far_q ? 0u : 1u) : (far_q ? 2u : 3u);
    label = (gi << 2) | gq;
  }
  const float u = __fmul_rn(q, cr), v = __fmul_rn(r, ci);
  return __fmul_rn(__fsub_rn(u, v), ic2);
}

template <int DET, bool GEAR, bool GAINS>
__global__ void __launch_bounds__(THREADS)
costas_tm_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                 const float* __restrict__ phase0,
                 const float* __restrict__ freq0,
                 const float* __restrict__ lev0,
                 const float* __restrict__ locked0,
                 const float* __restrict__ gains, float* __restrict__ outr,
                 float* __restrict__ outi, float* __restrict__ ftrace,
                 float* __restrict__ phase_out, float* __restrict__ freq_out,
                 float* __restrict__ lev_out, float* __restrict__ locked_out,
                 int32_t* __restrict__ packed, int T, int C, int trace_every,
                 int nsf, const LoopParams lp,
                 const __grid_constant__ DdConsts dd) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const float tau = 6.283185307179586f;
  float phase = phase0[c];
  float freq = freq0[c];
  float lev = GEAR ? lev0[c] : 0.f;
  float locked = GEAR ? locked0[c] : 0.f;
  uint32_t word = 0;
  for (int t = 0; t < T; ++t) {
    const long long o = (long long)t * C + c;
    float a = zr[o], b = zi[o];
    if (GAINS) {
      const float g = gains[(long long)(t / nsf) * C + c];
      a = __fmul_rn(a, g);
      b = __fmul_rn(b, g);
    }
    const float cs = cosf(phase), sn = sinf(phase);
    const float r = __fadd_rn(__fmul_rn(a, cs), __fmul_rn(b, sn));
    const float q = __fsub_rn(__fmul_rn(b, cs), __fmul_rn(a, sn));
    outr[o] = r;
    outi[o] = q;
    float err;
    if constexpr (DET == QPSK) {
      word |= (uint32_t)((q < 0.f ? 1 : 0) | (r < 0.f ? 2 : 0)) << (2 * (t & 15));
      if ((t & 15) == 15) {
        packed[(long long)(t >> 4) * C + c] = (int32_t)word;
        word = 0;
      }
      const float sr = r > 0.f ? 1.f : -1.f;
      const float si = q > 0.f ? 1.f : -1.f;
      err = __fsub_rn(__fmul_rn(sr, q), __fmul_rn(si, r));
    } else {
      uint32_t label;
      err = dd_error<DET>(r, q, dd, label);
      word |= label << (4 * (t & 7));
      if ((t & 7) == 7) {
        packed[(long long)(t >> 3) * C + c] = (int32_t)word;
        word = 0;
      }
    }
    float alpha = lp.alpha, beta = lp.beta;
    if (GEAR) {
      const float errn = __fdiv_rn(
          fabsf(err), __fadd_rn(__fadd_rn(fabsf(r), fabsf(q)), 1e-9f));
      lev = __fadd_rn(lev, __fmul_rn(lp.gamma, __fsub_rn(errn, lev)));
      locked = lev < lp.enter ? 1.f : (lev > lp.exit ? 0.f : locked);
      if (locked > 0.5f) {
        alpha = lp.alpha_trk;
        beta = lp.beta_trk;
      }
    }
    freq = __fadd_rn(freq, __fmul_rn(beta, err));
    phase = __fadd_rn(__fadd_rn(phase, freq), __fmul_rn(alpha, err));
    if (phase > tau) phase = __fsub_rn(phase, tau);
    if (phase > tau) phase = __fsub_rn(phase, tau);
    if (phase < -tau) phase = __fadd_rn(phase, tau);
    if (phase < -tau) phase = __fadd_rn(phase, tau);
    freq = fminf(fmaxf(freq, lp.min_freq), lp.max_freq);
    if ((t + 1) % trace_every == 0) {
      ftrace[(long long)(t / trace_every) * C + c] = freq;
    }
  }
  phase_out[c] = phase;
  freq_out[c] = freq;
  if (GEAR) {
    lev_out[c] = lev;
    locked_out[c] = locked;
  }
}

template <int DET, bool GEAR, bool GAINS>
int launch(const void* zr, const void* zi, const void* phase0,
           const void* freq0, const void* lev0, const void* locked0,
           const void* gains, void* outr, void* outi, void* ftrace,
           void* phase_out, void* freq_out, void* lev_out, void* locked_out,
           void* packed, int T, int C, int trace_every, int nsf,
           const LoopParams& lp, const DdConsts& dd, void* stream) {
  costas_tm_kernel<DET, GEAR, GAINS><<<(C + THREADS - 1) / THREADS, THREADS,
                                       0, (cudaStream_t)stream>>>(
      (const float*)zr, (const float*)zi, (const float*)phase0,
      (const float*)freq0, (const float*)lev0, (const float*)locked0,
      (const float*)gains, (float*)outr, (float*)outi, (float*)ftrace,
      (float*)phase_out, (float*)freq_out, (float*)lev_out,
      (float*)locked_out, (int32_t*)packed, T, C, trace_every, nsf, lp, dd);
  return (int)cudaGetLastError();
}

}  // namespace

// ``params`` is a host array of 9 floats: alpha, beta, min_freq, max_freq,
// alpha_trk, beta_trk, gamma, enter, exit.  Gear mode runs when ``lev0`` is
// not null (then ``locked0``, ``lev_out`` and ``locked_out`` are set too),
// with the QPSK detector only; gains mode when ``gains`` is not null, with
// ``nsf`` symbols per gain row.  ``det`` picks the detector (0 QPSK,
// 1 BPSK, 2 8PSK, 3 16QAM) and ``dd`` is a host array of 49 floats, the
// modfam.dd_constants of the dd modes.  ``packed`` holds (T/16, C) words
// for QPSK, (T/8, C) in the dd modes.  Returns a CUDA error code, or
// cudaErrorInvalidValue for gear with a dd detector or an unknown one.
extern "C" int qpsk_costas_tm(const void* zr, const void* zi,
                              const void* phase0, const void* freq0,
                              const void* lev0, const void* locked0,
                              const void* gains, void* outr, void* outi,
                              void* ftrace, void* phase_out, void* freq_out,
                              void* lev_out, void* locked_out, void* packed,
                              int T, int C, int trace_every, int nsf, int det,
                              const void* params, const void* dd,
                              void* stream) {
  const float* p = static_cast<const float*>(params);
  const LoopParams lp{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
  DdConsts k;
  const float* d = static_cast<const float*>(dd);
  for (int i = 0; i < 49; ++i) k.c[i] = d[i];
  const bool gear = lev0 != nullptr, g = gains != nullptr;
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, const void*, void*, void*,
                         void*, void*, void*, void*, void*, void*, int, int,
                         int, int, const LoopParams&, const DdConsts&, void*);
  Launch run = nullptr;
  switch (det) {
    case QPSK:
      run = gear ? (g ? launch<QPSK, true, true> : launch<QPSK, true, false>)
                 : (g ? launch<QPSK, false, true> : launch<QPSK, false, false>);
      break;
    case BPSK:
      run = g ? launch<BPSK, false, true> : launch<BPSK, false, false>;
      break;
    case PSK8:
      run = g ? launch<PSK8, false, true> : launch<PSK8, false, false>;
      break;
    case QAM16:
      run = g ? launch<QAM16, false, true> : launch<QAM16, false, false>;
      break;
  }
  if (run == nullptr || (gear && det != QPSK)) {
    return (int)cudaErrorInvalidValue;
  }
  return run(zr, zi, phase0, freq0, lev0, locked0, gains, outr, outi, ftrace,
             phase_out, freq_out, lev_out, locked_out, packed, T, C,
             trace_every, nsf, lp, k, stream);
}
