// Costas-loop kernel for Hopper (sm_90a).
//
// Replaces: qpsk_tpu/ops/pallas/costas_kernel.py, _kernel launched by
// _costas_pallas_tc (entries costas_run_pallas_tm, costas_run_pallas_traced)
// with the QPSK sign detector, emit_bits and trace_every, and its gear and
// gains modes; not its decision-directed detector (dd, emit_label).
//
// What it computes, per channel, in series over the T symbols of the
// time-major (T, C) input:
//   gains mode: z *= g[t / nsf], one multiply per plane, the frame-rate AGC
//       gain of the symbol's frame ((T/nsf, C) input);
//   out = z * e^{-j*phase};  err = sign+(Re out)*Im out - sign+(Im out)*Re out;
//   gear mode: errn = |err| / ((|Re out| + |Im out|) + 1e-9);
//       lev += gamma*(errn - lev);  locked = 1 if lev < enter, 0 if
//       lev > exit, else unchanged;  (alpha, beta) = the tracking gains
//       while locked, the acquisition gains otherwise;
//   freq += beta*err;  phase = (phase + freq) + alpha*err;
//   phase wrapped to +-TAU by two conditional subtractions each way;
//   freq clamped to [min_freq, max_freq].
// It writes the derotated (T, C) planes, the diagonal slicer's dibits of the
// STORED derotation packed 16 symbols per int32 word ((T/16, C), symbol
// t at bits 2*(t%16) with b1 = Im<0 in the low bit, the layout of
// unpack_bits_tm), the loop frequency after every trace_every-th symbol
// ((T/trace_every, C)) and the final phase, frequency and (gear mode)
// lock level and gear.
//
// The op order is that of qpsk_tpu/ops/costas.py (and of the plain
// PyTorch loop beside this kernel): every multiply, add and the division
// of errn is a round-to-nearest intrinsic, so nvcc cannot contract them
// into FMAs, and cosf/sinf are the precise library functions PyTorch's own
// cos/sin call.  gamma is a power of two, so gamma*(errn - lev) is exact.
// Bit-identity matters most in gear mode: a lock level one ulp off moves a
// gear change by a symbol and the two trajectories part from there.
//
// What bounds it on the H100: the serial dependence.  Each step waits on
// the previous step's phase through cosf/sinf and about 15 dependent float
// ops (about 25 with the gear's divide), so a channel advances one symbol
// per few hundred cycles, while its memory traffic (8 bytes in, 8.25 bytes
// out per symbol) is coalesced across the channels of a warp (thread =
// channel, (T, C) rows).  The design therefore puts one channel on one
// thread with the state in registers and relies on many channels in flight
// to hide the latency.  The gain multiply sits off the chain: its load and
// product do not depend on the loop state.  Occupancy is the first thing a
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

template <bool GEAR, bool GAINS>
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
                 int nsf, const LoopParams lp) {
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
    word |= (uint32_t)((q < 0.f ? 1 : 0) | (r < 0.f ? 2 : 0)) << (2 * (t & 15));
    if ((t & 15) == 15) {
      packed[(long long)(t >> 4) * C + c] = (int32_t)word;
      word = 0;
    }
    const float sr = r > 0.f ? 1.f : -1.f;
    const float si = q > 0.f ? 1.f : -1.f;
    const float err = __fsub_rn(__fmul_rn(sr, q), __fmul_rn(si, r));
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

template <bool GEAR, bool GAINS>
int launch(const void* zr, const void* zi, const void* phase0,
           const void* freq0, const void* lev0, const void* locked0,
           const void* gains, void* outr, void* outi, void* ftrace,
           void* phase_out, void* freq_out, void* lev_out, void* locked_out,
           void* packed, int T, int C, int trace_every, int nsf,
           const LoopParams& lp, void* stream) {
  costas_tm_kernel<GEAR, GAINS><<<(C + THREADS - 1) / THREADS, THREADS, 0,
                                  (cudaStream_t)stream>>>(
      (const float*)zr, (const float*)zi, (const float*)phase0,
      (const float*)freq0, (const float*)lev0, (const float*)locked0,
      (const float*)gains, (float*)outr, (float*)outi, (float*)ftrace,
      (float*)phase_out, (float*)freq_out, (float*)lev_out,
      (float*)locked_out, (int32_t*)packed, T, C, trace_every, nsf, lp);
  return (int)cudaGetLastError();
}

}  // namespace

// ``params`` is a host array of 9 floats: alpha, beta, min_freq, max_freq,
// alpha_trk, beta_trk, gamma, enter, exit.  Gear mode runs when ``lev0`` is
// not null (then ``locked0``, ``lev_out`` and ``locked_out`` are set too);
// gains mode when ``gains`` is not null, with ``nsf`` symbols per gain row.
extern "C" int qpsk_costas_tm(const void* zr, const void* zi,
                              const void* phase0, const void* freq0,
                              const void* lev0, const void* locked0,
                              const void* gains, void* outr, void* outi,
                              void* ftrace, void* phase_out, void* freq_out,
                              void* lev_out, void* locked_out, void* packed,
                              int T, int C, int trace_every, int nsf,
                              const void* params, void* stream) {
  const float* p = static_cast<const float*>(params);
  const LoopParams lp{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
  const bool gear = lev0 != nullptr, g = gains != nullptr;
  auto run = gear ? (g ? launch<true, true> : launch<true, false>)
                  : (g ? launch<false, true> : launch<false, false>);
  return run(zr, zi, phase0, freq0, lev0, locked0, gains, outr, outi, ftrace,
             phase_out, freq_out, lev_out, locked_out, packed, T, C,
             trace_every, nsf, lp, stream);
}
