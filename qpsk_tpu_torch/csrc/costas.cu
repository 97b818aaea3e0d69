// Costas-loop kernel for Hopper (sm_90a).
//
// Replaces: qpsk_tpu/ops/pallas/costas_kernel.py, _kernel launched by
// _costas_pallas_tc (entry costas_run_pallas_tm), in the slice's mode:
// QPSK sign detector, emit_bits, trace_every; no gear shift, no
// decision-directed detector, no AGC gains.
//
// What it computes, per channel, in series over the T symbols of the
// time-major (T, C) input:
//   out = z * e^{-j*phase};  err = sign+(Re out)*Im out - sign+(Im out)*Re out;
//   freq += beta*err;  phase = (phase + freq) + alpha*err;
//   phase wrapped to +-TAU by two conditional subtractions each way;
//   freq clamped to [min_freq, max_freq].
// It writes the derotated (T, C) planes, the diagonal slicer's dibits of the
// STORED derotation packed 16 symbols per int32 word ((T/16, C), symbol
// t at bits 2*(t%16) with b1 = Im<0 in the low bit, the layout of
// unpack_bits_tm), the loop frequency after every trace_every-th symbol
// ((T/trace_every, C)) and the final phase and frequency.
//
// The op order is that of qpsk_tpu/ops/costas.py (and of the plain
// PyTorch loop beside this kernel): every multiply and add is a
// round-to-nearest intrinsic, so nvcc cannot contract them into FMAs, and
// cosf/sinf are the precise library functions PyTorch's own cos/sin call.
//
// What bounds it on the H100: the serial dependence.  Each step waits on
// the previous step's phase through cosf/sinf and about 15 dependent float
// ops, so a channel advances one symbol per few hundred cycles, while its
// memory traffic (8 bytes in, 8.25 bytes out per symbol) is coalesced
// across the channels of a warp (thread = channel, (T, C) rows).  The
// design therefore puts one channel on one thread with the state in
// registers and relies on many channels in flight to hide the latency.
// Occupancy is the first thing a later change should look at: at 8192
// channels this launch is 64 blocks of 128 threads, under half of the
// 132 SMs, each SM running at most 4 warps of the chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
costas_tm_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                 const float* __restrict__ phase0,
                 const float* __restrict__ freq0, float* __restrict__ outr,
                 float* __restrict__ outi, float* __restrict__ ftrace,
                 float* __restrict__ phase_out, float* __restrict__ freq_out,
                 int32_t* __restrict__ packed, int T, int C, int trace_every,
                 float alpha, float beta, float min_freq, float max_freq) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const float tau = 6.283185307179586f;
  float phase = phase0[c];
  float freq = freq0[c];
  uint32_t word = 0;
  for (int t = 0; t < T; ++t) {
    const long long o = (long long)t * C + c;
    const float a = zr[o], b = zi[o];
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
    freq = __fadd_rn(freq, __fmul_rn(beta, err));
    phase = __fadd_rn(__fadd_rn(phase, freq), __fmul_rn(alpha, err));
    if (phase > tau) phase = __fsub_rn(phase, tau);
    if (phase > tau) phase = __fsub_rn(phase, tau);
    if (phase < -tau) phase = __fadd_rn(phase, tau);
    if (phase < -tau) phase = __fadd_rn(phase, tau);
    freq = fminf(fmaxf(freq, min_freq), max_freq);
    if ((t + 1) % trace_every == 0) {
      ftrace[(long long)(t / trace_every) * C + c] = freq;
    }
  }
  phase_out[c] = phase;
  freq_out[c] = freq;
}

}  // namespace

extern "C" int qpsk_costas_tm(const void* zr, const void* zi,
                              const void* phase0, const void* freq0,
                              void* outr, void* outi, void* ftrace,
                              void* phase_out, void* freq_out, void* packed,
                              int T, int C, int trace_every, float alpha,
                              float beta, float min_freq, float max_freq,
                              void* stream) {
  costas_tm_kernel<<<(C + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const float*)zr, (const float*)zi, (const float*)phase0,
      (const float*)freq0, (float*)outr, (float*)outi, (float*)ftrace,
      (float*)phase_out, (float*)freq_out, (int32_t*)packed, T, C,
      trace_every, alpha, beta, min_freq, max_freq);
  return (int)cudaGetLastError();
}
