// Soft-decision Viterbi decoder for Hopper (sm_90a): the K=7 rate-1/2
// code, 64 states, one warp per packet.
//
// Replaces: qpsk_tpu/ops/pallas/viterbi_kernel.py, _fwd_kernel + _bwd_kernel
// launched by _viterbi_2d (entry viterbi_decode_pallas).  The TPU layout
// (states on sublanes, batch on 128 lanes, bf16 0/1 decision planes, time
// padded with inert zero-LLR steps) exists because the TPU has no cheap
// gather; this kernel is designed for the warp instead:
//
//   - lane l holds the path metrics of states 2l and 2l+1.  Both states
//     have the predecessors l and 32+l (pred(s', p) = p*32 + (s' >> 1)),
//     which four __shfl_sync fetch from lanes l>>1 and 16+(l>>1);
//   - the 64 decisions of a step are two __ballot_sync words (bit l of
//     the first is state 2l, of the second state 2l+1), 8 bytes per step
//     and packet where the TPU stores 128 bytes of bf16.  Lane t%32 keeps
//     step t's pair and the warp stores 32 steps with one coalesced store;
//   - the per-step maximum is a 5-step xor-shuffle reduction (max is
//     exact, so the order does not matter);
//   - the traceback reads 32 steps of decision words per coalesced load
//     and walks them from state 0 at t = nsteps-1 with a uniform shuffle
//     per step; lane t%32 keeps step t's bit for one coalesced store.
//   Any nsteps and any batch size work with no padding.
//
// Bit-identity with the plain PyTorch version (and through it the JAX
// scan, packet/fec.py): the same -1e9 start metrics, bm = 0.5f*(g0*l0 +
// g1*l1), strict c1 > c0, and pm - max(pm) after every step.  g*l is exact
// (g = +-1), so FMA contraction of bm rounds exactly as the separate add
// does, and so is the 0.5f scaling, so contracting it into the add of the
// predecessor metric is harmless too; every other operation is a single
// add, compare or max, which rounds the same in both.  Built without
// --use_fast_math.
//
// What bounds it on the H100: per step and packet the forward pass is a
// chain of about 12 shuffles and 20 ALU instructions, so a warp advances
// one step per few hundred cycles of shuffle latency; the design relies on
// many packets (warps) in flight to hide it.  Memory traffic is small:
// 8 bytes of LLRs in and 8 bytes of decisions out and back per step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;              // packets per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
viterbi_kernel(const float* __restrict__ llrs, const float* __restrict__ sgn,
               uint2* __restrict__ dec, int32_t* __restrict__ bits, int B,
               int nsteps, int nbits) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together

  // sgn is the (2 outputs, 64 states, 2 predecessors) sign table;
  // g[q][j][p] belongs to state 2*lane + q
  float g[2][2][2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        g[q][j][p] = sgn[(j * 64 + 2 * lane + q) * 2 + p];

  float pm0 = lane == 0 ? 0.f : -1e9f;  // state 2*lane
  float pm1 = -1e9f;                    // state 2*lane + 1
  const float* ll = llrs + (long long)b * 2 * nsteps;
  uint2* d = dec + (long long)b * nsteps;
  const int src_lo = lane >> 1, src_hi = 16 + (lane >> 1);
  const bool odd = lane & 1;
  float lv = 0.f;
  uint2 mine = make_uint2(0u, 0u);

  for (int t = 0; t < nsteps; ++t) {
    const int k = t & 15;
    if (k == 0) {  // the next 16 steps' 32 LLRs, one per lane
      const int i = 2 * t + lane;
      lv = i < 2 * nsteps ? ll[i] : 0.f;
    }
    const float l0 = __shfl_sync(FULL, lv, 2 * k);
    const float l1 = __shfl_sync(FULL, lv, 2 * k + 1);
    const float a0 = __shfl_sync(FULL, pm0, src_lo);
    const float a1 = __shfl_sync(FULL, pm1, src_lo);
    const float c0 = __shfl_sync(FULL, pm0, src_hi);
    const float c1 = __shfl_sync(FULL, pm1, src_hi);
    const float p0 = odd ? a1 : a0;  // pm[lane]
    const float p1 = odd ? c1 : c0;  // pm[32 + lane]

    const float x0 = p0 + 0.5f * (g[0][0][0] * l0 + g[0][1][0] * l1);
    const float x1 = p1 + 0.5f * (g[0][0][1] * l0 + g[0][1][1] * l1);
    const float y0 = p0 + 0.5f * (g[1][0][0] * l0 + g[1][1][0] * l1);
    const float y1 = p1 + 0.5f * (g[1][0][1] * l0 + g[1][1][1] * l1);
    const bool d0 = x1 > x0, d1 = y1 > y0;
    const float n0 = d0 ? x1 : x0, n1 = d1 ? y1 : y0;
    float mx = fmaxf(n0, n1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    pm0 = n0 - mx;
    pm1 = n1 - mx;

    const unsigned w0 = __ballot_sync(FULL, d0);
    const unsigned w1 = __ballot_sync(FULL, d1);
    if (lane == (t & 31)) mine = make_uint2(w0, w1);
    if ((t & 31) == 31 || t == nsteps - 1) {
      const int t0 = t & ~31;
      if (t0 + lane <= t) d[t0 + lane] = mine;
    }
  }
  __syncwarp();  // the lanes' decision stores are visible to the warp

  int s = 0;  // tail-terminated: the encoder ends in state 0
  int32_t* out = bits + (long long)b * nbits;
  for (int t0 = (nsteps - 1) & ~31; t0 >= 0; t0 -= 32) {
    uint2 w = make_uint2(0u, 0u);
    if (t0 + lane < nsteps) w = d[t0 + lane];
    int u = 0;
    const int last = min(31, nsteps - 1 - t0);
    for (int k = last; k >= 0; --k) {
      const unsigned wx = __shfl_sync(FULL, w.x, k);
      const unsigned wy = __shfl_sync(FULL, w.y, k);
      if (lane == k) u = s & 1;  // the state's LSB is the consumed bit
      const unsigned word = (s & 1) ? wy : wx;
      s = (s >> 1) | ((int)((word >> (s >> 1)) & 1u) << 5);
    }
    if (t0 + lane < nbits) out[t0 + lane] = u;
  }
}

}  // namespace

extern "C" int qpsk_viterbi(const void* llrs, const void* sgn, void* dec,
                            void* bits, int B, int nsteps, int nbits,
                            void* stream) {
  viterbi_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                   (cudaStream_t)stream>>>(
      (const float*)llrs, (const float*)sgn, (uint2*)dec, (int32_t*)bits, B,
      nsteps, nbits);
  return (int)cudaGetLastError();
}
