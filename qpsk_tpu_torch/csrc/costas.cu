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
//       gain of the symbol's frame ((ceil(T/nsf), C) input);
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
// It writes the derotated (T, C) planes, the decided bits as the (C, BPS*T)
// int32 array the wrapper returns -- QPSK: modmap.demod_bits of the STORED
// derotation, (Im < 0, Re < 0) per symbol; dd: the Gray label the detector
// decided, MSB first (modfam.labels_to_bits) -- the loop frequency after
// every trace_every-th symbol ((T/trace_every, C)) and the final phase,
// frequency and (gear mode) lock level and gear.  Any T >= 1 works.
//
// The op order is that of qpsk_tpu/ops/costas.py (and of the plain
// PyTorch loop beside this kernel): every multiply, add and the division
// of errn is a round-to-nearest intrinsic, so nvcc cannot contract them
// into FMAs, and the sine and cosine are the precise library functions
// PyTorch's own cos/sin call (one sincosf; chip_smoke.py checks it against
// torch.cos/torch.sin on every float of magnitude <= 8).  gamma is a power
// of two, so gamma*(errn - lev) is exact.  Bit-identity matters most in
// gear mode (a lock level one ulp off moves a gear change by a symbol and
// the trajectories part from there) and in dd mode (the error's products
// are not by +-1).  The dd constants are a __grid_constant__ by-value
// struct, copied once into registers that the comparison tree selects
// among at compile-time indices.
//
// What bounds it on the H100: the serial dependence, a step's chain of
// sincosf (range reduction and two polynomials) and about 15 dependent
// pinned float operations (25 with the gear's divide): a channel advances
// one symbol per chain latency, whatever the occupancy.  Memory (8 bytes in,
// 8 + 4*BPS bytes out a symbol) is far below the card's rate.  With one or
// two warps an SM nothing else hides a cycle the warp spends off the
// chain, so the design keeps everything but the chain off the chain:
//   * one warp a block, one channel a lane (32 channels a block: 256 blocks
//     for 8192 channels spread over the 132 SMs);
//   * the inputs (zr, zi and the gain rows) arrive in tiles of S = 32
//     symbols by cp.async into a double buffer in shared memory, the next
//     tile in flight while the current one runs, so a step reads shared
//     memory only; a lane copies and reads its own channel's column, so
//     cp.async.wait_group needs no barrier (a dead lane copies nothing and
//     reads zeros).  A tile's copies are issued together at its start,
//     one straight line of predicated copies (issued a symbol a step into
//     a third buffer, they measured slower);
//   * the derotated symbols leave as one 128-byte row of the warp's 32
//     channels a step (stores do not wait), the trace likewise; the trace
//     and gain rows advance by countdowns, not divisions;
//   * each lane keeps its channel's next bits in a register (a symbol's
//     BPS bits in output order) and, when they fill one, stores a 16-byte
//     chunk of its own (C, BPS*T) row straight from it (``BitWriter``): no
//     shared memory, no hand-off between lanes, nothing after a tile; the
//     wrapper launches this one kernel and runs no unpack;
//   * the 8PSK detector selects its constants without a branch (a switch
//     on the sector diverged within a warp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CB = 32;                   // channels a block (one warp)
constexpr int S = 32;                    // symbols a tile

struct LoopParams {
  float alpha, beta, min_freq, max_freq;        // acquisition gear, clamp
  float alpha_trk, beta_trk, gamma, enter, exit;  // gear mode only
};

// The phase detector (ops/cuda/costas_kernel.py _DETECTOR).
enum Detector { QPSK = 0, BPSK = 1, PSK8 = 2, QAM16 = 3 };

template <int DET>
__host__ __device__ constexpr int bits_per_symbol() {
  return DET == QPSK ? 2 : DET == BPSK ? 1 : DET == PSK8 ? 3 : 4;
}

// modfam.dd_constants: [cre(M), cim(M), 1/|c|^2(M)] (+ the 16QAM axis
// threshold), at most 3*16 + 1 values.
struct DdConsts {
  float c[49];
};

// The detector's constants in registers, copied once through an opaque
// move: read from the parameter bank inside the select trees, nvcc turned
// the selects into branches and a lane-indexed constant load, which a warp
// serialises over its distinct indices.
struct DdRegs {
  float c[49];
};

__device__ __forceinline__ float opaque(float v) {
  float r;
  asm("mov.b32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ DdRegs dd_regs(const DdConsts& k) {
  DdRegs out;                 // the entries a detector does not read are dead
#pragma unroll
  for (int i = 0; i < 49; ++i) out.c[i] = opaque(k.c[i]);
  return out;
}

// The dd error of derotated (r, q) and its Gray label: modfam.dd_err_ops,
// with the same exact comparisons and the products pinned.
template <int DET>
__device__ __forceinline__ float dd_error(float r, float q, const DdRegs& k,
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
    // c[base + sector + diag], as the select tree of dd_err_ops, written
    // as selects on compile-time indices: a switch on the sector would
    // diverge within a warp
    cr = s_im ? (s_re ? (diag ? k.c[7] : k.c[6]) : (diag ? k.c[5] : k.c[4]))
              : (s_re ? (diag ? k.c[3] : k.c[2]) : (diag ? k.c[1] : k.c[0]));
    ci = s_im ? (s_re ? (diag ? k.c[15] : k.c[14]) : (diag ? k.c[13] : k.c[12]))
              : (s_re ? (diag ? k.c[11] : k.c[10]) : (diag ? k.c[9] : k.c[8]));
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

// a 4-byte copy into shared memory, issued where ``on``: a predicate in
// the instruction, not a branch around it, so a tile's copies issue as
// one straight line
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool on) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(d),
      "l"(src), "r"((int)on));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One tile of inputs in shared memory: [S][CB] planes and the gain rows
// g0 .. g0 + rows - 1, double-buffered: what one warp owns.  A tile's S
// symbols meet at most S rows: rows = floor((t0 + n - 1) / nsf) -
// floor(t0 / nsf) + 1 <= n for any nsf >= 1.
struct WarpSmem {
  float zr[2][S][CB];
  float zi[2][S][CB];
  float g[2][S][CB];
};

// Issue the copies of tile ``k`` (symbols k*S ..) of this lane's channel,
// where ``on`` (a dead lane copies nothing): a predicated copy for each
// slot of the tile, unrolled, so the issue is one straight line.
template <bool GAINS>
__device__ __forceinline__ void load_tile(WarpSmem& w, int b, const float* zr,
                                          const float* zi, const float* gains,
                                          int k, int T, int C, int nsf, int c,
                                          int lane, bool on) {
  const int t0 = k * S;
  const int n = min(S, T - t0);
  const float* pr = zr + (long long)t0 * C + c;
  const float* pi = zi + (long long)t0 * C + c;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    cp_async4(&w.zr[b][j][lane], pr + (long long)j * C, on && j < n);
    cp_async4(&w.zi[b][j][lane], pi + (long long)j * C, on && j < n);
  }
  if (GAINS) {
    const int g0 = t0 / nsf, rows = (t0 + n - 1) / nsf - g0 + 1;
    const float* pg = gains + (long long)g0 * C + c;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      cp_async4(&w.g[b][r][lane], pg + (long long)r * C, on && r < rows);
    }
  }
  cp_async_commit();
}

// One lane's bits, stored from registers into its channel's row of the
// (C, BPS*T) int32 output.  The row is cut into the 16-byte chunks of the
// address space: ``q`` is the first element of the chunk being filled,
// ``pend`` its bits from element q on, ``np`` how many of them it holds.
// A row that starts inside a chunk starts at q = -(elements of the chunk
// before it), and that first chunk is kept in ``head`` and stored after
// the last step; every other whole chunk is one 16-byte store, predicated,
// so ``put`` is a straight line; ``finish`` stores the head and the last,
// cut chunk element by element.  A dead lane (``nbits`` 0) stores nothing.
struct BitWriter {
  int32_t* row;
  int nbits, a, q, np;
  uint32_t pend, head;

  __device__ __forceinline__ BitWriter(int32_t* r, int n)
      : row(r), nbits(n), pend(0), head(0) {
    a = (int)(((uintptr_t)r >> 2) & 3);   // elements before r in its chunk
    q = -a;
    np = a;
  }

  // a symbol's ``bps`` bits, the first in bit 0
  __device__ __forceinline__ void put(uint32_t v, int bps) {
    pend |= v << np;
    np += bps;
    const bool full = np >= 4;
    // a whole chunk from q >= 0 holds bits of the row only
    if (full && q >= 0 && nbits > 0) {
      *reinterpret_cast<int4*>(row + q) =
          make_int4((int)(pend & 1u), (int)((pend >> 1) & 1u),
                    (int)((pend >> 2) & 1u), (int)((pend >> 3) & 1u));
    }
    head = full && q < 0 ? pend : head;
    pend = full ? pend >> 4 : pend;
    np = full ? np - 4 : np;
    q = full ? q + 4 : q;
  }

  // elements q0 + j, j < m, of ``bits`` (bit j), those inside the row
  __device__ __forceinline__ void store_part(int q0, uint32_t bits, int m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < m && q0 + j >= 0 && q0 + j < nbits) {
        row[q0 + j] = (int32_t)((bits >> j) & 1u);
      }
    }
  }

  __device__ __forceinline__ void finish() {
    if (a > 0 && q > -a) store_part(-a, head, 4);   // the head was filled
    store_part(q, pend, np);
  }
};

template <int DET, bool GEAR, bool GAINS>
__global__ void __launch_bounds__(CB)
costas_tm_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                 const float* __restrict__ phase0,
                 const float* __restrict__ freq0,
                 const float* __restrict__ lev0,
                 const float* __restrict__ locked0,
                 const float* __restrict__ gains, float* __restrict__ outr,
                 float* __restrict__ outi, float* __restrict__ ftrace,
                 float* __restrict__ phase_out, float* __restrict__ freq_out,
                 float* __restrict__ lev_out, float* __restrict__ locked_out,
                 int32_t* __restrict__ bits, int T, int C, int trace_every,
                 int nsf, const LoopParams lp,
                 const __grid_constant__ DdConsts dd) {
  constexpr int BPS = bits_per_symbol<DET>();
  __shared__ WarpSmem ws;
  const int lane = threadIdx.x;
  const int c = blockIdx.x * CB + lane;
  const bool live = c < C;
  const float tau = 6.283185307179586f;
  float phase = live ? phase0[c] : 0.f;
  float freq = live ? freq0[c] : 0.f;
  float lev = GEAR && live ? lev0[c] : 0.f;
  float locked = GEAR && live ? locked0[c] : 0.f;
  const int ntiles = (T + S - 1) / S;
  DdRegs kr;
  if constexpr (DET != QPSK) kr = dd_regs(dd);
  float* po_r = outr + c;                // this lane's column, row t
  float* po_i = outi + c;
  float* ptr = ftrace + c;
  int trace_left = trace_every;          // symbols to the next trace row
  int gain_left = nsf, grow = 0;         // symbols to the next gain row
  BitWriter out(bits + (long long)c * BPS * T, live ? BPS * T : 0);

  if (!live) {
    // a dead lane copies nothing: it reads zeros, so its loop stays at
    // phase 0 (stale shared memory could send its phase where sincosf
    // takes its slow path, and hold the warp there)
    for (int b = 0; b < 2; ++b) {
      for (int j = 0; j < S; ++j) {
        ws.zr[b][j][lane] = 0.f;
        ws.zi[b][j][lane] = 0.f;
        ws.g[b][j][lane] = 0.f;
      }
    }
  }
  load_tile<GAINS>(ws, 0, zr, zi, gains, 0, T, C, nsf, c, lane, live);
  for (int k = 0; k < ntiles; ++k) {
    if (k + 1 < ntiles) {
      load_tile<GAINS>(ws, (k + 1) & 1, zr, zi, gains, k + 1, T, C, nsf, c,
                       lane, live);
      cp_async_wait<1>();                // tile k has landed
    } else {
      cp_async_wait<0>();
    }
    const int b = k & 1;
    const int n = min(S, T - k * S);
    // one symbol, branch-free; the loop stays rolled: the chain is
    // latency-bound and an unrolled tile (32 copies of the step) measured
    // slower, out of the instruction cache
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      float a = ws.zr[b][j][lane], bq = ws.zi[b][j][lane];
      if (GAINS) {
        const float g = ws.g[b][grow][lane];
        a = __fmul_rn(a, g);
        bq = __fmul_rn(bq, g);
        const bool next = --gain_left == 0;
        gain_left = next ? nsf : gain_left;
        grow += next ? 1 : 0;
      }
      float sn, cs;
      sincosf(phase, &sn, &cs);
      const float r = __fadd_rn(__fmul_rn(a, cs), __fmul_rn(bq, sn));
      const float q = __fsub_rn(__fmul_rn(bq, cs), __fmul_rn(a, sn));
      if (live) {
        *po_r = r;
        *po_i = q;
      }
      po_r += C;
      po_i += C;
      float err;
      uint32_t v;                        // the symbol's bits, output order
      if constexpr (DET == QPSK) {
        v = (q < 0.f ? 1u : 0u) | (r < 0.f ? 2u : 0u);
        const float sr = r > 0.f ? 1.f : -1.f;
        const float si = q > 0.f ? 1.f : -1.f;
        err = __fsub_rn(__fmul_rn(sr, q), __fmul_rn(si, r));
      } else {
        uint32_t label;
        err = dd_error<DET>(r, q, kr, label);
        v = __brev(label) >> (32 - BPS);   // MSB of the label first
      }
      out.put(v, BPS);
      float alpha = lp.alpha, beta = lp.beta;
      if (GEAR) {
        const float errn = __fdiv_rn(
            fabsf(err), __fadd_rn(__fadd_rn(fabsf(r), fabsf(q)), 1e-9f));
        lev = __fadd_rn(lev, __fmul_rn(lp.gamma, __fsub_rn(errn, lev)));
        locked = lev < lp.enter ? 1.f : (lev > lp.exit ? 0.f : locked);
        const bool trk = locked > 0.5f;
        alpha = trk ? lp.alpha_trk : alpha;
        beta = trk ? lp.beta_trk : beta;
      }
      freq = __fadd_rn(freq, __fmul_rn(beta, err));
      phase = __fadd_rn(__fadd_rn(phase, freq), __fmul_rn(alpha, err));
      // the two conditional subtractions each way, their candidates formed
      // side by side: a value above tau never ends below -tau, and one at
      // or below tau is left alone by the first pair
      const float s1 = __fsub_rn(phase, tau), a1 = __fadd_rn(phase, tau);
      const float s2 = __fsub_rn(s1, tau), a2 = __fadd_rn(a1, tau);
      phase = phase > tau ? (s1 > tau ? s2 : s1)
                          : (phase < -tau ? (a1 < -tau ? a2 : a1) : phase);
      freq = fminf(fmaxf(freq, lp.min_freq), lp.max_freq);
      const bool traced = --trace_left == 0;
      trace_left = traced ? trace_every : trace_left;
      if (traced && live) *ptr = freq;
      ptr += traced ? C : 0;
    }
    grow = 0;             // the next tile's rows start at its first symbol's
  }
  out.finish();
  if (live) {
    phase_out[c] = phase;
    freq_out[c] = freq;
    if (GEAR) {
      lev_out[c] = lev;
      locked_out[c] = locked;
    }
  }
}

template <int DET, bool GEAR, bool GAINS>
int launch(const void* zr, const void* zi, const void* phase0,
           const void* freq0, const void* lev0, const void* locked0,
           const void* gains, void* outr, void* outi, void* ftrace,
           void* phase_out, void* freq_out, void* lev_out, void* locked_out,
           void* bits, int T, int C, int trace_every, int nsf,
           const LoopParams& lp, const DdConsts& dd, void* stream) {
  costas_tm_kernel<DET, GEAR, GAINS><<<(C + CB - 1) / CB, CB, 0,
                                       (cudaStream_t)stream>>>(
      (const float*)zr, (const float*)zi, (const float*)phase0,
      (const float*)freq0, (const float*)lev0, (const float*)locked0,
      (const float*)gains, (float*)outr, (float*)outi, (float*)ftrace,
      (float*)phase_out, (float*)freq_out, (float*)lev_out,
      (float*)locked_out, (int32_t*)bits, T, C, trace_every, nsf, lp, dd);
  return (int)cudaGetLastError();
}

__global__ void sincos_kernel(const float* __restrict__ x,
                              float* __restrict__ s, float* __restrict__ c,
                              long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sn, cs;
    sincosf(x[i], &sn, &cs);
    s[i] = sn;
    c[i] = cs;
  }
}

}  // namespace

// ``params`` is a host array of 9 floats: alpha, beta, min_freq, max_freq,
// alpha_trk, beta_trk, gamma, enter, exit.  Gear mode runs when ``lev0`` is
// not null (then ``locked0``, ``lev_out`` and ``locked_out`` are set too),
// with the QPSK detector only; gains mode when ``gains`` is not null, with
// ``nsf`` symbols per gain row.  ``det`` picks the detector (0 QPSK,
// 1 BPSK, 2 8PSK, 3 16QAM) and ``dd`` is a host array of 49 floats, the
// modfam.dd_constants of the dd modes.  ``bits`` is the (C, BPS*T) int32
// output, BPS = 2, 1, 3, 4 by detector.  Returns a CUDA error code, or
// cudaErrorInvalidValue for gear with a dd detector or an unknown one.
extern "C" int qpsk_costas_tm(const void* zr, const void* zi,
                              const void* phase0, const void* freq0,
                              const void* lev0, const void* locked0,
                              const void* gains, void* outr, void* outi,
                              void* ftrace, void* phase_out, void* freq_out,
                              void* lev_out, void* locked_out, void* bits,
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
  // a row's bit count is an int in the kernel's bit writer
  const long long bps = det == QPSK ? 2 : det == BPSK ? 1 : det == PSK8 ? 3 : 4;
  if (run == nullptr || (gear && det != QPSK) || T < 1 || (g && nsf < 1) ||
      bps * T > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  return run(zr, zi, phase0, freq0, lev0, locked0, gains, outr, outi, ftrace,
             phase_out, freq_out, lev_out, locked_out, bits, T, C,
             trace_every, nsf, lp, k, stream);
}

// sincosf of ``n`` floats, as the Costas kernel computes its phasor: the
// check that one sincosf gives the bits of PyTorch's cos and sin.
extern "C" int qpsk_sincosf(const void* x, void* s, void* c, long long n,
                            void* stream) {
  sincos_kernel<<<1056, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)s, (float*)c, n);
  return (int)cudaGetLastError();
}
