// Normalized min-sum LDPC decoder for Hopper (sm_90a): flooding schedule,
// a fixed number of iterations, one block per packet, one thread per
// check up to 1024 checks (CPT checks a thread beyond), one barrier an
// iteration.
//
// Replaces: qpsk_tpu/ops/pallas/ldpc_kernel.py, _kernel launched by
// _ldpc_2d (entry ldpc_decode_pallas).  The TPU kernel gathers and
// scatters messages with a one-hot (dmax*m, n) edge matrix on the MXU
// because the TPU has no cheap gather.  Here tensor cores serve nothing:
// the edges are a compact index table and shared memory does the gather.
// What the card offers this decoder is registers, shared memory and many
// warps, and the kernel is built from those:
//
//   - thread i owns check i, and for a code of more than 1024 checks
//     (a block has at most 1024 threads) also checks i + T, .. (CPT = 2
//     or 4 checks a thread, T threads).  Their <= DMAX var->check
//     messages and the channel LLRs of their variables stay in registers
//     across iterations (DMAX is a template parameter, the code's check
//     degree, so no instance carries dead slots);
//   - every index lives in registers, loaded once before the loop: for
//     slot s of the check, the edge list of its variable v (the per-slot
//     table of packet/ldpc.py, _slot_edge_table), as byte offsets into
//     the message array packed two to a register; a padded entry points at
//     a slot that holds zero, so the inner loop has no branch;
//   - the check->var messages live in shared memory twice (ping-pong).
//     After the check update (running min, second min and sign parity over
//     the check's slots: the running form of the Pallas kernel's
//     check_update) and ONE barrier, the check thread forms its next
//     var->check message itself,
//         mm[s] = (llr[v] + ((e[ed0] + e[ed1]) + e[ed2])) - e[s],
//     from three independent shared loads a slot; no table of totals, no
//     second and third barrier;
//   - the LLR row comes in with 16-byte loads; the last iteration ends
//     with the barrier and the posterior sum of message variable i.
//
// Float32 throughout.  The TPU kernel truncates matmul operands to bf16 on
// the MXU; that is a TPU artifact.  The sums run in the order of the plain
// PyTorch version (the edge list in order, then llr + sum, then - e), so
// the two agree bit for bit wherever the float operations are the same;
// the contract is the JAX package's own (>= 99.9 % bit agreement, equal
// frame errors).  Two forms differ from the plain version's and give the
// same values: the magnitude of slot s is alpha*m2 where |mm[s]| == m1,
// else alpha*m1 (on a tie for the minimum m2 == m1, so no argmin is
// needed), and the sign is taken from the messages' sign bits after the
// LLRs pass through x + 0.0f, which leaves no -0.0 for a sign bit to
// differ from `mm < 0` on.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md has
// the runs): instruction issue.  An iteration is 107 instructions a check
// (21 a slot, 15 shared loads and 5 stores among them), about half of
// them minima, selects and sign logic; 4096 packets take 0.135 ms where
// the three-barrier kernel before it took 0.31, and the data never leave
// the SM between the 2 KB row in and the 1 KB of bits out.  A small batch
// is bound by one packet's latency, 25 rounds of check update, barrier
// and gather: 156 packets take 0.012 ms.  Measured and not kept: several
// checks a thread for small codes (one warp a packet with __syncwarp for
// the barrier was 0.035 ms at 156 packets and 0.172 at 4096, at 255
// registers with a spill), and unpacked offsets (three more registers, no
// faster).  The 16-bit byte offsets bound dmax*m below 16384: m <= 3276
// for the slice's degree-5 codes (PacketConfig payloads up to 407 bytes).
//
// The kernel is a template on the check degree DMAX, the variable degree
// VMAX (an edge list of VMAX byte offsets, two a register) and the checks
// a thread.  PacketConfig's codes (dv = 3: VMAX 3, check degree 5) run
// ldpc_kernel<5 or 8, 3, CPT, false>.  Every other LdpcCode(k, dv) the TPU
// kernel's gate admits (qpsk_tpu/packet/ldpc.py: dmax*m*n*4 <= 6 MiB, so
// m <= 443 checks) runs a general instance with its exact degrees: the
// construction gives every such code check degree dmax = dv + 2 and
// edge lists of vmax = max(dv, 2) (the accumulator's parity variables, of
// degree 2 or 1, padded with the zero slot as the plain version pads
// them), so no slot past the check degree and no edge past the list runs,
// as in the dv = 3 instances.  dv 1 and 2 run this schedule as <dv + 2,
// 2, 1, true> (launched as ldpc_kernel_bounded, up to GEN_THREADS = 512
// checks); from dv = 4 a slot's edge list is long enough that
// ldpc_totals_kernel<dv + 2, dv>, which sums each variable's list once an
// iteration for a second barrier, is faster.  The instance is picked by
// the check degree.  What bounds them is what bounds the others,
// instruction issue and one packet's latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int GEN_THREADS = 512;  // the general instance's most checks

// the message at a byte offset into a message array
__device__ __forceinline__ float at(const float* base, unsigned byte_off) {
  return *(const float*)((const char*)base + byte_off);
}

// the byte offset of edge j of a packed list of VMAX edges (two 16-bit
// offsets a word); an odd list's last word holds its offset alone, so it
// is read unmasked (a mask there would cost the dv = 3 instances an
// instruction a slot an iteration on the serial message chain)
template <int VMAX>
__device__ __forceinline__ unsigned off_of(
    const unsigned (&o)[(VMAX + 1) / 2], int j) {
  if (j & 1) return o[j >> 1] >> 16;
  return ((VMAX & 1) && j == VMAX - 1) ? o[j >> 1] : (o[j >> 1] & 0xffffu);
}

// the sum of a variable's incoming messages in edge-list order, over the
// list's first ``vm`` edges (padding reads the zero slot)
template <int VMAX>
__device__ __forceinline__ float incoming(const float* e,
                                          const unsigned (&o)[(VMAX + 1) / 2],
                                          int vm) {
  float sum = at(e, off_of<VMAX>(o, 0));
#pragma unroll
  for (int j = 1; j < VMAX; ++j)
    if (j < vm) sum = sum + at(e, off_of<VMAX>(o, j));
  return sum;
}

// the packed byte offsets of the VMAX edges at list[0], list[stride], ...
// of a list of ``vm`` entries; a padded (-1), missing or dead entry reads
// zero_slot.  The offsets are formed first and packed after: so packed,
// the dv = 3 instances compile to the same machine code as the kernel
// before it took other degrees (packing each offset into a cleared word
// as it is read cost them 5 % at 156 packets on the H100)
template <int VMAX>
__device__ __forceinline__ void edge_offsets(const int32_t* list, int stride,
                                             int vm, bool live, int zero_slot,
                                             unsigned (&o)[(VMAX + 1) / 2]) {
  unsigned off[VMAX];
#pragma unroll
  for (int j = 0; j < VMAX; ++j) {
    const int ed = live && j < vm ? list[j * stride] : -1;
    off[j] = 4u * (unsigned)(ed >= 0 ? ed : zero_slot);
  }
#pragma unroll
  for (int w = 0; w < (VMAX + 1) / 2; ++w)
    o[w] = 2 * w + 1 < VMAX ? off[2 * w] | (off[2 * w + 1] << 16) : off[2 * w];
}

// DMAX slots a check and VMAX edges a variable at most; GEN: a general
// instance (dv 1 and 2, launch bounds of GEN_THREADS).  Every instance
// runs its exact list length: the tables' vmax is VMAX (the launcher
// checks it)
template <int DMAX, int VMAX, int CPT, bool GEN>
__device__ __forceinline__ void ldpc_body(
    const float* __restrict__ llrs, const int32_t* __restrict__ check_var,
    const int32_t* __restrict__ slot_edges,
    const int32_t* __restrict__ var_edges, int32_t* __restrict__ bits, int m,
    int n, int k, int dmax, int vmax, int estride, int iters, float alpha,
    int vec) {
  constexpr int NW = (VMAX + 1) / 2;     // offset words an edge list
  constexpr int vm = VMAX;
  extern __shared__ __align__(16) float shm[];
  // two (dmax*m + 1) message arrays, the last entry a zero that padded
  // edges read, then the n channel LLRs
  float* llr_sh = shm + 2 * estride;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const float* ll = llrs + b * n;
  const int zero_slot = dmax * m;

  // x + 0.0f turns a -0.0 LLR into +0.0 and changes nothing else
  if (vec) {
    for (int v = tid; v < n / 4; v += T) {
      float4 x = ((const float4*)ll)[v];
      x.x = __fadd_rn(x.x, 0.f);
      x.y = __fadd_rn(x.y, 0.f);
      x.z = __fadd_rn(x.z, 0.f);
      x.w = __fadd_rn(x.w, 0.f);
      ((float4*)llr_sh)[v] = x;
    }
  } else {
    for (int v = tid; v < n; v += T) llr_sh[v] = __fadd_rn(ll[v], 0.f);
  }
  if (tid == 0) {
    shm[zero_slot] = 0.f;
    shm[estride + zero_slot] = 0.f;
  }

  // checks i = tid + j*T, j < CPT: the edges of each slot's variable, and
  // of message variable i
  unsigned edge[CPT][DMAX][NW], post[CPT][NW];
  int cv[CPT][DMAX];
  unsigned real[CPT];  // bit s: slot s of the check is an edge
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int i = tid + j * T;
    real[j] = 0u;
#pragma unroll
    for (int s = 0; s < DMAX; ++s) {
      cv[j][s] = (i < m && s < dmax) ? check_var[s * m + i] : -1;
      real[j] |= (unsigned)(cv[j][s] >= 0) << s;
      edge_offsets<VMAX>(slot_edges + (s * vm) * m + i, m, vm, cv[j][s] >= 0,
                         zero_slot, edge[j][s]);
    }
    edge_offsets<VMAX>(var_edges + i * vm, 1, vm, i < k, zero_slot, post[j]);
  }
  __syncthreads();

  // a slot past the check's degree carries BIG: never a minimum, never
  // negative, and its message is stored nowhere
  float lv[CPT][DMAX], mm[CPT][DMAX];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int s = 0; s < DMAX; ++s) {
      lv[j][s] = cv[j][s] >= 0 ? llr_sh[cv[j][s]] : BIG;
      mm[j][s] = lv[j][s];
    }

  float* cur = shm;
  float* oth = shm + estride;
  for (int it = 0;; ++it) {
    // check update: mm becomes the check->var message e
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float m1 = BIG, m2 = BIG;
      unsigned px = 0u;
#pragma unroll
      for (int s = 0; s < DMAX; ++s) {
        const float a = fabsf(mm[j][s]);
        m2 = fminf(m2, fmaxf(m1, a));
        m1 = fminf(m1, a);
        px ^= __float_as_uint(mm[j][s]);
      }
      const float v1 = alpha * m1, v2 = alpha * m2;
#pragma unroll
      for (int s = 0; s < DMAX; ++s) {
        const float mag = fabsf(mm[j][s]) > m1 ? v1 : v2;
        const unsigned sign = (px ^ __float_as_uint(mm[j][s])) & 0x80000000u;
        mm[j][s] = __uint_as_float(__float_as_uint(mag) | sign);
        if (real[j] >> s & 1u) cur[s * m + tid + j * T] = mm[j][s];
      }
    }
    __syncthreads();
    if (it == iters - 1) break;

    // the next var->check messages: the variable's incoming messages in
    // edge-list order, the channel LLR, then without the own message
#pragma unroll
    for (int j = 0; j < CPT; ++j)
#pragma unroll
      for (int s = 0; s < DMAX; ++s)
        mm[j][s] = (lv[j][s] + incoming<VMAX>(cur, edge[j][s], vm)) - mm[j][s];
    float* t = cur;
    cur = oth;
    oth = t;
  }

  // posterior of message bit i: total < 0
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int i = tid + j * T;
    if (i < k)
      bits[b * k + i] =
          (llr_sh[i] + incoming<VMAX>(cur, post[j], vm)) < 0.f;
  }
}

// The totals schedule of the general instances from dv = 4: one thread a
// check, which also owns variables i and i + m (n = 2m: the IRA codes'
// message and parity halves).
// An iteration is the check update with its messages stored, ONE barrier,
// each thread's two variable totals llr + ((e0 + e1) + ...) over their edge
// lists stored, a SECOND barrier, and each slot's next message its
// variable's total less its own message.  A check then loads 2 x VMAX +
// DMAX values an iteration where the one-barrier schedule loads DMAX x VMAX
// (17 for 35 at dv = 5, 26 for 80 at dv = 8), and holds two edge lists in
// registers where that one holds DMAX (NVIDIA H100 80GB HBM3, 700 W, 4096
// packets:
// 0.2241 ms for 0.3207 at dv = 5, 0.2585 for 0.5232 at (192, dv = 8); at
// dv = 2, 8 loads either way, the second barrier lost, 0.1197 for 0.0933).
// The totals are the plain version's (the edge list in order, then llr +
// sum), so is every message.
template <int DMAX, int VMAX>
__device__ __forceinline__ void ldpc_totals_body(
    const float* __restrict__ llrs, const int32_t* __restrict__ check_var,
    const int32_t* __restrict__ var_edges, int32_t* __restrict__ bits, int m,
    int n, int k, int dmax, int estride, int iters, float alpha, int vec) {
  constexpr int NW = (VMAX + 1) / 2;     // offset words an edge list
  extern __shared__ __align__(16) float shm[];
  // the (dmax*m + 1) messages, the last a zero that padded edges read, the
  // n variable totals, the n channel LLRs
  float* e = shm;
  float* tot = shm + estride;
  float* llr_sh = tot + n;
  const int T = blockDim.x, i = threadIdx.x;
  const long long b = blockIdx.x;
  const float* ll = llrs + b * n;
  const int zero_slot = dmax * m;

  // x + 0.0f turns a -0.0 LLR into +0.0 and changes nothing else
  if (vec) {
    for (int v = i; v < n / 4; v += T) {
      float4 x = ((const float4*)ll)[v];
      x.x = __fadd_rn(x.x, 0.f);
      x.y = __fadd_rn(x.y, 0.f);
      x.z = __fadd_rn(x.z, 0.f);
      x.w = __fadd_rn(x.w, 0.f);
      ((float4*)llr_sh)[v] = x;
    }
  } else {
    for (int v = i; v < n; v += T) llr_sh[v] = __fadd_rn(ll[v], 0.f);
  }
  if (i == 0) e[zero_slot] = 0.f;

  // the check's slots (their variables as byte offsets into tot) and the
  // edge lists of variables i and i + m
  int cv[DMAX];
  unsigned toff[DMAX], real = 0u, vedge[2][NW];
#pragma unroll
  for (int s = 0; s < DMAX; ++s) {
    cv[s] = (i < m && s < dmax) ? check_var[s * m + i] : -1;
    real |= (unsigned)(cv[s] >= 0) << s;
    toff[s] = 4u * (unsigned)max(cv[s], 0);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    edge_offsets<VMAX>(var_edges + (i + h * m) * VMAX, 1, VMAX, i < m,
                       zero_slot, vedge[h]);
  __syncthreads();

  // a slot past the check's degree carries BIG: never a minimum, never
  // negative, and its message is stored nowhere
  float mm[DMAX];
#pragma unroll
  for (int s = 0; s < DMAX; ++s) mm[s] = cv[s] >= 0 ? llr_sh[cv[s]] : BIG;

  for (int it = 0;; ++it) {
    // check update: mm becomes the check->var message
    float m1 = BIG, m2 = BIG;
    unsigned px = 0u;
#pragma unroll
    for (int s = 0; s < DMAX; ++s) {
      const float a = fabsf(mm[s]);
      m2 = fminf(m2, fmaxf(m1, a));
      m1 = fminf(m1, a);
      px ^= __float_as_uint(mm[s]);
    }
    const float v1 = alpha * m1, v2 = alpha * m2;
#pragma unroll
    for (int s = 0; s < DMAX; ++s) {
      const float mag = fabsf(mm[s]) > m1 ? v1 : v2;
      const unsigned sign = (px ^ __float_as_uint(mm[s])) & 0x80000000u;
      mm[s] = __uint_as_float(__float_as_uint(mag) | sign);
      if (real >> s & 1u) e[s * m + i] = mm[s];
    }
    __syncthreads();
    if (it == iters - 1) break;

    // the totals of variables i and i + m, then each slot's next message
    if (i < m) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tot[i + h * m] = llr_sh[i + h * m] + incoming<VMAX>(e, vedge[h], VMAX);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < DMAX; ++s)
      mm[s] = ((real >> s & 1u) ? at(tot, toff[s]) : BIG) - mm[s];
  }

  // posterior of message bit i: total < 0
  if (i < k) bits[b * k + i] = (llr_sh[i] + incoming<VMAX>(e, vedge[0], VMAX)) < 0.f;
}

#define LDPC_PARAMS                                                      \
  const float *__restrict__ llrs, const int32_t *__restrict__ check_var,  \
      const int32_t *__restrict__ slot_edges,                             \
      const int32_t *__restrict__ var_edges, int32_t *__restrict__ bits,  \
      int m, int n, int k, int dmax, int vmax, int estride, int iters,    \
      float alpha, int vec
#define LDPC_ARGS                                                         \
  llrs, check_var, slot_edges, var_edges, bits, m, n, k, dmax, vmax,      \
      estride, iters, alpha, vec

// The launch bounds are the most threads the launcher gives an instance,
// so that ptxas keeps its registers within what such a block may hold
// (without them, on the H100, the instances of more than one check a
// thread failed to launch at 1456 checks and more, the general one at
// 448 and more; each general instance takes the registers its degrees
// need under that bound).  The slice's
// instance, dv = 3 at check degree 5 and one check a thread, fits 1024
// threads as it is and goes without: a bound changes its code and costs
// it time.
template <int DMAX, int VMAX, int CPT, bool GEN>
__global__ void ldpc_kernel(LDPC_PARAMS) {
  ldpc_body<DMAX, VMAX, CPT, GEN>(LDPC_ARGS);
}

template <int DMAX, int VMAX, int CPT, bool GEN>
__global__ void __launch_bounds__(GEN ? GEN_THREADS : 1024)
    ldpc_kernel_bounded(LDPC_PARAMS) {
  ldpc_body<DMAX, VMAX, CPT, GEN>(LDPC_ARGS);
}

template <int DMAX, int VMAX, int CPT, bool GEN>
int launch(const float* llrs, const int32_t* check_var,
           const int32_t* slot_edges, const int32_t* var_edges, int32_t* bits,
           int B, int m, int n, int k, int dmax, int vmax, int iters,
           float alpha, cudaStream_t stream) {
  const int threads = ((m + CPT - 1) / CPT + 31) / 32 * 32;
  const int estride = ((dmax * m + 1 + 3) / 4) * 4;
  const size_t smem = sizeof(float) * (2 * (size_t)estride + n);
  const auto kernel = [] {
    if constexpr (DMAX == 5 && CPT == 1 && !GEN)
      return ldpc_kernel<DMAX, VMAX, CPT, GEN>;
    else
      return ldpc_kernel_bounded<DMAX, VMAX, CPT, GEN>;
  }();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = n % 4 == 0 && (uintptr_t)llrs % 16 == 0;
  kernel<<<B, threads, smem, stream>>>(
      llrs, check_var, slot_edges, var_edges, bits, m, n, k, dmax, vmax,
      estride, iters, alpha, vec);
  return (int)cudaGetLastError();
}

template <int DMAX, int VMAX>
__global__ void __launch_bounds__(GEN_THREADS)
    ldpc_totals_kernel(const float* __restrict__ llrs,
                    const int32_t* __restrict__ check_var,
                    const int32_t* __restrict__ var_edges,
                    int32_t* __restrict__ bits, int m, int n, int k, int dmax,
                    int estride, int iters, float alpha, int vec) {
  ldpc_totals_body<DMAX, VMAX>(llrs, check_var, var_edges, bits, m, n, k,
                               dmax, estride, iters, alpha, vec);
}

// a general instance on the totals schedule: one check a thread, m <=
// GEN_THREADS, n = 2m; the arguments of launch (it reads no slot table)
template <int DMAX, int VMAX>
int launch_totals(const float* llrs, const int32_t* check_var,
                  const int32_t* /* slot_edges */, const int32_t* var_edges,
                  int32_t* bits, int B, int m, int n, int k, int dmax,
                  int /* vmax */, int iters, float alpha, cudaStream_t stream) {
  const int threads = (m + 31) / 32 * 32;
  const int estride = ((dmax * m + 1 + 3) / 4) * 4;
  const size_t smem = sizeof(float) * (estride + 2 * (size_t)n);
  const auto kernel = ldpc_totals_kernel<DMAX, VMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = n % 4 == 0 && (uintptr_t)llrs % 16 == 0;
  kernel<<<B, threads, smem, stream>>>(llrs, check_var, var_edges, bits, m, n,
                                       k, dmax, estride, iters, alpha, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// check_var (dmax, m), slot_edges (dmax, vmax, m) and var_edges (n, vmax)
// are the int32 tables of packet/ldpc.py, -1 for padding.  Takes k <= m
// with dmax*m < 16384 (message offsets of 16 bits, in bytes) and
// 4*(2*dmax*m + n) + 16 bytes of shared memory at most 227 KB; vmax 3
// (PacketConfig's codes, dv = 3): dmax <= 8, m <= 4096, one check a thread
// up to m = 1024, two up to 2048, four beyond; any other dv 1..8 (the
// general instances, LdpcCode(k, dv)): dmax == dv + 2 and vmax ==
// max(dv, 2), m <= GEN_THREADS, n == 2m from dv = 4.
extern "C" int qpsk_ldpc(const void* llrs, const void* check_var,
                         const void* slot_edges, const void* var_edges,
                         void* bits, int B, int m, int n, int k, int dmax,
                         int vmax, int iters, float alpha, void* stream) {
  const long long smem = 4LL * (2 * ((dmax * (long long)m + 4) / 4 * 4) + n);
  const bool fast = vmax == 3 && dmax <= 8 && m <= 4096;
  const bool gen = dmax >= 3 && dmax <= 10 && dmax != 5 &&
                   vmax == (dmax > 4 ? dmax - 2 : 2) && m <= GEN_THREADS &&
                   (dmax < 6 || n == 2 * m);
  if (!(fast || gen) || k > m || dmax * (long long)m >= 16384 ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, const int32_t*, const int32_t*,
                         const int32_t*, int32_t*, int, int, int, int, int,
                         int, int, float, cudaStream_t);
  // the general instances by check degree dv + 2 (5 is the fast ones'):
  // edge lists of 2 summed a slot, longer ones a variable (launch_totals)
  constexpr Launch by_dmax[8] = {
      launch<3, 2, 1, true>,  launch<4, 2, 1, true>,  nullptr,
      launch_totals<6, 4>,    launch_totals<7, 5>,    launch_totals<8, 6>,
      launch_totals<9, 7>,    launch_totals<10, 8>};
  const int cpt = m <= 1024 ? 1 : m <= 2048 ? 2 : 4;
  const Launch run =
      !fast ? by_dmax[dmax - 3]
      : dmax <= 5 ? (cpt == 1 ? launch<5, 3, 1, false>
                     : cpt == 2 ? launch<5, 3, 2, false> : launch<5, 3, 4, false>)
                  : (cpt == 1 ? launch<8, 3, 1, false>
                     : cpt == 2 ? launch<8, 3, 2, false> : launch<8, 3, 4, false>);
  return run((const float*)llrs, (const int32_t*)check_var,
             (const int32_t*)slot_edges, (const int32_t*)var_edges,
             (int32_t*)bits, B, m, n, k, dmax, vmax, iters, alpha,
             (cudaStream_t)stream);
}
