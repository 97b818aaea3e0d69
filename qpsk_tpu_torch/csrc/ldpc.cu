// Normalized min-sum LDPC decoder for Hopper (sm_90a): flooding schedule,
// a fixed number of iterations, one block per packet.
//
// Replaces: qpsk_tpu/ops/pallas/ldpc_kernel.py, _kernel launched by
// _ldpc_2d (entry ldpc_decode_pallas).  The TPU kernel gathers and
// scatters messages with a one-hot (dmax*m, n) edge matrix on the MXU
// because the TPU has no cheap gather; here the edges are a compact index
// table (qpsk_tpu_torch/packet/ldpc.py, _index_tables) and shared memory
// does the gather and the scatter:
//
//   - thread i owns check i: its <= dmax var->check messages stay in
//     registers across iterations.  The check phase keeps the running min,
//     second min, first-wins argmin and sign parity over the check's slots
//     (the running form of the Pallas kernel's check_update), and writes
//     the outgoing messages to shared memory;
//   - the variable phase sums, for each variable, its incoming messages in
//     the fixed order of its edge list and adds the channel LLR (no
//     atomics, so the sum order never changes between runs), into a
//     shared table of totals;
//   - each check thread then gathers its variables' totals and subtracts
//     its own message: the next var->check messages.
//   Two __syncthreads per iteration; the last iteration writes the k
//   posterior bits (total < 0).
//
// Float32 throughout.  The TPU kernel truncates matmul operands to bf16 on
// the MXU; that is a TPU artifact.  The plain PyTorch version sums each
// variable's messages in the same order, so the two agree bit for bit
// wherever the float operations are the same; the contract is the JAX
// package's own (>= 99.9 % bit agreement, equal frame errors).
//
// What bounds it on the H100: latency.  A packet's iteration is a few
// dozen dependent instructions and two block barriers per thread, and the
// data (LLRs, 9 KB of shared messages and totals) stay on the SM; with one
// 256-thread block per packet, up to 8 packets share an SM, so a batch of
// 4096 packets runs in about four waves over the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DMAX = 8;  // the largest check degree the kernel takes
constexpr float BIG = 1e30f;

__global__ void ldpc_kernel(const float* __restrict__ llrs,
                            const int32_t* __restrict__ check_var,
                            const int32_t* __restrict__ var_edges,
                            int32_t* __restrict__ bits, int m, int n, int k,
                            int dmax, int vmax, int iters, float alpha) {
  extern __shared__ float shm[];
  float* e_sh = shm;                 // (dmax, m) check->var messages
  float* llr_sh = shm + dmax * m;    // (n,) channel LLRs
  float* tot_sh = llr_sh + n;        // (n,) posterior totals
  const int i = threadIdx.x;
  const long long b = blockIdx.x;
  const float* ll = llrs + b * n;

  for (int v = i; v < n; v += blockDim.x) llr_sh[v] = ll[v];

  int cv[DMAX];
  int deg = 0;
#pragma unroll
  for (int s = 0; s < DMAX; ++s) {
    cv[s] = (i < m && s < dmax) ? check_var[s * m + i] : -1;
    deg += cv[s] >= 0;
  }
  __syncthreads();

  float mm[DMAX], e[DMAX];
#pragma unroll
  for (int s = 0; s < DMAX; ++s) mm[s] = s < deg ? llr_sh[cv[s]] : 0.f;

  for (int it = 0; it < iters; ++it) {
    // check phase: min, second min, first-wins argmin, sign parity
    float m1 = BIG, m2 = BIG;
    int am = 0, parity = 0;
#pragma unroll
    for (int s = 0; s < DMAX; ++s) {
      if (s < deg) {
        const float a = fabsf(mm[s]);
        if (a < m1) {
          m2 = m1;
          m1 = a;
          am = s;
        } else {
          m2 = fminf(m2, a);
        }
        parity ^= mm[s] < 0.f;
      }
    }
#pragma unroll
    for (int s = 0; s < DMAX; ++s) {
      if (s < deg) {
        const float v = alpha * (s == am ? m2 : m1);
        e[s] = (parity ^ (mm[s] < 0.f)) ? -v : v;
        e_sh[s * m + i] = e[s];
      }
    }
    __syncthreads();

    // variable phase: the incoming messages in edge-list order, then the
    // channel LLR
    const bool last = it == iters - 1;
    const int nv = last ? k : n;
    for (int v = i; v < nv; v += blockDim.x) {
      float sum = 0.f;
      for (int j = 0; j < vmax; ++j) {
        const int ed = var_edges[v * vmax + j];
        if (ed < 0) break;
        sum = j == 0 ? e_sh[ed] : sum + e_sh[ed];
      }
      const float total = llr_sh[v] + sum;
      if (last) {
        bits[b * k + v] = total < 0.f;
      } else {
        tot_sh[v] = total;
      }
    }
    if (last) break;
    __syncthreads();

    // the next var->check messages: the total without the own message
#pragma unroll
    for (int s = 0; s < DMAX; ++s)
      if (s < deg) mm[s] = tot_sh[cv[s]] - e[s];
    __syncthreads();
  }
}

}  // namespace

extern "C" int qpsk_ldpc(const void* llrs, const void* check_var,
                         const void* var_edges, void* bits, int B, int m,
                         int n, int k, int dmax, int vmax, int iters,
                         float alpha, void* stream) {
  const int threads = ((m + 31) / 32) * 32;
  const size_t smem = sizeof(float) * ((size_t)dmax * m + 2 * (size_t)n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ldpc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ldpc_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)llrs, (const int32_t*)check_var,
      (const int32_t*)var_edges, (int32_t*)bits, m, n, k, dmax, vmax, iters,
      alpha);
  return (int)cudaGetLastError();
}
