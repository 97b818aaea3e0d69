// Soft-decision Viterbi decoder for Hopper (sm_90a): any K=7 rate-1/2
// code whose two generators tap the newest and the oldest bit (the
// default (133, 171) and every other such pair), 64 states, a packet's
// trellis in the registers of G lanes.  Every other code the TPU kernel's
// gate takes (rate 1/1 to 1/8, K up to 15, any generators) runs
// viterbi_general_kernel, at the end of this file.
//
// Replaces: qpsk_tpu/ops/pallas/viterbi_kernel.py, _fwd_kernel + _bwd_kernel
// launched by _viterbi_2d (entry viterbi_decode_pallas).  The TPU layout
// (states on sublanes, batch on 128 lanes, bf16 0/1 decision planes, time
// padded with inert zero-LLR steps) exists because the TPU has no cheap
// gather.  Tensor cores serve nothing here: an add-compare-select is no
// product and the contract is bit-identity in float32.  What the card
// offers a trellis is registers, shared memory, asynchronous copies and
// many warps, and viterbi_kernel<G> is built from those:
//
//   - G lanes (a template parameter, a power of two up to 8; 1 and 8 are
//     built) hold a packet's 64 path metrics, 64/G a lane at compile-time
//     register indices.  Lane g owns
//     the new states [g*64/G, (g+1)*64/G); their predecessors s'>>1 and
//     32 + (s'>>1) are registers of lanes g>>1 and G/2 + (g>>1).  G = 1
//     exchanges nothing.  G > 1 fetches them in two rounds of shuffles in
//     which every lane sends one register to exactly one reader: 64/G
//     shuffles a lane and step;
//   - the two new states 2j, 2j+1 of a butterfly share the predecessors j
//     and 32+j, and because both generators tap the newest and the oldest
//     bit, their four branch metrics are +-one value: four adds, two
//     maxima and two differences whose sign bits are the decisions.  The
//     code arrives as its sign table's two bit masks (bit j of mask k:
//     output k of the branch j -> 2j is a one; the wrapper reads them off
//     the plain version's _trellis), so a butterfly's value is
//     +-0.5(l0+l1) where its two bits agree, +-0.5(l0-l1) where they
//     differ, negative where bit 0 is set.  For G = 1 and the default
//     code the instance viterbi_kernel<1, true> knows every butterfly's
//     value at compile time (the launch picks it when the masks are the
//     default code's), so the default code loses nothing to the
//     argument; viterbi_kernel<1, false> selects each value from the
//     masks; for G > 1 a lane keeps two coefficients a butterfly, taken
//     from the masks, or in viterbi_kernel<8, true> from the default
//     code's generators as before the masks (computed from the runtime
//     masks they cost the default code 7 % at 4096 packets);
//   - a lane packs its own 64/G decision bits with funnel shifts (no
//     ballot) and stores them into the (nsteps, B) scratch of 64-bit
//     words, bit s = state s, so the stores of a warp are contiguous;
//   - the maximum is a register tree, then log2 G xor-shuffles;
//   - the LLRs are staged through shared memory in tiles of packets x 16
//     steps by cp.async (16 bytes a copy), the next tile in flight while
//     this one is consumed, so the global reads stay coalesced though a
//     lane walks its own packet;
//   - the traceback is one thread a packet: a step's word does not depend
//     on the state, so 16 steps are loaded ahead into registers while the
//     thread walks the 16 before.  The bits are packed into shared memory
//     and the block writes the (B, nbits) int32 output coalesced.
//   Any nsteps and any batch size work with no padding.
// viterbi_warp_kernel (one warp a packet, two states a lane, the shape the
// port began with) stays for small batches, with the five shuffle rounds
// of its maximum replaced by one warp reduction.
//
// Bit-identity with the plain PyTorch version (and through it the JAX
// scan, packet/fec.py): the same -1e9 start metrics, bm = 0.5f*(g0*l0 +
// g1*l1), strict c1 > c0, and pm - max(pm) after every step (the
// subtraction rounds, so it is never deferred).  g = +-1, so g0*l0 + g1*l1
// is l0+l1, l0-l1 or the exact negative of one of them, the 0.5f scaling
// is exact, and adding the negated value is subtracting it; c1 > c0 is the
// sign of c0 - c1 (no flush to zero: a difference of unequal floats is not
// zero); max is exact in any order.  Built without --use_fast_math.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md has
// the runs), against 8 bytes of LLRs in and 8 bytes of decisions out and
// back a step.  A large batch is bound by instruction issue: a step of
// G = 1 is 475 instructions for 32 packets (130 adds, 128 multiply-adds,
// 127 maxima, 59 funnel shifts; the maxima and shifts issue at half the
// adds' rate), and 67 072 packets take 0.37 ms where the warp kernel takes
// 1.29.  But one lane a packet needs 16 896 packets to give each of the
// card's 528 warp schedulers one warp, and below that a launch lasts as
// long as one warp's 262 steps: 0.11 ms.  More lanes a packet shorten the
// step's dependent chain (exchange shuffle, add, maximum, tree, shuffle
// rounds, subtract) at the price of shuffles and selects: G = 8 takes
// 0.048 ms up to 2048 packets and 0.065 at 4096, the warp kernel 0.030 at
// 156 and 0.090 at 4096.  So the wrapper picks the shape from the batch
// size (ops/cuda/viterbi_kernel.py, _lanes).  Measured and not kept: 2 and
// 4 lanes a packet (never the fastest: 0.105 and 0.072 ms at 4096), the
// warp reduction on the lanes of a group (2.6x slower than shuffles for
// G = 4), and a maximum taken from the old metrics beside the shuffles
// (exact, but its two reductions a step cost more than the chain they
// shorten: 0.040 against 0.030 ms at 156 packets).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// the default code's generators: viterbi_kernel<1, true> is compiled for
// their butterflies
constexpr unsigned POLY0 = 0133, POLY1 = 0171;
constexpr int TILE = 16;          // trellis steps per staged LLR tile
constexpr int ROW = 2 * TILE + 4; // floats a packet's row of a tile takes:
                                  // rows stay 16-byte aligned and half the
                                  // lanes of a warp fall on distinct banks
constexpr int CHUNK = 16;         // decision words the traceback loads ahead

// 1 if output `poly` of the branch (predecessor j0 -> state 2*j0) is a one
__host__ __device__ constexpr int out_bit(unsigned poly, int j0) {
  unsigned x = poly & ((unsigned)j0 << 1);
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return (int)(x & 1u);
}

// the sign mask of a generator: bit j0 is out_bit(poly, j0)
__host__ __device__ constexpr unsigned code_mask(unsigned poly) {
  unsigned m = 0u;
  for (int j0 = 0; j0 < 32; ++j0) m |= (unsigned)out_bit(poly, j0) << j0;
  return m;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int G>
struct Shape {
  static constexpr int THREADS = G == 1 ? 32 : 128;
  static constexpr int N = 64 / G;        // states a lane
  static constexpr int H = N / 2;         // butterflies a lane
  static constexpr int P = THREADS / G;   // packets a block
};

// N sign bits into the low bits of a word, bit r from df[r]: four funnel-
// shift chains of N/4, merged by multiply-adds (their bits never overlap)
template <int N>
__device__ __forceinline__ unsigned pack_signs(const float* df) {
  constexpr int Q = N / 4;
  unsigned c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = Q - 1; r >= 0; --r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = __funnelshift_l(__float_as_uint(df[j * Q + r]), c[j], 1);
  return ((c[3] * (1u << Q) + c[2]) * (1u << Q) + c[1]) * (1u << Q) + c[0];
}

// the maximum of tr[0 .. 2W) into tr[0], a tree of compile-time levels
template <int W>
__device__ __forceinline__ void max_tree(float* tr) {
#pragma unroll
  for (int r = 0; r < W; ++r) tr[r] = fmaxf(tr[r], tr[r + W]);
  if constexpr (W > 1) max_tree<W / 2>(tr);
}

template <int G, bool FIXED>
__global__ void __launch_bounds__(Shape<G>::THREADS)
viterbi_kernel(const float* __restrict__ llrs, unsigned char* dec,
               int32_t* __restrict__ bits, int B, int nsteps, int nbits,
               int vec, unsigned mask0, unsigned mask1) {
  constexpr int T = Shape<G>::THREADS, N = Shape<G>::N, H = Shape<G>::H,
                P = Shape<G>::P;
  extern __shared__ __align__(16) float shm[];
  float* tiles = shm;                                   // 2 x P x ROW
  unsigned* bits_sh = (unsigned*)(shm + 2 * P * ROW);   // P x wstride
  const int wstride = (nsteps + 31) / 32 + 1;
  const int tid = threadIdx.x;
  const int g = tid % G;    // this lane's place among its packet's lanes
  const int pl = tid / G;   // its packet within the block
  const int base = blockIdx.x * P;
  const int b = base + pl;
  const bool valid = b < B;  // a lane past the batch computes and stores nothing

  // one tile: P packets x TILE steps x 2 LLRs, rows of packets past the
  // batch repeat the last packet
  auto stage = [&](int tile) {
    float* dst = tiles + (tile & 1) * P * ROW;
    const int f0 = 2 * TILE * tile;   // first float of the tile in a row
    if (vec) {  // rows 16-byte aligned and nsteps even: a copy is whole
      for (int q = tid; q < P * (TILE / 2); q += T) {
        const int p = q / (TILE / 2), part = q % (TILE / 2);
        const size_t row = (size_t)min(base + p, B - 1) * 2 * nsteps;
        if (f0 + 4 * part < 2 * nsteps)
          cp_async16(dst + p * ROW + 4 * part, llrs + row + f0 + 4 * part);
      }
    } else {
      for (int q = tid; q < P * 2 * TILE; q += T) {
        const int p = q / (2 * TILE), f = q % (2 * TILE);
        const size_t row = (size_t)min(base + p, B - 1) * 2 * nsteps;
        if (f0 + f < 2 * nsteps)
          cp_async4(dst + p * ROW + f, llrs + row + f0 + f);
      }
    }
    cp_async_commit();
  };

  // register r of lane g is state g*N + r
  float pm[N];
#pragma unroll
  for (int r = 0; r < N; ++r) pm[r] = (g == 0 && r == 0) ? 0.f : -1e9f;

  // G > 1: butterfly i of lane g is j0 = g*H + i, its branch value
  // ca*0.5(l0+l1) + cb*0.5(l0-l1) with (ca, cb) one of (+-1, 0), (0, +-1)
  float ca[G == 1 ? 1 : H], cb[G == 1 ? 1 : H];
  if constexpr (G > 1) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int j0 = g * H + i;
      const int s0 = FIXED ? out_bit(POLY0, j0) : (int)(mask0 >> j0 & 1u);
      const int s1 = FIXED ? out_bit(POLY1, j0) : (int)(mask1 >> j0 & 1u);
      const float sg = s0 ? -1.f : 1.f;
      ca[i] = s0 == s1 ? sg : 0.f;
      cb[i] = s0 == s1 ? 0.f : sg;
    }
  }
  const bool odd = g & 1, upper = g >= G / 2;
  const int src_even = g >> 1, src_odd = G / 2 + (g >> 1);

  const int ntiles = (nsteps + TILE - 1) / TILE;
  stage(0);
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // the tile is in; the other buffer is read out
    if (tile + 1 < ntiles) stage(tile + 1);
    const float* lt = tiles + (tile & 1) * P * ROW + pl * ROW;
    const int kmax = min(TILE, nsteps - TILE * tile);
#pragma unroll 1
    for (int k = 0; k < kmax; ++k) {
      const float2 l = *(const float2*)(lt + 2 * k);
      const float ha = 0.5f * (l.x + l.y), hb = 0.5f * (l.x - l.y);

      // the predecessors of butterfly i: pm[j0] and pm[32 + j0].  G = 1
      // has them in its own registers.  G > 1: state j0 = g*H + i is
      // register (g&1)*H + i of lane g>>1, state 32 + j0 the same register
      // of lane G/2 + (g>>1).  Round 1: even lanes read their lower
      // source, odd lanes their upper one; round 2 the other way: each
      // lane is read by one lane a round.
      float p0[G == 1 ? 1 : H], p1[G == 1 ? 1 : H];
      if constexpr (G > 1) {
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float s1 = upper ? pm[H + i] : pm[i];
          const float s2 = upper ? pm[i] : pm[H + i];
          const float r1 = __shfl_sync(FULL, s1, odd ? src_odd : src_even, G);
          const float r2 = __shfl_sync(FULL, s2, odd ? src_even : src_odd, G);
          p0[i] = odd ? r2 : r1;
          p1[i] = odd ? r1 : r2;
        }
      }

      float nm[N], df[N];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        float bt;
        if constexpr (G == 1 && FIXED) {
          const float h = out_bit(POLY0, i) == out_bit(POLY1, i) ? ha : hb;
          bt = out_bit(POLY0, i) ? -h : h;
        } else if constexpr (G == 1) {
          const float h = ((mask0 ^ mask1) >> i & 1u) ? hb : ha;
          bt = __uint_as_float(__float_as_uint(h) ^ (mask0 >> i << 31));
        } else {
          bt = fmaf(ca[i], ha, cb[i] * hb);
        }
        const float q0 = G == 1 ? pm[i] : p0[G == 1 ? 0 : i];
        const float q1 = G == 1 ? pm[H + i] : p1[G == 1 ? 0 : i];
        const float x0 = q0 + bt, x1 = q1 - bt;   // into state 2*j0
        const float y0 = q0 - bt, y1 = q1 + bt;   // into state 2*j0 + 1
        nm[2 * i] = fmaxf(x0, x1);
        nm[2 * i + 1] = fmaxf(y0, y1);
        df[2 * i] = x0 - x1;       // negative where the upper predecessor wins
        df[2 * i + 1] = y0 - y1;
      }

      // the maximum: a tree over the lane's registers, then across lanes
      float tr[H];
#pragma unroll
      for (int r = 0; r < H; ++r) tr[r] = fmaxf(nm[r], nm[r + H]);
      max_tree<H / 2>(tr);
      float mx = tr[0];
#pragma unroll
      for (int lvl = 1; lvl < G; lvl *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, lvl));
#pragma unroll
      for (int r = 0; r < N; ++r) pm[r] = nm[r] - mx;

      // the lane's decision bits, bit r = state g*N + r
      const size_t word = (size_t)(TILE * tile + k) * B + b;
      if constexpr (N == 64) {
        const unsigned lo = pack_signs<32>(df), hi = pack_signs<32>(df + 32);
        if (valid) ((uint2*)dec)[word] = make_uint2(lo, hi);
      } else {
        const unsigned w = pack_signs<N>(df);
        static_assert(N == 8, "a lane's decisions are a byte or a word pair");
        if (valid) dec[word * 8 + g] = (unsigned char)w;
      }
    }
  }
  __syncthreads();  // the block's decision words are visible to its threads

  // traceback, one thread a packet, from state 0 (tail-terminated) at the
  // last step; bit t of the packet is the LSB of the state after step t
  if (tid < P && base + tid < B) {
    const uint2* dw = (const uint2*)dec + (base + tid);
    uint2 cur[CHUNK], nxt[CHUNK];
    int s = 0;
    unsigned acc = 0u;
    const int nchunks = (nsteps + CHUNK - 1) / CHUNK;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int t = (nchunks - 1) * CHUNK + k;
      cur[k] = t < nsteps ? dw[(size_t)t * B] : make_uint2(0u, 0u);
    }
    for (int c = nchunks - 1; c >= 0; --c) {
      if (c > 0) {  // the 16 steps before, in flight while these are walked
#pragma unroll
        for (int k = 0; k < CHUNK; ++k)
          nxt[k] = dw[(size_t)((c - 1) * CHUNK + k) * B];
      }
#pragma unroll
      for (int k = CHUNK - 1; k >= 0; --k) {
        const int t = c * CHUNK + k;
        if (t < nsteps) {
          acc |= (unsigned)(s & 1) << (t & 31);
          const unsigned w = (s & 32) ? cur[k].y : cur[k].x;
          s = (s >> 1) | (int)(((w >> (s & 31)) & 1u) << 5);
        }
      }
      if ((c * CHUNK) % 32 == 0) {  // steps [16c, 16c + 32) are walked
        bits_sh[tid * wstride + (c * CHUNK) / 32] = acc;
        acc = 0u;
      }
      if (c > 0) {
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) cur[k] = nxt[k];
      }
    }
  }
  __syncthreads();

  for (int p = 0; p < P && base + p < B; ++p) {
    int32_t* out = bits + (size_t)(base + p) * nbits;
    for (int t = tid; t < nbits; t += T)
      out[t] = (int32_t)((bits_sh[p * wstride + (t >> 5)] >> (t & 31)) & 1u);
  }
}

// the maximum of x over the warp: one integer reduction on the floats'
// ordered bit patterns (the magnitude bits of the negatives flipped; the
// map is its own inverse) in place of five shuffle rounds
__device__ __forceinline__ float warp_max(float x) {
  int o = __float_as_int(x);
  o ^= (o >> 31) & 0x7fffffff;
  o = __reduce_max_sync(FULL, o);
  o ^= (o >> 31) & 0x7fffffff;
  return __int_as_float(o);
}

// One warp a packet, two states a lane: the shape of least latency, for a
// batch too small to fill the card.  Lane l holds states 2l and 2l+1, whose
// predecessors l and 32+l four shuffles fetch; a step's decisions are two
// ballots, kept by lane t%32 for one coalesced store per 32 steps; the
// maximum is one warp reduction.
__global__ void __launch_bounds__(128)
viterbi_warp_kernel(const float* __restrict__ llrs, uint2* dec,
                    int32_t* __restrict__ bits, int B, int nsteps, int nbits,
                    unsigned mask0, unsigned mask1) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together

  // g[q][j][p]: the sign of output j on the branch from predecessor
  // p*32 + lane into state 2*lane + q (the butterfly's symmetry)
  float g[2][2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float sg = ((j ? mask1 : mask0) >> lane & 1u) ? -1.f : 1.f;
    g[0][j][0] = sg;
    g[0][j][1] = -sg;
    g[1][j][0] = -sg;
    g[1][j][1] = sg;
  }

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
    const float mx = warp_max(fmaxf(n0, n1));
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

template <int G, bool FIXED>
int launch(const float* llrs, void* dec, int32_t* bits, int B, int nsteps,
           int nbits, unsigned mask0, unsigned mask1, cudaStream_t stream) {
  constexpr int P = Shape<G>::P;
  const size_t smem = sizeof(float) * 2 * P * ROW +
                      sizeof(unsigned) * P * ((nsteps + 31) / 32 + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<G, FIXED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = nsteps % 2 == 0 && (uintptr_t)llrs % 16 == 0;
  viterbi_kernel<G, FIXED>
      <<<(B + P - 1) / P, Shape<G>::THREADS, smem, stream>>>(
          llrs, (unsigned char*)dec, bits, B, nsteps, nbits, vec, mask0,
          mask1);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The general instance, viterbi_general_kernel: every code the TPU kernel's
// gate takes (qpsk_tpu/packet/fec.py, viterbi_decode: 8 % rate_den == 0
// and nstates % 16 == 0, any generators), i.e. rate 1/1, 1/2, 1/4 or 1/8
// at K >= 5, here up to K = 15 (16 384 states), where the kernels above
// take K = 7 rate 1/2 with the newest and oldest taps.
//
// What it computes is the plain version's scan (ops/cuda/viterbi_kernel.py,
// viterbi_decode_plain), op for op: path metrics start at -1e9 with 0 in
// state 0; a step's branch metric of new state s' from predecessor p is
// bm = 0.5f * (((0 + g0*l0) + g1*l1) + ...), the signs g_j = +-1 from the
// code's table (``signs``: bit j of signs[p*S + s'] is set where
// _trellis's sgns[j, s', p] is -1); c_p = pm[p*S/2 + (s' >> 1)] + bm_p;
// the decision is c1 > c0; pm' = max(c0, c1), then pm' - max over all
// states; the traceback from state 0, s = (s >> 1) | (d << (K-2)).  Every
// operation rounds once in both (the products by +-1 are exact), so the
// bits are equal on every input.
//
// What bounds it on the H100: latency.  One block a packet and one thread
// a state (up to 1024 threads, S/1024 states a thread beyond), the path
// metrics in shared memory twice (ping-pong: 2 x 64 KB at K = 15), two
// barriers a step (the block's maximum, then the normalised metrics); the
// decisions packed as bits (a warp's ballot a word) into device memory,
// (B, nsteps, max(S/32, 1)) words, and one thread a packet traces back
// afterwards through them.  A simple kernel that is right: at K = 7 the
// kernels above are an order of magnitude faster and stay for that code.
constexpr int VG_MAXT = 1024;            // threads a block

__global__ void __launch_bounds__(VG_MAXT)
viterbi_general_kernel(const float* __restrict__ llrs,
                       const unsigned char* __restrict__ signs,
                       unsigned* __restrict__ dec, int32_t* __restrict__ bits,
                       int K, int rd, int nsteps, int nbits) {
  extern __shared__ float vg_sh[];
  const int S = 1 << (K - 1), half = S >> 1;
  const int W = S >= 32 ? S / 32 : 1;    // decision words a step
  float* pm = vg_sh;                     // [2][S]
  float* wmax = vg_sh + 2 * S;           // [32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nw = T / 32;
  const long long b = blockIdx.x;
  const float* ll = llrs + b * (long long)rd * nsteps;
  unsigned* db = dec + b * (long long)nsteps * W;
  for (int s = tid; s < S; s += T) pm[s] = s == 0 ? 0.f : -1e9f;
  __syncthreads();

  float nm[16];                          // a thread's new metrics, S/T <= 16
  int cur = 0;
  for (int t = 0; t < nsteps; ++t) {
    float l[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) l[j] = j < rd ? ll[(long long)t * rd + j] : 0.f;
    const float* a = pm + cur * S;
    float mx = __int_as_float(0xff800000);   // -inf
    for (int r = 0, s = tid; s < ((S + T - 1) / T) * T; ++r, s += T) {
      bool d = false;
      if (s < S) {
        const unsigned char m0 = signs[s], m1 = signs[S + s];
        float b0 = 0.f, b1 = 0.f;
        for (int j = 0; j < rd; ++j) {
          b0 = __fadd_rn(b0, (m0 >> j & 1) ? -l[j] : l[j]);
          b1 = __fadd_rn(b1, (m1 >> j & 1) ? -l[j] : l[j]);
        }
        const float c0 = __fadd_rn(a[s >> 1], __fmul_rn(0.5f, b0));
        const float c1 = __fadd_rn(a[half + (s >> 1)], __fmul_rn(0.5f, b1));
        d = c1 > c0;
        nm[r] = fmaxf(c0, c1);
        mx = fmaxf(mx, nm[r]);
      }
      const unsigned word = __ballot_sync(0xffffffffu, d);
      if (lane == 0 && s - lane < S) db[(long long)t * W + (s >> 5)] = word;
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) wmax[warp] = mx;
    __syncthreads();
    mx = wmax[0];
    for (int w = 1; w < nw; ++w) mx = fmaxf(mx, wmax[w]);
    float* nxt = pm + (cur ^ 1) * S;
    for (int r = 0, s = tid; s < S; ++r, s += T) nxt[s] = __fsub_rn(nm[r], mx);
    cur ^= 1;
    __syncthreads();
  }

  if (tid != 0) return;
  // the traceback, from state 0 (tail-terminated); the decisions were
  // written by this block, visible after its barriers
  int s = 0;
  int32_t* out = bits + b * nbits;
  for (int t = nsteps - 1; t >= 0; --t) {
    if (t < nbits) out[t] = s & 1;
    const unsigned w = db[(long long)t * W + (s >> 5)];
    s = (s >> 1) | ((int)((w >> (s & 31)) & 1u) << (K - 2));
  }
}

}  // namespace

// lanes: how many lanes hold a packet's trellis (1 or 8; 32: the warp
// kernel).  dec is scratch of 8 * nsteps * B bytes.  mask0, mask1: the
// code's sign masks (code_mask of its two generators).
extern "C" int qpsk_viterbi(const void* llrs, void* dec, void* bits, int B,
                            int nsteps, int nbits, int lanes, unsigned mask0,
                            unsigned mask1, void* stream) {
  const float* ll = (const float*)llrs;
  int32_t* out = (int32_t*)bits;
  cudaStream_t st = (cudaStream_t)stream;
  const bool fixed = mask0 == code_mask(POLY0) && mask1 == code_mask(POLY1);
  switch (lanes) {
    case 1:
      return (fixed ? launch<1, true> : launch<1, false>)(
          ll, dec, out, B, nsteps, nbits, mask0, mask1, st);
    case 8:
      return (fixed ? launch<8, true> : launch<8, false>)(
          ll, dec, out, B, nsteps, nbits, mask0, mask1, st);
    case 32:
      viterbi_warp_kernel<<<(B + 3) / 4, 128, 0, st>>>(
          ll, (uint2*)dec, out, B, nsteps, nbits, mask0, mask1);
      return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The general instance.  signs: (2, S) bytes, bit j of signs[p*S + s'] set
// where output j of the branch from predecessor p into state s' is a one;
// dec: scratch of 4 * B * nsteps * max(S/32, 1) bytes.  Takes K 2..15,
// rate 1/rd with rd 1..8.
extern "C" int qpsk_viterbi_gen(const void* llrs, const void* signs,
                                void* dec, void* bits, int B, int K, int rd,
                                int nsteps, int nbits, void* stream) {
  if (B < 1 || K < 2 || K > 15 || rd < 1 || rd > 8 || nsteps < K ||
      nbits > nsteps)
    return (int)cudaErrorInvalidValue;
  const int S = 1 << (K - 1);
  const int threads = S < 32 ? 32 : (S < VG_MAXT ? S : VG_MAXT);
  const size_t smem = sizeof(float) * (2 * (size_t)S + 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_general_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)llrs, (const unsigned char*)signs, (unsigned*)dec,
      (int32_t*)bits, K, rd, nsteps, nbits);
  return (int)cudaGetLastError();
}
