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
// The general instances: every code the TPU kernel's gate takes
// (qpsk_tpu/packet/fec.py, viterbi_decode: 8 % rate_den == 0 and
// nstates % 16 == 0, any generators), i.e. rate 1/1, 1/2, 1/4 or 1/8 at
// K >= 5, here any rate 1/rd with rd 1..8 at K 2..15 (16 384 states),
// where the kernels above take K = 7 rate 1/2 with the newest and oldest
// taps.
//
// What they compute is the plain version's scan (ops/cuda/viterbi_kernel.py,
// viterbi_decode_plain), op for op: path metrics start at -1e9 with 0 in
// state 0; the branch metric of pattern m (bit j set where output j is a
// one) is bm(m) = 0.5f * (((0 + s0*l0) + s1*l1) + ...), s_j = -1 where bit
// j is set; c_p = pm[p*S/2 + (s' >> 1)] + bm; the decision is c1 > c0; pm'
// = max(c0, c1) - max over all states; the traceback from state 0,
// s = (s >> 1) | (d << (K-2)).  Every operation rounds once in both (the
// products by +-1 are exact), so the bits are equal on every input.
//
// What bounds them on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md has
// the runs): instruction issue, some 20 instructions a state and step at
// 8 states a lane (exchange, butterflies, maximum, decision bits and the
// step's share of the table, tile and loop), against the 12 operations of
// the bound; and with few packets the latency of one warp's step, some 800
// cycles at 8 states a lane.  K = 9 takes 0.32 ms at 4096 packets, 6.6x
// its bound, 1.3 waves of 24 warps an SM (its decisions in shared memory
// bound the blocks an SM), and 0.10 ms at 156.  Their design:
//
//   - a thread holds N states (a template parameter) in registers at
//     compile-time indices, lane g of a packet's G = S/N lanes the states
//     [g*N, (g+1)*N).  Up to K = 11 a packet lives in one warp or part of
//     one (viterbi_general_kernel<N, CPL, DIRECT>: N = 2, 4 or 8 up to
//     K = 9, 16 at K = 10, 32 at K = 11; 128 threads a block, so several
//     packets a block, halved down to a warp while the batch leaves the
//     SMs fewer than two blocks each) and fetches its predecessors s'>>1
//     and S/2 + (s'>>1) in two rounds of shuffles, as viterbi_kernel<G>
//     does; its step loop is unrolled by two (9 % at K = 9);
//   - from K = 12 a block of S/32 threads holds a packet
//     (viterbi_general_block_kernel<CPL>) and the metrics cross through
//     shared memory with ONE barrier a step: a step stores its new metrics
//     un-normalised, with each warp's maximum, and the next step subtracts
//     the block maximum as it reads them.  (nm - mx) + bm is the plain
//     version's pm = nm - mx followed by pm + bm, the same two roundings in
//     the same order; the warp instances subtract on read too, so the
//     maximum's reduction runs beside the predecessors' shuffles;
//   - a step has at most 2^rd distinct branch values.  While 2^rd <= S
//     they are summed once a step, in the plain version's order, into a
//     table in shared memory (each of the G threads building it shares the
//     prefix of its patterns' low bits, then doubles a tree over the high
//     ones), and each butterfly reads its values from there; the wrapper
//     hands each butterfly its four patterns as the bytes of one word
//     (_pattern_table).  CPL instances are the codes whose generators all
//     tap the newest and the oldest bit (every code of the TPU gate's
//     tests): a butterfly's four branches then carry one value and its
//     negative, one table read a butterfly.  Where 2^rd > S (K = 5 at
//     rate 1/8) the DIRECT instances sum the values a butterfly, with no
//     table (compiled apart: in one kernel with the table path they cost
//     it registers, 96 for 62 at K = 9, and occupancy);
//   - the LLRs are staged through shared memory in tiles of 32 / rd steps
//     by cp.async, the next tile in flight while this one is consumed;
//   - the decisions are packed a bit a state (bit s & 31 of word s >> 5 of
//     the step).  The warp instances keep a block's in shared memory when
//     they fit in VG_SMEM_DEC bytes (K = 9 at 256 bits: 8.4 KB a packet),
//     else in the device-memory scratch; either way a packet's G lanes
//     trace back together, 16 steps' words loaded ahead into registers and
//     the word of the state's step fetched by a shuffle, and write the bits
//     coalesced.  The block instance writes the decisions to the scratch
//     and stages them back 2S/(S/32) = 64 steps at a time into the metric
//     buffers for warp 0 to walk.
//   Any nsteps and any batch size work with no padding.  Measured and not
// kept: 16 or 32 states a lane below K = 10 (0.397 and 0.417 ms against
// 0.378 at K = 9, 4096 packets); a minimum of blocks an SM in the launch
// bounds (no faster); the next table built before the butterflies (0.325
// against 0.309 ms); the decisions always in device memory (0.350 against
// 0.325 at K = 9, though 0.497 against 0.527 at K = 10, hence the 64 KB
// bound); the values summed a butterfly at every code (0.095 against
// 0.106 ms at 156 packets, 0.374 against 0.325 at 4096); a ballot a
// register for the decisions of a packet that fills a warp, as
// viterbi_warp_kernel stores them (0.385 against 0.326 ms at K = 9).
constexpr int GROW = 36;            // floats a packet's row of an LLR tile
                                    // takes: 32 / rd steps of rd LLRs
constexpr int GCH = 16;             // decision steps the traceback loads ahead
constexpr int VG_TBL = 256;         // the most branch values a step has
constexpr int VG_THREADS = 128;     // the most threads a block of the warp
                                    // instances has
constexpr int VG_BLOCK_THREADS = 512;  // the block instance's most threads
constexpr int VG_SMEM_DEC = 64 * 1024;  // the most shared memory a block of
                                        // the warp instances takes with its
                                        // decisions; past it, device memory

// x with its sign flipped where bit (0 or 1) is set: exactly -x
__device__ __forceinline__ float flip(float x, unsigned bit) {
  return __uint_as_float(__float_as_uint(x) ^ (bit << 31));
}

// the branch value of pattern m summed in the plain version's order
__device__ __forceinline__ float branch_value(unsigned m, const float (&l)[8],
                                              int rd) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < rd) acc = acc + flip(l[j], (m >> j) & 1u);
  return 0.5f * acc;
}

// One step's 2^rd branch values into tbl, built by G threads (a power of
// two), this one g, from the step's LLRs l[0 .. rd) in shared memory: the
// patterns m = g + G*i.  Where 2^rd <= G (every code at K >= 7 up to rate
// 1/4) threads g < 2^rd sum one pattern each, in straight-line code.
// Else the patterns' low log2 G bits are g's, so their sums share that
// prefix, and the high bits double a tree of at most V values, bit by bit
// in the plain order (x - l is x + (-l)).
template <int V>
__device__ __forceinline__ void build_table(const float* l, int rd, int g,
                                            int G, float* tbl) {
  const int gb = 31 - __clz(G);
  if (gb >= rd) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < rd) acc = acc + flip(l[j], (g >> j) & 1);
    if (g < (1 << rd)) tbl[g] = 0.5f * acc;
    return;
  }
  float acc = 0.f;
#pragma unroll 1
  for (int j = 0; j < gb; ++j) acc = acc + flip(l[j], (g >> j) & 1);
  float val[V];
  val[0] = acc;
#pragma unroll
  for (int lev = 0; (1 << lev) < V; ++lev) {
    if (lev >= rd - gb) break;
    const float lj = l[gb + lev];
#pragma unroll
    for (int i = 0; i < (1 << lev); ++i) {
      val[i + (1 << lev)] = val[i] - lj;
      val[i] = val[i] + lj;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (i >= (1 << (rd - gb))) break;
    tbl[g + G * i] = 0.5f * val[i];
  }
}

// The branch values of a thread's H butterflies into v: pw holds each
// butterfly's four branch patterns (p, u) = (0,0), (1,0), (0,1), (1,1) as
// bytes, vals(m) gives a pattern's value.  CPL: a butterfly's branches
// carry +-one value, v[i] = vals of (0,0); else v[4i + c] = vals of byte c.
// The values are all fetched before any is used, so their loads overlap.
template <bool CPL, int H, typename Vals>
__device__ __forceinline__ void branch_values(const unsigned (&pw)[H],
                                              Vals vals,
                                              float (&v)[CPL ? H : 4 * H]) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    if constexpr (CPL) {
      v[i] = vals(pw[i] & 0xffu);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[4 * i + c] = vals((pw[i] >> (8 * c)) & 0xffu);
    }
  }
}

// One butterfly: predecessors q0 (state j) and q1 (state S/2 + j), already
// normalised, into new states 2j (n0, decision sign d0) and 2j + 1 (n1,
// d1), with its branch values v (branch_values); CPL: (1,0) and (0,1)
// subtract the one value.
template <bool CPL>
__device__ __forceinline__ void butterfly(float q0, float q1, const float* v,
                                          float& n0, float& n1, float& d0,
                                          float& d1) {
  float x0, x1, y0, y1;
  if constexpr (CPL) {
    x0 = q0 + v[0];
    x1 = q1 - v[0];
    y0 = q0 - v[0];
    y1 = q1 + v[0];
  } else {
    x0 = q0 + v[0];
    x1 = q1 + v[1];
    y0 = q0 + v[2];
    y1 = q1 + v[3];
  }
  n0 = fmaxf(x0, x1);
  n1 = fmaxf(y0, y1);
  d0 = x0 - x1;   // negative where the upper predecessor wins: c1 > c0
  d1 = y0 - y1;
}

// N decision signs into the low N bits of a word, bit r from df[r]
template <int N>
__device__ __forceinline__ unsigned pack_bits(const float* df) {
  if constexpr (N >= 4) {
    return pack_signs<N>(df);
  } else {
    unsigned w = 0u;
#pragma unroll
    for (int r = 0; r < N; ++r) w |= (__float_as_uint(df[r]) >> 31) << r;
    return w;
  }
}

// a lane's N decision bits into step t's words at bit g*N (N < 8: one lane
// a packet, one word a step)
template <int N>
__device__ __forceinline__ void store_bits(unsigned* dec, int t, int DW,
                                           int g, unsigned w) {
  if constexpr (N == 32)
    dec[(size_t)t * DW + g] = w;
  else if constexpr (N == 16)
    ((unsigned short*)dec)[(size_t)t * DW * 2 + g] = (unsigned short)w;
  else if constexpr (N == 8)
    ((unsigned char*)dec)[(size_t)t * DW * 4 + g] = (unsigned char)w;
  else
    dec[t] = w;
}

template <int N, bool CPL, bool DIRECT>
__global__ void __launch_bounds__(VG_THREADS)
viterbi_general_kernel(const float* __restrict__ llrs,
                       const unsigned* __restrict__ patterns, unsigned* gdec,
                       int32_t* __restrict__ bits, int B, int K, int rd,
                       int nsteps, int nbits, int smem_dec, int vec) {
  constexpr int H = N / 2;
  const int S = 1 << (K - 1), G = S / N;   // lanes a packet, 1..32
  const int T = blockDim.x, P = T / G;     // packets a block
  const int tsteps = 32 / rd;              // steps a tile
  // DIRECT: 2^rd > S (S <= 128), no table: the values summed a butterfly
  const int tstride = DIRECT ? 0 : 2 * (1 << rd) + 1;  // a packet's tables
  const int DW = S >= 32 ? S / 32 : 1;     // decision words a step
  extern __shared__ __align__(16) float shm[];
  float* tiles = shm;                                        // 2 x P x GROW
  float* tbls = tiles + 2 * P * GROW;                        // P x tstride
  unsigned* sdec = (unsigned*)(tbls + (P * tstride + 3) / 4 * 4);
  const int tid = threadIdx.x, g = tid % G, pl = tid / G;
  const int base = blockIdx.x * P;
  const int b = base + pl;
  const bool valid = b < B;  // a packet past the batch stores nothing
  // the packet's decisions: (nsteps, DW) words in shared or device memory,
  // each reached through a pointer of its own space (one pointer that
  // could be either makes every store a generic one, which the compiler
  // orders against the shared loads after it: twice the step's time)
  unsigned* const sd = sdec + (size_t)pl * nsteps * DW;
  unsigned* const gd = gdec + (size_t)min(b, B - 1) * nsteps * DW;

  // one tile: P packets x tsteps steps x rd LLRs, rows of packets past the
  // batch repeat the last packet
  auto stage = [&](int tile) {
    float* dst = tiles + (tile & 1) * P * GROW;
    const int nf = tsteps * rd, f0 = tile * nf, row = rd * nsteps;
    if (vec) {  // rows and tiles 16-byte aligned: a copy is whole
      for (int q = tid; q < P * (nf / 4); q += T) {
        const int p = q / (nf / 4), part = q % (nf / 4);
        if (f0 + 4 * part < row)
          cp_async16(dst + p * GROW + 4 * part,
                     llrs + (size_t)min(base + p, B - 1) * row + f0 + 4 * part);
      }
    } else {
      for (int q = tid; q < P * nf; q += T) {
        const int p = q / nf, f = q % nf;
        if (f0 + f < row)
          cp_async4(dst + p * GROW + f,
                    llrs + (size_t)min(base + p, B - 1) * row + f0 + f);
      }
    }
    cp_async_commit();
  };
  // the LLRs of step k of a tile
  auto step_row = [&](int tile, int k) {
    return tiles + (tile & 1) * P * GROW + pl * GROW + k * rd;
  };

  // register r of lane g is state g*N + r; the metrics are kept as the
  // step left them, and mx is the maximum still to subtract (none at first)
  float pm[N];
#pragma unroll
  for (int r = 0; r < N; ++r) pm[r] = (g == 0 && r == 0) ? 0.f : -1e9f;
  float mx = 0.f;
  // butterfly i of lane g is j = g*H + i
  unsigned pw[H];
#pragma unroll
  for (int i = 0; i < H; ++i) pw[i] = patterns[g * H + i];
  float* tb = tbls + pl * tstride;
  const bool odd = g & 1, upper = g >= G / 2;
  const int src_even = g >> 1, src_odd = G / 2 + (g >> 1);

  const int ntiles = (nsteps + tsteps - 1) / tsteps;
  stage(0);
  cp_async_wait_all();
  __syncthreads();
  if (ntiles > 1) stage(1);
  int tile = 0, k = 0;
  // the next tile: wait for it (the other buffer is read out), start the
  // one after
  const auto next_tile = [&] {
    k = 0;
    ++tile;
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < ntiles) stage(tile + 1);
  };
  if constexpr (!DIRECT) build_table<N>(step_row(0, 0), rd, g, G, tb);
  __syncwarp();
#pragma unroll 2
  for (int t = 0; t < nsteps; ++t) {
    float v[CPL ? H : 4 * H];
    if constexpr (!DIRECT) {
      const float* tbl = tb + (t & 1) * (1 << rd);
      branch_values<CPL>(pw, [&](unsigned m) { return tbl[m]; }, v);
    } else {
      const float* lt = step_row(tile, k);
      float l[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) l[j] = j < rd ? lt[j] : 0.f;
      branch_values<CPL>(pw, [&](unsigned m) { return branch_value(m, l, rd); },
                         v);
    }

    // the predecessors of butterfly i: states j and S/2 + j, register
    // (g&1)*H + i of lanes g>>1 and G/2 + (g>>1), fetched in two rounds in
    // which each lane sends the register its own half holds
    float p0[H], p1[H];
    if (G == 1) {
#pragma unroll
      for (int i = 0; i < H; ++i) {
        p0[i] = pm[i];
        p1[i] = pm[H + i];
      }
    } else {
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
    for (int i = 0; i < H; ++i)
      butterfly<CPL>(p0[i] - mx, p1[i] - mx, v + (CPL ? i : 4 * i), nm[2 * i],
                     nm[2 * i + 1], df[2 * i], df[2 * i + 1]);

    // the maximum: a tree over the lane's registers, then across its lanes
    float tr[H];
#pragma unroll
    for (int r = 0; r < H; ++r) tr[r] = fmaxf(nm[r], nm[r + H]);
    if constexpr (H > 1) max_tree<H / 2>(tr);
    float m = tr[0];
    if (G == 32) {
      m = warp_max(m);
    } else {
      for (int lvl = 1; lvl < G; lvl *= 2)
        m = fmaxf(m, __shfl_xor_sync(FULL, m, lvl));
    }
#pragma unroll
    for (int r = 0; r < N; ++r) pm[r] = nm[r];
    mx = m;

    // the lane's decision bits, bit r = state g*N + r of the step's words
    const unsigned w = pack_bits<N>(df);
    if (smem_dec)
      store_bits<N>(sd, t, DW, g, w);
    else if (valid)
      store_bits<N>(gd, t, DW, g, w);

    // the next step's LLRs (a new tile: wait for it, start the one after)
    // and its branch table, into the other buffer
    if (t + 1 < nsteps) {
      if (++k == tsteps) next_tile();
      if constexpr (!DIRECT)
        build_table<N>(step_row(tile, k), rd, g, G,
                       tb + ((t + 1) & 1) * (1 << rd));
    }
    __syncwarp();  // the table is built and the decisions are stored
  }

  // traceback from state 0 (tail-terminated) at the last step; the G lanes
  // walk together, lane g < DW holding word g of each step of a chunk
  int32_t* out = bits + (size_t)b * nbits;
  int s = 0;
  unsigned acc = 0u;
  unsigned cur[GCH], nxt[GCH];
  auto load = [&](unsigned (&w)[GCH], int c) {
#pragma unroll
    for (int q = 0; q < GCH; ++q) {
      const int t = c * GCH + q;
      const size_t at = (size_t)t * DW + g;
      w[q] = g >= DW || t >= nsteps ? 0u : smem_dec ? sd[at] : gd[at];
    }
  };
  const int nchunks = (nsteps + GCH - 1) / GCH;
  load(cur, nchunks - 1);
  for (int c = nchunks - 1; c >= 0; --c) {
    if (c > 0) load(nxt, c - 1);  // in flight while these are walked
#pragma unroll
    for (int q = GCH - 1; q >= 0; --q) {
      const int t = c * GCH + q;
      if (t < nsteps) {
        acc |= (unsigned)(s & 1) << (t & 31);
        const unsigned w = __shfl_sync(FULL, cur[q], s >> 5, G);
        s = (s >> 1) | (int)(((w >> (s & 31)) & 1u) << (K - 2));
      }
    }
    if ((c * GCH) % 32 == 0) {  // steps [16c, 16c + 32) are walked
      const int t0 = c * GCH;
      if (valid)
        for (int i = g; i < 32 && t0 + i < nbits; i += G)
          out[t0 + i] = (int32_t)((acc >> i) & 1u);
      acc = 0u;
    }
    if (c > 0) {
#pragma unroll
      for (int q = 0; q < GCH; ++q) cur[q] = nxt[q];
    }
  }
}

// a 16-byte chunk's place in the block instance's metric arrays: chunk q
// moves within its row of eight by q >> 3, so that neither a thread's
// reads (4 chunks from 4*tid) nor its writes (8 chunks from 8*tid) put
// two threads of a quarter warp on one bank
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 7); }

template <bool CPL>
__global__ void __launch_bounds__(VG_BLOCK_THREADS)
viterbi_general_block_kernel(const float* __restrict__ llrs,
                             const unsigned* __restrict__ patterns,
                             unsigned* dec, int32_t* __restrict__ bits, int K,
                             int rd, int nsteps, int nbits) {
  constexpr int N = 32, H = 16;
  const int S = 1 << (K - 1), T = blockDim.x;  // T = S / 32, a word a step
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = T >> 5;
  extern __shared__ __align__(16) float shm[];
  float4* pmb = (float4*)shm;           // [2][S/4] chunks, swizzled
  float* wmax = shm + 2 * S;            // [2][32] the warps' maxima
  float* tbl = wmax + 64;               // [2][VG_TBL] branch tables
  float* lsh = tbl + 2 * VG_TBL;        // [2][8] a step's LLRs
  const long long b = blockIdx.x;
  const float* ll = llrs + b * rd * nsteps;
  unsigned* db = dec + b * (long long)nsteps * T;

  // the thread's N states [32 tid, 32 tid + 32), un-normalised, and its
  // warp's maximum (0 in warp 0, which holds state 0)
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float v = (tid == 0 && c == 0) ? 0.f : -1e9f;
    pmb[swz(8 * tid + c)] = make_float4(v, -1e9f, -1e9f, -1e9f);
  }
  if (lane == 0) wmax[warp] = warp == 0 ? 0.f : -1e9f;
  unsigned pw[H];
#pragma unroll
  for (int i = 0; i < H; ++i) pw[i] = patterns[tid * H + i];
  // step t's table is built in step t - 1 from its LLRs, which thread
  // j < rd fetched from device memory in step t - 2 and stored to lsh
  if (tid < rd) {
    lsh[tid] = ll[tid];
    if (nsteps > 1) lsh[8 + tid] = ll[rd + tid];
  }
  __syncthreads();
  build_table<4>(lsh, rd, tid, T, tbl);
  __syncthreads();

#pragma unroll 1
  for (int t = 0; t < nsteps; ++t) {
    const int cur = t & 1;
    const float4* a = pmb + cur * (S / 4);
    float4* o = pmb + (cur ^ 1) * (S / 4);
    const bool fetch = tid < rd && t + 2 < nsteps;
    const float lnext = fetch ? ll[(size_t)(t + 2) * rd + tid] : 0.f;
    // the next step's table, before the butterflies, whose chain it overlaps
    if (t + 1 < nsteps)
      build_table<4>(lsh + (cur ^ 1) * 8, rd, tid, T, tbl + (cur ^ 1) * VG_TBL);
    const float mx = warp_max(wmax[cur * 32 + (lane < nw ? lane : 0)]);
    // predecessors: states [16 tid, 16 tid + 16) and S/2 + the same
    float q0[H], q1[H];
#pragma unroll
    for (int c = 0; c < H / 4; ++c) {
      const float4 u = a[swz(4 * tid + c)], v = a[swz(S / 8 + 4 * tid + c)];
      q0[4 * c] = u.x - mx;
      q0[4 * c + 1] = u.y - mx;
      q0[4 * c + 2] = u.z - mx;
      q0[4 * c + 3] = u.w - mx;
      q1[4 * c] = v.x - mx;
      q1[4 * c + 1] = v.y - mx;
      q1[4 * c + 2] = v.z - mx;
      q1[4 * c + 3] = v.w - mx;
    }
    const float* tb = tbl + cur * VG_TBL;
    float v[CPL ? H : 4 * H];
    branch_values<CPL>(pw, [&](unsigned m) { return tb[m]; }, v);
    float nm[N], df[N];
#pragma unroll
    for (int i = 0; i < H; ++i)
      butterfly<CPL>(q0[i], q1[i], v + (CPL ? i : 4 * i), nm[2 * i],
                     nm[2 * i + 1], df[2 * i], df[2 * i + 1]);

    float tr[H];
#pragma unroll
    for (int r = 0; r < H; ++r) tr[r] = fmaxf(nm[r], nm[r + H]);
    max_tree<H / 2>(tr);
    const float m = warp_max(tr[0]);
    if (lane == 0) wmax[(cur ^ 1) * 32 + warp] = m;
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      o[swz(8 * tid + c)] = make_float4(nm[4 * c], nm[4 * c + 1],
                                        nm[4 * c + 2], nm[4 * c + 3]);
    db[(size_t)t * T + tid] = pack_signs<N>(df);
    if (fetch) lsh[cur * 8 + tid] = lnext;  // step t + 2's, read after the barrier
    __syncthreads();
  }

  // traceback: the decisions come back 64 steps at a time into the metric
  // buffers (2S floats, S/32 words a step), warp 0 walks them
  const int chunk = 2 * S / T;
  int32_t* out = bits + b * nbits;
  int s = 0;
  unsigned acc = 0u;
  for (int c0 = (nsteps - 1) / chunk * chunk; c0 >= 0; c0 -= chunk) {
    const int n = min(chunk, nsteps - c0);
    __syncthreads();  // the buffers are read out
    const uint4* src = (const uint4*)(db + (size_t)c0 * T);
    uint4* dst = (uint4*)shm;
    for (int i = tid; i < n * T / 4; i += T) dst[i] = src[i];
    __syncthreads();
    if (warp == 0) {
      const unsigned* st = (const unsigned*)shm;
      for (int t = c0 + n - 1; t >= c0; --t) {
        acc |= (unsigned)(s & 1) << (t & 31);
        const unsigned w = st[(t - c0) * T + (s >> 5)];
        s = (s >> 1) | (int)(((w >> (s & 31)) & 1u) << (K - 2));
        if ((t & 31) == 0) {
          if (t + lane < nbits) out[t + lane] = (int32_t)((acc >> lane) & 1u);
          acc = 0u;
        }
      }
    }
  }
}

// the card's SMs, asked once
int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

template <int N, bool CPL, bool DIRECT>
int launch_general(const float* llrs, const unsigned* patterns, unsigned* dec,
                   int32_t* bits, int B, int K, int rd, int nsteps, int nbits,
                   cudaStream_t stream) {
  const int S = 1 << (K - 1), G = S / N;
  // VG_THREADS a block, halved (down to a warp) while the batch would give
  // the SMs fewer than two blocks each
  int T = VG_THREADS;
  while (T > 32 && T > G && (long long)B * G < 2LL * sm_count() * T) T /= 2;
  const int P = T / G;
  const int DW = S >= 32 ? S / 32 : 1;
  const int tstride = DIRECT ? 0 : 2 * (1 << rd) + 1;
  const size_t fixed = sizeof(float) * (2 * P * GROW + (P * tstride + 3) / 4 * 4);
  const size_t decb = sizeof(unsigned) * (size_t)P * nsteps * DW;
  const int smem_dec = fixed + decb <= VG_SMEM_DEC;
  const size_t smem = fixed + (smem_dec ? decb : 0);
  const auto kernel = viterbi_general_kernel<N, CPL, DIRECT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nf = 32 / rd * rd;
  const int vec = (rd * nsteps) % 4 == 0 && nf % 4 == 0 &&
                  (uintptr_t)llrs % 16 == 0;
  kernel<<<(B + P - 1) / P, T, smem, stream>>>(
      llrs, patterns, dec, bits, B, K, rd, nsteps, nbits, smem_dec, vec);
  return (int)cudaGetLastError();
}

template <bool CPL>
int launch_general_block(const float* llrs, const unsigned* patterns,
                         unsigned* dec, int32_t* bits, int B, int K, int rd,
                         int nsteps, int nbits, cudaStream_t stream) {
  const int S = 1 << (K - 1);
  const size_t smem = sizeof(float) * (2 * (size_t)S + 64 + 2 * VG_TBL + 16);
  const auto kernel = viterbi_general_block_kernel<CPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, S / 32, smem, stream>>>(llrs, patterns, dec, bits, K, rd,
                                      nsteps, nbits);
  return (int)cudaGetLastError();
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

// The general instances.  patterns: (S/2,) words, butterfly j's four
// branch patterns as bytes (bit k set where output k of the branch is a
// one), the branch from predecessor p into state 2j + u at byte p + 2u;
// cpl: every generator taps the newest and the oldest bit, so a
// butterfly's branches carry +-one value; spt: the states a thread holds,
// 2, 4, 8, 16 or 32 with S/spt <= 32 lanes a packet, or 32 from K = 12
// (the block instance, S/32 threads); dec: scratch of 4 * B * nsteps *
// max(S/32, 1) bytes.  Takes K 2..15, rate 1/rd with rd 1..8.
extern "C" int qpsk_viterbi_gen(const void* llrs, const void* patterns,
                                void* dec, void* bits, int B, int K, int rd,
                                int nsteps, int nbits, int spt, int cpl,
                                void* stream) {
  if (B < 1 || K < 2 || K > 15 || rd < 1 || rd > 8 || nsteps < K ||
      nbits > nsteps || spt < 2 || spt > 32 || (spt & (spt - 1)) != 0 ||
      spt > (1 << (K - 1)) ||
      ((1 << rd) > (1 << (K - 1)) && spt > 8))  // summed a butterfly: N <= 8
    return (int)cudaErrorInvalidValue;
  const float* ll = (const float*)llrs;
  const unsigned* pt = (const unsigned*)patterns;
  unsigned* d = (unsigned*)dec;
  int32_t* out = (int32_t*)bits;
  cudaStream_t st = (cudaStream_t)stream;
  if ((1 << (K - 1)) / spt > 32) {
    if (spt != 32) return (int)cudaErrorInvalidValue;
    return (cpl ? launch_general_block<true> : launch_general_block<false>)(
        ll, pt, d, out, B, K, rd, nsteps, nbits, st);
  }
  using Launch = int (*)(const float*, const unsigned*, unsigned*, int32_t*,
                         int, int, int, int, int, cudaStream_t);
  constexpr Launch by_spt[5][2] = {
      {launch_general<2, false, false>, launch_general<2, true, false>},
      {launch_general<4, false, false>, launch_general<4, true, false>},
      {launch_general<8, false, false>, launch_general<8, true, false>},
      {launch_general<16, false, false>, launch_general<16, true, false>},
      {launch_general<32, false, false>, launch_general<32, true, false>}};
  // 2^rd > S: the values summed a butterfly (spt <= 8, checked above)
  constexpr Launch direct_by_spt[3][2] = {
      {launch_general<2, false, true>, launch_general<2, true, true>},
      {launch_general<4, false, true>, launch_general<4, true, true>},
      {launch_general<8, false, true>, launch_general<8, true, true>}};
  const bool direct = (1 << rd) > (1 << (K - 1));
  return (direct ? direct_by_spt : by_spt)[__builtin_ctz(spt) - 1][cpl ? 1 : 0](
      ll, pt, d, out, B, K, rd, nsteps, nbits, st);
}
