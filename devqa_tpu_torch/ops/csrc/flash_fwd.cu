// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces the TPU kernel devqa_tpu/ops/attention.py::_flash_kernel
// (launched by _flash_fwd). Same contract:
//   O = softmax(Q K^T / sqrt(D) + mask) V, online softmax with running
//   max m and sum l in f32, masked scores set to -1e30 (never -inf);
//   mask = kv_valid[b, key] != 0 (any pattern, optional), causal with the
//   diagonal offset Lk - Lq, and bounds for ragged Lq / Lk;
//   P is rounded to bf16 before P V (the TPU kernel casts p to v's dtype);
//   a row that sees no live key gets exact zeros and lse = -1e30;
//   optional lse = m + log(l), f32 [B, H, Lq].
//
// Layout: q [B, H, Lq, D], k / v [B, H, Lk, D], o like q, all contiguous
// and 16-byte aligned bf16; kv_valid int32 [B, Lk] or null. D is a
// multiple of 8 padding to DP = round_up(D, 16) in {64, 80, 96, 128}: the
// paths' head dims are 64 (Q-Former, CLIP-L), 80 (OPT), 88 (EVA ViT, DP
// 96) and 128 (Vicuna).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): bytes, at
// every path shape. The OPT post pass (120 x 32 heads x 64 tokens, D 80)
// moves q + k + v + o = 157 MB (47 us) for 2.7 GFLOP of products (3 us);
// the ViT (8 images x 16 heads x 257 tokens, D 88) moves 23 MB (7 us)
// for 2.7 GFLOP. LLaVA's decoder rows (30 x 32 heads x 640 tokens, D 128)
// move 629 MB (188 us) for about 1e11 FLOP of live products (100 us), and
// its CLIP-L tower (8 x 16 heads x 577 tokens, D 64) 38 MB (11 us) for
// 1.1e10 (11 us): closer to balanced, still bytes first. So what the card
// lacks is bytes in flight and latency hidden, not tensor-core rate. The
// first version of this kernel (WMMA, accumulators in shared memory) ran
// 4-26x its bound. This design, by the causes it removes:
//
// 1. Accumulators in registers. Each of a block's 4 warps owns 16 query
//    rows and runs mma.sync.m16n8k16 (bf16 -> f32) fed by ldmatrix (.trans
//    for V). S = Q K^T stays in C fragments; the online softmax works on
//    them in place (a row's max over the 4 lanes of a quad by two
//    shuffles, its sum kept per lane and combined once at the end); the C
//    fragments rounded to bf16 are the A fragments of P V, so P never
//    touches shared memory; O's rescale multiplies registers. Q's
//    fragments are loaded once. Scores stay unscaled; the scale and log2 e
//    fold into one fma before ex2.approx.
// 2. Loads in flight during the math. K/V tiles sit in a ring of two
//    stages filled by cp.async groups. K and V of a tile are separate
//    groups, so Q K^T starts while V is still arriving; tile t+1's copies
//    fly while tile t is used, and tile t+2's are issued as soon as every
//    warp is done with tile t's stage. A row is 8 or 16 threads with one
//    16-byte chunk each, so a thread's copies are one column at a fixed
//    row stride: an add and a compare per copy (a flat chunk index spent
//    much of the loop on address arithmetic). A deeper ring (3 or 4
//    stages) measured no faster.
// 3. One-tile heads (L <= 64: OPT, Q-Former self): small blocks, many
//    resident, rather than a persistent grid. One stage (27-40 KB) is all
//    such a launch takes; 3 blocks of 4 warps fit an SM by registers, so
//    one block's loads overlap the others' math and stores, and Q and K
//    arrive in one group, V in the next.
// 4. Ragged tails and masks cost selects, not branches. A key tile always
//    runs its four 16-key steps (skipping steps past Lk or past the
//    diagonal by branches measured slower than computing them); keys past
//    Lk are zero-filled by the copies, which read nothing for them, and
//    masked. Tiles wholly above the block's diagonal are skipped; a warp
//    whose rows are past Lq, or that has no live key in a tile, skips the
//    tile and leaves m, l and O exactly as they were. A tile with every key
//    in range and neither mask nor causal limit skips the masking. The
//    257th ViT row still takes a fifth block of 64 rows (one warp working).
// 5. Wide stores. Each warp rounds its 16 rows of O to bf16 into shared
//    memory (Q's buffer) and writes them with 16-byte stores, neighbouring
//    lanes on neighbouring addresses (a warp's rows are contiguous in
//    global memory; D * 2 bytes is a multiple of 16 for every D). The lse
//    is written once per row.
//
// Shared memory per block (row stride DP + 8 bf16, so the 8 rows of an
// ldmatrix fall in distinct banks: at DP 128 the stride is 272 bytes, 68
// words, and 8 rows start 4 banks apart): Q 64 x (DP+8) x 2 bytes, and per
// stage K and V 64 x (DP+8) x 2 bytes each plus 64 mask ints. Bytes for
// one stage (Lk <= 64) / two stages:
//   DP 64: 27,904 / 46,592;  DP 80: 34,048 / 56,832;  DP 96: 40,192 / 67,072;
//   DP 128: 52,480 / 87,552.
// __launch_bounds__(128, 3) caps a thread at 168 registers, so every
// instantiation up to DP 96 holds 3 blocks (12 warps) per SM; shared
// memory alone would allow 8 / 4, 6 / 4 and 5 / 3. DP 128 keeps O (64
// registers a thread), Q's fragments (32) and S (32) in registers, about
// 200 with addresses and softmax state, and takes __launch_bounds__(128,
// 2): 255 registers at most, 2 blocks per SM, which two stages of shared
// memory (2 x 87,552 bytes) also allow. ptxas (sm_90a, CUDA 12.8, -O3) and
// the CUDA runtime on an H100 80GB HBM3, registers / spill bytes a thread,
// <DP, mask, causal>; static shared memory 0 everywhere (the ring is
// dynamic, bytes above):
//   < 64,0,0> 137/0   < 64,0,1> 150/0   < 64,1,0> 148/0   < 64,1,1> 154/0
//   < 80,0,0> 149/0   < 80,0,1> 164/0   < 80,1,0> 160/0   < 80,1,1> 166/0
//   < 96,0,0> 161/0   < 96,0,1> 168/12  < 96,1,0> 160/0   < 96,1,1> 168/0
//   <128,0,0> 192/0   <128,0,1> 214/0   <128,1,0> 196/0   <128,1,1> 218/0
// (DP 128: 2 resident blocks per SM, 52,480 / 87,552 bytes of dynamic
// shared memory, as the runtime reports.)
// The 12 bytes are in the causal, mask-free DP 96 instantiation, which no
// path launches. chip_smoke.py's build line prints these for every build,
// DP 128's among them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

using namespace devqa;

namespace {

constexpr int BQ = 64;            // query rows per block, 16 per warp
constexpr int BK = 64;            // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int STAGES = 2;         // K/V tiles in the shared-memory ring

// Resident blocks per SM the register budget is set for (see the note).
template <int DP>
constexpr int min_blocks() { return DP <= 96 ? 3 : 2; }
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DP>
struct Smem {
  static constexpr int LD = DP + 8;  // bf16 row stride of Q, K, V
  static constexpr int Q_BYTES = BQ * LD * 2;
  static constexpr int KV_BYTES = BK * LD * 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + BK * 4;  // K, V, mask
  static constexpr int bytes(int stages) { return Q_BYTES + stages * STAGE_BYTES; }
};

// Start copying rows [r0, r0 + NROWS) of a [len, D] bf16 matrix into
// shared memory (row stride DP + 8), zero-filling rows past len and
// columns D..DP, so padding adds exact zeros to every product. A row is
// LPR threads with one 16-byte chunk each, so a thread's chunks are one
// column at a fixed row stride: one add and one compare per copy.
template <int DP, int NROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int len, int D) {
  constexpr int LD = Smem<DP>::LD;
  constexpr int LPR = DP <= 64 ? 8 : 16;  // a power of two >= DP / 8
  constexpr int RPP = NTHREADS / LPR;     // rows per pass
  const int c = (threadIdx.x % LPR) * 8;
  const int r = threadIdx.x / LPR;
  if (c >= DP) return;
  const bool col_in = c < D;
  const bf16* s = src + (size_t)(r0 + r) * D + c;
  bf16* d = dst + r * LD + c;
#pragma unroll
  for (int i = 0; i < NROWS / RPP; ++i) {
    const bool in = col_in && r0 + r + i * RPP < len;
    cp_async_16(d + i * RPP * LD, in ? s + (size_t)i * RPP * D : src, in);
  }
}

// S += Q K^T for one key tile. k_addr: this lane's ldmatrix row address
// in the tile (bytes, shared window); every other offset is a constant.
template <int DP>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 8][4], const uint32_t (&qa)[DP / 16][4],
                                        uint32_t k_addr) {
  constexpr int LD = Smem<DP>::LD;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < BK / 16; ++jp) {
      uint32_t kb[4];
      ldmatrix_x4(kb, k_addr + (jp * 16 * LD + kk * 16) * 2);
      mma_bf16_16816(s[2 * jp], qa[kk], kb[0], kb[1]);
      mma_bf16_16816(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
    }
  }
}

// O += P V for one key tile; v_addr as k_addr, for the transposed loads.
template <int DP>
__device__ __forceinline__ void pv_tile(float (&acc)[DP / 8][4], const uint32_t (&pa)[BK / 16][4],
                                        uint32_t v_addr) {
  constexpr int LD = Smem<DP>::LD;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, v_addr + (kk * 16 * LD + dp * 16) * 2);
      mma_bf16_16816(acc[2 * dp], pa[kk], vb[0], vb[1]);
      mma_bf16_16816(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
    }
  }
}

template <int DP, bool HAS_MASK, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, min_blocks<DP>())
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_valid,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int Lq, int Lk, int D, int n_qtiles, float scale_log2) {
  using S = Smem<DP>;
  constexpr int LD = S::LD;
  constexpr int KSTEPS = DP / 16;  // 16-deep steps of Q K^T
  constexpr int DTILES = DP / 8;   // 8-column tiles of O
  constexpr int NT = BK / 8;       // 8-key tiles of S
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int b = bh / H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int wrow0 = q0 + warp * 16;  // this warp's first query row
  const bool warp_live = wrow0 < Lq;
  const int wlast = min(wrow0 + 15, Lq - 1);
  const int causal_offset = Lk - Lq;
  const bf16* qg = q + (size_t)bh * Lq * D;
  const bf16* kg = k + (size_t)bh * Lk * D;
  const bf16* vg = v + (size_t)bh * Lk * D;
  const int* mg = HAS_MASK ? kv_valid + (size_t)b * Lk : nullptr;

  int n_tiles = (Lk + BK - 1) / BK;
  if (CAUSAL) {
    // Tiles wholly above the diagonal of every row of this block change
    // nothing: skip them (and all later ones).
    const int last_key = min(q0 + BQ, Lq) - 1 + causal_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BK + 1);
  }

  auto k_stage = [&](int t) {
    return reinterpret_cast<bf16*>(smem + S::Q_BYTES + (t % STAGES) * S::STAGE_BYTES);
  };
  auto v_stage = [&](int t) { return k_stage(t) + BK * LD; };
  auto m_stage = [&](int t) { return reinterpret_cast<int*>(k_stage(t) + 2 * BK * LD); };
  // Tile t's K (with its mask) and V, each closed as its own group of
  // copies (an empty group past the last tile).
  auto load_k = [&](int t) {
    if (t < n_tiles) {
      load_rows<DP, BK>(k_stage(t), kg, t * BK, Lk, D);
      if (HAS_MASK && threadIdx.x < BK) {
        const int key = t * BK + threadIdx.x;
        cp_async_4(m_stage(t) + threadIdx.x, key < Lk ? mg + key : mg, key < Lk);
      }
    }
    cp_async_commit();
  };
  auto load_v = [&](int t) {
    if (t < n_tiles) load_rows<DP, BK>(v_stage(t), vg, t * BK, Lk, D);
    cp_async_commit();
  };

  // Q joins tile 0's K group; then V0, K1, V1.
  load_rows<DP, BQ>(Qs, qg, q0, Lq, D);
#pragma unroll
  for (int t = 0; t < STAGES; ++t) {
    load_k(t);
    load_v(t);
  }

  // This lane's ldmatrix row addresses: Q (A operand), K (B operand, keys
  // as rows), V (B operand transposed).
  const uint32_t q_addr =
      smem_addr(Qs) + ((warp * 16 + lane % 16) * LD + (lane / 16) * 8) * 2;
  const uint32_t k_lane = (((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8) * 2;
  const uint32_t v_lane = ((((lane / 8) % 2) * 8 + lane % 8) * LD + (lane / 16) * 8) * 2;

  uint32_t qa[KSTEPS][4];
  float acc[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  // This thread's rows are wrow0 + g (h = 0) and wrow0 + g + 8 (h = 1):
  // m, the row's running max of the unscaled score; l, the sum of
  // 2^((s - m) * scale * log2 e) over this lane's columns.
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    cp_async_wait<2 * STAGES - 1>();  // K_t (and Q) landed; V_t, K_t+1, V_t+1 may be in flight
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qa[kk], q_addr + kk * 32);
    }
    // A tile with every key in range and neither mask nor causal limit
    // needs no masking.
    const bool plain = !HAS_MASK && !CAUSAL && k0 + BK <= Lk;
    // Bit 2j+e: this lane's column 8j + 2c + e is in range and unmasked.
    uint32_t colbits = 0xffffu;
    if (!plain) {
      colbits = 0;
      const int* ms = m_stage(t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * c;
        int2 mv = make_int2(1, 1);
        if (HAS_MASK) mv = *reinterpret_cast<const int2*>(ms + col);
        if (k0 + col < Lk && mv.x != 0) colbits |= 1u << (2 * j);
        if (k0 + col + 1 < Lk && mv.y != 0) colbits |= 2u << (2 * j);
      }
    }
    // A warp whose rows are past Lq, or above the diagonal of the whole
    // tile, or that sees no live key in it, skips the tile: m, l and O stay.
    const bool math = __any_sync(0xffffffffu, warp_live && colbits != 0 &&
                                                  (!CAUSAL || k0 <= wlast + causal_offset));

    uint32_t pa[BK / 16][4];  // P as the A fragments of P V, one per 16 keys
    if (math) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t stage_addr = smem_addr(k_stage(t));
      qk_tile<DP>(s, qa, stage_addr + k_lane);
      // Mask by select: dead entries are exactly -1e30.
      if (!plain) {
        // Under the causal mask, column 8j + e of this lane is live in row
        // h while 8j + e <= diag[h].
        const int diag0 = wrow0 + g + causal_offset - k0 - 2 * c;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = i % 2, h = i / 2;
            bool live = (colbits >> (2 * j + e)) & 1u;
            if (CAUSAL) live = live && 8 * j + e <= diag0 + 8 * h;
            s[j][i] = live ? s[j][i] : NEG_INF;
          }
        }
      }
      float mx[2] = {NEG_INF, NEG_INF}, corr[2], msc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        // 1 when the max did not move (also while the row has seen no live
        // key), 0 when it first leaves -1e30.
        corr[h] = ex2_approx((m_r[h] - m_new) * scale_log2);
        m_r[h] = m_new;
        // While the row has no live key, 0 keeps every 2^(-1e30 * ...) zero.
        msc[h] = m_new <= NEG_INF / 2 ? 0.f : m_new * scale_log2;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = ex2_approx(fmaf(s[j][i], scale_log2, -msc[i / 2]));
          rs[i / 2] += s[j][i];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * corr[h] + rs[h];
#pragma unroll
      for (int d = 0; d < DTILES; ++d) {
        acc[d][0] *= corr[0];
        acc[d][1] *= corr[0];
        acc[d][2] *= corr[1];
        acc[d][3] *= corr[1];
      }
    }

    cp_async_wait<2 * STAGES - 2>();  // V_t landed
    __syncthreads();
    if (math) pv_tile<DP>(acc, pa, smem_addr(v_stage(t)) + v_lane);
    __syncthreads();  // every warp is done with this stage: refill it
    load_k(t + STAGES);
    load_v(t + STAGES);
  }

  // Finalize. A row that never saw a live key (m stayed -1e30) or whose
  // sum is zero is dead: exact zeros and lse = -1e30.
  cp_async_wait<0>();
  __syncthreads();  // every copy into Q's buffer has landed: reuse it for O
  bf16* os = Qs + warp * 16 * LD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    const bool dead = m_r[h] <= NEG_INF / 2 || l_r[h] == 0.f;
    const float inv = dead ? 0.f : 1.f / l_r[h];
#pragma unroll
    for (int d = 0; d < DTILES; ++d)
      *reinterpret_cast<uint32_t*>(os + (g + 8 * h) * LD + 8 * d + 2 * c) =
          pack_bf16x2(dead ? 0.f : acc[d][2 * h] * inv, dead ? 0.f : acc[d][2 * h + 1] * inv);
    const int row = wrow0 + g + 8 * h;
    if (lse != nullptr && c == 0 && row < Lq)
      lse[(size_t)bh * Lq + row] =
          dead ? NEG_INF : m_r[h] * (scale_log2 * LN2) + logf(l_r[h]);
  }
  __syncwarp();
  const int nrows = min(16, Lq - wrow0);
  if (nrows > 0) {
    const int ch = D / 8;  // 16-byte chunks per row
    bf16* og = o + ((size_t)bh * Lq + wrow0) * D;
    for (int i = lane; i < nrows * ch; i += 32) {
      const int r = i / ch;
      const int col = (i - r * ch) * 8;
      *reinterpret_cast<uint4*>(og + (size_t)r * D + col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
    }
  }
}

// Lets the instantiation take the two-stage ring's shared memory (over the
// 48 KB default) and prefer shared memory to L1; *smem = the dynamic bytes
// a launch over Lk keys takes (one stage when one key tile is all).
template <int DP, bool HAS_MASK, bool CAUSAL>
cudaError_t configure(int Lk, int* smem) {
  auto kern = flash_fwd_kernel<DP, HAS_MASK, CAUSAL>;
  *smem = Smem<DP>::bytes(min(STAGES, (Lk + BK - 1) / BK));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<DP>::bytes(STAGES));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int DP, bool HAS_MASK, bool CAUSAL>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const int* kv_valid, bf16* o,
                   float* lse, int B, int H, int Lq, int Lk, int D, float scale,
                   cudaStream_t stream) {
  int smem;
  cudaError_t err = configure<DP, HAS_MASK, CAUSAL>(Lk, &smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (Lq + BQ - 1) / BQ;
  const long long blocks = (long long)B * H * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<DP, HAS_MASK, CAUSAL><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      q, k, v, kv_valid, o, lse, H, Lq, Lk, D, n_qtiles, scale * LOG2E);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v, const int* kv_valid, bf16* o,
                     float* lse, int B, int H, int Lq, int Lk, int D, int causal, float scale,
                     cudaStream_t stream) {
  if (kv_valid != nullptr) {
    if (causal) return launch<DP, true, true>(q, k, v, kv_valid, o, lse, B, H, Lq, Lk, D, scale, stream);
    return launch<DP, true, false>(q, k, v, kv_valid, o, lse, B, H, Lq, Lk, D, scale, stream);
  }
  if (causal) return launch<DP, false, true>(q, k, v, kv_valid, o, lse, B, H, Lq, Lk, D, scale, stream);
  return launch<DP, false, false>(q, k, v, kv_valid, o, lse, B, H, Lq, Lk, D, scale, stream);
}

// Resources of the instantiation a launch with these arguments takes.
template <int DP, bool HAS_MASK, bool CAUSAL>
cudaError_t info(int Lk, int* out) {
  auto kern = flash_fwd_kernel<DP, HAS_MASK, CAUSAL>;
  int smem, blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t err = configure<DP, HAS_MASK, CAUSAL>(Lk, &smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return cudaSuccess;
}

template <int DP>
cudaError_t info_dp(int has_mask, int causal, int Lk, int* out) {
  if (has_mask) return causal ? info<DP, true, true>(Lk, out) : info<DP, true, false>(Lk, out);
  return causal ? info<DP, false, true>(Lk, out) : info<DP, false, false>(Lk, out);
}

}  // namespace

// For a launch at head dim D, mask or not, causal or not, over Lk keys:
// out[0] registers a thread, out[1] local (spill) bytes a thread, out[2]
// dynamic shared memory bytes a block, out[3] resident blocks per SM, as
// the CUDA runtime reports them on the current device. Returns a CUDA
// error.
extern "C" int devqa_flash_fwd_info(int D, int has_mask, int causal, int Lk, int* out) {
  switch ((D + 15) / 16 * 16) {
    case 64: return info_dp<64>(has_mask, causal, Lk, out);
    case 80: return info_dp<80>(has_mask, causal, Lk, out);
    case 96: return info_dp<96>(has_mask, causal, Lk, out);
    case 128: return info_dp<128>(has_mask, causal, Lk, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). kv_valid and lse may be null. Shapes are validated by the
// Python wrapper (devqa_tpu_torch/ops/attention.py::flash_attention).
extern "C" int devqa_flash_fwd(const void* q, const void* k, const void* v, const void* kv_valid,
                               void* o, void* lse, int B, int H, int Lq, int Lk, int D, int causal,
                               float scale, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* mp = static_cast<const int*>(kv_valid);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 64: return dispatch<64>(qp, kp, vp, mp, op, lp, B, H, Lq, Lk, D, causal, scale, st);
    case 80: return dispatch<80>(qp, kp, vp, mp, op, lp, B, H, Lq, Lk, D, causal, scale, st);
    case 96: return dispatch<96>(qp, kp, vp, mp, op, lp, B, H, Lq, Lk, D, causal, scale, st);
    case 128: return dispatch<128>(qp, kp, vp, mp, op, lp, B, H, Lq, Lk, D, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* devqa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
