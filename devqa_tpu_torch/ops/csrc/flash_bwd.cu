// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces the TPU kernels of devqa_tpu/ops/attention.py, launched by
// _flash_bwd:
//   K2 _flash_bwd_dq_kernel  -> flash_bwd_dq_kernel below
//   K3 _flash_bwd_dkv_kernel -> flash_bwd_dkv_kernel below
// Same contract (the block math of _bwd_p_ds / _bwd_block_mask):
//   p  = exp(Q K^T * scale - lse)            recomputed from the forward's lse
//   ds = p * (dO V^T - Dl) * scale,  Dl = rowsum(dO * O)
//   dq = ds K,  dk = ds^T Q,  dv = p^T dO
// An entry of p and ds whose key is masked (kv_valid, optional, any
// pattern), out of range, or causal-future (diagonal at offset Lk - Lq),
// or whose query row is out of range or dead (lse <= -1e30 / 2), is set to
// zero by a select, never by multiplying a zero into it. p and ds are
// rounded to bf16 before the products; products accumulate in f32. So a
// masked key gets exactly zero dk and dv, and a dead row exactly zero dq.
//
// Dl is folded into K2's prologue: K2 stages its rows of O in shared
// memory beside dO, reduces them there and writes Dl to `delta` [B, H, Lq]
// f32, which K3, launched after it on the same stream, reads. (The TPU version
// computed it with an XLA reduction before both kernels.)
//
// Layout: q, o, dO [B, H, Lq, D]; k, v [B, H, Lk, D]; dq like q, dk / dv
// like k; all contiguous bf16. lse, delta f32 [B, H, Lq]; kv_valid int32
// [B, Lk] or null. D is a multiple of 8 in [56, 128], zero-padded in
// shared memory to DP = round_up(D, 16) (64, 80, 96 or 128), so the padding
// adds exact zeros to every product and the padded columns are never stored.
//
// Design. Two kernels, as on the TPU, so dq needs no atomics and every
// result is deterministic:
//   K2: one block of 4 warps per (b*h, 64-query tile), looping over 64-key
//       tiles; each warp owns 16 query rows and keeps their dq in WMMA
//       accumulator fragments (registers) across the loop.
//   K3: one block of 4 warps per (b*h, 64-key tile), looping over 64-query
//       tiles; each warp owns 16 keys and keeps their dk and dv in
//       accumulator fragments.
// A tile's copies are issued together (cp.async, zero-filling past the
// edges and in the padded columns) and waited for together. Every product
// runs on the tensor cores as WMMA 16x16x16 bf16 -> f32. The elementwise
// step (p, ds) works on scores staged in shared memory; two lanes share a
// row (interleaved columns), as in flash_fwd.cu. Causal tiles that hold no
// live pair are skipped.
//
// What bounds it on an H100: at the training path's shapes (q/k/v
// [4..24, 32, 64, 80], causal, one 64-row tile per head) it is bound by
// bytes: per head the backward reads q, k, v, o, dO (5 x 10 KB) and writes
// dq, dk, dv (3 x 10 KB), ~82 KB, against ~2080 live pairs x 10*80 flops
// ~1.7 MFLOP, i.e. ~25 ns of memory time against ~1.7 ns of tensor-core
// time at 3.35 TB/s and 989 TFLOP/s. At LLaVA's (q/k/v [4..24, 32, 640,
// 128], causal, ten 64-row tiles per head) the bytes still bound it, but
// barely: per head ~1.3 MB moved against ~170k live pairs x 10*128 flops
// ~0.22 GFLOP (~0.39 us against ~0.22 us). The design reads each input
// once per tile pair and keeps p and ds on chip. At DP 128 a block's
// shared memory (~121 KB) leaves room for one block of 4 warps per SM,
// and K3's two accumulator sets (128 floats a thread) fill the 255
// registers and spill a little. Left for later: a K/V tile in
// flight while the current one is used, wgmma in place of WMMA, K and Q
// fragments held in registers across the inner loops, one kernel for
// short sequences (a single tile holds the whole head, so dq, dk and dv
// could come from one pass).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Shared-memory layout, the same for both kernels (BQ == BK). Leading
// dimensions keep every WMMA pointer 32-byte aligned and skew the banks.
// The f32 staging area of the epilogue reuses the S and dP buffers.
template <int DP>
struct Layout {
  static constexpr int T = 64;        // rows of every tile
  static constexpr int LDQ = DP + 8;  // bf16 Q, dO, K, V rows
  static constexpr int LDS = T + 4;   // f32 S, dP
  static constexpr int LDP = T + 8;   // bf16 P, dS
  static constexpr int LDO = DP + 4;  // f32 epilogue staging
  static constexpr int A_OFF = 0;     // K2: Q    K3: K
  static constexpr int B_OFF = align128(A_OFF + T * LDQ * 2);  // K2: dO   K3: V
  static constexpr int C_OFF = align128(B_OFF + T * LDQ * 2);  // K2: K    K3: Q
  static constexpr int D_OFF = align128(C_OFF + T * LDQ * 2);  // K2: V    K3: dO
  static constexpr int S_OFF = align128(D_OFF + T * LDQ * 2);
  static constexpr int DPS_OFF = align128(S_OFF + T * LDS * 4);
  static constexpr int P_OFF = align128(DPS_OFF + T * LDS * 4);
  static constexpr int DS_OFF = align128(P_OFF + T * LDP * 2);
  static constexpr int LSE_OFF = align128(DS_OFF + T * LDP * 2);
  static constexpr int DEL_OFF = align128(LSE_OFF + T * 4);
  static constexpr int M_OFF = align128(DEL_OFF + T * 4);
  static constexpr int TOTAL = align128(M_OFF + T * 4);
  static_assert(T * LDO * 4 <= P_OFF - S_OFF, "staging must fit in S and dP");
};

// 16-byte asynchronous copy global -> shared; when `in` is false nothing is
// read and the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [r0, r0 + 64) of a [len, D] bf16 matrix into shared
// memory with leading dimension ld, zero-filling rows past len and columns
// D..DP.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int r0, int len,
                                          int D) {
  constexpr int CH = DP / 8;  // 16-byte chunks per padded row
  constexpr int ITERS = (64 * CH + NTHREADS - 1) / NTHREADS;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * NTHREADS;
    if (idx < 64 * CH) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool in = r0 + r < len && c < D;
      cp_async_16(dst + r * ld + c, in ? src + (size_t)(r0 + r) * D + c : src, in);
    }
  }
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// For this warp's 16 rows of X (row0 in an [64, DP] tile) and all 64 rows
// of Y and Z: S = X Y^T and T = W Z^T, W being the warp's rows of a second
// tile; stored as f32 [16, 64] blocks at S + row0 * LDS and T + row0 * LDS.
template <int DP>
__device__ __forceinline__ void two_products_t(const bf16* X, const bf16* Y, const bf16* W,
                                               const bf16* Z, float* S, float* Tm, int row0) {
  using L = Layout<DP>;
#pragma unroll
  for (int n = 0; n < 64 / 16; ++n) {
    FragC s, t;
    wmma::fill_fragment(s, 0.f);
    wmma::fill_fragment(t, 0.f);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      FragA a;
      FragBCol b;
      wmma::load_matrix_sync(a, X + row0 * L::LDQ + kk * 16, L::LDQ);
      wmma::load_matrix_sync(b, Y + n * 16 * L::LDQ + kk * 16, L::LDQ);
      wmma::mma_sync(s, a, b, s);
      wmma::load_matrix_sync(a, W + row0 * L::LDQ + kk * 16, L::LDQ);
      wmma::load_matrix_sync(b, Z + n * 16 * L::LDQ + kk * 16, L::LDQ);
      wmma::mma_sync(t, a, b, t);
    }
    wmma::store_matrix_sync(S + row0 * L::LDS + n * 16, s, L::LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(Tm + row0 * L::LDS + n * 16, t, L::LDS, wmma::mem_row_major);
  }
}

// acc[j] += A (warp's 16 rows of a bf16 [64, 64] tile, ld LDP) x B[:, 16j:16j+16]
// (B a bf16 [64, DP] tile, ld LDQ).
template <int DP>
__device__ __forceinline__ void accumulate(FragC (&acc)[DP / 16], const bf16* A, const bf16* B,
                                           int row0) {
  using L = Layout<DP>;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      FragA a;
      FragBRow b;
      wmma::load_matrix_sync(a, A + row0 * L::LDP + kk * 16, L::LDP);
      wmma::load_matrix_sync(b, B + kk * 16 * L::LDQ + j * 16, L::LDQ);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// Round the warp's 16 accumulator rows to bf16 and store rows < len of
// out ([len, D], rows from r0) through the f32 staging area.
template <int DP>
__device__ __forceinline__ void store_rows(FragC (&acc)[DP / 16], float* stage, bf16* out,
                                           int r0, int len, int D, int row0, int lane) {
  using L = Layout<DP>;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    wmma::store_matrix_sync(stage + row0 * L::LDO + j * 16, acc[j], L::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16 && r0 + row0 + r < len; ++r) {
    bf16* orow = out + (size_t)(r0 + row0 + r) * D;
    for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(stage[(row0 + r) * L::LDO + c]);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// K2: dq (and Dl)
// ---------------------------------------------------------------------------

template <int DP, bool HAS_MASK, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_valid,
                    const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Lq, int Lk, int D, float scale) {
  using L = Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::A_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::B_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::C_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::D_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dPs = reinterpret_cast<float*>(smem + L::DPS_OFF);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::DS_OFF);
  int* Ms = reinterpret_cast<int*>(smem + L::M_OFF);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;
  const int row = row0 + lane / 2;  // lane pair 2r, 2r+1 owns row r
  const int h = lane % 2;
  const int qi = q0 + row;
  const bf16* qg = q + (size_t)bh * Lq * D;
  const bf16* og = o + (size_t)bh * Lq * D;
  const bf16* dog = dout + (size_t)bh * Lq * D;
  const bf16* kg = k + (size_t)bh * Lk * D;
  const bf16* vg = v + (size_t)bh * Lk * D;
  const int causal_offset = Lk - Lq;

  load_tile<DP>(Qs, L::LDQ, qg, q0, Lq, D);
  load_tile<DP>(dOs, L::LDQ, dog, q0, Lq, D);
  load_tile<DP>(Ks, L::LDQ, og, q0, Lq, D);  // O, in the K buffer until the first key tile
  cp_async_wait_all();
  __syncthreads();

  // Dl = rowsum(dO * O) in f32: the row's lane pair sums interleaved
  // columns (the zero padding adds nothing) and combines with one shuffle.
  float del_r = 0.f;
  for (int c = h; c < DP; c += 2)
    del_r += __bfloat162float(dOs[row * L::LDQ + c]) * __bfloat162float(Ks[row * L::LDQ + c]);
  del_r += __shfl_xor_sync(0xffffffffu, del_r, 1);
  if (h == 0 && qi < Lq) delta[(size_t)bh * Lq + qi] = del_r;
  const float lse_r = qi < Lq ? lse[(size_t)bh * Lq + qi] : NEG_INF;
  const bool row_live = qi < Lq && lse_r > NEG_INF / 2;

  FragC acc[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  int n_tiles = (Lk + BK - 1) / BK;
  if (CAUSAL) {
    const int last_key = q0 + BQ - 1 + causal_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K / V tile
    load_tile<DP>(Ks, L::LDQ, kg, k0, Lk, D);
    load_tile<DP>(Vs, L::LDQ, vg, k0, Lk, D);
    for (int j = threadIdx.x; j < BK; j += NTHREADS) {
      const int key = k0 + j;
      int live = key < Lk;
      if (HAS_MASK && live) live = kv_valid[(size_t)b * Lk + key] != 0;
      Ms[j] = live;
    }
    cp_async_wait_all();
    __syncthreads();

    two_products_t<DP>(Qs, Ks, dOs, Vs, Ss, dPs, row0);  // S = Q K^T, dP = dO V^T
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < BK / 2; ++j) {
      const int col = h + 2 * j;
      bool live = row_live && Ms[col] != 0;
      if (CAUSAL) live = live && (k0 + col <= qi + causal_offset);
      float ds = 0.f;
      if (live) {
        const float p = expf(Ss[row * L::LDS + col] * scale - lse_r);
        ds = p * (dPs[row * L::LDS + col] - del_r) * scale;
      }
      dSs[row * L::LDP + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    accumulate<DP>(acc, dSs, Ks, row0);  // dq += dS K
  }

  __syncthreads();  // the staging area overlaps other warps' S / dP rows
  store_rows<DP>(acc, Ss, dq + (size_t)bh * Lq * D, q0, Lq, D, row0, lane);
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------

template <int DP, bool HAS_MASK, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ kv_valid,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Lq, int Lk, int D, float scale) {
  using L = Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::A_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::B_OFF);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::C_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::D_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);    // S^T [key][query]
  float* dPs = reinterpret_cast<float*>(smem + L::DPS_OFF);  // dP^T
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);       // P^T
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::DS_OFF);     // dS^T
  float* Lsm = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* Dsm = reinterpret_cast<float*>(smem + L::DEL_OFF);
  int* Ms = reinterpret_cast<int*>(smem + L::M_OFF);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;
  const int row = row0 + lane / 2;  // lane pair 2r, 2r+1 owns key r
  const int h = lane % 2;
  const int key = k0 + row;
  const bf16* qg = q + (size_t)bh * Lq * D;
  const bf16* dog = dout + (size_t)bh * Lq * D;
  const bf16* kg = k + (size_t)bh * Lk * D;
  const bf16* vg = v + (size_t)bh * Lk * D;
  const int causal_offset = Lk - Lq;

  load_tile<DP>(Ks, L::LDQ, kg, k0, Lk, D);
  load_tile<DP>(Vs, L::LDQ, vg, k0, Lk, D);
  for (int j = threadIdx.x; j < BK; j += NTHREADS) {
    int live = k0 + j < Lk;
    if (HAS_MASK && live) live = kv_valid[(size_t)b * Lk + k0 + j] != 0;
    Ms[j] = live;
  }

  FragC dk_acc[DP / 16], dv_acc[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  // Query tiles that can see a key of this tile: with causal masking the
  // first is the one holding query k0 - causal_offset.
  const int n_tiles = (Lq + BQ - 1) / BQ;
  int t0 = 0;
  if (CAUSAL) t0 = max(0, k0 - causal_offset) / BQ;

  for (int t = t0; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // every warp is done with the previous Q / dO tile
    load_tile<DP>(Qs, L::LDQ, qg, q0, Lq, D);
    load_tile<DP>(dOs, L::LDQ, dog, q0, Lq, D);
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const bool in = q0 + i < Lq;
      Lsm[i] = in ? lse[(size_t)bh * Lq + q0 + i] : NEG_INF;
      Dsm[i] = in ? delta[(size_t)bh * Lq + q0 + i] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    two_products_t<DP>(Ks, Qs, Vs, dOs, Ss, dPs, row0);  // S^T = K Q^T, dP^T = V dO^T
    __syncwarp();

    const bool key_live = Ms[row] != 0;
#pragma unroll 4
    for (int j = 0; j < BQ / 2; ++j) {
      const int col = h + 2 * j;
      const int qi = q0 + col;
      const float lse_c = Lsm[col];
      bool live = key_live && qi < Lq && lse_c > NEG_INF / 2;
      if (CAUSAL) live = live && (key <= qi + causal_offset);
      float p = 0.f, ds = 0.f;
      if (live) {
        p = expf(Ss[row * L::LDS + col] * scale - lse_c);
        ds = p * (dPs[row * L::LDS + col] - Dsm[col]) * scale;
      }
      Ps[row * L::LDP + col] = __float2bfloat16(p);
      dSs[row * L::LDP + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    accumulate<DP>(dv_acc, Ps, dOs, row0);  // dv += P^T dO
    accumulate<DP>(dk_acc, dSs, Qs, row0);  // dk += dS^T Q
  }

  __syncthreads();  // the staging area overlaps other warps' S / dP rows
  store_rows<DP>(dk_acc, Ss, dk + (size_t)bh * Lk * D, k0, Lk, D, row0, lane);
  store_rows<DP>(dv_acc, Ss, dv + (size_t)bh * Lk * D, k0, Lk, D, row0, lane);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const int* kv_valid;
  const float* lse;
  float* delta;
  bf16 *dq, *dk, *dv;
  int B, H, Lq, Lk, D;
  float scale;
  cudaStream_t stream;
};

template <int DP, bool HAS_MASK, bool CAUSAL>
cudaError_t launch(const Args& a, bool dkv) {
  constexpr int smem = Layout<DP>::TOTAL;
  if (!dkv) {
    auto kern = flash_bwd_dq_kernel<DP, HAS_MASK, CAUSAL>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Lq + BQ - 1) / BQ));
    kern<<<grid, NTHREADS, smem, a.stream>>>(a.q, a.k, a.v, a.kv_valid, a.o, a.dout, a.lse,
                                             a.delta, a.dq, a.H, a.Lq, a.Lk, a.D, a.scale);
  } else {
    auto kern = flash_bwd_dkv_kernel<DP, HAS_MASK, CAUSAL>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Lk + BK - 1) / BK));
    kern<<<grid, NTHREADS, smem, a.stream>>>(a.q, a.k, a.v, a.kv_valid, a.dout, a.lse, a.delta,
                                             a.dk, a.dv, a.H, a.Lq, a.Lk, a.D, a.scale);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch_mask(const Args& a, int causal, bool dkv) {
  if (a.kv_valid != nullptr) {
    if (causal) return launch<DP, true, true>(a, dkv);
    return launch<DP, true, false>(a, dkv);
  }
  if (causal) return launch<DP, false, true>(a, dkv);
  return launch<DP, false, false>(a, dkv);
}

int dispatch(const Args& a, int causal, bool dkv) {
  switch ((a.D + 15) / 16 * 16) {
    case 64: return dispatch_mask<64>(a, causal, dkv);
    case 80: return dispatch_mask<80>(a, causal, dkv);
    case 96: return dispatch_mask<96>(a, causal, dkv);
    case 128: return dispatch_mask<128>(a, causal, dkv);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2: dq [B, H, Lq, D] and delta = rowsum(dO * O) [B, H, Lq] f32. Launches
// on `stream` and returns cudaGetLastError() (0 on success). kv_valid may
// be null. Shapes are validated by the Python wrapper
// (devqa_tpu_torch/ops/attention.py::flash_bwd_dq).
extern "C" int devqa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* kv_valid, const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq, int B, int H, int Lq,
                                  int Lk, int D, int causal, float scale, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.kv_valid = static_cast<const int*>(kv_valid);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.B = B; a.H = H; a.Lq = Lq; a.Lk = Lk; a.D = D;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(a, causal, false);
}

// K3: dk, dv [B, H, Lk, D] from the delta K2 wrote. Same conventions.
extern "C" int devqa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* kv_valid, const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv, int B, int H, int Lq,
                                   int Lk, int D, int causal, float scale, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.kv_valid = static_cast<const int*>(kv_valid);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(const_cast<void*>(delta));
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.B = B; a.H = H; a.Lq = Lq; a.Lk = Lk; a.D = D;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(a, causal, true);
}

extern "C" const char* devqa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
