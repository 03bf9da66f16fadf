// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces the TPU kernel devqa_tpu/ops/attention.py::_flash_kernel
// (launched by _flash_fwd). Same contract:
//   O = softmax(Q K^T / sqrt(D) + mask) V, online softmax with running
//   max m and sum l in f32, masked scores set to -1e30 (never -inf);
//   mask = kv_valid[b, key] != 0 (any pattern, optional), causal with the
//   diagonal offset Lk - Lq, and bounds for ragged Lq / Lk;
//   a row that sees no live key gets exact zeros and lse = -1e30;
//   optional lse = m + log(l), f32 [B, H, Lq].
//
// Layout: q [B, H, Lq, D], k / v [B, H, Lk, D], o like q, all contiguous
// bf16; kv_valid int32 [B, Lk] or null. D is a multiple of 8 in [56, 96]:
// the path's head dims are 64 (Q-Former), 80 (OPT) and 88 (ViT).
//
// Design: one block of 4 warps per (b*h, 64-row query tile); a loop in the
// block walks 64-key tiles (the TPU's sequential grid axis). Q, K, V and
// the tile's mask are staged in shared memory with the head dim zero-padded
// to DP = round_up(D, 16) (88 -> 96), so the padding adds exact zeros to
// the scores and to O's padded columns, which are never stored. A tile's
// copies are all issued at once (cp.async, zero-filling past the edges)
// and waited for together. Q K^T and P V run on the tensor cores through
// WMMA 16x16x16 bf16 -> f32; each warp owns 16 query rows and keeps their
// f32 O accumulator in shared memory. In the softmax two lanes share a row
// (interleaved columns, one shuffle to combine), so a warp's 16 rows are
// done in parallel; the row's running max and sum stay in registers.
// P is rounded to bf16 before P V, as the TPU kernel casts p to v's dtype.
//
// What bounds it on an H100: at the path's shapes it is memory-bound.
// OPT: 120 rows x 32 heads x 64 tokens x D 80 in bf16 moves q+k+v+o
// ~157 MB (~47 us at 3.35 TB/s) against ~5 GFLOP (~5 us at 989 TFLOP/s);
// the ViT, 8 images x 16 heads x 257 x 88, moves ~23 MB (~7 us) against
// ~3 GFLOP. The design reads each input byte once per query tile and
// keeps scores and probabilities on chip, which is what the bound asks.
// Left for later: TMA loads with an mbarrier pipeline (the next K/V tile
// in flight while this one is used), wgmma in place of WMMA, keeping O in
// registers, and reading the [B, L, H, D] projection layout directly
// instead of the caller's transpose copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;            // query rows per block, 16 per warp
constexpr int BK = 64;            // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Shared-memory layout. Leading dimensions keep every WMMA pointer 32-byte
// aligned (row offsets are multiples of 16 rows) and skew the banks.
template <int DP>
struct Layout {
  static constexpr int LDQ = DP + 8;   // bf16 Q, K, V rows
  static constexpr int LDS = BK + 4;   // f32 scores
  static constexpr int LDP = BK + 8;   // bf16 probabilities
  static constexpr int LDO = DP + 4;   // f32 O accumulator
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = align128(Q_OFF + BQ * LDQ * 2);
  static constexpr int V_OFF = align128(K_OFF + BK * LDQ * 2);
  static constexpr int S_OFF = align128(V_OFF + BK * LDQ * 2);
  static constexpr int P_OFF = align128(S_OFF + BQ * LDS * 4);
  static constexpr int O_OFF = align128(P_OFF + BQ * LDP * 2);
  static constexpr int M_OFF = align128(O_OFF + BQ * LDO * 4);
  static constexpr int TOTAL = align128(M_OFF + BK * 4);
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

// Start copying rows [r0, r0 + NROWS) of a [len, D] bf16 matrix into shared
// memory with leading dimension ld, zero-filling rows past len and columns
// D..DP. All of a thread's copies are in flight at once; cp_async_wait_all
// waits for them.
template <int DP, int NROWS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int r0, int len,
                                          int D) {
  constexpr int CH = DP / 8;  // 16-byte chunks per padded row
  constexpr int ITERS = (NROWS * CH + NTHREADS - 1) / NTHREADS;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * NTHREADS;
    if (idx < NROWS * CH) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool in = r0 + r < len && c < D;
      cp_async_16(dst + r * ld + c, in ? src + (size_t)(r0 + r) * D + c : src, in);
    }
  }
}

template <int DP, bool HAS_MASK, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_valid,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int Lq, int Lk, int D, float scale) {
  using L = Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  int* Ms = reinterpret_cast<int*>(smem + L::M_OFF);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's first row in the tile
  // In the softmax each of the warp's 16 rows belongs to a lane pair: lane
  // 2r + h takes row r's columns h, h + 2, h + 4, ... and both lanes of the
  // pair keep the row's running max and sum.
  const int row = row0 + lane / 2;
  const int h = lane % 2;
  const int qi = q0 + row;
  const bf16* qg = q + (size_t)bh * Lq * D;
  const bf16* kg = k + (size_t)bh * Lk * D;
  const bf16* vg = v + (size_t)bh * Lk * D;
  const int causal_offset = Lk - Lq;

  load_tile<DP, BQ>(Qs, L::LDQ, qg, q0, Lq, D);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) Os[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DP / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + row0 * L::LDQ + kk * 16, L::LDQ);

  float m_i = NEG_INF, l_i = 0.f;

  int n_tiles = (Lk + BK - 1) / BK;
  if (CAUSAL) {
    // Tiles wholly above the diagonal of every row of this query tile
    // change nothing: skip them (and all later ones).
    const int last_key = q0 + BQ - 1 + causal_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<DP, BK>(Ks, L::LDQ, kg, k0, Lk, D);
    load_tile<DP, BK>(Vs, L::LDQ, vg, k0, Lk, D);
    for (int j = threadIdx.x; j < BK; j += NTHREADS) {
      const int key = k0 + j;
      int live = key < Lk;
      if (HAS_MASK && live) live = kv_valid[(size_t)b * Lk + key] != 0;
      Ms[j] = live;
    }
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys.
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(Ss + row0 * L::LDS + n * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax: scale and mask the row's scores in place, then the
    // running max m, the probabilities P (bf16) and the running sum l.
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int col = h + 2 * j;
      bool live = Ms[col] != 0;
      if (CAUSAL) live = live && (k0 + col <= qi + causal_offset);
      const float sc = live ? Ss[row * L::LDS + col] * scale : NEG_INF;
      Ss[row * L::LDS + col] = sc;
      mx = fmaxf(mx, sc);
    }
    const float m_new = fmaxf(m_i, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int col = h + 2 * j;
      const float p = expf(Ss[row * L::LDS + col] - m_new);
      sum += p;
      Ps[row * L::LDP + col] = __float2bfloat16(p);
    }
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    m_i = m_new;
    for (int c = h; c < DP; c += 2) Os[row * L::LDO + c] *= corr;
    __syncwarp();

    // O += P V for this warp's rows.
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + row0 * L::LDO + j * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + row0 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(Os + row0 * L::LDO + j * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Finalize: a row that never saw a live key (m stayed -1e30) or whose sum
  // underflowed is dead: exact zeros and lse = -1e30. Each lane pair
  // normalizes its row in shared memory; then the warp stores its 16 rows
  // with neighbouring lanes on neighbouring columns.
  const bool dead = (m_i <= NEG_INF / 2) || (l_i == 0.f);
  for (int c = h; c < DP; c += 2)
    Os[row * L::LDO + c] = dead ? 0.f : Os[row * L::LDO + c] / l_i;
  if (lse != nullptr && h == 0 && qi < Lq)
    lse[(size_t)bh * Lq + qi] = dead ? NEG_INF : m_i + logf(l_i);
  __syncwarp();
  for (int r = 0; r < 16 && q0 + row0 + r < Lq; ++r) {
    bf16* orow = o + ((size_t)bh * Lq + q0 + row0 + r) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(Os[(row0 + r) * L::LDO + c]);
  }
}

template <int DP, bool HAS_MASK, bool CAUSAL>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const int* kv_valid, bf16* o,
                   float* lse, int B, int H, int Lq, int Lk, int D, float scale,
                   cudaStream_t stream) {
  constexpr int smem = Layout<DP>::TOTAL;
  auto kern = flash_fwd_kernel<DP, HAS_MASK, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(B * H), (unsigned)((Lq + BQ - 1) / BQ));
  kern<<<grid, NTHREADS, smem, stream>>>(q, k, v, kv_valid, o, lse, H, Lq, Lk, D, scale);
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

}  // namespace

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
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* devqa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
