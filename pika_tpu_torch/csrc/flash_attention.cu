// K4: flash attention, forward and backward, written for Hopper (sm_90a).
//
// Replaces the library Pallas TPU kernels that pika_tpu/models/transformer.py
// :MultiHeadedAttention._flash reaches (jax/experimental/pallas/ops/tpu/
// flash_attention.py, jax 0.9.0): the forward kernel (_flash_attention_impl,
// pallas_call :758), the dk/dv kernel (_flash_attention_bwd_dkv, :1121) and
// the dq kernel (_flash_attention_bwd_dq, :1456).  Per (batch, head) slice,
// with q already scaled by 1/sqrt(d) and keys at or past T masked out:
//
//     s = q k^T (f32),  p = exp(s - lse),  o = bf16(p) v          (forward)
//     dv = bf16(p)^T do,  ds = p * (do v^T - di),  di = sum(o * do)
//     dk = bf16(ds)^T q,  dq = bf16(ds) k                         (backward)
//
// q, k, v, o, do, dq, dk, dv are bf16 (BH, T, D); lse, di are f32 (BH, T).
// Every product takes bf16 operands and accumulates in f32, as the library
// kernels' dots with preferred_element_type=f32 do; the forward rounds
// exp(s - m) to bf16 relative to the running row max m, then divides by the
// row sum l (kept in f32 from the unrounded p) at the end; it writes
// lse = m + log(l) for the backward.
//
// What bounds it on the H100: the products, 4*BH*T^2*D flops forward,
// 8*BH*T^2*D (dk/dv) and 6*BH*T^2*D (dq) backward, on the bf16 tensor cores
// (989 TFLOP/s); the bytes (each input and output once) are 30-100x fewer
// than the card moves in that time at T ~ 1000.  Every block owns a tile of
// rows -- queries (forward, dq) or keys (dk/dv) -- and loops over the other
// axis itself: the TPU grid's sequential ("arbitrary") axis becomes this
// loop, because CUDA blocks run in no order (the forward's persistent
// blocks take one such tile after another).  Nothing crosses blocks: no
// atomics, results identical from run to run.  Keys and queries at or past
// T read as zeros and are masked in registers: this stands in for the
// segment ids with which _flash pads T to the TPU block multiple.  Any
// T >= 1; D = 64 or 128.
//
// All three kernels (the section "warp-specialised" below has the details)
// are warp-specialised blocks of 128 rows: a TMA producer warp feeds a
// 4-stage ring of 64-row tiles (128-row for the forward at D = 64; 3-D
// tensor maps over (BH, T, D), 128-byte swizzle, so a tile past T reads
// zeros of its own head), and two consumer warpgroups run wgmma: the score
// products (s, dp) with both operands in shared memory, the value and
// gradient products with bf16 p or ds as the register A operand and the
// streamed tile read transposed.  The forward keeps the online softmax in
// registers, overlaps one tile's p v with the next tile's scores, and is
// persistent (one block per SM).  The dk/dv and dq kernels recompute p: 7
// products where a fused backward with a cross-block dq reduction would do
// 5.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;
using hopper::exp2_approx;
using hopper::pack_bf16;

// ---- warp-specialised TMA + wgmma kernels -----------------------------------
//
// A block is 3 warpgroups: warpgroup 0 is the producer (its first warp
// keeps the ring filled, the other three idle; 40 registers each),
// warpgroups 1 and 2 are consumers with 232 registers, each owning 64 of
// the block's 128 rows.  The block's own 128-row tile (queries for the
// forward and dq, keys for dk/dv) is loaded once; the other axis streams
// through a ring of kStages tiles of kN rows, each guarded by a "full"
// barrier (TMA bytes landed, and for dk/dv the producer warp's lse and di
// stores) and an "empty" barrier (all 256 consumer threads are done with it).
//
// A consumer warpgroup pipelines its tiles: it issues tile i's score
// products (shared-memory operands), then tile i - 1's value or gradient
// product (register A operand, kept packed from the last iteration), so
// that the tensor cores run that while its threads turn tile i's scores
// into p (and ds).  The scores live in registers that only wgmma writes
// before it reads them; otherwise ptxas serializes every wgmma.  This is
// the forward and, at D = 64, the dq kernel (at D = 128 dq's extra
// fragments spill and it runs slower).  The dk/dv kernel keeps two
// accumulators and has no registers for a second tile's fragments: it
// overlaps within the tile instead (p while dp's product runs, ds while
// dv's runs).  Measured choices (NVIDIA H100, see PERF.md): 64-row streamed
// tiles (128-row tiles need 64-wide score accumulators that ptxas
// serializes and spills), 40 producer registers (24 spill the producer's
// lse/di loop), 4 stages.

constexpr int kBwdThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kBwdRows = 128;     // rows a block owns: 64 per consumer warpgroup
constexpr int kN = 64;            // rows of a streamed tile
constexpr int kStages = 4;        // depth of the streamed ring
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 40*128 + 232*256 <= 65536

// Byte offsets into the block's shared memory (1024-aligned tiles): the
// resident 128-row tiles of the two operands the block keeps, the ring of
// the two streamed operands, the ring's lse and di (f32 [kStages][kN], used
// by dk/dv), then the barriers: resident-full, full[kStages], empty[kStages].
template <int D>
struct BwdSmem {
  static constexpr uint32_t kResident = kBwdRows * D * 2;
  static constexpr uint32_t kStream = kN * D * 2;
  static constexpr uint32_t res0 = 0, res1 = kResident;
  static constexpr uint32_t ring0 = 2 * kResident, ring1 = ring0 + kStages * kStream;
  static constexpr uint32_t lse = ring1 + kStages * kStream;
  static constexpr uint32_t di = lse + kStages * kN * 4;
  static constexpr uint32_t bars = di + kStages * kN * 4;
  static constexpr uint32_t bytes = bars + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

using hopper::align_1024;
using hopper::warpgroup;

// TMA-load rows [row0, row0 + R) of head bh of a (BH, T, D) bf16 tensor into
// the panel layout of hopper.cuh: R / 64 x D / 64 boxes of 64 x 64.
template <int D, int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int bh) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int rb = 0; rb < R / 64; ++rb)
      hopper::tma_load_3d(dst + p * R * 128 + rb * 64 * 128, map, bar, p * 64, row0 + rb * 64, bh);
}

// acc (64 x N, f32) = the 64 rows at a_rows of a resident tile . the N
// rows of a streamed tile, contracted over D (both K-major).
template <int D, int N = kN>
__device__ __forceinline__ void rows_dot_rows_wg(float (&acc)[N / 2], uint32_t a_rows,
                                                 uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    hopper::wgmma_ss(acc,
                     hopper::desc_sw128(a_rows + (kk / 4) * kBwdRows * 128 + off, 16, 1024),
                     hopper::desc_sw128(b_tile + (kk / 4) * N * 128 + off, 16, 1024), kk > 0);
  }
}

// The f32 accumulator x (64 x N) rounded to bf16 as wgmma's register A
// operand, one fragment per k16 step.
template <int N = kN>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// acc (64 x D) += A . B: A (64 x N) packed by pack_frags, B (N x D) a
// streamed tile read MN-major.  The caller fences and commits.
template <int D, int N = kN>
__device__ __forceinline__ void frags_dot_tile_wg(float (&acc)[D / 2],
                                                  const uint32_t (&a)[N / 16][4],
                                                  uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    hopper::wgmma_rs<D>(acc, a[kk], hopper::desc_sw128(b_tile + kk * 16 * 128, N * 128, 1024));
}

// Write a consumer warpgroup's 64 x D accumulator as bf16 rows row0.. of a
// (T, D) matrix, skipping rows at or past T; this thread's rows (lo, and
// lo + 8) times scale_lo and scale_hi.
template <int D>
__device__ __forceinline__ void store_rows_wg(bf16* dst, const float (&acc)[D / 2], int row0,
                                              int T, float scale_lo = 1.f, float scale_hi = 1.f) {
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int r_lo = row0 + (tid >> 5) * 16 + (lane >> 2), r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    if (r_lo < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_lo * D + col) =
          pack_bf16(acc[4 * j] * scale_lo, acc[4 * j + 1] * scale_lo);
    if (r_hi < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_hi * D + col) =
          pack_bf16(acc[4 * j + 2] * scale_hi, acc[4 * j + 3] * scale_hi);
  }
}

__device__ __forceinline__ void init_ring(uint64_t* bars, int full_count) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bars + 1 + s, full_count);
      hopper::mbar_init(bars + 1 + kStages + s, 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// The forward's streamed tiles and ring: at D = 64, 128 keys a tile (twice
// the backward's, which keeps two score accumulators; here the registers
// hold one of 128 columns, and each tile's fixed costs -- barriers, row-max
// shuffles, the rescale of o -- are paid half as often: 12% faster on an
// H100); at D = 128, 64 keys (128 spill and serialize the wgmmas there); 4
// stages.  Offsets: two Q tiles (the current item's and the next's), the K
// and V rings, the barriers q_full[2], q_empty[2], full[S], empty[S].
template <int D>
struct FwdSmem {
  static constexpr int N = D == 64 ? 128 : 64, S = 4;
  static constexpr uint32_t kResident = kBwdRows * D * 2;
  static constexpr uint32_t kStream = N * D * 2;
  static constexpr uint32_t res0 = 0, ring0 = 2 * kResident, ring1 = ring0 + S * kStream;
  static constexpr uint32_t bars = ring1 + S * kStream;
  static constexpr uint32_t bytes = bars + (4 + 2 * S) * 8 + 1024;  // + alignment slack
};

// The forward: persistent blocks, one per SM, walk the work items (head bh,
// 128 queries) gridDim.x apart; consecutive items of a block share a head,
// so its K and V stay in L2.  The producer loads an item's Q into one of
// two resident buffers while the consumers still work on the last item,
// then streams the item's keys (K, V) N at a time through the ring, whose
// stage count runs on across items; so the next item's loads overlap this
// item's last tile and epilogue.  Per tile a consumer warpgroup computes
// s = q k^T from shared memory, keeps the online row max m and row sum l
// in f32, turns s into p = exp(s - m) relative to the running max,
// rescales o by exp(m_old - m), and adds bf16(p) v with p as the register A
// operand and V read MN-major.  Tile i + 1's scores are issued before tile
// i's p v, so the two overlap; o is rescaled once p v of the last tile has
// landed.  Each quad of lanes holds a row's keys of a tile, so the row max
// and sum need two shuffles.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ o, float* __restrict__ lse, int T, int n_items) {
  using L = FwdSmem<D>;
  constexpr int N = L::N, S = L::S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + S;
  const int q_tiles = (T + kBwdRows - 1) / kBwdRows;
  const int n_tiles = (T + N - 1) / N;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(&q_full[b], 1);
      hopper::mbar_init(&q_empty[b], 2 * 128);
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg_idx = warpgroup();

  if (wg_idx == 0) {  // producer
    hopper::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int g = 0;  // streamed tiles issued so far, over all items
      for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
        const int bh = item / q_tiles, q0 = (item % q_tiles) * kBwdRows, qb = j & 1;
        hopper::mbar_wait(&q_empty[qb], ((j >> 1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&q_full[qb], L::kResident);
        tma_tile<D, kBwdRows>(smem + L::res0 + qb * L::kResident, &tq, &q_full[qb], q0, bh);
        for (int i = 0; i < n_tiles; ++i, ++g) {
          const int s = g % S;
          hopper::mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], 2 * L::kStream);
          tma_tile<D, N>(smem + L::ring0 + s * L::kStream, &tk, &full[s], i * N, bh);
          tma_tile<D, N>(smem + L::ring1 + s * L::kStream, &tv, &full[s], i * N, bh);
        }
      }
    }
  } else {  // consumers
    hopper::regs_alloc<kConsumerRegs>();
    const int wg = wg_idx - 1, t = threadIdx.x & 3;
    int g = 0;  // streamed tiles consumed so far, over all items
    for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
      const int bh = item / q_tiles, q0 = (item % q_tiles) * kBwdRows, qb = j & 1;
      // this wg's 64 queries
      const uint32_t qs = hopper::smem_addr(smem + L::res0 + qb * L::kResident) + wg * 64 * 128;
      float o_acc[D / 2];
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o_acc[c] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max of this thread's two rows
      float l[2] = {0.f, 0.f};              // this thread's share of their running sums
      uint32_t pa[N / 16][4];               // bf16 p of the last tile
      auto issue_scores = [&](float(&sc)[N / 2], int gi) {
        const int s = gi % S;
        hopper::mbar_wait(&full[s], (gi / S) & 1);
        hopper::wgmma_fence();
        rows_dot_rows_wg<D, N>(sc, qs, hopper::smem_addr(smem + L::ring0 + s * L::kStream));
        hopper::wgmma_commit();
      };
      auto issue_values = [&](int gi) {  // o += p v of the tile counted gi
        hopper::fence_regs(o_acc);
        hopper::wgmma_fence();
        frags_dot_tile_wg<D, N>(o_acc, pa,
                                hopper::smem_addr(smem + L::ring1 + (gi % S) * L::kStream));
        hopper::wgmma_commit();
      };
      // s -> p in place for tile i; alpha returns the factor by which o
      // must be rescaled (0 on the first tile, where o is still 0)
      auto softmax = [&](float(&sc)[N / 2], int i, float(&alpha)[2]) {
        const int past = T - i * N;  // keys of this tile below T
        if (past < N) {              // the last tile: mask the keys at or past T
#pragma unroll
          for (int c = 0; c < N / 2; ++c)
            if ((c >> 2) * 8 + t * 2 + (c & 1) >= past) sc[c] = -INFINITY;
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int c = 0; c < N / 2; ++c) mx[(c >> 1) & 1] = fmaxf(mx[(c >> 1) & 1], sc[c]);
        float ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2_approx((m[r] - mx[r]) * kLog2e);
          m[r] = mx[r];
          ms[r] = mx[r] * kLog2e;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int c = 0; c < N / 2; ++c) {
          sc[c] = exp2_approx(fmaf(sc[c], kLog2e, -ms[(c >> 1) & 1]));
          l[(c >> 1) & 1] += sc[c];
        }
      };
      hopper::mbar_wait(&q_full[qb], (j >> 1) & 1);

      for (int i = 0; i < n_tiles; ++i) {
        float sc[N / 2], alpha[2];
        issue_scores(sc, g + i);
        if (i > 0) {
          issue_values(g + i - 1);
          hopper::wgmma_wait<1>();  // the scores have landed; tile i - 1's p v may run
        } else {
          hopper::wgmma_wait<0>();
        }
        if (i == n_tiles - 1) hopper::mbar_arrive(&q_empty[qb]);  // the item's last Q read
        hopper::fence_regs(sc);
        softmax(sc, i, alpha);
        if (i > 0) {  // tile i - 1's product is done with its tile and fragments
          hopper::wgmma_wait<0>();
          hopper::mbar_arrive(&empty[(g + i - 1) % S]);
          hopper::fence_regs(o_acc);
          // o *= alpha, skipped where no row of the warp found a new max
          if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
            for (int c = 0; c < D / 2; ++c) o_acc[c] *= alpha[(c >> 1) & 1];
          }
        }
        pack_frags<N>(pa, sc);
      }
      issue_values(g + n_tiles - 1);
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(&empty[(g + n_tiles - 1) % S]);
      hopper::fence_regs(o_acc);
      g += n_tiles;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const int row0 = q0 + wg * 64;
      store_rows_wg<D>(o + (size_t)bh * T * D, o_acc, row0, T, 1.f / l[0], 1.f / l[1]);
      const int lane = threadIdx.x & 31;
      if (t == 0) {
        const int row = row0 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
        if (row < T) lse[(size_t)bh * T + row] = m[0] + logf(l[0]);
        if (row + 8 < T) lse[(size_t)bh * T + row + 8] = m[1] + logf(l[1]);
      }
    }
  }
}

// dk, dv: a block owns 128 keys (K, V resident) and streams the queries
// (Q, dO) kN at a time.  Per tile a consumer warpgroup computes s^T = k q^T
// and dp^T = v do^T from shared memory, p^T and ds^T in registers, then
// dv += bf16(p^T) do and dk += bf16(ds^T) q with p^T and ds^T as the
// register A operand.  The producer warp's 32 lanes also copy each tile's
// lse (times log2 e) and di into the ring with plain loads (not by TMA: a
// 1-D box must start 16-byte aligned, and bh * T need not be), each lane
// arriving on the tile's full barrier after its stores.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T) {
  using L = BwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* lse_ring = reinterpret_cast<float*>(smem + L::lse);
  float* di_ring = reinterpret_cast<float*>(smem + L::di);
  const int k0 = blockIdx.x * kBwdRows, bh = blockIdx.y;
  const int n_tiles = (T + kN - 1) / kN;
  init_ring(kv_full, 1 + 32);
  const int wg_idx = warpgroup();

  if (wg_idx == 0) {  // producer
    hopper::regs_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * L::kResident);
        tma_tile<D, kBwdRows>(smem + L::res0, &tk, kv_full, k0, bh);
        tma_tile<D, kBwdRows>(smem + L::res1, &tv, kv_full, k0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], 2 * L::kStream);
          tma_tile<D, kN>(smem + L::ring0 + s * L::kStream, &tq, &full[s], i * kN, bh);
          tma_tile<D, kN>(smem + L::ring1 + s * L::kStream, &tdo, &full[s], i * kN, bh);
        }
#pragma unroll
        for (int c = lane; c < kN; c += 32) {
          const int row = i * kN + c;
          // p = exp2(s log2 e - inf) = 0 for queries past T
          lse_ring[s * kN + c] = row < T ? lse[(size_t)bh * T + row] * kLog2e : INFINITY;
          di_ring[s * kN + c] = row < T ? di[(size_t)bh * T + row] : 0.f;
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
  } else {  // consumers
    hopper::regs_alloc<kConsumerRegs>();
    const int wg = wg_idx - 1, t = threadIdx.x & 3;
    const uint32_t ks = hopper::smem_addr(smem + L::res0) + wg * 64 * 128;  // this wg's 64 keys
    const uint32_t vs = hopper::smem_addr(smem + L::res1) + wg * 64 * 128;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
    hopper::mbar_wait(kv_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t qs = hopper::smem_addr(smem + L::ring0 + s * L::kStream);
      const uint32_t dos = hopper::smem_addr(smem + L::ring1 + s * L::kStream);
      float p[kN / 2], dp[kN / 2];  // p^T, dp^T: 64 keys x kN queries
      uint32_t pa[kN / 16][4], dsa[kN / 16][4];
      hopper::mbar_wait(&full[s], (i / kStages) & 1);
      hopper::wgmma_fence();
      rows_dot_rows_wg<D>(p, ks, qs);
      hopper::wgmma_commit();
      rows_dot_rows_wg<D>(dp, vs, dos);
      hopper::wgmma_commit();
      // this thread's query columns: 8 (j / 4) + 2 t + (j & 1) of the tile
      const float2* lse_s = reinterpret_cast<const float2*>(lse_ring + s * kN) + t;
      const float2* di_s = reinterpret_cast<const float2*>(di_ring + s * kN) + t;
      hopper::wgmma_wait<1>();  // s^T has landed; dp^T may still run
      hopper::fence_regs(p);
#pragma unroll
      for (int j = 0; j < kN / 2; j += 2) {
        const float2 l = lse_s[4 * (j >> 2)];
        p[j] = exp2_approx(fmaf(p[j], kLog2e, -l.x));
        p[j + 1] = exp2_approx(fmaf(p[j + 1], kLog2e, -l.y));
      }
      pack_frags(pa, p);
      hopper::fence_regs(dv_acc);
      hopper::wgmma_fence();
      frags_dot_tile_wg<D>(dv_acc, pa, dos);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // dp^T has landed; dv's product may still run
      hopper::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kN / 2; j += 2) {
        const float2 g = di_s[4 * (j >> 2)];
        dp[j] = p[j] * (dp[j] - g.x);
        dp[j + 1] = p[j + 1] * (dp[j + 1] - g.y);
      }
      pack_frags(dsa, dp);
      hopper::fence_regs(dk_acc);
      hopper::wgmma_fence();
      frags_dot_tile_wg<D>(dk_acc, dsa, qs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(&empty[s]);
    }
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(dv_acc);
    const size_t base = (size_t)bh * T * D;
    store_rows_wg<D>(dk + base, dk_acc, k0 + wg * 64, T);
    store_rows_wg<D>(dv + base, dv_acc, k0 + wg * 64, T);
  }
}

// dq: a block owns 128 queries (Q, dO resident; lse, di in registers) and
// streams the keys (K, V) kN at a time.  Per tile a consumer warpgroup
// computes s = q k^T and dp = do v^T from shared memory, p and ds in
// registers, then dq += bf16(ds) k with ds as the register A operand.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    bf16* __restrict__ dq, int T) {
  using L = BwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;
  const int q0 = blockIdx.x * kBwdRows, bh = blockIdx.y;
  const int n_tiles = (T + kN - 1) / kN;
  init_ring(qdo_full, 1);
  const int wg_idx = warpgroup();

  if (wg_idx == 0) {  // producer
    hopper::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(qdo_full, 2 * L::kResident);
      tma_tile<D, kBwdRows>(smem + L::res0, &tq, qdo_full, q0, bh);
      tma_tile<D, kBwdRows>(smem + L::res1, &tdo, qdo_full, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::kStream);
        tma_tile<D, kN>(smem + L::ring0 + s * L::kStream, &tk, &full[s], i * kN, bh);
        tma_tile<D, kN>(smem + L::ring1 + s * L::kStream, &tv, &full[s], i * kN, bh);
      }
    }
  } else {  // consumers
    hopper::regs_alloc<kConsumerRegs>();
    const int wg = wg_idx - 1, lane = threadIdx.x & 31, t = lane & 3;
    const uint32_t qs = hopper::smem_addr(smem + L::res0) + wg * 64 * 128;  // this wg's 64 queries
    const uint32_t dos = hopper::smem_addr(smem + L::res1) + wg * 64 * 128;
    const int row0 = q0 + wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    float row_lse[2], row_di[2];  // lse times log2 e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      row_lse[r] = row < T ? lse[(size_t)bh * T + row] * kLog2e : 0.f;
      row_di[r] = row < T ? di[(size_t)bh * T + row] : 0.f;
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq_acc[j] = 0.f;
    constexpr bool kPipelined = D == 64;
    uint32_t dsa[kN / 16][4];  // bf16 ds of the last tile
    auto issue_scores = [&](float(&p)[kN / 2], float(&dp)[kN / 2], int i) {
      const int s = i % kStages;
      hopper::mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t ks = hopper::smem_addr(smem + L::ring0 + s * L::kStream);
      const uint32_t vs = hopper::smem_addr(smem + L::ring1 + s * L::kStream);
      hopper::wgmma_fence();
      rows_dot_rows_wg<D>(p, qs, ks);
      rows_dot_rows_wg<D>(dp, dos, vs);
      hopper::wgmma_commit();
    };
    auto issue_grads = [&](int i) {  // dq += ds k of tile i
      hopper::fence_regs(dq_acc);
      hopper::wgmma_fence();
      frags_dot_tile_wg<D>(dq_acc, dsa,
                               hopper::smem_addr(smem + L::ring0 + (i % kStages) * L::kStream));
      hopper::wgmma_commit();
    };
    hopper::mbar_wait(qdo_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      float p[kN / 2], ds[kN / 2];  // p, dp then ds: 64 queries x kN keys
      issue_scores(p, ds, i);
      if (kPipelined && i > 0) {
        issue_grads(i - 1);
        hopper::wgmma_wait<1>();  // the scores have landed; tile i - 1's product may run
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(p);
      hopper::fence_regs(ds);
      const int past = T - i * kN;  // keys of this tile below T: p = 0 from there
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) {
        const bool valid = (j >> 2) * 8 + t * 2 + (j & 1) < past;
        const float pe = valid ? exp2_approx(fmaf(p[j], kLog2e, -row_lse[(j >> 1) & 1])) : 0.f;
        ds[j] = pe * (ds[j] - row_di[(j >> 1) & 1]);
      }
      if (kPipelined && i > 0) {  // tile i - 1's product is done with its tile and fragments
        hopper::wgmma_wait<0>();
        hopper::mbar_arrive(&empty[(i - 1) % kStages]);
      }
      pack_frags(dsa, ds);
      if (!kPipelined) {
        issue_grads(i);
        hopper::wgmma_wait<0>();
        hopper::mbar_arrive(&empty[i % kStages]);
      }
    }
    if (kPipelined) {
      issue_grads(n_tiles - 1);
      hopper::wgmma_wait<0>();
    }
    hopper::fence_regs(dq_acc);
    store_rows_wg<D>(dq + (size_t)bh * T * D, dq_acc, q0 + wg * 64, T);
  }
}

// Shared memory above 48 KB is dynamic only, after this opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int BH, int T, int D) {
  return BH <= 0 || BH > 65535 || T <= 0 || (D != 64 && D != 128);
}

// A 3-D map over a (BH, T, D) bf16 tensor with 64 x 64 boxes and the
// 128-byte swizzle: a box past T reads zeros of the same head.
bool tile_map(CUtensorMap* map, const void* base, int BH, int T, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  return hopper::bf16_map(map, base, 3, dims, strides);
}

dim3 bwd_grid(int BH, int T) {
  return dim3((unsigned)((T + kBwdRows - 1) / kBwdRows), (unsigned)BH);
}

template <int D>
cudaError_t fwd(cudaStream_t s, const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                int BH, int T) {
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, BH, T, D) || !tile_map(&tk, k, BH, T, D) || !tile_map(&tv, v, BH, T, D))
    return cudaErrorInvalidValue;
  const size_t smem = FwdSmem<D>::bytes;
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const long long n_items = (long long)BH * ((T + kBwdRows - 1) / kBwdRows);
  if (n_items > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_kernel<D><<<(unsigned)(n_items < sms ? n_items : sms), kBwdThreads, smem, s>>>(
      tq, tk, tv, o, lse, T, (int)n_items);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(cudaStream_t s, const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* di, bf16* dq, int BH, int T) {
  CUtensorMap tq, tk, tv, tdo;
  if (!tile_map(&tq, q, BH, T, D) || !tile_map(&tk, k, BH, T, D) ||
      !tile_map(&tv, v, BH, T, D) || !tile_map(&tdo, dout, BH, T, D))
    return cudaErrorInvalidValue;
  const size_t smem = BwdSmem<D>::bytes;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<bwd_grid(BH, T), kBwdThreads, smem, s>>>(tq, tk, tv, tdo, lse, di, dq,
                                                                     T);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(cudaStream_t s, const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* lse, const float* di, bf16* dk, bf16* dv,
                    int BH, int T) {
  CUtensorMap tq, tk, tv, tdo;
  if (!tile_map(&tq, q, BH, T, D) || !tile_map(&tk, k, BH, T, D) ||
      !tile_map(&tv, v, BH, T, D) || !tile_map(&tdo, dout, BH, T, D))
    return cudaErrorInvalidValue;
  const size_t smem = BwdSmem<D>::bytes;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D><<<bwd_grid(BH, T), kBwdThreads, smem, s>>>(tq, tk, tv, tdo, lse, di, dk,
                                                                      dv, T);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each launches on `stream` and
// returns cudaGetLastError() after the launch (0 on success).  All arrays
// are contiguous: bf16 (BH, T, D), f32 (BH, T); D is 64 or 128; BH <= 65535.
extern "C" int pika_flash_attention_fwd(int device, void* stream, const void* q, const void* k,
                                        const void* v, void* o, float* lse, int BH, int T,
                                        int D) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_shape(BH, T, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qb = static_cast<const bf16*>(q);
  auto* kb = static_cast<const bf16*>(k);
  auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(o);
  return D == 64 ? fwd<64>(s, qb, kb, vb, ob, lse, BH, T) : fwd<128>(s, qb, kb, vb, ob, lse, BH, T);
}

extern "C" int pika_flash_attention_bwd_dq(int device, void* stream, const void* q, const void* k,
                                           const void* v, const void* dout, const float* lse,
                                           const float* di, void* dq, int BH, int T, int D) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_shape(BH, T, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qb = static_cast<const bf16*>(q);
  auto* kb = static_cast<const bf16*>(k);
  auto* vb = static_cast<const bf16*>(v);
  auto* db = static_cast<const bf16*>(dout);
  auto* dqb = static_cast<bf16*>(dq);
  return D == 64 ? bwd_dq<64>(s, qb, kb, vb, db, lse, di, dqb, BH, T)
                 : bwd_dq<128>(s, qb, kb, vb, db, lse, di, dqb, BH, T);
}

extern "C" int pika_flash_attention_bwd_dkv(int device, void* stream, const void* q,
                                            const void* k, const void* v, const void* dout,
                                            const float* lse, const float* di, void* dk, void* dv,
                                            int BH, int T, int D) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_shape(BH, T, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qb = static_cast<const bf16*>(q);
  auto* kb = static_cast<const bf16*>(k);
  auto* vb = static_cast<const bf16*>(v);
  auto* db = static_cast<const bf16*>(dout);
  auto* dkb = static_cast<bf16*>(dk);
  auto* dvb = static_cast<bf16*>(dv);
  return D == 64 ? bwd_dkv<64>(s, qb, kb, vb, db, lse, di, dkb, dvb, BH, T)
                 : bwd_dkv<128>(s, qb, kb, vb, db, lse, di, dkb, dvb, BH, T);
}
