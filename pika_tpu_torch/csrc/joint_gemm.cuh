// The pieces shared by the fused RNN-T joint kernels K1 (joint_fwd.cu), K2
// and K3 (joint_bwd.cu): a bf16 GEMM over 128 x BN output tiles with float32
// sums, written for Hopper (sm_90a), the kernel that forms the joint's
// hidden rows h in bf16, and the chunk schedule of the lattice.
//
// Every product of the joint is (lattice rows) x (H or V) with the
// contraction over the other of H and V, or (H x V) with the contraction
// over the rows.  A block of 3 warpgroups owns one output tile: a producer
// thread issues TMA loads of 64-deep stages (128-byte swizzle, zeros past
// every edge) into a 4-stage mbarrier ring, two consumer warpgroups of 64
// output rows each run wgmma.m64nBNk16 from shared memory, one stage's
// products in flight while the next is issued.  What a kernel does with
// its tile (the epilogue) is its own.
//
// The lattice: row = (b * T + t) * U1 + u for cell (b, t, u), (b, t) = bt.
// Each utterance's frames are cut into t-tiles of kTileT frames (the last
// one ragged), nt = ceil(T / kTileT) of them, numbered g = b * nt + ti over
// the batch.  A chunk is a run of whole t-tiles [g0, g1): the (b, t) rows
// [tile_bt(g0), tile_bt(g1)), so no 16-frame tile of K2's dh kernel
// straddles two chunks, and a chunk can be a part of one long utterance.
// TMA needs 16-byte strides and rows at least one box wide, so the callers'
// bf16 copies of W2 and the scratch are padded to Hp, Vp (H, V rounded up
// to 64) with zeros.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;           // producer warpgroup + 2 consumer warpgroups
constexpr int kTile = 128;              // output rows of a block: 64 per consumer
constexpr int kDepth = 64;              // contraction depth of one stage: one 128-byte panel
constexpr int kStages = 4;              // depth of the ring
constexpr int kPanel = 64 * 128;        // bytes of a 64 x 64 bf16 box
constexpr int kOperand = kTile * 128;   // bytes of A in a stage (128 rows of one panel)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 40*128 + 232*256 <= 65536
constexpr int kTileT = 16, kTileU = 8;  // K2's dh tile: 16 frames x 8 labels, t-major
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets into a block of BN output columns' shared memory: the ring
// (a stage is A, then B's BN / 64 boxes), a column-sum area (f32 [8
// warps][BN]), then full[kStages] and empty[kStages] barriers.
template <int BN>
struct Smem {
  static constexpr uint32_t stage = kOperand + BN * 128;
  static constexpr uint32_t red = kStages * stage;
  static constexpr uint32_t bars = red + 8 * BN * 4;
  static constexpr uint32_t bytes = bars + 2 * kStages * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// The producer's loop: for stage i, once its slot is free, load(st, bar,
// k0) issues the TMA loads of the stage (Smem<BN>::stage bytes in all) at
// contraction offset k0 = i * kDepth into slot st, completing on bar.
template <int BN, class Load>
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        int n_k, Load load) {
  constexpr int kStage = Smem<BN>::stage;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[s], kStage);
    load(ring + s * kStage, &full[s], i * kDepth);
  }
}

// B's BN / 64 boxes of a stage (after A's kOperand bytes), columns n0..
// n0 + BN - 1 of the output.
template <int Trans, int BN>
__device__ __forceinline__ void load_b(unsigned char* st, uint64_t* bar, const CUtensorMap* tb,
                                       int k0, int n0) {
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) {
    if constexpr (Trans)
      hopper::tma_load_2d(st + kOperand + j * kPanel, tb, bar, n0 + 64 * j, k0);
    else
      hopper::tma_load_2d(st + kOperand + j * kPanel, tb, bar, k0, n0 + 64 * j);
  }
}

// A stage from 2-D maps: two 64 x 64 boxes of A (rows m0.. m0 + 127 of the
// output) then B's boxes, each box 64 deep along the contraction at k0.
// Trans = 0: the maps' inner dimension is the contraction (K-major); Trans
// = 1: it is the output's.
template <int Trans, int BN>
__device__ __forceinline__ void load_stage(unsigned char* st, uint64_t* bar, const CUtensorMap* ta,
                                           const CUtensorMap* tb, int k0, int m0, int n0) {
#pragma unroll
  for (int j = 0; j < kTile / 64; ++j) {
    if constexpr (Trans)
      hopper::tma_load_2d(st + j * kPanel, ta, bar, m0 + 64 * j, k0);
    else
      hopper::tma_load_2d(st + j * kPanel, ta, bar, k0, m0 + 64 * j);
  }
  load_b<Trans, BN>(st, bar, tb, k0, n0);
}

// The consumers' loop: acc (64 x BN) = sum over the n_k stages of this
// warpgroup's 64 rows of A times B, 4 k16 steps a stage.  Trans = 0: both
// operands K-major (a stage holds 128 rows of A, then BN of B, each one
// 128-byte panel deep); Trans = 1: both MN-major (each operand is 64-column
// panels of 64 contraction rows).  One stage's products stay in flight
// while the next stage's are issued; a stage is released when its
// products are done.  In acc, this thread (lane l of warp w) holds rows
// w * 16 + l / 4 (+ 8) of the warpgroup's 64, columns 8 g + 2 (l % 4) (+ 1):
// acc[4 g + 2 r + e] is row + 8 r, column + e.
template <int Trans, int BN>
__device__ __forceinline__ void consume(float (&acc)[BN / 2], unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int n_k, int wg) {
  constexpr int kStage = Smem<BN>::stage;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t a = hopper::smem_addr(ring + s * kStage) + wg * kPanel;
    const uint32_t b = hopper::smem_addr(ring + s * kStage + kOperand);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      if constexpr (Trans)  // a k16 step is 16 rows of 128 bytes; the panels are kPanel apart
        hopper::wgmma_ss<1, 1>(acc, hopper::desc_sw128(a + kk * 2048, kPanel, 1024),
                               hopper::desc_sw128(b + kk * 2048, kPanel, 1024), i > 0 || kk > 0);
      else  // a k16 step is 32 bytes along the rows
        hopper::wgmma_ss(acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                         hopper::desc_sw128(b + kk * 32, 16, 1024), i > 0 || kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // stage i - 1's products are done
    if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

// h rows [row0, row0 + rows) of the lattice as bf16 (rows, Hp), zero past
// H; one thread per 8 columns (a 16-byte store).
__global__ void h_kernel(const float* __restrict__ ax, const float* __restrict__ gx,
                         const float* __restrict__ ay, const float* __restrict__ gy,
                         bf16* __restrict__ h, long long row0, int rows, int T, int U1, int H,
                         int Hp) {
  const int groups = Hp / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * groups) return;
  const long long local = idx / groups;
  const int c0 = (int)(idx % groups) * 8;
  const long long row = row0 + local;
  const long long bt = row / U1;  // b * T + t
  const long long bu = bt / T * U1 + row % U1;
  const float *axr = ax + bt * H, *gxr = gx + bt * H, *ayr = ay + bu * H, *gyr = gy + bu * H;
  uint32_t out[4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    float v[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = c0 + e + q;
      v[q] = c < H ? tanhf(axr[c] + ayr[c]) / (1.f + expf(-(gxr[c] + gyr[c]))) : 0.f;
    }
    out[e / 2] = hopper::pack_bf16(v[0], v[1]);
  }
  *reinterpret_cast<uint4*>(h + local * Hp + c0) = make_uint4(out[0], out[1], out[2], out[3]);
}

cudaError_t launch_h(cudaStream_t s, const float* ax, const float* gx, const float* ay,
                     const float* gy, bf16* h, long long row0, int rows, int T, int U1, int H,
                     int Hp) {
  const long long threads = (long long)rows * (Hp / 8);
  h_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(ax, gx, ay, gy, h, row0, rows, T,
                                                             U1, H, Hp);
  return cudaGetLastError();
}

// A 2-D map over a (rows, cols) row-major bf16 matrix: 64 x 64 boxes.
bool matrix_map(CUtensorMap* map, const void* base, long long rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  return hopper::bf16_map(map, base, 2, dims, strides);
}

// Shared memory above 48 KB is dynamic only, after this opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, uint32_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The first (b, t) row of t-tile g.
__host__ __device__ inline long long tile_bt(long long g, int nt, int T) {
  return g / nt * T + g % nt * kTileT;
}

// One chunk of the schedule: t-tiles [g0, g1), (b, t) rows [bt0, bt1),
// lattice rows [bt0 * U1, bt1 * U1).
struct Chunk {
  long long g0, g1, bt0, bt1;
  long long row0(int U1) const { return bt0 * U1; }
  int rows(int U1) const { return (int)((bt1 - bt0) * U1); }
};

// The chunks of `tiles` t-tiles each (the last one fewer) over B
// utterances of T frames; fn(chunk) for each in order, stopping at the
// first error it returns.
template <class Fn>
cudaError_t for_each_chunk(int B, int T, int tiles, Fn fn) {
  const int nt = (T + kTileT - 1) / kTileT;
  const long long n = (long long)B * nt;
  for (long long g = 0; g < n; g += tiles) {
    const long long g1 = g + tiles < n ? g + tiles : n;
    const Chunk c{g, g1, tile_bt(g, nt, T), tile_bt(g1, nt, T)};
    const cudaError_t err = fn(c);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Checks shared by the launchers: positive sizes, and every chunk's rows
// and row tiles within what an int and a grid's y extent hold.
inline bool valid_schedule(int B, int T, int U1, int H, int V, int tiles) {
  if (B <= 0 || T <= 0 || U1 <= 0 || H <= 0 || V <= 0 || tiles <= 0) return false;
  const long long n = (long long)B * ((T + kTileT - 1) / kTileT);
  const long long most = tiles < n ? tiles : n;  // t-tiles in the largest chunk
  const long long bts = most * kTileT < (long long)B * T ? most * kTileT : (long long)B * T;
  const long long rows = bts * U1;
  return rows < (1LL << 31) - kTile && (rows + kTile - 1) / kTile <= 65535 &&
         most * ((U1 + kTileU - 1) / kTileU) <= 65535;
}

}  // namespace
