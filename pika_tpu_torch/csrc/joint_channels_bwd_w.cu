// K3: the weight gradient of the fused RNN-T joint channels, written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pika_tpu/ops/rnnt_pallas.py:_bwd_w_kernel,
// launched by joint_channels_pallas_bwd at its default mm_dtype = bf16.
// Given K1's lse and the cotangents d_lse, d_zb, d_zy of the three channels,
// over every lattice cell (b, t, u) (a row of the lattice):
//
//     h  = bf16(tanh(ax[b,t] + ay[b,u]) * sigmoid(gx[b,t] + gy[b,u]))   (H,)
//     z  = h . bf16(W2) + b2                  (bf16 operands, f32 sums)   (V,)
//     dz = d_lse * exp(min(z - lse, 40)) + [v = 0] d_zb + [v = label] d_zy
//     dW2 = sum over rows of h^T bf16(dz),  db2 = sum over rows of dz (f32)
//
// (the blank and the label are the same column where label = 0: both terms
// land on it).
//
// What bounds it on the H100: the two (R x H) x (H x V) sized products,
// 2 * 2*R*H*V flops on the bf16 tensor cores (8.05 TFLOP, 8.1 ms at 989
// TFLOP/s, at R = 32*239*41 rows, H = 1024, V = 6268).  The TPU kernel keeps
// one (H, block_v) dW2 tile resident in VMEM across every lattice tile; on
// Hopper a 1024 x 128 f32 tile is twice an SM's registers, and splitting H
// would recompute z once per slice.  So dz is materialized instead, in
// chunks of rows small enough that the bf16 scratch stays near 512 MB (the
// lattice is never written whole), and each chunk runs three kernels in
// stream order:
//
//   h kernel   the chunk's h rows, f32 tanh * sigmoid rounded to bf16, into
//              a (rows, Hp) scratch: read by both products;
//   dz kernel  z = h_c . W2 (A = h_c, B = W2^T, both K-major) with the dz
//              formula as the epilogue; writes bf16 dz into a (rows, Vp)
//              scratch and each block's f32 column sums of dz (db2 partials,
//              summed by the caller);
//   dw kernel  dW2 += h_c^T . dz_c, both operands read MN-major (the
//              lattice rows are the contraction); a plain store on the
//              first chunk, an add after.
//
// Both products are warp-specialised blocks of 3 warpgroups over a 128 x
// 128 output tile: a producer thread issues TMA loads of 64-deep stages
// (2-D tensor maps, 128-byte swizzle, zeros past every edge) into a
// 4-stage mbarrier ring, two consumer warpgroups of 64 output rows each
// run wgmma.m64n128k16 from shared memory, one stage's products in flight
// while the next is issued.  Every block owns its output tile within a
// launch and the chunks run in order: no atomics, reruns are bit-identical.
//
// TMA needs 16-byte strides and rows at least one box wide: H and V are
// padded to Hp, Vp (multiples of 64) in the caller's bf16 copies and the
// scratch (W2^T zero-padded, b2 padded with 0; padded columns of dz are
// forced to 0).  Rows past the chunk read zeros and their
// dz is forced to 0.
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
constexpr int kDwCols = 256;            // output columns of a dw block (a dz block: kTile)
constexpr int kDepth = 64;              // contraction depth of one stage: one 128-byte panel
constexpr int kStages = 4;              // depth of the ring
constexpr int kPanel = 64 * 128;        // bytes of a 64 x 64 bf16 box
constexpr int kOperand = kTile * 128;   // bytes of A in a stage (2 boxes)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 40*128 + 232*256 <= 65536
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets into a block of BN output columns' shared memory: the ring
// (a stage is A, then B's BN / 64 boxes), the dz kernel's db2 reduction
// (f32 [8 warps][BN]), then full[kStages] and empty[kStages] barriers.
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

// The producer's loop: stage i holds two 64 x 64 boxes of A (rows m0..
// m0 + 127 of the output) then BN / 64 of B (columns n0.. n0 + BN - 1),
// each box 64 deep along the contraction at i * kDepth.  Trans = 0: the
// maps' inner dimension is the contraction (K-major); Trans = 1: it is the
// output's.
template <int Trans, int BN>
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* ta, const CUtensorMap* tb, int n_k,
                                        int m0, int n0) {
  constexpr int kStage = Smem<BN>::stage;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kStages, k0 = i * kDepth;
    hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[s], kStage);
    unsigned char* st = ring + s * kStage;
#pragma unroll
    for (int j = 0; j < kTile / 64; ++j) {
      if constexpr (Trans)
        hopper::tma_load_2d(st + j * kPanel, ta, &full[s], m0 + 64 * j, k0);
      else
        hopper::tma_load_2d(st + j * kPanel, ta, &full[s], k0, m0 + 64 * j);
    }
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      if constexpr (Trans)
        hopper::tma_load_2d(st + kOperand + j * kPanel, tb, &full[s], n0 + 64 * j, k0);
      else
        hopper::tma_load_2d(st + kOperand + j * kPanel, tb, &full[s], k0, n0 + 64 * j);
    }
  }
}

// The consumers' loop: acc (64 x BN) = sum over the n_k stages of this
// warpgroup's 64 rows of A times B, 4 k16 steps a stage.  Trans = 0: both
// operands K-major (a stage holds 128 rows of A, then BN of B, each one
// 128-byte panel deep); Trans = 1: both MN-major (each operand is 64-column
// panels of 64 contraction rows).  One stage's products stay in flight
// while the next stage's are issued; a stage is released when its
// products are done.
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

// dz for a 128-row x 128-column tile of the chunk (rows m0.., columns n0..):
// th maps the chunk's h (rows, Hp), tw maps W2^T (Vp, Hp); both K-major.
// lse, d_lse, d_zb, d_zy and labels are the whole lattice's; row0 is the
// chunk's first lattice row.  db2_p: this chunk's (row tiles, Vp) partials.
__global__ void __launch_bounds__(kThreads, 1)
dz_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw,
          const float* __restrict__ b2, const int* __restrict__ labels,
          const float* __restrict__ lse, const float* __restrict__ d_lse,
          const float* __restrict__ d_zb, const float* __restrict__ d_zy, bf16* __restrict__ dz,
          float* __restrict__ db2_p, long long row0, int rows, int T, int U1, int Hp, int V,
          int Vp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  using L = Smem<kTile>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int n_k = (Hp + kDepth - 1) / kDepth;
  init_ring(full, empty);
  const int wg_idx = hopper::warpgroup();

  if (wg_idx == 0) {  // producer
    hopper::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) produce<0, kTile>(smem, full, empty, &th, &tw, n_k, m0, n0);
  } else {  // consumers
    hopper::regs_alloc<kConsumerRegs>();
    const int wg = wg_idx - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int t = lane & 3;
    // this thread's two rows of the tile (lo, lo + 8) and their per-row terms
    const int local0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
    float r_lse[2], r_dl[2], r_db[2], r_dy[2];
    int r_label[2];
    bool r_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int local = local0 + 8 * r;
      const long long row = row0 + local;
      r_ok[r] = local < rows;
      r_lse[r] = r_ok[r] ? lse[row] : 0.f;
      r_dl[r] = r_ok[r] ? d_lse[row] : 0.f;
      r_db[r] = r_ok[r] ? d_zb[row] : 0.f;
      r_dy[r] = r_ok[r] ? d_zy[row] : 0.f;
      r_label[r] = r_ok[r] ? labels[row / ((long long)T * U1) * U1 + row % U1] : -1;
    }
    float acc[kTile / 2];
    consume<0, kTile>(acc, smem, full, empty, n_k, wg);

    // dz = d_lse exp(min(z - lse, 40)) + [v = 0] d_zb + [v = label] d_zy,
    // 0 past V and past the chunk; stored as bf16, summed in f32 per column
    float col_sum[kTile / 4];  // this thread's 32 columns: 8 g + 2 t + e
#pragma unroll
    for (int g = 0; g < kTile / 8; ++g) {
      const int c = n0 + 8 * g + 2 * t;
      const float2 bias = c < Vp ? *reinterpret_cast<const float2*>(b2 + c) : make_float2(0.f, 0.f);
      col_sum[2 * g] = col_sum[2 * g + 1] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c + e;
          const float z = acc[4 * g + 2 * r + e] + (e ? bias.y : bias.x);
          float v = r_dl[r] * hopper::exp2_approx(fminf(z - r_lse[r], 40.f) * kLog2e);
          if (col == 0) v += r_db[r];
          if (col == r_label[r]) v += r_dy[r];
          d[e] = r_ok[r] && col < V ? v : 0.f;
          col_sum[2 * g + e] += d[e];
        }
        if (r_ok[r] && c < Vp)
          *reinterpret_cast<uint32_t*>(dz + (size_t)(local0 + 8 * r) * Vp + c) =
              hopper::pack_bf16(d[0], d[1]);
      }
    }
    // column sums: over the 8 row groups of the warp, then over the 8 warps
    // in a fixed order (deterministic)
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      col_sum[j] += __shfl_xor_sync(0xffffffffu, col_sum[j], 4);
      col_sum[j] += __shfl_xor_sync(0xffffffffu, col_sum[j], 8);
      col_sum[j] += __shfl_xor_sync(0xffffffffu, col_sum[j], 16);
    }
    float* red = reinterpret_cast<float*>(smem + L::red);
    if (lane < 4) {
#pragma unroll
      for (int g = 0; g < kTile / 8; ++g) {
        red[(wg * 4 + warp) * kTile + 8 * g + 2 * t] = col_sum[2 * g];
        red[(wg * 4 + warp) * kTile + 8 * g + 2 * t + 1] = col_sum[2 * g + 1];
      }
    }
    hopper::bar_sync(1, 2 * 128);
    if (wg == 0 && n0 + tid < Vp) {
      float sum = 0.f;
      for (int w = 0; w < 8; ++w) sum += red[w * kTile + tid];
      db2_p[(size_t)blockIdx.y * Vp + n0 + tid] = sum;
    }
  }
}

// dW2[m0.., n0..] (+)= h_c^T dz_c over the chunk's rows, a 128 x BN tile:
// th maps h (rows, Hp), tdz maps dz (rows, Vp), both read MN-major.  dw2:
// (Hp, Vp) f32, stored when `first`, added to otherwise.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
dw_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tdz,
          float* __restrict__ dw2, int rows, int Hp, int Vp, int first) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem<BN>::bars);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTile;
  const int n_k = (rows + kDepth - 1) / kDepth;
  init_ring(full, empty);
  const int wg_idx = hopper::warpgroup();

  if (wg_idx == 0) {  // producer
    hopper::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) produce<1, BN>(smem, full, empty, &th, &tdz, n_k, m0, n0);
  } else {  // consumers
    hopper::regs_alloc<kConsumerRegs>();
    const int wg = wg_idx - 1, tid = threadIdx.x & 127, lane = tid & 31, t = lane & 3;
    float acc[BN / 2];
    consume<1, BN>(acc, smem, full, empty, n_k, wg);
    const int r_lo = m0 + wg * 64 + (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int g = 0; g < BN / 8; ++g) {
      const int c = n0 + 8 * g + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r_lo + 8 * r;
        if (row >= Hp || c >= Vp) continue;
        float2* dst = reinterpret_cast<float2*>(dw2 + (size_t)row * Vp + c);
        float2 v = make_float2(acc[4 * g + 2 * r], acc[4 * g + 2 * r + 1]);
        if (!first) {
          const float2 old = *dst;
          v.x += old.x;
          v.y += old.y;
        }
        *dst = v;
      }
    }
  }
}

// A 2-D map over a (rows, cols) row-major bf16 matrix: 64 x 64 boxes.
bool matrix_map(CUtensorMap* map, const void* base, long long rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  return hopper::bf16_map(map, base, 2, dims, strides);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Launches every chunk's three
// kernels on `stream` in order and returns the first CUDA error (0 on
// success).  ax, gx: (B, T, H) f32; ay, gy: (B, U1, H) f32; w2t: (Vp, Hp)
// bf16, W2 transposed and zero-padded; b2p: (Vp,) f32, b2 padded with 0;
// labels: (B, U1) int32 in [0, V); lse, d_lse, d_zb, d_zy: (B, T, U1) f32.
// Scratch: h_buf (min(chunk_rows, R), Hp) and dz_buf (min(chunk_rows, R),
// Vp) bf16, R = B*T*U1.  Out: dw2 (Hp, Vp) f32; db2_p (ceil(R / 128), Vp)
// f32 per-row-tile partials of d_b2.  Hp, Vp: H, V rounded up to 64;
// chunk_rows a positive multiple of 128.  Every pointer 16-byte aligned.
extern "C" int pika_joint_channels_bwd_w(int device, void* stream, const float* ax,
                                         const float* gx, const float* ay, const float* gy,
                                         const void* w2t, const float* b2p, const int* labels,
                                         const float* lse, const float* d_lse, const float* d_zb,
                                         const float* d_zy, void* h_buf, void* dz_buf, float* dw2,
                                         float* db2_p, int B, int T, int U1, int H, int V,
                                         int chunk_rows) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || T <= 0 || U1 <= 0 || H <= 0 || V <= 0 || chunk_rows <= 0 ||
      chunk_rows % kTile != 0 || chunk_rows / kTile > 65535)
    return cudaErrorInvalidValue;
  const int Hp = (H + 63) / 64 * 64, Vp = (V + 63) / 64 * 64;
  if ((Hp + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // shared memory above 48 KB is dynamic only, after this opt-in
  constexpr uint32_t dz_smem = Smem<kTile>::bytes, dw_smem = Smem<kDwCols>::bytes;
  if ((err = cudaFuncSetAttribute(dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dz_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dw_kernel<kDwCols>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem)) !=
          cudaSuccess)
    return err;
  CUtensorMap tw;
  if (!matrix_map(&tw, w2t, Vp, Hp)) return cudaErrorInvalidValue;
  const auto* hb = static_cast<const bf16*>(h_buf);
  const long long total = (long long)B * T * U1;
  for (long long row0 = 0; row0 < total; row0 += chunk_rows) {
    const int rows = (int)(total - row0 < chunk_rows ? total - row0 : chunk_rows);
    const long long h_threads = (long long)rows * (Hp / 8);
    h_kernel<<<(unsigned)((h_threads + 255) / 256), 256, 0, s>>>(
        ax, gx, ay, gy, static_cast<bf16*>(h_buf), row0, rows, T, U1, H, Hp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    CUtensorMap th, tdz;
    if (!matrix_map(&th, hb, rows, Hp) || !matrix_map(&tdz, dz_buf, rows, Vp))
      return cudaErrorInvalidValue;
    const unsigned row_tiles = (unsigned)((rows + kTile - 1) / kTile);
    const unsigned v_tiles = (unsigned)((Vp + kTile - 1) / kTile);
    dz_kernel<<<dim3(v_tiles, row_tiles), kThreads, dz_smem, s>>>(
        th, tw, b2p, labels, lse, d_lse, d_zb, d_zy, static_cast<bf16*>(dz_buf),
        db2_p + (size_t)(row0 / kTile) * Vp, row0, rows, T, U1, Hp, V, Vp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 dw_grid((unsigned)((Vp + kDwCols - 1) / kDwCols),
                       (unsigned)((Hp + kTile - 1) / kTile));
    dw_kernel<kDwCols><<<dw_grid, kThreads, dw_smem, s>>>(th, tdz, dw2, rows, Hp, Vp, row0 == 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
