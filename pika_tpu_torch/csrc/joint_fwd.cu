// K1: the fused RNN-T joint-channel forward, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pika_tpu/ops/rnnt_pallas.py:_fwd_kernel
// (launched by joint_channels_pallas at its default mm_dtype = bf16).  For
// every lattice cell (b, t, u):
//
//     h   = bf16(tanh(ax[b,t] + ay[b,u]) * sigmoid(gx[b,t] + gy[b,u]))  (H,)
//     z   = h . bf16(W2) + b2                 (bf16 operands, f32 sums)  (V,)
//     lse = logsumexp(z),  zb = z[0],  zy = z[labels_ext[b,u]]
//
// and writes only the three (B, T, U+1) float32 channels: the
// (B, T, U+1, V) logit lattice is never stored.
//
// What bounds it on the H100: the (R x H) x (H x V) product, 2*R*H*V flops
// on the bf16 tensor cores (1.01 TFLOP, 1.02 ms at 989 TFLOP/s at the
// flagship eval shape R = 8*239*41, H = 1024, V = 6268; 4.03 TFLOP at B =
// 32).  A block cannot hold a row's whole h at H = 1024 beside enough rows
// to reuse W2, so V is split instead of walked: over the chunks of
// joint_gemm.cuh's schedule, in stream order,
//
//   h kernel    (joint_gemm.cuh) the chunk's h rows into a (rows, Hp) bf16
//               scratch;
//   lse kernel  z = h_c . W2 over a 128-row x 128-column tile (A = h_c, B =
//               W2^T, both K-major: the GEMM of K3's dz kernel) with the
//               softmax partials as the epilogue: per row, the tile's max
//               m_j and sum of exp(z - m_j) over its columns below V (a quad
//               of lanes holds a row: two shuffles each), into a (v tiles,
//               rows) scratch; zb and zy from the block that holds the
//               column;
//   combine     per row, lse = M + log(sum_j s_j exp(m_j - M)), M = max m_j.
//
// z is formed as K2 and K3's dz kernel forms it (same h, same W2 copy, same
// tile order), so the backward's softmax is normalized by this lse.  Every
// output has one writer: no atomics, reruns are bit-identical.
#include "joint_gemm.cuh"

namespace {

// Softmax partials of a 128-row x 128-column tile of z (rows m0.., columns
// n0..): th maps the chunk's h (rows, Hp), tw maps W2^T (Vp, Hp); b2 padded
// to Vp.  part: the chunk's (v tiles, rows) (max, sum of exp) pairs; zb, zy
// and labels are the whole lattice's, row0 the chunk's first row.
__global__ void __launch_bounds__(kThreads, 1)
lse_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw,
           const float* __restrict__ b2, const int* __restrict__ labels,
           float2* __restrict__ part, float* __restrict__ zb, float* __restrict__ zy,
           long long row0, int rows, int T, int U1, int Hp, int V) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  using L = Smem<kTile>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int n_k = Hp / kDepth;
  init_ring(full, empty);
  const int wg_idx = hopper::warpgroup();

  if (wg_idx == 0) {  // producer
    hopper::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0)
      produce<kTile>(smem, full, empty, n_k,
                     [ta = &th, tb = &tw, m0, n0](unsigned char* st, uint64_t* bar, int k0) {
                       load_stage<0, kTile>(st, bar, ta, tb, k0, m0, n0);
                     });
  } else {  // consumers
    hopper::regs_alloc<kConsumerRegs>();
    const int wg = wg_idx - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int q = lane & 3;
    const int local0 = m0 + wg * 64 + warp * 16 + (lane >> 2);  // rows local0, local0 + 8
    int r_label[2];
    bool r_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int local = local0 + 8 * r;
      const long long row = row0 + local;
      r_ok[r] = local < rows;
      r_label[r] = r_ok[r] ? labels[row / ((long long)T * U1) * U1 + row % U1] : -1;
    }
    float acc[kTile / 2];
    consume<0, kTile>(acc, smem, full, empty, n_k, wg);

#pragma unroll
    for (int g = 0; g < kTile / 8; ++g) {  // z = h W2 + b2
      const int c = n0 + 8 * g + 2 * q;
      const float2 bias = *reinterpret_cast<const float2*>(b2 + (c < V ? c : 0));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * g + 2 * r] += bias.x;
        acc[4 * g + 2 * r + 1] += bias.y;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int g = 0; g < kTile / 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + 8 * g + 2 * q + e < V) m = fmaxf(m, acc[4 * g + 2 * r + e]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kTile / 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + 8 * g + 2 * q + e < V)
            s += hopper::exp2_approx((acc[4 * g + 2 * r + e] - m) * kLog2e);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (!r_ok[r]) continue;
      const int local = local0 + 8 * r;
      const long long row = row0 + local;
      if (q == 0) part[(size_t)blockIdx.x * rows + local] = make_float2(m, s);
#pragma unroll
      for (int g = 0; g < kTile / 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * g + 2 * q + e;
          if (col == 0) zb[row] = acc[4 * g + 2 * r + e];
          if (col == r_label[r]) zy[row] = acc[4 * g + 2 * r + e];
        }
    }
  }
}

// lse of the chunk's rows from their v_tiles softmax partials, in a fixed
// order; one thread per row.
__global__ void combine_kernel(const float2* __restrict__ part, float* __restrict__ lse,
                               long long row0, int rows, int v_tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float m = -INFINITY;
  for (int j = 0; j < v_tiles; ++j) m = fmaxf(m, part[(size_t)j * rows + i].x);
  float s = 0.f;
  for (int j = 0; j < v_tiles; ++j) {
    const float2 p = part[(size_t)j * rows + i];
    s += p.y * expf(p.x - m);
  }
  lse[row0 + i] = m + logf(s);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Launches every chunk's kernels on
// `stream` in order and returns the first CUDA error (0 on success).  ax,
// gx: (B, T, H) f32; ay, gy: (B, U1, H) f32; w2t: (Vp, Hp) bf16, W2
// transposed and zero-padded; b2p: (Vp,) f32, b2 padded with 0; labels: (B,
// U1) int32 in [0, V).  The schedule: chunks of `tiles` t-tiles of 16
// frames (joint_gemm.cuh).  Scratch for the largest chunk's rows: h_buf
// (rows, Hp) bf16, part_buf (ceil(Vp / 128), rows) float2.  Out: lse, zb, zy
// (B, T, U1) f32.  Hp, Vp: H, V rounded up to 64.  Every pointer 16-byte
// aligned.
extern "C" int pika_joint_channels_fwd(int device, void* stream, const float* ax,
                                       const float* gx, const float* ay, const float* gy,
                                       const void* w2t, const float* b2p, const int* labels,
                                       void* h_buf, void* part_buf, float* lse, float* zb,
                                       float* zy, int B, int T, int U1, int H, int V, int tiles) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid_schedule(B, T, U1, H, V, tiles)) return cudaErrorInvalidValue;
  const int Hp = (H + 63) / 64 * 64, Vp = (V + 63) / 64 * 64;
  const int v_tiles = (Vp + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr uint32_t smem = Smem<kTile>::bytes;
  if ((err = allow_smem(lse_kernel, smem)) != cudaSuccess) return err;
  CUtensorMap tw;
  if (!matrix_map(&tw, w2t, Vp, Hp)) return cudaErrorInvalidValue;
  auto* hb = static_cast<bf16*>(h_buf);
  auto* part = static_cast<float2*>(part_buf);
  return for_each_chunk(B, T, tiles, [&](const Chunk& c) -> cudaError_t {
    const int rows = c.rows(U1);
    const long long row0 = c.row0(U1);
    cudaError_t e = launch_h(s, ax, gx, ay, gy, hb, row0, rows, T, U1, H, Hp);
    if (e != cudaSuccess) return e;
    CUtensorMap th;
    if (!matrix_map(&th, hb, rows, Hp)) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)v_tiles, (unsigned)((rows + kTile - 1) / kTile));
    lse_kernel<<<grid, kThreads, smem, s>>>(th, tw, b2p, labels, part, zb, zy, row0, rows, T, U1,
                                            Hp, V);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    combine_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(part, lse, row0, rows, v_tiles);
    return cudaGetLastError();
  });
}

extern "C" const char* pika_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
