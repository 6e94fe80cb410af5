// K1: the fused RNN-T joint-channel forward, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pika_tpu/ops/rnnt_pallas.py:_fwd_kernel
// (launched by joint_channels_pallas).  For every lattice cell (b, t, u):
//
//     h   = tanh(ax[b,t] + ay[b,u]) * sigmoid(gx[b,t] + gy[b,u])      (H,)
//     z   = h . W2 + b2                                               (V,)
//     lse = logsumexp(z),  zb = z[0],  zy = z[labels_ext[b,u]]
//
// and writes only the three (B, T, U+1) float32 channels: the
// (B, T, U+1, V) logit lattice is never stored.
//
// What bounds it on the H100: the (B*T*U1, H) x (H, V) product, about
// 2*B*T*U1*H*V flops (1.0 TFLOP at the flagship eval shape B=8, T=239,
// U1=41, H=1024, V=6268), here in float32 on the SIMT FMA units.  What the
// design does about it:
//   * One block owns 8 * R consecutive cells of the flattened (b, t, u)
//     grid, R rows per warp.  R is the largest of 6, 4, 2, 1 whose h tile
//     fits in shared memory: 48 rows for H <= 1040, down to 8 rows for
//     H <= 6240.  Every W2 element read from L2 serves that many rows.  The
//     block builds its h rows once, into shared memory, and then walks all
//     of V itself, keeping the online max / sum-exp and the blank and
//     label logits per row in registers.  The TPU kernel's sequential V grid
//     axis becomes this loop, since CUDA blocks run in no order.
//   * W2 streams through shared memory in (kK x kCols) chunks, double
//     buffered through registers so the next chunk's global loads are in
//     flight while the current one is multiplied.  W2 (25.7 MB at the
//     flagship shape) stays resident in the 50 MB L2 across blocks.
//   * Warp w owns R rows and lane l owns 8 columns of each V tile, so the
//     h operand is a shared-memory broadcast and every row reduction of the
//     online softmax stays inside one warp (shuffles, no shared memory).
//   * Ragged T, U+1, V and H edges are masked here; the caller pads nothing.
// bf16 wgmma and TMA, which would allow larger row tiles, are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 256;                 // vocabulary columns per V tile
constexpr int kK = 16;                     // depth of one staged W2 chunk
constexpr int kThreads = 256;              // 8 warps, one staged column each
constexpr int kWarps = kThreads / 32;
constexpr int kChunkPerThread = kK * kCols / kThreads;  // 16

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kRowsPerWarp lattice cells per warp, kRows per block.
template <int kRowsPerWarp>
__global__ void __launch_bounds__(kThreads, 1)
joint_channels_fwd_kernel(const float* __restrict__ ax, const float* __restrict__ gx,
                          const float* __restrict__ ay, const float* __restrict__ gy,
                          const float* __restrict__ w2, const float* __restrict__ b2,
                          const int* __restrict__ labels,
                          float* __restrict__ lse, float* __restrict__ zb,
                          float* __restrict__ zy,
                          int T, int U1, int H, int Hp, int V, long long rows_total) {
  constexpr int kRows = kRowsPerWarp * kWarps;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [kRows][Hp], row-major
  float* ws = hs + (size_t)kRows * Hp;          // [2][kK][kCols]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * kRows;

  // 1. The h tile.  Lanes walk H, so the factor loads are coalesced.
  for (int r = warp; r < kRows; r += kWarps) {
    const long long row = row0 + r;
    float* hrow = hs + (size_t)r * Hp;
    if (row < rows_total) {
      const long long bt = row / U1;
      const long long u = row - bt * U1;
      const long long b = bt / T;
      const float* axr = ax + bt * H;
      const float* gxr = gx + bt * H;
      const float* ayr = ay + (b * U1 + u) * H;
      const float* gyr = gy + (b * U1 + u) * H;
      for (int k = lane; k < Hp; k += 32)
        hrow[k] = k < H ? tanhf(axr[k] + ayr[k]) * sigmoid(gxr[k] + gyr[k]) : 0.f;
    } else {
      for (int k = lane; k < Hp; k += 32) hrow[k] = 0.f;
    }
  }

  // Per-row state of this warp's rows; every lane of the warp holds the same values.
  float run_m[kRowsPerWarp], run_s[kRowsPerWarp];
  int label[kRowsPerWarp];
  bool valid[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long row = row0 + warp * kRowsPerWarp + i;
    valid[i] = row < rows_total;
    const long long bt = row / U1;
    label[i] = valid[i] ? labels[(bt / T) * U1 + (row - bt * U1)] : -1;
    run_m[i] = -INFINITY;
    run_s[i] = 0.f;
  }

  const int n_chunks = Hp / kK;
  const float* hw = hs + (size_t)warp * kRowsPerWarp * Hp;
  float stage[kChunkPerThread];

  for (int v0 = 0; v0 < V; v0 += kCols) {
    const int vc = v0 + tid;  // the column this thread stages
    auto load_chunk = [&](int k0) {
#pragma unroll
      for (int j = 0; j < kChunkPerThread; ++j) {
        const int k = k0 + j;
        stage[j] = (k < H && vc < V) ? w2[(size_t)k * V + vc] : 0.f;
      }
    };
    auto store_chunk = [&](float* dst) {
#pragma unroll
      for (int j = 0; j < kChunkPerThread; ++j) dst[j * kCols + tid] = stage[j];
    };

    float acc[kRowsPerWarp][8];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load_chunk(0);
    store_chunk(ws);
    __syncthreads();  // also publishes the h tile on the first V tile

    for (int c = 0; c < n_chunks; ++c) {
      const float* wcur = ws + (c & 1) * kK * kCols;
      if (c + 1 < n_chunks) load_chunk((c + 1) * kK);
#pragma unroll
      for (int kk = 0; kk < kK; kk += 4) {
        float4 hv[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          hv[i] = *reinterpret_cast<const float4*>(hw + (size_t)i * Hp + c * kK + kk);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float4 wa = *reinterpret_cast<const float4*>(wcur + (kk + s) * kCols + 4 * lane);
          const float4 wb =
              *reinterpret_cast<const float4*>(wcur + (kk + s) * kCols + 128 + 4 * lane);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float h = s == 0 ? hv[i].x : s == 1 ? hv[i].y : s == 2 ? hv[i].z : hv[i].w;
            acc[i][0] = fmaf(h, wa.x, acc[i][0]);
            acc[i][1] = fmaf(h, wa.y, acc[i][1]);
            acc[i][2] = fmaf(h, wa.z, acc[i][2]);
            acc[i][3] = fmaf(h, wa.w, acc[i][3]);
            acc[i][4] = fmaf(h, wb.x, acc[i][4]);
            acc[i][5] = fmaf(h, wb.y, acc[i][5]);
            acc[i][6] = fmaf(h, wb.z, acc[i][6]);
            acc[i][7] = fmaf(h, wb.w, acc[i][7]);
          }
        }
      }
      if (c + 1 < n_chunks) store_chunk(ws + ((c + 1) & 1) * kK * kCols);
      __syncthreads();
    }

    // 2. Online logsumexp, blank and label logits over this V tile.
    int col[8];
    float bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      col[j] = v0 + (j < 4 ? 4 * lane + j : 128 + 4 * lane + j - 4);
      bias[j] = col[j] < V ? b2[col[j]] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float z[8];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        z[j] = acc[i][j] + bias[j];
        if (col[j] < V) m = fmaxf(m, z[j]);
      }
      const float m_new = fmaxf(run_m[i], warp_max(m));
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col[j] < V) s += expf(z[j] - m_new);
      run_s[i] = run_s[i] * expf(run_m[i] - m_new) + warp_sum(s);
      run_m[i] = m_new;
      if (valid[i]) {
        const long long row = row0 + warp * kRowsPerWarp + i;
        if (v0 == 0 && lane == 0) zb[row] = z[0];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (col[j] == label[i]) zy[row] = z[j];
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      if (valid[i]) lse[row0 + warp * kRowsPerWarp + i] = run_m[i] + logf(run_s[i]);
  }
}

template <int kRowsPerWarp>
size_t smem_bytes(int Hp) {
  return ((size_t)kRowsPerWarp * kWarps * Hp + 2 * kK * kCols) * sizeof(float);
}

template <int kRowsPerWarp>
cudaError_t launch(cudaStream_t stream, const float* ax, const float* gx, const float* ay,
                   const float* gy, const float* w2, const float* b2, const int* labels,
                   float* lse, float* zb, float* zy, int T, int U1, int H, int Hp, int V,
                   long long rows) {
  const size_t smem = smem_bytes<kRowsPerWarp>(Hp);
  cudaError_t err = cudaFuncSetAttribute(joint_channels_fwd_kernel<kRowsPerWarp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long block_rows = kRowsPerWarp * kWarps;
  const unsigned grid = (unsigned)((rows + block_rows - 1) / block_rows);
  joint_channels_fwd_kernel<kRowsPerWarp><<<grid, kThreads, smem, stream>>>(
      ax, gx, ay, gy, w2, b2, labels, lse, zb, zy, T, U1, H, Hp, V, rows);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).  labels must lie in
// [0, V); H is limited by the h tile in shared memory (H <= 6240 on Hopper).
extern "C" int pika_joint_channels_fwd(int device, void* stream, const float* ax,
                                       const float* gx, const float* ay, const float* gy,
                                       const float* w2, const float* b2, const int* labels,
                                       float* lse, float* zb, float* zy, int B, int T, int U1,
                                       int H, int V) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || T <= 0 || U1 <= 0 || H <= 0 || V <= 0) return cudaErrorInvalidValue;
  const int Hp = (H + kK - 1) / kK * kK;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t limit = (size_t)optin;
  const long long rows = (long long)B * T * U1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes<6>(Hp) <= limit)
    return launch<6>(s, ax, gx, ay, gy, w2, b2, labels, lse, zb, zy, T, U1, H, Hp, V, rows);
  if (smem_bytes<4>(Hp) <= limit)
    return launch<4>(s, ax, gx, ay, gy, w2, b2, labels, lse, zb, zy, T, U1, H, Hp, V, rows);
  if (smem_bytes<2>(Hp) <= limit)
    return launch<2>(s, ax, gx, ay, gy, w2, b2, labels, lse, zb, zy, T, U1, H, Hp, V, rows);
  if (smem_bytes<1>(Hp) <= limit)
    return launch<1>(s, ax, gx, ay, gy, w2, b2, labels, lse, zb, zy, T, U1, H, Hp, V, rows);
  return cudaErrorInvalidValue;
}

extern "C" const char* pika_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
