// K2: the input gradients of the fused RNN-T joint channels, written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pika_tpu/ops/rnnt_pallas.py:_bwd_in_kernel,
// launched by joint_channels_pallas_bwd (K3, its weight gradient, is in
// joint_channels_bwd_w.cu).  Given K1's lse and the cotangents d_lse, d_zb,
// d_zy of the three channels, for every lattice cell (b, t, u) it
// recomputes
//
//     h  = tanh(ax[b,t] + ay[b,u]) * sigmoid(gx[b,t] + gy[b,u])       (H,)
//     z  = h . W2 + b2                                                (V,)
//     dz = d_lse * exp(min(z - lse, 40)) + [v = 0] d_zb + [v = label] d_zy
//
// (blank and label are the same column where label = 0, as in column U: both
// terms land on it).  Then dh = dz . W2^T; dpre = dh * sig * (1 - tanh^2),
// dgate = dh * tanh * sig * (1 - sig); d_ax, d_gx sum them over u, d_ay,
// d_gy over t.
//
// What bounds it on the H100: two (R x H) x (H x V) sized products, R =
// B*T*U1 cells, 2*R*H*V flops each (2 TFLOP in all at B=8, T=239, U1=41,
// H=1024, V=6268; 8 TFLOP at B=32), here in float32 on the SIMT FMA units.
//
// The TPU kernel carries dh across a sequential V grid axis in VMEM.  Here
// one block owns tile_t x tile_u cells (24 at H <= 1040, 16 at H <= 1560, 8
// at H <= 3120: an f32 h tile and an f32 dh tile of that many rows share
// the 227 KB of shared memory) and walks all of V itself: for each
// 256-column V tile it recomputes z as K1 does (warp w owns rows, lane l
// owns 8 columns, W2 double-buffered through shared memory), forms dz into
// shared memory (aliasing the spent W2 staging buffer), and adds dz . W2^T
// into the dh tile, reading W2^T (a transposed copy the wrapper makes)
// straight from L2, four coalesced H columns per thread.  The sums over u
// and over t cross block boundaries, so the block writes per-tile partials
// (B, T, n_u_tiles, H) and (B, n_t_tiles, U1, H) that the wrapper adds up
// with torch; nothing carries a running sum.
//
// Ragged T, U1, V and H are masked here; the caller pads nothing.  bf16
// wgmma and TMA, and reading K3's dz chunks so z is formed once per
// backward, are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

// K2
constexpr int kCols = 256;                              // V tile
constexpr int kK = 16;                                  // depth of one staged W2 chunk
constexpr int kChunkPerThread = kK * kCols / kThreads;  // 16
constexpr int kDhCols = 4;                              // H columns of dh per thread

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The cotangent of logit column `col` of one cell.
__device__ __forceinline__ float dlogit(float z, int col, float lse, float dl, float db,
                                        float dy, int label) {
  float dz = dl * expf(fminf(z - lse, 40.f));
  if (col == 0) dz += db;
  if (col == label) dz += dy;
  return dz;
}

// ---------------------------------------------------------------------------
// K2: gradients to ax, gx, ay, gy
// ---------------------------------------------------------------------------

template <int kRowsPerWarp>
__global__ void __launch_bounds__(kThreads, 1)
bwd_in_kernel(const float* __restrict__ ax, const float* __restrict__ gx,
              const float* __restrict__ ay, const float* __restrict__ gy,
              const float* __restrict__ w2, const float* __restrict__ w2t,
              const float* __restrict__ b2, const int* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ d_lse,
              const float* __restrict__ d_zb, const float* __restrict__ d_zy,
              float* __restrict__ dax_p, float* __restrict__ dgx_p,
              float* __restrict__ day_p, float* __restrict__ dgy_p,
              int T, int U1, int H, int Hp, int V, int tile_t, int tile_u, int nt, int nu) {
  constexpr int kRows = kRowsPerWarp * kWarps;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [kRows][Hp]; dpre in the epilogue
  float* dhs = hs + (size_t)kRows * Hp;         // [kRows][Hp]; dgate in the epilogue
  float* ws = dhs + (size_t)kRows * Hp;         // [2][kK][kCols] W2 staging
  float* dzs = ws;                              // [kRows][kCols], aliases the staging

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ti = blockIdx.x / nu, ui = blockIdx.x - ti * nu;
  const int b = blockIdx.y;

  // Row r of the block is cell (t0 + r / tile_u, u0 + r % tile_u).
  auto cell_of = [&](int r, long long* cell, int* t, int* u) {
    *t = ti * tile_t + r / tile_u;
    *u = ui * tile_u + r % tile_u;
    *cell = ((long long)b * T + *t) * U1 + *u;
    return r < tile_t * tile_u && *t < T && *u < U1;
  };

  // 1. The h tile, and dh = 0.  Lanes walk H, so the factor loads are coalesced.
  for (int r = warp; r < kRows; r += kWarps) {
    long long cell;
    int t, u;
    const bool ok = cell_of(r, &cell, &t, &u);
    float* hrow = hs + (size_t)r * Hp;
    float* dhrow = dhs + (size_t)r * Hp;
    const float* axr = ax + ((long long)b * T + t) * H;
    const float* gxr = gx + ((long long)b * T + t) * H;
    const float* ayr = ay + ((long long)b * U1 + u) * H;
    const float* gyr = gy + ((long long)b * U1 + u) * H;
    for (int k = lane; k < Hp; k += 32) {
      hrow[k] = ok && k < H ? tanhf(axr[k] + ayr[k]) * sigmoid(gxr[k] + gyr[k]) : 0.f;
      dhrow[k] = 0.f;
    }
  }

  // Per-row state of this warp's rows; every lane of the warp holds the same values.
  float r_lse[kRowsPerWarp], r_dl[kRowsPerWarp], r_db[kRowsPerWarp], r_dy[kRowsPerWarp];
  int r_label[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    long long cell;
    int t, u;
    const bool ok = cell_of(warp * kRowsPerWarp + i, &cell, &t, &u);
    r_lse[i] = ok ? lse[cell] : 0.f;
    r_dl[i] = ok ? d_lse[cell] : 0.f;
    r_db[i] = ok ? d_zb[cell] : 0.f;
    r_dy[i] = ok ? d_zy[cell] : 0.f;
    r_label[i] = ok ? labels[(long long)b * U1 + u] : -1;
  }

  const int n_chunks = Hp / kK;
  const float* hw = hs + (size_t)warp * kRowsPerWarp * Hp;
  float stage[kChunkPerThread];

  for (int v0 = 0; v0 < V; v0 += kCols) {
    // 2. z for this V tile, as in K1.
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
      __syncthreads();  // after the last chunk: the staging buffer is free for dz
    }

    // 3. dz of this V tile into shared memory; 0 past V.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = j < 4 ? 4 * lane + j : 128 + 4 * lane + j - 4;
      const int col = v0 + cl;
      const float bias = col < V ? b2[col] : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float dz = col < V ? dlogit(acc[i][j] + bias, col, r_lse[i], r_dl[i], r_db[i],
                                          r_dy[i], r_label[i])
                                 : 0.f;
        dzs[(warp * kRowsPerWarp + i) * kCols + cl] = dz;
      }
    }
    __syncthreads();

    // 4. dh += dz . W2^T over this V tile: thread owns kDhCols H columns
    //    k0 + j * kThreads; each dz row (a shared-memory broadcast) serves all
    //    of them, W2^T rows are coalesced over k, many loads in flight.
    for (int k0 = tid; k0 < Hp; k0 += kDhCols * kThreads) {
      float dacc[kDhCols][kRows];
      bool k_ok[kDhCols];
#pragma unroll
      for (int j = 0; j < kDhCols; ++j) {
        k_ok[j] = k0 + j * kThreads < H;
#pragma unroll
        for (int r = 0; r < kRows; ++r) dacc[j][r] = 0.f;
      }
#pragma unroll 2
      for (int c = 0; c < kCols; c += 4) {
        float w[kDhCols][4];
#pragma unroll
        for (int j = 0; j < kDhCols; ++j)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int col = v0 + c + s;
            w[j][s] = (k_ok[j] && col < V) ? w2t[(size_t)col * H + k0 + j * kThreads] : 0.f;
          }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(dzs + r * kCols + c);
#pragma unroll
          for (int j = 0; j < kDhCols; ++j)
            dacc[j][r] = fmaf(d.x, w[j][0],
                              fmaf(d.y, w[j][1], fmaf(d.z, w[j][2], fmaf(d.w, w[j][3], dacc[j][r]))));
        }
      }
#pragma unroll
      for (int j = 0; j < kDhCols; ++j) {
        const int k = k0 + j * kThreads;
        if (k < Hp) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) dhs[(size_t)r * Hp + k] += dacc[j][r];
        }
      }
    }
    __syncthreads();  // dzs aliases the staging buffer of the next V tile
  }

  // 5. The tanh / sigmoid derivatives, in place: hs <- dpre, dhs <- dgate.
  for (int r = warp; r < kRows; r += kWarps) {
    long long cell;
    int t, u;
    const bool ok = cell_of(r, &cell, &t, &u);
    float* prow = hs + (size_t)r * Hp;
    float* grow = dhs + (size_t)r * Hp;
    const float* axr = ax + ((long long)b * T + t) * H;
    const float* gxr = gx + ((long long)b * T + t) * H;
    const float* ayr = ay + ((long long)b * U1 + u) * H;
    const float* gyr = gy + ((long long)b * U1 + u) * H;
    for (int k = lane; k < H; k += 32) {
      if (ok) {
        const float th = tanhf(axr[k] + ayr[k]);
        const float ga = sigmoid(gxr[k] + gyr[k]);
        const float dh = grow[k];
        prow[k] = dh * ga * (1.f - th * th);
        grow[k] = dh * th * ga * (1.f - ga);
      } else {
        prow[k] = 0.f;
        grow[k] = 0.f;
      }
    }
  }
  __syncthreads();

  // 6. Partials: d_ax, d_gx summed over this tile's u; d_ay, d_gy over its t.
  for (int tl = 0; tl < tile_t; ++tl) {
    const int t = ti * tile_t + tl;
    if (t >= T) break;
    const long long o = (((long long)b * T + t) * nu + ui) * H;
    for (int k = tid; k < H; k += kThreads) {
      float sp = 0.f, sg = 0.f;
      for (int ul = 0; ul < tile_u; ++ul) {
        sp += hs[(size_t)(tl * tile_u + ul) * Hp + k];
        sg += dhs[(size_t)(tl * tile_u + ul) * Hp + k];
      }
      dax_p[o + k] = sp;
      dgx_p[o + k] = sg;
    }
  }
  for (int ul = 0; ul < tile_u; ++ul) {
    const int u = ui * tile_u + ul;
    if (u >= U1) break;
    const long long o = (((long long)b * nt + ti) * U1 + u) * H;
    for (int k = tid; k < H; k += kThreads) {
      float sp = 0.f, sg = 0.f;
      for (int tl = 0; tl < tile_t; ++tl) {
        sp += hs[(size_t)(tl * tile_u + ul) * Hp + k];
        sg += dhs[(size_t)(tl * tile_u + ul) * Hp + k];
      }
      day_p[o + k] = sp;
      dgy_p[o + k] = sg;
    }
  }
}

// K2's shared memory: an h tile and a dh tile of rows x Hp floats, and the
// W2 staging.
size_t in_smem_bytes(int rows, int Hp) {
  return ((size_t)2 * rows * Hp + 2 * kK * kCols) * sizeof(float);
}

// Rows per block K2 takes at this H: 24, 16 or 8; 0 if none fits.
int in_rows(int device, int H, int* Hp_out, size_t* smem_out) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  const int Hp = (H + kK - 1) / kK * kK;
  *Hp_out = Hp;
  for (int rows : {3 * kWarps, 2 * kWarps, kWarps}) {
    if (in_smem_bytes(rows, Hp) <= (size_t)optin) {
      *smem_out = in_smem_bytes(rows, Hp);
      return rows;
    }
  }
  return 0;
}

template <int kRowsPerWarp>
cudaError_t launch_in(cudaStream_t stream, size_t smem, dim3 grid, const float* ax,
                      const float* gx, const float* ay, const float* gy, const float* w2,
                      const float* w2t, const float* b2, const int* labels, const float* lse,
                      const float* d_lse, const float* d_zb, const float* d_zy, float* dax_p,
                      float* dgx_p, float* day_p, float* dgy_p, int T, int U1, int H, int Hp,
                      int V, int tile_t, int tile_u, int nt, int nu) {
  cudaError_t err = cudaFuncSetAttribute(bwd_in_kernel<kRowsPerWarp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_in_kernel<kRowsPerWarp><<<grid, kThreads, smem, stream>>>(
      ax, gx, ay, gy, w2, w2t, b2, labels, lse, d_lse, d_zb, d_zy, dax_p, dgx_p, day_p, dgy_p,
      T, U1, H, Hp, V, tile_t, tile_u, nt, nu);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  The launchers run on `stream` and
// return cudaGetLastError() after the launch (0 on success); labels must lie
// in [0, V).

// K2's cell tile at this T, U1 and H: tile_t x tile_u <= the rows per block
// that fit, picked to waste the fewest rows on the ragged T and U1 edges.
extern "C" int pika_joint_channels_bwd_in_tile(int device, int T, int U1, int H, int* tile_t,
                                               int* tile_u) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (T <= 0 || U1 <= 0 || H <= 0) return cudaErrorInvalidValue;
  int Hp = 0;
  size_t smem = 0;
  const int rows = in_rows(device, H, &Hp, &smem);
  if (rows == 0) return cudaErrorInvalidValue;
  double best = -1.0;
  for (int tu = rows < U1 ? rows : U1; tu >= 1; --tu) {
    int tt = rows / tu;
    if (tt > T) tt = T;
    const int nt = (T + tt - 1) / tt, nu = (U1 + tu - 1) / tu;
    const double used = (double)T * U1 / ((double)nt * tt * nu * tu) * tt * tu / rows;
    if (used > best) {
      best = used;
      *tile_t = tt;
      *tile_u = tu;
    }
  }
  return cudaSuccess;
}

// K2.  dax_p, dgx_p: (B, T, nu, H); day_p, dgy_p: (B, nt, U1, H), with
// nt = ceil(T / tile_t), nu = ceil(U1 / tile_u).  w2t is W2 transposed (V, H).
extern "C" int pika_joint_channels_bwd_in(int device, void* stream, const float* ax,
                                          const float* gx, const float* ay, const float* gy,
                                          const float* w2, const float* w2t, const float* b2,
                                          const int* labels, const float* lse,
                                          const float* d_lse, const float* d_zb,
                                          const float* d_zy, float* dax_p, float* dgx_p,
                                          float* day_p, float* dgy_p, int B, int T, int U1,
                                          int H, int V, int tile_t, int tile_u) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || T <= 0 || U1 <= 0 || H <= 0 || V <= 0 || tile_t <= 0 || tile_u <= 0)
    return cudaErrorInvalidValue;
  int Hp = 0;
  size_t smem = 0;
  const int rows = in_rows(device, H, &Hp, &smem);
  if (rows == 0 || tile_t * tile_u > rows || B > 65535) return cudaErrorInvalidValue;
  const int nt = (T + tile_t - 1) / tile_t, nu = (U1 + tile_u - 1) / tile_u;
  const dim3 grid((unsigned)(nt * nu), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 3 * kWarps)
    return launch_in<3>(s, smem, grid, ax, gx, ay, gy, w2, w2t, b2, labels, lse, d_lse, d_zb,
                        d_zy, dax_p, dgx_p, day_p, dgy_p, T, U1, H, Hp, V, tile_t, tile_u, nt, nu);
  if (rows == 2 * kWarps)
    return launch_in<2>(s, smem, grid, ax, gx, ay, gy, w2, w2t, b2, labels, lse, d_lse, d_zb,
                        d_zy, dax_p, dgx_p, day_p, dgy_p, T, U1, H, Hp, V, tile_t, tile_u, nt, nu);
  return launch_in<1>(s, smem, grid, ax, gx, ay, gy, w2, w2t, b2, labels, lse, d_lse, d_zb,
                      d_zy, dax_p, dgx_p, day_p, dgy_p, T, U1, H, Hp, V, tile_t, tile_u, nt, nu);
}
