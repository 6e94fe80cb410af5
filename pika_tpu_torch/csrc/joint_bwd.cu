// K2 and K3: the gradients of the fused RNN-T joint channels, written for
// Hopper (sm_90a).
//
// Replace the Pallas TPU kernels pika_tpu/ops/rnnt_pallas.py:_bwd_in_kernel
// (K2) and _bwd_w_kernel (K3), launched by joint_channels_pallas_bwd at its
// default mm_dtype = bf16.  Given K1's lse and the cotangents d_lse, d_zb,
// d_zy of the three channels, over every lattice cell (b, t, u) (a row of
// the lattice):
//
//     h  = bf16(tanh(ax[b,t] + ay[b,u]) * sigmoid(gx[b,t] + gy[b,u]))   (H,)
//     z  = h . bf16(W2) + b2                  (bf16 operands, f32 sums)   (V,)
//     dz = d_lse * exp(min(z - lse, 40)) + [v = 0] d_zb + [v = label] d_zy
//     K3: dW2 = sum over rows of h^T bf16(dz),  db2 = sum over rows of dz
//     K2: dh  = bf16(dz) . bf16(W2)^T         (f32 sums over all of V)
//         th = tanh(ax + ay), ga = sigmoid(gx + gy) in f32,
//         d_ax[b,t] = sum over u of dh ga (1 - th^2),
//         d_gx[b,t] = sum over u of dh th ga (1 - ga), d_ay, d_gy over t
//
// (the blank and the label are the same column where label = 0: both terms
// land on it).  The TPU kernel keeps dh in a bf16 VMEM scratch rounded
// after every V tile; here dh stays in f32 registers across all of V.
//
// What bounds it on the H100: three (R x H) x (H x V) sized products -- z,
// dW2 and dh -- 2*R*H*V flops each on the bf16 tensor cores (4.03 TFLOP,
// 4.07 ms at 989 TFLOP/s each, at R = 32*239*41 rows, H = 1024, V = 6268).
// The TPU kernels each recompute z; here z is formed once per backward and
// dz materialized in bf16, in chunks of whole t-tiles (joint_gemm.cuh) of
// about 512 MB of scratch (the lattice is never written whole).  Each chunk
// runs, in stream order:
//
//   h kernel   (joint_gemm.cuh) the chunk's h rows into a (rows, Hp) bf16
//              scratch, read by the z and dW2 products;
//   dz kernel  z = h_c . W2 (A = h_c, B = W2^T, both K-major), the dz formula
//              as the epilogue: bf16 dz into a (rows, Vp) scratch and, for
//              K3, each block's f32 column sums of dz (db2 partials, summed
//              by the caller);
//   dw kernel  (K3) dW2 += h_c^T . dz_c, both operands MN-major (the lattice
//              rows are the contraction); a plain store on the first chunk,
//              an add after;
//   dh kernel  (K2) dh = dz_c . W2 (A = dz_c, B = W2 as (Hp, Vp), both
//              K-major) over a tile of 16 t x 8 u cells and 128 columns of
//              H, the derivatives as the epilogue; writes per-tile partials
//              of d_ax, d_gx (summed over the tile's u) and d_ay, d_gy (over
//              its t), summed by the caller.
//
// Every block owns its output within a launch and the chunks run in order:
// no atomics, reruns are bit-identical.  W2's bf16 copies are zero-padded,
// dz's padded columns are forced to 0, rows past a chunk read zeros; the
// dh tile's cells past T (the next utterance's rows) or past U1 are masked
// in its epilogue.
#include "joint_gemm.cuh"

namespace {

constexpr int kDwCols = 256;          // output columns of a dw block (a dz or dh block: kTile)
constexpr int kRedStride = kTile + 4;  // a row of the dh epilogue's sums, padded against bank conflicts
constexpr int kPartK2 = 1, kPartK3 = 2;

// dz for a 128-row x 128-column tile of the chunk (rows m0.., columns n0..):
// th maps the chunk's h (rows, Hp), tw maps W2^T (Vp, Hp); both K-major.
// lse, d_lse, d_zb, d_zy and labels are the whole lattice's; row0 is the
// chunk's first lattice row.  db2_p: this chunk's (row tiles, Vp) partials,
// or null (none are written).
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
    if (db2_p == nullptr) return;
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
    if (threadIdx.x == 0)
      produce<BN>(smem, full, empty, n_k,
                  [ta = &th, tb = &tdz, m0, n0](unsigned char* st, uint64_t* bar, int k0) {
                    load_stage<1, BN>(st, bar, ta, tb, k0, m0, n0);
                  });
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

// K2's product and epilogue for one tile of 16 frames x 8 labels (t-tile g,
// label tile ui: blockIdx.y = (g - g0) * nu + ui) and 128 columns of H
// (n0 = blockIdx.x * 128).  tdz maps the chunk's dz as (n_bt, U1, Vp) with
// 64 x 8 x 16 boxes, so a stage's A is the tile's 128 rows, t-major, in the
// layout of two 64-row boxes; tw maps W2 (Hp, Vp).  g0, bt0: the chunk's
// first t-tile and (b, t) row.  dax_p, dgx_p: (B, T, nu, H); day_p, dgy_p:
// (B, nt, U1, H).
__global__ void __launch_bounds__(kThreads, 1)
dh_kernel(const __grid_constant__ CUtensorMap tdz, const __grid_constant__ CUtensorMap tw,
          const float* __restrict__ ax, const float* __restrict__ gx,
          const float* __restrict__ ay, const float* __restrict__ gy,
          float* __restrict__ dax_p, float* __restrict__ dgx_p, float* __restrict__ day_p,
          float* __restrict__ dgy_p, long long g0, long long bt0, int T, int U1, int H, int Vp,
          int nt, int nu) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  using L = Smem<kTile>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kTile;
  const long long g = g0 + blockIdx.y / nu;
  const int ui = blockIdx.y % nu, b = (int)(g / nt), ti = (int)(g % nt);
  const int t0 = ti * kTileT, u0 = ui * kTileU;
  const int lbt = (int)((long long)b * T + t0 - bt0);  // the tile's first (b, t) row in the chunk
  const int n_k = Vp / kDepth;
  init_ring(full, empty);
  const int wg_idx = hopper::warpgroup();

  if (wg_idx == 0) {  // producer
    hopper::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0)
      produce<kTile>(smem, full, empty, n_k, [ta = &tdz, tb = &tw, u0, lbt, n0](
                                                     unsigned char* st, uint64_t* bar, int k0) {
        hopper::tma_load_3d(st, ta, bar, k0, u0, lbt);  // 16 frames x 8 labels, t-major
        load_b<0, kTile>(st, bar, tb, k0, n0);
      });
  } else {  // consumers
    hopper::regs_alloc<kConsumerRegs>();
    const int wg = wg_idx - 1, tid = threadIdx.x & 127, lane = tid & 31, q = lane & 3;
    const int w8 = wg * 4 + (tid >> 5);  // this warp among the 8 consumer warps
    float acc[kTile / 2];
    consume<0, kTile>(acc, smem, full, empty, n_k, wg);

    // this thread's cells: frames tr and tr + 1 (rows lo, lo + 8 of the
    // warp's 16), label u
    const int u = u0 + (lane >> 2), tr = t0 + 2 * w8;
    const bool u_ok = u < U1;
    bool t_ok[2];
    const float *axr[2], *gxr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      t_ok[r] = tr + r < T;
      const long long bt = (long long)b * T + (t_ok[r] ? tr + r : 0);
      axr[r] = ax + bt * H;
      gxr[r] = gx + bt * H;
    }
    const long long bu = (long long)b * U1 + (u_ok ? u : 0);
    const float *ayr = ay + bu * H, *gyr = gy + bu * H;

    // Both warpgroups' products are done once they meet here: the ring then
    // holds each warp's sums over its 2 frames, [d_ay, d_gy][warp][label][column].
    float* red = reinterpret_cast<float*>(smem);
    hopper::bar_sync(1, 2 * 128);
#pragma unroll
    for (int gi = 0; gi < kTile / 8; ++gi) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * gi + 2 * q + e, col = n0 + cl;
        const bool c_ok = col < H;
        const float ya = u_ok && c_ok ? ayr[col] : 0.f;
        const float yg = u_ok && c_ok ? gyr[col] : 0.f;
        float sp = 0.f, sg = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float dp = 0.f, dg = 0.f;
          if (u_ok && t_ok[r] && c_ok) {
            const float th = tanhf(axr[r][col] + ya);
            const float ga = 1.f / (1.f + expf(-(gxr[r][col] + yg)));
            const float dh = acc[4 * gi + 2 * r + e];
            dp = dh * ga * (1.f - th * th);
            dg = dh * th * ga * (1.f - ga);
          }
          sp += dp;
          sg += dg;
          // d_ax, d_gx: the sum over the frame's 8 labels (lanes of one lane % 4)
#pragma unroll
          for (int m = 4; m < 32; m *= 2) {
            dp += __shfl_xor_sync(0xffffffffu, dp, m);
            dg += __shfl_xor_sync(0xffffffffu, dg, m);
          }
          if (lane < 4 && t_ok[r] && c_ok) {
            const size_t o = (((size_t)b * T + tr + r) * nu + ui) * H + col;
            dax_p[o] = dp;
            dgx_p[o] = dg;
          }
        }
        red[((0 * 8 + w8) * kTileU + (lane >> 2)) * kRedStride + cl] = sp;
        red[((1 * 8 + w8) * kTileU + (lane >> 2)) * kRedStride + cl] = sg;
      }
    }
    hopper::bar_sync(1, 2 * 128);
    // d_ay, d_gy: the sum over the tile's 16 frames, the 8 warps' sums in a
    // fixed order
    for (int i = tid + wg * 128; i < 2 * kTileU * kTile; i += 2 * 128) {
      const int which = i / (kTileU * kTile), uu = i / kTile % kTileU, cl = i % kTile;
      if (u0 + uu >= U1 || n0 + cl >= H) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[((which * 8 + w) * kTileU + uu) * kRedStride + cl];
      (which ? dgy_p : day_p)[(((size_t)b * nt + ti) * U1 + u0 + uu) * H + n0 + cl] = s;
    }
  }
}

static_assert(2 * 8 * kTileU * kRedStride * 4 <= kStages * Smem<kTile>::stage,
              "the dh epilogue's sums fit in the ring");

}  // namespace

// Plain C interface, loaded with ctypes.  Launches every chunk's kernels on
// `stream` in order and returns the first CUDA error (0 on success).
// parts: 1 = K2 (d_ax, d_gx, d_ay, d_gy), 2 = K3 (d_w2, d_b2), 3 = both from
// one z.  ax, gx: (B, T, H) f32; ay, gy: (B, U1, H) f32; w2t: (Vp, Hp) bf16,
// W2 transposed and zero-padded; w2p: (Hp, Vp) bf16, W2 zero-padded (K2
// only, else null); b2p: (Vp,) f32, b2 padded with 0; labels: (B, U1) int32
// in [0, V); lse, d_lse, d_zb, d_zy: (B, T, U1) f32.  The schedule: chunks
// of `tiles` t-tiles of 16 frames (joint_gemm.cuh).  Scratch: h_buf (rows,
// Hp) and dz_buf (rows, Vp) bf16 for the largest chunk's rows.  Out (K3, else
// null): dw2 (Hp, Vp) f32; db2_p (sum over chunks of ceil(rows / 128), Vp)
// f32, per-row-tile partials of d_b2.  Out (K2, else null): dax_p, dgx_p
// (B, T, ceil(U1 / 8), H) and day_p, dgy_p (B, ceil(T / 16), U1, H) f32,
// per-tile partials.  Hp, Vp: H, V rounded up to 64.  Every pointer
// 16-byte aligned.
extern "C" int pika_joint_channels_bwd(int device, void* stream, const float* ax,
                                       const float* gx, const float* ay, const float* gy,
                                       const void* w2t, const void* w2p, const float* b2p,
                                       const int* labels, const float* lse, const float* d_lse,
                                       const float* d_zb, const float* d_zy, void* h_buf,
                                       void* dz_buf, float* dw2, float* db2_p, float* dax_p,
                                       float* dgx_p, float* day_p, float* dgy_p, int B, int T,
                                       int U1, int H, int V, int tiles, int parts) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid_schedule(B, T, U1, H, V, tiles) || parts < 1 || parts > 3)
    return cudaErrorInvalidValue;
  const bool k2 = parts & kPartK2, k3 = parts & kPartK3;
  const int Hp = (H + 63) / 64 * 64, Vp = (V + 63) / 64 * 64;
  const int nt = (T + kTileT - 1) / kTileT, nu = (U1 + kTileU - 1) / kTileU;
  if ((Hp + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr uint32_t smem = Smem<kTile>::bytes, dw_smem = Smem<kDwCols>::bytes;
  if ((err = allow_smem(dz_kernel, smem)) != cudaSuccess ||
      (err = allow_smem(dw_kernel<kDwCols>, dw_smem)) != cudaSuccess ||
      (err = allow_smem(dh_kernel, smem)) != cudaSuccess)
    return err;
  CUtensorMap tw, tw2;
  if (!matrix_map(&tw, w2t, Vp, Hp) || (k2 && !matrix_map(&tw2, w2p, Hp, Vp)))
    return cudaErrorInvalidValue;
  auto* hb = static_cast<bf16*>(h_buf);
  auto* dzb = static_cast<bf16*>(dz_buf);
  long long db2_tile = 0;  // the first row tile of this chunk's db2 partials
  return for_each_chunk(B, T, tiles, [&](const Chunk& c) -> cudaError_t {
    const int rows = c.rows(U1);
    const long long row0 = c.row0(U1);
    cudaError_t e = launch_h(s, ax, gx, ay, gy, hb, row0, rows, T, U1, H, Hp);
    if (e != cudaSuccess) return e;
    CUtensorMap th, tdz;
    if (!matrix_map(&th, hb, rows, Hp) || !matrix_map(&tdz, dzb, rows, Vp))
      return cudaErrorInvalidValue;
    const unsigned row_tiles = (unsigned)((rows + kTile - 1) / kTile);
    const unsigned v_tiles = (unsigned)((Vp + kTile - 1) / kTile);
    dz_kernel<<<dim3(v_tiles, row_tiles), kThreads, smem, s>>>(
        th, tw, b2p, labels, lse, d_lse, d_zb, d_zy, dzb,
        k3 ? db2_p + (size_t)db2_tile * Vp : nullptr, row0, rows, T, U1, Hp, V, Vp);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    db2_tile += row_tiles;
    if (k3) {
      const dim3 grid((unsigned)((Vp + kDwCols - 1) / kDwCols), (unsigned)((Hp + kTile - 1) / kTile));
      dw_kernel<kDwCols><<<grid, kThreads, dw_smem, s>>>(th, tdz, dw2, rows, Hp, Vp, c.g0 == 0);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    if (k2) {
      CUtensorMap tdz3;
      const cuuint64_t dims[3] = {(cuuint64_t)Vp, (cuuint64_t)U1, (cuuint64_t)(c.bt1 - c.bt0)};
      const cuuint64_t strides[2] = {(cuuint64_t)Vp * 2, (cuuint64_t)U1 * Vp * 2};
      const cuuint32_t box[3] = {64, kTileU, kTileT};
      if (!hopper::bf16_map(&tdz3, dzb, 3, dims, strides, box)) return cudaErrorInvalidValue;
      const dim3 grid((unsigned)((Hp + kTile - 1) / kTile), (unsigned)((c.g1 - c.g0) * nu));
      dh_kernel<<<grid, kThreads, smem, s>>>(tdz3, tw2, ax, gx, ay, gy, dax_p, dgx_p, day_p,
                                             dgy_p, c.g0, c.bt0, T, U1, H, Vp, nt, nu);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
}
