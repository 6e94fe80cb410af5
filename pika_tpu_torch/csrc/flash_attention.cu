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
// than the card moves in that time at T ~ 1000.  What the design does:
//   * One block of 4 warps owns a 64-row tile of queries (forward, dq) or
//     of keys (dk/dv) and loops over the other axis itself: the TPU grid's
//     sequential ("arbitrary") axis becomes this loop, because CUDA blocks
//     run in no order.  Each warp owns 16 rows, so the online softmax's row
//     max and row sum stay inside a quad of lanes (two shuffles).  Nothing
//     crosses blocks: no atomics, deterministic results.
//   * Products are mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Operand
//     tiles sit in shared memory with rows padded by 16 bytes, so the
//     ldmatrix loads (with .trans where the operand is needed transposed)
//     are free of bank conflicts; the f32 accumulator of s becomes the bf16
//     A operand of the next product in registers, never touching memory.
//   * Keys and queries at or past T are zero-filled in shared memory and
//     masked in registers: this stands in for the segment ids with which
//     _flash pads T to the TPU block multiple.  Any T >= 1; D = 64 or 128.
//   * The dk/dv block's loop runs over 64 queries at D = 64 and 32 at
//     D = 128, which keeps its two D-wide accumulators within the registers.
// TMA, wgmma and a fused single-pass backward are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows a block owns: 16 per warp
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + R) of a (T, D) bf16 matrix into a shared tile of
// row stride D + 8, zero-filling rows at or past T.  16-byte loads.
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int T) {
  constexpr int kChunks = D / 8;
  constexpr int kStride = D + 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) = val;
  }
}

// The A operand (16 x 16, row-major) at rows row0.., columns col0.. of a
// shared tile of row stride `stride`.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int stride, int row0,
                                       int col0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (row0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * stride + col0 +
                     (lane >> 4) * 8);
}

// B operands of two n8 tiles (n = rows n0..n0+15 of the tile, k = columns
// k0..k0+15): b[0], b[1] for rows n0..n0+7, b[2], b[3] for n0+8..n0+15.
// The product then contracts over the tile's columns (s = q k^T).
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile, int stride, int n0,
                                            int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * stride + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B operands of two n8 tiles (k = rows k0..k0+15 of the tile, n = columns
// n0..n0+15): b[0], b[1] for columns n0..n0+7, b[2], b[3] for n0+8..n0+15.
// The product then contracts over the tile's rows (o = p v).
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile, int stride, int k0,
                                            int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * stride + n0 +
                           (lane >> 4) * 8);
}

// acc[N/8] (16 x N, f32) = A[16 rows at a_row0 of `a`] . B^T over D columns,
// B's rows being rows 0..N-1 of `b`.
template <int D, int N>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[N / 8][4], const bf16* a, int a_row0,
                                              const bf16* b) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t af[4];
    load_a(af, a, kStride, a_row0, kk);
#pragma unroll
    for (int nn = 0; nn < N; nn += 16) {
      uint32_t bf[4];
      load_b_rows(bf, b, kStride, nn, kk);
      mma_16816(acc[nn / 8], af, bf[0], bf[1]);
      mma_16816(acc[nn / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D/8] (16 x D, f32) += P . B, with P (16 x N) given as f32 accumulator
// fragments (rounded to bf16 here) and B rows 0..N-1 of `b` (N x D).
template <int D, int N>
__device__ __forceinline__ void probs_dot_tile(float (&acc)[D / 8][4], const float (&p)[N / 8][4],
                                               const bf16* b) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bf[4];
      load_b_cols(bf, b, kStride, kk * 16, dn * 16);
      mma_16816(acc[2 * dn], pa, bf[0], bf[1]);
      mma_16816(acc[2 * dn + 1], pa, bf[2], bf[3]);
    }
  }
}

// Write a warp's 16 x D f32 fragments as bf16 rows row0 + g (times scale_lo)
// and row0 + g + 8 (times scale_hi) of a (T, D) matrix, g = lane / 4; rows
// at or past T are skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int row0,
                                           int T, float scale_lo, float scale_hi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + tig * 2;
    if (r_lo < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_lo * D + col) =
          pack_bf16(acc[j][0] * scale_lo, acc[j][1] * scale_lo);
    if (r_hi < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_hi * D + col) =
          pack_bf16(acc[j][2] * scale_hi, acc[j][3] * scale_hi);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int T) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kStride]
  bf16* ks = qs + kRows * kStride;
  bf16* vs = ks + kRows * kStride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const size_t base = (size_t)blockIdx.y * T * D;
  load_tile<D, kRows>(qs, q + base, q0, T);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // this lane's share of their running sums

  for (int k0 = 0; k0 < T; k0 += kRows) {
    __syncthreads();  // the last tile's readers are done (and qs is loaded)
    load_tile<D, kRows>(ks, k + base, k0, T);
    load_tile<D, kRows>(vs, v + base, k0, T);
    __syncthreads();

    float s[kRows / 8][4];
    rows_dot_rows<D, kRows>(s, qs, warp * 16, ks);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + j * 8 + tig * 2 + (e & 1) >= T) s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - m[e >> 1]) * kLog2e);
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    probs_dot_tile<D, kRows>(acc, s, vs);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + warp * 16;
  store_rows<D>(o + base, acc, row0, T, 1.f / l[0], 1.f / l[1]);
  if (tig == 0) {
    const int g = lane >> 2;
    if (row0 + g < T) lse[(size_t)blockIdx.y * T + row0 + g] = m[0] + logf(l[0]);
    if (row0 + g + 8 < T) lse[(size_t)blockIdx.y * T + row0 + g + 8] = m[1] + logf(l[1]);
  }
}

// dq: a block owns 64 queries and walks all keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    bf16* __restrict__ dq, int T) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kStride]
  bf16* dos = qs + kRows * kStride;
  bf16* ks = dos + kRows * kStride;
  bf16* vs = ks + kRows * kStride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const size_t base = (size_t)blockIdx.y * T * D;
  load_tile<D, kRows>(qs, q + base, q0, T);
  load_tile<D, kRows>(dos, dout + base, q0, T);
  const int row0 = q0 + warp * 16;
  float row_lse[2], row_di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    row_lse[r] = row < T ? lse[(size_t)blockIdx.y * T + row] : 0.f;
    row_di[r] = row < T ? di[(size_t)blockIdx.y * T + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kRows) {
    __syncthreads();
    load_tile<D, kRows>(ks, k + base, k0, T);
    load_tile<D, kRows>(vs, v + base, k0, T);
    __syncthreads();

    float s[kRows / 8][4], dp[kRows / 8][4];
    rows_dot_rows<D, kRows>(s, qs, warp * 16, ks);
    rows_dot_rows<D, kRows>(dp, dos, warp * 16, vs);
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + j * 8 + tig * 2 + (e & 1) < T;
        const float p = valid ? exp2f((s[j][e] - row_lse[e >> 1]) * kLog2e) : 0.f;
        s[j][e] = p * (dp[j][e] - row_di[e >> 1]);  // ds
      }
    }
    probs_dot_tile<D, kRows>(acc, s, ks);
  }
  store_rows<D>(dq + base, acc, row0, T, 1.f, 1.f);
}

// dk, dv: a block owns 64 keys and walks all queries, kN at a time.
template <int D, int kN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kStride]
  bf16* vs = ks + kRows * kStride;
  bf16* qs = vs + kRows * kStride;  // [kN][kStride]
  bf16* dos = qs + kN * kStride;
  float* lse_s = reinterpret_cast<float*>(dos + kN * kStride);  // [kN]
  float* di_s = lse_s + kN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  const int k0 = blockIdx.x * kRows;
  const size_t base = (size_t)blockIdx.y * T * D;
  load_tile<D, kRows>(ks, k + base, k0, T);
  load_tile<D, kRows>(vs, v + base, k0, T);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int q0 = 0; q0 < T; q0 += kN) {
    __syncthreads();
    load_tile<D, kN>(qs, q + base, q0, T);
    load_tile<D, kN>(dos, dout + base, q0, T);
    for (int i = threadIdx.x; i < kN; i += kThreads) {
      const bool valid = q0 + i < T;
      lse_s[i] = valid ? lse[(size_t)blockIdx.y * T + q0 + i] : 0.f;
      di_s[i] = valid ? di[(size_t)blockIdx.y * T + q0 + i] : 0.f;
    }
    __syncthreads();

    // p^T (this warp's 16 keys x kN queries), then dv += p^T do
    float p[kN / 8][4];
    rows_dot_rows<D, kN>(p, ks, warp * 16, qs);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tig * 2 + (e & 1);
        p[j][e] = q0 + col < T ? exp2f((p[j][e] - lse_s[col]) * kLog2e) : 0.f;
      }
    }
    probs_dot_tile<D, kN>(dv_acc, p, dos);

    // ds^T = p^T * (v do^T - di), then dk += ds^T q
    float dp[kN / 8][4];
    rows_dot_rows<D, kN>(dp, vs, warp * 16, dos);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - di_s[j * 8 + tig * 2 + (e & 1)]);
    }
    probs_dot_tile<D, kN>(dk_acc, dp, qs);
  }
  const int row0 = k0 + warp * 16;
  store_rows<D>(dk + base, dk_acc, row0, T, 1.f, 1.f);
  store_rows<D>(dv + base, dv_acc, row0, T, 1.f, 1.f);
}

constexpr size_t tile_bytes(int D, int rows) { return (size_t)rows * (D + 8) * sizeof(bf16); }

// Shared memory above 48 KB is dynamic only, after this opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int BH, int T, int D) {
  return BH <= 0 || BH > 65535 || T <= 0 || (D != 64 && D != 128);
}

dim3 grid_of(int BH, int T) { return dim3((unsigned)((T + kRows - 1) / kRows), (unsigned)BH); }

template <int D>
cudaError_t fwd(cudaStream_t s, const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                int BH, int T) {
  const size_t smem = 3 * tile_bytes(D, kRows);
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<grid_of(BH, T), kThreads, smem, s>>>(q, k, v, o, lse, T);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(cudaStream_t s, const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* di, bf16* dq, int BH, int T) {
  const size_t smem = 4 * tile_bytes(D, kRows);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<grid_of(BH, T), kThreads, smem, s>>>(q, k, v, dout, lse, di, dq, T);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(cudaStream_t s, const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* lse, const float* di, bf16* dk, bf16* dv,
                    int BH, int T) {
  constexpr int kN = D == 128 ? 32 : 64;
  const size_t smem = 2 * tile_bytes(D, kRows) + 2 * tile_bytes(D, kN) + 2 * kN * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, kN>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, kN><<<grid_of(BH, T), kThreads, smem, s>>>(q, k, v, dout, lse, di, dk,
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
