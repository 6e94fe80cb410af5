// The RNN-T loss DP over the full (T, U+1) lattice: the forward variables
// alpha with the per-utterance loss, and the backward variables beta with
// the channel cotangents, one launch each.
//
// Replaces no Pallas kernel: the JAX package runs this DP as two lax.scan
// loops (pika_tpu/ops/rnnt_loss.py, rnnt_alpha and rnnt_beta) that XLA
// compiles into one program.  Its first PyTorch form, the plain version
// beside the wrappers (ops/rnnt_loss.py: rnnt_alpha, rnnt_occupancy), is a
// Python loop over the T rows that launches a handful of small kernels per
// row: about 6,000 launches a training step at T' = 239, U+1 = 41, with the
// device idle between them.  The original pika ran the same DP in CUDA
// (warp_rnnt).  With blank = 0 and lp = log-probs of the channels:
//
//   alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
//                           alpha[t, u-1] + emit[t, u-1])
//   loss        = -(alpha[tl-1, ul] + blank[tl-1, ul])
//   beta[t, u]  = logaddexp(beta[t+1, u] + blank[t, u], beta[t, u+1] + emit[t, u])
//   d_zb[t, u]  = -g exp(alpha[t, u] + blank[t, u] + beta[t+1, u] - loglike)
//   d_zy[t, u]  = -g exp(alpha[t, u] + emit[t, u] + beta[t, u+1] - loglike)
//   d_lse       = -(d_zb + d_zy)
//
// with beta[t+1, u] := 0 at the exit cell (tl-1, ul), the exponents clamped
// to [NEG, 30], d_zb zero outside u <= ul, d_zy zero outside u < ul, and
// every output zero in rows t >= tl (tl, ul: the utterance's lengths).
//
// What bounds it on the H100: not the bytes (about 5 MB in and out of the
// forward, 10 MB of the backward at B = 32, T = 239, U+1 = 41: a few
// microseconds at 3.35 TB/s) and not the arithmetic (a few exp and log a
// cell), but the chain of tl dependent rows, each a scan over U+1 columns.
// One block per utterance walks its rows; each row is solved in parallel
// over u.  The row recurrence x_u = logaddexp(f_u, x_{u-1} + g_{u-1}) is a
// linear recurrence in the log semiring: each column is the map
// x -> logaddexp(x + a, b), and maps compose associatively,
//   (a1, b1) then (a2, b2) = (a1 + a2, logaddexp(b1 + a2, b2)),
// so a row is a block scan (warp shuffles, then the warp totals through
// shared memory), chunked over rows wider than the block with the running
// value carried between chunks.  This scan is chosen over the plain
// version's closed form G + logcumsumexp(f - G): the closed form subtracts
// and adds back the running emission sum G, which loses the low bits of f
// for long rows, and it needs two scans where the pairs need one.  Sentinels
// are NEG = -1e30, as in the plain version (rows clamped at NEG), so no
// inf - inf appears; the composed a's stay far inside float range.  The
// inputs of the next row are loaded before the current row's scan, so the
// loads do not sit on the chain.
//
// Precision: the sums along the chain are double, the rows kept between
// steps too; only the corrections log1p(exp(d)) (d <= 0, results below
// log 2) and the cotangents' exponentials are float.  Alphas and betas run
// to hundreds or thousands of nats, so float sums lose ulps of that size
// at every step of the chain: a float version of this scan, like the plain
// loops, gives cotangents off by up to 2e-5 at B = 3, T = 20, U+1 = 8 and
// 2e-4 at the training cell's 239 x 41, which K2's cancelling sums over V
// and u turn into 1.7e-4 of d_ax at the smaller shape.  With double sums
// the outputs are the float rounding of nearly exact values: an emulation
// of this kernel on the CPU put its cotangents 6-10x closer to a float64 DP
// than the loops' at both shapes.  The transcendental functions stay float.
//
// The forward writes NEG in alpha's rows t >= tl (never read).  The backward
// keeps beta's rows t+1 and t in shared memory and never writes beta.  Each
// block owns its utterance's outputs: no atomics, reruns are bit-identical.
// Lengths are clamped into the lattice (0 <= ul <= U1 - 1, tl <= T).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kExpMax = 30.0f;
constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 227 * 1024;

// the map x -> logaddexp(x + a, b)
struct Pair {
  double a, b;
};

// the sum in double, the correction (at most log 2) in float
__device__ __forceinline__ double logaddexp(double x, double y) {
  const double m = fmax(x, y);
  return m + (double)log1pf(expf((float)(fmin(x, y) - m)));
}

// -g exp(clamp(x, NEG, 30)): an arc's posterior times the loss's cotangent
__device__ __forceinline__ float cotangent(double x, float g) {
  return -expf((float)fmin(fmax(x, (double)kNeg), (double)kExpMax)) * g;
}

// p, then q
__device__ __forceinline__ Pair compose(Pair p, Pair q) {
  return {p.a + q.a, logaddexp(p.b + q.a, q.b)};
}

__device__ __forceinline__ Pair shfl_up(Pair p, int off) {
  return {__shfl_up_sync(0xffffffffu, p.a, off), __shfl_up_sync(0xffffffffu, p.b, off)};
}

// The recurrence x_i = logaddexp(x_{i-1} + a_i, b_i) over the block's
// elements in thread order, started from `carry` (x before the first
// element): returns this thread's x and sets `carry` to the last element's
// x in every thread.  `totals` holds a Pair per warp, `starts` a double per
// warp and one more; each is written and read between the same two
// barriers, so back-to-back calls need no third one.
__device__ double block_scan(Pair p, double& carry, Pair* totals, double* starts) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const Pair prev = shfl_up(p, off);
    if (lane >= off) p = compose(prev, p);
  }
  if (lane == kWarp - 1) totals[warp] = p;
  __syncthreads();
  if (warp == 0) {
    Pair w = totals[min(lane, nwarps - 1)];  // lanes past nwarps only follow
    for (int off = 1; off < nwarps; off <<= 1) {
      const Pair prev = shfl_up(w, off);
      if (lane >= off) w = compose(prev, w);
    }
    if (lane < nwarps) starts[lane + 1] = logaddexp(carry + w.a, w.b);
    if (lane == 0) starts[0] = carry;
  }
  __syncthreads();
  carry = starts[nwarps];
  return logaddexp(starts[warp] + p.a, p.b);
}

__device__ __forceinline__ void lengths(const int* t_len, const int* u_len, int T, int U1,
                                        int& tl, int& ul) {
  tl = min(t_len[blockIdx.x], T);
  ul = min(max(u_len[blockIdx.x], 0), U1 - 1);
}

// One block per utterance; blockDim.x threads (a multiple of 32) take a
// chunk of blockDim.x columns at a time.  Dynamic shared memory: the
// previous alpha row (U1 doubles), each thread reading back what it wrote.
__global__ void __launch_bounds__(kMaxThreads)
    dp_forward_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                      const int* __restrict__ t_len, const int* __restrict__ u_len,
                      float* __restrict__ alpha, float* __restrict__ loss, int T, int U1) {
  extern __shared__ double prev_row[];
  __shared__ Pair totals[kWarp];
  __shared__ double starts[kWarp + 1];
  int tl, ul;
  lengths(t_len, u_len, T, U1, tl, ul);
  const size_t base = (size_t)blockIdx.x * T * U1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* al = alpha + base;
  const int nt = blockDim.x, chunks = (U1 + nt - 1) / nt;
  const int steps = max(tl, 0) * chunks;

  // inputs of step k (row t, chunk c): blank[t-1, u] and emit[t, u-1]
  auto load = [&](int k, float& b_prev, float& e_prev) {
    const int t = k / chunks, u = (k - t * chunks) * nt + threadIdx.x;
    b_prev = (t > 0 && u <= ul) ? bl[(size_t)(t - 1) * U1 + u] : 0.0f;
    e_prev = (u > 0 && u <= ul) ? em[(size_t)t * U1 + u - 1] : kNeg;
  };
  float b_next = 0.0f, e_next = kNeg;
  double carry = kNeg;
  if (steps > 0) load(0, b_next, e_next);
  for (int k = 0; k < steps; ++k) {
    const int t = k / chunks, c = k - t * chunks, u = c * nt + threadIdx.x;
    const float b_prev = b_next, e_prev = e_next;
    if (k + 1 < steps) load(k + 1, b_next, e_next);
    if (c == 0) carry = kNeg;
    Pair p{kNeg, kNeg};  // columns past ul: cut
    if (u <= ul) p = {e_prev, t > 0 ? prev_row[u] + b_prev : (u == 0 ? 0.0 : kNeg)};
    const double x = block_scan(p, carry, totals, starts);
    if (u < U1) {
      const double a = u <= ul ? fmax(x, (double)kNeg) : kNeg;
      prev_row[u] = a;
      al[(size_t)t * U1 + u] = (float)a;
      if (t == tl - 1 && u == ul) loss[blockIdx.x] = (float)-(a + bl[(size_t)t * U1 + u]);
    }
  }
  if (tl <= 0 && threadIdx.x == 0) loss[blockIdx.x] = 0.0f;
  for (size_t i = (size_t)max(tl, 0) * U1 + threadIdx.x; i < (size_t)T * U1; i += nt) al[i] = kNeg;
}

// One block per utterance, rows from tl - 1 down to 0; thread i takes column
// U1 - 1 - (c * blockDim.x + i) of chunk c, so the scan runs right to left.
// Dynamic shared memory: beta rows t+1 and t (alternating) and, per column,
// alpha + emit (doubles) and the finished d_zb (floats), kept for the
// second pass of the row.
__global__ void __launch_bounds__(kMaxThreads)
    dp_backward_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                       const float* __restrict__ alpha, const float* __restrict__ loss,
                       const float* __restrict__ g_loss, const int* __restrict__ t_len,
                       const int* __restrict__ u_len, float* __restrict__ d_zb,
                       float* __restrict__ d_zy, float* __restrict__ d_lse, int T, int U1) {
  extern __shared__ double smem[];
  double* beta_rows = smem;                           // 2 x U1
  double* ae_keep = smem + 2 * U1;                    // U1
  float* zb_keep = reinterpret_cast<float*>(smem + 3 * U1);  // U1
  __shared__ Pair totals[kWarp];
  __shared__ double starts[kWarp + 1];
  int tl, ul;
  lengths(t_len, u_len, T, U1, tl, ul);
  const size_t base = (size_t)blockIdx.x * T * U1;
  const float* bl = blank + base;
  const float* em = emit + base;
  const float* al = alpha + base;
  float* out_b = d_zb + base;
  float* out_y = d_zy + base;
  float* out_l = d_lse + base;
  const double loglike = -(double)loss[blockIdx.x];
  const float g = g_loss[blockIdx.x];
  const int nt = blockDim.x, chunks = (U1 + nt - 1) / nt;
  const int steps = max(tl, 0) * chunks;

  struct In {
    float b, e, a;
  };
  auto load = [&](int k) {
    const int t = tl - 1 - k / chunks, u = U1 - 1 - ((k % chunks) * nt + (int)threadIdx.x);
    if (u < 0 || u > ul) return In{0.0f, 0.0f, 0.0f};
    const size_t i = (size_t)t * U1 + u;
    return In{bl[i], em[i], al[i]};
  };
  In next = steps > 0 ? load(0) : In{0.0f, 0.0f, 0.0f};
  double carry = kNeg;
  for (int k = 0; k < steps; ++k) {
    const int t = tl - 1 - k / chunks, c = k % chunks;
    const int u = U1 - 1 - (c * nt + (int)threadIdx.x);
    const In in = next;
    if (k + 1 < steps) next = load(k + 1);
    if (c == 0) carry = kNeg;
    double* row = beta_rows + (t & 1) * U1;                   // beta row t
    const double* row_next = beta_rows + ((t + 1) & 1) * U1;  // beta row t+1
    Pair p{kNeg, kNeg};  // columns past ul: cut
    if (u >= 0 && u <= ul) {
      const double bn = t == tl - 1 ? (u == ul ? 0.0 : kNeg) : row_next[u];
      p = {u < ul ? in.e : kNeg, fmax(in.b + bn, (double)kNeg)};
      zb_keep[u] = cotangent((double)in.a + in.b + bn - loglike, g);
      ae_keep[u] = (double)in.a + in.e;
    }
    const double x = block_scan(p, carry, totals, starts);
    if (u >= 0) row[u] = u <= ul ? fmax(x, (double)kNeg) : kNeg;
    if (c < chunks - 1) continue;
    // the row's beta is whole: its cotangents, each thread on its own columns
    __syncthreads();
    for (int cc = 0; cc < chunks; ++cc) {
      const int v = U1 - 1 - (cc * nt + (int)threadIdx.x);
      if (v < 0) continue;
      float zb = 0.0f, zy = 0.0f;
      if (v <= ul) zb = zb_keep[v];
      if (v < ul) zy = cotangent(ae_keep[v] + row[v + 1] - loglike, g);
      const size_t i = (size_t)t * U1 + v;
      out_b[i] = zb;
      out_y[i] = zy;
      out_l[i] = -(zb + zy);
    }
  }
  for (size_t i = (size_t)max(tl, 0) * U1 + threadIdx.x; i < (size_t)T * U1; i += nt) {
    out_b[i] = 0.0f;
    out_y[i] = 0.0f;
    out_l[i] = 0.0f;
  }
}

int block_threads(int U1) { return min((U1 + kWarp - 1) / kWarp * kWarp, kMaxThreads); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int B, int T, int U1) { return B < 1 || T < 1 || U1 < 1; }

}  // namespace

// Plain C interface, loaded with ctypes.  Each launches on `stream` and
// returns cudaGetLastError() after the launch (0 on success); nothing is
// allocated.  Arrays are contiguous: f32 (B, T, U1) lattices, f32 and int32
// (B,) per utterance.  U1 is at most about 8,300 (the backward's shared
// rows), B at most 2^31 - 1.
extern "C" int pika_rnnt_dp_forward(int device, void* stream, const float* blank,
                                    const float* emit, const int* t_len, const int* u_len,
                                    float* alpha, float* loss, int B, int T, int U1) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_shape(B, T, U1)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)U1 * sizeof(double);
  if ((err = allow_smem(dp_forward_kernel, smem)) != cudaSuccess) return err;
  dp_forward_kernel<<<B, block_threads(U1), smem, static_cast<cudaStream_t>(stream)>>>(
      blank, emit, t_len, u_len, alpha, loss, T, U1);
  return cudaGetLastError();
}

extern "C" int pika_rnnt_dp_backward(int device, void* stream, const float* blank,
                                     const float* emit, const float* alpha, const float* loss,
                                     const float* g_loss, const int* t_len, const int* u_len,
                                     float* d_zb, float* d_zy, float* d_lse, int B, int T,
                                     int U1) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_shape(B, T, U1)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)U1 * (3 * sizeof(double) + sizeof(float));
  if ((err = allow_smem(dp_backward_kernel, smem)) != cudaSuccess) return err;
  dp_backward_kernel<<<B, block_threads(U1), smem, static_cast<cudaStream_t>(stream)>>>(
      blank, emit, alpha, loss, g_loss, t_len, u_len, d_zb, d_zy, d_lse, T, U1);
  return cudaGetLastError();
}
