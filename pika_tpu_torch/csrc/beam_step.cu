// The plain beam search's bookkeeping, one loop step in four launches: the
// selection in two (a block a beam row, then a block an utterance), the
// state's update before the prediction net in one, and the commit of the
// net's outputs after it in one.
//
// Replaces no Pallas kernel: the JAX package's beam step
// (pika_tpu/decode/beam.py, the loop's body) is part of one XLA program.
// The port's first form of it, the plain version (decode/beam.py:
// BeamLoop.torch_body, which the CPU and the FST-fusion searches still run),
// issues about 145 small kernels a step for the bookkeeping alone: the masks,
// two stable whole-axis sorts (the top-K of K * V candidates is a cub radix
// sort of 50,144 keys a row at K 8, V 6268), the gathers by beam, the
// commit's `where`s.  Inside a CUDA graph each costs a few microseconds of
// device time and its share of the host's launch of the graph.
//
// What bounds it on the H100: not the bytes (at B 8, K 8, V 6268, H 1024 the
// bf16 logits are 0.8 MB, the state the update rewrites about 1.2 MB) and not
// the arithmetic, but the chain of dependent steps: a row's max, then its
// sum, then K rounds of selection, then the merge of the rows of an
// utterance, then the gathers.  So each step is a block-wide reduction, and
// the design keeps the chain short:
//
// 1. Rows (beam_rows_kernel, a block per (utterance, beam)): the loop's
//    condition (block 0 only, from the state before the step), the
//    duplicate-prefix pruning (equal hash and length, then equal token
//    buffers, against the earlier beams), the float32 log-softmax at
//    sm_scale, the masks (full beams take only blank; a beam at its last
//    frame takes no blank), the finished candidate (blank at the last
//    frame), and the row's own top-K: each thread keeps its own first K
//    candidates sorted in registers (built in one pass), each warp takes
//    its first K from its lanes' lists in K rounds of shuffles, and warp 0
//    merges the warps' lists in K more; one barrier in all.  Candidates are
//    64-bit keys (below), compared as integers.  Nothing of the (B, K, V)
//    candidates is written to device memory.  This is chosen over a
//    block-wide argmax a round whose winner scans its tokens again: at the
//    flagship's shape that took 28 us a launch with the candidates in
//    shared memory (35 us reading the logits again), this 13-14 us.
// 2. Merge (beam_merge_kernel, a block an utterance): warp 0 merges the K
//    sorted row lists (K rounds of shuffles); the N + K finished candidates
//    are ranked by counting the entries that come before each; the new
//    scores, lengths, alignment lengths, hashes, time pointers and the
//    finished store's scalars written in place (every old value read into
//    shared memory first), and the step's picks (beam, token, the token's
//    and the alignment step's positions, the finished picks) for the update.
// 3. Update (beam_update_kernel, a block a slice of one buffer of one
//    utterance): the token buffers, alignments, both joint factors of the
//    prediction net (and the LSTM state) gathered by beam in place, a
//    slice's rows staged through shared memory in one round, the token and
//    the alignment step written, the finished store's buffers merged from
//    the old ones and the old live beams; the next joint's encoder factors
//    gathered by the new time pointers.
// 4. Commit (beam_commit_kernel): the net's outputs where the beam emitted.
//
// Every selection follows jax.lax.top_k's order: the larger value first,
// the lower flat index first among equal values (every dead beam sits at
// NEG, where NEG + lp == NEG in float32); a NaN comes before every number,
// as torch.sort(descending) puts it.  Every write of the state is skipped
// once the device flag `running` is false, so the steps after the search's
// end are no-ops, as the plain version's commit makes them.  The log-softmax
// is float32 with its products and sums rounded as written (no contraction),
// so a graph's replay and an eager step give the same bits; against the
// plain version's (another order of summation) scores differ in the last
// bits.  Every reduction has a fixed order: no atomics, reruns are
// bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1.0e20f;
constexpr int kWarp = 32;
constexpr int kMaxBeam = 32;
constexpr int kMaxBest = 32;
constexpr int kRowThreads = 512;      // a row's block for K <= 8 (each thread's top-8 in registers)
constexpr int kRowThreadsWide = 256;  // for K <= 32 (its top-32: about 90 registers a thread)
constexpr int kUpdateThreads = 256;
constexpr int kCommitThreads = 256;
constexpr int kChunkWords = 2048;  // an update block's slice, 8 KB
constexpr int kMaxLayers = 8;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;
constexpr int kMaxVocab = (kMaxSmem - 4096) / 4;  // 57,088: a row's candidates in shared memory
constexpr long long kHashMult = 1000003;
constexpr long long kHashMask = 0xFFFFFFFFLL;

// the pointers of one search's state and the step's scratch, in the order of
// decode/beam_kernels.py's SLOTS
enum Slot {
  kRunning, kStep, kScores, kTIdx, kLens, kAlignLens, kHashes, kTokens, kAligns,
  kFinScores, kFinLens, kFinAlignLens, kFinTokens, kFinAligns, kEncLens,
  kAxAll, kGxAll, kDecAy, kDecGy, kDecH, kDecC,
  kRowKey, kFinCand, kPrevK, kTok, kPos, kAPos, kFinIdx, kAxSel, kGxSel,
  kLogits, kNewAy, kNewGy, kNewH, kNewC, kSlots
};

// the sizes, in the order of decode/beam_kernels.py's DIMS
enum Dim {
  kB, kK, kN, kV, kUm, kS, kT, kH, kLayers, kBlank, kPrune, kLogitsBf16, kElemBytes, kDims
};

// a launch's arguments, by value: a captured graph keeps them in its node
struct Args {
  void* p[kSlots];
  long long d[kDims];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The selections' order as one 64-bit key, larger first: the value's
// order-preserving bits above, the complement of the index below (so the
// lower index comes first among equal values).  -0 is made +0 and every
// NaN one positive NaN first: equal values tie, and a NaN comes before
// every number, as torch.sort(descending) puts it.
typedef unsigned long long Key;
constexpr Key kAfterAll = 0;  // after every real candidate

__device__ __forceinline__ Key make_key(float v, int i) {
  unsigned u = __float_as_uint(isnan(v) ? __int_as_float(0x7fc00000) : v + 0.0f);
  u = u & 0x80000000u ? ~u : u | 0x80000000u;
  return (Key)u << 32 | (0xFFFFFFFFu - (unsigned)i);
}

__device__ __forceinline__ float key_value(Key k) {
  const unsigned u = (unsigned)(k >> 32);
  return __uint_as_float(u & 0x80000000u ? u & 0x7FFFFFFFu : ~u);
}

__device__ __forceinline__ int key_index(Key k) { return (int)(0xFFFFFFFFu - (unsigned)k); }

__device__ __forceinline__ Key warp_first(Key k) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) k = max(k, __shfl_xor_sync(0xffffffffu, k, off));
  return k;
}

// max and sum over the block, in every thread, in a fixed order (float
// addition commutes, so the butterfly's lanes agree)
__device__ float block_max(float x, float* red) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & (kWarp - 1)) == 0) red[threadIdx.x / kWarp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < (int)blockDim.x / kWarp; ++w) x = fmaxf(x, red[w]);
  __syncthreads();
  return x;
}

__device__ float block_sum(float x, float* red) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & (kWarp - 1)) == 0) red[threadIdx.x / kWarp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < (int)blockDim.x / kWarp; ++w) x = __fadd_rn(x, red[w]);
  __syncthreads();
  return x;
}

// Every kernel reads its pointers and sizes out of the by-value arguments by
// constant index: a runtime index into them makes the compiler copy them all.
#define ARG(type, slot) static_cast<type>(a.p[slot])

// 1. A block per beam row b * K + k.  Writes the row's top-K keys (value,
// flat index k * V + v), in order, to row_key (B, K, K) and its
// finished candidate to fin_cand (B, K); block 0 also folds the loop's
// condition into `running`.  KC >= K: each thread's own top-KC, in registers.
template <typename T, int KC, int kThreads>
__global__ void __launch_bounds__(kThreads)
    beam_rows_kernel(const __grid_constant__ Args a, float sm_scale) {
  __shared__ Key wtop[kThreads / kWarp][KC];
  __shared__ float fred[kThreads / kWarp];
  __shared__ unsigned maybe_dup;
  extern __shared__ float z[];  // V floats
  const int B = (int)a.d[kB], K = (int)a.d[kK], N = (int)a.d[kN], V = (int)a.d[kV];
  const int Um = (int)a.d[kUm], blank = (int)a.d[kBlank];
  const long long max_steps = a.d[kS];
  const bool prune = a.d[kPrune] != 0;
  bool* running = ARG(bool*, kRunning);
  const long long* step = ARG(const long long*, kStep);
  const float* scores = ARG(const float*, kScores);
  const float* fin_scores = ARG(const float*, kFinScores);
  const long long* lens = ARG(const long long*, kLens);
  const long long* hashes = ARG(const long long*, kHashes);
  const long long* tokens = ARG(const long long*, kTokens);
  const long long* t_idx = ARG(const long long*, kTIdx);
  const long long* enc_lens = ARG(const long long*, kEncLens);
  const T* logits = ARG(const T*, kLogits);
  float* fin_cand = ARG(float*, kFinCand);
  Key* row_key = ARG(Key*, kRowKey);
  const int row = blockIdx.x, b = row / K, k = row - b * K, tid = threadIdx.x;

  if (row == 0) {  // running &= step < max_steps and some live beam beats the N-th finished one
    bool undecided = false;
    for (int i = tid; i < B * K; i += blockDim.x)
      undecided |= scores[i] > fin_scores[(size_t)(i / K) * N + N - 1];
    undecided = __syncthreads_or(undecided);
    if (tid == 0) *running = *running && *step < max_steps && undecided;
  }

  // a beam that repeats an earlier beam's emitted prefix is dead: equal
  // hash and length (the earlier beams at once, a bit each), then equal tokens
  float score = scores[row];
  const long long len = lens[row];
  const bool full = len >= Um;
  const bool at_last = t_idx[row] >= enc_lens[b] - 1;
  if (prune && len > 0) {
    if (tid < kWarp) {
      const size_t other = (size_t)b * K + tid;
      const bool same = tid < k && hashes[other] == hashes[row] && lens[other] == len;
      const unsigned mask = __ballot_sync(0xffffffffu, same);
      if (tid == 0) maybe_dup = mask;
    }
    __syncthreads();
    bool dup = false;
    for (unsigned mask = maybe_dup; mask && !dup; mask &= mask - 1) {  // uniform over the block
      const size_t other = (size_t)b * K + __ffs(mask) - 1;
      bool differ = false;
      for (int u = tid; u < Um; u += blockDim.x)
        differ |= tokens[other * Um + u] != tokens[(size_t)row * Um + u];
      dup = !__syncthreads_or(differ);
    }
    if (dup) score = kNeg;
  }

  // float32 log-softmax of sm_scale * logits: z - max - log(sum(exp(z - max)))
  const T* x = logits + (size_t)row * V;
  float m = -INFINITY;
#pragma unroll 8
  for (int v = tid; v < V; v += blockDim.x) {
    z[v] = __fmul_rn(sm_scale, to_float(x[v]));
    m = fmaxf(m, z[v]);
  }
  m = block_max(m, fred);
  float s = 0.0f;
#pragma unroll 8
  for (int v = tid; v < V; v += blockDim.x) s = __fadd_rn(s, expf(__fsub_rn(z[v], m)));
  const float logsum = logf(block_sum(s, fred));
  if (tid == 0)  // blank at the last frame finishes the hypothesis
    fin_cand[row] = at_last && score > kNeg / 2
                        ? __fadd_rn(score, __fsub_rn(__fsub_rn(z[blank], m), logsum)) : kNeg;

  // each thread's own first KC candidates, in order, in registers
  Key top[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) top[i] = kAfterAll;
  const int flat0 = k * V;
  for (int v = tid; v < V; v += blockDim.x) {
    const float c = (full && v != blank) || (at_last && v == blank)
                        ? kNeg : __fadd_rn(score, __fsub_rn(__fsub_rn(z[v], m), logsum));
    const Key e = make_key(c, flat0 + v);
    if (e > top[KC - 1]) {
      top[KC - 1] = e;
#pragma unroll
      for (int i = KC - 1; i > 0; --i) {
        const Key hi = max(top[i], top[i - 1]);
        top[i] = min(top[i], top[i - 1]);
        top[i - 1] = hi;
      }
    }
  }

  // the row's top-K: each warp's own in K rounds of shuffles (the lane
  // holding the first drops it), then warp 0 merges the warps' sorted lists
  // in K more; one barrier in all
  const int lane = tid & (kWarp - 1), warp = tid / kWarp;
  for (int r = 0; r < K; ++r) {
    const Key first = warp_first(top[0]);
    if (lane == 0) wtop[warp][r] = first;
    if (top[0] == first && first != kAfterAll) {
#pragma unroll
      for (int i = 0; i < KC - 1; ++i) top[i] = top[i + 1];
      top[KC - 1] = kAfterAll;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int head = 0;
    for (int r = 0; r < K; ++r) {
      const Key mine = lane < kThreads / kWarp && head < K ? wtop[lane][head] : kAfterAll;
      const Key first = warp_first(mine);
      if (lane == 0) row_key[(size_t)row * K + r] = first;
      if (mine == first && first != kAfterAll) ++head;
    }
  }
}

// 2. A block an utterance: the K of its K x K row winners and the N of its
// N finished and K finished candidates, the scalars of the state in place.
__global__ void beam_merge_kernel(const __grid_constant__ Args a) {
  __shared__ Key rk[kMaxBeam * kMaxBeam];
  __shared__ Key fk[kMaxBest + kMaxBeam];
  __shared__ Key pick[kMaxBeam];
  __shared__ float fin_v[kMaxBest];
  __shared__ int fin_pick[kMaxBest];
  __shared__ long long old_t[kMaxBeam], old_len[kMaxBeam], old_al[kMaxBeam], old_h[kMaxBeam];
  __shared__ long long old_fl[kMaxBest], old_fal[kMaxBest];
  const int K = (int)a.d[kK], N = (int)a.d[kN], V = (int)a.d[kV], Um = (int)a.d[kUm];
  const int blank = (int)a.d[kBlank];
  const long long S = a.d[kS];
  const bool* running = ARG(const bool*, kRunning);
  long long* step = ARG(long long*, kStep);
  float* scores = ARG(float*, kScores);
  long long* t_idx = ARG(long long*, kTIdx);
  long long* lens = ARG(long long*, kLens);
  long long* align_lens = ARG(long long*, kAlignLens);
  long long* hashes = ARG(long long*, kHashes);
  float* fin_scores = ARG(float*, kFinScores);
  long long* fin_lens = ARG(long long*, kFinLens);
  long long* fin_align_lens = ARG(long long*, kFinAlignLens);
  const Key* row_key = ARG(const Key*, kRowKey);
  const float* fin_cand = ARG(const float*, kFinCand);
  int* prev_k = ARG(int*, kPrevK);
  long long* tok = ARG(long long*, kTok);
  int* pos = ARG(int*, kPos);
  int* apos = ARG(int*, kAPos);
  int* fin_idx = ARG(int*, kFinIdx);
  const int b = blockIdx.x, tid = threadIdx.x, nf = N + K;
  const size_t bk = (size_t)b * K, bn = (size_t)b * N;

  for (int i = tid; i < K * K; i += blockDim.x) rk[i] = row_key[bk * K + i];
  for (int i = tid; i < nf; i += blockDim.x)
    fk[i] = make_key(i < N ? fin_scores[bn + i] : fin_cand[bk + i - N], i);
  for (int j = tid; j < K; j += blockDim.x) {
    old_t[j] = t_idx[bk + j];
    old_len[j] = lens[bk + j];
    old_al[j] = align_lens[bk + j];
    old_h[j] = hashes[bk + j];
  }
  for (int i = tid; i < N; i += blockDim.x) {
    old_fl[i] = fin_lens[bn + i];
    old_fal[i] = fin_align_lens[bn + i];
  }
  const bool run = *running;
  __syncthreads();
  // the first K of the K sorted rows: warp 0 merges them, a lane a row (a
  // row of fewer than K tokens ends in kAfterAll)
  if (tid < kWarp) {
    int head = 0;
    for (int r = 0; r < K; ++r) {
      const Key mine = tid < K && head < K ? rk[tid * K + head] : kAfterAll;
      const Key first = warp_first(mine);
      if (tid == 0) pick[r] = first;
      if (mine == first) ++head;
    }
  }
  // the finished store: an entry's rank is the count of entries before it
  for (int i = tid; i < nf; i += blockDim.x) {
    int rank = 0;
    for (int j = 0; j < nf; ++j) rank += fk[j] > fk[i];
    if (rank < N) {
      fin_pick[rank] = i;
      fin_v[rank] = i < N ? fin_scores[bn + i] : fin_cand[bk + i - N];
    }
  }
  __syncthreads();
  for (int j = tid; j < K; j += blockDim.x) {
    const int flat = key_index(pick[j]), pk = flat / V, t = flat - pk * V;
    const bool emit = t != blank;
    prev_k[bk + j] = pk;
    tok[bk + j] = t;
    pos[bk + j] = (int)min(max(old_len[pk], 0LL), (long long)Um - 1);
    apos[bk + j] = (int)min(max(old_al[pk], 0LL), S - 1);
    if (run) {
      scores[bk + j] = key_value(pick[j]);
      t_idx[bk + j] = emit ? old_t[pk] : old_t[pk] + 1;
      lens[bk + j] = old_len[pk] + emit;
      align_lens[bk + j] = old_al[pk] + 1;
      hashes[bk + j] = emit ? (old_h[pk] * kHashMult + t + 1) & kHashMask : old_h[pk];
    }
  }
  __syncthreads();  // fin_scores read above before they are written
  for (int i = tid; i < N; i += blockDim.x) {
    const int f = fin_pick[i];
    fin_idx[bn + i] = f;
    if (run) {
      fin_scores[bn + i] = fin_v[i];
      fin_lens[bn + i] = f < N ? old_fl[f] : old_len[f - N];
      fin_align_lens[bn + i] = f < N ? old_fal[f] : old_al[f - N];
    }
  }
  if (b == 0 && tid == 0 && run) ++*step;
}

// 3. Grid (blocks, B): each block takes one slice of columns of one of
// utterance b's buffers (a segment: the token buffers, the alignments, the
// joint factors, each layer's LSTM state, or the next joint's encoder
// factors), at most kChunkWords words of all its rows.  A permuted segment
// is staged in one round: every row's slice into shared memory, one
// barrier, every row written back in place, live row r from old live row
// prev_k[r], finished row i from old finished row fin_idx[i] < N, else from
// old live row fin_idx[i] - N.  The buffers move as 4-byte words (an int64
// is two).  The token buffers get the emitted token at its position, the
// alignments the step's token; the encoder factors are gathered at the new
// time pointers.  A block a slice is chosen over a block walking every
// segment, a load-barrier-store round each (10.7 us a launch at the
// flagship's shape, this 8).
struct Segment {
  unsigned* live;        // K rows
  unsigned* fin;         // N rows, or none
  const unsigned* from;  // the encoder factors (B, T, H) for a gather, or none
  int width;             // words a row
  int put;               // 0: none; 1: the token where emitted, at pos; 2: the token at apos
};

// Segment `i` of utterance b: 0 the token buffers, 1 the alignments, 2 and 3
// the joint factors, then each layer's LSTM state (h, c), then the two
// encoder factors to gather.
__device__ Segment segment(const Args& a, int b, int i) {
  const int B = (int)a.d[kB], K = (int)a.d[kK], N = (int)a.d[kN], Um = (int)a.d[kUm];
  const int S = (int)a.d[kS], T = (int)a.d[kT], layers = (int)a.d[kLayers];
  const int hw = (int)(a.d[kH] * a.d[kElemBytes] / 4);
  const size_t bk = (size_t)b * K, bn = (size_t)b * N;
  if (i == 0)
    return {ARG(unsigned*, kTokens) + bk * Um * 2, ARG(unsigned*, kFinTokens) + bn * Um * 2,
            nullptr, Um * 2, 1};
  if (i == 1)
    return {ARG(unsigned*, kAligns) + bk * S * 2, ARG(unsigned*, kFinAligns) + bn * S * 2,
            nullptr, S * 2, 2};
  // (a pointer picked by a runtime index into the arguments would copy them all)
  if (i < 4) return {(i == 2 ? ARG(unsigned*, kDecAy) : ARG(unsigned*, kDecGy)) + bk * hw, nullptr,
                     nullptr, hw, 0};
  if (i < 4 + 2 * layers) {
    const int l = (i - 4) / 2;
    unsigned* state = (i - 4) % 2 ? ARG(unsigned*, kDecC) : ARG(unsigned*, kDecH);
    return {state + ((size_t)l * B * K + bk) * hw, nullptr, nullptr, hw, 0};
  }
  const bool gy = i > 4 + 2 * layers;
  const unsigned* all = gy ? ARG(const unsigned*, kGxAll) : ARG(const unsigned*, kAxAll);
  return {(gy ? ARG(unsigned*, kGxSel) : ARG(unsigned*, kAxSel)) + bk * hw, nullptr,
          all + (size_t)b * T * hw, hw, 0};
}

// Segment i's slices: a block takes `cols` columns of all its rows, at most
// kChunkWords words; returns their count.
__host__ __device__ inline int segment_chunks(const long long* d, int i, int& cols) {
  const int width = (int)(i == 0 ? 2 * d[kUm] : i == 1 ? 2 * d[kS] : d[kH] * d[kElemBytes] / 4);
  const int rows = (int)(i < 2 ? d[kK] + d[kN] : d[kK]);
  cols = kChunkWords / rows > 1 ? kChunkWords / rows : 1;
  return (width + cols - 1) / cols;
}

__global__ void __launch_bounds__(kUpdateThreads)
    beam_update_kernel(const __grid_constant__ Args a) {
  if (!*ARG(const bool*, kRunning)) return;
  __shared__ unsigned stage[kChunkWords];
  __shared__ int src[kMaxBeam], fsrc[kMaxBest], at[kMaxBeam];
  __shared__ long long frame[kMaxBeam];
  __shared__ unsigned put[kMaxBeam][2];
  const int K = (int)a.d[kK], N = (int)a.d[kN], T = (int)a.d[kT], blank = (int)a.d[kBlank];
  const int b = blockIdx.y, tid = threadIdx.x;
  const size_t bk = (size_t)b * K, bn = (size_t)b * N;
  // this block's segment and slice
  const int nseg = 6 + 2 * (int)a.d[kLayers];
  int sg = 0, first = blockIdx.x, cols = 1;
  for (; sg < nseg; ++sg) {
    const int chunks = segment_chunks(a.d, sg, cols);
    if (first < chunks) break;
    first -= chunks;
  }
  if (sg == nseg) return;  // a block past the last slice
  const Segment g = segment(a, b, sg);
  const int lo = first * cols, w = min(cols, g.width - lo);
  const int rows = K + (g.fin ? N : 0);

  for (int j = tid; j < K; j += blockDim.x) {
    const long long t = ARG(const long long*, kTok)[bk + j];
    src[j] = ARG(const int*, kPrevK)[bk + j];
    put[j][0] = (unsigned)(t & 0xFFFFFFFFLL);
    put[j][1] = (unsigned)((unsigned long long)t >> 32);
    at[j] = g.put == 1 ? (t != blank ? ARG(const int*, kPos)[bk + j] : -1)
                       : g.put == 2 ? ARG(const int*, kAPos)[bk + j] : -1;
    frame[j] = min(max(ARG(const long long*, kTIdx)[bk + j], 0LL), (long long)T - 1);
  }
  for (int i = tid; i < N; i += blockDim.x) fsrc[i] = ARG(const int*, kFinIdx)[bn + i];
  __syncthreads();
  if (g.from) {  // the next joint's encoder factors at the new time pointers (merge wrote them)
    for (int i = tid; i < K * w; i += blockDim.x) {
      const int r = i / w, c = lo + i - r * w;
      g.live[(size_t)r * g.width + c] = g.from[frame[r] * g.width + c];
    }
    return;
  }
#pragma unroll 4
  for (int i = tid; i < rows * w; i += blockDim.x) {
    const int r = i / w, c = lo + i - r * w;
    stage[i] = r < K ? g.live[(size_t)r * g.width + c] : g.fin[(size_t)(r - K) * g.width + c];
  }
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < rows * w; i += blockDim.x) {
    const int r = i / w, c = i - r * w, col = lo + c;
    if (r < K) {  // in words: element col / 2, its half col % 2
      const unsigned x = at[r] >= 0 && col / 2 == at[r] ? put[r][col % 2] : stage[src[r] * w + c];
      g.live[(size_t)r * g.width + col] = x;
    } else {
      const int f = fsrc[r - K];
      g.fin[(size_t)(r - K) * g.width + col] = stage[(f < N ? K + f : f - N) * w + c];
    }
  }
}

// 4. The net's new joint factors (and LSTM state) where the beam emitted:
// rows of dec_ay, dec_gy, then each layer's dec_h and dec_c, in 4-byte words.
__global__ void __launch_bounds__(kCommitThreads)
    beam_commit_kernel(const __grid_constant__ Args a) {
  if (!*ARG(const bool*, kRunning)) return;
  const long long bkn = a.d[kB] * a.d[kK], hw = a.d[kH] * a.d[kElemBytes] / 4;
  const long long blank = a.d[kBlank], rows = bkn * (2 + 2 * a.d[kLayers]);
  const long long* tok = ARG(const long long*, kTok);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < rows * hw;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / hw, c = i - row * hw, part = row / bkn, r = row - part * bkn;
    if (tok[r] == blank) continue;
    // part 0, 1: the joint factors; 2 + 2 l (+ 1): layer l's h (c)
    const long long at = (part < 2 ? r : (part - 2) / 2 * bkn + r) * hw + c;
    if (part == 0) ARG(unsigned*, kDecAy)[at] = ARG(const unsigned*, kNewAy)[at];
    else if (part == 1) ARG(unsigned*, kDecGy)[at] = ARG(const unsigned*, kNewGy)[at];
    else if (part % 2 == 0) ARG(unsigned*, kDecH)[at] = ARG(const unsigned*, kNewH)[at];
    else ARG(unsigned*, kDecC)[at] = ARG(const unsigned*, kNewC)[at];
  }
}

#undef ARG

long long clamp_ll(long long x, long long lo, long long hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

// the arguments, checked, and the launch's device made current
cudaError_t prepare(int device, void* const* p, const long long* d, Args& a) {
  for (int i = 0; i < kSlots; ++i) a.p[i] = p[i];
  for (int i = 0; i < kDims; ++i) a.d[i] = d[i];
  if (d[kB] < 1 || d[kB] > 65535 || d[kK] < 1 || d[kK] > kMaxBeam || d[kN] < 1 ||
      d[kN] > kMaxBest || d[kV] < 1 || d[kV] > kMaxVocab || d[kUm] < 1 || d[kS] < 1 || d[kT] < 1 ||
      d[kH] < 1 || d[kLayers] < 0 || d[kLayers] > kMaxLayers || d[kBlank] < 0 ||
      d[kBlank] >= d[kV] ||
      (d[kElemBytes] != 2 && d[kElemBytes] != 4) || d[kH] * d[kElemBytes] % 4 != 0)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// The rows kernel's shared memory for V candidates; above the default 48 KB
// it asks the device for the most once, at a warm-up launch, before any
// capture.  `allowed` is what this kernel may have on the current device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess) allowed = kMaxSmem;
  return err;
}

}  // namespace

// Plain C interface, loaded with ctypes.  `p` is a host array of kSlots
// pointers (SLOTS in decode/beam_kernels.py; a slot that the call does not
// read may be null, and dec_h / dec_c are null for a net without LSTM
// state), `d` a host array of kDims sizes (DIMS).  The kernels take them by
// value, so a captured graph keeps them.  Each launches on `stream` and
// returns cudaGetLastError() after its launches (0 on success); nothing is
// allocated.  The state is contiguous: float32 scores, int64 counters and
// buffers, a bool flag; the net's buffers in its dtype (2 or 4 bytes, rows
// of a whole number of 4-byte words).  V is at most kMaxVocab (the
// candidates of a row in shared memory), the LSTM at most kMaxLayers deep.
extern "C" int pika_beam_select(int device, void* stream, void* const* p, const long long* d,
                                float sm_scale) {
  static size_t allowed[kMaxDevices][4];  // each device's opt-in, by kernel (0: not yet asked)
  Args a;
  cudaError_t err = prepare(device, p, d, a);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = (int)(d[kB] * d[kK]);
  const size_t smem = (size_t)d[kV] * sizeof(float);
  const bool bf16 = d[kLogitsBf16] != 0, wide = d[kK] > 8;
  auto kernel = bf16 ? (wide ? beam_rows_kernel<__nv_bfloat16, 32, kRowThreadsWide>
                             : beam_rows_kernel<__nv_bfloat16, 8, kRowThreads>)
                     : (wide ? beam_rows_kernel<float, 32, kRowThreadsWide>
                             : beam_rows_kernel<float, 8, kRowThreads>);
  if ((err = allow_smem(kernel, smem, allowed[device][2 * bf16 + wide])) != cudaSuccess) return err;
  kernel<<<rows, wide ? kRowThreadsWide : kRowThreads, smem, s>>>(a, sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long most = d[kN] + d[kK] > kWarp ? d[kN] + d[kK] : kWarp;
  beam_merge_kernel<<<(int)d[kB], (int)((most + kWarp - 1) / kWarp * kWarp), 0, s>>>(a);
  return cudaGetLastError();
}

extern "C" int pika_beam_update(int device, void* stream, void* const* p, const long long* d) {
  Args a;
  cudaError_t err = prepare(device, p, d, a);
  if (err != cudaSuccess) return err;
  // the slices of an utterance's segments, as the kernel counts them
  long long blocks = 0;
  int cols;
  for (int i = 0; i < 6 + 2 * d[kLayers]; ++i) blocks += segment_chunks(d, i, cols);
  const dim3 grid((unsigned)blocks, (unsigned)d[kB]);
  beam_update_kernel<<<grid, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int pika_beam_commit(int device, void* stream, void* const* p, const long long* d) {
  Args a;
  cudaError_t err = prepare(device, p, d, a);
  if (err != cudaSuccess) return err;
  const long long words = d[kB] * d[kK] * (2 + 2 * d[kLayers]) * d[kH] * d[kElemBytes] / 4;
  const int blocks = (int)clamp_ll((words + kCommitThreads - 1) / kCommitThreads, 1, 1024);
  beam_commit_kernel<<<blocks, kCommitThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
